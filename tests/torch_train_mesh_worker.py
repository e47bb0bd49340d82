"""Rank worker for the port's data-parallel training battery.

Usage: ``python torch_train_mesh_worker.py JOBS_JSON`` with a JSON list of
jobs, each a dict whose ``job`` is one of

* ``trainer`` — ``Trainer(mesh=("data",) over every rank)`` of ``arch``'s
  smoke config from the checkpoint in ``dir`` (``seq``, ``batch``,
  ``micro``, ``steps``, ``ckpt_every``): prints the restored state's
  digest, the losses, and after each step the parameters' digest and the
  whole state's (parameters, moments, step);
* ``vlm_step`` — the data-parallel ``make_train_step`` on a VLM
  ``demo_batch`` (vision patches, (3, B, S) positions) split into
  ``micro`` microbatches, from the parameters in ``dir``; rank 0 saves
  the stepped state to ``out``;
* ``compressed`` — ``make_train_step(compress_pods=True)`` over a mesh of
  ``dims`` (``[["pod", 2]]`` or ``[["pod", 2], ["data", 2]]``), ``steps``
  steps from ``dir``; rank 0 saves the parameters and residuals to ``out``;
* ``psum`` — ``tree_compressed_psum`` over every rank of the gradient and
  residual trees in ``inp`` + rank (an ``.npz`` of ``g/...`` and
  ``e/...`` arrays); each rank saves its result to ``out`` + rank;
* ``straddle`` — a MoE step whose routing groups straddle the ranks:
  prints the error it raises;
* ``wait`` — wait for the file ``path`` (another process's checkpoint).

The topology comes from ``REPRO_SHARD_COORD`` / ``REPRO_SHARD_N`` /
``REPRO_SHARD_ID``; every job runs on the CPU on one process group, in
order, and prints ``RESULT <json>``.  Imports only ``repro_torch``.
"""

from __future__ import annotations

import json
import os
import sys
import time

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from repro_torch.configs.base import ShapeConfig, smoke_config
from repro_torch.data.corpus import CorpusConfig, TokenStream, shard_batch
from repro_torch.launch.mesh import init_em_distributed
from repro_torch.models.param import leaves
from repro_torch.models.registry import get_model
from repro_torch.train import compress, optimizer, train_step
from repro_torch.train.trainer import Trainer, TrainerConfig, checkpoint_state, state_from_tree

OPT = optimizer.OptConfig(lr=1e-3, warmup_steps=2)


def flat(tree, prefix=""):
    if not isinstance(tree, dict):
        return {prefix: tree.detach().cpu().numpy() if isinstance(tree, torch.Tensor)
                else np.asarray(tree)}
    out = {}
    for k, v in tree.items():
        out.update(flat(v, f"{prefix}/{k}"))
    return out


def load_state(arch: str, path: str):
    """The trainable model and optimizer state of the latest checkpoint."""
    from repro_torch.checkpoint.checkpointer import Checkpointer

    api = get_model(smoke_config(arch))
    specs = api.param_specs()
    ckpt = Checkpointer(path)
    got = ckpt.restore(ckpt.latest_step(), {"params": specs, "opt": {
        "m": specs, "v": specs, "step": np.zeros((), np.int32)}}, device="cpu")
    return api, state_from_tree(api, got["params"], got["opt"])


def run_trainer(job, mesh):
    cfg = smoke_config(job["arch"])
    api = get_model(cfg)
    data = CorpusConfig(vocab_size=cfg.vocab_size, seq_len=job["seq"],
                        global_batch=job["batch"], seed=0)
    tcfg = TrainerConfig(steps=job["steps"], ckpt_every=job["ckpt_every"], log_every=1,
                         microbatches=job["micro"], ckpt_dir=job["dir"], async_ckpt=False)
    t = Trainer(api, data, OPT, tcfg, mesh=mesh, device="cpu")
    state, start = t.restore_or_init()
    restored = train_step.state_digest(state["params"], state["opt"])
    states, inner = [], t.step_fn

    def step_fn(model, opt, batch):
        out = inner(model, opt, batch)
        states.append((int(out[1]["step"]), train_step.state_digest(out[0], out[1])))
        return out

    t.step_fn = step_fn
    out = t.run()
    return dict(start=start, restored=restored, losses=out["losses"], digests=out["digests"],
                states=states)


def run_vlm_step(job, mesh):
    api, state = load_state(job["arch"], job["dir"])
    model, opt = state["params"], state["opt"]
    micro = job["micro"]
    batch = api.demo_batch(ShapeConfig("t", job["seq"], job["batch"], "train"), seed=1)
    split = train_step.split_microbatches(batch, micro)
    local = shard_batch(split, mesh, ("data",), microbatched=micro > 1)
    step = train_step.make_train_step(api, OPT, microbatches=micro, mesh=mesh)
    model, opt, metrics = step(model, opt, local)
    agree, digest = train_step.replicas_agree(dict(model.named_parameters()))
    if dist.get_rank() == 0:
        np.savez(job["out"], **flat(checkpoint_state(model, opt)))
    return dict(loss=float(metrics["loss"]), agree=agree, digest=digest,
                shapes={k: list(v.shape) for k, v in local.items()})


def run_compressed(job):
    names, sizes = zip(*job["dims"])
    mesh = DeviceMesh("cpu", torch.arange(int(np.prod(sizes))).reshape(sizes),
                      mesh_dim_names=names)
    api, state = load_state(job["arch"], job["dir"])
    model, opt = state["params"], state["opt"]
    err = train_step.error_state_of(model)
    micro = job["micro"]
    step = train_step.make_train_step(api, OPT, microbatches=micro, compress_pods=True,
                                      mesh=mesh)
    cfg = api.cfg
    stream = TokenStream(CorpusConfig(vocab_size=cfg.vocab_size, seq_len=job["seq"],
                                      global_batch=job["batch"], seed=0))
    losses, digests = [], []
    first = int(opt["step"])
    for i in range(first, first + job["steps"]):
        split = train_step.split_microbatches(stream.batch(i), micro)
        local = shard_batch(split, mesh, ("pod", "data"), microbatched=micro > 1)
        model, opt, err, metrics = step(model, opt, err, local)
        losses.append(float(metrics["loss"]))
        agree, digest = train_step.replicas_agree(dict(model.named_parameters()))
        digests.append((agree, digest))
    if dist.get_rank() == 0:
        np.savez(job["out"], **flat(checkpoint_state(model, opt)), **flat(err, "err"))
    err_norm = float(torch.sqrt(sum(torch.sum(e * e) for e in leaves(err))))
    return dict(losses=losses, digests=digests, err_norm=err_norm)


def _tree(arrays: dict, head: str) -> dict:
    tree: dict = {}
    for key, v in arrays.items():
        first, *path = key.strip("/").split("/")
        if first != head:
            continue
        node = tree
        for p in path[:-1]:
            node = node.setdefault(p, {})
        node[path[-1]] = torch.as_tensor(v)
    return tree


def run_psum(job):
    rank = dist.get_rank()
    with np.load(f"{job['inp']}{rank}.npz") as z:
        arrays = {k: z[k] for k in z.files}
    g, e = _tree(arrays, "g"), _tree(arrays, "e")
    out, new_err = compress.tree_compressed_psum(g, dist.group.WORLD, e)
    q, scale = compress.quantize(g["a"], None)
    np.savez(f"{job['out']}{rank}.npz", **flat(out, "out"), **flat(new_err, "err"),
             q_local=q.numpy(), scale_local=scale.numpy())
    return dict(rank=rank)


def run_straddle(job, mesh):
    cfg = smoke_config(job["arch"])
    api = get_model(cfg)
    data = CorpusConfig(vocab_size=cfg.vocab_size, seq_len=job["seq"],
                        global_batch=job["batch"], seed=0)
    t = Trainer(api, data, OPT, TrainerConfig(steps=1), mesh=mesh, device="cpu")
    try:
        t.run()
    except ValueError as e:
        return dict(raised=str(e))
    return dict(raised=None)


def main(argv) -> int:
    jobs = json.loads(argv[1])
    init_em_distributed(device="cpu")
    n = dist.get_world_size()
    mesh = DeviceMesh("cpu", torch.arange(n), mesh_dim_names=("data",))
    for job in jobs:
        kind = job["job"]
        if kind == "wait":
            t0 = time.time()
            while not os.path.exists(job["path"]):
                if time.time() - t0 > job.get("timeout", 120):
                    raise TimeoutError(f"no {job['path']}")
                time.sleep(0.05)
            continue
        if kind == "trainer":
            res = run_trainer(job, mesh)
        elif kind == "vlm_step":
            res = run_vlm_step(job, mesh)
        elif kind == "compressed":
            res = run_compressed(job)
        elif kind == "psum":
            res = run_psum(job)
        elif kind == "straddle":
            res = run_straddle(job, mesh)
        else:
            raise ValueError(f"unknown job {kind!r}")
        print("RESULT " + json.dumps({"job": job.get("name", kind), "rank": dist.get_rank(),
                                      "ranks": n, **res}), flush=True)
    dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv))
