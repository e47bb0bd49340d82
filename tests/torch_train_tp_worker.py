"""Rank worker for the port's tensor-parallel training battery.

Usage: ``python torch_train_tp_worker.py JOBS_JSON`` with a JSON list of
jobs, each a dict whose ``job`` is one of

* ``grads`` — ``arch``'s smoke config from the checkpoint in ``dir``, laid
  out over a ``(data, model)`` mesh of ``dims``: the loss and the whole
  gradient of :func:`repro_torch.train.train_step.tensor_parallel_grads`
  on the batch :func:`tp_batch` (``seq``, ``batch``, ``micro``), saved by
  rank 0 to ``out``; then one ``make_train_step`` step on the same batch,
  with its loss, whether the ranks' shards agree after it, and the kinds
  of collective it issued (counted by ``launch.hlo_analysis.OpCounter``);
  ``compute`` (optional) sets the models' compute dtype for the job
  (:func:`compute_dtype`);
* ``trainer`` — ``Trainer(mesh=)`` over ``dims`` from the seed, ``steps``
  steps with a checkpoint every ``ckpt_every`` into ``dir``, then the file
  ``dir/DONE``;
* ``restore`` — ``Trainer(mesh=)`` over ``dims`` restoring the latest
  checkpoint in ``dir`` (a copy of its own): the whole restored state
  (gathered) saved by rank 0 to ``out``, then the steps to ``steps``;
* ``decode`` — ``steps`` decode steps of ``arch``'s smoke config (drawn
  from seed 0) with its cache laid out by ``state_shardings`` over
  ``dims``: rank 0 saves the logits to ``out``;
* ``wait`` — wait for the file ``path`` (another process's checkpoint).

The topology comes from ``REPRO_SHARD_COORD`` / ``REPRO_SHARD_N`` /
``REPRO_SHARD_ID``; every job runs on the CPU on one process group, in
order, and prints ``RESULT <json>``.  Imports only ``repro_torch``.
"""

from __future__ import annotations

import contextlib
import json
import os
import sys
import time

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from repro_torch.configs.base import smoke_config
from repro_torch.data.corpus import CorpusConfig, shard_batch
from repro_torch.launch.mesh import init_em_distributed
from repro_torch.models.param import stacked_tree
from repro_torch.models.registry import get_model
from repro_torch.train import optimizer, train_step
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


def tp_batch(cfg, seq: int, batch: int, seed: int = 1) -> dict:
    """Random tokens and labels from ``seed``, (batch, seq) int32."""
    rng = np.random.default_rng(seed)
    return {k: rng.integers(1, cfg.vocab_size - 1, size=(batch, seq)).astype(np.int32)
            for k in ("tokens", "labels")}


@contextlib.contextmanager
def compute_dtype(name: str | None):
    """The models' compute dtype (``models.layers.COMPUTE_DTYPE``, bf16 by
    default) set to ``torch.<name>`` for the block; ``None`` leaves it."""
    from repro_torch.models import layers

    old = layers.COMPUTE_DTYPE
    if name:
        layers.COMPUTE_DTYPE = getattr(torch, name)
    try:
        yield
    finally:
        layers.COMPUTE_DTYPE = old


def load_state(arch: str, path: str, mesh=None):
    from repro_torch.checkpoint.checkpointer import Checkpointer

    api = get_model(smoke_config(arch))
    specs = api.param_specs()
    ckpt = Checkpointer(path)
    got = ckpt.restore(ckpt.latest_step(), {"params": specs, "opt": {
        "m": specs, "v": specs, "step": np.zeros((), np.int32)}}, device="cpu")
    return api, state_from_tree(api, got["params"], got["opt"], mesh)


def make_mesh(dims):
    names, sizes = zip(*dims)
    return DeviceMesh("cpu", torch.arange(int(np.prod(sizes))).reshape(sizes),
                      mesh_dim_names=names)


def run_grads(job, mesh):
    with compute_dtype(job.get("compute")):
        return _run_grads(job, mesh)


def _run_grads(job, mesh):
    from repro_torch.launch.hlo_analysis import OpCounter

    api, state = load_state(job["arch"], job["dir"], mesh)
    micro = job["micro"]
    split = train_step.split_microbatches(
        tp_batch(api.cfg, job["seq"], job["batch"]), micro)
    local = shard_batch(split, mesh, ("data",), microbatched=micro > 1)
    batch = train_step.dtensor_batch(local, mesh, ("data",), micro > 1)
    model, opt = state["params"], state["opt"]
    values, grads, _ = train_step.tensor_parallel_grads(api, model, batch, mesh, micro)
    whole = train_step.whole_leaves(model, grads)
    if dist.get_rank() == 0:
        np.savez(job["out"], **flat(stacked_tree(whole)))
    step = train_step.make_train_step(api, OPT, microbatches=micro, mesh=mesh)
    counter = OpCounter(ops=False)
    with counter:
        model, opt, metrics = step(model, opt, batch)
    agree, _ = train_step.tp_replicas_agree(model, opt, mesh)
    return dict(loss=float(values["loss"]), step_loss=float(metrics["loss"]), agree=agree,
                kinds=sorted({c["kind"] for c in counter.counts.collectives}))


def run_trainer(job, mesh):
    cfg = smoke_config(job["arch"])
    data = CorpusConfig(vocab_size=cfg.vocab_size, seq_len=job["seq"],
                        global_batch=job["batch"], seed=0)
    tcfg = TrainerConfig(steps=job["steps"], ckpt_every=job["ckpt_every"], log_every=1,
                         microbatches=job["micro"], ckpt_dir=job["dir"], async_ckpt=False)
    out = Trainer(get_model(cfg), data, OPT, tcfg, mesh=mesh, device="cpu").run()
    if dist.get_rank() == 0:  # every rank has returned: the checkpoints are written
        open(os.path.join(job["dir"], "DONE"), "w").close()
    return dict(losses=out["losses"])


def run_restore(job, mesh):
    cfg = smoke_config(job["arch"])
    data = CorpusConfig(vocab_size=cfg.vocab_size, seq_len=job["seq"],
                        global_batch=job["batch"], seed=0)
    tcfg = TrainerConfig(steps=job["steps"], ckpt_every=100, log_every=1,
                         microbatches=job["micro"], ckpt_dir=job["dir"], async_ckpt=False)
    t = Trainer(get_model(cfg), data, OPT, tcfg, mesh=mesh, device="cpu")
    state, start = t.restore_or_init()
    restored = checkpoint_state(state["params"], state["opt"])
    if dist.get_rank() == 0:
        np.savez(job["out"], **flat(restored))
    return dict(start=start, losses=t.run()["losses"])


def run_decode(job, mesh):
    from torch.distributed.tensor.experimental import implicit_replication

    from repro_torch.configs.base import ShapeConfig
    from repro_torch.launch import sharding as sl
    from repro_torch.models.layers import use_mesh
    from repro_torch.models.param import init_params, spec_tree_map

    api = get_model(smoke_config(job["arch"]))
    B, S = job["batch"], job["seq"]
    model = train_step.distribute_model(
        api.load(init_params(api.param_specs(), seed=0, device="cpu")), api, mesh)
    cache = spec_tree_map(lambda ps: torch.zeros(ps.shape, dtype=ps.dtype),
                          api.cache_specs(B, S))
    cache = sl.distribute_state(cache, sl.state_shardings(api.cache_specs(B, S), mesh))
    shape = ShapeConfig("d", S, B, "decode")
    toks = tp_batch(api.cfg, job["steps"], B, seed=2)["tokens"]
    logits = []
    for t in range(job["steps"]):
        b = {"tokens": torch.as_tensor(toks[:, t:t + 1]),
             "pos": torch.full((B,), t, dtype=torch.int32)}
        b = sl.distribute_state(b, sl.input_shardings(api, shape, mesh))
        with use_mesh(mesh), implicit_replication():
            out, cache = api.decode(model, cache, b)
        logits.append(out.full_tensor().float().numpy())
    if dist.get_rank() == 0:
        np.save(job["out"], np.stack(logits))
    return dict(placements=[type(p).__name__ for p in
                            next(iter(cache["layers"].values())).placements])


def main(argv) -> int:
    jobs = json.loads(argv[1])
    init_em_distributed(device="cpu")
    for job in jobs:
        kind = job["job"]
        if kind == "wait":
            t0 = time.time()
            while not os.path.exists(job["path"]):
                if time.time() - t0 > job.get("timeout", 120):
                    raise TimeoutError(f"no {job['path']}")
                time.sleep(0.05)
            continue
        mesh = make_mesh(job["dims"])
        res = {"grads": run_grads, "trainer": run_trainer, "restore": run_restore,
               "decode": run_decode}[kind](job, mesh)
        print("RESULT " + json.dumps({"job": kind, "tag": job.get("tag", kind),
                                      "rank": dist.get_rank(), **res}), flush=True)
    dist.barrier()
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv))
