"""Tensor-parallel training over gloo CPU ranks against the port's one-rank
step and the reference's step on the same mesh shape.

Four smoke configs (dense Qwen1.5, GQA Yi, MLA MiniCPM3, MoE Moonshot)
start from one common state each, written here as a checkpoint
(:func:`_write_start`), and take one batch drawn with numpy from a seed
(``tests/torch_train_tp_worker.py`` ``tp_batch``).  Three things run at once:

* the reference, in a subprocess with 4 XLA host devices (its
  ``xla_allow_excess_precision`` off, so it rounds as the port does): the
  loss and the microbatch-mean gradient under ``jax.jit`` with its
  parameters laid out by its ``param_shardings`` on ``(data, model)``
  meshes of (1, 2) and (2, 2), the batch over ``data``;
* the port on 2 and 4 gloo CPU ranks (the worker): the same loss and
  gradient from ``train_step.tensor_parallel_grads`` over the same mesh
  shapes, gathered whole, then one ``make_train_step`` step after which
  the ranks' shards must agree; 4 ranks train Qwen1.5 for 2 steps with
  checkpoints, and 2 ranks run 4 decode steps of Yi and MiniCPM3 with
  their caches laid out by ``state_shardings`` and restore the 4 ranks'
  checkpoint onto (1, 2);
* in this process, the port on one rank: the same losses and gradients,
  the decode steps, and the 4 ranks' checkpoint restored onto one rank.

Held to: losses within LOSS_REL, every gradient leaf within GRAD_REL of its
largest entry, decode logits within LOGITS, restored states equal to the
checkpoint bit for bit.  The MoE's losses and gradients are computed in f32
on every side (``COMPUTE``: its bf16 routing sits on near ties).  Every collective times out after 60 s, every
spawn after TIMEOUT_S.
"""

from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys
import textwrap
import time
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.checkpoint.checkpointer import Checkpointer  # noqa: E402
from repro_torch.configs.base import smoke_config  # noqa: E402
from repro_torch.models.param import in_f32, init_params, stacked_tree  # noqa: E402
from repro_torch.models.registry import get_model  # noqa: E402
from repro_torch.train import train_step  # noqa: E402
from repro_torch.train.trainer import (  # noqa: E402
    Trainer, TrainerConfig, checkpoint_state, state_from_tree,
)

sys.path.insert(0, str(Path(__file__).parent))
from torch_train_tp_worker import OPT, compute_dtype, flat, tp_batch  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
WORKER = str(Path(__file__).parent / "torch_train_tp_worker.py")
TIMEOUT_S = 240
LOSS_REL = 2e-3
GRAD_REL = 5e-2
LOGITS = dict(rtol=2e-2, atol=2e-2)
ARCHS = {"dense": "qwen1_5_0_5b", "gqa": "yi_6b", "mla": "minicpm3_4b",
         "moe": "moonshot_v1_16b_a3b"}
# seq, global batch, microbatches: the MoE's rows hold whole routing groups
# of 512 tokens on every rank of both meshes
LAYOUT = {"dense": (16, 4, 2), "gqa": (16, 4, 2), "mla": (16, 4, 2), "moe": (256, 4, 1)}
MESHES = {"1x2": [["data", 1], ["model", 2]], "2x2": [["data", 2], ["model", 2]]}
DECODE = {"gqa": (2, 16, 4), "mla": (2, 16, 4)}  # batch, cache length, steps
# The models' compute dtype a kind runs in, on every side (bf16 unless
# named).  The MoE smoke draw routes near ties (router scale 0.02: top-2
# margins of a few 1e-6 among its 1,024 tokens, which the 512-token routing
# groups on each of (2, 2)'s data ranks force), so in bf16 one rounding of
# a hidden state moves experts and, through the capacity queue, the tokens
# after it: the reference's own gradients on a (1, 2) or (2, 2) mesh differ
# from its one-device ones by up to 0.22 of a leaf's largest entry, and the
# port's one rank from the reference's by up to 0.41 (measured).  In f32 the
# rounding is 2^16 times finer than those margins, so the routing is the
# same on every side and each leaf is held to GRAD_REL.
COMPUTE = {"moe": "float32"}

REFERENCE = textwrap.dedent(
    """
    import os, sys, json
    os.environ["XLA_FLAGS"] = ("--xla_force_host_platform_device_count=4 "
                               "--xla_allow_excess_precision=false")
    import jax, jax.numpy as jnp, numpy as np
    from jax.sharding import NamedSharding, PartitionSpec as P
    from repro.checkpoint.checkpointer import Checkpointer
    from repro.models import layers
    from repro.configs.base import smoke_config
    from repro.launch import sharding as shardlib
    from repro.models.param import init_params
    from repro.models.registry import get_model
    from repro.train import optimizer, train_step

    out_dir, spec = sys.argv[1], json.loads(sys.argv[2])

    def flat(tree, prefix=""):
        if not isinstance(tree, dict):
            return {prefix: np.asarray(tree)}
        o = {}
        for k, v in tree.items():
            o.update(flat(v, f"{prefix}/{k}"))
        return o

    res = {}
    for kind, (arch, seq, batch, micro, start) in spec["archs"].items():
        layers.COMPUTE_DTYPE = getattr(jnp, spec["compute"].get(kind, "bfloat16"))
        api = get_model(smoke_config(arch))
        p0 = init_params(api.param_specs(), seed=0)
        ck = Checkpointer(start)
        params = ck.restore(ck.latest_step(),
                            {"params": p0, "opt": optimizer.init_opt_state(p0)})["params"]
        rng = np.random.default_rng(1)
        b = {k: rng.integers(1, api.cfg.vocab_size - 1, size=(batch, seq)).astype(np.int32)
             for k in ("tokens", "labels")}
        b = {k: jnp.asarray(v) for k, v in train_step.split_microbatches(b, micro).items()}
        grad_fn = jax.value_and_grad(api.loss, has_aux=True)

        def loss_grads(params, batch):
            if micro == 1:
                (loss, _), g = grad_fn(params, batch)
                return loss, g
            acc, losses = None, []
            for i in range(micro):
                (loss, _), g = grad_fn(params, {k: v[i] for k, v in batch.items()})
                g = jax.tree.map(lambda x: x.astype(jnp.float32) / micro, g)
                acc = g if acc is None else jax.tree.map(jnp.add, acc, g)
                losses.append(loss)
            return jnp.mean(jnp.stack(losses)), acc

        for name, dims in spec["meshes"].items():
            sizes = tuple(s for _, s in dims)
            mesh = jax.make_mesh(sizes, ("data", "model"),
                                 devices=jax.devices()[:int(np.prod(sizes))],
                                 axis_types=(jax.sharding.AxisType.Auto,) * 2)
            pshard = shardlib.param_shardings(api.param_specs(), mesh)
            bshard = NamedSharding(mesh, P(None, "data") if micro > 1 else P("data"))
            f = jax.jit(loss_grads, in_shardings=(pshard, {k: bshard for k in b}))
            with jax.set_mesh(mesh):
                loss, grads = f(params, b)
            np.savez(f"{out_dir}/ref_{kind}_{name}.npz", **flat(grads))
            res[f"{kind}/{name}"] = float(loss)
    print("REFERENCE " + json.dumps(res), flush=True)
    """
)


def _write_start(path: Path, arch: str):
    """The common start state: the port's f32 draw from seed 0, zero moments."""
    api = get_model(smoke_config(arch))
    state = state_from_tree(api, init_params(in_f32(api.param_specs()), seed=0, device="cpu"))
    ck = Checkpointer(str(path), async_save=False)
    ck.save(0, checkpoint_state(state["params"], state["opt"]))
    ck.wait()


def _spawn(jobs: list, n: int, base: Path, env: dict):
    store = base / f"store{n}"
    return [subprocess.Popen(
        [sys.executable, WORKER, json.dumps(jobs)],
        env=dict(env, REPRO_SHARD_COORD=f"file://{store}", REPRO_SHARD_N=str(n),
                 REPRO_SHARD_ID=str(r)),
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True) for r in range(n)]


def _results(procs) -> dict:
    outs = [p.communicate(timeout=TIMEOUT_S) for p in procs]
    for p, (_, err) in zip(procs, outs):
        assert p.returncode == 0, err[-4000:]
    got: dict = {}
    for out, _ in outs:
        for line in out.splitlines():
            if line.startswith("RESULT "):
                r = json.loads(line[len("RESULT "):])
                got.setdefault(r["tag"], []).append(r)
    return got


def _one_rank(kind: str, tree) -> tuple[float, dict]:
    """The port's one-rank loss and microbatch-mean gradient (the step's)."""
    with compute_dtype(COMPUTE.get(kind)):
        return _one_rank_grads(get_model(smoke_config(ARCHS[kind])), tree, *LAYOUT[kind])


def _one_rank_grads(api, tree, seq, batch, micro) -> tuple[float, dict]:
    model = state_from_tree(api, tree)["params"]
    names, params = zip(*model.named_parameters())
    split = train_step.split_microbatches(tp_batch(api.cfg, seq, batch), micro)
    split = {k: torch.as_tensor(v) for k, v in split.items()}
    acc, losses = None, []
    for i in range(micro):
        mb = {k: v[i] for k, v in split.items()} if micro > 1 else split
        loss, _ = api.loss(model, mb)
        grads = torch.autograd.grad(loss, params)
        acc = ([g.float() / micro for g in grads] if acc is None
               else [a + g.float() / micro for a, g in zip(acc, grads)])
        losses.append(float(loss))
    return float(np.mean(losses)), flat(stacked_tree(dict(zip(names, acc))))


def _decode_one_rank(arch: str, batch: int, s_max: int, steps: int) -> np.ndarray:
    api = get_model(smoke_config(arch))
    model = api.load(init_params(api.param_specs(), seed=0, device="cpu"))
    from repro_torch.models.param import spec_tree_map

    cache = spec_tree_map(lambda ps: torch.zeros(ps.shape, dtype=ps.dtype),
                          api.cache_specs(batch, s_max))
    toks = tp_batch(api.cfg, steps, batch, seed=2)["tokens"]
    out = []
    for t in range(steps):
        b = {"tokens": torch.as_tensor(toks[:, t:t + 1]),
             "pos": torch.full((batch,), t, dtype=torch.int32)}
        logits, cache = api.decode(model, cache, b)
        out.append(logits.float().numpy())
    return np.stack(out)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    base = tmp_path_factory.mktemp("train_tp")
    trees = {}
    for kind, arch in ARCHS.items():
        _write_start(base / f"start_{kind}", arch)
        api = get_model(smoke_config(arch))
        trees[kind] = init_params(in_f32(api.param_specs()), seed=0, device="cpu")
    # one thread a process: 7 processes share the CPU
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), REPRO_SHARD_TIMEOUT_S="60",
               JAX_PLATFORMS="cpu", OMP_NUM_THREADS="1")
    archs = {k: [ARCHS[k], *LAYOUT[k], str(base / f"start_{k}")] for k in ARCHS}
    # two reference processes, a mesh shape each, compile at once
    refs = [subprocess.Popen(
        [sys.executable, "-c", REFERENCE, str(base), json.dumps(
            {"archs": archs, "meshes": {m: MESHES[m]}, "compute": COMPUTE})],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for m in MESHES]

    def grads_jobs(mesh):
        return [{"job": "grads", "tag": f"{k}/{mesh}", "arch": ARCHS[k], "dims": MESHES[mesh],
                 "seq": LAYOUT[k][0], "batch": LAYOUT[k][1], "micro": LAYOUT[k][2],
                 "compute": COMPUTE.get(k),
                 "dir": str(base / f"start_{k}"), "out": str(base / f"tp_{k}_{mesh}.npz")}
                for k in ARCHS]

    ckpt4, ckpt12 = base / "ckpt_2x2", base / "ckpt_1x2"
    dense = {"arch": ARCHS["dense"], "seq": 16, "batch": 4, "micro": 2}
    four = _spawn([{"job": "trainer", "tag": "trainer", "dims": MESHES["2x2"], "steps": 2,
                    "ckpt_every": 1, "dir": str(ckpt4), **dense}] + grads_jobs("2x2"),
                  4, base, env)
    two = _spawn(grads_jobs("1x2") + [
        {"job": "decode", "tag": f"decode/{k}", "arch": ARCHS[k], "dims": MESHES["1x2"],
         "batch": b, "seq": s, "steps": n, "out": str(base / f"decode_{k}.npy")}
        for k, (b, s, n) in DECODE.items()] + [
        {"job": "wait", "path": str(ckpt12 / "READY"), "timeout": TIMEOUT_S},
        {"job": "restore", "tag": "restore/1x2", "dims": MESHES["1x2"], "steps": 3,
         "dir": str(ckpt12), "out": str(base / "restored_1x2.npz"), **dense}], 2, base, env)

    got = {"one": {k: _one_rank(k, trees[k]) for k in ARCHS},
           "decode_one": {k: _decode_one_rank(ARCHS[k], *DECODE[k]) for k in DECODE}}
    t0 = time.time()
    while not (ckpt4 / "DONE").exists():  # the 4 ranks' checkpoints are written
        assert time.time() - t0 < TIMEOUT_S and four[0].poll() in (None, 0), "no checkpoint"
        time.sleep(0.05)
    shutil.copytree(ckpt4, ckpt12)
    (ckpt12 / "READY").touch()
    ckpt11 = base / "ckpt_1x1"
    shutil.copytree(ckpt4, ckpt11)
    api = get_model(smoke_config(ARCHS["dense"]))
    specs = api.param_specs()
    ck = Checkpointer(str(ckpt4))
    got["ckpt"] = flat(ck.restore(2, {"params": specs, "opt": {
        "m": specs, "v": specs, "step": np.zeros((), np.int32)}}, device="cpu"))
    from repro_torch.data.corpus import CorpusConfig

    t = Trainer(api, CorpusConfig(vocab_size=api.cfg.vocab_size, seq_len=16, global_batch=4,
                                  seed=0),
                OPT, TrainerConfig(steps=3, ckpt_every=100, log_every=1, microbatches=2,
                                   ckpt_dir=str(ckpt11), async_ckpt=False), device="cpu")
    state, _ = t.restore_or_init()
    got["restored_1x1"] = flat(checkpoint_state(state["params"], state["opt"]))
    got["restore_1x1_losses"] = t.run()["losses"]
    got["two"] = _results(two)
    got["four"] = _results(four)
    got["reference"] = {}
    for ref in refs:
        out, err = ref.communicate(timeout=TIMEOUT_S)
        assert ref.returncode == 0, err[-4000:]
        got["reference"].update(json.loads(
            [ln for ln in out.splitlines() if ln.startswith("REFERENCE ")][-1][10:]))
    got["base"] = base
    return got


def _tp(runs, kind, mesh):
    res = (runs["two"] if mesh == "1x2" else runs["four"])[f"{kind}/{mesh}"]
    with np.load(runs["base"] / f"tp_{kind}_{mesh}.npz") as z:
        grads = {k: z[k] for k in z.files}
    return res, grads


def _assert_grads(got: dict, want: dict):
    """Each leaf within GRAD_REL of its largest entry."""
    assert got.keys() == want.keys()
    for key, w in want.items():
        err = float(np.max(np.abs(got[key] - w)))
        bound = GRAD_REL * float(np.max(np.abs(w)))
        assert err <= bound + 1e-12, (key, err, bound)


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("kind", list(ARCHS))
def test_tp_loss_and_grads_equal_one_rank(runs, kind, mesh):
    res, grads = _tp(runs, kind, mesh)
    loss, want = runs["one"][kind]
    for r in res:  # every rank: the same loss, the replicas' shards agreeing after a step
        assert abs(r["loss"] - loss) <= LOSS_REL * abs(loss), (r["loss"], loss)
        assert r["step_loss"] == r["loss"] and r["agree"]
    _assert_grads(grads, want)


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("kind", list(ARCHS))
def test_tp_loss_and_grads_equal_the_reference_on_its_mesh(runs, kind, mesh):
    res, grads = _tp(runs, kind, mesh)
    want_loss = runs["reference"][f"{kind}/{mesh}"]
    assert abs(res[0]["loss"] - want_loss) <= LOSS_REL * abs(want_loss)
    with np.load(runs["base"] / f"ref_{kind}_{mesh}.npz") as z:
        want = {k: z[k] for k in z.files}
    _assert_grads(grads, want)


def test_tp_step_issues_all_gathers_and_reduces(runs):
    """The (2, 2) step's collectives come from DTensor: gathers of the
    column-sharded weights and the reductions of the row-parallel sums."""
    kinds = {k for r in runs["four"]["dense/2x2"] for k in r["kinds"]}
    assert {"all-gather", "all-reduce"} <= kinds


@pytest.mark.parametrize("kind", list(DECODE))
def test_tp_decode_equals_one_rank(runs, kind):
    got = np.load(runs["base"] / f"decode_{kind}.npy")
    np.testing.assert_allclose(got, runs["decode_one"][kind], **LOGITS)
    # the cache is laid out over the model axis: heads or sequence
    assert runs["two"][f"decode/{kind}"][0]["placements"][-1] == "Shard"


@pytest.mark.parametrize("onto", ["1x1", "1x2"])
def test_restore_of_a_2x2_checkpoint(runs, onto):
    """The (2, 2) ranks' checkpoint (the reference's whole-leaf layout)
    restores onto one rank and onto (1, 2) bit for bit, and the next step
    agrees."""
    if onto == "1x1":
        restored = runs["restored_1x1"]
        losses = runs["restore_1x1_losses"]
    else:
        with np.load(runs["base"] / "restored_1x2.npz") as z:
            restored = {k: z[k] for k in z.files}
        losses = runs["two"]["restore/1x2"][0]["losses"]
    assert restored.keys() == runs["ckpt"].keys()
    for key, want in runs["ckpt"].items():
        np.testing.assert_array_equal(restored[key], want, err_msg=key)
    (step, loss), = losses
    ref_step, ref_loss = runs["restore_1x1_losses"][0]
    assert step == ref_step == 3
    assert abs(loss - ref_loss) <= LOSS_REL * abs(ref_loss)
    assert runs["four"]["trainer"][0]["losses"][-1][0] == 2
