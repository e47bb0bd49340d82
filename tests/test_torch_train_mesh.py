"""Data-parallel training over gloo CPU ranks against the reference on
host devices: the compressed cross-pod exchange, the Trainer on a mesh,
the compressed step, elastic restores and the batch layout.

Three things run at once from the module fixture:

* the reference, in three subprocesses with 4 host devices
  (``XLA_FLAGS=--xla_force_host_platform_device_count=4``, and XLA's
  ``xla_allow_excess_precision`` off so it rounds as the port does, as in
  ``tests/test_torch_train_families.py``): its ``Trainer(mesh=
  jax.make_mesh((2,), ("data",)))`` for the dense, MoE and VLM smoke
  configs, one microbatched VLM step with vision patches and (3, B, S)
  positions, ``make_train_step(compress_pods=True, mesh=...)`` over
  ``pod=2`` and ``pod=2 x data=2``, ``tree_compressed_psum`` in a
  ``shard_map`` over 2 and 4 devices, and its batch shards;
* 2 port ranks (``tests/torch_train_mesh_worker.py``) running the same
  jobs, and 4 ranks running the 4-rank ones;
* in this process, a one-rank Trainer that restores a checkpoint of the
  2 ranks and runs 2 steps, whose checkpoint the 4 ranks restore.

Every run starts from one common state per config, written here first
(:func:`_write_start`).  The losses are held to LOGITS, every leaf to LOGITS
and its change over the run within CHANGE_REL of the reference's (norm
over norm, as ``tests/test_torch_train_loop.py`` holds it), the
exchange bit for bit, and the ranks' parameters bit-identical after
every step.  Every collective times out after 60 s, every spawn after
TIMEOUT_S.
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

import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.train import compress as ref_compress  # noqa: E402
from repro_torch.checkpoint.checkpointer import Checkpointer  # noqa: E402
from repro_torch.configs import base  # noqa: E402
from repro_torch.data.corpus import CorpusConfig, Loader, TokenStream, shard_batch  # noqa: E402
from repro_torch.models.registry import get_model  # noqa: E402
from repro_torch.train import compress, train_step  # noqa: E402
from repro_torch.train.trainer import Trainer, TrainerConfig, checkpoint_state  # noqa: E402

sys.path.insert(0, str(Path(__file__).parent))
from torch_train_mesh_worker import OPT  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
WORKER = str(Path(__file__).parent / "torch_train_mesh_worker.py")
TIMEOUT_S = 240
LOGITS = dict(rtol=2e-2, atol=2e-2)
CHANGE_REL = 5e-2
NOISY_CHANGE = ("/layers/attn/bk",)  # see tests/test_torch_train_loop.py
ARCHS = {"dense": "qwen1_5_0_5b", "moe": "moonshot_v1_16b_a3b", "vlm": "qwen2_vl_7b"}
# seq, global batch, microbatches: the MoE's 2 rows x 256 tokens a rank
# hold whole routing groups of 512
LAYOUT = {"dense": (16, 8, 2), "moe": (256, 4, 1), "vlm": (16, 8, 2)}
START, STEPS = 8, 3  # the common state's step, and the steps run from it
END = START + STEPS
VISION_WARM = 4  # of the VLM's START steps, on batches with vision patches
PSUM_SEED = 7
PSUM_SHAPES = {"a": (64, 32), "b": {"c": (128,), "d": (8, 8, 8)}, "z": (16,)}
COMPRESSED = {"pod2": [["pod", 2]], "pod2xdata2": [["pod", 2], ["data", 2]]}

REFERENCE = textwrap.dedent(
    """
    import os, sys, json, shutil
    os.environ["XLA_FLAGS"] = ("--xla_force_host_platform_device_count=4 "
                               "--xla_allow_excess_precision=false")
    import jax, jax.numpy as jnp, numpy as np
    from jax.sharding import NamedSharding, PartitionSpec as P
    from repro.configs.base import ShapeConfig, smoke_config
    from repro.data.corpus import CorpusConfig, Loader, TokenStream, shard_batch
    from repro.models.registry import get_model
    from repro.checkpoint.checkpointer import Checkpointer
    from repro.train import compress, optimizer, train_step, trainer

    out = sys.argv[1]
    spec = json.loads(sys.argv[3])
    opt = optimizer.OptConfig(lr=1e-3, warmup_steps=2)
    devs = jax.devices()
    res = {}

    def flat(tree, prefix=""):
        if not isinstance(tree, dict):
            return {prefix: np.asarray(tree)}
        o = {}
        for k, v in tree.items():
            o.update(flat(v, f"{prefix}/{k}"))
        return o

    def restore(arch, path):
        api = get_model(smoke_config(arch))
        from repro.models.param import init_params
        p = init_params(api.param_specs(), seed=0)
        ck = Checkpointer(path)
        st = ck.restore(ck.latest_step(), {"params": p, "opt": optimizer.init_opt_state(p)})
        return api, st["params"], st["opt"]

    mesh2 = jax.make_mesh((2,), ("data",), devices=devs[:2])
    for kind, (arch, seq, batch, micro, steps) in spec.get("trainers", {}).items():
        cfg = smoke_config(arch)
        data = CorpusConfig(vocab_size=cfg.vocab_size, seq_len=seq, global_batch=batch, seed=0)
        tc = trainer.TrainerConfig(steps=steps, ckpt_every=1, log_every=1, microbatches=micro,
                                   ckpt_dir=f"{out}/trainer_{kind}", async_ckpt=False)
        got = trainer.Trainer(get_model(cfg), data, opt, tc, mesh=mesh2).run()
        res[f"trainer_{kind}"] = got["losses"]

    if "trainers" in spec:  # three processes: the trainers, the compressed steps, the rest
        print("REFERENCE " + json.dumps(res), flush=True)
        sys.exit(0)

    # one microbatched VLM step on a demo batch with vision patches
    if "vlm_step" in spec:
        arch, seq, batch, micro = spec["vlm_step"]
        api, params, ost = restore(arch, f"{out}/start_vlm")
        b = api.demo_batch(ShapeConfig("t", seq, batch, "train"), seed=1)
        split = {k: jnp.asarray(v) for k, v in train_step.split_microbatches(b, micro).items()}
        params, ost, m = jax.jit(train_step.make_train_step(api, opt, microbatches=micro))(
            params, ost, split)
        res["vlm_step"] = float(m["loss"])
        np.savez(f"{out}/vlm_step.npz", **flat({"params": params, "opt": ost}))

    # the compressed cross-pod step
    for name, dims in spec.get("compressed", {}).items():
        arch, seq, batch, micro, steps = spec["compressed_run"]
        names, sizes = zip(*dims)
        mesh = jax.make_mesh(tuple(sizes), tuple(names), devices=devs[:int(np.prod(sizes))])
        api, params, ost = restore(arch, f"{out}/start_dense")
        err = compress.init_error_state(params)
        step = jax.jit(train_step.make_train_step(api, opt, microbatches=micro,
                                                  compress_pods=True, mesh=mesh))
        stream = TokenStream(CorpusConfig(vocab_size=api.cfg.vocab_size, seq_len=seq,
                                          global_batch=batch, seed=0))
        losses = []
        for i in range(int(ost["step"]), int(ost["step"]) + steps):
            split = train_step.split_microbatches(stream.batch(i), micro)
            params, ost, err, m = step(params, ost, err, {k: jnp.asarray(v)
                                                         for k, v in split.items()})
            losses.append(float(m["loss"]))
        res[f"compressed_{name}"] = losses
        np.savez(f"{out}/compressed_{name}.npz",
                 **flat({"params": params, "opt": ost}), **flat(err, "err"))

    # tree_compressed_psum in a shard_map over n devices
    for n in spec.get("psum", ()):
        mesh = jax.make_mesh((n,), ("pod",), devices=devs[:n])
        ins = []
        for r in range(n):
            with np.load(f"{sys.argv[2]}{r}.npz") as z:
                arrays = {k: z[k] for k in z.files}
            trees = []
            for head in ("g", "e"):
                t = {}
                for key, v in arrays.items():
                    first, *path = key.strip("/").split("/")
                    if first == head:
                        node = t
                        for q in path[:-1]:
                            node = node.setdefault(q, {})
                        node[path[-1]] = v
                trees.append(t)
            ins.append(trees)
        stackd = lambda i: jax.tree.map(lambda *xs: np.stack(xs), *[x[i] for x in ins])
        def body(g, e):
            g = jax.tree.map(lambda x: x[0], g)
            e = jax.tree.map(lambda x: x[0], e)
            o, ne = compress.tree_compressed_psum(g, "pod", e)
            return jax.tree.map(lambda x: x[None], o), jax.tree.map(lambda x: x[None], ne)
        fn = jax.jit(jax.shard_map(body, mesh=mesh, in_specs=(P("pod"), P("pod")),
                                   out_specs=(P("pod"), P("pod")), check_vma=False))
        o, ne = fn(stackd(0), stackd(1))
        np.savez(f"{out}/psum_{n}.npz", **flat(o, "out"), **flat(ne, "err"))

    # the batch's device shards: flat over (pod, data), and pre-split
    if "compressed" in spec:
        print("REFERENCE " + json.dumps(res), flush=True)
        sys.exit(0)
    mesh4 = jax.make_mesh((2, 2), ("pod", "data"), devices=devs[:4])
    batch = TokenStream(CorpusConfig(vocab_size=512, seq_len=8, global_batch=8, seed=3)).batch(0)
    shards = {}
    for tag, arrs in [("flat", shard_batch(batch, mesh4, ("pod", "data"))),
                      ("split", {k: jax.device_put(v, NamedSharding(mesh4, P(None, ("pod", "data"))))
                                 for k, v in train_step.split_microbatches(batch, 2).items()}),
                      ("loader", next(iter(Loader(CorpusConfig(vocab_size=512, seq_len=8,
                                                                   global_batch=8, seed=3),
                                                      mesh=mesh4, data_axes=("pod", "data")))))]:
        for k, a in arrs.items():
            for sh in a.addressable_shards:
                coord = [int(c[0]) for c in np.nonzero(mesh4.devices == sh.device)]
                shards[f"{tag}|{k}|{coord[0]}{coord[1]}"] = np.asarray(sh.data)
    np.savez(f"{out}/shards.npz", **shards)
    print("REFERENCE " + json.dumps(res), flush=True)
    """
)


def psum_inputs(seed: int, rank: int) -> tuple[dict, dict]:
    """Rank ``rank``'s gradient and residual trees: normal draws of a
    different scale per leaf, the residual 1e-3 of that, and ``z`` all
    zeros (the scale's 1e-12 floor)."""
    rng = np.random.default_rng([seed, rank])

    def draw(shape, scale):
        return (rng.standard_normal(shape) * scale).astype(np.float32)

    sh = PSUM_SHAPES
    g = {"a": draw(sh["a"], 3.0), "b": {"c": draw(sh["b"]["c"], 1e-4),
                                        "d": draw(sh["b"]["d"], 50.0)},
         "z": np.zeros(sh["z"], np.float32)}
    e = {"a": draw(sh["a"], 3e-3), "b": {"c": draw(sh["b"]["c"], 1e-7),
                                         "d": draw(sh["b"]["d"], 5e-2)},
         "z": np.zeros(sh["z"], np.float32)}
    return g, e


def _flat_tree(tree, prefix="") -> dict:
    if not isinstance(tree, dict):
        return {prefix: tree}
    out = {}
    for k, v in tree.items():
        out.update(_flat_tree(v, f"{prefix}/{k}"))
    return out


def _spawn(n: int, jobs: list[dict], store: Path) -> list[subprocess.Popen]:
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src"), "OMP_NUM_THREADS": "1",
           "REPRO_SHARD_COORD": store.as_uri(), "REPRO_SHARD_N": str(n),
           "REPRO_SHARD_TIMEOUT_S": "60"}
    return [subprocess.Popen([sys.executable, WORKER, json.dumps(jobs)], stdout=subprocess.PIPE,
                             stderr=subprocess.PIPE, text=True,
                             env={**env, "REPRO_SHARD_ID": str(i)}) for i in range(n)]


def _collect(procs: list[subprocess.Popen]) -> list[tuple[int, str, str]]:
    """Every process's (rc, stdout, stderr); every one is killed on failure."""
    outs = []
    try:
        for p in procs:
            out, err = p.communicate(timeout=TIMEOUT_S)
            outs.append((p.returncode, out, err))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    return outs


def _results(outs) -> dict:
    """job name -> [each rank's result, rank order]."""
    bad = [f"rank exit {rc}:\n{err[-2500:]}" for rc, _, err in outs if rc != 0]
    assert not bad, "\n".join(bad)
    got: dict = {}
    for rc, out, err in outs:
        for line in out.splitlines():
            if line.startswith("RESULT "):
                r = json.loads(line[7:])
                got.setdefault(r["job"], []).append(r)
    return {k: sorted(v, key=lambda r: r["rank"]) for k, v in got.items()}


def _wait_for(path: Path, timeout: float = TIMEOUT_S) -> None:
    t0 = time.time()
    while not path.exists():
        assert time.time() - t0 < timeout, f"no {path}"
        time.sleep(0.05)


def _ckpt(path: Path, step: int) -> Path:
    return path / f"step_{step:09d}"


def _write_start(path: Path, kind: str) -> None:
    """The common state every run starts from: the port's seed-0 draw
    trained START steps on one device at ``kind``'s layout, the VLM's last
    VISION_WARM of them on demo batches with vision patches (warm moments:
    the first AdamW steps move every element by about lr times the sign of
    its gradient, which rounding decides where the gradient is near 0)."""
    seq, batch, micro = LAYOUT[kind]
    cfg = base.smoke_config(ARCHS[kind])
    api = get_model(cfg)
    text = START - (VISION_WARM if kind == "vlm" else 0)
    out = Trainer(api, CorpusConfig(vocab_size=cfg.vocab_size, seq_len=seq,
                                    global_batch=batch, seed=0), OPT,
                  TrainerConfig(steps=text, ckpt_every=text, microbatches=micro,
                                ckpt_dir=str(path), async_ckpt=False), device="cpu").run()
    if kind != "vlm":
        return
    model, opt = out["params"], out["opt"]
    step = train_step.make_train_step(api, OPT, microbatches=micro)
    for seed in range(VISION_WARM):
        b = api.demo_batch(base.ShapeConfig("t", seq, batch, "train"), seed=100 + seed)
        split = train_step.split_microbatches(b, micro)
        model, opt, _ = step(model, opt, {k: torch.as_tensor(v) for k, v in split.items()})
    Checkpointer(str(path)).save(START, checkpoint_state(model, opt))


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("mesh")
    for kind in ARCHS:
        _write_start(tmp / f"start_{kind}", kind)
        for who in ("ref", "port"):
            shutil.copytree(tmp / f"start_{kind}", tmp / f"{who}_{kind}")
    ref_out = tmp / "reference"
    ref_out.mkdir()
    for kind in ARCHS:
        shutil.copytree(tmp / f"start_{kind}", ref_out / f"start_{kind}")
        shutil.copytree(tmp / f"start_{kind}", ref_out / f"trainer_{kind}")
    trainers = {k: (ARCHS[k], *LAYOUT[k], END) for k in ARCHS}
    trainers["dense"] = (ARCHS["dense"], *LAYOUT["dense"], END + 2)  # the uninterrupted run
    spec = {"trainers": trainers, "vlm_step": (ARCHS["vlm"], 16, 4, 2),
            "compressed": COMPRESSED, "compressed_run": (ARCHS["dense"], 16, 8, 2, STEPS),
            "psum": [2, 4]}
    for r in range(4):
        g, e = psum_inputs(PSUM_SEED, r)
        np.savez(tmp / f"psum_in_{r}.npz", **_flat_tree(g, "g"), **_flat_tree(e, "e"))
    refs = [subprocess.Popen([sys.executable, "-c", REFERENCE, str(ref_out),
                              str(tmp / "psum_in_"), json.dumps(part)],
                             stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
                             env={**os.environ, "PYTHONPATH": str(ROOT / "src")})
            for part in ({"trainers": spec.pop("trainers")},
                         {k: spec.pop(k) for k in ("compressed", "compressed_run")}, spec)]

    def trainer_job(kind, d, steps, ckpt_every=STEPS, name=None):
        seq, batch, micro = LAYOUT[kind]
        return dict(job="trainer", name=name or f"trainer_{kind}", arch=ARCHS[kind], seq=seq,
                    batch=batch, micro=micro, steps=steps, ckpt_every=ckpt_every, dir=str(d))

    def compressed_job(name):
        return dict(job="compressed", name=f"compressed_{name}", arch=ARCHS["dense"],
                    dir=str(tmp / "start_dense"), dims=COMPRESSED[name], seq=16, batch=8,
                    micro=2, steps=STEPS, out=str(tmp / f"port_compressed_{name}.npz"))

    two = [trainer_job("dense", tmp / "port_dense", END, ckpt_every=2),
           dict(job="psum", inp=str(tmp / "psum_in_"), out=str(tmp / "port_psum_2_")),
           trainer_job("moe", tmp / "port_moe", END), trainer_job("vlm", tmp / "port_vlm", END),
           dict(job="vlm_step", arch=ARCHS["vlm"], dir=str(tmp / "start_vlm"), seq=16, batch=4,
                micro=2, out=str(tmp / "port_vlm_step.npz")),
           compressed_job("pod2"),
           dict(job="straddle", arch=ARCHS["moe"], seq=16, batch=4)]
    four = [dict(job="psum", inp=str(tmp / "psum_in_"), out=str(tmp / "port_psum_4_")),
            compressed_job("pod2xdata2"),
            dict(job="wait", path=str(tmp / "four_ready")),
            trainer_job("dense", tmp / "four", END + 2, name="restore_4")]
    spawns = [_spawn(2, two, tmp / "store2"), _spawn(4, four, tmp / "store4")]

    # one rank: restore the 2 ranks' checkpoint of step START + 2, run 2 steps
    one_dir = tmp / "one"
    try:
        _wait_for(_ckpt(tmp / "port_dense", START + 2) / "manifest.json")
        shutil.copytree(_ckpt(tmp / "port_dense", START + 2), _ckpt(one_dir, START + 2))
        seq, batch, micro = LAYOUT["dense"]
        cfg = base.smoke_config(ARCHS["dense"])
        one = Trainer(get_model(cfg), CorpusConfig(vocab_size=cfg.vocab_size, seq_len=seq,
                                                   global_batch=batch, seed=0), OPT,
                      TrainerConfig(steps=END + 1, ckpt_every=100, log_every=1, microbatches=micro,
                                    ckpt_dir=str(one_dir), async_ckpt=False), device="cpu")
        state, start = one.restore_or_init()
        restored_one = (start, train_step.state_digest(state["params"], state["opt"]),
                        train_step.replica_digest(dict(state["params"].named_parameters())))
        one_out = one.run()
        shutil.copytree(_ckpt(one_dir, END + 1), _ckpt(tmp / "four", END + 1))
        (tmp / "four_ready").touch()
        port = _results(_collect(spawns[0]) + _collect(spawns[1]))
        reference = {}
        for rc, out, err in _collect(refs):
            assert rc == 0, err[-3000:]
            reference.update(json.loads(out.strip().splitlines()[-1].split(" ", 1)[1]))
    finally:
        for p in [*refs, *spawns[0], *spawns[1]]:
            if p.poll() is None:
                p.kill()
                p.communicate()
    return dict(tmp=tmp, ref_out=ref_out, port=port, ref=reference,
                one=dict(restored=restored_one, losses=one_out["losses"],
                         final=train_step.state_digest(one_out["params"], one_out["opt"])))


def _flat_ckpt(path: Path, step: int) -> dict:
    """A checkpoint as {"params": {key: array}, "m", "v", "step"}."""
    flat, _ = Checkpointer(str(path)).restore_raw(step)
    out: dict = {"params": {}, "m": {}, "v": {}}
    for k, v in flat.items():
        name, key = k.split("|", 1)
        if name == "params":
            out["params"]["/" + key] = v
        elif key == "step":
            out["step"] = v
        else:
            kind, rest = key.split("/", 1)
            out[kind]["/" + rest] = v
    return out


def _flat_npz(path) -> dict:
    with np.load(path) as z:
        arrays = {k: z[k] for k in z.files}
    out: dict = {"params": {}, "m": {}, "v": {}, "err": {}}
    for k, v in arrays.items():
        head, rest = k.lstrip("/").split("/", 1)
        if head == "opt":
            kind, rest = rest.split("/", 1) if "/" in rest else (rest, "")
            if kind == "step":
                out["step"] = v
            else:
                out[kind]["/" + rest] = v
        else:
            out[head]["/" + rest] = v
    return out


def _rel_norm(a, b) -> float:
    return float(np.linalg.norm((a.astype(np.float64) - b).ravel())
                 / max(np.linalg.norm(b.ravel()), 1e-30))


def assert_follows(got: dict, want: dict, start: dict) -> None:
    """Every parameter within LOGITS, each leaf's change within CHANGE_REL of
    the reference's (the noisy key bias in the whole model's change)."""
    p, w, s = got["params"], want["params"], start["params"]
    assert p.keys() == w.keys() == s.keys()
    for key in w:
        np.testing.assert_allclose(p[key], w[key], **LOGITS, err_msg=key)
        if key not in NOISY_CHANGE:
            err = _rel_norm(p[key] - s[key], w[key] - s[key])
            assert err <= CHANGE_REL, f"change of {key}: {err:.3g} > {CHANGE_REL}"
    whole = [np.concatenate([(t[k] - s[k]).ravel() for k in sorted(w)]) for t in (p, w)]
    assert _rel_norm(*whole) <= CHANGE_REL


def _replicas_agree(results: list[dict], key: str = "digests") -> None:
    first = results[0][key]
    assert len(first) > 0
    for r in results[1:]:
        assert r[key] == first, f"rank {r['rank']} differs from rank 0"


# -- the compressed exchange -------------------------------------------------


@pytest.mark.parametrize("scale", [1e-6, 1.0, 300.0, 0.0])
def test_quantize_local_scale_bitwise(scale):
    """``quantize(g, None)`` is the reference's bit for bit: values, and the
    scale with its 1e-12 floor (an all-zero g)."""
    g = (np.random.default_rng(3).standard_normal((257, 33)) * scale).astype(np.float32)
    g[0, :4] = [0.5, -0.5, 1.5, -2.5]  # halves: round half to even
    q, s = compress.quantize(torch.as_tensor(g), None)
    rq, rs = ref_compress.quantize(jax.numpy.asarray(g), None)
    assert q.dtype == torch.int8 and np.array_equal(q.numpy(), np.asarray(rq))
    assert s.numpy().tobytes() == np.asarray(rs).tobytes()


@pytest.mark.parametrize("n", [2, 4])
def test_tree_compressed_psum_bitwise(runs, n):
    """Each rank's reduced tree and residual equal the reference's
    ``shard_map`` over ``n`` devices, bit for bit."""
    with np.load(runs["ref_out"] / f"psum_{n}.npz") as z:
        want = {k: z[k] for k in z.files}
    for r in range(n):
        with np.load(runs["tmp"] / f"port_psum_{n}_{r}.npz") as z:
            got = {k: z[k] for k in z.files}
        g, _ = psum_inputs(PSUM_SEED, r)
        q, s = ref_compress.quantize(jax.numpy.asarray(g["a"]), None)
        assert np.array_equal(got["q_local"], np.asarray(q)), r
        assert got["scale_local"].tobytes() == np.asarray(s).tobytes()
        for key, w in want.items():
            assert got[key].dtype == np.float32
            assert got[key].tobytes() == w[r].tobytes(), (r, key)


def test_init_error_state_and_one_rank_psum():
    """Residuals start at zero in f32; ``compressed_psum`` needs a group."""
    tree = {"a": torch.ones(3, 2, dtype=torch.bfloat16), "b": {"c": torch.ones(4)}}
    err = compress.init_error_state(tree)
    assert err["a"].dtype == torch.float32 and err["a"].shape == (3, 2)
    assert not err["b"]["c"].any()
    want = ref_compress.init_error_state({"a": np.ones((3, 2)), "b": {"c": np.ones(4)}})
    assert np.asarray(want["a"]).dtype == np.float32


# -- the Trainer on 2 ranks --------------------------------------------------


@pytest.mark.parametrize("kind", list(ARCHS))
def test_data_parallel_trainer_follows_reference(runs, kind):
    """2 ranks against the reference's ``Trainer(mesh=(2,) data)``: the losses
    within LOGITS, every leaf as ``assert_follows`` holds it, the ranks'
    parameters bit-identical after every step."""
    got = runs["port"][f"trainer_{kind}"]
    assert [r["ranks"] for r in got] == [2, 2]
    _replicas_agree(got)
    assert [s for s, _ in got[0]["digests"]] == list(range(START + 1, END + 1))
    want_losses = runs["ref"][f"trainer_{kind}"][:STEPS]
    assert [s for s, _ in got[0]["losses"]] == [s for s, _ in want_losses]
    for r in got:
        assert r["losses"] == got[0]["losses"]
    np.testing.assert_allclose([x for _, x in got[0]["losses"]],
                               [x for _, x in want_losses], **LOGITS)
    start = _flat_ckpt(runs["tmp"] / f"start_{kind}", START)
    port = _flat_ckpt(runs["tmp"] / f"port_{kind}", END)
    ref = _flat_ckpt(runs["ref_out"] / f"trainer_{kind}", END)
    assert int(port["step"]) == int(ref["step"]) == END
    assert_follows(port, ref, start)


def test_microbatched_vlm_step_with_positions(runs):
    """The VLM's data-parallel step on a batch of vision patches and (3, B, S)
    positions in 2 microbatches: each rank holds one row of each microbatch
    (positions split on their B dim), and the step follows the reference's."""
    got = runs["port"]["vlm_step"]
    assert all(r["agree"] for r in got) and got[0]["digest"] == got[1]["digest"]
    assert got[0]["shapes"] == {"tokens": [2, 1, 16], "labels": [2, 1, 16],
                                "vision_embeds": [2, 1, 8, 48], "vision_pos": [2, 1, 8],
                                "positions": [2, 3, 1, 16]}
    np.testing.assert_allclose(got[0]["loss"], runs["ref"]["vlm_step"], **LOGITS)
    start = _flat_ckpt(runs["tmp"] / "start_vlm", START)
    assert_follows(_flat_npz(runs["tmp"] / "port_vlm_step.npz"),
                   _flat_npz(runs["ref_out"] / "vlm_step.npz"), start)


# -- the compressed cross-pod step ----------------------------------------


@pytest.mark.parametrize("name", list(COMPRESSED))
def test_compressed_step_follows_reference(runs, name):
    """``make_train_step(compress_pods=True)`` against the reference's over the
    same mesh: the losses within LOGITS, the parameters as
    ``assert_follows`` holds them, the residuals' norm within CHANGE_REL,
    the replicas bit-identical after every step."""
    got = runs["port"][f"compressed_{name}"]
    for r in got:
        assert all(a for a, _ in r["digests"])
        assert r["digests"] == got[0]["digests"] and r["losses"] == got[0]["losses"]
    np.testing.assert_allclose(got[0]["losses"], runs["ref"][f"compressed_{name}"], **LOGITS)
    port = _flat_npz(runs["tmp"] / f"port_compressed_{name}.npz")
    ref = _flat_npz(runs["ref_out"] / f"compressed_{name}.npz")
    assert_follows(port, ref, _flat_ckpt(runs["tmp"] / "start_dense", START))
    norm = lambda e: np.sqrt(sum(float(np.sum(v.astype(np.float64) ** 2))  # noqa: E731
                                 for v in e.values()))
    assert got[0]["err_norm"] > 0
    assert abs(norm(port["err"]) - norm(ref["err"])) <= CHANGE_REL * norm(ref["err"])


# -- elastic restore -------------------------------------------------------


def test_elastic_restore_two_to_one(runs):
    """One rank restores the 2 ranks' checkpoint of step START + 2 bit for bit
    (their parameters, moments and step as they held them then), and its
    next 2 steps follow the uninterrupted reference within LOGITS, and the 2
    ranks' same step within 1e-4 (the reduction order)."""
    two = runs["port"]["trainer_dense"][0]
    start, restored, params = runs["one"]["restored"]
    assert start == START + 2 and params == dict(two["digests"])[START + 2]
    assert restored == dict(two["states"])[START + 2]
    losses = runs["one"]["losses"]
    assert [s for s, _ in losses] == [END, END + 1]
    want = dict(runs["ref"]["trainer_dense"])
    np.testing.assert_allclose([x for _, x in losses], [want[s] for s, _ in losses], **LOGITS)
    np.testing.assert_allclose(losses[0][1], dict(two["losses"])[END], rtol=1e-4)


def test_elastic_restore_one_to_four(runs):
    """4 ranks restore the one rank's checkpoint bit for bit and run one more
    step within LOGITS of the uninterrupted reference; the 4 replicas
    agree."""
    got = runs["port"]["restore_4"]
    assert [r["ranks"] for r in got] == [4] * 4
    for r in got:
        assert r["start"] == END + 1 and r["restored"] == runs["one"]["final"]
    _replicas_agree(got)
    assert [s for s, _ in got[0]["losses"]] == [END + 2]
    np.testing.assert_allclose(got[0]["losses"][0][1],
                               dict(runs["ref"]["trainer_dense"])[END + 2],
                               **LOGITS)



# -- the batch layout ------------------------------------------------------


class _FakeWorld:
    """Rank ``rank`` of a ``fake`` process group of ``n`` ranks in this
    process (no collective runs), for layouts on a mesh without ranks."""

    def __init__(self, rank: int, n: int):
        self.rank, self.n = rank, n

    def __enter__(self):
        import torch.distributed as dist
        from torch.testing._internal.distributed.fake_pg import FakeStore

        assert not dist.is_initialized()
        dist.init_process_group("fake", store=FakeStore(), rank=self.rank, world_size=self.n)
        return self

    def __exit__(self, *exc):
        import torch.distributed as dist

        dist.destroy_process_group()


def _mesh4():
    from torch.distributed.device_mesh import DeviceMesh

    return DeviceMesh("cpu", torch.arange(4).reshape(2, 2), mesh_dim_names=("pod", "data"))


@pytest.mark.parametrize("tag", ["flat", "split", "loader"])
def test_shard_batch_gives_each_rank_its_rows(runs, tag):
    """On a (pod=2, data=2) mesh each rank holds exactly the reference's
    device shard of the batch: flat (rows over ("pod", "data"), pod major),
    pre-split into 2 microbatches (rows of every microbatch), and from
    ``Loader(mesh=)``."""
    with np.load(runs["ref_out"] / "shards.npz") as z:
        want = {k: z[k] for k in z.files if k.startswith(tag + "|")}
    cfg = CorpusConfig(vocab_size=512, seq_len=8, global_batch=8, seed=3)
    batch = TokenStream(cfg).batch(0)
    for rank in range(4):
        with _FakeWorld(rank, 4):
            mesh = _mesh4()
            if tag == "flat":
                got = shard_batch(batch, mesh, ("pod", "data"))
            elif tag == "split":
                got = shard_batch(train_step.split_microbatches(batch, 2), mesh,
                                  ("pod", "data"), microbatched=True)
            else:
                got = next(iter(Loader(cfg, mesh=mesh, data_axes=("pod", "data"))))
            coord = "".join(str(c) for c in mesh.get_coordinate())
        for k, v in got.items():
            assert np.array_equal(v.numpy(), want[f"{tag}|{k}|{coord}"]), (rank, k)


def test_shard_batch_positions_split_on_their_batch_dim():
    """M-RoPE positions (3, B, S) split on dim 1 (dim 2 once pre-split)."""
    pos = np.broadcast_to(np.arange(8 * 4).reshape(1, 8, 4), (3, 8, 4)).copy()
    with _FakeWorld(1, 2):
        from torch.distributed.device_mesh import DeviceMesh

        mesh = DeviceMesh("cpu", torch.arange(2), mesh_dim_names=("data",))
        flat = shard_batch({"positions": pos}, mesh)["positions"]
        split = shard_batch(train_step.split_microbatches({"positions": pos}, 2), mesh,
                            microbatched=True)["positions"]
    assert np.array_equal(flat.numpy(), pos[:, 4:])
    assert split.shape == (2, 3, 2, 4)
    assert np.array_equal(split[0].numpy(), pos[:, 2:4]) and np.array_equal(
        split[1].numpy(), pos[:, 6:8])


# -- what raises -----------------------------------------------------------


def test_straddling_moe_groups_raise(runs):
    """A MoE layout whose routing groups straddle the ranks (2 ranks of 2 x 16
    tokens: the reference routes each 64-token microbatch as one group)
    raises, naming the layout, on every rank."""
    for r in runs["port"]["straddle"]:
        assert r["raised"] and "straddle ranks" in r["raised"] and "64 tokens" in r["raised"]


@pytest.mark.parametrize("arch,local,ranks,ok", [
    ("moonshot_v1_16b_a3b", 512, 2, True), ("moonshot_v1_16b_a3b", 1024, 4, True),
    ("moonshot_v1_16b_a3b", 32, 2, False), ("moonshot_v1_16b_a3b", 768, 2, False),
    ("jamba_v0_1_52b", 256, 2, False), ("moonshot_v1_16b_a3b", 32, 1, True),
    ("qwen1_5_0_5b", 32, 2, True)])
def test_check_moe_groups(arch, local, ranks, ok):
    """Whole groups a rank pass; a straddling layout raises; a model without
    experts, or one rank, never does."""
    cfg = base.smoke_config(arch)
    if ok:
        train_step.check_moe_groups(cfg, local, ranks)
    else:
        with pytest.raises(ValueError, match="straddle"):
            train_step.check_moe_groups(cfg, local, ranks)


def test_model_axis_raises_naming_item_17():
    """A mesh whose ``model`` axis has more than one rank is tensor
    parallelism, now ported: the Trainer and the step take it, and the
    data-parallel compressed step refuses it."""
    from torch.distributed.device_mesh import DeviceMesh

    cfg = base.smoke_config(ARCHS["dense"])
    api = get_model(cfg)
    with _FakeWorld(0, 4):
        mesh = DeviceMesh("cpu", torch.arange(4).reshape(2, 2), mesh_dim_names=("data", "model"))
        assert Trainer(api, CorpusConfig(vocab_size=cfg.vocab_size), OPT, TrainerConfig(),
                       mesh=mesh, device="cpu").tp
        assert train_step.tensor_parallel(mesh)
        assert callable(train_step.make_train_step(api, OPT, mesh=mesh))
        pods = DeviceMesh("cpu", torch.arange(4).reshape(2, 2), mesh_dim_names=("pod", "model"))
        with pytest.raises(ValueError, match="model axis"):
            train_step.make_train_step(api, OPT, compress_pods=True, mesh=pods)
    with pytest.raises(ValueError, match="pod"):
        train_step.make_train_step(api, OPT, compress_pods=True)
