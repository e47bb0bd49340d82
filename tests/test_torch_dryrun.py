"""The multi-pod dry run (``launch/dryrun.py``), its analysis
(``launch/hlo_analysis.py``) and its roofline (``launch/roofline.py``)
against the reference's, on 256- and 512-rank ``fake`` process groups.

* every arch x shape cell's status, and a skipped cell's record, are the
  reference's (``shape_applicable``);
* ``param_count``, ``active_param_count`` and ``model_flops`` equal the
  reference's for all ten archs, and every ok cell's per-rank argument
  bytes equal the sum of the reference's ``NamedSharding.shard_shape``
  bytes of its parameters, optimizer state (or KV cache) and batch (a
  subprocess of 512 XLA host devices; nothing is compiled);
* a dense cell's counted matrix-product FLOPs equal a closed form of its
  projections, attention and unembedding, forward, backward and remat;
* the EM cell's record;
* ``analyze`` against the reference's ``analyze`` on HLO text that
  carries the same collectives (group size, cross-pod, wire bytes);
* ``roofline.terms`` against the reference's formula with the H100's
  constants.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs import base as ref_base  # noqa: E402
from repro.launch import hlo_analysis as ref_ha  # noqa: E402
from repro.launch import roofline as ref_roofline  # noqa: E402
from repro_torch.configs import base  # noqa: E402
from repro_torch.launch import dryrun, hlo_analysis, roofline  # noqa: E402
from repro_torch.launch.sharding import cast_params  # noqa: E402
from repro_torch.models.param import param_count  # noqa: E402
from repro_torch.models.registry import get_model  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
CELLS = [(a, s) for a in base.ARCH_IDS for s in base.SHAPES]

REFERENCE = textwrap.dedent(
    """
    import json, sys
    import numpy as np
    import jax, jax.numpy as jnp
    from jax.sharding import NamedSharding
    from repro.launch import dryrun  # sets 512 host devices before jax starts
    from repro.configs.base import ARCH_IDS, SHAPES, get_config, shape_applicable
    from repro.launch import sharding as shardlib
    from repro.launch.mesh import make_production_mesh, pod_spec
    from repro.models.param import abstract_params, filter_spec, param_count
    from repro.models.registry import get_model
    from repro.train.train_step import microbatched_specs
    import dataclasses

    def nbytes(sds, sharding):
        return int(np.prod(sharding.shard_shape(sds.shape))) * jnp.dtype(sds.dtype).itemsize

    def tree_bytes(abs_tree, shard_tree):
        return sum(nbytes(a, s) for a, s in zip(jax.tree.leaves(abs_tree),
                                                 jax.tree.leaves(shard_tree)))

    out = {"counts": {}, "args": {}}
    for arch in ARCH_IDS:
        cfg = get_config(arch)
        for kind, cast in (("train", False), ("decode", True)):
            specs = get_model(cfg).param_specs()
            if cast:
                specs = shardlib.cast_params(specs, jnp.bfloat16)
            out["counts"][f"{arch}|{kind}"] = [param_count(specs),
                                                dryrun.active_param_count(cfg, specs)]
    for multi_pod in (False, True):
        mesh = make_production_mesh(multi_pod=multi_pod)
        dsz = shardlib.data_axis_size(mesh) * (2 if multi_pod else 1)
        for arch in ARCH_IDS:
            for name, shape in SHAPES.items():
                cfg = get_config(arch)
                if not shape_applicable(cfg, shape)[0]:
                    continue
                if shape.kind == "train":
                    cfg = dataclasses.replace(cfg, remat_group=shardlib.default_remat_group(
                        cfg.n_layers))
                    api = get_model(cfg)
                    specs = shardlib.fsdp_params(api.param_specs(), mesh)
                    pshard = shardlib.param_shardings(specs, mesh)
                    pabs = abstract_params(specs)
                    mb = shardlib.pick_microbatches(shape.global_batch, dsz, shape.seq_len)
                    babs, bpsp = microbatched_specs(dict(api.input_specs(shape)),
                                                    api.input_pspecs(shape), mb)
                    total = 3 * tree_bytes(pabs, pshard) + 4
                    for k, sds in babs.items():
                        sp = shardlib.drop_indivisible(filter_spec(pod_spec(bpsp[k], mesh), mesh),
                                                       sds.shape, mesh)
                        total += nbytes(sds, NamedSharding(mesh, sp))
                else:
                    api = get_model(cfg)
                    specs = shardlib.cast_params(api.param_specs(), jnp.bfloat16)
                    if param_count(specs) * 2 / 16 > 8e9:
                        specs = shardlib.fsdp_params(specs, mesh)
                    total = tree_bytes(abstract_params(specs),
                                       shardlib.param_shardings(specs, mesh))
                    cs = api.cache_specs(shape.global_batch, shape.seq_len)
                    total += tree_bytes(abstract_params(cs), shardlib.state_shardings(cs, mesh))
                    bsh = shardlib.input_shardings(api, shape, mesh)
                    total += sum(nbytes(sds, bsh[k]) for k, sds in api.input_specs(shape).items())
                out["args"][f"{arch}|{name}|{multi_pod}"] = int(total)
    print("REFERENCE " + json.dumps(out))
    """
)


@pytest.fixture(scope="module")
def reference():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu")
    out = subprocess.run([sys.executable, "-c", REFERENCE], capture_output=True, text=True,
                         env=env, timeout=240)
    assert out.returncode == 0, out.stderr[-3000:]
    line = [ln for ln in out.stdout.splitlines() if ln.startswith("REFERENCE ")][-1]
    return json.loads(line[len("REFERENCE "):])


@pytest.mark.parametrize("arch,shape", CELLS)
def test_cell_status_is_the_references(arch, shape):
    ok, why = base.shape_applicable(base.get_config(arch), base.SHAPES[shape])
    want = ref_base.shape_applicable(ref_base.get_config(arch), ref_base.SHAPES[shape])
    assert (ok, why) == want
    if not ok:
        for multi_pod in (False, True):
            assert dryrun.lower_cell(arch, shape, multi_pod) == {
                "arch": arch, "shape": shape, "mesh": "2x16x16" if multi_pod else "16x16",
                "status": "skipped", "reason": want[1]}


@pytest.mark.parametrize("arch", base.ARCH_IDS)
def test_model_counts_are_the_references(reference, arch):
    cfg = base.get_config(arch)
    for kind in ("train", "decode"):
        specs = get_model(cfg).param_specs()
        if kind == "decode":
            specs = cast_params(specs, torch.bfloat16)
        got = [param_count(specs), dryrun.active_param_count(cfg, specs)]
        assert got == reference["counts"][f"{arch}|{kind}"], kind
        for name, shape in base.SHAPES.items():
            if shape.kind != kind:
                continue
            tokens = shape.global_batch * (shape.seq_len if kind == "train" else 1)
            ref_flops = (6 if kind == "train" else 2) * reference["counts"][f"{arch}|{kind}"][1] \
                * tokens
            assert (6 if kind == "train" else 2) * got[1] * tokens == ref_flops, name


@pytest.mark.parametrize("multi_pod", [False, True], ids=["16x16", "2x16x16"])
@pytest.mark.parametrize("arch", base.ARCH_IDS)
def test_argument_bytes_are_the_references(reference, arch, multi_pod):
    for shape in base.SHAPES:
        key = f"{arch}|{shape}|{multi_pod}"
        if key in reference["args"]:
            assert dryrun.argument_bytes(arch, shape, multi_pod) == reference["args"][key], shape


def test_dense_cell_matmul_flops_equal_the_closed_form():
    """Qwen1.5-0.5B x train_4k on 16 x 16, per rank: 8 microbatches of 2 rows
    x 4,096 tokens (T = 8,192), one head and 176 FFN columns a rank.  Each
    layer's products run forward, again in the remat recompute, and twice
    in the backward, but for the last product of each remat group, which
    PyTorch's checkpoint does not recompute (nothing of its output is
    needed); the unembedding runs once forward and twice backward."""
    rec = dryrun.lower_cell("qwen1_5_0_5b", "train_4k", False)
    cfg = base.get_config("qwen1_5_0_5b")
    m, T, B, S = 16, 8192, 2, 4096
    d, hd, L = cfg.d_model, cfg.head_dim, cfg.n_layers
    cols, f = cfg.n_heads * hd // m, cfg.d_ff // m
    layer = (2 * T * d * 3 * cols          # q, k, v (column-parallel)
             + 4 * B * (cfg.n_heads // m) * S * S * hd  # scores and values, every pair
             + 2 * T * cols * d            # o (row-parallel)
             + 3 * 2 * T * d * f)          # gate, up and down
    groups = L // rec["remat_group"]
    per_mb = L * 4 * layer - groups * 2 * T * f * d + 3 * 2 * T * d * (cfg.vocab_size // m)
    assert rec["multipliers"] == {"microbatches": 8, "layer_groups": groups,
                                  "layers_per_group": rec["remat_group"]}
    assert rec["matmul_flops"] == 8 * per_mb
    assert rec["hlo_flops"] > rec["matmul_flops"]  # and the elementwise work
    assert rec["temp_bytes_is_estimate"] and rec["bf16_upcast_bytes"] == 0


@pytest.mark.parametrize("multi_pod", [False, True], ids=["16x16", "2x16x16"])
def test_em_cell_record(multi_pod):
    rec = dryrun.lower_em_cell(multi_pod)
    n = 512 if multi_pod else 256
    B, k, P, universe = 8192, 32, 496, 1 << 20
    assert (rec["arch"], rec["shape"], rec["mesh"], rec["kind"], rec["status"]) == (
        "em_round_mln", f"k{k}_B{B}", "2x16x16" if multi_pod else "16x16", "em_round", "ok")
    assert (rec["n_chips"], rec["tokens_per_step"], rec["rows_a_rank"]) == (n, B, B // n)
    assert rec["model_flops"] == float(B * 2 * P ** 3)
    b = B // n
    # masks and the int8 levels a byte an entry, uidx four, the bitset replicated
    assert rec["mem"]["argument_bytes"] == b * k + b * k * k + 2 * b * P + 4 * b * P + universe
    # the bitset reduced over every rank, x and the labels gathered back
    assert set(rec["collectives_by_kind"]) == {"all-reduce", "all-gather"}
    assert rec["collectives_by_kind"]["all-reduce"] == 2.0 * universe
    assert (rec["collective_cross_pod_bytes"] > 0) == multi_pod
    assert rec["unknown_whiles"] > 0 and rec["hlo_flops"] > 0


def _hlo(lines: list[str]) -> str:
    body = "\n".join(f"  {ln}" for ln in lines)
    return ("HloModule m\n\n%add (a: f32[], b: f32[]) -> f32[] {\n  %a = f32[] parameter(0)\n"
            "  %b = f32[] parameter(1)\n  ROOT %s = f32[] add(%a, %b)\n}\n\n"
            "ENTRY %main (p0: f32[1024], p1: bf16[64,128]) -> f32[1024] {\n"
            "  %p0 = f32[1024]{0} parameter(0)\n  %p1 = bf16[64,128]{1,0} parameter(1)\n"
            f"{body}\n  ROOT %r = f32[1024]{{0}} add(%p0, %p0)\n}}\n")


# (HLO line, the port's record of it): kind, result bytes, rank 0's group
SNIPPETS = {
    "all-reduce in pairs": [
        ("%ar = f32[1024]{0} all-reduce(%p0), replica_groups={{0,1},{2,3}}, to_apply=%add",
         ("all-reduce", 4096, (0, 1)))],
    "all-gather across pods": [
        ("%ag = bf16[128,128]{1,0} all-gather(%p1), replica_groups=[256,2]<=[2,256]T(1,0), "
         "dimensions={0}", ("all-gather", 128 * 128 * 2, (0, 256)))],
    "mixed": [
        ("%ar = f32[1024]{0} all-reduce(%p0), replica_groups=[2,256]<=[512], to_apply=%add",
         ("all-reduce", 4096, tuple(range(256)))),
        ("%rs = f32[512]{0} reduce-scatter(%p0), replica_groups=[256,2]<=[512], "
         "dimensions={0}, to_apply=%add", ("reduce-scatter", 2048, (0, 1))),
        ("%ag = bf16[128,128]{1,0} all-gather(%p1), replica_groups=[256,2]<=[2,256]T(1,0), "
         "dimensions={0}", ("all-gather", 128 * 128 * 2, (0, 256))),
        ("%a2 = f32[1024]{0} all-reduce(%p0), replica_groups=[1,512]<=[512], to_apply=%add",
         ("all-reduce", 4096, tuple(range(512)))),
    ],
}
KEYS = ["collective_bytes", "collective_wire_bytes", "collective_cross_pod_bytes",
        "collectives_by_kind", "n_collective_sites", "bf16_upcast_bytes"]


@pytest.mark.parametrize("name", list(SNIPPETS))
def test_analyze_equals_the_references_on_hlo(name):
    want = ref_ha.analyze(_hlo([ln for ln, _ in SNIPPETS[name]]), n_devices=512,
                          pod_boundary=256)
    counts = hlo_analysis.Counts(collectives=[
        {"kind": k, "bytes": b, "ranks": r} for _, (k, b, r) in SNIPPETS[name]])
    got = hlo_analysis.analyze(counts, pod_boundary=256)
    assert {k: got[k] for k in KEYS} == {k: want[k] for k in KEYS}


def test_roofline_terms_are_the_references_formula_at_h100_constants(monkeypatch):
    for attr, value in (("PEAK_FLOPS", 989e12), ("HBM_BW", 3.35e12), ("ICI_BW", 450e9),
                        ("DCN_BW", 50e9)):
        monkeypatch.setattr(ref_roofline, attr, value)
    assert (roofline.PEAK_FLOPS, roofline.HBM_BW, roofline.NVLINK_BW, roofline.NIC_BW,
            roofline.HBM_GB) == (989e12, 3.35e12, 450e9, 50e9, 80)
    rng = np.random.default_rng(0)
    for _ in range(6):
        rec = {"hlo_flops": float(rng.uniform(1e12, 1e15)),
               "hlo_bytes": float(rng.uniform(1e9, 1e12)),
               "collective_wire_bytes": float(rng.uniform(1e9, 1e12)),
               "n_chips": 512, "model_flops": float(rng.uniform(1e14, 1e17)),
               "mem": {"argument_bytes": 10, "temp_bytes": 20, "output_bytes": 5,
                       "alias_bytes": 5}, "bf16_upcast_bytes": 0.0, "kind": "train",
               "params": 1e9, "arch": "qwen1_5_0_5b"}
        rec["collective_cross_pod_bytes"] = rec["collective_wire_bytes"] * rng.uniform(0, 0.5)
        got, want = roofline.terms(rec), ref_roofline.terms(rec)
        assert got == pytest.approx(want) and got["bound"] == want["bound"]
        assert roofline.advice(rec, got) is not None
