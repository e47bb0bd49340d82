"""Multi-pod dry run: build every (arch x shape x mesh) cell's step without running it.

The reference lowers and compiles each cell's step for 512 placeholder
host devices and reads the compiled program.  Here each cell's step is
built on ``meta`` tensors (shapes and dtypes, no storage) over a
``fake`` process group of 256 or 512 ranks (rank 0 of it: no collective
runs, no device is touched), with the reference's layouts as DTensor
placements (``launch/sharding.py``), and run once under
:class:`repro_torch.launch.hlo_analysis.OpCounter`, which counts what
this rank would run: its local operations (FLOPs, an HBM-bytes proxy)
and the collectives DTensor places, by kind, bytes and group.  The two
production meshes:

  * the single-pod mesh  (data=16, model=16)      — 256 ranks, and
  * the multi-pod mesh   (pod=2, data=16, model=16) — 512 ranks,

for every assigned architecture x input-shape cell, plus the EM-round
cell (:func:`lower_em_cell`).  Each record keeps the reference's keys
and file name (``<arch>__<shape>__<mesh>.json``);
:mod:`repro_torch.launch.roofline` reads them.

**Keeping the grid tractable.**  The reference's ``lax.scan`` over layer
groups and microbatches is counted once and multiplied by its trip
count.  Here a train cell traces one microbatch through one and two
remat groups of layers (one and two periods of the hybrid), a decode
cell one and two layers; the second trace less the first is one group's
work, and the record is the first plus ``groups - 1`` such differences,
the microbatch part times ``microbatches`` (``multipliers`` names them).
The optimizer's update is traced the same way, once a step.  The first
trace of each cell runs twice and the second run is counted
(:func:`_warm`; a decode cell's second depth too, its stacked cache
having new shapes).

**How each key is measured.**  ``hlo_flops``: the matrix products'
FLOPs by ``FlopCounterMode``'s registry plus one an element for
elementwise ops and reductions; ``hlo_bytes``: each op's result, and the
operands of products and reductions; collectives from the functional
collectives DTensor issues; ``mem.argument_bytes``: exact, the local
blocks of the parameters, optimizer state and batch under their
placements; ``mem.temp_bytes``: an estimate, the peak bytes of the
tensors the traced step allocates (``temp_bytes_is_estimate``);
``lower_s``: laying the cell out, ``compile_s``: the traces.  A kernel
wrapper takes its plain version on ``meta`` tensors, so attention is
counted as the plain version computes it (every score of the square, as
the reference's XLA attention does).

**The EM cell** runs one legacy round (:func:`repro_torch.core.parallel.
build_round_fn`) on rank 0's rows, on CPU tensors (the matcher's loops
read a change flag on the host, which ``meta`` cannot give), with every
``pair_mask`` False, so each fixpoint loop ends after one pass; each such
host read counts as one loop of unknown trip count (``unknown_whiles``).

Usage::

    PYTHONPATH=src python -m repro_torch.launch.dryrun --mesh both            # all cells
    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen1_5_0_5b \\
        --shape train_4k --mesh pod
    PYTHONPATH=src python -m repro_torch.launch.dryrun --em                   # EM round cell
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import math
import os
import time
import traceback

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.configs.base import ARCH_IDS, SHAPES, get_config, shape_applicable
from repro_torch.launch import hlo_analysis
from repro_torch.launch import sharding as shardlib
from repro_torch.launch.mesh import NamedSharding, make_production_mesh, pod_spec
from repro_torch.models.param import abstract_params, filter_spec, in_f32, leaves, param_count
from repro_torch.models.registry import get_model

OUT_DIR = os.path.join("experiments", "dryrun")


def mesh_name(multi_pod: bool) -> str:
    return "2x16x16" if multi_pod else "16x16"


@contextlib.contextmanager
def fake_world(n: int):
    """Rank 0 of a ``fake`` process group of ``n`` ranks, unless a group of
    at least ``n`` ranks is joined already (then that one)."""
    if dist.is_initialized():
        if dist.get_world_size() < n:
            raise ValueError(f"a {n}-rank mesh in a group of {dist.get_world_size()} ranks")
        yield
        return
    from torch.testing._internal.distributed.fake_pg import FakeStore

    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=n)
    try:
        yield
    finally:
        dist.destroy_process_group()


def _mesh(multi_pod: bool):
    return make_production_mesh(multi_pod=multi_pod, device_type="cpu")


def active_param_count(cfg, specs) -> int:
    """Params touched per token: total minus the (1 - k/E) unused experts."""
    total = param_count(specs)
    if not cfg.n_experts:
        return total
    f = cfg.moe_d_ff or cfg.d_ff
    per_expert = cfg.d_model * 2 * f + f * cfg.d_model
    if cfg.family == "hybrid":
        from repro_torch.models.hybrid import _is_moe

        n_moe = sum(_is_moe(cfg, i) for i in range(cfg.n_layers))
    else:
        n_moe = cfg.n_layers
    unused = n_moe * (cfg.n_experts - cfg.experts_per_token) * per_expert
    return total - unused


def _local_bytes(tree, shardings) -> int:
    """Bytes of this rank's blocks of a PSpec tree under a sharding tree."""
    total = 0
    for ps, ns in zip(leaves(tree), leaves(shardings)):
        n = math.prod(s.stop - s.start for s in ns.block(ps.shape))
        total += n * torch.empty((), dtype=ps.dtype).element_size()
    return total


def _depth(cfg, unit: int, groups: int):
    """``cfg`` cut to ``groups`` units of ``unit`` layers (the encoder cut
    in proportion)."""
    n = unit * groups
    enc = cfg.encoder_layers * n // cfg.n_layers if cfg.encoder_layers else 0
    return dataclasses.replace(cfg, n_layers=n, encoder_layers=enc)


def _scaled(one: hlo_analysis.Counts, two: hlo_analysis.Counts, groups: int,
            times: int = 1) -> hlo_analysis.Counts:
    """``times`` x (the one-unit counts + ``groups - 1`` units' worth of the
    two-unit counts less the one-unit ones); the peak bytes of one run plus
    ``groups - 1`` units' growth (each unit's saved input)."""
    per = two.minus(one)
    out = hlo_analysis.Counts()
    out.add(one, times)
    out.add(per, (groups - 1) * times)
    out.peak_bytes = one.peak_bytes + (groups - 1) * per.peak_bytes
    return out


def _dtensor_batch(batch_abs: dict, bshard: dict) -> dict:
    from torch.distributed.tensor import DTensor

    out = {}
    for k, t in batch_abs.items():
        ns = bshard[k]
        local = torch.empty([s.stop - s.start for s in ns.block(t.shape)], dtype=t.dtype,
                            device="meta")
        out[k] = DTensor.from_local(local, ns.mesh, ns.placements, run_check=False,
                                    shape=t.shape, stride=t.stride())
    return out


def _trace_train(api, specs, mesh, batch_abs, bshard, opt_cfg):
    """One microbatch's loss and gradients, and the update, of ``api``'s
    model over ``mesh`` on ``meta`` tensors: (microbatch counts, update
    counts)."""
    from torch.distributed.tensor.experimental import implicit_replication

    from repro_torch.models.layers import use_mesh
    from repro_torch.train.optimizer import adamw_update
    from repro_torch.train.train_step import distribute_model, sharded_global_norm

    model = distribute_model(api.load(abstract_params(in_f32(specs)), trainable=True),
                             api, mesh, specs)
    names, params = zip(*model.named_parameters())
    batch = _dtensor_batch(batch_abs, bshard)
    mb = hlo_analysis.OpCounter(track_memory=True)
    with use_mesh(mesh), implicit_replication(), mb:
        loss, _ = api.loss(model, batch)
        grads = torch.autograd.grad(loss, params, allow_unused=True)
    upd = hlo_analysis.OpCounter()
    with use_mesh(mesh), implicit_replication(), upd:
        local = {n: (torch.zeros_like(p) if g is None else g).redistribute(
            mesh, p.placements).to_local().float() for n, p, g in zip(names, params, grads)}
        norm = sharded_global_norm(local, {n: p.placements for n, p in zip(names, params)}, mesh)
        state = {"m": {n: torch.zeros_like(t) for n, t in local.items()},
                 "v": {n: torch.zeros_like(t) for n, t in local.items()},
                 "step": torch.zeros((), dtype=torch.int32, device="meta")}
        adamw_update(opt_cfg, {n: p.detach().to_local() for n, p in zip(names, params)},
                     local, state, norm=norm)
    return mb.counts, upd.counts


def _trace_decode(api, specs, mesh, cache_specs, cshard, batch_abs, bshard):
    """One decode step of ``api``'s served model over ``mesh`` on ``meta``."""
    from torch.distributed.tensor.experimental import implicit_replication

    from repro_torch.models.layers import use_mesh
    from repro_torch.train.train_step import distribute_model

    model = distribute_model(api.load(abstract_params(specs)), api, mesh, specs)
    cache = shardlib.distribute_state(abstract_params(cache_specs), cshard)
    batch = _dtensor_batch(batch_abs, bshard)
    c = hlo_analysis.OpCounter(track_memory=True)
    with torch.no_grad(), use_mesh(mesh), implicit_replication(), c:
        api.decode(model, cache, batch)
    return c.counts


def _unit(cfg, kind: str, rg: int) -> int:
    """Layers a traced unit holds: a remat group for training (a period of
    the hybrid), one layer (a period) for decode."""
    if cfg.family == "hybrid":
        return cfg.period or cfg.attn_layer_period
    if kind == "train" and rg > 1 and cfg.n_layers % rg == 0:
        return rg
    return 1


def lower_cell(arch: str, shape_name: str, multi_pod: bool, *,
               fsdp: str = "auto", microbatches: int | None = None,
               remat_group: int | None = None, donate: bool = True,
               tp: str = "on"):
    """Build and count one cell; return the metrics dict (the reference's keys)."""
    shape = SHAPES[shape_name]
    cfg = get_config(arch)
    ok, why = shape_applicable(cfg, shape)
    if not ok:
        return {"arch": arch, "shape": shape_name, "mesh": mesh_name(multi_pod),
                "status": "skipped", "reason": why}
    with fake_world(512 if multi_pod else 256):
        return _lower_cell(arch, shape, cfg, multi_pod, fsdp, microbatches, remat_group,
                           donate, tp)


def _layout(cfg, shape, mesh, multi_pod, fsdp, microbatches, remat_group, tp):
    """A cell's layout, no trace: the (cut) config, the parameter specs and
    their shardings, the batch (one microbatch of it for training) and its
    shardings, the decode cache's, the exact per-rank argument and output
    bytes, and the record's extra keys."""
    import types

    from repro_torch.train.train_step import microbatched_specs

    L = types.SimpleNamespace(kind=shape.kind)
    dsz = shardlib.data_axis_size(mesh) * (2 if multi_pod else 1)

    def block_bytes(t, ns):
        return math.prod(s.stop - s.start for s in ns.block(t.shape)) * t.element_size()

    if shape.kind == "train":
        rg = remat_group if remat_group is not None else shardlib.default_remat_group(
            cfg.n_layers)
        L.cfg = cfg = dataclasses.replace(cfg, remat_group=rg)
        L.tp, L.use_fsdp = tp, fsdp in ("on", "auto")
        L.specs = _train_specs(cfg, tp, L.use_fsdp, mesh)
        pshard = shardlib.param_shardings(L.specs, mesh)
        if tp == "off":  # pure-DP layout: the tensor axis becomes batch
            dsz *= dict(zip(mesh.mesh_dim_names, mesh.shape)).get("model", 1)
        mb = microbatches if microbatches is not None else shardlib.pick_microbatches(
            shape.global_batch, dsz, shape.seq_len)
        api = get_model(cfg)
        batch_all, psp_all = microbatched_specs(
            {k: torch.empty(s.shape, dtype=s.dtype, device="meta")
             for k, s in api.input_specs(shape).items()}, api.input_pspecs(shape), mb)
        if tp == "off":
            psp_all = {k: shardlib.dp_over_model_spec(v) for k, v in psp_all.items()}
        bshard_all = {k: NamedSharding(mesh, shardlib.drop_indivisible(
            filter_spec(pod_spec(psp_all[k], mesh), mesh), t.shape, mesh))
            for k, t in batch_all.items()}
        # one microbatch: the leading microbatch axis dropped
        L.batch = {k: t[0] if mb > 1 else t for k, t in batch_all.items()}
        L.bshard = {k: NamedSharding(mesh, ns.spec[1:] if mb > 1 else ns.spec)
                    for k, ns in bshard_all.items()}
        L.unit = _unit(cfg, "train", rg)
        L.mb = mb
        pbytes = _local_bytes(in_f32(L.specs), pshard)
        opt_bytes = 2 * pbytes + 4  # m, v and the int32 step
        L.args = pbytes + opt_bytes + sum(block_bytes(batch_all[k], ns)
                                          for k, ns in bshard_all.items())
        L.out_bytes = pbytes + opt_bytes
        L.extra = {"microbatches": mb, "remat_group": rg, "fsdp": L.use_fsdp, "tp": tp}
    else:  # decode: one token a row against a seq_len KV cache
        L.cfg = cfg
        specs = shardlib.cast_params(get_model(cfg).param_specs(), torch.bfloat16)
        L.use_fsdp = fsdp == "on" or (
            fsdp == "auto" and param_count(specs) * 2 / 16 > 8e9)  # >8GB/chip at TP-16
        L.specs = shardlib.fsdp_params(specs, mesh) if L.use_fsdp else specs
        api = get_model(cfg)
        cache_specs = api.cache_specs(shape.global_batch, shape.seq_len)
        L.bshard = shardlib.input_shardings(api, shape, mesh)
        L.batch = {k: torch.empty(s.shape, dtype=s.dtype, device="meta")
                   for k, s in api.input_specs(shape).items()}
        L.unit = _unit(cfg, "decode", 0)
        cbytes = _local_bytes(cache_specs, shardlib.state_shardings(cache_specs, mesh))
        L.args = (_local_bytes(L.specs, shardlib.param_shardings(L.specs, mesh)) + cbytes
                  + sum(block_bytes(L.batch[k], ns) for k, ns in L.bshard.items()))
        L.out_bytes = cbytes
        L.extra = {"fsdp": L.use_fsdp}
    L.groups = cfg.n_layers // L.unit
    return L


def _warm(trace, cfg):
    """``trace(cfg)`` run twice, the second run's result: the first fills
    DTensor's sharding-propagation cache, whose misses run the op on
    global-shape stand-ins (and their decompositions), no rank's work."""
    trace(cfg)
    return trace(cfg)


def _train_specs(cfg, tp, use_fsdp, mesh):
    specs = get_model(cfg).param_specs()
    if tp == "off":
        specs = shardlib.strip_model(specs)
    return shardlib.fsdp_params(specs, mesh) if use_fsdp else specs


def _decode_specs(cfg, use_fsdp, mesh):
    specs = shardlib.cast_params(get_model(cfg).param_specs(), torch.bfloat16)
    return shardlib.fsdp_params(specs, mesh) if use_fsdp else specs


def argument_bytes(arch: str, shape_name: str, multi_pod: bool, *, fsdp: str = "auto",
                   microbatches: int | None = None, remat_group: int | None = None,
                   tp: str = "on") -> int:
    """A cell's exact per-rank argument bytes (``mem.argument_bytes``)
    without tracing it."""
    with fake_world(512 if multi_pod else 256):
        return _layout(get_config(arch), SHAPES[shape_name], _mesh(multi_pod), multi_pod, fsdp,
                       microbatches, remat_group, tp).args


def _lower_cell(arch, shape, cfg, multi_pod, fsdp, microbatches, remat_group, donate, tp):
    from repro_torch.models import layers as layerslib
    from repro_torch.train.optimizer import OptConfig

    mesh = _mesh(multi_pod)
    n_chips = int(np.prod(mesh.shape))
    kind = shape.kind
    saved = layerslib.DP_OVER_MODEL, layerslib.SEQ_SHARD_BOUNDARY
    t0 = time.perf_counter()
    try:
        if kind == "train":
            # Megatron-SP at layer boundaries: off by default, as in the
            # reference (measured there to double the FLOPs); kept as a knob.
            layerslib.SEQ_SHARD_BOUNDARY = os.environ.get("REPRO_SEQ_SHARD", "0") == "1"
            layerslib.DP_OVER_MODEL = tp == "off"
        L = _layout(cfg, shape, mesh, multi_pod, fsdp, microbatches, remat_group, tp)
        cfg, unit, groups = L.cfg, L.unit, L.groups
        t_lower = time.perf_counter() - t0
        if kind == "train":
            def trace(c):
                return _trace_train(get_model(c), _train_specs(c, tp, L.use_fsdp, mesh), mesh,
                                    L.batch, L.bshard, OptConfig())

            # the second group's ops have the first's shapes: cached by then
            traces = [_warm(trace, _depth(cfg, unit, 1)), trace(_depth(cfg, unit, 2))]
            counts = _scaled(traces[0][0], traces[1][0], groups, L.mb)
            counts.add(_scaled(traces[0][1], traces[1][1], groups))
            counts.peak_bytes = _scaled(traces[0][0], traces[1][0], groups).peak_bytes
            multipliers = {"microbatches": L.mb, "layer_groups": groups,
                           "layers_per_group": unit}
        else:
            def trace(c):
                a = get_model(c)
                cs = a.cache_specs(shape.global_batch, shape.seq_len)
                return _trace_decode(a, _decode_specs(c, L.use_fsdp, mesh), mesh, cs,
                                     shardlib.state_shardings(cs, mesh), L.batch, L.bshard)

            traces = [_warm(trace, _depth(cfg, unit, g)) for g in (1, 2)]
            counts = _scaled(traces[0], traces[1], groups)
            multipliers = {"layer_groups": groups, "layers_per_group": unit}
    finally:
        layerslib.DP_OVER_MODEL, layerslib.SEQ_SHARD_BOUNDARY = saved
    t_compile = time.perf_counter() - t0 - t_lower
    args, out_bytes, n_params_specs = L.args, L.out_bytes, L.specs
    extra = {**L.extra, "multipliers": multipliers}

    ana = hlo_analysis.analyze(counts, pod_boundary=256)
    n_params = param_count(n_params_specs)
    n_active = active_param_count(cfg, n_params_specs)
    tokens = shape.global_batch * (shape.seq_len if kind == "train" else 1)
    model_flops = (6 if kind == "train" else 2) * n_active * tokens
    return {
        "arch": arch, "shape": shape.name, "mesh": mesh_name(multi_pod),
        "status": "ok", "kind": kind, "n_chips": n_chips,
        "params": int(n_params), "active_params": int(n_active),
        "tokens_per_step": int(tokens), "model_flops": float(model_flops),
        # per-rank numbers from the counted local operations
        "hlo_flops": ana["flops"],
        "hlo_bytes": ana["bytes"],
        "matmul_flops": float(counts.matmul_flops),
        "mem": {
            "argument_bytes": int(args),
            "output_bytes": int(out_bytes),
            "temp_bytes": int(counts.peak_bytes),
            "alias_bytes": int(out_bytes if donate else 0),
            "code_bytes": 0,
        },
        "temp_bytes_is_estimate": True,
        "collective_bytes": ana["collective_bytes"],
        "collective_wire_bytes": ana["collective_wire_bytes"],
        "collective_cross_pod_bytes": ana["collective_cross_pod_bytes"],
        "n_collectives": ana["n_collective_sites"],
        "collectives_by_kind": ana["collectives_by_kind"],
        "unknown_whiles": ana["unknown_whiles"],
        # the reference's XLA-CPU bf16 legalisation copies: none here
        "bf16_upcast_bytes": ana["bf16_upcast_bytes"],
        "lower_s": round(t_lower, 2), "compile_s": round(t_compile, 2),
        "donate": donate,
        **extra,
    }


# ---------------------------------------------------------------------------
# The EM-round cell (the paper's technique on the production mesh)
# ---------------------------------------------------------------------------


def lower_em_cell(multi_pod: bool, *, k: int = 32, neighborhoods: int = 8192,
                  universe: int = 1 << 20, matcher_kind: str = "mln"):
    """Count one SPMD message-passing round at production scale.

    One round = batched MLN MAP inference on every active neighborhood
    (split over every rank of the mesh) + the match-bitset all-reduce.
    8192 neighborhoods of k=32 is a DBLP-BIG-scale round (paper §6.3).
    """
    with fake_world(512 if multi_pod else 256):
        return _lower_em_cell(multi_pod, k, neighborhoods, universe, matcher_kind)


def _lower_em_cell(multi_pod, k, neighborhoods, universe, matcher_kind):
    from repro_torch.core import pairs as pairlib
    from repro_torch.core.mln import PAPER_LEARNED
    from repro_torch.core.parallel import RoundSpec, build_round_fn
    from repro_torch.launch.mesh import EMMesh

    mesh = _mesh(multi_pod)
    n_chips = int(np.prod(mesh.shape))
    em = EMMesh.ranks_of(mesh)
    B = max(neighborhoods, n_chips)
    b = -(-B // n_chips)  # this rank's rows
    Pn = pairlib.num_pairs(k)
    t0 = time.perf_counter()
    spec = RoundSpec(num_pairs=Pn, universe_size=universe, matcher_kind=matcher_kind,
                     weights=PAPER_LEARNED)
    fn = build_round_fn(spec, em, tuple(em.axis_names))
    rows = (np.ones((b, k), bool), np.zeros((b, k, k), bool), np.zeros((b, Pn), np.int8),
            np.zeros((b, Pn), bool), np.full((b, Pn), universe, np.int32))
    m_bits = torch.zeros(universe, dtype=torch.bool)
    t_lower = time.perf_counter() - t0
    c = hlo_analysis.OpCounter(track_memory=True)
    with c:
        fn(*rows, m_bits)
    t_compile = time.perf_counter() - t0 - t_lower
    reads = c.counts.host_reads
    ana = hlo_analysis.analyze(c.counts, unknown_whiles=reads, pod_boundary=256)
    args = sum(a.nbytes for a in rows) + m_bits.numel()
    return {
        "arch": f"em_round_{matcher_kind}", "shape": f"k{k}_B{B}",
        "mesh": mesh_name(multi_pod), "status": "ok",
        "kind": "em_round", "n_chips": n_chips,
        "params": 0, "active_params": 0, "tokens_per_step": B,
        # useful work: one (P,P)@(P,P) entailment matmul + sweeps per nb
        "model_flops": float(B * 2 * Pn * Pn * Pn),
        "hlo_flops": ana["flops"],
        "hlo_bytes": ana["bytes"],
        "matmul_flops": float(c.counts.matmul_flops),
        "mem": {
            "argument_bytes": int(args),
            "output_bytes": int(b * Pn * 5 + universe),
            "temp_bytes": int(c.counts.peak_bytes),
            "alias_bytes": 0,
            "code_bytes": 0,
        },
        "temp_bytes_is_estimate": True,
        "collective_bytes": ana["collective_bytes"],
        "collective_wire_bytes": ana["collective_wire_bytes"],
        "collective_cross_pod_bytes": ana["collective_cross_pod_bytes"],
        "n_collectives": ana["n_collective_sites"],
        "collectives_by_kind": ana["collectives_by_kind"],
        "unknown_whiles": ana["unknown_whiles"],
        "rows_a_rank": b,
        "lower_s": round(t_lower, 2), "compile_s": round(t_compile, 2),
    }


# ---------------------------------------------------------------------------
# CLI
# ---------------------------------------------------------------------------


def _save(rec: dict, out_dir: str):
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, f"{rec['arch']}__{rec['shape']}__{rec['mesh']}.json")
    with open(path, "w") as f:
        json.dump(rec, f, indent=1)
    return path


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="all", help="arch id or 'all'")
    ap.add_argument("--shape", default="all", help="shape name or 'all'")
    ap.add_argument("--mesh", default="both", choices=["pod", "multipod", "both"])
    ap.add_argument("--em", action="store_true", help="run the EM-round cell")
    ap.add_argument("--fsdp", default="auto", choices=["auto", "on", "off"])
    ap.add_argument("--tp", default="on", choices=["on", "off"])
    ap.add_argument("--microbatches", type=int, default=None)
    ap.add_argument("--remat-group", type=int, default=None)
    ap.add_argument("--out", default=os.environ.get("DRYRUN_OUT", OUT_DIR))
    args = ap.parse_args(argv)

    meshes = {"pod": [False], "multipod": [True], "both": [False, True]}[args.mesh]
    archs = ARCH_IDS if args.arch == "all" else [args.arch]
    shapes = list(SHAPES) if args.shape == "all" else [args.shape]

    n_ok = n_skip = n_fail = 0
    for multi_pod in meshes:
        if args.em:
            rec = lower_em_cell(multi_pod)
            _save(rec, args.out)
            print(f"[em_round {rec['mesh']}] ok "
                  f"flops={rec['hlo_flops']:.3e} coll={rec['collective_wire_bytes']:.3e}B "
                  f"compile={rec['compile_s']}s", flush=True)
            n_ok += 1
            continue
        for arch in archs:
            for shape in shapes:
                tag = f"{arch} x {shape} x {mesh_name(multi_pod)}"
                try:
                    rec = lower_cell(arch, shape, multi_pod, fsdp=args.fsdp,
                                     microbatches=args.microbatches,
                                     remat_group=args.remat_group, tp=args.tp)
                except Exception:  # a cell that fails is reported, and the grid goes on
                    n_fail += 1
                    print(f"[{tag}] FAIL", flush=True)
                    traceback.print_exc()
                    continue
                _save(rec, args.out)
                if rec["status"] == "skipped":
                    n_skip += 1
                    print(f"[{tag}] skipped: {rec['reason']}", flush=True)
                else:
                    n_ok += 1
                    m = rec["mem"]
                    hbm = (m["argument_bytes"] + m["temp_bytes"] + m["output_bytes"]
                           - m["alias_bytes"])
                    print(f"[{tag}] ok mem/dev={hbm / 2**30:.2f}GiB "
                          f"flops={rec['hlo_flops']:.3e} "
                          f"coll={rec['collective_wire_bytes']:.3e}B "
                          f"compile={rec['compile_s']}s", flush=True)
    print(f"dry-run: {n_ok} ok, {n_skip} skipped, {n_fail} failed", flush=True)
    return 1 if n_fail else 0


if __name__ == "__main__":
    raise SystemExit(main())
