#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one GPU: build, kernels, main path.

    python3 chip_smoke.py

1. Build: compiles ``src/repro_torch/csrc/*.cu`` with nvcc for sm_90a into
   ``src/repro_torch/_build/`` (one nvcc per source, all in parallel).
2. Kernels: each CUDA kernel against its plain PyTorch version on the card,
   at the shapes the main path gives it, with its time, the plain version's,
   a library call's where one computes the same function, and the bound
   from bytes and float32 operations.
3. Pipeline: ``repro_torch.core.pipeline.resolve`` for nomp, smp and mmp on
   the HEPTH-like corpus ``SynthConfig.hepth(scale=1.0, seed=7)`` on CUDA,
   then the MMP fixpoint scored with ``MLNMatcher.score``.  The kernels'
   launch counters are set to 0 just before and read just after.  The
   match gids must equal the port's own CPU run, and the evals, messages,
   matches and P/R/F1 the reference table below.
4. Profile: the first 100 MMP evaluations once more under
   ``torch.profiler``: the device's busy share and what takes its time.
5. The card's name and power limit, the kernel list as one JSON line, and
   last the line ``{"ok": true, "device": {...}}``.

Any failure raises and exits non-zero before the last line.  Imports
nothing of JAX or of the JAX package ``repro``.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

# H100 SXM published peaks: HBM3 bytes/s and float32 (non-tensor-core) flop/s
PEAK_BYTES_S = 3.35e12
PEAK_F32_FLOPS = 67e12

# ``resolve`` on SynthConfig.hepth(scale=1.0, seed=7) with the reference
# package (algorithm-determined, framework-independent):
# scheme -> (evals, messages emitted, promoted, matches, P, R, F1)
EXPECTED = {
    "nomp": (406, 0, 0, 2978, 0.8057, 0.8465, 0.8256),
    "smp": (463, 0, 0, 2984, 0.8059, 0.8481, 0.8265),
    "mmp": (467, 126, 4, 3000, 0.8067, 0.8521, 0.8288),
}
CORPUS = dict(refs=1842, neighborhoods=406)

KERNELS = {
    "icm_sweep": dict(
        source="src/repro_torch/csrc/icm_sweep.cu",
        replaces="src/repro/kernels/icm_sweep/kernel.py:55",
    ),
    "ngram_sim": dict(
        source="src/repro_torch/csrc/ngram_sim.cu",
        replaces="src/repro/kernels/ngram_sim/kernel.py:55",
    ),
    "mln_score": dict(
        source="src/repro_torch/csrc/mln_score.cu",
        replaces="src/repro/kernels/mln_score/kernel.py:81",
    ),
}


def log(msg: str) -> None:
    print(msg, flush=True)


def require(ok, msg: str) -> None:
    """A check of the run's result (kept under ``python -O``, unlike assert)."""
    if not ok:
        raise RuntimeError(msg)


def _events_ms(run) -> float:
    import torch

    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    run()
    end.record()
    end.synchronize()
    return start.elapsed_time(end)


def time_ms(fn, iters: int = 50) -> tuple[float, float]:
    """(device ms, eager ms) of one call of ``fn``.

    Device time: CUDA events around one replay of a CUDA graph that holds
    ``iters`` calls, so the host's launch overhead is not in it.  Eager
    time: CUDA events around ``iters`` calls launched from Python, which
    is what the main path pays for a call when the host is the limit.
    Inputs stay warm in the 50 MB L2 between calls.
    """
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()  # warm up allocator and library handles off the capture
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    device = _events_ms(graph.replay) / iters

    def eager():
        for _ in range(iters):
            fn()

    eager()
    return device, _events_ms(eager) / iters


def bound(n_bytes: int, flops: int) -> tuple[float, str]:
    """Least time on the card (ms): the larger of bytes and float32 flops."""
    t_bytes = n_bytes / PEAK_BYTES_S * 1e3
    t_ops = flops / PEAK_F32_FLOPS * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def phase_build() -> float:
    from repro_torch.kernels import build

    t0 = time.perf_counter()
    path = build.library_path()
    build.library()
    secs = time.perf_counter() - t0
    log(f"[build] {path.relative_to(ROOT)} in {secs:.1f} s")
    return secs


def _symmetric_coupling(rng, B, P, w_co=2.46, density=0.02):
    link = np.triu(rng.random((B, P, P)) < density, 1)
    link = link | link.transpose(0, 2, 1)
    return (w_co * link).astype(np.float32)


def phase_kernels(dev) -> list[dict]:
    """Each kernel vs its plain version on the card at the main path's shapes."""
    import torch

    from repro_torch.kernels.icm_sweep import ops as icm
    from repro_torch.kernels.mln_score import ops as score
    from repro_torch.kernels.ngram_sim import ops as sim

    rng = np.random.default_rng(0)
    rows = []

    def put(a):
        return torch.as_tensor(a, device=dev)

    def check(name, shape, kernel, plain, library, tol, n_bytes, flops):
        got, want = kernel(), plain()
        torch.cuda.synchronize()
        np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(), **tol)
        ms, call_ms = time_ms(kernel)
        row = dict(
            name=name, shape=shape, max_abs_err=float((got - want).abs().max()),
            ms=ms, call_ms=call_ms, plain_ms=time_ms(plain)[0],
            library_ms=None if library is None else time_ms(library)[0],
        )
        row["bound_ms"], row["bound_by"] = bound(n_bytes, flops)
        lib = "n/a" if row["library_ms"] is None else f"{row['library_ms']:.4f}"
        log(
            f"[kernels] {name:9s} {shape:22s} ok  max_abs_err={row['max_abs_err']:.3g}"
            f"  kernel_ms={ms:.4f} (eager call {call_ms:.4f})  plain_ms={row['plain_ms']:.4f}"
            f"  library_ms={lib}  bound_ms={row['bound_ms']:.5f} ({row['bound_by']})"
        )
        rows.append(row)

    f32 = dict(rtol=1e-5, atol=1e-5)
    for B, S, P in [(1, 1, 496), (1, 496, 496), (192, 1, 496)]:
        u = put(rng.standard_normal((B, P)).astype(np.float32))
        C = put(_symmetric_coupling(rng, B, P))
        X = put((rng.random((B, S, P)) < 0.3).astype(np.float32))
        check(
            "icm_sweep", f"B={B},S={S},P={P}",
            lambda: icm.sweep_batched(u, C, X), lambda: icm.sweep_batched_plain(u, C, X),
            lambda: torch.baddbmm(u[:, None, :], X, C), f32,
            4 * (B * P + B * P * P + 2 * B * S * P), 2 * B * S * P * P,
        )

    for M, N, F in [(1, 1024, 128), (1024, 1842, 128)]:
        A = rng.random((M, F)).astype(np.float32)
        Bm = rng.random((N, F)).astype(np.float32)
        A = put(A / np.linalg.norm(A, axis=1, keepdims=True))
        Bm = put(Bm / np.linalg.norm(Bm, axis=1, keepdims=True))
        check(
            "ngram_sim", f"M={M},N={N},F={F}",
            lambda: sim.sim_above(A, Bm, 0.7), lambda: sim.sim_above_plain(A, Bm, 0.7),
            # the product alone: no single PyTorch call applies the threshold
            lambda: torch.matmul(A, Bm.T), f32,
            4 * (M * F + N * F + M * N), 2 * M * N * F,
        )

    for B, S, P in [(192, 1, 496)]:
        u = put(rng.standard_normal((B, P)).astype(np.float32))
        C = put(_symmetric_coupling(rng, B, P))
        X = put((rng.random((B, S, P)) < 0.3).astype(np.float32))
        check(
            "mln_score", f"B={B},S={S},P={P}",
            lambda: score.score_sets(u, C, X), lambda: score.score_sets_plain(u, C, X),
            None,  # no single PyTorch call computes x.u + x C x^T / 2
            dict(rtol=2e-5, atol=2e-4),
            4 * (B * P + B * P * P + B * S * P + B * S), 2 * B * S * P * P + 2 * B * S * P,
        )
    return rows


def _same_packed(a, b) -> bool:
    if sorted(a.bins) != sorted(b.bins):
        return False
    fields = ("entity_ids", "entity_mask", "coauthor", "sim_level", "pair_gid", "pair_mask")
    return all(
        np.array_equal(getattr(a.bins[k], f), getattr(b.bins[k], f))
        for k in a.bins for f in fields
    ) and np.array_equal(a.neighborhood_bin, b.neighborhood_bin)


def phase_pipeline(dev):
    """resolve() for nomp/smp/mmp on CUDA, then the Type-II score of the MMP fixpoint."""
    import torch

    from repro_torch.core import pipeline
    from repro_torch.core.mln import MLNMatcher, PAPER_LEARNED
    from repro_torch.data.synthetic import SynthConfig, make_dataset
    from repro_torch.kernels.icm_sweep import ops as icm
    from repro_torch.kernels.mln_score import ops as score
    from repro_torch.kernels.ngram_sim import ops as sim

    wrappers = {"icm_sweep": icm.sweep_batched, "ngram_sim": sim.sim_above,
                "mln_score": score.score_sets}
    ds = make_dataset(SynthConfig.hepth(scale=1.0, seed=7))
    truth = ds.entities.truth

    for w in wrappers.values():
        w.launches = 0
    gpu, wall = {}, {}
    for scheme in EXPECTED:
        t0 = time.perf_counter()
        gpu[scheme] = pipeline.resolve(ds.entities, ds.relations, scheme=scheme, device=dev)
        torch.cuda.synchronize()
        wall[scheme] = time.perf_counter() - t0
    fixpoint = gpu["mmp"]
    matcher = MLNMatcher(PAPER_LEARNED, device=dev)
    scores = {
        k: matcher.score(nb, fixpoint.result.matches.mask_of(nb.pair_gid))
        for k, nb in fixpoint.packed.bins.items()
    }
    torch.cuda.synchronize()
    launches = {name: w.launches for name, w in wrappers.items()}
    log(f"[pipeline] launches on the main path: {launches}")
    for name, n in launches.items():
        require(n > 0, f"{name} was never launched on the main path")

    packed = fixpoint.packed
    log(
        f"[pipeline] corpus: {len(ds.entities)} refs, {packed.num_neighborhoods} neighborhoods, "
        f"{len(fixpoint.gg.gids)} candidate pairs, bins "
        + ", ".join(f"k={k}: {nb.batch}x{nb.num_pairs}" for k, nb in sorted(packed.bins.items()))
    )
    require(len(ds.entities) == CORPUS["refs"], "corpus size changed")
    require(packed.num_neighborhoods == CORPUS["neighborhoods"], "cover size changed")

    # the port's own CPU run of the same corpus (plain versions, no kernels)
    t0 = time.perf_counter()
    pk_cpu, gg_cpu, _ = pipeline.prepare(ds.entities, ds.relations, device="cpu")
    require(_same_packed(pk_cpu, packed), "CUDA and CPU covers differ")
    require(np.array_equal(gg_cpu.gids, fixpoint.gg.gids), "CUDA and CPU groundings differ")
    cpu = {
        s: pipeline.resolve(ds.entities, ds.relations, scheme=s, packed=pk_cpu, gg=gg_cpu,
                            device="cpu")
        for s in EXPECTED
    }
    cpu_matcher = MLNMatcher(PAPER_LEARNED, device="cpu")
    for k, nb in packed.bins.items():
        want = cpu_matcher.score(nb, cpu["mmp"].result.matches.mask_of(nb.pair_gid))
        np.testing.assert_allclose(scores[k], want, rtol=2e-5, atol=2e-4)
        require(np.isfinite(scores[k]).all() and scores[k].shape == (nb.batch,),
                f"bin {k}: scores not finite or of the wrong shape")
    log(f"[pipeline] CPU run of the port in {time.perf_counter() - t0:.1f} s; "
        f"MMP fixpoint scores agree on {len(scores)} bins")

    for scheme, (evals, emitted, promoted, n_match, p, r, f1) in EXPECTED.items():
        res = gpu[scheme].result
        prf = pipeline.evaluate(gpu[scheme], truth)
        require(np.array_equal(res.matches.gids, cpu[scheme].result.matches.gids),
                f"{scheme}: CUDA and CPU match gids differ")
        got = (res.neighborhood_evals, res.messages_emitted, res.messages_promoted,
               len(res.matches), round(prf.precision, 4), round(prf.recall, 4), round(prf.f1, 4))
        want = (evals, emitted, promoted, n_match, p, r, f1)
        require(got == want, f"{scheme}: got {got}, expected {want}")
        log(
            f"[pipeline] {scheme}: wall {wall[scheme]:.2f} s (cover {gpu[scheme].cover_time_s:.2f} s, "
            f"matching {res.wall_time_s:.2f} s), evals {res.neighborhood_evals}, messages "
            f"{res.messages_emitted}/{res.messages_promoted}, matches {len(res.matches)}, "
            f"P {prf.precision:.4f} R {prf.recall:.4f} F1 {prf.f1:.4f}"
        )
    return launches, fixpoint


def phase_profile(dev, fixpoint, max_evals: int = 100) -> None:
    """Where the matcher's time goes: the first ``max_evals`` MMP evaluations
    (cover excluded) once more under torch.profiler, device activity only;
    device busy = summed kernel and copy time over the wall time."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.core.driver import run_mmp
    from repro_torch.core.mln import MLNMatcher, PAPER_LEARNED

    matcher = MLNMatcher(PAPER_LEARNED, device=dev)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        res = run_mmp(fixpoint.packed, matcher, fixpoint.gg, max_evals=max_evals)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    per_name: dict[str, list[float]] = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            name = e.name.removeprefix("void ").removeprefix("(anonymous namespace)::")
            per_name.setdefault(name, []).append(e.time_range.elapsed_us())
    if not per_name:
        log("[profile] device time not measured (the profiler saw no device activity)")
        return
    busy = sum(sum(v) for v in per_name.values()) / 1e6
    top = sorted(per_name.items(), key=lambda kv: -sum(kv[1]))[:6]
    log(
        f"[profile] mmp, first {res.neighborhood_evals} evals: wall {wall:.2f} s under the "
        f"profiler, device busy {busy:.3f} s ({100 * busy / wall:.1f}%), "
        f"{sum(len(v) for v in per_name.values())} device ops; top: "
        + "; ".join(f"{n[:44]} {sum(v) / 1e3:.1f} ms x{len(v)}" for n, v in top)
    )


def main() -> int:
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    if not (ROOT / "src" / "repro_torch").is_dir():
        print("chip_smoke: src/repro_torch not found beside this script", file=sys.stderr)
        return 2
    from repro_torch.kernels.common import resolve_device

    dev = resolve_device("cuda:0")
    t0 = time.perf_counter()
    phase_build()
    rows = phase_kernels(dev)
    launches, fixpoint = phase_pipeline(dev)
    phase_profile(dev, fixpoint)

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()
    log(f"[done] {time.perf_counter() - t0:.1f} s")
    log(smi[torch.cuda.current_device()] if len(smi) > 1 else smi[0])

    kernels = []
    for name, meta in KERNELS.items():
        mine = [r for r in rows if r["name"] == name]
        main_shape = mine[0]  # the first shape listed is the main path's per-eval call
        kernels.append(dict(
            name=name, route="cuda", source=meta["source"], replaces=meta["replaces"],
            launches=launches[name], shape=main_shape["shape"],
            max_abs_err=max(r["max_abs_err"] for r in mine),
            ms=main_shape["ms"], call_ms=main_shape["call_ms"], plain_ms=main_shape["plain_ms"],
            bound_ms=main_shape["bound_ms"], bound_by=main_shape["bound_by"],
            library_ms=main_shape["library_ms"],
        ))
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
