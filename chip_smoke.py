#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one GPU: build, kernels, main paths.

    python3 chip_smoke.py

1. Build: compiles ``src/repro_torch/csrc/*.cu`` with nvcc for sm_90a into
   ``src/repro_torch/_build/`` (one nvcc per source, all in parallel).
2. Kernels: each CUDA kernel against its plain PyTorch version on the card,
   at the shapes the main paths give it, with its time, the plain version's,
   a library call's where one computes the same function, and the bound
   from bytes and operations.
3. Pipeline: ``repro_torch.core.pipeline.resolve`` for nomp, smp and mmp on
   the HEPTH-like corpus ``SynthConfig.hepth(scale=1.0, seed=7)`` on CUDA,
   then the MMP fixpoint scored with ``MLNMatcher.score``.  The kernels'
   launch counters are set to 0 just before and read just after.  The
   match gids must equal the port's own CPU run, and the evals, messages,
   matches and P/R/F1 the reference table below.  Then (not counted)
   ``mln_score`` is timed on the k=32 bin's grounding and the fixpoint's
   mask, beside its bound on the rows of C that mask needs.
4. Rules (``rules``): ``resolve`` with ``RulesMatcher`` on CUDA, nomp and
   smp, on phase 3's cover and grounding, the counters set to 0 before
   each run and read after it; evals, matches, P/R/F1 and the gid digest
   must equal ``EXPECTED_RULES``, ``icm_sweep`` must launch, and MMP must
   refuse the matcher (it has no ``score``).
5. Parallel (``parallel``): the round-parallel engine
   ``repro_torch.core.parallel.run_parallel`` on CUDA over phase 3's cover
   and grounding: the MLN matcher nomp, smp and mmp and RULES nomp and smp,
   each fused and ``fused=False``, the counters set to 0 before each run and
   read after it.  Rounds, evals, messages, matches, P/R/F1, dispatches,
   full rounds, the per-round history, host scans and the gid digest must
   equal ``EXPECTED_PARALLEL``, the gids phase 3's (or ``RULES_GID_DIGEST``),
   and ``icm_sweep`` must launch in every run.  Then ``resolve(...,
   parallel=True)`` for mmp, the streaming service with ``parallel=True``
   over the 29 batches (smp and mmp, held to ``EXPECTED_STREAM_PARALLEL``,
   ``minhash`` launched 29 times each), and once more for mmp with
   ``gcache_capacity=1`` (spill mode: the same match digest, at most one
   resident bin, evictions and cold re-grounds).  Prints each run's wall,
   dispatches and launches, and the device's busy share, device ops and
   device-to-host copies of one more fused mmp run under ``torch.profiler``.
6. Stream: the same corpus through ``repro_torch.stream.ResolveService``
   on CUDA, as 29 paper-aligned batches (smp and mmp) and as one batch
   (smp).  The launch counters are set to 0 before each run and read
   after it.  Matches, evals, clusters, the O(dirty) counters and the
   digests must equal the reference table ``EXPECTED_STREAM``; the
   one-batch gids must equal phase 3's smp gids.  Prints each run's wall
   time, ingest p50/p99 and the time of each ingest stage (tracing spans).
7. Matchers (``matchers``): every family of the registry
   (``repro_torch.core.matchers``) through ``resolve(scheme="smp")`` on CUDA
   on ``make_bipartite(60, seed=1)``, with the sequential driver and, for the
   device families, the parallel engine, held to ``EXPECTED_MATCHERS``;
   ``run_parallel`` must refuse the host-only families (``TypeError``).  Then
   the embedding family at the users' scale, on phase 3's corpus and cover:
   the ``ngram`` encoder on both engines against ``EXPECTED_EMBED_NGRAM``
   and ``EMBED_NGRAM_DIGEST``, and the ``lm`` encoder (parallel) on the card
   against the port on the CPU from the same weights: embeddings within
   ``LM_EMBED_TOL``, match sets equal but for pairs whose cosine lies within
   the embeddings' error of ``tau`` (counted), ``flash_attn`` launched twice
   a prefill.  ``icm_sweep`` and ``flash_attn`` must launch in the phase.
8. Serving (``serving``): ``repro_torch.stream.ServingFrontend`` with
   ``ServingConfig(max_batch=1)`` over a durable
   ``ServiceConfig(scheme="mmp", parallel=True, durability_dir=...,
   checkpoint_every=8)`` on CUDA, fed the 29 batches as 29 requests: the
   counters and digests of ``EXPECTED_STREAM_PARALLEL["mmp"]``, ``minhash``
   launched 29 times, 2 checkpoints kept and the WAL collected past the
   last.  Then this script again as a subprocess (``--crash-worker``) that
   dies at hit 12 of the ``rounds`` fault site (exit 117), the directory
   recovered on the card with ``ResolveService.recover`` and the rest
   re-submitted: the same state digest.  Last a coalescing run at the
   default ``ServingConfig()``, one request a paper, for throughput.  Prints
   requests and entities a second, the queue wait p50/p99, the WAL bytes,
   the checkpoint size and save time, ``recover.replayed`` and its wall.
9. LM (``lm``): Yi-6B at full width.  First the card against the CPU: 2
   layers, weights drawn on the CPU with ``init_params``, a prefill of 4
   prompts of 32 tokens and 4 greedy decode steps teacher-forced with the
   CPU's tokens; the largest logit difference over the largest logit must
   stay within 2e-2, and greedy tokens must agree wherever the CPU's
   top-1/top-2 margin is above twice that difference.  Then serving at full
   depth (32 layers, weights drawn on the card):
   ``repro_torch.launch.serve.main`` with 8 requests of 32 tokens in
   batches of 4, 16 new tokens each, and one prompt of 4,096 tokens through
   an ``Engine`` of batch 1.  Logits must be finite, every request gets 16
   tokens, and ``flash_attn`` must launch exactly 32 x 2 + 32 = 96 times
   (one launch a layer a prefill; decode attention is plain tensor code).
   Prints prefill ms, decode ms a step, tokens/s, peak memory, and the
   device's busy share of one more serving run of each kind under
   ``torch.profiler``.
10. Profile: the first 100 MMP evaluations once more under
   ``torch.profiler``: the device's busy share and what takes its time.
11. The card's name and power limit, the kernel list as one JSON line, and
   last the line ``{"ok": true, "device": {...}}``.

Any failure raises and exits non-zero before the last line.  Imports
nothing of JAX or of the JAX package ``repro``.
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
import hashlib
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
# dense bf16 tensor-core flop/s (H100 SXM data sheet)
PEAK_BF16_FLOPS = 989e12
# int32 min/compare outside the tensor cores: 132 SMs x 64 INT32 lanes
# an SM a clock x 1.98 GHz boost clock (H100 SXM, Hopper white paper)
PEAK_INT32_OPS = 132 * 64 * 1.98e9

# ``resolve`` on SynthConfig.hepth(scale=1.0, seed=7) with the reference
# package (algorithm-determined, framework-independent):
# scheme -> (evals, messages emitted, promoted, matches, P, R, F1)
EXPECTED = {
    "nomp": (406, 0, 0, 2978, 0.8057, 0.8465, 0.8256),
    "smp": (463, 0, 0, 2984, 0.8059, 0.8481, 0.8265),
    "mmp": (467, 126, 4, 3000, 0.8067, 0.8521, 0.8288),
}
CORPUS = dict(refs=1842, neighborhoods=406)

# ``ResolveService(ServiceConfig(scheme=...))`` fed the same corpus with the
# reference package (algorithm-determined, framework-independent).
# (scheme, batches) -> matches, summed evals, clusters of >= 2, summed
# replay_visits / cover_splice_rows / grounding_pair_visits, digests.
# Batches: ``arrival_stream(ds, batch_size=64)`` (29 paper-aligned batches),
# or one batch of every id and every coauthor edge.
EXPECTED_STREAM = {
    ("smp", 29): dict(
        matches=3015, evals=2153, clusters=353, replay_visits=8741,
        cover_splice_rows=1878, grounding_pair_visits=0,
        match_digest="22666affdd33605ff048087be7ef1d570813ba18fe0ecb9bf4d4732c10a8df6b",
        state_digest="97741b7640050f6ceb98f6b8d6720b956c6bdd9278c62ec6869e44c5f18b1222",
    ),
    ("mmp", 29): dict(
        matches=3031, evals=2157, clusters=369, replay_visits=8741,
        cover_splice_rows=1878, grounding_pair_visits=4707,
        match_digest="455b8da3058044e71ddd381d47687911627ccf1c99389f02a6dc6278e50bedbf",
        state_digest="60ae36cb6a8e980c18c11a36d67d9c00217dbdb6bf34eaa58d5093c33a788b40",
    ),
    ("smp", 1): dict(
        matches=2984,
        match_digest="7033f22c37fcd616d9e0d95a76d412fe98c86f87079461cf366d9e2fffe607d2",
    ),
}
# ``resolve(..., matcher=RulesMatcher())`` on the same corpus with the
# reference package: scheme -> (evals, messages emitted, promoted, matches,
# P, R, F1); both schemes give the same match gids, of this digest
# (``gid_digest``)
EXPECTED_RULES = {
    "nomp": (406, 0, 0, 2849, 0.826, 0.8014, 0.8135),
    "smp": (452, 0, 0, 2849, 0.826, 0.8014, 0.8135),
}
RULES_GID_DIGEST = "bb434f828312311d328f8db0c03f8a2b77a0def58df08cec840caeacc8dbfa95"
# ``run_parallel`` on phase 3's cover and grounding with the reference
# package (algorithm-determined, framework-independent):
# (matcher, scheme, fused) -> (rounds, evals, emitted, promoted, matches, P,
# R, F1, dispatches, full_rounds, history, host scans); the MLN runs give the
# gids of ``PARALLEL_GID_DIGEST`` (those of the sequential drivers), the
# RULES runs those of ``RULES_GID_DIGEST``
_NOMP, _SMP, _MMP = (0.8057, 0.8465, 0.8256), (0.8059, 0.8481, 0.8265), (0.8067, 0.8521, 0.8288)
_RULES = (0.826, 0.8014, 0.8135)
EXPECTED_PARALLEL = {
    ("mln", "nomp", True): (1, 406, 0, 0, 2978, *_NOMP, 4, 1, [406], 0),
    ("mln", "smp", True): (4, 1119, 0, 0, 2984, *_SMP, 9, 2, [403, 376, 10, 330], 0),
    ("mln", "mmp", True): (3, 1111, 238, 8, 3000, *_MMP, 9, 2, [403, 394, 314], 0),
    ("mln", "nomp", False): (1, 406, 0, 0, 2978, *_NOMP, 4, 0, [406], 0),
    ("mln", "smp", False): (3, 792, 0, 0, 2984, *_SMP, 9, 0, [406, 376, 10], 0),
    ("mln", "mmp", False): (3, 1206, 238, 8, 3000, *_MMP, 12, 0, [406, 394, 406], 3),
    ("rules", "nomp", True): (1, 406, 0, 0, 2849, *_RULES, 1, 0, [406], 0),
    ("rules", "smp", True): (2, 774, 0, 0, 2849, *_RULES, 1, 0, [406, 368], 0),
    ("rules", "nomp", False): (1, 406, 0, 0, 2849, *_RULES, 4, 0, [406], 0),
    ("rules", "smp", False): (2, 774, 0, 0, 2849, *_RULES, 8, 0, [406, 368], 0),
}
PARALLEL_GID_DIGEST = {
    "nomp": "be8e7532898fb93d9aa68f67c1aa993aadab9abad8374d0a0415cfdc19f8d7aa",
    "smp": "357d0d33364d11a20b84c03c8131fd3a2cb979dc0013831bfac4c166503fc70b",
    "mmp": "69c0aaf689754bc8d56ae42c58c93b7c8c79deafb10a983c554919c86e7cf53d",
}
# ``ResolveService(ServiceConfig(scheme=..., parallel=True))`` over the 29
# batches with the reference package: the sequential engine's matches,
# clusters and match digests; evals count rounds' rows, and mmp's pool (so its
# state digest) differs from the sequential engine's
EXPECTED_STREAM_PARALLEL = {
    "smp": dict(
        matches=3015, evals=5124, clusters=353, replay_visits=8741,
        cover_splice_rows=1878, grounding_pair_visits=0, reground_rows=1890,
        match_digest="22666affdd33605ff048087be7ef1d570813ba18fe0ecb9bf4d4732c10a8df6b",
        state_digest="97741b7640050f6ceb98f6b8d6720b956c6bdd9278c62ec6869e44c5f18b1222",
    ),
    "mmp": dict(
        matches=3031, evals=5116, clusters=369, replay_visits=8741,
        cover_splice_rows=1878, grounding_pair_visits=4707, reground_rows=1890,
        match_digest="455b8da3058044e71ddd381d47687911627ccf1c99389f02a6dc6278e50bedbf",
        state_digest="766e56e7812489d69309cda1ec2cf50b98df795cd60029bb15ebe840869e1c49",
    ),
}
# Every registered matcher family through ``resolve(scheme="smp")`` on
# ``make_bipartite(60, seed=1)`` (302 references, the fig4_matchers corpus)
# with the reference package: (family, parallel) -> (evals, matches, P, R,
# F1, first 16 hex digits of ``gid_digest``)
BIPARTITE = dict(groups=60, seed=1, refs=302)
_EXACT = (97, 1.0, 1.0, 1.0, "c35b14aaf4ed172a")
_MLN_BIP = (102, 0.8291, 1.0, 0.9065, "322b210d323aefb2")
EXPECTED_MATCHERS = {
    ("embedding", False): (90, *_EXACT),
    ("embedding", True): (180, *_EXACT),
    ("hungarian", False): (90, *_EXACT),
    ("hungarian_greedy", False): (90, 97, 0.9175, 0.9175, 0.9175, "0b296a6fb36349c9"),
    ("mln", False): (90, *_MLN_BIP),
    ("mln", True): (187, *_MLN_BIP),
    ("mln_greedy", False): (90, *_MLN_BIP),
    ("mln_greedy", True): (180, *_MLN_BIP),
    ("rules", False): (90, *_MLN_BIP),
    ("rules", True): (180, *_MLN_BIP),
}
# ``EmbeddingMatcher(encoder="ngram")`` bound to the names of phase 3's corpus,
# smp on phase 3's cover, with the reference package: parallel -> (evals,
# rounds, dispatches, matches, P, R, F1, encode_calls, encoded_ids); both
# engines give the gids of ``EMBED_NGRAM_DIGEST``
EXPECTED_EMBED_NGRAM = {
    True: (769, 2, 1, 2293, 0.8799, 0.5106, 0.6462, 4, 1842),
    False: (406, 1, 406, 2293, 0.8799, 0.5106, 0.6462, 229, 1842),
}
EMBED_NGRAM_DIGEST = "3d10dc4b13896c6c056632236002aa83640b39ae69d2ef3f973e31d1531624b6"
# the lm encoder, card against CPU from the same weights: embeddings within
LM_EMBED_TOL = 2e-3
# the serving phase's durable service checkpoints every that many ingests,
# and its crash worker dies at this hit of the ``rounds`` fault site
SERVING_CKPT_EVERY = 8
SERVING_CRASH_HIT = 12
STREAM_SPANS = ("ingest.lsh", "ingest.replay", "ingest.cover_splice",
                "ingest.grounding_splice", "ingest.rounds", "ingest.commit")

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
    "minhash": dict(
        source="src/repro_torch/csrc/minhash.cu",
        replaces="src/repro/kernels/minhash/kernel.py:59",
    ),
    "flash_attn": dict(
        # the tensor-core kernel carries the serving path (bf16, hd 64/128);
        # flash_attn.cu takes f32 inputs and hd 8/16/32
        source="src/repro_torch/csrc/flash_attn_sm90.cu",
        sources=["src/repro_torch/csrc/flash_attn_sm90.cu", "src/repro_torch/csrc/flash_attn.cu"],
        replaces="src/repro/kernels/flash_attn/kernel.py:108",
    ),
}


def _wrappers() -> dict:
    """Each ported kernel's wrapper, which carries its launch counter."""
    from repro_torch.kernels.flash_attn import ops as flash
    from repro_torch.kernels.icm_sweep import ops as icm
    from repro_torch.kernels.minhash import ops as mh
    from repro_torch.kernels.mln_score import ops as score
    from repro_torch.kernels.ngram_sim import ops as sim

    return {"icm_sweep": icm.sweep_batched, "ngram_sim": sim.sim_above,
            "mln_score": score.score_sets, "minhash": mh.minhash,
            "flash_attn": flash.attention}


def _zero_counts() -> None:
    for w in _wrappers().values():
        w.launches = 0
    _wrappers()["flash_attn"].wgmma_launches = 0


def _read_counts() -> dict:
    return {name: w.launches for name, w in _wrappers().items()}


def _count_into(total: dict, lc: dict) -> None:
    """Add the launch counts ``lc`` of one run into ``total``."""
    for name, n in lc.items():
        total[name] += n


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


def bound(n_bytes: int, ops: int, peak: float = PEAK_F32_FLOPS) -> tuple[float, str]:
    """Least time on the card (ms): the larger of bytes and operations (at
    ``peak`` operations a second: float32 by default)."""
    t_bytes = n_bytes / PEAK_BYTES_S * 1e3
    t_ops = ops / peak * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def phase_build(ptxas_verbose: bool = False) -> float:
    from repro_torch.kernels import build

    t0 = time.perf_counter()
    path = build.library_path()
    build.build(ptxas_verbose=ptxas_verbose)
    build.library()
    secs = time.perf_counter() - t0
    log(f"[build] {path.relative_to(ROOT)} in {secs:.1f} s")
    return secs


def _symmetric_coupling(rng, B, P, w_co=2.46, density=0.02):
    link = np.triu(rng.random((B, P, P)) < density, 1)
    link = link | link.transpose(0, 2, 1)
    return (w_co * link).astype(np.float32)


def _score_work(X: np.ndarray) -> dict:
    """(bytes, flops) of ``score_sets`` on X (B, S, P), two ways.  "present":
    reading only the rows of C at X's present entries (u and X read and out
    written once, each row C[b, q] that some s of b needs read once, 2 flops
    a value of a row for each present entry; at S = 1 the bytes are
    4 (B P + B S P + B S + P nnz(X))).  "dense": reading all of C."""
    B, S, P = X.shape
    present = X != 0
    rows = int(np.count_nonzero(present.any(axis=1)))
    nnz = int(np.count_nonzero(present))
    return dict(
        present=(4 * (B * P + B * S * P + B * S + P * rows), 2 * P * nnz + 2 * B * S * P),
        dense=(4 * (B * P + B * P * P + B * S * P + B * S), 2 * B * S * P * P + 2 * B * S * P),
    )


def phase_kernels(dev, only: list[str] | None = None) -> list[dict]:
    """Each kernel (or each named in ``only``) vs its plain version on the
    card at the main path's shapes."""
    import torch

    from repro_torch.kernels.flash_attn import ops as flash
    from repro_torch.kernels.icm_sweep import ops as icm
    from repro_torch.kernels.minhash import ops as mh
    from repro_torch.kernels.mln_score import ops as score
    from repro_torch.kernels.ngram_sim import ops as sim

    rng = np.random.default_rng(0)
    rows = []

    def wanted(name):
        return only is None or name in only

    def put(a):
        return torch.as_tensor(a, device=dev)

    def check(name, shape, kernel, plain, library, tol, n_bytes, ops, peak=PEAK_F32_FLOPS,
              iters=50, dense=None):
        """``dense``: (bytes, ops) of a kernel that reads every input whole,
        where ``n_bytes`` and ``ops`` count only what this input's data needs."""
        got, want = kernel(), plain()
        torch.cuda.synchronize()
        if tol is None:  # exact: integer outputs
            require(torch.equal(got, want), f"{name} {shape}: kernel and plain version differ")
        else:
            np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(), **tol)
        ms, call_ms = time_ms(kernel, iters)
        row = dict(
            name=name, shape=shape,
            max_abs_err=float((got.double() - want.double()).abs().max()),
            ms=ms, call_ms=call_ms, plain_ms=time_ms(plain, iters)[0],
            library_ms=None if library is None else time_ms(library, iters)[0],
        )
        row["bound_ms"], row["bound_by"] = bound(n_bytes, ops, peak)
        if dense is not None:
            row["dense_bound_ms"] = bound(*dense, peak)[0]
        lib = "n/a" if row["library_ms"] is None else f"{row['library_ms']:.4f}"
        log(
            f"[kernels] {name:9s} {shape:22s} ok  max_abs_err={row['max_abs_err']:.3g}"
            f"  kernel_ms={ms:.4f} (eager call {call_ms:.4f})  plain_ms={row['plain_ms']:.4f}"
            f"  library_ms={lib}  bound_ms={row['bound_ms']:.5f} ({row['bound_by']})"
            + (f"  dense_bound_ms={row['dense_bound_ms']:.5f}" if dense is not None else "")
        )
        rows.append(row)

    f32 = dict(rtol=1e-5, atol=1e-5)
    # the k=32 bin's closure, entailment and batch sweeps, then the other
    # bins' P (k=16: 120, k=24: 276) at S = 1 and S = P, and last the
    # round-parallel engine's full round: the k=32 bin's 192 rows' entailment
    for B, S, P in [(1, 1, 496), (1, 496, 496), (192, 1, 496),
                    (1, 1, 120), (1, 120, 120), (1, 1, 276), (1, 276, 276),
                    (192, 496, 496)]:
        if not wanted("icm_sweep"):
            break
        u = put(rng.standard_normal((B, P)).astype(np.float32))
        C = put(_symmetric_coupling(rng, B, P))
        X = put((rng.random((B, S, P)) < 0.3).astype(np.float32))
        check(
            "icm_sweep", f"B={B},S={S},P={P}",
            lambda: icm.sweep_batched(u, C, X), lambda: icm.sweep_batched_plain(u, C, X),
            lambda: torch.baddbmm(u[:, None, :], X, C), f32,
            4 * (B * P + B * P * P + 2 * B * S * P), 2 * B * S * P * P,
            iters=10 if B * S > 1 << 12 else 50,
        )

    # the canopy seed probe, the all-pairs form, and the streaming probe;
    # then the canopy's second chunk, the probe's two ends, a ragged F and
    # an F that is not a multiple of 4 (the 4-byte copies)
    for M, N, F in [(1, 1024, 128), (1024, 1842, 128), (64, 936, 128), (1, 818, 128),
                    (64, 65, 128), (68, 1697, 128), (3, 70, 100), (5, 37, 30)]:
        if not wanted("ngram_sim"):
            break
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

    # the k=32 bin at X density 0.3, then at the path's own sparsity (50
    # valid pairs a neighborhood, 35 present on average, C zero outside the
    # valid pairs as the grounding masks it), an all-zero X, an X that is
    # not 0/1, S = 16 at the k=16 bin's P, and a P that is not a multiple of
    # 4 (the 4-byte loads)
    for B, S, P, x_kind in [(192, 1, 496, "x 0.3"), (192, 1, 496, "path"),
                            (192, 1, 496, "x 0"), (192, 1, 496, "x real"),
                            (90, 16, 120, "x 0.3"), (64, 2, 378, "x 0.3")]:
        if not wanted("mln_score"):
            break
        u = rng.standard_normal((B, P)).astype(np.float32)
        C = _symmetric_coupling(rng, B, P)
        present = rng.random((B, S, P)) < 0.3
        if x_kind == "path":
            valid = np.zeros((B, P), dtype=bool)
            for b in range(B):
                valid[b, rng.choice(P, 50, replace=False)] = True
            u = np.where(valid, u, np.float32(0))
            C = C * (valid[:, :, None] & valid[:, None, :])
            present = valid[:, None, :] & (rng.random((B, S, P)) < 0.7)
        X = present.astype(np.float32)
        if x_kind == "x 0":
            X[:] = 0
        elif x_kind == "x real":
            X *= rng.standard_normal((B, S, P)).astype(np.float32)
        work = _score_work(X)  # the rows of C this X needs
        u, C, X = put(u), put(C), put(X)
        check(
            "mln_score", f"B={B},S={S},P={P},{x_kind}",
            lambda: score.score_sets(u, C, X), lambda: score.score_sets_plain(u, C, X),
            None,  # no single PyTorch call computes x.u + x C x^T / 2
            dict(rtol=2e-5, atol=2e-4),
            *work["present"], dense=work["dense"],
        )

    # the per-ingest signature call, the whole corpus at once, one row, the
    # schedule's largest batch, a ragged table (H = 8, D = 40) and a D that is
    # not a multiple of 4 (4-byte loads of X); each through the entry the
    # path takes (the transposed table) and through the (H, D) table
    for N, H, D in [(64, 128, 512), (1842, 128, 512), (1, 128, 512), (67, 128, 512),
                    (5, 8, 40), (9, 33, 70)]:
        if not wanted("minhash"):
            break
        present = rng.random((N, D)) < (9 / 512 if D == 512 else 0.2)  # the path's density
        if N >= 4:
            present[[1, N // 2, N - 1]] = False  # rows with no shingle give EMPTY
        X = put(present.astype(np.float32))
        A = put(mh.hash_table(H, D, seed=N))
        At = A.T.contiguous()
        for label, kernel in [("", lambda: mh.minhash_transposed(X, At)),
                              (",A (H,D)", lambda: mh.minhash(X, A))]:
            check(
                "minhash", f"N={N},H={H},D={D}{label}",
                kernel, lambda: mh.minhash_plain(X, A),
                None,  # no single PyTorch call computes the masked min
                None,  # exact
                # ops: one int32 min for each present shingle of each row and hash
                4 * (N * D + H * D + N * H), H * int(present.sum()), PEAK_INT32_OPS,
            )

    # the serving path's prefills in bf16 first (Yi-6B's requests, its long
    # prompt, the embedding matcher's encoder, a Qwen1.5-0.5B prompt at hd
    # 64), then the reference test's f32 shapes, a ragged S = T, and a
    # causal S < T
    for B, S, T, H, hkv, hd, dtype, causal in [
        (4, 32, 32, 32, 4, 128, torch.bfloat16, True),
        (1, 4096, 4096, 32, 4, 128, torch.bfloat16, True),
        (8, 32, 32, 4, 4, 8, torch.bfloat16, True),
        (1, 2048, 2048, 16, 16, 64, torch.bfloat16, True),
        *[(2, S_, S_, H_, k_, d_, torch.float32, c)
          for S_, H_, k_, d_ in [(128, 4, 2, 32), (256, 2, 2, 64), (192, 4, 1, 32)]
          for c in (True, False)],
        (2, 100, 100, 4, 2, 16, torch.float32, True),
        (2, 40, 100, 4, 2, 8, torch.float32, True),
    ]:
        if not wanted("flash_attn"):
            break
        q, k, v = (
            put(rng.standard_normal((B, n, h, hd)).astype(np.float32)).to(dtype)
            for n, h in [(S, H), (T, hkv), (T, hkv)]
        )
        scale = 1.0 / np.sqrt(hd)
        # (row, col) score pairs this input needs: all, or col <= row under the mask
        pairs = sum(min(r + 1, T) for r in range(S)) if causal else S * T
        esize = q.element_size()
        route = flash.route(dtype, hd)
        before = flash.attention.wgmma_launches
        check(
            "flash_attn",
            f"B={B},S={S},T={T},H={H},Hkv={hkv},hd={hd},{str(dtype)[6:]},"
            + ("causal" if causal else "full") + f",{route}",
            lambda: flash.attention(q, k, v, scale, causal=causal),
            lambda: flash.attention_plain(q, k, v, scale, causal=causal),
            lambda: torch.nn.functional.scaled_dot_product_attention(
                q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
                is_causal=causal, scale=scale, enable_gqa=True),
            dict(rtol=2e-3, atol=2e-3),
            esize * (B * S * H * hd + 2 * B * T * hkv * hd) + 4 * B * S * H * hd,
            4 * B * H * hd * pairs,
            PEAK_BF16_FLOPS if dtype == torch.bfloat16 else PEAK_F32_FLOPS,
            iters=10 if S * T > 1 << 20 else 50,
        )
        require((flash.attention.wgmma_launches > before) == (route == "wgmma"),
                f"flash_attn at hd={hd}, {dtype} did not take the {route} route")
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

    ds = make_dataset(SynthConfig.hepth(scale=1.0, seed=7))
    truth = ds.entities.truth

    _zero_counts()
    gpu, wall, icm_runs = {}, {}, {}
    for scheme in EXPECTED:
        before = _read_counts()["icm_sweep"]
        t0 = time.perf_counter()
        gpu[scheme] = pipeline.resolve(ds.entities, ds.relations, scheme=scheme, device=dev)
        torch.cuda.synchronize()
        wall[scheme] = time.perf_counter() - t0
        icm_runs[scheme] = _read_counts()["icm_sweep"] - before
    fixpoint = gpu["mmp"]
    matcher = MLNMatcher(PAPER_LEARNED, device=dev)
    scores = {
        k: matcher.score(nb, fixpoint.result.matches.mask_of(nb.pair_gid))
        for k, nb in fixpoint.packed.bins.items()
    }
    torch.cuda.synchronize()
    launches = _read_counts()
    log(f"[pipeline] launches on the main path: {launches}")
    for name in ("icm_sweep", "ngram_sim", "mln_score"):
        require(launches[name] > 0, f"{name} was never launched on the main path")
    require(launches["mln_score"] == len(fixpoint.packed.bins),
            f"mln_score launched {launches['mln_score']} times, once a bin expected")
    time_fixpoint_score(dev, matcher, fixpoint)

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
            f"P {prf.precision:.4f} R {prf.recall:.4f} F1 {prf.f1:.4f}, "
            f"icm_sweep launches {icm_runs[scheme]}"
        )
    return launches, gpu, icm_runs


def time_fixpoint_score(dev, matcher, fixpoint, k: int = 32) -> None:
    """``score_sets`` on the path's own input: the k=32 bin's grounding and
    the MMP fixpoint's mask, timed (after the counted run) beside its bounds."""
    import torch

    from repro_torch.kernels.mln_score import ops as score

    nb = fixpoint.packed.bins[k]
    g = matcher.ground(nb)
    mask = np.asarray(fixpoint.result.matches.mask_of(nb.pair_gid), dtype=bool)
    X = torch.as_tensor(mask, device=dev).float()[:, None, :]
    kernel = lambda: score.score_sets(g.u_raw, g.C, X)  # noqa: E731
    plain = lambda: score.score_sets_plain(g.u_raw, g.C, X)  # noqa: E731
    np.testing.assert_allclose(kernel().cpu().numpy(), plain().cpu().numpy(),
                               rtol=2e-5, atol=2e-4)
    ms, call_ms = time_ms(kernel)
    work = _score_work(mask[:, None, :])
    log(f"[pipeline] mln_score on the MMP fixpoint's k={k} bin (B,S,P = {tuple(X.shape)}, "
        f"{mask.sum()} present pairs, {mask.sum(1).mean():.1f} a row, at most "
        f"{mask.sum(1).max()}): kernel_ms={ms:.4f} (eager call {call_ms:.4f})  "
        f"plain_ms={time_ms(plain)[0]:.4f}  bound_ms={bound(*work['present'])[0]:.5f} "
        f"(present rows)  dense_bound_ms={bound(*work['dense'])[0]:.5f}")


def stream_run(dev, scheme: str, batches, **config) -> dict:
    """One ``ResolveService`` fed ``batches`` on ``dev`` (``config``: more
    ``ServiceConfig`` fields): the reference table's quantities, the wall
    and span times, and the launch counts."""
    import torch

    from repro_torch import obs
    from repro_torch.core.mln import PAPER_LEARNED
    from repro_torch.stream import ResolveService, ServiceConfig

    svc = ResolveService(ServiceConfig(scheme=scheme, weights=PAPER_LEARNED, **config),
                         device=dev)
    obs.reset()
    _zero_counts()
    t0 = time.perf_counter()
    reports = [svc.ingest(b.names, b.edges, ids=b.ids) for b in batches]
    if dev.type == "cuda":
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = _read_counts()
    spans = obs.get_registry().snapshot()["spans"]
    ingest_s = np.array([r.wall_time_s for r in reports])
    return dict(
        service=svc, wall=wall, launches=launches,
        p50=float(np.percentile(ingest_s, 50)), p99=float(np.percentile(ingest_s, 99)),
        spans={n: spans.get(n, {}).get("total_s", 0.0) for n in STREAM_SPANS},
        **service_summary(svc),
    )


def service_summary(svc) -> dict:
    """The reference table's quantities of a ``ResolveService``, summed over
    its ingest reports."""
    from repro_torch.stream.digest import match_digest, state_digest

    reports = svc.reports
    return dict(
        matches=len(svc.matches), evals=sum(r.neighborhood_evals for r in reports),
        clusters=len(svc.clusters()),
        replay_visits=sum(r.replay_visits for r in reports),
        cover_splice_rows=sum(r.cover_splice_rows for r in reports),
        grounding_pair_visits=sum(r.grounding_pair_visits for r in reports),
        dispatches=svc.engine.total_dispatches,
        reground_rows=sum(r.reground_rows for r in reports),
        peak_resident_bins=max(r.peak_resident_bins for r in reports),
        cache_evictions=sum(r.cache_evictions for r in reports),
        cold_regrounds=sum(r.cold_regrounds for r in reports),
        match_digest=match_digest(svc.matches), state_digest=state_digest(svc),
    )


def stream_schedules(ds) -> dict:
    """Batches by count: 29 paper-aligned ones, and the whole corpus as one
    (every id and every coauthor edge)."""
    from repro_torch.data.synthetic import arrival_stream

    return {29: arrival_stream(ds, batch_size=64), 1: arrival_stream(ds, 1)}


def phase_stream(dev, resolved) -> dict:
    """The streaming service on CUDA against the reference table; returns
    the launch counts summed over its runs."""
    from repro_torch.data.synthetic import SynthConfig, make_dataset

    ds = make_dataset(SynthConfig.hepth(scale=1.0, seed=7))
    schedules = stream_schedules(ds)
    require(len(schedules[29]) == 29, f"{len(schedules[29])} batches, expected 29")
    total = dict.fromkeys(KERNELS, 0)
    for (scheme, n_batches), want in EXPECTED_STREAM.items():
        run = stream_run(dev, scheme, schedules[n_batches])
        got = {k: run[k] for k in want}
        require(got == want, f"stream {scheme}/{n_batches}: got {got}, expected {want}")
        lc = run["launches"]
        if n_batches == 29:
            require(lc["minhash"] == n_batches,
                    f"minhash launched {lc['minhash']} times in {n_batches} ingests")
        for name in ("minhash", "ngram_sim", "icm_sweep"):
            require(lc[name] > 0, f"{name} was never launched on the stream path")
        if n_batches == 1:
            require(np.array_equal(run["service"].matches.gids, resolved["smp"].result.matches.gids),
                    "one-batch stream and batch resolve give different smp gids")
        _count_into(total, lc)
        log(
            f"[stream] {scheme}, {n_batches} batches: wall {run['wall']:.2f} s, ingest p50 "
            f"{run['p50'] * 1e3:.1f} ms p99 {run['p99'] * 1e3:.1f} ms; spans s: "
            + ", ".join(f"{n.removeprefix('ingest.')} {t:.3f}" for n, t in run["spans"].items())
            + f"; matches {run['matches']}, evals {run['evals']}, clusters {run['clusters']}, "
            f"launches {lc}"
        )
    return total


def gid_digest(gids) -> str:
    """sha256 of the sorted match gids as int64."""
    return hashlib.sha256(np.sort(np.asarray(gids)).astype(np.int64).tobytes()).hexdigest()


def phase_rules(dev, resolved) -> dict:
    """``resolve`` with the RULES matcher on ``dev`` (nomp, smp) against
    ``EXPECTED_RULES``, on phase 3's cover and grounding; MMP must refuse
    it.  Returns the launch counts summed over its runs, and each run's
    ``icm_sweep`` launches."""
    from repro_torch.core import pipeline
    from repro_torch.core.rules import RulesMatcher
    from repro_torch.data.synthetic import SynthConfig, make_dataset

    ds = make_dataset(SynthConfig.hepth(scale=1.0, seed=7))
    packed, gg = resolved["mmp"].packed, resolved["mmp"].gg
    total = dict.fromkeys(KERNELS, 0)
    icm_runs = {}
    for scheme, want in EXPECTED_RULES.items():
        _zero_counts()
        t0 = time.perf_counter()
        res = pipeline.resolve(ds.entities, ds.relations, scheme=scheme, packed=packed, gg=gg,
                               matcher=RulesMatcher(device=dev), device=dev)
        _sync(dev)
        wall = time.perf_counter() - t0
        lc = _read_counts()
        require(lc["icm_sweep"] > 0, f"rules {scheme}: icm_sweep was never launched")
        r = res.result
        prf = pipeline.evaluate(res, ds.entities.truth)
        got = (r.neighborhood_evals, r.messages_emitted, r.messages_promoted, len(r.matches),
               round(prf.precision, 4), round(prf.recall, 4), round(prf.f1, 4))
        require(got == want, f"rules {scheme}: got {got}, expected {want}")
        digest = gid_digest(r.matches.gids)
        require(digest == RULES_GID_DIGEST,
                f"rules {scheme}: gid digest {digest}, expected {RULES_GID_DIGEST}")
        _count_into(total, lc)
        icm_runs[scheme] = lc["icm_sweep"]
        log(f"[rules] {scheme}: wall {wall:.2f} s (matching {r.wall_time_s:.2f} s), evals "
            f"{r.neighborhood_evals}, matches {len(r.matches)}, P {prf.precision:.4f} "
            f"R {prf.recall:.4f} F1 {prf.f1:.4f}, gid digest {digest[:16]}..., "
            f"icm_sweep launches {lc['icm_sweep']}")
    try:
        pipeline.resolve(ds.entities, ds.relations, scheme="mmp", packed=packed, gg=gg,
                         matcher=RulesMatcher(device=dev), device=dev)
    except AssertionError as e:
        log(f"[rules] mmp refuses RulesMatcher: {e}")
    else:
        raise RuntimeError("resolve(scheme='mmp') accepted RulesMatcher, which has no score()")
    return total, icm_runs


def _profile_run(dev, run) -> dict:
    """``run()`` under torch.profiler, device activity only: the wall, the
    device's busy seconds (summed kernel and copy time), the device ops,
    the device-to-host copies, and the device events themselves."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    _sync(dev)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        _sync(dev)
        wall = time.perf_counter() - t0
    events = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    return dict(wall=wall, busy=sum(e.time_range.elapsed_us() for e in events) / 1e6,
                ops=len(events), d2h=sum("DtoH" in e.name for e in events), events=events)


def parallel_run(dev, packed, gg, kind: str, scheme: str, fused: bool, truth) -> dict:
    """One ``run_parallel`` on ``dev`` (the MLN matcher at the paper's weights,
    or RULES), the launch counters set to 0 just before it and read just
    after: its ``EMResult``, P/R/F1, synchronized wall and launch counts."""
    from repro_torch.core import metrics
    from repro_torch.core.closure import transitive_closure
    from repro_torch.core.mln import MLNMatcher, PAPER_LEARNED
    from repro_torch.core.parallel import run_parallel
    from repro_torch.core.rules import RulesMatcher

    matcher = (RulesMatcher(device=dev) if kind == "rules"
               else MLNMatcher(PAPER_LEARNED, device=dev))
    _zero_counts()
    _sync(dev)
    t0 = time.perf_counter()
    res = run_parallel(packed, matcher, gg, scheme=scheme, fused=fused, device=dev)
    _sync(dev)
    wall = time.perf_counter() - t0
    launches = _read_counts()
    prf = metrics.prf(transitive_closure(res.matches), truth, candidate_gids=gg.gids)
    return dict(result=res, prf=prf, wall=wall, launches=launches)


def phase_parallel(dev, resolved, seq_icm: dict, rules_icm: dict) -> dict:
    """The round-parallel engine on ``dev`` against ``EXPECTED_PARALLEL`` on
    phase 3's cover and grounding, ``resolve(parallel=True)``, and the
    streaming service on it against ``EXPECTED_STREAM_PARALLEL`` and in
    spill mode.  ``seq_icm``/``rules_icm``: the sequential runs' ``icm_sweep``
    launches, printed beside this phase's.  Returns the launch counts
    summed over its counted runs."""
    from repro_torch.core import pipeline
    from repro_torch.core.mln import MLNMatcher, PAPER_LEARNED
    from repro_torch.core.parallel import run_parallel
    from repro_torch.data.synthetic import SynthConfig, make_dataset

    t_phase = time.perf_counter()
    ds = make_dataset(SynthConfig.hepth(scale=1.0, seed=7))
    truth = ds.entities.truth
    packed, gg = resolved["mmp"].packed, resolved["mmp"].gg
    total = dict.fromkeys(KERNELS, 0)
    count = functools.partial(_count_into, total)
    for (kind, scheme, fused), want in EXPECTED_PARALLEL.items():
        tag = f"{kind} {scheme} {'fused' if fused else 'legacy'}"
        run = parallel_run(dev, packed, gg, kind, scheme, fused, truth)
        r, prf, lc = run["result"], run["prf"], run["launches"]
        count(lc)
        got = (r.rounds, r.neighborhood_evals, r.messages_emitted, r.messages_promoted,
               len(r.matches), round(prf.precision, 4), round(prf.recall, 4), round(prf.f1, 4),
               r.dispatches, r.full_rounds, r.history, r.promote_host_scans)
        require(got == want, f"parallel {tag}: got {got}, expected {want}")
        digest = gid_digest(r.matches.gids)
        if kind == "mln":
            require(np.array_equal(r.matches.gids, resolved[scheme].result.matches.gids),
                    f"parallel {tag}: gids differ from the sequential {scheme} run's")
        want_digest = PARALLEL_GID_DIGEST[scheme] if kind == "mln" else RULES_GID_DIGEST
        require(digest == want_digest, f"parallel {tag}: gid digest {digest}, expected {want_digest}")
        require(lc["icm_sweep"] > 0, f"parallel {tag}: icm_sweep was never launched")
        seq = (seq_icm if kind == "mln" else rules_icm)[scheme]
        log(f"[parallel] {tag}: wall {run['wall']:.2f} s (EMResult {r.wall_time_s:.2f} s), "
            f"dispatches {r.dispatches}, rounds {r.rounds} {r.history}, evals "
            f"{r.neighborhood_evals}, messages {r.messages_emitted}/{r.messages_promoted}, "
            f"matches {len(r.matches)}, F1 {prf.f1:.4f}, gid digest {digest[:16]}...; "
            f"icm_sweep launches {lc['icm_sweep']} (sequential {scheme}: {seq}); launches {lc}")

    # the pipeline's own entry point, cover included
    _zero_counts()
    t0 = time.perf_counter()
    res = pipeline.resolve(ds.entities, ds.relations, scheme="mmp", parallel=True, device=dev)
    _sync(dev)
    wall = time.perf_counter() - t0
    lc = _read_counts()
    count(lc)
    prf = pipeline.evaluate(res, truth)
    got = (len(res.result.matches), round(prf.precision, 4), round(prf.recall, 4),
           round(prf.f1, 4), res.result.dispatches, gid_digest(res.result.matches.gids))
    want = (3000, *_MMP, 9, PARALLEL_GID_DIGEST["mmp"])
    require(got == want, f"resolve(parallel=True) mmp: got {got}, expected {want}")
    require(lc["icm_sweep"] > 0 and lc["ngram_sim"] > 0,
            f"resolve(parallel=True) mmp: kernels not launched: {lc}")
    log(f"[parallel] resolve(parallel=True) mmp: wall {wall:.2f} s (cover "
        f"{res.cover_time_s:.2f} s, matching {res.result.wall_time_s:.2f} s), "
        f"dispatches {res.result.dispatches}, matches {len(res.result.matches)}, "
        f"F1 {prf.f1:.4f}; launches {lc}")

    # where the fused mmp run's time goes (not counted)
    prof = _profile_run(dev, lambda: run_parallel(
        packed, MLNMatcher(PAPER_LEARNED, device=dev), gg, scheme="mmp", device=dev))
    log(f"[parallel] mmp fused under torch.profiler: wall {prof['wall']:.2f} s, device busy "
        + (f"{prof['busy']:.3f} s ({100 * prof['busy'] / prof['wall']:.1f}%)" if prof["ops"]
           else "not measured (the profiler saw no device activity)")
        + f", {prof['ops']} device ops, {prof['d2h']} of them device-to-host copies "
        "(the sequential driver's share: phase 10, `[profile]`)")

    batches = stream_schedules(ds)[29]
    for scheme, want in EXPECTED_STREAM_PARALLEL.items():
        run = stream_run(dev, scheme, batches, parallel=True)
        got = {k: run[k] for k in want}
        require(got == want, f"parallel stream {scheme}: got {got}, expected {want}")
        lc = run["launches"]
        count(lc)
        require(lc["minhash"] == len(batches),
                f"parallel stream {scheme}: minhash launched {lc['minhash']} times in "
                f"{len(batches)} ingests")
        require(lc["icm_sweep"] > 0, f"parallel stream {scheme}: icm_sweep was never launched")
        log(f"[parallel] stream {scheme}, {len(batches)} batches: wall {run['wall']:.2f} s, "
            f"ingest p50 {run['p50'] * 1e3:.1f} ms p99 {run['p99'] * 1e3:.1f} ms; spans s: "
            + ", ".join(f"{n.removeprefix('ingest.')} {t:.3f}" for n, t in run["spans"].items())
            + f"; dispatches {run['dispatches']}, matches {run['matches']}, evals {run['evals']}, "
            f"re-ground rows {run['reground_rows']}, launches {lc}")
    spill = stream_run(dev, "mmp", batches, parallel=True, gcache_capacity=1)
    count(spill["launches"])
    want_digest = EXPECTED_STREAM_PARALLEL["mmp"]["match_digest"]
    require(spill["match_digest"] == want_digest,
            f"spill-mode stream: match digest {spill['match_digest']}, expected {want_digest}")
    require(spill["peak_resident_bins"] <= 1 and spill["cache_evictions"] > 0
            and spill["cold_regrounds"] > 0,
            f"spill-mode stream: peak {spill['peak_resident_bins']} bins, "
            f"{spill['cache_evictions']} evictions, {spill['cold_regrounds']} cold re-grounds")
    log(f"[parallel] stream mmp, gcache_capacity=1: wall {spill['wall']:.2f} s, ingest p50 "
        f"{spill['p50'] * 1e3:.1f} ms p99 {spill['p99'] * 1e3:.1f} ms; spans s: "
        + ", ".join(f"{n.removeprefix('ingest.')} {t:.3f}" for n, t in spill["spans"].items())
        + f"; dispatches {spill['dispatches']}, evals {spill['evals']}, matches "
        f"{spill['matches']}, peak "
        f"resident bins {spill['peak_resident_bins']}, evictions {spill['cache_evictions']}, "
        f"cold re-grounds {spill['cold_regrounds']}, re-ground rows {spill['reground_rows']}, "
        f"launches {spill['launches']}")
    log(f"[parallel] phase {time.perf_counter() - t_phase:.1f} s")
    return total


def _prf4(prf) -> tuple:
    return round(prf.precision, 4), round(prf.recall, 4), round(prf.f1, 4)


def matcher_families(dev, total: dict) -> None:
    """Every registered family through ``resolve(scheme="smp")`` on the
    bipartite corpus on ``dev`` (the sequential driver, and the parallel
    engine for the device families), held to ``EXPECTED_MATCHERS``;
    ``run_parallel`` must refuse the host-only families."""
    from repro_torch.core import pipeline
    from repro_torch.core.matchers import get_matcher, list_matchers, matcher_info
    from repro_torch.core.parallel import run_parallel
    from repro_torch.data.synthetic import make_bipartite

    ds = make_bipartite(BIPARTITE["groups"], seed=BIPARTITE["seed"])
    require(len(ds.entities) == BIPARTITE["refs"], "bipartite corpus size changed")
    packed, gg, _ = pipeline.prepare(ds.entities, ds.relations, device=dev)
    runs = [(n, par) for n in list_matchers() for par in (False, True)
            if not par or matcher_info(n).device_parallel]
    require(sorted(runs) == sorted(EXPECTED_MATCHERS), f"families changed: {runs}")
    for name, par in runs:
        _zero_counts()
        t0 = time.perf_counter()
        res = pipeline.resolve(ds.entities, ds.relations, scheme="smp", packed=packed, gg=gg,
                               matcher=get_matcher(name, device=dev), parallel=par, device=dev)
        _sync(dev)
        wall = time.perf_counter() - t0
        lc = _read_counts()
        _count_into(total, lc)
        r = res.result
        got = (r.neighborhood_evals, len(r.matches), *_prf4(pipeline.evaluate(res, ds.entities.truth)),
               gid_digest(r.matches.gids)[:16])
        want = EXPECTED_MATCHERS[(name, par)]
        tag = f"{name} {'parallel' if par else 'sequential'}"
        require(got == want, f"matchers {tag}: got {got}, expected {want}")
        if name.startswith(("mln", "rules")):
            require(lc["icm_sweep"] > 0, f"matchers {tag}: icm_sweep was never launched")
        log(f"[matchers] bipartite {tag}: wall {wall:.2f} s, evals {got[0]}, matches {got[1]}, "
            f"P/R/F1 {got[2]}/{got[3]}/{got[4]}, gid digest {got[5]}, launches {lc}")
    for name in list_matchers():
        if matcher_info(name).device_parallel:
            continue
        try:
            run_parallel(packed, get_matcher(name, device=dev), scheme="smp", device=dev)
        except TypeError as e:
            log(f"[matchers] run_parallel refuses {name}: {str(e)[:60]}...")
        else:
            raise RuntimeError(f"run_parallel accepted the host-only family {name}")


def embed_ngram(dev, ds, packed, gg, total: dict) -> None:
    """The ngram embedding family at the users' scale (phase 3's corpus and
    cover), both engines, held to ``EXPECTED_EMBED_NGRAM``."""
    from repro_torch.core import pipeline
    from repro_torch.core.matchers.embedding import EmbeddingMatcher

    for par, want in EXPECTED_EMBED_NGRAM.items():
        m = EmbeddingMatcher(encoder="ngram", device=dev)
        m.bind_names(list(ds.entities.names))
        _zero_counts()
        t0 = time.perf_counter()
        res = pipeline.resolve(ds.entities, ds.relations, scheme="smp", packed=packed, gg=gg,
                               matcher=m, parallel=par, device=dev)
        _sync(dev)
        wall = time.perf_counter() - t0
        _count_into(total, _read_counts())
        r = res.result
        got = (r.neighborhood_evals, r.rounds, r.dispatches, len(r.matches),
               *_prf4(pipeline.evaluate(res, ds.entities.truth)), m.encode_calls, m.encoded_ids)
        tag = f"ngram {'parallel' if par else 'sequential'}"
        require(got == want, f"matchers {tag}: got {got}, expected {want}")
        digest = gid_digest(r.matches.gids)
        require(digest == EMBED_NGRAM_DIGEST, f"matchers {tag}: gid digest {digest}")
        log(f"[matchers] hepth {tag}: wall {wall:.2f} s (matching {r.wall_time_s:.2f} s), evals "
            f"{got[0]}, rounds {got[1]}, dispatches {got[2]}, matches {got[3]}, P/R/F1 "
            f"{got[4]}/{got[5]}/{got[6]}, encode calls {got[7]}, encoded ids {got[8]}")


def _lm_run(dev, ds, packed, gg):
    from repro_torch.core import pipeline
    from repro_torch.core.matchers.embedding import EmbeddingMatcher

    m = EmbeddingMatcher(encoder="lm", device=dev)
    m.bind_names(list(ds.entities.names))
    t0 = time.perf_counter()
    res = pipeline.resolve(ds.entities, ds.relations, scheme="smp", packed=packed, gg=gg,
                           matcher=m, parallel=True, device=dev)
    _sync(dev)
    return m, res, time.perf_counter() - t0


def embed_lm(dev, ds, packed, gg, total: dict) -> None:
    """The lm embedding family, parallel smp, on the card against the port
    on the CPU from the same weights (drawn on the CPU from the seed):
    embeddings within ``LM_EMBED_TOL``; match sets equal but for pairs whose
    cosine lies within the embeddings' error of ``tau``; ``flash_attn``
    launched twice a prefill (the em_encoder's 2 layers)."""
    import torch

    from repro_torch.core import pairs as pairlib
    from repro_torch.core import pipeline

    _zero_counts()
    with engine_probe(dev) as rec:
        m, res, wall = _lm_run(dev, ds, packed, gg)
    lc = _read_counts()
    _count_into(total, lc)
    prefills = len(rec["prefill_ms"])
    require(rec["finite"], "lm encoder: logits not finite")
    require(lc["flash_attn"] == 2 * prefills > 0,
            f"lm encoder: flash_attn launched {lc['flash_attn']} times in {prefills} prefills")
    m_cpu, res_cpu, wall_cpu = _lm_run(torch.device("cpu"), ds, packed, gg)
    ids = sorted(m._memo)
    require(ids == sorted(m_cpu._memo) == list(range(len(ds.entities))),
            "lm encoder: card and CPU encoded different ids")
    E = np.stack([m._memo[i] for i in ids])
    E_cpu = np.stack([m_cpu._memo[i] for i in ids])
    require(np.isfinite(E).all(), "lm encoder: embeddings not finite")
    err = float(np.abs(E - E_cpu).max())
    require(err <= LM_EMBED_TOL, f"lm encoder: card vs CPU embeddings differ by {err:.3g}")
    e = float(np.linalg.norm(E - E_cpu, axis=1).max())
    eps = 2 * e + e * e  # how far the error can move a cosine of unit vectors
    got, want = set(res.result.matches.gids.tolist()), set(res_cpu.result.matches.gids.tolist())
    differ = sorted(got ^ want)
    a, b = pairlib.split_gid(np.asarray(differ, dtype=np.int64))
    cos = (E_cpu[a] * E_cpu[b]).sum(-1)
    require(bool(np.all(np.abs(cos - m.tau) <= eps)),
            f"lm encoder: {len(differ)} differing matches, some further than {eps:.3g} from tau")
    prf = pipeline.evaluate(res, ds.entities.truth)
    log(f"[matchers] hepth lm parallel: wall {wall:.2f} s on the card ({wall_cpu:.2f} s on the "
        f"CPU), {prefills} prefills, flash_attn launches {lc['flash_attn']}, evals "
        f"{res.result.neighborhood_evals}, matches {len(got)} (CPU {len(want)}), F1 {prf.f1:.4f}; "
        f"embeddings card vs CPU max |d| {err:.3g} (limit {LM_EMBED_TOL}), cosine error bound "
        f"{eps:.3g}; {len(differ)} matches differ, each within it of tau; launches {lc}")


def phase_matchers(dev, resolved) -> dict:
    """The matcher registry's families on the card (see the module
    docstring); returns the launch counts summed over its counted runs."""
    from repro_torch.data.synthetic import SynthConfig, make_dataset

    t0 = time.perf_counter()
    total = dict.fromkeys(KERNELS, 0)
    matcher_families(dev, total)
    ds = make_dataset(SynthConfig.hepth(scale=1.0, seed=7))
    packed, gg = resolved["mmp"].packed, resolved["mmp"].gg
    embed_ngram(dev, ds, packed, gg, total)
    embed_lm(dev, ds, packed, gg, total)
    require(total["icm_sweep"] > 0 and total["flash_attn"] > 0,
            f"matchers: icm_sweep or flash_attn never launched: {total}")
    log(f"[matchers] phase {time.perf_counter() - t0:.1f} s; launches {total}")
    return total


def _durable_config(dur_dir):
    from repro_torch.core.mln import PAPER_LEARNED
    from repro_torch.stream import ServiceConfig

    return ServiceConfig(scheme="mmp", weights=PAPER_LEARNED, parallel=True,
                         durability_dir=str(dur_dir), checkpoint_every=SERVING_CKPT_EVERY)


def serve(svc, requests, config, start_first: bool = False) -> dict:
    """``requests`` through a ``ServingFrontend`` over ``svc``: queued before
    the worker starts (the flushes' schedule is then fixed), or submitted
    to a running worker as fast as one producer can.  Returns the wall,
    requests and entities a second and the queue-wait histogram."""
    from repro_torch import obs
    from repro_torch.stream import ServingFrontend

    fe = ServingFrontend(svc, config, start=start_first)
    t0 = time.perf_counter()
    tickets = [fe.submit(b.names, b.edges, [int(i) for i in b.ids]) for b in requests]
    fe.start()
    require(fe.drain(900), "serving: the front end did not drain")
    fe.close()
    _sync(svc.device)
    wall = time.perf_counter() - t0
    for t in tickets:
        t.wait(0)  # raises the flush's error, if any
    reg = obs.get_registry()
    n_entities = sum(len(b.names) for b in requests)
    return dict(wall=wall, requests_s=len(requests) / wall, entities_s=n_entities / wall,
                wait=reg.histogram("serve.queue.wait_ms").summary(),
                flushes=reg.histogram("serve.batch.requests").summary()["count"])


def crash_worker(dur_dir: str, device: str) -> int:
    """The serving phase's worker that dies: the durable service on
    ``device``, the 29 requests through the front end, a crash armed at the
    ``SERVING_CRASH_HIT``-th hit of ``rounds`` (exit ``CRASH_EXIT_CODE``)."""
    from repro_torch import faults
    from repro_torch.data.synthetic import SynthConfig, arrival_stream, make_dataset
    from repro_torch.kernels.common import resolve_device
    from repro_torch.stream import ResolveService, ServingConfig

    dev = resolve_device(device)
    batches = arrival_stream(make_dataset(SynthConfig.hepth(scale=1.0, seed=7)), batch_size=64)
    svc = ResolveService(_durable_config(dur_dir), device=dev)
    faults.install(faults.FaultPlan.fail_once("rounds", hit=SERVING_CRASH_HIT, crash=True))
    serve(svc, batches, ServingConfig(max_batch=1))
    return 0  # not reached when the crash fires


def phase_serving(dev) -> dict:
    """The serving front end over a durable service on the card, a crashed
    worker's directory recovered, and a coalescing run (see the module
    docstring); returns the launch counts summed over its counted runs."""
    import tempfile

    from repro_torch import obs
    from repro_torch.data.synthetic import SynthConfig, arrival_stream, make_dataset
    from repro_torch.faults import CRASH_EXIT_CODE
    from repro_torch.stream import ResolveService, ServiceConfig, ServingConfig
    from repro_torch.stream.digest import state_digest
    from repro_torch.stream.wal import WriteAheadLog

    t_phase = time.perf_counter()
    total = dict.fromkeys(KERNELS, 0)
    ds = make_dataset(SynthConfig.hepth(scale=1.0, seed=7))
    batches = arrival_stream(ds, batch_size=64)
    want = EXPECTED_STREAM_PARALLEL["mmp"]
    with tempfile.TemporaryDirectory(prefix=".chip_smoke_", dir=ROOT) as tmp:
        tmp = Path(tmp)
        # 1. the durable service behind the front end, one request a flush
        obs.reset()
        _zero_counts()
        svc = ResolveService(_durable_config(tmp / "durable"), device=dev)
        run = serve(svc, batches, ServingConfig(max_batch=1))
        svc.close()
        lc = _read_counts()
        _count_into(total, lc)
        got = {k: v for k, v in service_summary(svc).items() if k in want}
        require(got == want, f"serving durable: got {got}, expected {want}")
        require(lc["minhash"] == len(batches),
                f"serving: minhash launched {lc['minhash']} times in {len(batches)} ingests")
        require(run["flushes"] == len(batches), f"serving: {run['flushes']} flushes")
        steps = svc._ckpt.all_steps()
        last = len(batches) // SERVING_CKPT_EVERY * SERVING_CKPT_EVERY
        require(steps == [last - SERVING_CKPT_EVERY, last], f"serving: checkpoints {steps}")
        records, _ = WriteAheadLog.scan(tmp / "durable" / "wal")
        require([r.seq for r in records] == list(range(last + 1, len(batches) + 1)),
                f"serving: the WAL holds {[r.seq for r in records]} after the last checkpoint")
        reg = obs.get_registry()
        save_ms = reg.histogram("ckpt.save_ms").summary()
        ckpt_disk = sum(f.stat().st_size for f in (tmp / "durable" / "ckpt").rglob("*")
                        if f.is_file())
        log(f"[serving] durable mmp parallel, {len(batches)} requests, max_batch=1: wall "
            f"{run['wall']:.2f} s, {run['requests_s']:.2f} requests/s, {run['entities_s']:.1f} "
            f"entities/s, queue wait ms p50 {run['wait']['p50']:.1f} p99 {run['wait']['p99']:.1f}; "
            f"WAL {reg.value('wal.bytes')} bytes in {reg.value('wal.appends')} appends "
            f"(append ms p50 {reg.histogram('wal.append_ms').summary()['p50']:.3f}); "
            f"{reg.value('ckpt.saves')} checkpoints of {reg.value('ckpt.bytes') / reg.value('ckpt.saves') / 2**20:.2f} "
            f"MiB each (kept {steps}, {ckpt_disk / 2**20:.2f} MiB on disk), save ms p50 "
            f"{save_ms['p50']:.1f} max {save_ms['max']:.1f}; state digest {got['state_digest'][:16]}...; "
            f"launches {lc}")

        # 2. a worker killed mid-stream, then recovered here
        t0 = time.perf_counter()
        child = subprocess.run(
            [sys.executable, str(ROOT / "chip_smoke.py"), "--crash-worker", str(tmp / "crash"),
             "--crash-device", str(dev)],
            cwd=ROOT, capture_output=True, text=True, timeout=600,
        )
        require(child.returncode == CRASH_EXIT_CODE,
                f"crash worker exited {child.returncode}, expected {CRASH_EXIT_CODE}:\n"
                f"{child.stderr[-2000:]}")
        crash_s = time.perf_counter() - t0
        obs.reset()
        _zero_counts()
        t0 = time.perf_counter()
        rec = ResolveService.recover(str(tmp / "crash"), _durable_config(tmp / "crash"), device=dev)
        _sync(dev)
        recover_s = time.perf_counter() - t0
        reg = obs.get_registry()
        replayed, rec_ms = reg.value("recover.replayed"), reg.histogram("recover.wall_ms").summary()
        seq = rec._seq
        run = serve(rec, batches[seq:], ServingConfig(max_batch=1))
        rec.close()
        lc = _read_counts()
        _count_into(total, lc)
        summ = service_summary(rec)
        got = {k: summ[k] for k in ("matches", "clusters", "match_digest", "state_digest")}
        require(got == {k: want[k] for k in got}, f"serving recovered: got {got}")
        log(f"[serving] crash worker exited {child.returncode} after {crash_s:.1f} s (crash at "
            f"rounds hit {SERVING_CRASH_HIT}); recover on the card: {recover_s:.2f} s "
            f"(recover.wall_ms {rec_ms['max']:.1f}), recover.replayed {replayed}, resumed at "
            f"seq {seq}, then {len(batches) - seq} requests in {run['wall']:.2f} s; state digest "
            f"equals the uninterrupted run's; launches {lc}")

    # 3. coalescing at the default budgets, one request a paper, for throughput
    obs.reset()
    _zero_counts()
    papers = arrival_stream(ds, batch_size=1)
    svc = ResolveService(ServiceConfig(scheme="mmp", parallel=True), device=dev)
    run = serve(svc, papers, ServingConfig(), start_first=True)
    lc = _read_counts()
    _count_into(total, lc)
    size = obs.get_registry().histogram("serve.batch.coalesced_size").summary()
    require(svc.delta.n_entities == len(ds.entities) and len(svc.matches) > 0,
            "serving coalesced: not every paper ingested")
    log(f"[serving] coalescing, default ServingConfig (64 entities, 2 ms), {len(papers)} requests "
        f"(one a paper): wall {run['wall']:.2f} s, {run['requests_s']:.1f} requests/s, "
        f"{run['entities_s']:.1f} entities/s, {run['flushes']} flushes of {size['mean']:.1f} "
        f"entities on average, queue wait ms p50 {run['wait']['p50']:.1f} p99 "
        f"{run['wait']['p99']:.1f}; matches {len(svc.matches)}; launches {lc}")
    log(f"[serving] phase {time.perf_counter() - t_phase:.1f} s; launches {total}")
    return total


def _sync(dev) -> None:
    import torch

    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def lm_card_vs_cpu(dev, cfg, batch: int = 4, prompt_len: int = 32, steps: int = 4) -> dict:
    """One model on ``dev`` and on the CPU, from weights drawn on the CPU: a
    prefill and ``steps`` greedy decode steps, the device teacher-forced with
    the CPU's tokens.  Returns the relative logit error and the tokens compared."""
    import torch

    from repro_torch.models.param import init_params
    from repro_torch.models.registry import get_model

    api = get_model(cfg)
    cpu = torch.device("cpu")
    t0 = time.perf_counter()
    tree = init_params(api.param_specs(), seed=0, device=cpu)
    models = [(cpu, api.load(tree)), (dev, api.load(tree).to(dev))]
    del tree
    rng = np.random.default_rng(13)
    toks = rng.integers(1, cfg.vocab_size - 1, (batch, prompt_len)).astype(np.int32)
    s_max = prompt_len + steps
    runs = []  # per run: logits of each step, (B, V) f32 on the CPU
    for d, model in models:
        out, cache = api.prefill(model, torch.as_tensor(toks, device=d), s_max)
        seq = [out[:, -1].float().cpu()]
        for t in range(steps):
            fed = (runs[0] if runs else seq)[t].argmax(-1)  # the CPU's greedy token
            batch_in = {"tokens": fed.to(torch.int32)[:, None].to(d),
                        "pos": torch.full((batch,), prompt_len + t, dtype=torch.int32, device=d)}
            out, cache = api.decode(model, cache, batch_in)
            seq.append(out[:, 0].float().cpu())
        _sync(d)
        runs.append(seq)
    want, got = torch.stack(runs[0]), torch.stack(runs[1])  # (steps+1, B, V)
    require(bool(torch.isfinite(got).all()), "device logits are not finite")
    err = float((got - want).abs().max())
    rel = err / float(want.abs().max())
    top2 = want.topk(2, dim=-1).values
    decided = (top2[..., 0] - top2[..., 1]) > 2 * err
    same = got.argmax(-1) == want.argmax(-1)
    require(bool(same[decided].all()),
            f"greedy tokens differ where the CPU's margin is above {2 * err:.4g}")
    return dict(rel=rel, err=err, compared=int(decided.sum()), tokens=int(decided.numel()),
                seconds=time.perf_counter() - t0)


@contextlib.contextmanager
def engine_probe(dev):
    """Time every prefill and decode call of ``Engine`` (synchronized) and
    check that its logits are finite; restores the engine on exit."""
    import torch

    from repro_torch.serve.engine import Engine

    rec = {"prefill_ms": [], "decode_ms": [], "finite": True}
    originals = {"_prefill": Engine._prefill, "_decode": Engine._decode}

    def timed(fn, key):
        def call(self, *args):
            _sync(dev)
            t0 = time.perf_counter()
            logits, cache = fn(self, *args)
            _sync(dev)
            rec[key].append((time.perf_counter() - t0) * 1e3)
            rec["finite"] &= bool(torch.isfinite(logits).all())
            return logits, cache
        return call

    Engine._prefill = timed(originals["_prefill"], "prefill_ms")
    Engine._decode = timed(originals["_decode"], "decode_ms")
    try:
        yield rec
    finally:
        for name, fn in originals.items():
            setattr(Engine, name, fn)


def _device_busy(dev, run) -> str:
    """Device busy share of ``run()`` under torch.profiler (kernels and copies)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    if dev.type != "cuda":
        return "not measured (no device)"
    _sync(dev)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        _sync(dev)
        wall = time.perf_counter() - t0
    busy = sum(e.time_range.elapsed_us() for e in prof.events()
               if e.device_type == DeviceType.CUDA) / 1e6
    if busy == 0:
        return "not measured (the profiler saw no device activity)"
    return f"{busy:.3f} s of {wall:.3f} s ({100 * busy / wall:.1f}%)"


def lm_serve(dev, serve_argv: list[str], long_cfg, long_len: int, max_new: int) -> dict:
    """``launch.serve.main(serve_argv)``, then one ``long_len``-token prompt
    through an ``Engine`` of batch 1 over ``long_cfg`` with random weights."""
    import torch

    from repro_torch.launch import serve
    from repro_torch.models.registry import get_model
    from repro_torch.serve.engine import Engine, demo_engine

    out = {}
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    with engine_probe(dev) as rec:
        t0 = time.perf_counter()
        outs = serve.main(serve_argv)
        out["requests_s"] = time.perf_counter() - t0
    require(rec["finite"], "serving gave logits that are not finite")
    require(all(len(o) == max_new for o in outs), f"not every request got {max_new} tokens")
    out["requests"] = dict(rec, n=len(outs), tokens=sum(map(len, outs)))

    engine = demo_engine(get_model(long_cfg), batch=1, s_max=long_len + max_new, device=dev)
    if dev.type == "cuda":
        out["peak_init_bytes"] = torch.cuda.max_memory_allocated(dev)
        torch.cuda.reset_peak_memory_stats(dev)
    prompt = np.random.default_rng(1).integers(1, long_cfg.vocab_size - 1, long_len).astype(np.int32)
    with engine_probe(dev) as rec:
        t0 = time.perf_counter()
        long_out = engine.generate([prompt], max_new=max_new)
        out["long_s"] = time.perf_counter() - t0
    require(rec["finite"], "the long prompt gave logits that are not finite")
    require([len(o) for o in long_out] == [max_new], f"the long prompt did not get {max_new} tokens")
    out["long"] = dict(rec, n=1, tokens=max_new)
    if dev.type == "cuda":
        out["peak_long_bytes"] = torch.cuda.max_memory_allocated(dev)
    out["launches"] = _read_counts()
    out["wgmma_launches"] = _wrappers()["flash_attn"].wgmma_launches
    # the device's busy share of one more serving run of each kind (not counted above)
    requests = np.random.default_rng(0).integers(1, long_cfg.vocab_size - 1, (4, 32), np.int32)
    batch4 = Engine(engine.api, engine.params, 4, 32 + max_new, device=dev)
    out["busy_requests"] = _device_busy(dev, lambda: batch4.generate(list(requests), max_new))
    out["busy_long"] = _device_busy(dev, lambda: engine.generate([prompt], max_new=max_new))
    return out


def phase_lm(dev, arch: str = "yi_6b", cmp_layers: int = 2, long_len: int = 4096,
             max_new: int = 16) -> dict:
    """Yi-6B at full width on the card: against the CPU at ``cmp_layers``
    layers, then served at full depth.  Returns the launch counts of the
    serving part."""
    from repro_torch.configs.base import get_config

    t0 = time.perf_counter()
    cfg = get_config(arch)
    cmp = lm_card_vs_cpu(dev, dataclasses.replace(cfg, n_layers=cmp_layers))
    log(f"[lm] {cfg.name} at {cmp_layers} layers, card vs CPU: max |dlogit| {cmp['err']:.4g}, "
        f"relative {cmp['rel']:.3g} (limit 2e-2); greedy tokens compared where the CPU's "
        f"margin > {2 * cmp['err']:.4g}: {cmp['compared']} of {cmp['tokens']}, all equal "
        f"({cmp['seconds']:.1f} s)")
    require(cmp["rel"] <= 2e-2, f"card vs CPU logits differ by {cmp['rel']:.3g} > 2e-2")
    require(cmp["compared"] >= 1, "no greedy token was decided clearly enough to compare")

    _zero_counts()
    argv = ["--arch", arch, "--requests", "8", "--batch", "4", "--prompt-len", "32",
            "--max-new", str(max_new)]
    res = lm_serve(dev, argv, cfg, long_len, max_new)
    launches = res["launches"]
    want = cfg.n_layers * (2 + 1)  # one launch a layer for each of 3 prefills
    require(launches["flash_attn"] == want,
            f"flash_attn launched {launches['flash_attn']} times, expected {want}")
    wgmma = res["wgmma_launches"]
    require(wgmma == want, f"{wgmma} of {want} flash_attn launches took the tensor-core route")
    req, lng = res["requests"], res["long"]
    log(f"[lm] serve.main {' '.join(argv)}: {req['n']} requests, {req['tokens']} tokens in "
        f"{res['requests_s']:.2f} s (weights drawn on the card included); prefill (4 x 32) ms "
        + ", ".join(f"{t:.2f}" for t in req["prefill_ms"])
        + f"; decode ms a step (batch 4) median {np.median(req['decode_ms']):.2f}, "
        f"{4e3 / np.median(req['decode_ms']):.1f} tokens/s")
    log(f"[lm] long prompt: {long_len} tokens + {max_new} new in {res['long_s']:.2f} s; prefill "
        f"{lng['prefill_ms'][0]:.1f} ms ({long_len / lng['prefill_ms'][0] * 1e3:.0f} tokens/s); "
        f"decode ms a token median {np.median(lng['decode_ms']):.2f} "
        f"({1e3 / np.median(lng['decode_ms']):.1f} tokens/s)")
    log(f"[lm] peak memory: {res['peak_init_bytes'] / 2**30:.2f} GiB with the weights' f32 draw, "
        f"{res['peak_long_bytes'] / 2**30:.2f} GiB serving the long prompt "
        f"(torch.cuda.max_memory_allocated); device busy: requests {res['busy_requests']}, "
        f"long prompt {res['busy_long']}")
    log(f"[lm] launches in the serving part: {launches} (flash_attn on the tensor cores: "
        f"{wgmma}); phase {time.perf_counter() - t0:.1f} s")
    return launches


def phase_profile(dev, fixpoint, max_evals: int = 100) -> None:
    """Where the matcher's time goes: the first ``max_evals`` MMP evaluations
    (cover excluded) once more under torch.profiler, device activity only;
    device busy = summed kernel and copy time over the wall time."""
    from repro_torch.core.driver import run_mmp
    from repro_torch.core.mln import MLNMatcher, PAPER_LEARNED

    matcher = MLNMatcher(PAPER_LEARNED, device=dev)
    out = {}

    def run():
        out["res"] = run_mmp(fixpoint.packed, matcher, fixpoint.gg, max_evals=max_evals)

    prof = _profile_run(dev, run)
    res, wall, busy = out["res"], prof["wall"], prof["busy"]
    per_name: dict[str, list[float]] = {}
    for e in prof["events"]:
        name = e.name.removeprefix("void ").removeprefix("(anonymous namespace)::")
        per_name.setdefault(name, []).append(e.time_range.elapsed_us())
    if not per_name:
        log("[profile] device time not measured (the profiler saw no device activity)")
        return
    top = sorted(per_name.items(), key=lambda kv: -sum(kv[1]))[:6]
    log(
        f"[profile] mmp, first {res.neighborhood_evals} evals: wall {wall:.2f} s under the "
        f"profiler, device busy {busy:.3f} s ({100 * busy / wall:.1f}%), "
        f"{prof['ops']} device ops, {prof['d2h']} of them device-to-host copies; top: "
        + "; ".join(f"{n[:44]} {sum(v) / 1e3:.1f} ms x{len(v)}" for n, v in top)
    )


def main(argv: list[str] | None = None) -> int:
    import argparse

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--ptxas-verbose", action="store_true",
                    help="print each kernel's registers, spills and shared memory as it builds")
    ap.add_argument("--kernels-only", action="store_true",
                    help="stop after phase 2 (build and kernels); prints no result line")
    ap.add_argument("--only", type=lambda v: v.split(","), metavar="KERNEL[,KERNEL]",
                    help="with --kernels-only: phase 2 for these kernels alone")
    ap.add_argument("--crash-worker", metavar="DIR",
                    help="the serving phase's worker: serve into DIR and die at the armed "
                         "fault (exit 117); prints no result line")
    ap.add_argument("--crash-device", default="cuda:0", help="the crash worker's device")
    args = ap.parse_args(argv)
    if args.crash_worker:
        return crash_worker(args.crash_worker, args.crash_device)
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
    phase_build(args.ptxas_verbose)
    if args.only and not args.kernels_only:
        ap.error("--only needs --kernels-only")
    rows = phase_kernels(dev, args.only)
    if args.kernels_only:
        return 0
    launches, resolved, seq_icm = phase_pipeline(dev)
    rules_launches, rules_icm = phase_rules(dev, resolved)
    parallel_launches = phase_parallel(dev, resolved, seq_icm, rules_icm)
    stream_launches = phase_stream(dev, resolved)
    matchers_launches = phase_matchers(dev, resolved)
    serving_launches = phase_serving(dev)
    lm_launches = phase_lm(dev)
    phase_profile(dev, resolved["mmp"])

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
            name=name, route="cuda", source=meta["source"],
            **({"sources": meta["sources"]} if "sources" in meta else {}),
            replaces=meta["replaces"],
            launches=(launches[name] + rules_launches[name] + parallel_launches[name]
                      + stream_launches[name] + matchers_launches[name]
                      + serving_launches[name] + lm_launches[name]),
            launches_by_path={"pipeline": launches[name], "rules": rules_launches[name],
                              "parallel": parallel_launches[name],
                              "stream": stream_launches[name],
                              "matchers": matchers_launches[name],
                              "serving": serving_launches[name], "lm": lm_launches[name]},
            shape=main_shape["shape"],
            max_abs_err=max(r["max_abs_err"] for r in mine),
            ms=main_shape["ms"], call_ms=main_shape["call_ms"], plain_ms=main_shape["plain_ms"],
            bound_ms=main_shape["bound_ms"], bound_by=main_shape["bound_by"],
            **({"dense_bound_ms": main_shape["dense_bound_ms"]}
               if "dense_bound_ms" in main_shape else {}),
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
