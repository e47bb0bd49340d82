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
8. Dedup (``dedup``): ``repro_torch.data.dedup.dedup_documents`` on CUDA over
   ``make_documents(CorpusConfig(seed=1), 5000)`` with 8 crawl sources (smp,
   ``k_max=24``): the paper's pipeline over documents, its canopies on
   ``ngram_sim`` and its MLN steps on ``icm_sweep``, both of which must
   launch.  Clusters, documents removed and the digests of the keep mask and
   of the clusters must equal ``EXPECTED_DEDUP``.  Prints the wall.
9. Serving (``serving``): ``repro_torch.stream.ServingFrontend`` with
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
10. Shard (``shard``): sharded serving (``repro_torch.stream.shard``), its
   ranks this script again as subprocesses (``--shard-worker``) with
   ``REPRO_SHARD_COORD`` / ``_N`` / ``_ID`` set, on one ``torch.distributed``
   group each (a file store): several ranks on the one card, so the backend
   rule gives gloo (NCCL refuses two ranks on a GPU).  (a) 2 ranks, each a
   ``ShardCoordinator`` with ``ServiceConfig(parallel=True)`` over the 29
   batches, mmp then smp on one group: both ranks' matches, evals,
   clusters, O(dirty) counters, re-ground rows and digests must equal
   ``EXPECTED_STREAM_PARALLEL``, ``digests_agree()`` must hold, each rank
   must launch ``minhash`` 29 times and ``icm_sweep`` and ``ngram_sim``, and
   evaluate some but not all of the rows.  (b) 4 ranks run ``run_parallel``
   on ``make_lattice_cover(depth=6, width=4)``, smp and mmp: each digest
   equal to a one-rank run here.  (c) ``python -m repro_torch.launch.serve
   --em`` at its defaults as 2 ranks and as one: equal digests, exit 0.
   Each rank sets its counters to 0 before a run and reads them after.
   Prints, per rank and scheme, the wall, ingest p50/p99, the collectives
   (bitset reductions, row gathers, probe unions: calls and ms),
   ``icm_sweep`` launches and rows against the one-rank stream of phase
   ``parallel``, and the backend.
11. LM (``lm``): Yi-6B at full width.  First the card against the CPU: 2
   layers, weights drawn on the card with ``init_params`` and copied to the
   CPU, a prefill of 4 prompts of 32 tokens and 4 greedy decode steps on the
   card, the CPU teacher-forced with the card's tokens (``lm_card_vs_cpu``,
   which phase ``lm_families`` shares); the largest logit difference over
   the largest logit must
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
12. LM families (``lm_families``): the MoE (Llama-4 Scout, Moonlight), MLA
   (MiniCPM3), VLM (Qwen2-VL) and SSM (Falcon-Mamba) configurations at full
   width, weights from ``init_params`` seed 0 (``LM_FAMILIES``).  Each first
   on the card against the CPU from one draw at a cut depth: a prefill of 4
   prompts of 32 tokens and 4 greedy decode steps on the card, the CPU
   teacher-forced with the card's tokens, max |dlogit| / max |logit| <=
   2e-2 and greedy tokens equal where the CPU's margin is clear; for MoE
   the CPU also takes the card's routing (its own gates) and the logits
   are compared on every token; every routing call's own choices are
   recorded on both, and each (token, layer) set whose experts differ must
   have a CPU router-logit margin (k-th minus (k+1)-th) of at most twice
   that token's router-logit error.  Qwen2-VL also runs ``forward_train`` with 1,024
   vision patches at distinct M-RoPE streams (B=1, S=1,088, 1 layer) and
   Falcon-Mamba its chunked ``forward_train`` (S=256, 2 layers) against the
   CPU.  Then each is served through ``repro_torch.launch.serve.main``
   (``--layers``, the deepest whose draw stays under ``DRAW_BUDGET_GIB``,
   where the full depth does not): 4 requests of 32 tokens in
   a batch of 4, 8 new tokens each, and for MiniCPM3 one 4,096-token prompt
   through an ``Engine`` of batch 1.  Logits finite, every request its
   tokens, and ``flash_attn`` launched exactly layers x prefills times, all
   on the tensor-core route (MiniCPM3's q.k dim 96 and v dim 64 padded to
   128), and 0 times for Falcon-Mamba.  Prints prefill and decode ms,
   tokens/s, peak memory and the busy share of one more batch run.  Then the
   decode-only families (``LM_DECODE_ONLY``), which have no prefill in the
   reference: ``launch.serve`` must exit with "has no prefill path", and the
   phase drives the model API.  Jamba (hybrid) against the CPU at one period
   (8 of 32 layers): 4 prompts of 4 tokens fed as decode steps and 4 greedy
   steps, the CPU fed the card's tokens and replaying its routing, then
   ``forward_train`` at B=1, S=128, each within 2e-2 with the routing held
   as above; served at 16 of 32 layers (the deepest draw, cut in whole
   periods): 4 prompts of 32 tokens as decode steps from a zero cache, 8
   greedy tokens, one ``forward_train`` at B=1, S=2,048, ``flash_attn``
   launched once an attention sublayer (2).  Whisper against the CPU at 2 +
   2 layers: ``encode`` of 4 x 1,500 stub frames, ``decode_train`` of 4 x 32
   tokens and a request's decode-step logits, each within 2e-2; served at 24
   + 24 layers: ``encode``, ``build_cross_cache``, a 4-token prompt as decode
   steps and 8 greedy tokens, ``flash_attn`` launched 24 times, non-causal.
13. Train (``train``): ``flash_attn`` under autograd first: at Qwen1.5-0.5B's
   training shape, Yi-6B's heads, Whisper's cross attention and MiniCPM3's
   MLA (through ``layers.attend``'s padding), the kernel inside the autograd
   Function ``FlashAttention``, whose dq, dk and dv (its blocked backward)
   must be within 2e-3 of autograd of ``attention_plain`` (max |d| / max
   |ref|), with the forward kernel, the blocked backward and SDPA's forward
   and backward timed.  Then Qwen1.5-0.5B at full width and 2 layers on the
   card against the CPU from one seed-0 draw: loss and every gradient within
   2e-2, every attention projection's gradient nonzero.  Then
   Qwen1.5-0.5B at full width and depth (24 layers) through
   ``repro_torch.train.trainer.Trainer``: batch 8 x 2,048 in 2 microbatches,
   ``remat_group`` 4, ``OptConfig(lr=1e-3, warmup_steps=2)``, 8 steps with
   a checkpoint at step 4, then a restart from that checkpoint to step 8:
   the restarted losses within 1e-5 relative of the uninterrupted ones, the
   last loss below the first, and ``flash_attn`` launched 24 x 2 x 2 = 96
   times a step (forward and remat recompute).  The counters are set to 0
   before the Trainer runs and read after them.  Prints each step's loss,
   ms, tokens/s, peak memory and launches (the steps are timed without the
   profiler), then the device's busy share of one more step under
   ``torch.profiler``, and a microbatch's forward, backward and AdamW
   times.  Last
   ``python -m repro_torch.launch.train --arch qwen1_5_0_5b --steps 2
   --batch 8 --seq 2048 --microbatches 2`` as a subprocess, which must exit 0.
14. Train mesh (``train_mesh``): training over ranks, this script again as
   2 ranks (``--train-mesh-worker``) on one group sharing the card (gloo),
   with phase train's model and settings.  (a) ``Trainer`` on a
   ``("data",)`` ``DeviceMesh`` for 4 steps, a checkpoint at step 2: the
   losses within ``MESH_LOSS_TOL`` of phase train's (``MESH_STEP1_TOL`` at
   step 1), every rank's parameters, moments and step equal after every
   step, ``flash_attn`` 96 times a rank a step.  (b) Elastic restores:
   phase train's step-4 checkpoint on the 2 ranks (their state equal to the
   state phase train saved) and step 5; the ranks' step-2 checkpoint in
   this process on one card (equal to the state the ranks saved) and
   steps 3-4; the losses within the same limit.  (c) 3 steps of
   ``make_train_step(compress_pods=True)`` over a ``("pod",)`` mesh of the
   2 ranks: step 1's loss within 1e-6 of (a)'s, the replicas equal, the
   error feedback nonzero.  (d) ``compressed_psum`` of 2^20 seeded f32
   elements a rank, bit for bit against the formula in numpy.  (e)
   ``python -m repro_torch.launch.train --smoke`` as 2 ranks: exit 0,
   ``devices=2`` and the same losses on both.  Each rank sets its counters
   to 0 before a run and reads them after.  Prints each rank's step walls,
   collective ms and bytes a step, peak memory, and its busy share of one
   more step under ``torch.profiler``.
15. Train TP (``train_tp``): tensor parallelism, this script again as 2
   ranks (``--train-tp-worker``) sharing the card (gloo; the functional
   all-gathers DTensor issues are composed from gloo's c10d all-gather,
   ``launch/mesh.py`` ``compose_gloo_cuda_collectives``),
   with phase train's model
   and settings over a ``(data, model)`` mesh of (1, 2): 8 of 16 heads and
   75,968 of 151,936 vocabulary rows a rank, every parameter a DTensor
   laid out by the reference's specs.  (a) ``Trainer`` for 4 steps, a
   checkpoint at step 2 (whole leaves, the reference's layout): the losses
   within ``MESH_LOSS_TOL`` of phase train's (``MESH_STEP1_TOL`` at step
   1), the blocks that ranks share equal after every step, ``flash_attn``
   96 times a rank a step; step 4 runs under ``torch.profiler`` for the
   busy share.  (b) That checkpoint restored onto a (2, 1) data-parallel
   mesh of the same ranks and, in this process, onto one card: each state
   equal to the checkpoint's bit for bit, and step 3 within
   ``MESH_LOSS_TOL`` of the tensor-parallel one.  Prints each rank's step
   ms, peak memory and busy share, and for steps 1 and 2 (``TP_COUNTED``,
   run inside ``OpCounter``, each collective synchronized) the collective
   ms, calls and bytes by kind; steps 3 and 4 run uncounted.
16. Dry run (``dryrun``), in a process of its own on this machine's CPU,
   started before phase ``train`` and read after ``train_tp``:
   ``launch.dryrun.lower_cell`` for ``DRYRUN_CELLS`` and
   ``lower_em_cell`` on the (16, 16) and (2, 16, 16)
   meshes of a ``fake`` process group; each record's parameters, active
   parameters, tokens a step and model FLOPs equal to the port's own
   functions', and its roofline terms printed at the H100's datasheet
   constants (``launch.roofline``).
17. Profile: the first 100 MMP evaluations once more under
   ``torch.profiler``: the device's busy share and what takes its time.
18. The card's name and power limit, the kernel list as one JSON line, and
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
import os
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
# ``dedup_documents(make_documents(CorpusConfig(seed=1), 5000)[0],
# source_of=np.arange(5000) % 8)`` (smp, k_max=24) with the reference package
# under numpy 2.0, whose Zipf sampler the port's corpus keeps on any numpy:
# the documents' digest (``documents_digest``), clusters, documents removed,
# sha256 of ``np.packbits(keep_mask)``, and sha256 of the clusters ordered by
# their smallest member, each as the int64 array [*sorted(c), -1],
# concatenated (``cluster_digest``)
DEDUP_DOCUMENTS_DIGEST = "902ef0c5a5849dd84d64e462840861fdb535b3aea0491d59375c11368a9cc5a0"
EXPECTED_DEDUP = dict(
    docs=5000, clusters=418, removed=520,
    keep_digest="b4dfe5ce6b761ecab9ee357fadf853e0f6dafc5635b5855757757b6d9b3848fa",
    cluster_digest="03780aa9b1d9f4275bf61e07861dac4beffbbbf670b8402be50c88fca2e0c1f2",
)
# the lm encoder, card against CPU from the same weights: embeddings within
LM_EMBED_TOL = 2e-3
# the serving phase's durable service checkpoints every that many ingests,
# and its crash worker dies at this hit of the ``rounds`` fault site
SERVING_CKPT_EVERY = 8
SERVING_CRASH_HIT = 12
# the shard phase: ranks on the card for the 29-batch stream, and for the
# lattice; each rank's collectives time out after this many seconds
SHARD_RANKS = 2
SHARD_LATTICE_RANKS = 4
SHARD_TIMEOUT_S = 300
# the parallel phase's one-rank streams, which the shard phase's ranks
# are set beside: scheme -> wall, ingest p50/p99, evals, launches, icm rows
UNSHARDED_STREAM: dict = {}
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
    _wrappers()["icm_sweep"].rows = 0


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
              iters=50, dense=None, unpadded=None):
        """``dense``: (bytes, ops) of a kernel that reads every input whole,
        where ``n_bytes`` and ``ops`` count only what this input's data needs;
        ``unpadded``: (bytes, ops) of the work before its head dims were padded."""
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
        if unpadded is not None:
            row["unpadded_bound_ms"] = bound(*unpadded, peak)[0]
        lib = "n/a" if row["library_ms"] is None else f"{row['library_ms']:.4f}"
        log(
            f"[kernels] {name:9s} {shape:22s} ok  max_abs_err={row['max_abs_err']:.3g}"
            f"  kernel_ms={ms:.4f} (eager call {call_ms:.4f})  plain_ms={row['plain_ms']:.4f}"
            f"  library_ms={lib}  bound_ms={row['bound_ms']:.5f} ({row['bound_by']})"
            + (f"  dense_bound_ms={row['dense_bound_ms']:.5f}" if dense is not None else "")
            + (f"  unpadded_bound_ms={row['unpadded_bound_ms']:.5f}"
               if unpadded is not None else "")
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
    # then the canopy's second chunk, the probe's two ends, a ragged F, an F
    # that is not a multiple of 4 (the 4-byte copies), and the dedup phase's
    # seed probe over 5,000 signatures' last chunk (N = 904)
    for M, N, F in [(1, 1024, 128), (1024, 1842, 128), (64, 936, 128), (1, 818, 128),
                    (64, 65, 128), (68, 1697, 128), (3, 70, 100), (5, 37, 30),
                    (1, 904, 128)]:
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
    # 64; then every shape the lm_families phase sends: MiniCPM3's MLA long
    # prompt and its served requests, q.k dim 96 and v dim 64 zero-padded to
    # 128, Llama-4 Scout's GQA group of 5, Qwen2-VL's group of 7 at its vision
    # forward and its served requests, Moonlight's MHA requests; Jamba's
    # forward_train against the CPU (S=128) and served (S=2,048), Whisper's
    # non-causal encoder over 1,500 frames (1,500 is not a multiple of the
    # 64-key tile: the masked key tail and the TMA box past T), its cross
    # attention (S=32 over T=1,500) and its causal decoder); the train phase's
    # Qwen1.5-0.5B microbatch (B=4, S=2,048), its card-vs-CPU check (B=2,
    # S=256) and its autograd check at Yi-6B's heads (S=2,048, 32/4), then the
    # reference test's f32 shapes, a ragged S = T, and a causal S < T
    for B, S, T, H, hkv, hd, dtype, causal, mla in [
        (4, 32, 32, 32, 4, 128, torch.bfloat16, True, None),
        (1, 4096, 4096, 32, 4, 128, torch.bfloat16, True, None),
        (8, 32, 32, 4, 4, 8, torch.bfloat16, True, None),
        (1, 2048, 2048, 16, 16, 64, torch.bfloat16, True, None),
        (1, 4096, 4096, 40, 40, 128, torch.bfloat16, True, (96, 64)),
        (4, 32, 32, 40, 8, 128, torch.bfloat16, True, None),
        (1, 1088, 1088, 28, 4, 128, torch.bfloat16, True, None),
        (4, 32, 32, 16, 16, 128, torch.bfloat16, True, None),
        (4, 32, 32, 40, 40, 128, torch.bfloat16, True, (96, 64)),
        (4, 32, 32, 28, 4, 128, torch.bfloat16, True, None),
        (1, 128, 128, 32, 8, 128, torch.bfloat16, True, None),
        (1, 2048, 2048, 32, 8, 128, torch.bfloat16, True, None),
        (4, 1500, 1500, 16, 16, 64, torch.bfloat16, False, None),
        (4, 32, 1500, 16, 16, 64, torch.bfloat16, False, None),
        (4, 32, 32, 16, 16, 64, torch.bfloat16, True, None),
        (4, 2048, 2048, 16, 16, 64, torch.bfloat16, True, None),
        (4, 2048, 2048, 8, 8, 64, torch.bfloat16, True, None),  # train_tp: 8 of 16 heads a rank
        (2, 256, 256, 16, 16, 64, torch.bfloat16, True, None),
        (1, 2048, 2048, 32, 4, 128, torch.bfloat16, True, None),
        *[(2, S_, S_, H_, k_, d_, torch.float32, c, None)
          for S_, H_, k_, d_ in [(128, 4, 2, 32), (256, 2, 2, 64), (192, 4, 1, 32)]
          for c in (True, False)],
        (2, 100, 100, 4, 2, 16, torch.float32, True, None),
        (2, 40, 100, 4, 2, 8, torch.float32, True, None),
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
        unpadded = None
        if mla is not None:  # the columns past the true head dims are the padding's zeros
            hq, hv = mla
            q[..., hq:] = 0
            k[..., hq:] = 0
            v[..., hv:] = 0
            scale = 1.0 / np.sqrt(hq)
            # the unpadded work: q.k over hq, p.v over hv
            unpadded = (esize * (B * S * H * hq + B * T * hkv * (hq + hv)) + 4 * B * S * H * hv,
                        2 * B * H * pairs * (hq + hv))
        route = flash.route(dtype, hd)
        before = flash.attention.wgmma_launches
        check(
            "flash_attn",
            f"B={B},S={S},T={T},H={H},Hkv={hkv},hd={hd},{str(dtype)[6:]},"
            + ("causal" if causal else "full") + f",{route}"
            + ("" if mla is None else f",MLA {mla[0]}/{mla[1]} padded"),
            lambda: flash.attention(q, k, v, scale, causal=causal),
            lambda: flash.attention_plain(q, k, v, scale, causal=causal),
            lambda: torch.nn.functional.scaled_dot_product_attention(
                q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
                is_causal=causal, scale=scale, enable_gqa=True),
            dict(rtol=2e-3, atol=2e-3),
            esize * (B * S * H * hd + 2 * B * T * hkv * hd) + 4 * B * S * H * hd,
            4 * B * H * hd * pairs,
            PEAK_BF16_FLOPS if dtype == torch.bfloat16 else PEAK_F32_FLOPS,
            iters=10 if S * T > 1 << 20 else 50, unpadded=unpadded,
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
    icm_rows = _wrappers()["icm_sweep"].rows
    spans = obs.get_registry().snapshot()["spans"]
    ingest_s = np.array([r.wall_time_s for r in reports])
    return dict(
        service=svc, wall=wall, launches=launches, icm_rows=icm_rows,
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
        "(the sequential driver's share: phase 11, `[profile]`)")

    batches = stream_schedules(ds)[29]
    for scheme, want in EXPECTED_STREAM_PARALLEL.items():
        run = stream_run(dev, scheme, batches, parallel=True)
        got = {k: run[k] for k in want}
        require(got == want, f"parallel stream {scheme}: got {got}, expected {want}")
        UNSHARDED_STREAM[scheme] = {k: run[k] for k in ("wall", "p50", "p99", "evals",
                                                        "launches", "icm_rows")}
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


def documents_digest(docs, dup_of) -> str:
    """sha256 of each document's int32 tokens followed by b"|", then ``dup_of``."""
    return hashlib.sha256(b"".join(np.asarray(d, np.int32).tobytes() + b"|" for d in docs)
                          + np.asarray(dup_of, np.int64).tobytes()).hexdigest()


def cluster_digest(clusters) -> str:
    """sha256 of the clusters ordered by their smallest member, each as the
    int64 array [*sorted(c), -1], concatenated."""
    parts = [np.asarray([*sorted(int(x) for x in c), -1], dtype=np.int64).tobytes()
             for c in sorted(clusters, key=lambda c: int(np.min(c)))]
    return hashlib.sha256(b"".join(parts)).hexdigest()


def phase_dedup(dev) -> dict:
    """Corpus dedup through the MLN pipeline on the card (see the module
    docstring); returns its launch counts."""
    from repro_torch.data.corpus import CorpusConfig, make_documents, zipf
    from repro_torch.data.dedup import dedup_documents

    n = EXPECTED_DEDUP["docs"]
    docs, dup_of = make_documents(CorpusConfig(seed=1), n)
    require(documents_digest(docs, dup_of) == DEDUP_DOCUMENTS_DIGEST,
            "dedup: the generated documents differ from the reference's")
    log(f"[dedup] numpy {np.__version__}: Generator.zipf(1.2) from seed 1 draws "
        f"{np.random.default_rng(1).zipf(1.2, size=8).tolist()}, the corpus's numpy 2.0 "
        f"sampler {zipf(np.random.default_rng(1), 1.2, 8).tolist()}")
    _zero_counts()
    t0 = time.perf_counter()
    report = dedup_documents(docs, source_of=np.arange(n) % 8, device=dev)
    _sync(dev)
    wall = time.perf_counter() - t0
    lc = _read_counts()
    got = dict(docs=report.n_docs, clusters=report.n_clusters, removed=report.n_removed,
               keep_digest=hashlib.sha256(np.packbits(report.keep_mask).tobytes()).hexdigest(),
               cluster_digest=cluster_digest(report.clusters))
    require(got == EXPECTED_DEDUP, f"dedup: got {got}, expected {EXPECTED_DEDUP}")
    require(int(report.keep_mask.sum()) == n - report.n_removed, "dedup: keep mask and count differ")
    require(lc["icm_sweep"] > 0 and lc["ngram_sim"] > 0,
            f"dedup: icm_sweep or ngram_sim never launched: {lc}")
    log(f"[dedup] {n} documents (CorpusConfig(seed=1), 8 sources), smp, k_max=24: wall "
        f"{wall:.2f} s, {report.n_clusters} clusters, {report.n_removed} removed, keep mask and "
        f"clusters equal to the reference's digests; launches {lc}")
    return lc


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


def _rank_result(tag: str, **fields) -> None:
    """One result line of a shard-phase rank, read back by the parent."""
    print(f"SHARD_RESULT {tag} " + json.dumps(fields), flush=True)


def _mesh_stats(mesh) -> dict:
    """The mesh's collectives as kind -> [calls, ms]."""
    return {k: [n, round(s * 1e3, 3)] for k, (n, s) in mesh.stats.items()}


def shard_worker(job: str, device: str | None) -> int:
    """A rank of the shard phase, on the group that ``REPRO_SHARD_*`` names.

    ``stream``: a ``ShardCoordinator`` with ``ServiceConfig(parallel=True)``
    over the 29 batches, mmp then smp on the one group; ``lattice``:
    ``run_parallel`` on ``make_lattice_cover(depth=6, width=4)``, smp then
    mmp, over the rank mesh.  The launch counters and the mesh's
    collectives are set to 0 before each run and read after it; prints one
    ``SHARD_RESULT`` line a run.
    """
    import torch

    from repro_torch import obs
    from repro_torch.core.mln import PAPER_LEARNED
    from repro_torch.stream import ServiceConfig
    from repro_torch.stream.shard import ShardContext, ShardCoordinator

    ctx = ShardContext.create(device=device)
    mesh = ctx.mesh
    who = dict(rank=ctx.shard_id, ranks=ctx.n_shards, backend=mesh.backend,
               device=str(mesh.device))
    if job == "lattice":
        from repro_torch.core.global_grounding import build_global_grounding
        from repro_torch.core.mln import MLNMatcher
        from repro_torch.core.parallel import run_parallel
        from repro_torch.data.synthetic import make_lattice_cover
        from repro_torch.stream.digest import match_digest

        packed, relations, weights = make_lattice_cover(depth=6, width=4)
        for scheme in ("smp", "mmp"):
            gg = (build_global_grounding(packed.pair_levels, relations, weights)
                  if scheme == "mmp" else None)
            _zero_counts()
            mesh.reset_stats()
            res = run_parallel(packed, MLNMatcher(weights, device=mesh.device), gg,
                               scheme=scheme, mesh=mesh)
            _rank_result("lattice", scheme=scheme, digest=match_digest(res.matches),
                         evals=res.neighborhood_evals, rows_evaluated=mesh.rows_evaluated,
                         launches=_read_counts(), collectives=_mesh_stats(mesh), **who)
        return 0

    from repro_torch.data.synthetic import SynthConfig, make_dataset

    batches = stream_schedules(make_dataset(SynthConfig.hepth(scale=1.0, seed=7)))[29]
    for scheme in ("mmp", "smp"):
        coord = ShardCoordinator(ctx, config=ServiceConfig(scheme=scheme, weights=PAPER_LEARNED,
                                                           parallel=True))
        obs.reset()
        _zero_counts()
        mesh.reset_stats()
        t0 = time.perf_counter()
        reports = [coord.ingest(b.names, b.edges, ids=b.ids) for b in batches]
        if mesh.device.type == "cuda":
            torch.cuda.synchronize(mesh.device)
        wall = time.perf_counter() - t0
        launches = _read_counts()
        icm_rows = _wrappers()["icm_sweep"].rows
        stats = _mesh_stats(mesh)
        ingest_s = np.array([r.wall_time_s for r in reports])
        summary = service_summary(coord.service)
        _rank_result("stream", scheme=scheme, wall=wall,
                     p50=float(np.percentile(ingest_s, 50)),
                     p99=float(np.percentile(ingest_s, 99)), launches=launches,
                     icm_rows=icm_rows, rows_evaluated=mesh.rows_evaluated,
                     collectives=stats, agree=coord.digests_agree(), **summary, **who)
    return 0


def _spawn_ranks(n: int, argv: list[str], store: Path, timeout: float) -> list[str]:
    """``n`` ranks of ``python argv`` on one group (a file store at
    ``store``), started together; each rank's stdout.  A rank that fails
    fails the phase, and every rank still running is killed."""
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src"), "REPRO_SHARD_N": str(n),
           "REPRO_SHARD_COORD": store.as_uri(), "REPRO_SHARD_TIMEOUT_S": str(SHARD_TIMEOUT_S)}
    procs = [subprocess.Popen([sys.executable, *argv], cwd=ROOT, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True,
                              env={**env, "REPRO_SHARD_ID": str(i)}) for i in range(n)]
    outs = []
    try:
        for i, p in enumerate(procs):
            out, err = p.communicate(timeout=timeout)
            require(p.returncode == 0, f"shard rank {i}/{n} ({' '.join(argv)}) exited "
                    f"{p.returncode}:\n{err[-3000:]}")
            outs.append(out)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    return outs


def _rank_results(out: str, tag: str) -> list[dict]:
    return [json.loads(ln.split(" ", 2)[2]) for ln in out.splitlines()
            if ln.startswith(f"SHARD_RESULT {tag} ")]


def _em_digest(out: str) -> str:
    """The digest of ``launch.serve --em``'s summary line."""
    line = out.strip().splitlines()[-1]
    require("(replicas agree)" in line, f"serve --em: {line}")
    return line.split("digest ", 1)[1].split()[0]


def phase_shard(dev) -> dict:
    """Sharded serving, ranks on the card (see the module docstring);
    returns the launch counts summed over the ranks' runs."""
    import tempfile

    from repro_torch.core.global_grounding import build_global_grounding
    from repro_torch.core.mln import MLNMatcher
    from repro_torch.core.parallel import run_parallel
    from repro_torch.data.synthetic import make_lattice_cover
    from repro_torch.stream.digest import match_digest

    t_phase = time.perf_counter()
    total = dict.fromkeys(KERNELS, 0)
    dev_arg = [] if dev.type == "cuda" else ["--shard-device", str(dev)]
    with tempfile.TemporaryDirectory(prefix=".chip_smoke_", dir=ROOT) as tmp:
        tmp = Path(tmp)
        # (a) the 29-batch stream on SHARD_RANKS ranks sharing the card
        t0 = time.perf_counter()
        outs = _spawn_ranks(SHARD_RANKS, ["chip_smoke.py", "--shard-worker", "stream", *dev_arg],
                            tmp / "stream", 900)
        log(f"[shard] stream: {SHARD_RANKS} ranks, mmp then smp on one group, "
            f"{time.perf_counter() - t0:.1f} s from spawn to exit")
        for out in outs:
            runs = _rank_results(out, "stream")
            require([r["scheme"] for r in runs] == ["mmp", "smp"], f"shard stream: {runs}")
            for r in runs:
                want = EXPECTED_STREAM_PARALLEL[r["scheme"]]
                got = {k: r[k] for k in want}
                tag = f"shard stream {r['scheme']}, rank {r['rank']}/{r['ranks']}"
                require(got == want, f"{tag}: got {got}, expected {want}")
                require(r["agree"], f"{tag}: the replicas' digests differ")
                lc = r["launches"]
                require(lc["minhash"] == 29, f"{tag}: minhash launched {lc['minhash']} times")
                for name in ("icm_sweep", "ngram_sim"):
                    require(lc[name] > 0, f"{tag}: {name} was never launched")
                require(0 < r["rows_evaluated"] < r["evals"],
                        f"{tag}: evaluated {r['rows_evaluated']} of {r['evals']} rows")
                _count_into(total, lc)
                one = UNSHARDED_STREAM.get(r["scheme"])
                vs = (f" (one rank, phase parallel: wall {one['wall']:.2f} s, p50 "
                      f"{one['p50'] * 1e3:.1f} ms, p99 {one['p99'] * 1e3:.1f} ms, icm_sweep "
                      f"{one['launches']['icm_sweep']} launches over {one['icm_rows']} rows, "
                      f"{one['evals']} rows evaluated)") if one else ""
                log(f"[shard] {tag}, backend {r['backend']} on {r['device']}: wall "
                    f"{r['wall']:.2f} s, ingest p50 {r['p50'] * 1e3:.1f} ms p99 "
                    f"{r['p99'] * 1e3:.1f} ms; collectives (calls, ms): {r['collectives']}; "
                    f"icm_sweep {lc['icm_sweep']} launches over {r['icm_rows']} rows, "
                    f"{r['rows_evaluated']} of {r['evals']} rows evaluated here{vs}; "
                    f"launches {lc}; state digest {r['state_digest'][:16]}...")

        # (b) the lattice on SHARD_LATTICE_RANKS ranks against one rank here
        outs = _spawn_ranks(SHARD_LATTICE_RANKS,
                            ["chip_smoke.py", "--shard-worker", "lattice", *dev_arg],
                            tmp / "lattice", 600)
        packed, relations, weights = make_lattice_cover(depth=6, width=4)
        want = {}
        for scheme in ("smp", "mmp"):
            gg = (build_global_grounding(packed.pair_levels, relations, weights)
                  if scheme == "mmp" else None)
            res = run_parallel(packed, MLNMatcher(weights, device=dev), gg, scheme=scheme,
                               device=dev)
            want[scheme] = (match_digest(res.matches), res.neighborhood_evals)
        for out in outs:
            for r in _rank_results(out, "lattice"):
                tag = f"shard lattice {r['scheme']}, rank {r['rank']}/{r['ranks']}"
                require((r["digest"], r["evals"]) == want[r["scheme"]],
                        f"{tag}: {r['digest']}, {r['evals']} evals; one rank "
                        f"{want[r['scheme']]}")
                require(r["launches"]["icm_sweep"] > 0, f"{tag}: icm_sweep was never launched")
                _count_into(total, r["launches"])
                log(f"[shard] {tag}, backend {r['backend']}: digest equals one rank's; "
                    f"{r['rows_evaluated']} of {r['evals']} rows evaluated here; collectives "
                    f"(calls, ms) {r['collectives']}; launches {r['launches']}")

        # (c) launch.serve --em at its defaults, as SHARD_RANKS ranks and as one
        em = ["-m", "repro_torch.launch.serve", "--em", *(["--device", str(dev)]
                                                         if dev.type != "cuda" else [])]
        t0 = time.perf_counter()
        many = [_em_digest(o) for o in _spawn_ranks(SHARD_RANKS, em, tmp / "em", 600)]
        t_many = time.perf_counter() - t0
        t0 = time.perf_counter()
        alone = subprocess.run([sys.executable, *em], cwd=ROOT, capture_output=True, text=True,
                               timeout=600, env={**os.environ, "PYTHONPATH": str(ROOT / "src")})
        require(alone.returncode == 0, f"serve --em alone exited {alone.returncode}:\n"
                f"{alone.stderr[-3000:]}")
        one = _em_digest(alone.stdout)
        require(many == [one] * SHARD_RANKS, f"serve --em: ranks {many}, one rank {one}")
        log(f"[shard] serve --em: {SHARD_RANKS} ranks {t_many:.1f} s, one "
            f"{time.perf_counter() - t0:.1f} s (spawn to exit), digest {one} on every rank")
    log(f"[shard] phase {time.perf_counter() - t_phase:.1f} s; launches {total}")
    return total


def _sync(dev) -> None:
    import torch

    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


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
    log(f"[lm] peak memory: {res['peak_init_bytes'] / 2**30:.2f} GiB with the weights' draw, "
        f"{res['peak_long_bytes'] / 2**30:.2f} GiB serving the long prompt "
        f"(torch.cuda.max_memory_allocated); device busy: requests {res['busy_requests']}, "
        f"long prompt {res['busy_long']}")
    log(f"[lm] launches in the serving part: {launches} (flash_attn on the tensor cores: "
        f"{wgmma}); phase {time.perf_counter() - t0:.1f} s")
    return launches


# the lm_families phase: (arch, layers in the card-vs-CPU check, layers served);
# a served depth is cut only where the weights' draw (the tree at its declared
# dtypes plus its largest leaf in f32, ``_draw_gib``) would pass
# DRAW_BUDGET_GIB, and then to the deepest that stays under it (the rest of
# the card's 79.6 GiB holds the CUDA context, caches and activations)
DRAW_BUDGET_GIB = 74.0
LM_FAMILIES = [
    ("llama4_scout_17b_a16e", 1, 7),
    ("moonshot_v1_16b_a3b", 2, 29),
    ("minicpm3_4b", 2, 62),
    ("qwen2_vl_7b", 2, 28),
    ("falcon_mamba_7b", 2, 64),
]
LM_REL_TOL = 2e-2


def _tree_to(tree, device):
    if isinstance(tree, dict):
        return {k: _tree_to(v, device) for k, v in tree.items()}
    return tree.to(device)


def _free(dev) -> None:
    import gc

    import torch

    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()


def _models_on_both(dev, api):
    """The model on ``dev`` and on the CPU from one draw of its weights
    (``init_params`` seed 0 on ``dev``, copied to the CPU)."""
    import torch

    from repro_torch.models.param import init_params

    tree = init_params(api.param_specs(), seed=0, device=dev)
    card = api.load(tree)
    host = api.load(_tree_to(tree, torch.device("cpu")))
    del tree
    return card, host


@contextlib.contextmanager
def routing_probe(replay: list | None = None):
    """Record every MoE routing call (router logits, probabilities, experts,
    kept mask and queue positions, on the CPU).  With ``replay``, the calls
    of another run, each call routes as that run's did: its experts, kept
    choices and queue slots, gated by this run's own probabilities (the
    record still holds this run's own choices)."""
    import torch

    from repro_torch.models import moe

    calls = []
    original = moe.route

    def route(cfg, router, xt):
        probs, idx, gate, within = original(cfg, router, xt)
        logits = torch.matmul(xt.float(), router.float())
        calls.append(dict(logits=logits.cpu(), probs=probs.cpu(), idx=idx.cpu(),
                          kept=(gate > 0).cpu(), within=within.cpu()))
        if replay is not None:
            other = replay[len(calls) - 1]
            idx = other["idx"].to(xt.device)
            within = other["within"].to(xt.device)
            gate = probs.gather(-1, idx)
            if cfg.experts_per_token > 1:
                gate = gate / gate.sum(dim=-1, keepdim=True)
            gate = gate * other["kept"].to(xt.device)
        return probs, idx, gate, within

    moe.route = route
    try:
        yield calls
    finally:
        moe.route = original


def _routing_agreement(ref_calls, got_calls, cfg, n_calls: int) -> dict:
    """Compare the CPU's and the card's routing call by call.  A (token,
    layer) set agrees when its experts and its kept experts are equal.  The
    top-k of the softmax is the top-k of the router logits, so a set whose
    experts differ needs two logits to cross: its CPU logit margin (k-th
    minus (k+1)-th) must be at most twice that token's largest router-logit
    error, the bound.  Returns the sets, the agreeing ones, the differing
    ones, the sets within their bound (those that could differ), the largest
    margin / bound of a differing set, and the largest router-logit error."""
    K = cfg.experts_per_token
    require(len(ref_calls) == len(got_calls) == n_calls,
            f"{len(ref_calls)} and {len(got_calls)} routing calls, expected {n_calls}")
    res = dict(sets=0, agree=0, differ=0, near=0, worst_ratio=0.0, router_err=0.0)
    for i, (r, g) in enumerate(zip(ref_calls, got_calls)):
        err = (g["logits"] - r["logits"]).abs().amax(-1)  # each token's
        res["router_err"] = max(res["router_err"], float(err.max()))
        top = r["logits"].sort(-1, descending=True).values
        bound = 2 * err
        margin = top[..., K - 1] - top[..., K]
        same_experts = (r["idx"].sort(-1).values == g["idx"].sort(-1).values).all(-1)
        differ = ~same_experts
        bad = differ & (margin > bound)
        require(not bool(bad.any()),
                f"routing call {i}: {int(bad.sum())} (token, layer) sets differ with a CPU "
                f"logit margin above twice their router-logit error")
        if bool(differ.any()):
            res["worst_ratio"] = max(res["worst_ratio"],
                                     float((margin / bound)[differ].max()))
        kept_r = r["kept"].new_zeros(r["probs"].shape).scatter(-1, r["idx"], r["kept"])
        kept_g = g["kept"].new_zeros(g["probs"].shape).scatter(-1, g["idx"], g["kept"])
        res["agree"] += int((same_experts & (kept_r == kept_g).all(-1)).sum())
        res["differ"] += int(differ.sum())
        res["near"] += int((margin <= bound).sum())
        res["sets"] += same_experts.numel()
    return res


def lm_card_vs_cpu(dev, cfg, batch: int = 4, prompt_len: int = 32, steps: int = 4) -> dict:
    """One configuration on ``dev`` and on the CPU from the same weights: a
    prefill and ``steps`` greedy decode steps on the card, then the same on
    the CPU teacher-forced with the card's tokens.  For MoE the CPU run also
    takes the card's routing (experts, drops, slots; its own gates), so that
    one token routed the other way does not move every token it is mixed
    with; the CPU's own choices are recorded and compared set by set.
    Returns the relative logit error and counts."""
    import torch

    from repro_torch.models.registry import get_model

    api = get_model(cfg)
    cpu = torch.device("cpu")
    t0 = time.perf_counter()
    card, host = _models_on_both(dev, api)
    rng = np.random.default_rng(13)
    toks = rng.integers(1, cfg.vocab_size - 1, (batch, prompt_len)).astype(np.int32)
    s_max = prompt_len + steps
    runs, routes = [], []
    for d, model in [(dev, card), (cpu, host)]:
        with routing_probe(replay=routes[0] if routes else None) as calls:
            out, cache = api.prefill(model, torch.as_tensor(toks, device=d), s_max)
            seq = [out[:, -1].float().cpu()]
            for t in range(steps):
                fed = (runs[0] if runs else seq)[t].argmax(-1)  # the card's greedy token
                batch_in = {"tokens": fed.to(torch.int32)[:, None].to(d),
                            "pos": torch.full((batch,), prompt_len + t, dtype=torch.int32,
                                              device=d)}
                out, cache = api.decode(model, cache, batch_in)
                seq.append(out[:, 0].float().cpu())
            _sync(d)
        runs.append(seq)
        routes.append(calls)
    del card, host, cache
    res = _logit_agreement(torch.stack(runs[0]), torch.stack(runs[1]))  # (steps+1, B, V)
    if cfg.n_experts:
        res["routing"] = _routing_agreement(routes[1], routes[0], cfg,
                                            cfg.n_layers * (1 + steps))
    res["seconds"] = time.perf_counter() - t0
    return res


def _logit_agreement(got, want) -> dict:
    """Card logits ``got`` against CPU logits ``want`` (steps, B, V): the
    largest difference, relative to the largest CPU logit, and greedy tokens
    equal wherever the CPU's top-1/top-2 margin exceeds twice that difference."""
    import torch

    require(bool(torch.isfinite(got).all()), "device logits are not finite")
    err = float((got - want).abs().max())
    top2 = want.topk(2, dim=-1).values
    decided = (top2[..., 0] - top2[..., 1]) > 2 * err
    same = got.argmax(-1) == want.argmax(-1)
    require(bool(same[decided].all()),
            f"greedy tokens differ where the CPU's margin is above {2 * err:.4g}")
    return dict(err=err, rel=err / float(want.abs().max()), compared=int(decided.sum()),
                tokens=decided.numel())


def _logits_rel(want_h, got_h, api_mod, cfg, models, every: int) -> tuple[float, float]:
    """Relative max error of the hidden states, and of the logits at every
    ``every``-th position (each package's own LM head on its own hidden)."""
    import torch

    err_h = float((got_h.float().cpu() - want_h.float()).abs().max()) / float(
        want_h.float().abs().max())
    lw = api_mod.logits_of(cfg, models[0], want_h[:, ::every])
    lg = api_mod.logits_of(cfg, models[1], got_h[:, ::every]).cpu()
    require(bool(torch.isfinite(lg).all()), "device logits are not finite")
    return err_h, float((lg - lw).abs().max()) / float(lw.abs().max())


def vlm_forward_card_vs_cpu(dev, cfg, text: int = 32) -> dict:
    """``forward_train`` with ``cfg.vision_patches`` patches (a square grid
    of one frame) between two runs of ``text`` tokens, M-RoPE streams as
    Qwen2-VL lays them out: text (i, i, i); patches (t0, t0 + row, t0 + col);
    the text after resumes at the largest position + 1."""
    import torch

    from repro_torch.models import transformer
    from repro_torch.models.registry import get_model

    api = get_model(cfg)
    t0 = time.perf_counter()
    card, host = _models_on_both(dev, api)
    P = cfg.vision_patches
    side = int(round(P ** 0.5))
    require(side * side == P, f"{P} patches do not form a square grid")
    S = text + P + text
    rng = np.random.default_rng(17)
    toks = rng.integers(1, cfg.vocab_size - 1, (1, S)).astype(np.int32)
    grid = np.arange(P)
    pos3 = np.zeros((3, 1, S), np.int32)
    pos3[:, 0, :text] = np.arange(text)
    pos3[0, 0, text:text + P] = text
    pos3[1, 0, text:text + P] = text + grid // side
    pos3[2, 0, text:text + P] = text + grid % side
    nxt = pos3[:, 0, :text + P].max() + 1
    pos3[:, 0, text + P:] = nxt + np.arange(text)
    extra = dict(vision_embeds=rng.normal(0, 0.3, (1, P, cfg.vision_dim)).astype(np.float32),
                 vision_pos=(text + grid)[None].astype(np.int32))
    hidden = []
    for d, model in [(torch.device("cpu"), host), (dev, card)]:
        h, _ = transformer.forward_train(
            cfg, model, torch.as_tensor(toks, device=d), torch.as_tensor(pos3, device=d),
            {k: torch.as_tensor(v, device=d) for k, v in extra.items()})
        hidden.append(h)
    rel_h, rel = _logits_rel(hidden[0], hidden[1], transformer, cfg, (host, card), every=17)
    return dict(S=S, rel_h=rel_h, rel=rel, seconds=time.perf_counter() - t0)


def ssm_forward_card_vs_cpu(dev, cfg, S: int = 256) -> dict:
    """The SSM's chunked ``forward_train`` (chunks of 128) on the card and the CPU."""
    import torch

    from repro_torch.models import ssm_lm
    from repro_torch.models.registry import get_model

    api = get_model(cfg)
    t0 = time.perf_counter()
    card, host = _models_on_both(dev, api)
    toks = np.random.default_rng(19).integers(1, cfg.vocab_size - 1, (1, S)).astype(np.int32)
    hidden = [ssm_lm.forward_train(cfg, m, torch.as_tensor(toks, device=d))
              for d, m in [(torch.device("cpu"), host), (dev, card)]]
    rel_h, rel = _logits_rel(hidden[0], hidden[1], ssm_lm, cfg, (host, card), every=16)
    return dict(S=S, rel_h=rel_h, rel=rel, seconds=time.perf_counter() - t0)


def _draw_gib(cfg, layers: int) -> float:
    """GiB of the weights' draw at ``layers`` layers, by the spec tree:
    ``init_params`` casts each leaf to its declared dtype as it is drawn, so
    the peak is the tree at its declared dtypes plus the largest leaf in f32."""
    from repro_torch.models.param import leaves
    from repro_torch.models.registry import get_model

    specs = leaves(get_model(dataclasses.replace(cfg, n_layers=layers)).param_specs())
    return (sum(ps.size * ps.dtype.itemsize for ps in specs)
            + 4 * max(ps.size for ps in specs)) / 2**30


def _depth_step(cfg) -> int:
    """The unit a served depth is cut in: a period for the hybrid (its
    parameter tree stacks whole periods), else a layer."""
    return (cfg.period or cfg.attn_layer_period) if cfg.family == "hybrid" else 1


def _deepest_draw(arch: str, layers: int) -> tuple[float, float | None]:
    """The draw at ``layers`` and at one more step of depth (None at full
    depth); fails unless ``layers`` is the deepest under ``DRAW_BUDGET_GIB``."""
    from repro_torch.configs.base import get_config

    full = get_config(arch)
    more = layers + _depth_step(full)
    draw = _draw_gib(full, layers)
    deeper = _draw_gib(full, more) if more <= full.n_layers else None
    require(draw <= DRAW_BUDGET_GIB and (deeper is None or deeper > DRAW_BUDGET_GIB),
            f"{arch}: {layers} layers is not the deepest draw under {DRAW_BUDGET_GIB} GiB "
            f"({draw:.2f} GiB; one more step of depth {deeper} GiB)")
    return draw, deeper


def family_serve(dev, arch: str, layers: int, max_new: int = 8, long_len: int = 0) -> dict:
    """``launch.serve.main`` for ``arch`` at ``layers`` layers: 4 requests of
    32 tokens in a batch of 4, ``max_new`` tokens each; then, with
    ``long_len``, one prompt of that length through an ``Engine`` of batch 1
    over the same weights, drawn again as ``serve.main`` draws them.  The
    counters are set to 0 before and read after; the busy share comes from
    one more run of the batch (not counted)."""
    import torch

    from repro_torch.configs.base import get_config
    from repro_torch.launch import serve
    from repro_torch.models.registry import get_model
    from repro_torch.serve.engine import Engine, demo_engine

    out = {}
    argv = ["--arch", arch, "--layers", str(layers), "--requests", "4", "--batch", "4",
            "--prompt-len", "32", "--max-new", str(max_new), "--s-max", str(32 + max_new),
            "--device", str(dev)]
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    _zero_counts()
    with engine_probe(dev) as rec:
        t0 = time.perf_counter()
        outs = serve.main(argv)
        out["requests_s"] = time.perf_counter() - t0
    require(rec["finite"], f"{arch}: serving gave logits that are not finite")
    require([len(o) for o in outs] == [max_new] * 4,
            f"{arch}: not every request got {max_new} tokens")
    out["requests"] = rec
    _free(dev)
    cfg = dataclasses.replace(get_config(arch), n_layers=layers)
    engine = demo_engine(get_model(cfg), batch=4, s_max=32 + max_new, device=dev)
    if long_len:
        long_engine = Engine(engine.api, engine.params, 1, long_len + max_new, device=dev)
        prompt = np.random.default_rng(1).integers(
            1, engine.api.cfg.vocab_size - 1, long_len).astype(np.int32)
        with engine_probe(dev) as lrec:
            long_out = long_engine.generate([prompt], max_new=max_new)
        del long_engine
        require(lrec["finite"] and [len(o) for o in long_out] == [max_new],
                f"{arch}: the long prompt failed")
        out["long"] = lrec
    out["launches"] = _read_counts()
    out["wgmma_launches"] = _wrappers()["flash_attn"].wgmma_launches
    if dev.type == "cuda":
        out["peak_bytes"] = torch.cuda.max_memory_allocated(dev)
    requests = np.random.default_rng(0).integers(1, engine.api.cfg.vocab_size - 1, (4, 32),
                                                 np.int32)
    out["busy"] = _device_busy(dev, lambda: engine.generate(list(requests), max_new))
    del engine
    return out


# the decode-only families: the reference gives them no prefill, so
# launch.serve refuses them and the phase drives the model API: (arch, layers
# in the card-vs-CPU check, layers served); the hybrid's depth is cut in whole
# periods of 8
LM_DECODE_ONLY = [
    ("jamba_v0_1_52b", 8, 16),
    ("whisper_medium", 2, 24),
]


def _zero_cache(api, batch: int, s_max: int, device) -> dict:
    import torch

    from repro_torch.models.param import spec_tree_map

    return spec_tree_map(lambda ps: torch.zeros(ps.shape, dtype=ps.dtype, device=device),
                         api.cache_specs(batch, s_max))


def decode_steps(dev, api, params, cache, prompt: np.ndarray, max_new: int, fed=None) -> dict:
    """A prompt (B, P) fed as decode steps into ``cache`` (as the SSM's prefill
    does), then greedy decode: ``max_new`` tokens, the first from the last
    prompt step, each fed back as the next step (``fed``: feed another run's
    tokens instead).  Returns every step's logits (B, V) f32 on the CPU, the
    tokens and each step's ms (synchronized)."""
    import torch

    B, P = prompt.shape
    toks = torch.as_tensor(prompt, device=dev)
    out = dict(logits=[], tokens=[], ms=[])
    for t in range(P + max_new - 1):
        if t < P:
            tok = toks[:, t:t + 1]
        else:
            tok = (fed[t - P] if fed is not None else out["tokens"][-1]).to(dev)[:, None]
        batch = {"tokens": tok.to(torch.int32),
                 "pos": torch.full((B,), t, dtype=torch.int32, device=dev)}
        _sync(dev)
        t0 = time.perf_counter()
        logits, cache = api.decode(params, cache, batch)
        _sync(dev)
        out["ms"].append((time.perf_counter() - t0) * 1e3)
        out["logits"].append(logits[:, 0].float().cpu())
        if t >= P - 1:
            out["tokens"].append(out["logits"][-1].argmax(-1).to(torch.int32))
    return out


def _moe_sublayers(cfg) -> int:
    from repro_torch.models import hybrid

    return sum(hybrid._is_moe(cfg, i) for i in range(cfg.n_layers))


@contextlib.contextmanager
def sublayer_check(card, host):
    """While the hybrid runs on the card, run each sublayer call once more
    on the CPU, on the card's own input (caches copied before the card
    updates them) and the CPU copy of the weights, so that no earlier
    sublayer's rounding reaches the CPU's result: the embedding, every
    RMSNorm, mixer (attention or SSM, full or decode), FFN (MLP or MoE, the
    CPU replaying the card's routing) and the LM head.  Records the largest
    difference relative to the largest CPU value for each kind of call, the
    head's outputs on both, and each MoE call's own routing on both."""
    import torch

    from repro_torch.models import hybrid, ssm

    on_host = {id(t): h for (_, t), (_, h) in zip(card.named_parameters(),
                                                  host.named_parameters())}
    on_host.update({id(m): h for (_, m), (_, h) in zip(card.named_modules(),
                                                       host.named_modules())})

    def to_host(x):
        if id(x) in on_host:
            return on_host[id(x)]
        if isinstance(x, torch.Tensor):
            return x.detach().cpu().clone()
        if isinstance(x, dict):
            return {k: to_host(v) for k, v in x.items()}
        if isinstance(x, tuple):
            return tuple(to_host(v) for v in x)
        return x

    rec = dict(rel={}, head=[], host_routes=[], card_routes=[])

    def checked(name, fn):
        def call(*args):
            host_args = to_host(args)
            with routing_probe() as card_calls:
                out = fn(*args)
            with routing_probe(replay=card_calls or None) as host_calls:
                want = fn(*host_args)
            rec["card_routes"].extend(card_calls)
            rec["host_routes"].extend(host_calls)
            got = (out[0] if isinstance(out, tuple) else out).float().cpu()
            want = (want[0] if isinstance(want, tuple) else want).float()
            rel = float((got - want).abs().max()) / max(float(want.abs().max()), 1e-30)
            rec["rel"][name] = max(rec["rel"].get(name, 0.0), rel)
            if name == "logits_of":
                rec["head"].append((got, want))
            return out
        return call

    patched = [(hybrid, "embed_lookup"), (hybrid, "rmsnorm"), (hybrid, "attention_train"),
               (hybrid, "attention_decode"), (ssm, "ssm_forward"), (ssm, "ssm_decode"),
               (hybrid, "_ffn"), (hybrid, "logits_of")]
    originals = [(mod, name, getattr(mod, name)) for mod, name in patched]
    for mod, name, fn in originals:
        setattr(mod, name, checked(name, fn))
    try:
        yield rec
    finally:
        for mod, name, fn in originals:
            setattr(mod, name, fn)


@contextlib.contextmanager
def _recorded(mod, name: str):
    """Record the output of every call of ``mod.name`` (f32, on the CPU)."""
    outs = []
    fn = getattr(mod, name)

    def call(*args):
        out = fn(*args)
        outs.append(out.float().cpu())
        return out

    setattr(mod, name, call)
    try:
        yield outs
    finally:
        setattr(mod, name, fn)


def hybrid_card_vs_cpu(dev, cfg, batch: int = 4, prompt_len: int = 4, new: int = 4,
                       train_len: int = 128) -> dict:
    """The hybrid on the card and on the CPU from one draw: a prompt fed as
    decode steps from a zero cache, then greedy steps, and ``forward_train``
    at B=1, S=``train_len``.  Held to the limit: every sublayer and the LM
    head on the card's own input (:func:`sublayer_check`), with the MoE
    routing compared set by set.  Measured beside it: the CPU running free,
    fed the card's tokens and replaying its routing (as ``lm_card_vs_cpu``),
    where bf16 rounding carries through all the layers."""
    import torch

    from repro_torch.models import hybrid
    from repro_torch.models.registry import get_model

    api = get_model(cfg)
    cpu = torch.device("cpu")
    t0 = time.perf_counter()
    card, host = _models_on_both(dev, api)
    rng = np.random.default_rng(23)
    prompt = rng.integers(1, cfg.vocab_size - 1, (batch, prompt_len)).astype(np.int32)
    toks = rng.integers(1, cfg.vocab_size - 1, (1, train_len)).astype(np.int32)
    steps = prompt_len + new - 1
    with sublayer_check(card, host) as rec:
        decode_steps(dev, api, card, _zero_cache(api, batch, prompt_len + new, dev), prompt, new)
        hidden = hybrid.forward_train(cfg, card, torch.as_tensor(toks, device=dev))[0][:, ::8]
        hybrid.logits_of(cfg, card, hidden)
    head = rec["head"]
    res = _logit_agreement(torch.stack([g for g, _ in head[:steps]]),
                           torch.stack([w for _, w in head[:steps]]))
    res["train_rel"] = float((head[-1][0] - head[-1][1]).abs().max()) / float(
        head[-1][1].abs().max())
    res["sublayer_rel"] = rec["rel"]
    res["routing"] = _routing_agreement(rec["host_routes"], rec["card_routes"], cfg,
                                        _moe_sublayers(cfg) * (steps + 1))

    runs, routes = [], []
    for d, model in [(dev, card), (cpu, host)]:
        with routing_probe(replay=routes[0] if routes else None) as calls:
            cache = _zero_cache(api, batch, prompt_len + new, d)
            runs.append(decode_steps(d, api, model, cache, prompt, new,
                                     fed=runs[0]["tokens"] if runs else None))
        routes.append(calls)
    free = _logit_agreement(torch.stack(runs[0]["logits"]), torch.stack(runs[1]["logits"]))
    free["routing"] = _routing_agreement(routes[1], routes[0], cfg, _moe_sublayers(cfg) * steps)
    hidden, routes, norms = [], [], []
    for d, model in [(dev, card), (cpu, host)]:
        with routing_probe(replay=routes[0] if routes else None) as calls, \
                _recorded(hybrid, "rmsnorm") as outs:
            hidden.append(hybrid.forward_train(cfg, model, torch.as_tensor(toks, device=d))[0])
        routes.append(calls)
        norms.append(outs)
    free["train_rel_h"], free["train_rel"] = _logits_rel(hidden[1], hidden[0], hybrid, cfg,
                                                         (host, card), every=8)
    # each sublayer's normed input (ln1, ln2, ..., ln_f), card against CPU
    free["growth"] = [float((g - w).abs().max()) / float(w.abs().max())
                      for g, w in zip(*norms)]
    free["train_routing"] = _routing_agreement(routes[1], routes[0], cfg, _moe_sublayers(cfg))
    res["free"] = free
    res["seconds"] = time.perf_counter() - t0
    return res


def _stub_frames(cfg, batch: int, seed: int) -> np.ndarray:
    """Stub audio frame embeddings (B, encoder_frames, d_model), drawn as the
    registry's ``demo_batch`` draws them."""
    return np.random.default_rng(seed).normal(
        0, 0.3, (batch, cfg.encoder_frames, cfg.d_model)).astype(np.float32)


def _encdec_request(dev, api, params, frames: np.ndarray, prompt: np.ndarray, max_new: int,
                    fed=None) -> dict:
    """One batch of requests: ``encode`` the frames, ``build_cross_cache``
    into a zero cache, then the prompt as decode steps and greedy decode."""
    import torch

    from repro_torch.models import encdec

    cfg = api.cfg
    frames = torch.as_tensor(frames, device=dev)
    _sync(dev)
    t0 = time.perf_counter()
    memory = encdec.encode(cfg, params, frames)
    _sync(dev)
    t1 = time.perf_counter()
    cache = _zero_cache(api, prompt.shape[0], prompt.shape[1] + max_new, dev)
    for name, t in encdec.build_cross_cache(cfg, params, memory).items():
        cache["layers"]["cross"][name].copy_(t)
    _sync(dev)
    t2 = time.perf_counter()
    out = decode_steps(dev, api, params, cache, prompt, max_new, fed=fed)
    out.update(memory=memory, encode_ms=(t1 - t0) * 1e3, cross_ms=(t2 - t1) * 1e3)
    return out


def encdec_card_vs_cpu(dev, cfg, batch: int = 4, text: int = 32, prompt_len: int = 4,
                       new: int = 4) -> dict:
    """The encoder-decoder on the card and on the CPU from one draw:
    ``encode`` of stub frames, ``decode_train`` over each run's own memory,
    and a request's decode steps (cross cache, prompt, greedy; the CPU fed the
    card's tokens)."""
    import torch

    from repro_torch.models import encdec
    from repro_torch.models.registry import get_model

    api = get_model(cfg)
    t0 = time.perf_counter()
    card, host = _models_on_both(dev, api)
    frames = _stub_frames(cfg, batch, 29)
    rng = np.random.default_rng(31)
    toks = rng.integers(1, cfg.vocab_size - 1, (batch, text)).astype(np.int32)
    prompt = rng.integers(1, cfg.vocab_size - 1, (batch, prompt_len)).astype(np.int32)
    runs, hidden = [], []
    for d, model in [(dev, card), (torch.device("cpu"), host)]:
        runs.append(_encdec_request(d, api, model, frames, prompt, new,
                                    fed=runs[0]["tokens"] if runs else None))
        hidden.append(encdec.decode_train(cfg, model, torch.as_tensor(toks, device=d),
                                          runs[-1]["memory"]))
    res = _logit_agreement(torch.stack(runs[0]["logits"]), torch.stack(runs[1]["logits"]))
    mem_card, mem_cpu = runs[0]["memory"].float().cpu(), runs[1]["memory"].float()
    res["encode_rel"] = float((mem_card - mem_cpu).abs().max()) / float(mem_cpu.abs().max())
    res["train_rel_h"], res["train_rel"] = _logits_rel(hidden[1], hidden[0], encdec, cfg,
                                                       (host, card), every=4)
    res["seconds"] = time.perf_counter() - t0
    return res


def decode_only_serve(dev, arch: str, layers: int, max_new: int = 8, batch: int = 4,
                      prompt_len: int = 32, train_len: int = 2048) -> dict:
    """Serve a decode-only family at ``layers`` layers with random weights
    drawn on the card: ``batch`` requests a batch; the hybrid's prompts of
    ``prompt_len`` tokens fed as decode steps from a zero cache, then one
    ``forward_train`` at B=1, S=``train_len``; the encoder-decoder's stub
    frames encoded, the cross cache built, a 4-token prompt fed as decode
    steps.  Then ``max_new`` greedy tokens.  The counters are set to 0 before
    and read after; the busy share comes from one more request (not
    counted)."""
    import torch

    from repro_torch.configs.base import get_config
    from repro_torch.models import hybrid
    from repro_torch.models.param import init_params
    from repro_torch.models.registry import get_model

    cfg = dataclasses.replace(get_config(arch), n_layers=layers)
    api = get_model(cfg)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    _zero_counts()
    t0 = time.perf_counter()
    params = api.load(init_params(api.param_specs(), seed=0, device=dev))
    _sync(dev)
    out = dict(draw_s=time.perf_counter() - t0)
    rng = np.random.default_rng(0)
    if cfg.family == "encdec":
        frames = _stub_frames(cfg, batch, 0)
        prompt = rng.integers(1, cfg.vocab_size - 1, (batch, 4)).astype(np.int32)

        def request():
            return _encdec_request(dev, api, params, frames, prompt, max_new)
    else:
        prompt = rng.integers(1, cfg.vocab_size - 1, (batch, prompt_len)).astype(np.int32)

        def request():
            cache = _zero_cache(api, batch, prompt_len + max_new, dev)
            return decode_steps(dev, api, params, cache, prompt, max_new)
    run = request()
    P = prompt.shape[1]
    require(all(bool(torch.isfinite(lg).all()) for lg in run["logits"]),
            f"{arch}: logits not finite")
    require(len(run["tokens"]) == max_new, f"{arch}: not every request got {max_new} tokens")
    out.update(prompt_ms=sum(run["ms"][:P]), decode_ms=float(np.median(run["ms"][P:])))
    if cfg.family == "encdec":
        out.update(encode_ms=run["encode_ms"], cross_ms=run["cross_ms"])
    else:
        toks = torch.as_tensor(
            rng.integers(1, cfg.vocab_size - 1, (1, train_len)).astype(np.int32), device=dev)
        _sync(dev)
        t1 = time.perf_counter()
        hidden, _ = hybrid.forward_train(cfg, params, toks)
        logits = hybrid.logits_of(cfg, params, hidden[:, -1:])
        _sync(dev)
        out["train_ms"] = (time.perf_counter() - t1) * 1e3
        require(bool(torch.isfinite(logits).all()), f"{arch}: forward_train not finite")
    out["launches"] = _read_counts()
    out["wgmma_launches"] = _wrappers()["flash_attn"].wgmma_launches
    if dev.type == "cuda":
        out["peak_bytes"] = torch.cuda.max_memory_allocated(dev)
    out["busy"] = _device_busy(dev, request)
    del params
    return out


def decode_only_family(dev, arch: str, cmp_layers: int, serve_layers: int,
                       max_new: int) -> dict:
    """One decode-only configuration: ``launch.serve`` refuses it, as the
    reference's does; the card against the CPU at ``cmp_layers``; served at
    ``serve_layers`` (the deepest draw under the budget).  Returns the
    serving part's launch counts."""
    from repro_torch.configs.base import get_config
    from repro_torch.launch import serve

    full = get_config(arch)
    try:
        serve.main(["--arch", arch, "--device", str(dev)])
    except SystemExit as e:
        require("has no prefill path" in str(e), f"{arch}: launch.serve exited with {e}")
    else:
        raise RuntimeError(f"{arch}: launch.serve served a family with no prefill")
    draw, deeper = _deepest_draw(arch, serve_layers)
    _free(dev)
    hybrid = full.family == "hybrid"
    if hybrid:
        cmp = hybrid_card_vs_cpu(dev, dataclasses.replace(full, n_layers=cmp_layers))
        cmp_depth = f"{cmp_layers} of {full.n_layers} layers"
    else:
        cmp = encdec_card_vs_cpu(dev, dataclasses.replace(full, n_layers=cmp_layers,
                                                          encoder_layers=cmp_layers))
        cmp_depth = f"{cmp_layers} + {cmp_layers} of {full.encoder_layers} + {full.n_layers} layers"
    if hybrid:
        rt, free = cmp["routing"], cmp["free"]
        detail = ("; every sublayer on the card's own input, largest relative difference: "
                  + ", ".join(f"{k} {v:.3g}" for k, v in sorted(cmp["sublayer_rel"].items()))
                  + f"; forward_train B=1, S=128 logits {cmp['train_rel']:.3g}; routing sets "
                  f"equal {rt['agree']} of {rt['sets']}, experts differ in {rt['differ']} "
                  f"(largest margin / bound {rt['worst_ratio']:.3g}, {rt['near']} sets within "
                  f"their bound). Running free (not held to the limit: bf16 rounding carried "
                  f"through {cmp_layers} layers): decode-step logits relative {free['rel']:.3g}, "
                  f"forward_train hidden {free['train_rel_h']:.3g}, logits "
                  f"{free['train_rel']:.3g}, each sublayer's normed input relative "
                  + " ".join(f"{g:.2g}" for g in free["growth"]) + "; routing experts differ in "
                  f"{free['routing']['differ'] + free['train_routing']['differ']} sets, each "
                  f"within its bound")
        rels = [cmp["rel"], cmp["train_rel"], *cmp["sublayer_rel"].values()]
    else:
        detail = (f"; encode (4 x 1,500 frames) relative {cmp['encode_rel']:.3g}; decode_train "
                  f"(4 x 32 tokens): hidden relative {cmp['train_rel_h']:.3g}, logits "
                  f"{cmp['train_rel']:.3g}")
        rels = [cmp["rel"], cmp["train_rel_h"], cmp["train_rel"], cmp["encode_rel"]]
    log(f"[lm_families] {full.name} at {cmp_depth}, card vs CPU: decode-step logits max |dlogit| "
        f"{cmp['err']:.4g}, relative {cmp['rel']:.3g} (limit {LM_REL_TOL}){detail}; greedy "
        f"tokens compared {cmp['compared']} of {cmp['tokens']}, all equal ({cmp['seconds']:.1f} s)")
    require(max(rels) <= LM_REL_TOL, f"{arch}: card vs CPU beyond {LM_REL_TOL}: {rels}")
    require(cmp["compared"] >= 1, f"{arch}: no greedy token was clear enough to compare")
    _free(dev)

    res = decode_only_serve(dev, arch, serve_layers, max_new)
    launches = res["launches"]
    cfg = dataclasses.replace(full, n_layers=serve_layers)
    # one launch an attention layer a forward: the hybrid's attention
    # sublayers in its forward_train, the encoder's layers in one encode
    want = (sum(i % cfg.attn_layer_period == cfg.attn_layer_offset for i in range(serve_layers))
            if hybrid else full.encoder_layers)
    require(launches["flash_attn"] == want == res["wgmma_launches"],
            f"{arch}: flash_attn launched {launches['flash_attn']} times "
            f"({res['wgmma_launches']} on the tensor cores), expected {want}")
    first = (f"prompt (4 x 32 tokens) as decode steps {res['prompt_ms']:.2f} ms; forward_train "
             f"B=1, S=2,048 {res['train_ms']:.2f} ms" if hybrid else
             f"encode (4 x 1,500 frames) {res['encode_ms']:.2f} ms, cross cache "
             f"{res['cross_ms']:.2f} ms, prompt (4 x 4 tokens) {res['prompt_ms']:.2f} ms")
    depth = (f"{serve_layers} of {full.n_layers} layers" if hybrid
             else f"{full.encoder_layers} + {serve_layers} layers")
    log(f"[lm_families] {full.name} served at {depth} (batch 4, {max_new} new): {first}; decode "
        f"{res['decode_ms']:.2f} ms a step ({4e3 / res['decode_ms']:.1f} tokens/s); weights drawn "
        f"in {res['draw_s']:.2f} s, draw peak {draw:.2f} GiB by the spec tree"
        + ("" if deeper is None else f" ({deeper:.2f} one period deeper)")
        + f"; peak {res.get('peak_bytes', 0) / 2**30:.2f} GiB; device busy {res['busy']}; "
        f"flash_attn {launches['flash_attn']} (tensor cores {res['wgmma_launches']})")
    return launches


def phase_lm_families(dev, max_new: int = 8, long_len: int = 4096) -> dict:
    """The MoE, MLA, VLM and SSM families at full width: each against the
    CPU at a cut depth, then served through ``launch.serve.main``; then the
    decode-only hybrid and encoder-decoder (``LM_DECODE_ONLY``).  Returns
    the launch counts of the serving parts."""
    from repro_torch.configs.base import get_config

    t_phase = time.perf_counter()
    total = {name: 0 for name in KERNELS}
    for arch, cmp_layers, serve_layers in LM_FAMILIES:
        _free(dev)
        full = get_config(arch)
        draw, deeper = _deepest_draw(arch, serve_layers)
        cfg = dataclasses.replace(full, n_layers=cmp_layers)
        cmp = lm_card_vs_cpu(dev, cfg)
        rt = cmp.get("routing")
        routing = (f"; routing sets equal {rt['agree']} of {rt['sets']} (token, layer), experts "
                   f"differ in {rt['differ']}, each with a CPU logit margin within twice its "
                   f"token's router-logit error (largest margin / bound {rt['worst_ratio']:.3g}; "
                   f"{rt['near']} sets lie within their bound); router-logit error up to "
                   f"{rt['router_err']:.3g}" if rt else "")
        log(f"[lm_families] {full.name} at {cmp_layers} of {full.n_layers} layers, card vs CPU: "
            f"max |dlogit| {cmp['err']:.4g}, relative {cmp['rel']:.3g} (limit {LM_REL_TOL})"
            f"{routing}; greedy tokens compared {cmp['compared']} of {cmp['tokens']}, all equal "
            f"({cmp['seconds']:.1f} s)")
        require(cmp["rel"] <= LM_REL_TOL,
                f"{arch}: card vs CPU logits differ by {cmp['rel']:.3g} > {LM_REL_TOL}")
        require(cmp["compared"] >= 1, f"{arch}: no greedy token was clear enough to compare")
        _free(dev)
        if full.vision_dim:
            fw = vlm_forward_card_vs_cpu(dev, dataclasses.replace(full, n_layers=1))
        elif full.family == "ssm":
            fw = ssm_forward_card_vs_cpu(dev, cfg)
        else:
            fw = None
        if fw is not None:
            log(f"[lm_families] {full.name} forward_train, card vs CPU at "
                f"{1 if full.vision_dim else cmp_layers} layer(s), B=1, S={fw['S']}"
                + (f" ({full.vision_patches} vision patches of {full.vision_dim}, distinct "
                   f"M-RoPE streams)" if full.vision_dim else " (chunks of 128)")
                + f": hidden relative {fw['rel_h']:.3g}, logits relative {fw['rel']:.3g} "
                f"({fw['seconds']:.1f} s)")
            require(fw["rel"] <= LM_REL_TOL and fw["rel_h"] <= LM_REL_TOL,
                    f"{arch}: forward_train card vs CPU beyond {LM_REL_TOL}")
            _free(dev)

        long = long_len if full.mla else 0
        res = family_serve(dev, arch, serve_layers, max_new, long)
        launches = res["launches"]
        prefills = 1 + bool(long)
        want = 0 if full.family == "ssm" else serve_layers * prefills
        require(launches["flash_attn"] == want,
                f"{arch}: flash_attn launched {launches['flash_attn']} times, expected {want}")
        require(res["wgmma_launches"] == want,
                f"{arch}: {res['wgmma_launches']} of {want} flash_attn launches took the "
                f"tensor-core route")
        req = res["requests"]
        dec = float(np.median(req["decode_ms"]))
        log(f"[lm_families] {full.name} served at {serve_layers} of {full.n_layers} layers "
            f"(launch.serve.main, 4 x 32 tokens, batch 4, {max_new} new): prefill "
            f"{req['prefill_ms'][0]:.2f} ms ({4 * 32 / req['prefill_ms'][0] * 1e3:.0f} tokens/s), "
            f"decode {dec:.2f} ms a step ({4e3 / dec:.1f} tokens/s); wall {res['requests_s']:.2f} s "
            f"with the weights' draw; draw peak {draw:.2f} GiB by the spec tree"
            + ("" if deeper is None else f" ({deeper:.2f} with one more layer)")
            + f"; peak {res.get('peak_bytes', 0) / 2**30:.2f} GiB; device "
            f"busy {res['busy']}; flash_attn {launches['flash_attn']} (tensor cores "
            f"{res['wgmma_launches']})")
        if long:
            lng = res["long"]
            ldec = float(np.median(lng["decode_ms"]))
            log(f"[lm_families] {full.name} long prompt: {long} tokens, prefill "
                f"{lng['prefill_ms'][0]:.1f} ms ({long / lng['prefill_ms'][0] * 1e3:.0f} "
                f"tokens/s), decode {ldec:.2f} ms a token")
        _count_into(total, launches)
        del res
    for arch, cmp_layers, serve_layers in LM_DECODE_ONLY:
        _free(dev)
        _count_into(total, decode_only_family(dev, arch, cmp_layers, serve_layers, max_new))
    _free(dev)
    log(f"[lm_families] phase {time.perf_counter() - t_phase:.1f} s; launches {total}")
    return total


# the train phase: Qwen1.5-0.5B (hf:Qwen/Qwen1.5-0.5B) at full width and depth
TRAIN_ARCH = "qwen1_5_0_5b"
TRAIN_STEPS, TRAIN_CKPT_AT, TRAIN_BATCH, TRAIN_SEQ, TRAIN_MICRO = 8, 4, 8, 2048, 2
TRAIN_RESTART_TOL = 1e-5  # relative: the embedding backward's atomics (index_add_)
# the autograd Function's dq, dk, dv against autograd of attention_plain:
# (label, B, S, T, H, Hkv, hd, causal, MLA (q.k dim, v dim) padded to hd)
FLASH_GRAD_SHAPES = [
    ("Qwen1.5-0.5B train", 4, 2048, 2048, 16, 16, 64, True, None),
    ("Yi-6B", 1, 2048, 2048, 32, 4, 128, True, None),
    ("Whisper cross", 4, 32, 1500, 16, 16, 64, False, None),
    ("MiniCPM3 MLA", 1, 4096, 4096, 40, 40, 128, True, (96, 64)),
]
FLASH_GRAD_TOL = 2e-3  # max |d| / max |ref|, the kernel's contract


def eager_ms(fn, iters: int = 5) -> float:
    """Device ms of one call of ``fn``: CUDA events around ``iters`` eager
    calls after one warm-up (for calls that run autograd, which a CUDA graph
    does not capture)."""
    fn()

    def run():
        for _ in range(iters):
            fn()

    return _events_ms(run) / iters


def _rel(got, want) -> float:
    return float((got.double() - want.double()).abs().max() / want.double().abs().max())


def flash_grad_check(dev, label, B, S, T, H, hkv, hd, causal, mla) -> dict:
    """``flash.attention`` under autograd on the card (the kernel inside
    ``FlashAttention``) against autograd of ``attention_plain`` on the same
    bf16 inputs (through ``layers.attend``'s padding for MLA).  The Function's
    bf16 gradients must equal its blocked backward in f32 rounded to bf16,
    and those f32 gradients the plain version's within ``FLASH_GRAD_TOL``.
    Then the forward kernel, the blocked backward, and SDPA's forward and
    backward are timed on the same input."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels.flash_attn import ops as flash
    from repro_torch.models import layers

    rng = np.random.default_rng(5)
    hq, hv = mla or (hd, hd)
    q, k, v = (torch.as_tensor(rng.standard_normal((B, n, h, d)).astype(np.float32),
                               device=dev).to(torch.bfloat16).requires_grad_()
               for n, h, d in [(S, H, hq), (T, hkv, hq), (T, hkv, hv)])
    do = torch.as_tensor(rng.standard_normal((B, S, H * hv)).astype(np.float32), device=dev)
    scale = 1.0 / np.sqrt(hq)

    def through(attn, q, k, v):
        if mla is None:
            return attn(q, k, v, scale, causal=causal)
        pad = [F.pad(t, (0, hd - t.shape[-1])) for t in (q, k, v)]
        o = attn(*pad, scale, causal=causal)
        return o.reshape(B, S, H, hd)[..., :hv].reshape(B, S, H * hv)

    before = flash.attention.launches
    if mla is None:
        o = flash.attention(q, k, v, scale, causal=causal)
    else:
        o = layers.attend(q, k, v, scale, torch.float32, causal=causal)
    require(flash.attention.launches == before + 1 and o.grad_fn is not None,
            f"{label}: flash_attn did not launch inside the autograd Function")
    got = torch.autograd.grad(o, (q, k, v), do)
    # the Function's backward in f32 (before its cast to bf16), and the plain
    # version's autograd, on f32 copies of the same inputs (MLA: padded as attend pads)
    q32, k32, v32 = (t.detach().float().requires_grad_() for t in (q, k, v))
    pq, pk, pv = (F.pad(t.detach(), (0, hd - t.shape[-1])) for t in (q32, k32, v32))
    with torch.no_grad():
        o_pad = flash.attention(*(t.to(torch.bfloat16) for t in (pq, pk, pv)), scale,
                                causal=causal)
    do_pad = F.pad(do.reshape(B, S, H, hv), (0, hd - hv)).reshape(B, S, H * hd)
    f32 = flash.attention_backward_blocked(pq, pk, pv, o_pad, do_pad, scale, causal)
    f32 = [g[..., :t.shape[-1]] for g, t in zip(f32, (q, k, v))]
    want = torch.autograd.grad(through(flash.attention_plain, q32, k32, v32),
                               (q32, k32, v32), do)
    errs = {}
    for name, g, g32, w in zip("qkv", got, f32, want):
        require(g.dtype == torch.bfloat16 and torch.equal(g, g32.to(torch.bfloat16)),
                f"{label}: d{name} is not the blocked backward's f32 gradient in bf16")
        errs[f"d{name}"] = _rel(g32, w)
        require(errs[f"d{name}"] <= FLASH_GRAD_TOL,
                f"{label}: d{name} differs from the plain version's by {errs[f'd{name}']:.3g}"
                f" > {FLASH_GRAD_TOL}")
    del got, f32, want, q32, k32, v32
    _free(dev)

    # timing on the padded bf16 input the kernel takes (MLA: q, k, v at hd)
    qb, kb, vb = (t.to(torch.bfloat16) for t in (pq, pk, pv))
    ob, dob = o_pad, do_pad
    st = [t.transpose(1, 2).detach().requires_grad_() for t in (qb, kb, vb)]

    def sdpa():
        return F.scaled_dot_product_attention(*st, is_causal=causal, scale=scale,
                                              enable_gqa=True)

    so = sdpa()
    sdo = dob.reshape(B, S, H, hd).transpose(1, 2).to(torch.bfloat16)
    with torch.no_grad():
        kernel_ms = eager_ms(lambda: flash.attention(qb, kb, vb, scale, causal=causal))
    backward_ms = eager_ms(lambda: flash.attention_backward_blocked(
        qb, kb, vb, ob, dob, scale, causal))
    with torch.no_grad():
        sdpa_ms = eager_ms(sdpa)
    sdpa_bwd_ms = eager_ms(lambda: torch.autograd.grad(so, st, sdo, retain_graph=True))
    pairs = sum(min(r + 1, T) for r in range(S)) if causal else S * T
    esize = 2
    io = esize * (B * S * H * hd + 2 * B * T * hkv * hd)
    fwd_bound = bound(io + 4 * B * S * H * hd, 4 * B * H * hd * pairs, PEAK_BF16_FLOPS)
    # backward: reads q, k, v (bf16), o and dO (f32); writes dq, dk, dv (bf16);
    # five products of 2 * hd flops a (row, col) pair: scores, dV, dP, dQ, dK
    bwd_bytes = io + 2 * 4 * B * S * H * hd + io
    bwd_bound = bound(bwd_bytes, 10 * B * H * hd * pairs, PEAK_BF16_FLOPS)
    bwd_bound_f32 = bound(bwd_bytes, 10 * B * H * hd * pairs, PEAK_F32_FLOPS)
    del q, k, v, qb, kb, vb, ob, st, so
    _free(dev)
    return dict(label=label, errs=errs, kernel_ms=kernel_ms, backward_ms=backward_ms,
                sdpa_ms=sdpa_ms, sdpa_bwd_ms=sdpa_bwd_ms, fwd_bound=fwd_bound,
                bwd_bound=bwd_bound, bwd_bound_f32=bwd_bound_f32)


def train_card_vs_cpu(dev, cfg, batch: int = 2, seq: int = 256) -> dict:
    """The loss and every gradient of ``cfg`` on the card against the CPU,
    from one seed-0 draw (every leaf in f32) carried to both, on one
    ``demo_batch``.  Returns the loss's relative difference, each leaf's
    max |d| / max |g_cpu|, the largest attention-projection gradients on the
    card, and the ``flash_attn`` launches of the card's loss and backward."""
    import torch

    from repro_torch.configs.base import ShapeConfig
    from repro_torch.models.param import in_f32, init_params
    from repro_torch.models.registry import get_model

    api = get_model(cfg)
    cpu = torch.device("cpu")
    tree = init_params(in_f32(api.param_specs()), seed=0, device=dev)
    host_tree = _tree_to(tree, cpu)
    data = api.demo_batch(ShapeConfig("t", seq, batch, "train"))
    out = {}
    for name, d, t in [("card", dev, tree), ("cpu", cpu, host_tree)]:
        model = api.load(t, trainable=True)
        names, params = zip(*model.named_parameters())
        _zero_counts()
        loss, _ = api.loss(model, {k: torch.as_tensor(v, device=d) for k, v in data.items()})
        grads = torch.autograd.grad(loss, params)
        _sync(d)
        out[name] = (float(loss), {n: g.float().cpu() for n, g in zip(names, grads)},
                     _read_counts()["flash_attn"])
        del model, params, grads, loss
    del tree, host_tree
    _free(dev)
    (card_loss, card_g, launches), (cpu_loss, cpu_g, _) = out["card"], out["cpu"]
    rel = {n: _rel(card_g[n], cpu_g[n]) for n in cpu_g}
    proj = {n: float(card_g[n].abs().max()) for n in card_g
            if ".attn." in n and n.rsplit(".", 1)[-1] in ("wq", "wk", "wv", "wo", "bq", "bk", "bv")}
    return dict(loss=(card_loss, cpu_loss), loss_rel=abs(card_loss - cpu_loss) / abs(cpu_loss),
                rel=rel, proj=proj, launches=launches)


def phase_train(dev, steps: int = TRAIN_STEPS, seq: int = TRAIN_SEQ, batch: int = TRAIN_BATCH,
                micro: int = TRAIN_MICRO, layers: int | None = None,
                keep: Path | None = None) -> tuple[dict, dict]:
    """LM training on the card: the ``flash_attn`` autograd Function, the
    card against the CPU at 2 layers, Qwen1.5-0.5B trained through
    ``Trainer`` with a restart, and the launcher.  Returns the launch counts
    of the Trainer runs, and for phase ``train_mesh`` the uninterrupted
    run's losses by step, the state digest at the checkpoint and, with
    ``keep``, that checkpoint linked into ``keep``."""
    import shutil
    import tempfile

    import torch

    from repro_torch.configs.base import get_config
    from repro_torch.data.corpus import CorpusConfig
    from repro_torch.kernels.flash_attn import ops as flash
    from repro_torch.launch.sharding import default_remat_group
    from repro_torch.models.registry import get_model
    from repro_torch.train.optimizer import OptConfig, adamw_update
    from repro_torch.train.train_step import make_train_step, split_microbatches
    from repro_torch.train.train_step import state_digest as train_digest
    from repro_torch.train.trainer import Trainer, TrainerConfig

    t_phase = time.perf_counter()
    for shape in FLASH_GRAD_SHAPES:
        r = flash_grad_check(dev, *shape)
        log(f"[train] flash_attn autograd {r['label']} {shape[1:]}: dq/dk/dv vs plain "
            + ", ".join(f"{k} {v:.3g}" for k, v in r["errs"].items())
            + f" (limit {FLASH_GRAD_TOL}); forward kernel {r['kernel_ms']:.4f} ms (bound "
            f"{r['fwd_bound'][0]:.5f}, {r['fwd_bound'][1]}), SDPA forward {r['sdpa_ms']:.4f}; "
            f"blocked backward {r['backward_ms']:.4f} ms (bound {r['bwd_bound'][0]:.5f} "
            f"{r['bwd_bound'][1]} at the bf16 peak, {r['bwd_bound_f32'][0]:.5f} at the f32 "
            f"peak), SDPA backward {r['sdpa_bwd_ms']:.4f} ms (eager, CUDA events)")

    base_cfg = get_config(TRAIN_ARCH)
    cmp = train_card_vs_cpu(dev, dataclasses.replace(base_cfg, n_layers=2))
    worst = max(cmp["rel"], key=cmp["rel"].get)
    log(f"[train] {base_cfg.name} at 2 layers, card vs CPU (B=2, S=256): loss "
        f"{cmp['loss'][0]:.6f} / {cmp['loss'][1]:.6f} (relative {cmp['loss_rel']:.3g}); "
        f"gradients max |d| / max |g_cpu| worst {cmp['rel'][worst]:.3g} ({worst}), limit "
        f"{LM_REL_TOL}; attention projections' max |g| on the card: smallest "
        f"{min(cmp['proj'].values()):.3g} ({min(cmp['proj'], key=cmp['proj'].get)}); "
        f"flash_attn launches {cmp['launches']}")
    require(cmp["loss_rel"] <= LM_REL_TOL, f"train loss card vs CPU {cmp['loss_rel']:.3g}")
    bad = {n: e for n, e in cmp["rel"].items() if not e <= LM_REL_TOL}
    require(not bad, f"gradients card vs CPU over {LM_REL_TOL}: {bad}")
    require(len(cmp["proj"]) == 2 * 7 and all(g > 0 for g in cmp["proj"].values()),
            f"an attention projection has no gradient on the card: {cmp['proj']}")
    require(cmp["launches"] == 2 * 2, f"flash_attn launched {cmp['launches']} times in the "
            "2-layer loss and backward, expected 4 (forward and recompute)")

    n_layers = layers or base_cfg.n_layers
    cfg = dataclasses.replace(base_cfg, n_layers=n_layers,
                              remat_group=default_remat_group(n_layers))
    api = get_model(cfg)
    data = CorpusConfig(vocab_size=cfg.vocab_size, seq_len=seq, global_batch=batch, seed=0)
    opt_cfg = OptConfig(lr=1e-3, warmup_steps=2)
    root = Path(tempfile.mkdtemp(prefix=".chip_smoke_train_", dir=ROOT))
    per_launch = n_layers * micro * 2  # forward and remat recompute
    records: list = []
    kept: dict = {}

    def trainer(ckpt_dir, n):
        t = Trainer(api, data, opt_cfg, TrainerConfig(
            steps=n, ckpt_every=TRAIN_CKPT_AT, log_every=1, microbatches=micro,
            ckpt_dir=str(ckpt_dir), keep_ckpts=3), device=dev)
        step_fn = t.step_fn

        def timed(model, opt, b):
            """One step, synchronized, on the host clock (no profiler)."""
            _sync(dev)
            if dev.type == "cuda":
                torch.cuda.reset_peak_memory_stats(dev)
            before = flash.attention.launches
            t0 = time.perf_counter()
            out = step_fn(model, opt, b)
            loss = float(out[2]["loss"])
            _sync(dev)
            if int(out[1]["step"]) == TRAIN_CKPT_AT and "digest" not in kept:
                kept["digest"] = train_digest(out[0], out[1])
            records.append(dict(ms=(time.perf_counter() - t0) * 1e3, loss=loss,
                                launches=flash.attention.launches - before,
                                peak=torch.cuda.max_memory_allocated(dev)
                                if dev.type == "cuda" else 0))
            return out
        t.step_fn = timed
        return t

    try:
        _zero_counts()
        full = trainer(root / "full", steps).run()
        full_losses, full_wall = full["losses"], full["wall_time_s"]
        del full  # the first run's model and moments, before the restart's
        _free(dev)
        restart_dir = root / "restart"
        for d in [restart_dir, keep] if keep is not None else [restart_dir]:
            shutil.copytree(root / "full" / f"step_{TRAIN_CKPT_AT:09d}",
                            d / f"step_{TRAIN_CKPT_AT:09d}", copy_function=os.link)
        shutil.rmtree(root / "full")
        resumed_t = trainer(restart_dir, steps)
        resumed = resumed_t.run()
        launches = _read_counts()
        wgmma = _wrappers()["flash_attn"].wgmma_launches
        for i, r in enumerate(records):
            step = i + 1 if i < steps else TRAIN_CKPT_AT + i - steps + 1
            log(f"[train] {'run' if i < steps else 'restart'} step {step}: loss {r['loss']:.6f}, "
                f"{r['ms']:.1f} ms, {batch * seq / r['ms'] * 1e3:.0f} tokens/s, peak "
                f"{r['peak'] / 2**30:.2f} GiB, flash_attn {r['launches']}")
        require(all(r["launches"] == per_launch for r in records),
                f"flash_attn launched {[r['launches'] for r in records]} times a step, "
                f"expected {per_launch} ({n_layers} layers x {micro} microbatches x 2)")
        require(launches["flash_attn"] == wgmma == per_launch * len(records),
                f"flash_attn launches {launches['flash_attn']} (tensor cores {wgmma}), "
                f"expected {per_launch * len(records)}")
        losses = [x for _, x in full_losses]
        require(losses[-1] < losses[0], f"the loss did not fall: {losses}")
        again = dict(resumed["losses"])
        diffs = {s: abs(again[s] - x) / abs(x) for s, x in full_losses if s > TRAIN_CKPT_AT}
        require(sorted(again) == list(range(TRAIN_CKPT_AT + 1, steps + 1))
                and max(diffs.values()) <= TRAIN_RESTART_TOL,
                f"restarted losses differ: {again} vs {full_losses}")
        log(f"[train] {cfg.name}, {n_layers} layers, remat_group {cfg.remat_group}, batch "
            f"{batch} x {seq} in {micro} microbatches: losses {losses[0]:.4f} -> "
            f"{losses[-1]:.4f} over {steps} steps ({full_wall:.1f} s, checkpoint saves "
            f"included); restart at step {TRAIN_CKPT_AT}: steps {sorted(again)}, largest "
            f"relative loss difference from the uninterrupted run {max(diffs.values()):.3g} "
            f"(limit {TRAIN_RESTART_TOL}: deterministic algorithms are not set, so the "
            f"embedding backward's index_add_ atomics may move the last bits)")

        # not counted: the device's busy share of one more step under
        # torch.profiler, and how a microbatch's step splits between
        # forward, backward (with the remat recompute) and AdamW
        model, opt = resumed["params"], resumed["opt"]
        step_fn = make_train_step(api, opt_cfg, microbatches=micro)
        split = {k: torch.as_tensor(v, device=dev) for k, v in
                 split_microbatches(resumed_t.data.batch(steps), micro).items()}
        log(f"[train] one more step under torch.profiler: device busy "
            f"{_device_busy(dev, lambda: step_fn(model, opt, split))}")
        b = {k: torch.as_tensor(v, device=dev) for k, v in
             resumed_t.data.batch(steps).items()}
        mb = {k: v[: batch // micro] for k, v in b.items()}
        params = dict(model.named_parameters())
        _sync(dev)
        t0 = time.perf_counter()
        loss, _ = api.loss(model, mb)
        _sync(dev)
        t1 = time.perf_counter()
        grads = torch.autograd.grad(loss, list(params.values()))
        _sync(dev)
        t2 = time.perf_counter()
        adamw_update(opt_cfg, params, dict(zip(params, grads)), opt)
        _sync(dev)
        t3 = time.perf_counter()
        log(f"[train] one microbatch of "
            f"{batch // micro} x {seq}: forward {(t1 - t0) * 1e3:.1f} ms, backward (remat "
            f"recompute included) {(t2 - t1) * 1e3:.1f} ms; AdamW over "
            f"{sum(p.numel() for p in params.values()) / 1e6:.1f} M parameters "
            f"{(t3 - t2) * 1e3:.1f} ms (host clock, synchronized)")
        del model, opt, grads, params, resumed, resumed_t
    finally:
        shutil.rmtree(root, ignore_errors=True)
        _free(dev)

    argv = [sys.executable, "-m", "repro_torch.launch.train", "--arch", TRAIN_ARCH,
            "--steps", "2", "--batch", str(batch), "--seq", str(seq),
            "--microbatches", str(micro)]
    if dev.type != "cuda":
        argv += ["--device", "cpu"]
    t0 = time.perf_counter()
    proc = subprocess.run(argv, cwd=str(ROOT), capture_output=True, text=True, timeout=600,
                          env={**os.environ, "PYTHONPATH": str(ROOT / "src")})
    log(f"[train] {' '.join(argv[1:])}: exit {proc.returncode} in "
        f"{time.perf_counter() - t0:.1f} s: " + " | ".join(proc.stdout.strip().splitlines()))
    require(proc.returncode == 0, f"the train launcher failed: {proc.stderr[-2000:]}")
    log(f"[train] launches in the Trainer runs: {launches}; phase "
        f"{time.perf_counter() - t_phase:.1f} s")
    return launches, dict(losses=dict(full_losses), digest=kept.get("digest"), ckpt=keep)


# the train_mesh phase: phase train's model and settings on 2 ranks sharing the card
MESH_RANKS = 2
MESH_STEPS, MESH_CKPT_AT, MESH_COMPRESSED_STEPS = 4, 2, 3
MESH_LOSS_TOL = 2e-3  # relative, steps 2 on, against phase train (PERF.md §6)
MESH_STEP1_TOL = 1e-3  # relative, step 1 against phase train: the same parameters
COMPRESSED_STEP1_TOL = 1e-6  # the compressed step's step 1 against the data-parallel one
PSUM_ELEMS = 1 << 20


def _mesh_trainer(api, data, opt_cfg, ckpt_dir, steps, micro, mesh, dev, records,
                  profile_last: bool = False, count_steps=()):
    """A Trainer whose steps are timed on the host clock (synchronized), with
    each step's launches, collective seconds and bytes, peak memory and state
    digest recorded; the first record is the state as restored.
    ``profile_last``: the last step runs under torch.profiler, its record
    holding the device's busy share (and its time the profiler's cost).
    A data-parallel step times its own all-reduces (``step.stats``); a
    tensor-parallel step's collectives are counted by kind, each
    synchronized, by ``OpCounter`` on the steps in ``count_steps`` only (the
    others run as a user's would, so the pair shows what counting costs)."""
    import torch

    from repro_torch.kernels.flash_attn import ops as flash
    from repro_torch.launch.hlo_analysis import OpCounter, by_kind
    from repro_torch.train.train_step import state_digest as train_digest
    from repro_torch.train.trainer import Trainer, TrainerConfig

    t = Trainer(api, data, opt_cfg, TrainerConfig(
        steps=steps, ckpt_every=MESH_CKPT_AT, log_every=1, microbatches=micro,
        ckpt_dir=str(ckpt_dir), keep_ckpts=3), mesh=mesh, device=dev)
    step_fn = t.step_fn
    if t.tp:  # a tensor-parallel state's digest: each rank's blocks
        from repro_torch.train.train_step import tp_replicas_agree

        def train_digest(model, opt):  # noqa: F811
            return tp_replicas_agree(model, opt, mesh)[1]

    def timed(model, opt, b):
        if not records:
            records.append(dict(restored=train_digest(model, opt), step=int(opt["step"])))
        _sync(dev)
        if dev.type == "cuda":
            torch.cuda.reset_peak_memory_stats(dev)
        before = flash.attention.launches
        step_no = int(opt["step"]) + 1
        counter = OpCounter(timed=True, ops=False) if t.tp and step_no in count_steps else None

        def run():
            if counter is None:
                return step_fn(model, opt, b)
            with counter:
                return step_fn(model, opt, b)

        t0 = time.perf_counter()
        busy = None
        if profile_last and step_no == steps and dev.type == "cuda":
            got = []
            busy = _device_busy(dev, lambda: got.append(run()))
            out = got[0]
        else:
            out = run()
        loss = float(out[2]["loss"])
        _sync(dev)
        ms = (time.perf_counter() - t0) * 1e3
        if counter is not None:
            colls = counter.counts.collectives
            stats = dict(collective_s=sum(c["seconds"] for c in colls),
                         bytes=sum(c["bytes"] for c in colls),
                         by_kind=by_kind(colls, "bytes"),
                         seconds_by_kind=by_kind(colls, "seconds"))
        else:
            stats = {} if t.tp else getattr(step_fn, "stats", {"collective_s": 0.0, "bytes": 0})
        records.append(dict(step=int(out[1]["step"]), ms=ms, loss=loss,
                            launches=flash.attention.launches - before,
                            **({"collective_ms": stats["collective_s"] * 1e3,
                                "bytes": stats["bytes"]} if stats else {}),
                            **{k: stats[k] for k in ("by_kind", "seconds_by_kind")
                               if k in stats}, **({"busy": busy} if busy else {}),
                            peak=torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0,
                            digest=train_digest(out[0], out[1])))
        return out

    t.step_fn = timed
    return t


def train_mesh_worker(spec_path: str, device: str | None) -> int:
    """A rank of phase ``train_mesh`` (``REPRO_SHARD_*`` set by the phase):
    (1) data parallelism, (2) phase train's checkpoint restored and one step,
    (3) the compressed cross-pod step, (4) ``compressed_psum`` on seeded
    inputs; prints one ``SHARD_RESULT`` line a job."""
    import torch
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh

    from repro_torch.data.corpus import CorpusConfig, TokenStream, shard_batch
    from repro_torch.launch.mesh import init_em_distributed, mesh_device
    from repro_torch.models.param import in_f32, init_params, leaves
    from repro_torch.models.registry import get_model
    from repro_torch.train import compress
    from repro_torch.train.optimizer import OptConfig
    from repro_torch.train.train_step import (
        error_state_of, make_train_step, replicas_agree, split_microbatches)
    from repro_torch.train.trainer import state_from_tree

    spec = json.loads(Path(spec_path).read_text())
    init_em_distributed(device=device)
    rank, n = dist.get_rank(), dist.get_world_size()
    dev_type = "cpu" if device == "cpu" else "cuda"
    mesh = DeviceMesh(dev_type, torch.arange(n), mesh_dim_names=("data",))
    dev = mesh_device(mesh)
    who = dict(rank=rank, ranks=n, backend=dist.get_backend(), device=str(dev))
    api = get_model(_train_cfg(spec["layers"], spec["smoke"]))
    micro, seq, batch = spec["micro"], spec["seq"], spec["batch"]
    data = CorpusConfig(vocab_size=api.cfg.vocab_size, seq_len=seq, global_batch=batch, seed=0)
    opt_cfg = OptConfig(lr=1e-3, warmup_steps=2)

    # (1) data parallelism, and (2) phase train's checkpoint on 2 ranks
    for job, ckpt_dir, steps in [("dp", spec["dp_dir"], MESH_STEPS),
                                 ("restore", spec["train_ckpt"], spec["train_ckpt_at"] + 1)]:
        records: list = []
        _zero_counts()
        out = _mesh_trainer(api, data, opt_cfg, ckpt_dir, steps, micro, mesh, dev,
                            records).run()
        launches = _read_counts()
        wgmma = _wrappers()["flash_attn"].wgmma_launches
        busy = None
        if job == "dp":  # one more step under the profiler
            step_fn = make_train_step(api, opt_cfg, microbatches=micro, mesh=mesh)
            b = shard_batch(split_microbatches(TokenStream(data).batch(steps), micro), mesh,
                            microbatched=micro > 1)
            busy = _device_busy(dev, lambda: step_fn(out["params"], out["opt"], b))
            del step_fn, b
        _rank_result("train_mesh", job=job, records=records, digests=out["digests"],
                     launches=launches, wgmma=wgmma, busy=busy, **who)
        del out
        _free(dev)

    # (3) the compressed cross-pod step over a ("pod",) mesh of the same ranks
    pods = DeviceMesh(dev_type, torch.arange(n), mesh_dim_names=("pod",))
    state = state_from_tree(api, init_params(in_f32(api.param_specs()), seed=0, device=dev))
    model, opt = state["params"], state["opt"]
    err = error_state_of(model)
    step_fn = make_train_step(api, opt_cfg, microbatches=micro, compress_pods=True, mesh=pods)
    stream = TokenStream(data)
    records = []
    _zero_counts()
    for i in range(MESH_COMPRESSED_STEPS):
        b = shard_batch(split_microbatches(stream.batch(i), micro), pods, ("pod", "data"),
                        microbatched=micro > 1)
        _sync(dev)
        if dev.type == "cuda":
            torch.cuda.reset_peak_memory_stats(dev)
        t0 = time.perf_counter()
        model, opt, err, metrics = step_fn(model, opt, err, b)
        loss = float(metrics["loss"])
        _sync(dev)
        ms = (time.perf_counter() - t0) * 1e3
        agree, digest = replicas_agree(dict(model.named_parameters()))
        err_norm = float(torch.sqrt(sum(torch.sum(e.double() * e.double())
                                        for e in leaves(err))))
        records.append(dict(step=i + 1, ms=ms, loss=loss, agree=agree, digest=digest,
                            err_norm=err_norm, collective_ms=step_fn.stats["collective_s"] * 1e3,
                            bytes=step_fn.stats["bytes"],
                            peak=torch.cuda.max_memory_allocated(dev) if dev.type == "cuda"
                            else 0))
    _rank_result("train_mesh", job="compressed", records=records, launches=_read_counts(),
                 **who)
    del model, opt, err, state
    _free(dev)

    # (4) compressed_psum on seeded f32 gradients, held to the host's formula by the parent
    g, e = _psum_inputs(rank)
    got, resid = compress.compressed_psum(torch.as_tensor(g, device=dev), pods.get_group(),
                                          torch.as_tensor(e, device=dev))
    np.savez(Path(spec["psum_out"]) / f"rank{rank}.npz", out=got.cpu().numpy(),
             err=resid.cpu().numpy())
    _rank_result("train_mesh", job="psum", **who)
    dist.destroy_process_group()
    return 0


def _psum_inputs(rank: int) -> tuple[np.ndarray, np.ndarray]:
    """Rank ``rank``'s seeded f32 gradient and residual for the exchange check."""
    rng = np.random.default_rng([23, rank])
    g = (rng.standard_normal(PSUM_ELEMS) * 3.0).astype(np.float32)
    return g, (rng.standard_normal(PSUM_ELEMS) * 3e-3).astype(np.float32)


def psum_on_host(inputs: list[tuple[np.ndarray, np.ndarray]]) -> list[tuple[np.ndarray, ...]]:
    """``compressed_psum``'s formula in numpy for every rank: the shared
    scale from the largest |g + err|, round half to even, the residual
    rounded once, the int32 sum over the ranks, ``total * scale / n``."""
    f32 = np.float32
    gs = [g + e for g, e in inputs]
    amax = max(np.abs(x).max() for x in gs)
    scale = f32(max(amax, f32(1e-12)) / f32(127.0))
    qs = [np.clip(np.rint(x / scale), -127, 127).astype(np.int8) for x in gs]
    total = np.sum([q.astype(np.int32) for q in qs], axis=0, dtype=np.int32)
    out = total.astype(f32) * scale / f32(len(inputs))
    return [(out, (x.astype(np.float64) - q.astype(np.float64) * np.float64(scale)).astype(f32))
            for x, q in zip(gs, qs)]


def _train_cfg(layers: int | None, smoke: bool = False):
    """Phase train's model at ``layers`` (default: full depth); ``smoke``: its
    reduced config (a CPU rehearsal's ranks)."""
    from repro_torch.configs.base import get_config, smoke_config
    from repro_torch.launch.sharding import default_remat_group

    cfg = smoke_config(TRAIN_ARCH) if smoke else get_config(TRAIN_ARCH)
    n = layers or cfg.n_layers
    return dataclasses.replace(cfg, n_layers=n, remat_group=default_remat_group(n))


def _mesh_log(tag: str, r: dict) -> None:
    for rec in r["records"]:
        if "ms" not in rec:
            continue
        log(f"[train_mesh] {tag} rank {r['rank']}/{r['ranks']} step {rec['step']}: loss "
            f"{rec['loss']:.6f}, {rec['ms']:.1f} ms, collectives {rec['collective_ms']:.1f} ms "
            f"(host clock, synchronized), {rec['bytes'] / 1e9:.3f} GB all-reduced, peak "
            f"{rec['peak'] / 2**30:.2f} GiB" + (f", flash_attn {rec['launches']}"
                                                if "launches" in rec else "")
            + (f", error feedback norm {rec['err_norm']:.6g}" if "err_norm" in rec else ""))


def phase_train_mesh(dev, train: dict, seq: int = TRAIN_SEQ, batch: int = TRAIN_BATCH,
                     micro: int = TRAIN_MICRO, layers: int | None = None,
                     smoke: bool = False) -> dict:
    """Training over a mesh of ranks on the card (see the module docstring).
    ``train`` is phase train's result: its losses by step, the state digest
    at its checkpoint and that checkpoint's directory.  Returns the launch
    counts of the ranks' and this process's Trainer runs."""
    import shutil
    import tempfile

    from repro_torch.data.corpus import CorpusConfig
    from repro_torch.kernels.flash_attn import ops as flash
    from repro_torch.models.registry import get_model
    from repro_torch.train.optimizer import OptConfig

    t_phase = time.perf_counter()
    total = dict.fromkeys(KERNELS, 0)
    api = get_model(_train_cfg(layers, smoke))
    n_layers = api.cfg.n_layers
    per_step = n_layers * micro * 2
    want = train["losses"]
    dev_arg = [] if dev.type == "cuda" else ["--shard-device", str(dev)]

    def rel(a, b):
        return abs(a - b) / abs(b)

    with tempfile.TemporaryDirectory(prefix=".chip_smoke_", dir=ROOT) as tmp:
        tmp = Path(tmp)
        (tmp / "psum").mkdir()
        spec = dict(layers=layers, smoke=smoke, seq=seq, batch=batch, micro=micro,
                    dp_dir=str(tmp / "dp"),
                    train_ckpt=str(train["ckpt"]), train_ckpt_at=TRAIN_CKPT_AT,
                    psum_out=str(tmp / "psum"))
        (tmp / "spec.json").write_text(json.dumps(spec))
        t0 = time.perf_counter()
        outs = _spawn_ranks(MESH_RANKS, ["chip_smoke.py", "--train-mesh-worker",
                                         str(tmp / "spec.json"), *dev_arg], tmp / "store", 1200)
        log(f"[train_mesh] {MESH_RANKS} ranks: {time.perf_counter() - t0:.1f} s from spawn to "
            "exit")
        runs = [{r["job"]: r for r in _rank_results(out, "train_mesh")} for out in outs]

        # (1) data parallelism against phase train
        dp = [r["dp"] for r in runs]
        for r in dp:
            _mesh_log("data-parallel", r)
            _count_into(total, r["launches"])
            steps = [rec for rec in r["records"] if "ms" in rec]
            require([rec["step"] for rec in steps] == list(range(1, MESH_STEPS + 1)),
                    f"data-parallel steps {[rec['step'] for rec in steps]}")
            require(all(rec["launches"] == per_step for rec in steps),
                    f"rank {r['rank']}: flash_attn launched {[rec['launches'] for rec in steps]}"
                    f" times a step, expected {per_step}")
            require(r["launches"]["flash_attn"] == r["wgmma"] == per_step * MESH_STEPS,
                    f"rank {r['rank']}: flash_attn launches {r['launches']['flash_attn']} "
                    f"(tensor cores {r['wgmma']}), expected {per_step * MESH_STEPS}")
            log(f"[train_mesh] data-parallel rank {r['rank']}: one more step under "
                f"torch.profiler: device busy {r['busy']} (this rank's kernels)")
        digests = [[rec["digest"] for rec in r["records"] if "ms" in rec] for r in dp]
        require(all(d == digests[0] for d in digests), "the replicas' states differ")
        losses = {rec["step"]: rec["loss"] for rec in dp[0]["records"] if "ms" in rec}
        require(all({rec["step"]: rec["loss"] for rec in r["records"] if "ms" in rec} == losses
                    for r in dp), "the ranks' losses differ")
        diffs = {s: rel(x, want[s]) for s, x in losses.items()}
        require(diffs[1] <= MESH_STEP1_TOL and max(diffs.values()) <= MESH_LOSS_TOL,
                f"data-parallel losses {losses} against phase train's {want}: {diffs}")
        log(f"[train_mesh] data parallelism, {MESH_RANKS} ranks ({dp[0]['backend']} on "
            f"{dp[0]['device']}), {n_layers} layers, batch {batch} x {seq} in {micro} "
            f"microbatches: losses {losses}; relative to phase train's "
            + ", ".join(f"step {s} {d:.3g}" for s, d in diffs.items())
            + f" (limits {MESH_STEP1_TOL} at step 1, {MESH_LOSS_TOL}); the replicas' "
            f"parameters, moments and step agree after every step")

        # (2) elastic restore: phase train's checkpoint on 2 ranks
        rs = [r["restore"] for r in runs]
        for r in rs:
            _mesh_log("restore 1 -> 2", r)
            _count_into(total, r["launches"])
            first = r["records"][0]
            require(first["step"] == TRAIN_CKPT_AT and first["restored"] == train["digest"],
                    f"rank {r['rank']} restored step {first['step']} with digest "
                    f"{first['restored'][:16]}, phase train saved {str(train['digest'])[:16]}")
        (rec5,) = [rec for rec in rs[0]["records"] if "ms" in rec]
        require(all([rec for rec in r["records"] if "ms" in rec][0]["digest"] == rec5["digest"]
                    for r in rs), "the restored replicas differ")
        d5 = rel(rec5["loss"], want[TRAIN_CKPT_AT + 1])
        require(d5 <= MESH_LOSS_TOL, f"step {TRAIN_CKPT_AT + 1} after the 1 -> 2 restore: "
                f"{rec5['loss']} against {want[TRAIN_CKPT_AT + 1]}")
        log(f"[train_mesh] phase train's step-{TRAIN_CKPT_AT} checkpoint restored on "
            f"{MESH_RANKS} ranks bit for bit; step {TRAIN_CKPT_AT + 1} loss {rec5['loss']:.6f}, "
            f"relative to phase train's {d5:.3g}")

        # (3) the compressed cross-pod step
        cs = [r["compressed"] for r in runs]
        for r in cs:
            _mesh_log("compressed", r)
            _count_into(total, r["launches"])
            require(all(rec["agree"] for rec in r["records"]), "compressed replicas differ")
            require(all(rec["err_norm"] > 0 for rec in r["records"]),
                    "the error feedback stayed 0")
        c1 = cs[0]["records"][0]["loss"]
        require(rel(c1, losses[1]) <= COMPRESSED_STEP1_TOL,
                f"compressed step 1 loss {c1} against data-parallel {losses[1]}")
        log(f"[train_mesh] compressed cross-pod step over ('pod',) x {MESH_RANKS}: losses "
            f"{[rec['loss'] for rec in cs[0]['records']]}; step 1 relative to the data-parallel "
            f"step 1 {rel(c1, losses[1]):.3g} (limit {COMPRESSED_STEP1_TOL}); int32 exchange "
            f"{cs[0]['records'][0]['bytes'] / 1e9:.3f} GB a step a rank")

        # (4) compressed_psum bit for bit against the host's formula
        want_psum = psum_on_host([_psum_inputs(r) for r in range(MESH_RANKS)])
        for r in range(MESH_RANKS):
            with np.load(tmp / "psum" / f"rank{r}.npz") as z:
                out, err = z["out"], z["err"]
            require(out.tobytes() == want_psum[r][0].tobytes()
                    and err.tobytes() == want_psum[r][1].tobytes(),
                    f"compressed_psum rank {r} differs from the host's formula")
        log(f"[train_mesh] compressed_psum of {PSUM_ELEMS} f32 elements a rank: result and "
            f"residual equal the host's formula bit for bit on both ranks")

        # (2) elastic restore: the 2 ranks' step-2 checkpoint on this one process
        one_dir = tmp / "one"
        shutil.copytree(tmp / "dp" / f"step_{MESH_CKPT_AT:09d}",
                        one_dir / f"step_{MESH_CKPT_AT:09d}", copy_function=os.link)
        data = CorpusConfig(vocab_size=api.cfg.vocab_size, seq_len=seq, global_batch=batch,
                            seed=0)
        records: list = []
        _zero_counts()
        _mesh_trainer(api, data, OptConfig(lr=1e-3, warmup_steps=2), one_dir, MESH_STEPS,
                      micro, None, dev, records).run()
        lc = _read_counts()
        _count_into(total, lc)
        require(lc["flash_attn"] == flash.attention.wgmma_launches == per_step * 2,
                f"flash_attn launched {lc['flash_attn']} times in the 2 -> 1 restore")
        saved = {rec["step"]: rec["digest"] for rec in dp[0]["records"] if "ms" in rec}
        require(records[0]["restored"] == saved[MESH_CKPT_AT],
                f"the 2 -> 1 restore differs from the state the ranks saved at step "
                f"{MESH_CKPT_AT}")
        one = {rec["step"]: rec["loss"] for rec in records if "ms" in rec}
        d1 = {s: rel(x, want[s]) for s, x in one.items()}
        require(sorted(one) == [MESH_CKPT_AT + 1, MESH_STEPS]
                and max(d1.values()) <= MESH_LOSS_TOL,
                f"steps after the 2 -> 1 restore: {one} against phase train's {want}")
        log(f"[train_mesh] the ranks' step-{MESH_CKPT_AT} checkpoint restored on one process "
            f"bit for bit; losses {one}, relative to phase train's "
            + ", ".join(f"step {s} {d:.3g}" for s, d in d1.items())
            + ", to the ranks' " + ", ".join(f"step {s} {rel(x, losses[s]):.3g}"
                                             for s, x in one.items()))
        _free(dev)

        # (5) the launcher as 2 ranks
        argv = ["-m", "repro_torch.launch.train", "--arch", TRAIN_ARCH, "--smoke", "--steps",
                "3", *(["--device", str(dev)] if dev.type != "cuda" else [])]
        t0 = time.perf_counter()
        outs = _spawn_ranks(MESH_RANKS, argv, tmp / "launch", 600)
        lines = [[ln for ln in o.splitlines() if ln.startswith(("arch=", "step "))]
                 for o in outs]
        require(all(f"devices={MESH_RANKS}" in ls[0] for ls in lines)
                and all(ls == lines[0] for ls in lines),
                f"the launcher's ranks printed {lines}")
        log(f"[train_mesh] python {' '.join(argv)} as {MESH_RANKS} ranks: exit 0 in "
            f"{time.perf_counter() - t0:.1f} s, both print " + " | ".join(lines[0]))
    if train["ckpt"] is not None:
        shutil.rmtree(train["ckpt"], ignore_errors=True)
    log(f"[train_mesh] phase {time.perf_counter() - t_phase:.1f} s; launches {total}")
    return total


# the train_tp phase: phase train's model and settings over a (data, model)
# mesh of (1, 2), 2 ranks sharing the card
TP_SHAPE = (1, 2)
TP_STEPS, TP_CKPT_AT = 4, 2
TP_COUNTED = (1, 2)  # steps whose collectives OpCounter counts; 3 and 4 run uncounted


def _tp_mesh(dev_type: str, shape):
    import torch
    from torch.distributed.device_mesh import DeviceMesh

    return DeviceMesh(dev_type, torch.arange(shape[0] * shape[1]).reshape(shape),
                      mesh_dim_names=("data", "model"))


def train_tp_worker(spec_path: str, device: str | None) -> int:
    """A rank of phase ``train_tp`` (``REPRO_SHARD_*`` set by the phase): (1)
    the tensor-parallel Trainer over a (1, 2) mesh from phase train's seed,
    a checkpoint at step 2, the last step under the profiler; (2) that
    checkpoint restored onto a (2, 1) data-parallel mesh and one step;
    prints one ``SHARD_RESULT`` line a job."""
    import torch.distributed as dist

    from repro_torch.data.corpus import CorpusConfig
    from repro_torch.launch.mesh import init_em_distributed, mesh_device
    from repro_torch.models.registry import get_model
    from repro_torch.train.optimizer import OptConfig

    spec = json.loads(Path(spec_path).read_text())
    init_em_distributed(device=device)
    rank, n = dist.get_rank(), dist.get_world_size()
    dev_type = "cpu" if device == "cpu" else "cuda"
    api = get_model(_train_cfg(spec["layers"], spec["smoke"]))
    micro, seq, batch = spec["micro"], spec["seq"], spec["batch"]
    data = CorpusConfig(vocab_size=api.cfg.vocab_size, seq_len=seq, global_batch=batch, seed=0)
    opt_cfg = OptConfig(lr=1e-3, warmup_steps=2)
    for job, shape, steps in [("tp", TP_SHAPE, TP_STEPS),
                              ("restore", TP_SHAPE[::-1], TP_CKPT_AT + 1)]:
        ckpt_dir = Path(spec["dir"])
        if job == "restore":  # the step-2 checkpoint alone
            ckpt_dir = ckpt_dir.with_name("restore")
            if rank == 0:
                import shutil

                shutil.copytree(Path(spec["dir"]) / f"step_{TP_CKPT_AT:09d}",
                                ckpt_dir / f"step_{TP_CKPT_AT:09d}", copy_function=os.link)
            dist.barrier()
        mesh = _tp_mesh(dev_type, shape)
        dev = mesh_device(mesh)
        who = dict(rank=rank, ranks=n, backend=dist.get_backend(), device=str(dev),
                   mesh=list(shape))
        records: list = []
        _zero_counts()
        out = _mesh_trainer(api, data, opt_cfg, ckpt_dir, steps, micro, mesh, dev, records,
                            profile_last=job == "tp", count_steps=TP_COUNTED).run()
        launches = _read_counts()
        wgmma = _wrappers()["flash_attn"].wgmma_launches
        _rank_result("train_tp", job=job, records=records, launches=launches, wgmma=wgmma,
                     busy=records[-1].get("busy"), **who)
        del out
        _free(dev)
    dist.destroy_process_group()
    return 0


def _checkpoint_digest(api, ckpt_dir: Path, step: int) -> str:
    """The state digest of a checkpoint, restored on the CPU."""
    from repro_torch.checkpoint.checkpointer import Checkpointer
    from repro_torch.train.train_step import state_digest as train_digest
    from repro_torch.train.trainer import state_from_tree

    specs = api.param_specs()
    got = Checkpointer(str(ckpt_dir)).restore(step, {"params": specs, "opt": {
        "m": specs, "v": specs, "step": np.zeros((), np.int32)}}, device="cpu")
    state = state_from_tree(api, got["params"], got["opt"])
    return train_digest(state["params"], state["opt"])


def phase_train_tp(dev, train: dict, seq: int = TRAIN_SEQ, batch: int = TRAIN_BATCH,
                   micro: int = TRAIN_MICRO, layers: int | None = None,
                   smoke: bool = False) -> dict:
    """Tensor-parallel training on the card (see the module docstring).
    ``train`` is phase train's result (its losses by step).  Returns the
    launch counts of the ranks' and this process's Trainer runs."""
    import shutil
    import tempfile

    from repro_torch.data.corpus import CorpusConfig
    from repro_torch.kernels.flash_attn import ops as flash
    from repro_torch.models.registry import get_model
    from repro_torch.train.optimizer import OptConfig

    t_phase = time.perf_counter()
    total = dict.fromkeys(KERNELS, 0)
    api = get_model(_train_cfg(layers, smoke))
    n_layers = api.cfg.n_layers
    per_step = n_layers * micro * 2
    want = train["losses"]
    dev_arg = [] if dev.type == "cuda" else ["--shard-device", str(dev)]

    def rel(a, b):
        return abs(a - b) / abs(b)

    with tempfile.TemporaryDirectory(prefix=".chip_smoke_", dir=ROOT) as tmp:
        tmp = Path(tmp)
        spec = dict(layers=layers, smoke=smoke, seq=seq, batch=batch, micro=micro,
                    dir=str(tmp / "tp"))
        (tmp / "spec.json").write_text(json.dumps(spec))
        t0 = time.perf_counter()
        outs = _spawn_ranks(MESH_RANKS, ["chip_smoke.py", "--train-tp-worker",
                                         str(tmp / "spec.json"), *dev_arg], tmp / "store", 1200)
        log(f"[train_tp] {MESH_RANKS} ranks: {time.perf_counter() - t0:.1f} s from spawn to "
            "exit")
        runs = [{r["job"]: r for r in _rank_results(out, "train_tp")} for out in outs]

        # (1) the tensor-parallel steps against phase train
        tp = [r["tp"] for r in runs]
        for r in tp:
            _count_into(total, r["launches"])
            for rec in r["records"]:
                if "ms" not in rec:
                    continue
                if "by_kind" in rec:
                    kinds = ", ".join(f"{k} {v['calls']:.0f} calls {v['bytes'] / 1e9:.3f} GB "
                                      f"{rec['seconds_by_kind'][k]['seconds'] * 1e3:.1f} ms"
                                      for k, v in sorted(rec["by_kind"].items()))
                    colls = (f"collectives {rec['collective_ms']:.1f} ms (counted, each "
                             f"synchronized, host clock): {kinds}")
                else:
                    colls = "collectives not counted (no OpCounter, no synchronization)"
                log(f"[train_tp] rank {r['rank']}/{r['ranks']} (data, model) = {r['mesh']} step "
                    f"{rec['step']}: loss {rec['loss']:.6f}, {rec['ms']:.1f} ms, {colls}; peak "
                    f"{rec['peak'] / 2**30:.2f} GiB, flash_attn {rec['launches']}")
            steps = [rec for rec in r["records"] if "ms" in rec]
            require([rec["step"] for rec in steps] == list(range(1, TP_STEPS + 1)),
                    f"tensor-parallel steps {[rec['step'] for rec in steps]}")
            require(all(rec["launches"] == per_step for rec in steps),
                    f"rank {r['rank']}: flash_attn launched {[rec['launches'] for rec in steps]}"
                    f" times a step, expected {per_step}")
            require(r["launches"]["flash_attn"] == r["wgmma"] == per_step * TP_STEPS,
                    f"rank {r['rank']}: flash_attn launches {r['launches']['flash_attn']} "
                    f"(tensor cores {r['wgmma']}), expected {per_step * TP_STEPS}")
            log(f"[train_tp] rank {r['rank']}: step {TP_STEPS} under torch.profiler: device "
                f"busy {r['busy']} (this rank's kernels)")
        losses = {rec["step"]: rec["loss"] for rec in tp[0]["records"] if "ms" in rec}
        require(all({rec["step"]: rec["loss"] for rec in r["records"] if "ms" in rec} == losses
                    for r in tp), "the ranks' losses differ")
        diffs = {s: rel(x, want[s]) for s, x in losses.items()}
        require(diffs[1] <= MESH_STEP1_TOL and max(diffs.values()) <= MESH_LOSS_TOL,
                f"tensor-parallel losses {losses} against phase train's {want}: {diffs}")
        log(f"[train_tp] tensor parallelism over (data, model) = {TP_SHAPE}, {MESH_RANKS} ranks "
            f"({tp[0]['backend']} on {tp[0]['device']}), {n_layers} layers, "
            f"{api.cfg.n_heads // TP_SHAPE[1]} of {api.cfg.n_heads} heads and "
            f"{api.cfg.vocab_size // TP_SHAPE[1]} of {api.cfg.vocab_size} vocabulary rows a "
            f"rank, batch {batch} x {seq} in {micro} microbatches: losses {losses}; relative "
            "to phase train's " + ", ".join(f"step {s} {d:.3g}" for s, d in diffs.items())
            + f" (limits {MESH_STEP1_TOL} at step 1, {MESH_LOSS_TOL}); the blocks each rank "
            "shares with another (the norms, and every leaf across data ranks) agree after "
            "every step")

        # (2) the step-2 checkpoint on a (2, 1) data-parallel mesh and on one process
        saved = _checkpoint_digest(api, tmp / "tp", TP_CKPT_AT)
        rs = [r["restore"] for r in runs]
        for r in rs:
            _count_into(total, r["launches"])
            first = r["records"][0]
            require(first["step"] == TP_CKPT_AT and first["restored"] == saved,
                    f"rank {r['rank']} restored step {first['step']} with digest "
                    f"{first['restored'][:16]}, the checkpoint holds {saved[:16]}")
        (rec3,) = [rec for rec in rs[0]["records"] if "ms" in rec]
        require(all([rec for rec in r["records"] if "ms" in rec][0]["digest"] == rec3["digest"]
                    for r in rs), "the restored replicas differ")
        one_dir = tmp / "one"
        shutil.copytree(tmp / "tp" / f"step_{TP_CKPT_AT:09d}",
                        one_dir / f"step_{TP_CKPT_AT:09d}", copy_function=os.link)
        data = CorpusConfig(vocab_size=api.cfg.vocab_size, seq_len=seq, global_batch=batch,
                            seed=0)
        records: list = []
        _zero_counts()
        _mesh_trainer(api, data, OptConfig(lr=1e-3, warmup_steps=2), one_dir, TP_CKPT_AT + 1,
                      micro, None, dev, records).run()
        lc = _read_counts()
        _count_into(total, lc)
        require(lc["flash_attn"] == per_step, f"flash_attn launched {lc['flash_attn']} times "
                "in the restore on one process")
        require(records[0]["restored"] == saved, "the restore on one process differs from the "
                "checkpoint")
        (one3,) = [rec for rec in records if "ms" in rec]
        d3 = {"(2, 1)": rel(rec3["loss"], losses[3]), "one": rel(one3["loss"], losses[3])}
        require(max(d3.values()) <= MESH_LOSS_TOL,
                f"step {TP_CKPT_AT + 1} after the restores: (2, 1) {rec3['loss']}, one process "
                f"{one3['loss']}, against the tensor-parallel {losses[3]}")
        log(f"[train_tp] the (1, 2) ranks' step-{TP_CKPT_AT} checkpoint (whole leaves) restored "
            f"bit for bit on a (2, 1) data-parallel mesh and on one process; step "
            f"{TP_CKPT_AT + 1} loss {rec3['loss']:.6f} and {one3['loss']:.6f}, relative to the "
            f"tensor-parallel step {d3['(2, 1)']:.3g} and {d3['one']:.3g}; (2, 1) step "
            f"{rec3['ms']:.1f} ms, collectives {rec3['collective_ms']:.1f} ms")
        _free(dev)
    log(f"[train_tp] phase {time.perf_counter() - t_phase:.1f} s; launches {total}")
    return total


# the dryrun phase: cells of the multi-pod dry run, on the host's CPU
DRYRUN_CELLS = [("qwen1_5_0_5b", "train_4k"), ("qwen1_5_0_5b", "decode_32k"),
                ("yi_6b", "train_4k")]


def dryrun_worker(out_dir: str) -> int:
    """The dry run's cells (``DRYRUN_CELLS``) and the EM cell on both
    production meshes, records written to ``out_dir``: a process of its own,
    so that its fake 256- and 512-rank groups meet no other phase's."""
    from repro_torch.launch import dryrun

    for multi_pod in (False, True):
        for arch, shape in DRYRUN_CELLS:
            dryrun._save(dryrun.lower_cell(arch, shape, multi_pod), out_dir)
        dryrun._save(dryrun.lower_em_cell(multi_pod), out_dir)
    return 0


def start_dryrun() -> tuple:
    """Start phase dryrun's process (it runs on the CPU beside the card's
    phases): (process, its records' directory, the start time)."""
    import tempfile

    tmp = tempfile.mkdtemp(prefix=".chip_smoke_", dir=ROOT)
    proc = subprocess.Popen([sys.executable, "chip_smoke.py", "--dryrun-worker", tmp],
                            cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
                            env={**os.environ, "PYTHONPATH": str(ROOT / "src"),
                                 "CUDA_VISIBLE_DEVICES": ""})
    return proc, tmp, time.perf_counter()


def phase_dryrun(started: tuple | None = None) -> None:
    """The multi-pod dry run on this machine's CPU (see the module
    docstring): every record's model counts against the port's own
    functions, and its roofline terms.  ``started``: :func:`start_dryrun`'s
    process, already running."""
    import shutil

    from repro_torch.configs.base import SHAPES, get_config
    from repro_torch.launch import roofline
    from repro_torch.launch.dryrun import active_param_count
    from repro_torch.launch.sharding import cast_params
    from repro_torch.models.param import param_count
    from repro_torch.models.registry import get_model

    import torch

    proc, tmp, t0 = started or start_dryrun()
    try:
        _, err = proc.communicate(timeout=900)
        require(proc.returncode == 0, f"the dry run failed:\n{err[-3000:]}")
        recs = roofline.load(tmp)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate()
        shutil.rmtree(tmp, ignore_errors=True)
    want_n = 2 * (len(DRYRUN_CELLS) + 1)
    require(len(recs) == want_n and all(r["status"] == "ok" for r in recs),
            f"the dry run wrote {len(recs)} records, expected {want_n} ok")
    for r in recs:
        if r["kind"] != "em_round":
            cfg, shape = get_config(r["arch"]), SHAPES[r["shape"]]
            specs = get_model(cfg).param_specs()
            if shape.kind == "decode":
                specs = cast_params(specs, torch.bfloat16)
            n, act = param_count(specs), active_param_count(cfg, specs)
            tokens = shape.global_batch * (shape.seq_len if shape.kind == "train" else 1)
            flops = (6 if shape.kind == "train" else 2) * act * tokens
            require((r["params"], r["active_params"], r["tokens_per_step"], r["model_flops"])
                    == (n, act, tokens, float(flops)),
                    f"{r['arch']} x {r['shape']}: model counts {r['params']}, "
                    f"{r['active_params']}, {r['tokens_per_step']}, {r['model_flops']} against "
                    f"{n}, {act}, {tokens}, {flops}")
        t = roofline.terms(r)
        log(f"[dryrun] {r['arch']} x {r['shape']} x {r['mesh']}: per rank {r['hlo_flops']:.4g} "
            f"FLOPs, {r['hlo_bytes']:.4g} bytes, {r['collective_wire_bytes']:.4g} wire bytes "
            f"({r['collective_cross_pod_bytes']:.4g} cross-pod), arguments "
            f"{r['mem']['argument_bytes'] / 2**30:.2f} GiB; roofline at the H100's datasheet "
            f"constants: compute {t['compute_s']:.4g} s, memory {t['memory_s']:.4g} s, "
            f"collective {t['collective_s']:.4g} s, {t['bound']}-bound, MFU {t['mfu']:.3f}; "
            f"built in {r['lower_s']} + {r['compile_s']} s (CPU)")
    log(f"[dryrun] {len(recs)} records on the CPU, read {time.perf_counter() - t0:.1f} s after "
        "its start (it runs beside the training phases)")


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
    ap.add_argument("--shard-worker", choices=["stream", "lattice"],
                    help="a rank of the shard phase (REPRO_SHARD_* set by the phase); "
                         "prints no result line")
    ap.add_argument("--shard-device", default=None,
                    help="a shard rank's device (default: the backend rule's card)")
    ap.add_argument("--train-mesh-worker", metavar="SPEC",
                    help="a rank of the train_mesh phase (REPRO_SHARD_* set by the phase, "
                         "its jobs in the JSON file SPEC); prints no result line")
    ap.add_argument("--train-tp-worker", metavar="SPEC",
                    help="a rank of the train_tp phase (REPRO_SHARD_* set by the phase, its "
                         "settings in the JSON file SPEC); prints no result line")
    ap.add_argument("--dryrun-worker", metavar="DIR",
                    help="the dryrun phase's process: write its records to DIR; prints no "
                         "result line")
    args = ap.parse_args(argv)
    if args.crash_worker:
        return crash_worker(args.crash_worker, args.crash_device)
    if args.shard_worker:
        return shard_worker(args.shard_worker, args.shard_device)
    if args.train_mesh_worker:
        return train_mesh_worker(args.train_mesh_worker, args.shard_device)
    if args.train_tp_worker:
        return train_tp_worker(args.train_tp_worker, args.shard_device)
    if args.dryrun_worker:
        return dryrun_worker(args.dryrun_worker)
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
    dedup_launches = phase_dedup(dev)
    serving_launches = phase_serving(dev)
    shard_launches = phase_shard(dev)
    lm_launches = phase_lm(dev)
    families_launches = phase_lm_families(dev)
    import tempfile

    keep = Path(tempfile.mkdtemp(prefix=".chip_smoke_train_ckpt_", dir=ROOT))
    dry = start_dryrun()  # on the CPU, beside the training phases on the card
    train_launches, train = phase_train(dev, keep=keep)
    mesh_launches = phase_train_mesh(dev, train)
    tp_launches = phase_train_tp(dev, train)
    phase_dryrun(dry)
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
                      + stream_launches[name] + matchers_launches[name] + dedup_launches[name]
                      + serving_launches[name] + shard_launches[name] + lm_launches[name]
                      + families_launches[name] + train_launches[name]
                      + mesh_launches[name] + tp_launches[name]),
            launches_by_path={"pipeline": launches[name], "rules": rules_launches[name],
                              "parallel": parallel_launches[name],
                              "stream": stream_launches[name],
                              "matchers": matchers_launches[name],
                              "dedup": dedup_launches[name],
                              "serving": serving_launches[name],
                              "shard": shard_launches[name], "lm": lm_launches[name],
                              "lm_families": families_launches[name],
                              "train": train_launches[name],
                              "train_mesh": mesh_launches[name],
                              "train_tp": tp_launches[name]},
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
