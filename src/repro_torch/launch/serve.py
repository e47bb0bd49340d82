"""Serving launcher: ``python -m repro_torch.launch.serve --arch <id> ...``

Random-weight serving driver around :class:`repro_torch.serve.engine.Engine`:
``--requests`` prompts of ``--prompt-len`` random tokens, served in
batches of ``--batch`` with ``--max-new`` greedy tokens each.  It runs on
CUDA unless ``--device cpu`` is given; the first prefill builds the
CUDA kernels.  ``--smoke`` serves the architecture's reduced config;
``--layers N`` keeps the config's widths and serves its first N layers
(a depth cut, where the full model's weights do not fit the card).  The
dense, MoE, MLA, VLM (text prompts) and SSM families serve; the hybrid
and encoder-decoder families have no prefill, so it exits, as the
reference's launcher does.

``--em`` switches to the sharded entity-resolution service instead: one
:class:`repro_torch.stream.shard.ShardCoordinator` replica a process.
Run it once a rank with ``REPRO_SHARD_COORD`` / ``REPRO_SHARD_N`` /
``REPRO_SHARD_ID`` set (see :mod:`repro_torch.launch.mesh` for the
backend rule); a bare single-process invocation serves the unsharded
one-shard case.  It exits 1 when the replicas' digests differ.
"""

from __future__ import annotations

import argparse
import sys
import time

import numpy as np


def em_main(argv=None) -> str:
    """Serve a HEPTH-like stream through this rank's shard, print the
    reference's summary line, and return the state digest."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--em", action="store_true")
    ap.add_argument("--scheme", default="smp", choices=["smp", "mmp"])
    ap.add_argument("--scale", type=float, default=0.05)
    ap.add_argument("--batches", type=int, default=6)
    ap.add_argument("--shards", type=int, default=None)
    ap.add_argument("--device", default=None, help="torch device (default: the rank's card)")
    args = ap.parse_args(argv)

    from repro_torch.data.synthetic import SynthConfig, arrival_stream, make_dataset
    from repro_torch.stream.service import ServiceConfig
    from repro_torch.stream.shard import ShardContext, ShardCoordinator

    ctx = ShardContext.create(args.shards, device=args.device)
    coord = ShardCoordinator(ctx, config=ServiceConfig(scheme=args.scheme, parallel=True))
    ds = make_dataset(SynthConfig.hepth(scale=args.scale, seed=7))
    t0 = time.perf_counter()
    n_refs = 0
    for b in arrival_stream(ds, n_batches=args.batches):
        coord.ingest(list(b.names), b.edges)
        n_refs += len(b.names)
    dt = time.perf_counter() - t0
    agree = coord.digests_agree()
    digest = coord.digest()
    print(
        f"shard {ctx.shard_id}/{ctx.n_shards}: {n_refs} refs in {dt:.2f}s "
        f"({n_refs / dt:.1f} refs/s), "
        f"{len(coord.snapshot().clusters())} clusters, "
        f"digest {digest[:12]} "
        f"({'replicas agree' if agree else 'REPLICA DIVERGENCE'})",
        flush=True,
    )
    if not agree:
        raise SystemExit(1)
    return digest


def main(argv=None) -> list[list[int]] | str:
    """Serve the requests, print the reference's summary line, and
    return the generated tokens of each request (``--em``: the state
    digest)."""
    argv = sys.argv[1:] if argv is None else list(argv)
    if "--em" in argv:
        return em_main(argv)

    import dataclasses

    from repro_torch.configs.base import ARCH_IDS, get_config, smoke_config
    from repro_torch.models.registry import get_model
    from repro_torch.serve.engine import demo_engine

    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True, choices=ARCH_IDS)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--layers", type=int, default=None,
                    help="serve only the first N layers (default: all of the config's)")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--s-max", type=int, default=128)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--device", default=None, help="torch device (default: cuda)")
    args = ap.parse_args(argv)

    cfg = smoke_config(args.arch) if args.smoke else get_config(args.arch)
    if args.layers is not None:
        cfg = dataclasses.replace(cfg, n_layers=args.layers)
    api = get_model(cfg)
    if api.prefill is None:
        raise SystemExit(f"{cfg.name} ({cfg.family}) has no prefill path")
    engine = demo_engine(api, batch=args.batch, s_max=args.s_max, device=args.device)

    rng = np.random.default_rng(0)
    prompts = [
        rng.integers(1, cfg.vocab_size - 1, size=args.prompt_len).astype(np.int32)
        for _ in range(args.requests)
    ]
    t0 = time.perf_counter()
    outs = engine.generate(prompts, max_new=args.max_new)
    dt = time.perf_counter() - t0
    total = sum(len(o) for o in outs)
    print(f"{cfg.name}: {len(prompts)} requests, {total} tokens, "
          f"{dt:.2f}s ({total/dt:.1f} tok/s incl. compile)")
    return outs


if __name__ == "__main__":
    main()
