"""Serving launcher: ``python -m repro_torch.launch.serve --arch <id> ...``

Random-weight serving driver around :class:`repro_torch.serve.engine.Engine`:
``--requests`` prompts of ``--prompt-len`` random tokens, served in
batches of ``--batch`` with ``--max-new`` greedy tokens each.  It runs on
CUDA unless ``--device cpu`` is given; the first prefill builds the
CUDA kernels.  ``--smoke`` serves the architecture's reduced config.

The reference's ``--em`` mode (the sharded entity-resolution service)
is not ported yet (``ROADMAP.md`` Queue 1 item 9).
"""

from __future__ import annotations

import argparse
import sys
import time

import numpy as np


def main(argv=None) -> list[list[int]]:
    """Serve the requests, print the reference's summary line, and
    return the generated tokens of each request."""
    argv = sys.argv[1:] if argv is None else list(argv)
    from repro_torch.models.layers import unported

    if "--em" in argv:
        raise unported("the sharded entity-resolution service (--em)", item=9)

    from repro_torch.configs.base import ARCH_IDS, get_config, smoke_config
    from repro_torch.models.registry import get_model
    from repro_torch.serve.engine import demo_engine

    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True, choices=ARCH_IDS)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--s-max", type=int, default=128)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--device", default=None, help="torch device (default: cuda)")
    args = ap.parse_args(argv)

    cfg = smoke_config(args.arch) if args.smoke else get_config(args.arch)
    api = get_model(cfg)
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
