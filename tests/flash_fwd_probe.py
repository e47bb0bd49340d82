"""``flash_attn``'s tensor-core forward on the card at ``chip_smoke.py``'s
phase-2 shapes: for each, the largest difference from ``attention_plain``
(max |d| / max |ref|), whether two calls give the same bits, the call's
device ms (CUDA events around a CUDA graph of ``--iters`` calls, as phase 2
times it), SDPA's on the same inputs
(zero-padded to 128 at MLA's dims), and, under ``torch.profiler``, the
device time of each kernel of one call.

    python3 tests/flash_fwd_probe.py [--reps 3] [--iters 20] [--shapes NAME,...]

It imports ``repro_torch`` from the ``src`` beside this file, so the same
script run from an unpacked copy of another commit times that commit's
kernels (MLA at its own dims where that commit's forward has the (96, 64)
instance; the wrapper pads where it does not).  It is a measurement, not a
test: pytest does not collect it.
"""

from __future__ import annotations

import argparse
import ctypes
import subprocess
import sys
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parent.parent / "src"))

# (label, B, S, T, H, Hkv, hq, hv, causal): phase 2's tensor-core forward rows
SHAPES = {
    "minicpm3": ("MiniCPM3 train MLA", 4, 2048, 2048, 40, 40, 96, 64, True),
    "moonlight": ("Moonlight train", 4, 2048, 2048, 16, 16, 128, 128, True),
    "qwen": ("Qwen1.5-0.5B train", 4, 2048, 2048, 16, 16, 64, 64, True),
    "yi_long": ("Yi-6B prompt", 1, 4096, 4096, 32, 4, 128, 128, True),
    "minicpm3_long": ("MiniCPM3 prompt MLA", 1, 4096, 4096, 40, 40, 96, 64, True),
    "yi_train": ("Yi-6B train", 1, 2048, 2048, 32, 4, 128, 128, True),
    "train_tp": ("train_tp", 4, 2048, 2048, 8, 8, 64, 64, True),
    "yi_req": ("Yi-6B requests", 4, 32, 32, 32, 4, 128, 128, True),
    "cvc": ("train card vs CPU", 2, 256, 256, 16, 16, 64, 64, True),
    "minicpm3_req": ("MiniCPM3 requests MLA", 4, 32, 32, 40, 40, 96, 64, True),
    "minicpm3_cvc": ("MiniCPM3 card vs CPU MLA", 2, 256, 256, 40, 40, 96, 64, True),
    "whisper_enc": ("Whisper encoder", 4, 1500, 1500, 16, 16, 64, 64, False),
    "whisper_cross": ("Whisper cross", 4, 32, 1500, 16, 16, 64, 64, False),
}
KERNEL_TAGS = ("v16", "flash_attn_sm90", "Memset", "pad", "copy", "elementwise")


def inputs(dev, B, S, T, H, hkv, hq, hv, causal):
    import torch

    rng = np.random.default_rng(0)
    q, k, v = (torch.as_tensor(rng.standard_normal((B, n, h, d)).astype(np.float32),
                               device=dev).to(torch.bfloat16)
               for n, h, d in [(S, H, hq), (T, hkv, hq), (T, hkv, hv)])
    return q, k, v, 1.0 / np.sqrt(hq), causal


def graph_ms(fn, iters: int) -> float:
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def kernel_us(fn) -> dict:
    """Device microseconds of each kernel of one call of ``fn``."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    out = {}
    for e in prof.key_averages():
        t = getattr(e, "device_time_total", None) or getattr(e, "cuda_time_total", 0)
        tag = next((tag for tag in KERNEL_TAGS if tag in e.key), None)
        if tag is not None and t:
            out[tag] = out.get(tag, 0.0) + t
    return out


def main() -> int:
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels import build
    from repro_torch.kernels.flash_attn import ops as flash

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--shapes", type=lambda v: v.split(","), default=list(SHAPES))
    ap.add_argument("--ptxas-verbose", action="store_true")
    args = ap.parse_args()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip().splitlines()
    print(f"[probe] {Path(__file__).resolve().parent.parent}: {smi[0] if smi else 'no card'}")
    build.build(ptxas_verbose=args.ptxas_verbose)
    lib = build.library()
    if hasattr(lib, "repro_flash_attn_sm90_instances"):
        rows = (ctypes.c_int * 7 * 8)()
        n = lib.repro_flash_attn_sm90_instances(ctypes.addressof(rows), 8)
        for r in range(max(n, 0)):
            print("[probe] instance (%d, %d), fp16 copy %d: %d block(s) per SM, %d registers, "
                  "%d shared bytes, %d spilled bytes" % tuple(rows[r]), flush=True)
    dev = torch.device("cuda:0")
    for name in args.shapes:
        label, *shape = SHAPES[name]
        q, k, v, scale, causal = inputs(dev, *shape)
        want = flash.attention_plain(q, k, v, scale, causal=causal)
        fn = lambda: flash.attention(q, k, v, scale, causal=causal)  # noqa: E731
        got, again = fn(), fn()
        torch.cuda.synchronize()
        err = float((got.double() - want.double()).abs().max() / want.double().abs().max())
        times = [graph_ms(fn, args.iters) for _ in range(args.reps)]
        part = (f"err {err:.3g}, equal {torch.equal(got, again)}, ms "
                + " ".join(f"{t:.4f}" for t in times))
        del got, again
        hd = max(q.shape[-1], v.shape[-1])
        qp, kp, vp = (F.pad(t, (0, (128 if hd > 64 else 64) - t.shape[-1])).transpose(1, 2)
                      for t in (q, k, v))
        sdpa = lambda: F.scaled_dot_product_attention(  # noqa: E731
            qp, kp, vp, is_causal=causal, scale=scale, enable_gqa=True)
        sdpa_ms = min(graph_ms(sdpa, args.iters) for _ in range(args.reps))
        print(f"[probe] {label} {q.shape[-1]}/{v.shape[-1]}: " + part
              + f"; sdpa {sdpa_ms:.4f}; one call's kernels (us): "
              + ", ".join(f"{k_} {v_:.1f}" for k_, v_ in kernel_us(fn).items()), flush=True)
        del q, k, v, want, qp, kp, vp
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
