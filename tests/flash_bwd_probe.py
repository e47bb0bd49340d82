"""Where ``flash_attn``'s tensor-core backward spends its time on the card: for
each training shape of ``chip_smoke.py``'s phase 2, the whole
``attention_backward`` call (device ms: CUDA events around a CUDA graph of
``--iters`` calls, as phase 2 times it) and, under ``torch.profiler``, the
device time of each of its kernels (the passes before dK/dV, dK/dV, dQ)
in one call.

    python3 tests/flash_bwd_probe.py [--reps 3] [--iters 20] [--shapes NAME,...]

It imports ``repro_torch`` from the ``src`` beside this file, so the same
script run from an unpacked copy of another commit times that commit's
kernels (phase 2's inputs; MLA unpadded where that commit's wrapper takes
unequal dims, padded to 128 where it does not).  It is a measurement, not a
test: pytest does not collect it.
"""

from __future__ import annotations

import argparse
import subprocess
import sys
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parent.parent / "src"))

# (label, B, S, T, H, Hkv, hq, hv, causal): phase 2's tensor-core rows
SHAPES = {
    "qwen": ("Qwen1.5-0.5B train", 4, 2048, 2048, 16, 16, 64, 64, True),
    "moonlight": ("Moonlight train", 4, 2048, 2048, 16, 16, 128, 128, True),
    "minicpm3": ("MiniCPM3 train MLA", 4, 2048, 2048, 40, 40, 96, 64, True),
    "minicpm3_long": ("MiniCPM3 MLA", 1, 4096, 4096, 40, 40, 96, 64, True),
    "yi": ("Yi-6B", 1, 2048, 2048, 32, 4, 128, 128, True),
    "train_tp": ("train_tp", 4, 2048, 2048, 8, 8, 64, 64, True),
    "whisper": ("Whisper cross", 4, 32, 1500, 16, 16, 64, 64, False),
    "train_cvc": ("train card vs CPU", 2, 256, 256, 16, 16, 64, 64, True),
    "moonlight_cvc": ("Moonlight card vs CPU", 2, 256, 256, 16, 16, 128, 128, True),
    "minicpm3_cvc": ("MiniCPM3 card vs CPU MLA", 2, 256, 256, 40, 40, 96, 64, True),
}


# the backward's kernels by a part of their names (both designs' names)
KERNEL_TAGS = ("Memset", "memset", "amax", "convert", "rows", "prep", "dkdv", "dq_kernel", "sum")


def inputs(dev, B, S, T, H, hkv, hq, hv, causal):
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels.flash_attn import ops as flash

    rng = np.random.default_rng(5)
    q, k, v = (torch.as_tensor(rng.standard_normal((B, n, h, d)).astype(np.float32),
                               device=dev).to(torch.bfloat16)
               for n, h, d in [(S, H, hq), (T, hkv, hq), (T, hkv, hv)])
    do = torch.as_tensor(rng.standard_normal((B, S, H * hv)).astype(np.float32), device=dev)
    scale = 1.0 / np.sqrt(hq)
    dims = getattr(flash, "WGMMA_DIMS", getattr(flash, "WGMMA_BWD_DIMS", ()))
    if hq != hv and (hq, hv) not in dims:
        hd = 128  # a wrapper without the native instance: MLA padded, as its attend did
        q, k, v = (F.pad(t, (0, hd - t.shape[-1])).contiguous() for t in (q, k, v))
        do = F.pad(do.reshape(B, S, H, hv), (0, hd - hv)).reshape(B, S, H * hd).contiguous()
    o, lse = flash.attention_forward(q, k, v, scale, causal=causal)
    return (q, k, v, o, lse, do, scale, causal)


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


def timeline(fn, path: Path) -> str:
    """Each kernel of one call of ``fn`` inside a CUDA graph replay: its
    start after the first kernel's and its duration, in microseconds, from
    ``torch.profiler``'s trace (written to ``path``)."""
    import json

    import torch
    from torch.profiler import ProfilerActivity, profile

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        fn()
    graph.replay()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        graph.replay()
        torch.cuda.synchronize()
    prof.export_chrome_trace(str(path))
    events = [e for e in json.loads(path.read_text())["traceEvents"]
              if e.get("cat") == "kernel" or e.get("cat") == "gpu_memset"]
    events.sort(key=lambda e: e["ts"])
    t0 = events[0]["ts"] if events else 0
    return "; ".join(f"{next((t for t in KERNEL_TAGS if t in e['name']), e['name'][:20])} "
                     f"+{e['ts'] - t0:.1f} ({e['dur']:.1f})" for e in events)


def main() -> int:
    import torch

    from repro_torch.kernels.flash_attn import ops as flash

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--shapes", type=lambda v: v.split(","), default=list(SHAPES))
    ap.add_argument("--timeline", action="store_true",
                    help="also print one graph-replayed call's kernels: start (duration), us")
    args = ap.parse_args()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip().splitlines()
    print(f"[probe] {Path(__file__).resolve().parent.parent}: {smi[0] if smi else 'no card'}")
    dev = torch.device("cuda:0")
    for name in args.shapes:
        label, *shape = SHAPES[name]
        a = inputs(dev, *shape)
        fn = lambda: flash.attention_backward(*a)  # noqa: E731
        times = [graph_ms(fn, args.iters) for _ in range(args.reps)]
        parts = kernel_us(fn)
        print(f"[probe] {label}: {a[0].shape[-1]}/{a[2].shape[-1]} ms "
              + " ".join(f"{t:.4f}" for t in times) + "; one call's kernels (us): "
              + ", ".join(f"{k} {v:.1f}" for k, v in parts.items()), flush=True)
        if args.timeline:
            out = Path(__file__).resolve().parent.parent / "chiprun_out"
            out.mkdir(exist_ok=True)
            print(f"[probe] {label} timeline: " + timeline(fn, out / f"probe_{name}.json"),
                  flush=True)
        del a, fn
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
