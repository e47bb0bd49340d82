"""How far each way of rounding the operands of the attention backward takes
dq, dk and dv from the exact gradient: one bf16 rounding of each float32
operand, the hi + lo bf16 split that ``csrc/flash_attn_bwd_sm90.cu`` used
until it took fp16 operands, and those fp16 operands with exact
power-of-two scales, the scheme the kernel computes now.

The tensor-core backward multiplies 16-bit operands.  q, k and v are bf16;
dO (the output's gradient), P (the recomputed softmax) and dS (P * (dP -
D)) are float32 and must be rounded.  The fp16 scheme scales each of q, k,
v and dO by a power of two, 2^(15 - E) with max |x| < 2^E (so the
conversion of q, k and v is exact and dO keeps 11 significant bits), P
(in [0, 1]) goes unscaled, and dS takes 2^(15 - E) with E from the bound
|dS| <= 2 hv max|dO| max|v| (|dP| and |D| are each at most hv max|dO|
max|v|, O being a mean of v's rows); D is summed from the float32 dO.  This
script emulates each choice in float64 on the CPU, on bf16-valued random
inputs at the training paths' head dims and sequence lengths (fewer heads
than the card runs: the error is a per-head matter), and prints max |d| /
max |ref| of dq, dk and dv against the exact gradient, the measure
``chip_smoke.py`` holds to 2e-3.  A scheme is taken only at or below 1e-3,
half the contract, at every shape.

    PYTHONPATH=src python tests/flash_bwd_rounding.py

It is a measurement, not a test: pytest does not collect it.
"""

from __future__ import annotations

import math

import numpy as np
import torch

# (label, B, S, T, H, Hkv, q.k dim, v dim, causal)
SHAPES = [
    ("Qwen1.5-0.5B train (2 of 16 heads, S 1,024)", 1, 1024, 1024, 2, 2, 64, 64, True),
    ("Moonlight train (2 of 16 heads, hd 128)", 1, 2048, 2048, 2, 2, 128, 128, True),
    ("Yi-6B (8 of 32 heads, 1 KV head, S 1,024)", 1, 1024, 1024, 8, 1, 128, 128, True),
    ("Whisper cross (4 of 16 heads)", 1, 32, 1500, 4, 4, 64, 64, False),
    ("MiniCPM3 MLA 96/64 (2 of 40 heads)", 1, 2048, 2048, 2, 2, 96, 64, True),
    ("MiniCPM3 MLA 96/64 prompt (1 of 40, S 4,096)", 1, 4096, 4096, 1, 1, 96, 64, True),
    ("train card vs CPU (4 of 16 heads)", 1, 256, 256, 4, 4, 64, 64, True),
    ("train_tp (1 of 8 heads)", 1, 2048, 2048, 1, 1, 64, 64, True),
]


def bf16(x):
    return x.to(torch.bfloat16).double()


def split(x):
    """hi + lo: the two bf16 parts the split multiplied (their sum)."""
    hi = bf16(x)
    return hi + bf16(x - hi)


def range_exp(amax: float) -> int:
    """e with amax * 2^e < 2^15: E such that amax < 2^E, then 15 - E."""
    return 0 if amax == 0 else 15 - (math.frexp(amax)[1])


def fp16(x, e: int):
    """x scaled by 2^e, rounded to fp16 (subnormals as the card rounds
    them), and scaled back."""
    return (x * 2.0**e).half().double() / 2.0**e


def gradients(q, k, v, do, scale, causal, scheme):
    """dq, dk, dv with the operands rounded as ``scheme`` says."""
    B, S, H, hq = q.shape
    T, hkv, hv = k.shape[1], k.shape[2], v.shape[-1]
    g = H // hkv
    do5 = do.reshape(B, S, hkv, g, hv)
    qg = q.reshape(B, S, hkv, g, hq)
    if scheme == "fp16":  # exact for bf16 q, k, v inside the range
        qg, k, v = (fp16(t, range_exp(float(t.abs().max()))) for t in (qg, k, v))
    s = torch.einsum("bskgh,btkh->bkgst", qg, k) * scale
    if causal:
        s = torch.where(torch.arange(S)[:, None] >= torch.arange(T)[None, :], s, -1e30)
    p = torch.softmax(s, -1)
    o = torch.einsum("bkgst,btkh->bskgh", p, v)
    D = (do5 * o).sum(-1).permute(0, 2, 3, 1)[..., None]  # from the float32 dO
    one = lambda x: x  # noqa: E731
    if scheme == "fp16":
        e_ds = 15 - (1 + math.ceil(math.log2(hv)) + math.frexp(float(do5.abs().max()))[1]
                     + math.frexp(float(v.abs().max()))[1])
        p_op, ds_op = (lambda x: x.half().double()), (lambda x: fp16(x, e_ds))
        dO = fp16(do5, range_exp(float(do5.abs().max())))
    elif scheme == "hi + lo":
        p_hi, do_hi = bf16(p), bf16(do5)
        p_lo, do_lo = bf16(p - p_hi), bf16(do5 - do_hi)
        dv = (torch.einsum("bkgst,bskgh->btkh", p_hi, do_hi + do_lo)
              + torch.einsum("bkgst,bskgh->btkh", p_lo, do_hi))  # lo x lo dropped
        ds = split(p * (torch.einsum("bskgh,btkh->bkgst", do_hi + do_lo, v) - D))
        return (torch.einsum("bkgst,btkh->bskgh", ds, k).reshape(B, S, H, hq) * scale,
                torch.einsum("bkgst,bskgh->btkh", ds, qg) * scale, dv)
    else:
        p_op, do_op, ds_op = {
            "exact": (one, one, one),
            "dO in one bf16": (one, bf16, one),
            "P in one bf16": (bf16, one, one),
            "dS in one bf16": (one, one, bf16),
            "all three in one bf16": (bf16, bf16, bf16),
        }[scheme]
        dO = do_op(do5)
    dv = torch.einsum("bkgst,bskgh->btkh", p_op(p), dO)
    ds = ds_op(p * (torch.einsum("bskgh,btkh->bkgst", dO, v) - D))
    dq = torch.einsum("bkgst,btkh->bskgh", ds, k) * scale
    dk = torch.einsum("bkgst,bskgh->btkh", ds, qg) * scale
    return dq.reshape(B, S, H, hq), dk, dv


def main() -> None:
    torch.set_num_threads(4)
    schemes = ["dO in one bf16", "P in one bf16", "dS in one bf16", "all three in one bf16",
               "hi + lo", "fp16"]
    print(f"{'shape':46s} {'operands':22s} dq / dk / dv: max |d| / max |ref|")
    for label, B, S, T, H, hkv, hq, hv, causal in SHAPES:
        rng = np.random.default_rng(5)
        q, k, v = (bf16(torch.as_tensor(rng.standard_normal((B, n, h, d)), dtype=torch.float32))
                   for n, h, d in [(S, H, hq), (T, hkv, hq), (T, hkv, hv)])
        do = torch.as_tensor(rng.standard_normal((B, S, H * hv)).astype(np.float32)).double()
        scale = 1.0 / np.sqrt(hq)
        want = gradients(q, k, v, do, scale, causal, "exact")
        for name in schemes:
            got = gradients(q, k, v, do, scale, causal, name)
            errs = [float((g - w).abs().max() / w.abs().max()) for g, w in zip(got, want)]
            print(f"{label:46s} {name:22s} " + " / ".join(f"{e:.2e}" for e in errs), flush=True)


if __name__ == "__main__":
    main()
