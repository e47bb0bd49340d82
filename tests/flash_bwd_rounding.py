"""How far one bf16 rounding of each float32 operand of the attention
backward takes dq, dk and dv from the exact gradient, and how far the hi +
lo split that ``csrc/flash_attn_bwd_sm90.cu`` uses does.

The tensor-core backward multiplies bf16 operands.  q, k and v are bf16
already; dO (the output's gradient), P (the recomputed softmax) and dS
(P * (dP - D)) are float32 and must be rounded.  This script emulates each
choice in float64 on the CPU, on bf16-valued random inputs at the training
paths' head dims and sequence lengths (fewer heads than the card runs: the
error is a per-head matter), and prints max |d| / max |ref| of dq, dk and dv
against the exact gradient, the measure ``chip_smoke.py`` holds to 2e-3.

    PYTHONPATH=src python tests/flash_bwd_rounding.py

It is a measurement, not a test: pytest does not collect it.
"""

from __future__ import annotations

import numpy as np
import torch

# (label, B, S, T, H, Hkv, hd, causal, MLA (q.k dim, v dim))
SHAPES = [
    ("Qwen1.5-0.5B train (2 of 16 heads, S 1,024)", 1, 1024, 1024, 2, 2, 64, True, None),
    ("Yi-6B (8 of 32 heads, 1 KV head, S 1,024)", 1, 1024, 1024, 8, 1, 128, True, None),
    ("Whisper cross (4 of 16 heads)", 1, 32, 1500, 4, 4, 64, False, None),
    ("MiniCPM3 MLA 96/64 (2 of 40 heads, S 1,024)", 1, 1024, 1024, 2, 2, 128, True, (96, 64)),
    ("train card vs CPU (4 of 16 heads)", 1, 256, 256, 4, 4, 64, True, None),
    ("train_tp (1 of 8 heads)", 1, 2048, 2048, 1, 1, 64, True, None),
]


def bf16(x):
    return x.to(torch.bfloat16).double()


def split(x):
    """hi + lo: the two bf16 parts the kernel multiplies (their sum)."""
    hi = bf16(x)
    return hi + bf16(x - hi)


def gradients(q, k, v, do, scale, causal, p_op, do_op, ds_op, dv_split_p_lo_do_lo):
    """dq, dk, dv with P, dO and dS passed through the given roundings."""
    B, S, H, hd = q.shape
    T, hkv = k.shape[1], k.shape[2]
    qg = q.reshape(B, S, hkv, H // hkv, hd)
    s = torch.einsum("bskgh,btkh->bkgst", qg, k) * scale
    if causal:
        s = torch.where(torch.arange(S)[:, None] >= torch.arange(T)[None, :], s, -1e30)
    p = torch.softmax(s, -1)
    do5 = do.reshape(B, S, hkv, H // hkv, -1)
    o = torch.einsum("bkgst,btkh->bskgh", p, v)
    D = (do5 * o).sum(-1).permute(0, 2, 3, 1)[..., None]
    dO = do_op(do5)
    if dv_split_p_lo_do_lo:  # the kernel's dV: P_hi dO_hi + P_hi dO_lo + P_lo dO_hi
        p_hi, do_hi = bf16(p), bf16(do5)
        p_lo, do_lo = bf16(p - p_hi), bf16(do5 - do_hi)
        dv = (torch.einsum("bkgst,bskgh->btkh", p_hi, do_hi + do_lo)
              + torch.einsum("bkgst,bskgh->btkh", p_lo, do_hi))
    else:
        dv = torch.einsum("bkgst,bskgh->btkh", p_op(p), dO)
    ds = ds_op(p * (torch.einsum("bskgh,btkh->bkgst", dO, v) - D))
    dq = torch.einsum("bkgst,btkh->bskgh", ds, k) * scale
    dk = torch.einsum("bkgst,bskgh->btkh", ds, qg) * scale
    return dq, dk, dv


def main() -> None:
    torch.set_num_threads(4)
    exact = (lambda x: x, lambda x: x, lambda x: x, False)
    variants = {
        "dO in one bf16": (lambda x: x, bf16, lambda x: x, False),
        "P in one bf16": (bf16, lambda x: x, lambda x: x, False),
        "dS in one bf16": (lambda x: x, lambda x: x, bf16, False),
        "all three in one bf16": (bf16, bf16, bf16, False),
        "the kernel: hi + lo": (None, split, split, True),
    }
    print(f"{'shape':48s} {'operands':24s} dq / dk / dv: max |d| / max |ref|")
    for label, B, S, T, H, hkv, hd, causal, mla in SHAPES:
        rng = np.random.default_rng(5)
        hq, hv = mla or (hd, hd)
        q, k, v = (bf16(torch.as_tensor(rng.standard_normal((B, n, h, d)), dtype=torch.float32))
                   for n, h, d in [(S, H, hq), (T, hkv, hq), (T, hkv, hv)])
        do = torch.as_tensor(rng.standard_normal((B, S, H * hv)).astype(np.float32)).double()
        scale = 1.0 / np.sqrt(hq)
        want = gradients(q, k, v, do, scale, causal, *exact)
        for name, ops in variants.items():
            got = gradients(q, k, v, do, scale, causal, *ops)
            errs = [float((g - w).abs().max() / w.abs().max()) for g, w in zip(got, want)]
            print(f"{label:48s} {name:24s} " + " / ".join(f"{e:.2e}" for e in errs), flush=True)


if __name__ == "__main__":
    main()
