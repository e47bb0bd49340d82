"""Grouped-query softmax attention: CUDA flash kernel and plain version.

    ``attention(q, k, v, scale, causal=True)``:
    q (B, S, H, hd), k/v (B, T, Hkv, hd) with H a multiple of Hkv
    (GQA groups of H // Hkv query heads per KV head) -> (B, S, H*hd)
    f32.  Inputs are bfloat16 or float32; scores, softmax and the
    output accumulate in f32.  Causal masking keeps ``row >= col``
    with both indices counted from 0 (top-left aligned, also when
    S != T).

Every prefill of the LM stack (``models.layers.attention_train``) goes
through it.  Two CUDA kernels replace the Pallas kernel
``src/repro/kernels/flash_attn/kernel.py``; :func:`route` picks one from
the input's dtype and head dim alone:

* ``"wgmma"``, ``csrc/flash_attn_sm90.cu``: bf16 inputs with hd 64 or 128
  (Yi-6B's and Qwen1.5's prefills), on the tensor cores with TMA loads;
* ``"fma"``, ``csrc/flash_attn.cu``: every other input it takes (f32, and
  hd 8, 16 or 32), with float32 FMAs.

Each source says what bounds it on the H100.  CPU tensors go to
:func:`attention_plain`.

Training: on CUDA tensors with grad mode on and an input that requires a
gradient, the kernel runs inside the autograd Function
:class:`FlashAttention`, whose backward is
:func:`attention_backward_blocked` (PyTorch ops in f32, a query block at
a time).  The reference has no backward kernel: its Pallas kernel has no
``custom_vjp``, and its models train through XLA's autodiff of blocked
attention computed outside any kernel and rematerialised a query block at
a time.  This backward is the port's counterpart of that computation.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import build
from repro_torch.kernels.common import check_operand, takes_plain

NEG_INF = -1e30
# query rows a block of the blocked backward (the reference's ATTN_Q_BLOCK)
Q_BLOCK = 1024

# head dims the kernel is instantiated for: 128 (Yi-6B), 64 (Qwen1.5),
# 8 and 16 (the embedding matcher's encoder and the smoke configs), 32
HEAD_DIMS = (8, 16, 32, 64, 128)
# head dims of the tensor-core kernel (bf16 only)
WGMMA_HEAD_DIMS = (64, 128)
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def route(dtype: torch.dtype, hd: int) -> str:
    """The CUDA kernel that takes a call: ``"wgmma"`` or ``"fma"``."""
    return "wgmma" if dtype == torch.bfloat16 and hd in WGMMA_HEAD_DIMS else "fma"


def attention_plain(q, k, v, scale, *, causal: bool = True):
    """Plain PyTorch version: the full (S, T) scores in f32."""
    B, S, H, hd = q.shape
    T, hkv = k.shape[1], k.shape[2]
    g = H // hkv
    qg = q.reshape(B, S, hkv, g, hd).float()
    s = torch.einsum("bskgh,btkh->bkgst", qg, k.float()) * scale
    if causal:
        rows = torch.arange(S, device=q.device)[:, None]
        cols = torch.arange(T, device=q.device)[None, :]
        s = torch.where(rows >= cols, s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bkgst,btkh->bskgh", p, v.float())
    return o.reshape(B, S, H * hd)


def attention_backward_blocked(q, k, v, o, do, scale, causal: bool = True,
                               q_block: int = Q_BLOCK):
    """dq, dk, dv of :func:`attention` given its output ``o`` and the output's
    gradient ``do`` (both (B, S, H*hd)), in f32, a block of ``q_block``
    query rows at a time: each block recomputes its scores, the causal mask
    (top-left aligned, as the kernel) and its softmax P over the keys it can
    see, then with ``D = rowsum(dO * O)``::

        dV += P^T dO,  dS = P * (dO V^T - D),  dQ = dS K scale,  dK += dS^T Q scale

    Each GQA group's query heads sum into their KV head's dk and dv.  The
    results are cast to the inputs' dtypes."""
    B, S, H, hd = q.shape
    T, hkv = k.shape[1], k.shape[2]
    g = H // hkv
    kf, vf = k.float(), v.float()
    o5 = o.float().reshape(B, S, hkv, g, hd)
    do5 = do.float().reshape(B, S, hkv, g, hd)
    D = (do5 * o5).sum(-1).permute(0, 2, 3, 1)  # (B, hkv, g, S)
    dq = torch.empty((B, S, hkv, g, hd), dtype=torch.float32, device=q.device)
    dk = torch.zeros((B, T, hkv, hd), dtype=torch.float32, device=q.device)
    dv = torch.zeros_like(dk)
    for s0 in range(0, S, q_block):
        s1 = min(s0 + q_block, S)
        t1 = min(s1, T) if causal else T  # row r sees columns 0..r
        qb = q[:, s0:s1].reshape(B, s1 - s0, hkv, g, hd).float()
        kb, vb, dob = kf[:, :t1], vf[:, :t1], do5[:, s0:s1]
        s = torch.einsum("bskgh,btkh->bkgst", qb, kb) * scale
        if causal:
            rows = torch.arange(s0, s1, device=q.device)[:, None]
            s = torch.where(rows >= torch.arange(t1, device=q.device)[None, :], s, NEG_INF)
        p = torch.softmax(s, dim=-1)
        dv[:, :t1] += torch.einsum("bkgst,bskgh->btkh", p, dob)
        dp = torch.einsum("bskgh,btkh->bkgst", dob, vb)
        ds = p * (dp - D[..., s0:s1, None])
        dq[:, s0:s1] = torch.einsum("bkgst,btkh->bskgh", ds, kb) * scale
        dk[:, :t1] += torch.einsum("bkgst,bskgh->btkh", ds, qb) * scale
    return dq.reshape(B, S, H, hd).to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


class FlashAttention(torch.autograd.Function):
    """The CUDA kernel forward, :func:`attention_backward_blocked` backward."""

    @staticmethod
    def forward(ctx, q, k, v, scale, causal):
        o = _launch(q, k, v, scale, causal)
        ctx.save_for_backward(q, k, v, o)
        ctx.scale, ctx.causal = scale, causal
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o = ctx.saved_tensors
        dq, dk, dv = attention_backward_blocked(q, k, v, o, do, ctx.scale, ctx.causal)
        return dq, dk, dv, None, None


def attention(q, k, v, scale, *, causal: bool = True):
    """q (B, S, H, hd), k/v (B, T, Hkv, hd) -> (B, S, H*hd) f32.

    On CUDA tensors with grad mode on and an input that requires a gradient,
    the launch runs inside :class:`FlashAttention`, so autograd follows it."""
    if takes_plain(q):
        return attention_plain(q, k, v, scale, causal=causal)
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad or v.requires_grad):
        return FlashAttention.apply(q, k, v, scale, causal)
    return _launch(q, k, v, scale, causal)


def _launch(q, k, v, scale, causal: bool):
    """Check the operands and launch the kernel of :func:`route`."""
    B, S, H, hd = q.shape
    T, hkv = k.shape[1], k.shape[2]
    if q.dtype not in _DTYPES:
        raise ValueError(f"q has dtype {q.dtype}; the kernel takes float32 or bfloat16")
    if hd not in HEAD_DIMS:
        raise ValueError(f"head_dim {hd} is not one of the kernel's {HEAD_DIMS}")
    if hkv == 0 or H % hkv:
        raise ValueError(f"{H} query heads do not form groups over {hkv} KV heads")
    check_operand("q", q, (B, S, H, hd), q.device, dtype=q.dtype)
    check_operand("k", k, (B, T, hkv, hd), q.device, dtype=q.dtype)
    check_operand("v", v, (B, T, hkv, hd), q.device, dtype=q.dtype)
    out = torch.empty((B, S, H * hd), dtype=torch.float32, device=q.device)
    if B * S * H == 0:
        return out
    if T == 0:
        raise ValueError("attention over zero keys")
    stream = torch.cuda.current_stream(q.device).cuda_stream
    if route(q.dtype, hd) == "wgmma":
        for name, t in (("q", q), ("k", k), ("v", v), ("out", out)):
            if t.data_ptr() % 16:
                raise ValueError(f"{name} is not 16-byte aligned, as the TMA loads need")
        rc = build.library().repro_flash_attn_sm90(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            B, S, T, H, hkv, hd, float(scale), int(causal), stream,
        )
        build.check("flash_attn (wgmma)", rc)
        attention.wgmma_launches += 1
    else:
        rc = build.library().repro_flash_attn(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            B, S, T, H, hkv, hd, float(scale), int(causal), _DTYPES[q.dtype], stream,
        )
        build.check("flash_attn", rc)
    attention.launches += 1
    return out


attention.launches = 0  # every launch, both routes
attention.wgmma_launches = 0  # the tensor-core route's share
