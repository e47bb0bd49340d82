"""Grouped-query softmax attention: CUDA flash kernel and plain version.

    ``attention(q, k, v, scale, causal=True)``:
    q (B, S, H, hq), k (B, T, Hkv, hq), v (B, T, Hkv, hv) with H a
    multiple of Hkv (GQA groups of H // Hkv query heads per KV head)
    -> (B, S, H*hv) f32.  Inputs are bfloat16 or float32; scores,
    softmax and the output accumulate in f32.  Causal masking keeps
    ``row >= col`` with both indices counted from 0 (top-left aligned,
    also when S != T).  hq and hv differ for MLA (96 and 64).

Every prefill of the LM stack (``models.layers.attend``) goes through
it.  Two CUDA kernels replace the Pallas kernel
``src/repro/kernels/flash_attn/kernel.py``; :func:`route` picks one from
the input's dtype and head dims alone:

* ``"wgmma"``, ``csrc/flash_attn_sm90.cu``: bf16 inputs with (hq, hv) =
  (64, 64) (Qwen1.5's prefills), (128, 128) (Yi-6B's) or MLA's own (96, 64)
  (:data:`WGMMA_DIMS`), unpadded, on the tensor cores with TMA loads: q.k
  in bf16, P.V once in fp16 against a copy of v scaled by a power of two
  a 64-key tile;
* ``"fma"``, ``csrc/flash_attn.cu``: every other input it takes (f32, and
  hd 8, 16 or 32), with float32 FMAs.

The FMA kernel takes one head dim from :data:`HEAD_DIMS` for q, k and v;
other dims (the smoke configs' 24 and 16, MLA's in f32) are zero-padded to
:func:`padded_dim`, which leaves q.k unchanged, and each head's first hv
output columns are kept.  :func:`forward_dims` says which kernel takes a
call at which dims; this module is the one place that pads.

Each source says what bounds it on the H100.  CPU tensors go to
:func:`attention_plain`.

Training: on CUDA tensors with grad mode on and an input that requires a
gradient, the kernel runs inside the autograd Function
:class:`FlashAttention`.  Its forward also writes each row's log-sum-exp
(``lse``, (B, H, S) f32; the serving path asks for none), and its
backward, :func:`attention_backward`, launches the route's backward
kernels, which recompute the softmax from ``lse``:

* ``"wgmma"``, ``csrc/flash_attn_bwd_sm90.cu``: dK/dV and dQ on the tensor
  cores, every operand in fp16 with an exact power-of-two scale (q, k, v
  and dO by their maxima, dS by its bound) that the kernels compute on the
  card; the forward's instances, unpadded;
* ``"fma"``, ``csrc/flash_attn_bwd.cu``: the same math in float32 FMAs, on
  the forward's padded dims.

Both write f32 gradients with no atomics (two calls give the same bits),
cast to the inputs' dtype by the Function.  The reference has no backward
kernel: its Pallas kernel has no ``custom_vjp``, and its models train
through XLA's autodiff of attention computed outside any kernel.
:func:`attention_backward_blocked` (PyTorch ops in f32, a query block at a
time) is the plain version of that gradient, and :func:`attention_lse_plain`
of the row statistics; the tests and ``chip_smoke.py`` compare the kernels
with them, and no path on the card calls them.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build
from repro_torch.kernels.common import check_operand, takes_plain

NEG_INF = -1e30
# query rows a block of the blocked backward (the reference's ATTN_Q_BLOCK)
Q_BLOCK = 1024

# head dims the FMA kernels are instantiated for: 8 and 16 (the embedding
# matcher's encoder and the smoke configs), 32, 64 and 128 (f32 inputs)
HEAD_DIMS = (8, 16, 32, 64, 128)
# (q.k dim, v dim) of the tensor-core kernels' instances, forward and
# backward: Qwen1.5's, Yi-6B's and MLA's own (MiniCPM3's 96 and 64), each
# taken unpadded
WGMMA_DIMS = ((64, 64), (128, 128), (96, 64))
# key rows of a tile of the tensor-core forward's fp16 copy of v, each with
# its own power-of-two scale
_V16_TILE = 64
# rows of the tensor-core backward's statistics tables: S rounded up to this
_STAT_ROWS = 128
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def route(dtype: torch.dtype, hq: int, hv: int | None = None) -> str:
    """The CUDA kernels that take a call of q.k dim ``hq`` and v dim ``hv``
    (``hq`` when not given): ``"wgmma"`` or ``"fma"``."""
    hv = hq if hv is None else hv
    return "wgmma" if dtype == torch.bfloat16 and (hq, hv) in WGMMA_DIMS else "fma"


def padded_dim(hq: int, hv: int) -> int:
    """The FMA kernels' head dim for q.k dim ``hq`` and v dim ``hv``: the
    smallest of :data:`HEAD_DIMS` that holds both."""
    fits = [d for d in HEAD_DIMS if d >= max(hq, hv)]
    if not fits:
        raise ValueError(f"head dims ({hq}, {hv}) exceed the kernels' {HEAD_DIMS[-1]}")
    return fits[0]


def forward_dims(dtype: torch.dtype, hq: int, hv: int) -> tuple[str, int, int]:
    """The forward kernel that takes a call of ``dtype``, q.k dim ``hq`` and
    v dim ``hv``, and the (q.k, v) dims it runs at: the tensor-core route's
    own instances as they are (MLA's (96, 64) unpadded), the FMA route at
    :func:`padded_dim` for both, where q, k and v are zero-padded and each
    head's first ``hv`` output columns kept."""
    if route(dtype, hq, hv) == "wgmma":
        return "wgmma", hq, hv
    if hq == hv and hq in HEAD_DIMS:
        return "fma", hq, hv
    hd = padded_dim(hq, hv)
    return "fma", hd, hd


def _pad_heads(t, hd: int):
    """``t`` (..., h) zero-padded to (..., hd), contiguous."""
    return torch.nn.functional.pad(t, (0, hd - t.shape[-1])).contiguous()


def _head_slice(x, heads: int, h: int):
    """Each head's first ``h`` columns of ``x`` (B, S, heads * hd), contiguous."""
    B, S, _ = x.shape
    return x.reshape(B, S, heads, -1)[..., :h].reshape(B, S, heads * h)


def attention_scores_plain(q, k, scale, *, causal: bool = True):
    """The scaled, masked scores in f32, (B, Hkv, G, S, T): query head
    ``kv * G + g`` of KV head ``kv``; masked entries hold ``NEG_INF``."""
    B, S, H, hd = q.shape
    T, hkv = k.shape[1], k.shape[2]
    qg = q.reshape(B, S, hkv, H // hkv, hd).float()
    s = torch.einsum("bskgh,btkh->bkgst", qg, k.float()) * scale
    if causal:
        rows = torch.arange(S, device=q.device)[:, None]
        cols = torch.arange(T, device=q.device)[None, :]
        s = torch.where(rows >= cols, s, NEG_INF)
    return s


def attention_plain(q, k, v, scale, *, causal: bool = True):
    """Plain PyTorch version: the full (S, T) scores in f32."""
    B, S, H, _ = q.shape
    p = torch.softmax(attention_scores_plain(q, k, scale, causal=causal), dim=-1)
    o = torch.einsum("bkgst,btkh->bskgh", p, v.float())
    return o.reshape(B, S, H * v.shape[-1])


def attention_lse_plain(q, k, v, scale, *, causal: bool = True):
    """Plain version of the forward's row statistics: each row's natural
    log-sum-exp of its scaled, masked scores, (B, H, S) f32 (``v`` is not
    read; the signature is :func:`attention`'s)."""
    B, S, H, _ = q.shape
    lse = torch.logsumexp(attention_scores_plain(q, k, scale, causal=causal), dim=-1)
    return lse.reshape(B, H, S)


def attention_backward_blocked(q, k, v, o, do, scale, causal: bool = True,
                               q_block: int = Q_BLOCK):
    """dq, dk, dv of :func:`attention` given its output ``o`` and the output's
    gradient ``do`` (both (B, S, H*hv)), in f32, a block of ``q_block``
    query rows at a time: each block recomputes its scores, the causal mask
    (top-left aligned, as the kernel) and its softmax P over the keys it can
    see, then with ``D = rowsum(dO * O)``::

        dV += P^T dO,  dS = P * (dO V^T - D),  dQ = dS K scale,  dK += dS^T Q scale

    Each GQA group's query heads sum into their KV head's dk and dv.  The
    results are cast to the inputs' dtypes."""
    B, S, H, hq = q.shape
    T, hkv, hv = k.shape[1], k.shape[2], v.shape[-1]
    g = H // hkv
    kf, vf = k.float(), v.float()
    o5 = o.float().reshape(B, S, hkv, g, hv)
    do5 = do.float().reshape(B, S, hkv, g, hv)
    D = (do5 * o5).sum(-1).permute(0, 2, 3, 1)  # (B, hkv, g, S)
    dq = torch.empty((B, S, hkv, g, hq), dtype=torch.float32, device=q.device)
    dk = torch.zeros((B, T, hkv, hq), dtype=torch.float32, device=q.device)
    dv = torch.zeros((B, T, hkv, hv), dtype=torch.float32, device=q.device)
    for s0 in range(0, S, q_block):
        s1 = min(s0 + q_block, S)
        t1 = min(s1, T) if causal else T  # row r sees columns 0..r
        qb = q[:, s0:s1].reshape(B, s1 - s0, hkv, g, hq).float()
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
    return dq.reshape(B, S, H, hq).to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


class FlashAttention(torch.autograd.Function):
    """The CUDA kernels forward (with the rows' log-sum-exp) and backward.
    It saves q, k, v and the output at their own head dims (MLA's
    unpadded), which the backward takes."""

    @staticmethod
    def forward(ctx, q, k, v, scale, causal):
        q, k, v = (t.contiguous() for t in (q, k, v))
        o, lse = attention_forward(q, k, v, scale, causal=causal)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.scale, ctx.causal = scale, causal
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        dq, dk, dv = attention_backward(q, k, v, o, lse, do.float().contiguous(), ctx.scale,
                                        ctx.causal)
        return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype), None, None


def attention_forward(q, k, v, scale, *, causal: bool = True):
    """:func:`attention`'s output (B, S, H*hv) and each row's log-sum-exp
    ((B, H, S) f32), the statistics :func:`attention_backward` reads: the
    forward kernel on CUDA tensors (at :func:`forward_dims`), the plain
    versions on CPU and ``meta`` tensors."""
    if takes_plain(q):
        return (attention_plain(q, k, v, scale, causal=causal),
                attention_lse_plain(q, k, v, scale, causal=causal))
    B, S, H, _ = q.shape
    lse = torch.empty((B, H, S), dtype=torch.float32, device=q.device)
    return _forward(q, k, v, scale, causal, lse=lse), lse


def attention_backward(q, k, v, o, lse, do, scale, causal: bool = True):
    """dq (B, S, H, hq), dk (B, T, Hkv, hq), dv (B, T, Hkv, hv) in f32 of
    :func:`attention`, given its output ``o``, the output's gradient ``do``
    (both (B, S, H*hv) f32) and the forward's row log-sum-exp ``lse`` (B,
    H, S).

    CUDA tensors launch the backward kernels of :func:`route`, or raise:
    the tensor-core backward on q, k, v as they are ((hq, hv) one of
    :data:`WGMMA_DIMS`), the FMA one on them padded to
    :func:`padded_dim`.  CPU and ``meta`` tensors take the plain version,
    :func:`attention_backward_blocked` on f32 copies (``lse`` unused)."""
    if takes_plain(q):
        return attention_backward_blocked(q.float(), k.float(), v.float(), o, do, scale, causal)
    B, S, H, hq = q.shape
    T, hkv, hv = k.shape[1], k.shape[2], v.shape[-1]
    wgmma = route(q.dtype, hq, hv) == "wgmma"
    if not wgmma and (hq != hv or hq not in HEAD_DIMS):
        hd = padded_dim(hq, hv)
        check_operand("o", o, (B, S, H * hv), q.device)
        check_operand("do", do, (B, S, H * hv), q.device)
        dq, dk, dv = attention_backward(
            *(_pad_heads(t, hd) for t in (q, k, v)),
            _pad_heads(o.reshape(B, S, H, hv), hd).reshape(B, S, H * hd), lse,
            _pad_heads(do.reshape(B, S, H, hv), hd).reshape(B, S, H * hd), scale, causal)
        return (dq[..., :hq].contiguous(), dk[..., :hq].contiguous(),
                dv[..., :hv].contiguous())
    _check(q, k, v, WGMMA_DIMS if wgmma else None)
    check_operand("o", o, (B, S, H * hv), q.device)
    check_operand("do", do, (B, S, H * hv), q.device)
    check_operand("lse", lse, (B, H, S), q.device)
    f32 = dict(dtype=torch.float32, device=q.device)
    dq, dk, dv = (torch.empty(s, **f32) for s in [(B, S, H, hq), (B, T, hkv, hq), (B, T, hkv, hv)])
    if B * S * H == 0 or T == 0:
        return dq.zero_(), dk.zero_(), dv.zero_()
    stream = torch.cuda.current_stream(q.device).cuda_stream
    if wgmma:
        # D and lse * log2(e), each (B, H, S rounded up to _STAT_ROWS); the
        # operands' scaled fp16 copies; their four maxima
        stats = torch.empty((2, B, H, -(-S // _STAT_ROWS) * _STAT_ROWS), **f32)
        f16 = dict(dtype=torch.float16, device=q.device)
        q16, do16 = torch.empty(q.shape, **f16), torch.empty((B, S, H, hv), **f16)
        amax = torch.empty(4, dtype=torch.int32, device=q.device)
        # the kernels' plan from the shapes: whether the dQ kernel streams
        # fp16 copies of k and v, and how many partial dq it sums
        lib = build.library()
        plan = (ctypes.c_int * 2)()
        lib.repro_flash_attn_bwd_sm90_plan(B, S, T, H, hkv, hq, ctypes.addressof(plan))
        kv16, split = plan
        k16, v16 = (torch.empty(t.shape, **f16) if kv16 else None for t in (k, v))
        parts = torch.empty((split, B, S, H, hq), **f32) if split > 1 else None
        scratch = dict(q16=q16, do16=do16, amax=amax, stats=stats, k16=k16, v16=v16, parts=parts)
        _aligned(q=q, k=k, v=v, o=o, do=do, dq=dq, dk=dk, dv=dv,
                 **{n: t for n, t in scratch.items() if t is not None})
        rc = lib.repro_flash_attn_bwd_sm90(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), do.data_ptr(),
            lse.data_ptr(), stats[0].data_ptr(), stats[1].data_ptr(), q16.data_ptr(),
            *(0 if t is None else t.data_ptr() for t in (k16, v16)), do16.data_ptr(),
            amax.data_ptr(), 0 if parts is None else parts.data_ptr(), dq.data_ptr(),
            dk.data_ptr(), dv.data_ptr(), B, S, T, H, hkv, hq, hv, float(scale), int(causal),
            stream,
        )
        build.check("flash_attn backward (wgmma)", rc)
        attention.wgmma_backward_launches += 1
        if hq != hv:
            attention.mla_backward_launches += 1
    else:
        D = torch.empty((B, H, S), **f32)
        rc = build.library().repro_flash_attn_bwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), do.data_ptr(),
            lse.data_ptr(), D.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
            B, S, T, H, hkv, hq, float(scale), int(causal), _DTYPES[q.dtype], stream,
        )
        build.check("flash_attn backward", rc)
    attention.backward_launches += 1
    return dq, dk, dv


def attention(q, k, v, scale, *, causal: bool = True):
    """q (B, S, H, hq), k (B, T, Hkv, hq), v (B, T, Hkv, hv) -> (B, S, H*hv)
    f32.

    On CUDA tensors with grad mode on and an input that requires a gradient,
    the launch runs inside :class:`FlashAttention`, so autograd follows it."""
    if takes_plain(q):
        return attention_plain(q, k, v, scale, causal=causal)
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad or v.requires_grad):
        return FlashAttention.apply(q, k, v, scale, causal)
    return _forward(q, k, v, scale, causal)


def _check(q, k, v, dims=None) -> None:
    """Raise unless q, k and v are what the kernels take: (hq, hv) one of
    ``dims``, or with ``dims`` None one head dim of :data:`HEAD_DIMS`."""
    B, S, H, hq = q.shape
    T, hkv, hv = k.shape[1], k.shape[2], v.shape[-1]
    if q.dtype not in _DTYPES:
        raise ValueError(f"q has dtype {q.dtype}; the kernel takes float32 or bfloat16")
    if dims is None and (hq != hv or hq not in HEAD_DIMS):
        raise ValueError(f"head dims ({hq}, {hv}) are not one of the kernel's {HEAD_DIMS}")
    if dims is not None and (hq, hv) not in dims:
        raise ValueError(f"head dims ({hq}, {hv}) are not one of the kernel's {dims}")
    if hkv == 0 or H % hkv:
        raise ValueError(f"{H} query heads do not form groups over {hkv} KV heads")
    check_operand("q", q, (B, S, H, hq), q.device, dtype=q.dtype)
    check_operand("k", k, (B, T, hkv, hq), q.device, dtype=q.dtype)
    check_operand("v", v, (B, T, hkv, hv), q.device, dtype=q.dtype)


def _aligned(**tensors) -> None:
    for name, t in tensors.items():
        if t.data_ptr() % 16:
            raise ValueError(f"{name} is not 16-byte aligned, as the TMA loads need")


def _forward(q, k, v, scale, causal: bool, lse=None):
    """:func:`_launch` at :func:`forward_dims`: on q, k, v as they are
    (contiguous: MLA's v is a view of its key-value projection), or padded
    for the FMA kernel and each head's first hv output columns."""
    hq, hv = q.shape[-1], v.shape[-1]
    _, dq_, dv_ = forward_dims(q.dtype, hq, hv)
    if (dq_, dv_) == (hq, hv):
        return _launch(*(t.contiguous() for t in (q, k, v)), scale, causal, lse=lse)
    out = _launch(*(_pad_heads(t, dq_) for t in (q, k, v)), scale, causal, lse=lse)
    return _head_slice(out, q.shape[2], hv)


def _launch(q, k, v, scale, causal: bool, lse=None):
    """Check the operands and launch the kernel of :func:`route`; with
    ``lse`` ((B, H, S) f32) the kernel also writes each row's log-sum-exp.
    The tensor-core kernel takes scratch for its fp16 copy of v and each
    key tile's scale exponent."""
    B, S, H, hq = q.shape
    T, hkv, hv = k.shape[1], k.shape[2], v.shape[-1]
    wgmma = route(q.dtype, hq, hv) == "wgmma"
    _check(q, k, v, WGMMA_DIMS if wgmma else None)
    if lse is not None:
        check_operand("lse", lse, (B, H, S), q.device)
    out = torch.empty((B, S, H * hv), dtype=torch.float32, device=q.device)
    if B * S * H == 0:
        return out
    if T == 0:
        raise ValueError("attention over zero keys")
    stream = torch.cuda.current_stream(q.device).cuda_stream
    lse_ptr = 0 if lse is None else lse.data_ptr()
    if wgmma:
        # the kernel's plan from the shapes: an fp16 copy of v, each key tile
        # with its scale exponent, or v converted in shared memory
        lib = build.library()
        v16 = vexp = None
        if lib.repro_flash_attn_sm90_plan(B, S, H):
            v16 = torch.empty(v.shape, dtype=torch.float16, device=q.device)
            vexp = torch.empty(B * hkv * -(-T // _V16_TILE), dtype=torch.int32, device=q.device)
            _aligned(v16=v16)
        _aligned(q=q, k=k, v=v, out=out)
        rc = lib.repro_flash_attn_sm90(
            q.data_ptr(), k.data_ptr(), v.data_ptr(),
            *(0 if t is None else t.data_ptr() for t in (v16, vexp)),
            out.data_ptr(), lse_ptr, B, S, T, H, hkv, hq, hv, float(scale), int(causal), stream,
        )
        build.check("flash_attn (wgmma)", rc)
        attention.wgmma_launches += 1
        if hq != hv:
            attention.mla_forward_launches += 1
    else:
        rc = build.library().repro_flash_attn(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), lse_ptr,
            B, S, T, H, hkv, hq, float(scale), int(causal), _DTYPES[q.dtype], stream,
        )
        build.check("flash_attn", rc)
    attention.launches += 1
    return out


attention.launches = 0  # every forward launch, both routes
attention.wgmma_launches = 0  # the tensor-core route's share
attention.backward_launches = 0  # every attention_backward launch, both routes
attention.wgmma_backward_launches = 0  # the tensor-core backward's share
attention.mla_forward_launches = 0  # the tensor-core forward's (96, 64) instance
attention.mla_backward_launches = 0  # the tensor-core backward's (96, 64) instance
