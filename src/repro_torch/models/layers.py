"""Transformer building blocks (bf16 compute): GQA, MLA and cross
attention, RoPE and M-RoPE, RMSNorm and LayerNorm, the MLP.

Conventions, the reference's (``repro.models.layers``):
  * parameters are read as ``p[name]``, from a plain dict of tensors or
    from the model's modules (:class:`repro_torch.models.transformer.
    DecoderLM`), which hold the same names;
  * activations are bf16; norms, RoPE, the SiLU gate, softmax and the
    logits are computed in f32 and cast back;
  * attention keeps an explicit GQA grouping (no repeated KV heads);
    every full-sequence attention runs the ``flash_attn`` kernel;
  * decode uses a KV cache ``[B, n_kv, S_max, hd]`` written at ``pos[0]``.

**Tensor parallelism.** Over a ``DeviceMesh`` with a ``model`` axis the
parameters are DTensors laid out by their specs (``launch/sharding.py``
``param_shardings``): q/k/v and up projections on their columns, o/down
projections on their rows, the embedding on its vocabulary.  The layer
functions run on DTensors as they are; DTensor's sharding propagation
places the collectives, as the reference's compiler does.  Where that
would gather what need not be gathered, the work runs on each rank's
shards (``local_map``) or reduces explicitly: :func:`attend` (the
``flash_attn`` kernel on whole heads a rank), :func:`embed_lookup` (each
rank looks up the ids of its vocabulary rows; the partial sums add one
nonzero row to zeros, so the result is the whole table's),
:func:`softmax_xent` (the gold logits and ``logsumexp`` from the
vocabulary shards), :func:`row_project` (the row-parallel sums),
:func:`gated` (the fused gate/up weight) and the decode steps over a
model-sharded cache (:func:`_decode_sharded`, :func:`_mla_latent_sharded`).

The activation pins are the reference's: :func:`use_mesh` sets the
ambient mesh (the counterpart of ``jax.set_mesh``), and
:func:`shard_spec` / :func:`shard_batch` ``redistribute`` a DTensor to
the placements the reference's rules choose, under the module switches
``DP_OVER_MODEL`` and ``SEQ_SHARD_BOUNDARY``.  Without a mesh, or on a
plain tensor, they return their input.
"""

from __future__ import annotations

import contextlib
import contextvars
import functools
import math
import os

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.flash_attn import ops as flash
from repro_torch.models.param import PSpec, in_bf16

COMPUTE_DTYPE = torch.bfloat16
NEG_INF = -1e9

# CPU tensors longer than this take the query-block-chunked plain path
# (a (q_block, T) score tile live at a time instead of (S, T)); CUDA
# tensors always take the flash kernel.
ATTN_CHUNK_THRESHOLD = int(os.environ.get("REPRO_ATTN_CHUNK_THRESHOLD", 4096))
ATTN_Q_BLOCK = int(os.environ.get("REPRO_ATTN_Q_BLOCK", 1024))


# ---------------------------------------------------------------------------
# The ambient mesh and the activation pins
# ---------------------------------------------------------------------------

# Pure-DP layout (launcher-owned): the tensor axis carries batch too.
DP_OVER_MODEL = False

# Megatron-style sequence parallelism at layer boundaries: the residual
# stream is pinned (dp, model, None).  Module-level because model code is
# mesh-agnostic; the dry run owns the policy (off by default, as in the
# reference, where it was measured to double the FLOPs).
SEQ_SHARD_BOUNDARY = False

_AMBIENT = contextvars.ContextVar("repro_torch_ambient_mesh", default=None)


@contextlib.contextmanager
def use_mesh(mesh):
    """Make ``mesh`` (a ``DeviceMesh``, or ``None``) the ambient mesh for the
    duration of the block: the counterpart of ``jax.set_mesh``."""
    token = _AMBIENT.set(mesh)
    try:
        yield mesh
    finally:
        _AMBIENT.reset(token)


def ambient_mesh():
    """The mesh set by :func:`use_mesh`, or ``None``."""
    return _AMBIENT.get()


def _sizes(mesh) -> dict[str, int]:
    return dict(zip(mesh.mesh_dim_names, mesh.shape))


def _dp_axes():
    """Data-parallel axes of the ambient mesh ('pod' shards batch too) and
    their rank count."""
    am = ambient_mesh()
    if am is None:
        return None, 1
    names = am.mesh_dim_names
    dp_names = ("pod", "data", "model") if DP_OVER_MODEL else ("pod", "data")
    axes = tuple(a for a in dp_names if a in names)
    if not axes:
        return None, 1
    sizes = _sizes(am)
    return axes, math.prod(sizes[a] for a in axes)


def pin_spec(shape, entries) -> tuple | None:
    """The spec tuple :func:`shard_spec` pins a ``shape`` activation to under
    the ambient mesh, or ``None`` without one: 'dp' resolves to the
    data-parallel axes, and an entry whose axes do not divide its dim (or
    name one rank) is dropped."""
    axes, _ = _dp_axes()
    if axes is None:
        return None
    sizes = _sizes(ambient_mesh())
    out = []
    for dim, e in zip(shape, entries):
        ee = axes if e == "dp" else e
        if ee is None:
            out.append(None)
            continue
        names = ee if isinstance(ee, tuple) else (ee,)
        n = math.prod(sizes.get(a, 1) for a in names)
        out.append((ee if len(names) > 1 else names[0]) if dim % n == 0 and n > 1 else None)
    return tuple(out)


def batch_pin_spec(shape, batch_dim: int = 0, model_dim: int | None = None) -> tuple | None:
    """The spec tuple :func:`shard_batch` pins a ``shape`` activation to, or
    ``None`` where it leaves it (no mesh, or a batch the data-parallel
    ranks do not divide)."""
    axes, n = _dp_axes()
    if axes is None or n == 1 or shape[batch_dim] % n != 0:
        return None
    msize = _sizes(ambient_mesh()).get("model", 1)
    entries: list = [None] * len(shape)
    entries[batch_dim] = axes if len(axes) > 1 else axes[0]
    if model_dim is not None and not DP_OVER_MODEL:
        if msize > 1 and shape[model_dim] % msize == 0:
            entries[model_dim] = "model"
    elif (SEQ_SHARD_BOUNDARY and len(shape) == 3 and batch_dim == 0 and msize > 1
          and shape[1] % msize == 0):
        entries[1] = "model"  # sequence parallelism (residual stream)
    return tuple(entries)


def _is_dtensor(x) -> bool:
    from torch.distributed.tensor import DTensor

    return isinstance(x, DTensor)


def _pin(x, spec):
    if spec is None or not _is_dtensor(x):
        return x
    from repro_torch.launch.mesh import NamedSharding

    placements = NamedSharding(x.device_mesh, spec).placements
    if tuple(x.placements) == placements:
        return x
    return x.redistribute(x.device_mesh, placements)


def shard_spec(x, entries):
    """Pin an activation to an explicit spec; 'dp' resolves to the
    data-parallel axes (('pod', 'data') on a multi-pod mesh).  Entries whose
    axes do not divide the dim are dropped.  A no-op without a mesh or on a
    plain tensor."""
    return _pin(x, pin_spec(x.shape, entries))


def shard_batch(x, batch_dim: int = 0, model_dim: int | None = None):
    """Pin an activation's batch dim to the data-parallel mesh axes, every
    other dim replicated; ``model_dim`` additionally pins that dim to
    ``model`` (the vocabulary dim of logits), and ``SEQ_SHARD_BOUNDARY`` the
    residual stream's sequence dim.  The redistribution is where a
    row-parallel projection's partial sums are reduced.  A no-op without a
    mesh, on a plain tensor, or when the dim does not divide evenly."""
    if model_dim is not None and model_dim < 0:
        model_dim += x.ndim
    return _pin(x, batch_pin_spec(x.shape, batch_dim, model_dim))


def _model_dim(x, dim: int) -> int | None:
    """The mesh dim of a DTensor's ``model`` axis if ``x`` is sharded on
    tensor dim ``dim`` over it, else ``None``."""
    if not _is_dtensor(x) or "model" not in x.device_mesh.mesh_dim_names:
        return None
    i = x.device_mesh.mesh_dim_names.index("model")
    p = x.placements[i]
    return i if p.is_shard() and p.dim % x.ndim == dim % x.ndim else None


def _local_map(fn, out_placements, args, mesh, grad_placements=None):
    """``local_map`` over DTensor ``args`` at their own placements.
    ``grad_placements``: the layout of each input's gradient where it is
    not the input's own (``None`` entries keep it): ``Partial()`` on a mesh
    dim where the input is replicated but each rank's local function saw
    only part of what reads it (other rows, other experts, other heads)."""
    from torch.distributed.tensor.experimental import local_map

    ins = tuple(a.placements for a in args)
    grads = tuple(ins[i] if g is None else g for i, g in enumerate(grad_placements or
                                                                   (None,) * len(args)))
    return local_map(fn, out_placements=out_placements, in_placements=ins,
                     in_grad_placements=grads, device_mesh=mesh)(*args)


def _reduced(x):
    """``x`` with its partial sums reduced (``Replicate()`` where it was
    ``Partial``): a partial value added to a replicated one would have the
    replicated one split over the ranks and rounded twice."""
    from torch.distributed.tensor import Replicate

    whole = [Replicate() if p.is_partial() else p for p in x.placements]
    return x.redistribute(x.device_mesh, whole) if whole != list(x.placements) else x


class _SumPartials(torch.autograd.Function):
    """Reduce a DTensor's partial sums (``placements`` without ``Partial``);
    its gradient goes back whole on every rank (the gradient of a sum is
    each term's), its own partial sums reduced first: the residual stream's
    gradient arrives partial from the column-parallel products' backward,
    and a partial gradient would make the row-parallel product's backward
    gather its weight over ``model`` and compute every column on every
    rank (Megatron's all-reduce of that gradient, in its place)."""

    @staticmethod
    def forward(ctx, y, placements):
        ctx.placements = placements
        return y.redistribute(y.device_mesh, placements)

    @staticmethod
    def backward(ctx, g):
        if any(p.is_partial() for p in g.placements):
            g = g.redistribute(g.device_mesh, [p if p.is_shard() else q for p, q in
                                               zip(g.placements, ctx.placements)])
        return g, None


class _ContiguousGrad(torch.autograd.Function):
    """The identity, whose backward makes its gradient contiguous: a local
    gradient handed back to DTensor must have the strides of its global
    layout, or DTensor's later views of it fail."""

    @staticmethod
    def forward(ctx, t):
        return t.view_as(t)

    @staticmethod
    def backward(ctx, g):
        return g.contiguous()


def _contiguous_grads(*ts):
    return tuple(_ContiguousGrad.apply(t) if t.requires_grad else t for t in ts)


def _partial_where_split(placements, split):
    """``placements`` with ``Partial()`` on every mesh dim in ``split``."""
    from torch.distributed.tensor import Partial

    return tuple(Partial() if i in split else p for i, p in enumerate(placements))


def mp(x):
    """Cast to the compute (mixed-precision) dtype; a no-op on bf16 weights."""
    return x.to(COMPUTE_DTYPE)


def split_heads(t, heads: int):
    """``t`` (..., heads * hd) viewed as (..., heads, hd).  A DTensor
    sharded on its last dim over mesh dims whose ranks do not divide the
    heads (Yi-6B's 4 KV heads over 16) is gathered over them first:
    DTensor does not cut a head across ranks."""
    shape = (*t.shape[:-1], heads, t.shape[-1] // heads)
    if _is_dtensor(t):
        from torch.distributed.tensor import Replicate

        last = t.ndim - 1
        dims = [i for i, p in enumerate(t.placements) if p.is_shard() and p.dim % t.ndim == last]
        if heads % math.prod(t.device_mesh.shape[i] for i in dims):
            t = t.redistribute(t.device_mesh, [Replicate() if i in dims else p
                                               for i, p in enumerate(t.placements)])
    return t.reshape(shape)


def row_project(x, w):
    """``x @ mp(w)`` in the compute dtype.  Where the contraction is split
    over ``model`` (a row-parallel projection of DTensors), each rank's
    partial product is formed in f32 and the partials are summed in f32
    before the one rounding to bf16: the one-device product's rounding,
    where bf16 partial sums would round twice."""
    if _model_dim(w, 0) is None or not _is_dtensor(x):
        return torch.matmul(x, mp(w))
    y = torch.matmul(x.float(), mp(w).float())
    from torch.distributed.tensor import Replicate

    whole = [Replicate() if p.is_partial() else p for p in y.placements]
    return _SumPartials.apply(y, whole).to(x.dtype)


def mixed_einsum(spec, a, b):
    """bf16 x bf16 -> f32 contraction, with the operands upcast first (the
    reference's CPU form).  On CUDA float32 products run in full float32."""
    return torch.einsum(spec, a.float(), b.float())


# ---------------------------------------------------------------------------
# Norms / embeddings
# ---------------------------------------------------------------------------


def rmsnorm_spec(d: int) -> PSpec:
    return PSpec((d,), (), init="ones")


def rmsnorm(scale, x, eps: float = 1e-5):
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps) * scale.float()).to(x.dtype)


def layernorm_spec(d: int) -> dict:
    return {"scale": PSpec((d,), (), init="ones"), "bias": PSpec((d,), (), init="zeros")}


def layernorm(p, x, eps: float = 1e-5):
    """LayerNorm with bias (Whisper); statistics, scale and bias in f32."""
    xf = x.float()
    mu = torch.mean(xf, dim=-1, keepdim=True)
    var = torch.var(xf, dim=-1, keepdim=True, unbiased=False)
    y = (xf - mu) * torch.rsqrt(var + eps)
    return (y * p["scale"].float() + p["bias"].float()).to(x.dtype)


def embed_spec(vocab: int, d: int) -> PSpec:
    return PSpec((vocab, d), ("model", None), init="embed", scale=0.02)


def _lookup(table, ids):
    return mp(torch.index_select(table, 0, ids.reshape(-1)).reshape(*ids.shape, -1))


def embed_lookup(table, ids):
    """The rows of ``ids`` in bf16.  On a vocabulary-sharded DTensor table
    each rank looks up the ids its rows hold (zeros elsewhere) and the
    partial results are summed over ``model``: one nonzero a row, so the
    sum is the whole table's row."""
    mdim = _model_dim(table, 0)
    if mdim is None or not _is_dtensor(ids):
        return _lookup(table, ids)
    from torch.distributed.tensor import Partial

    rows = table.to_local().shape[0]
    start = table.device_mesh.get_local_rank("model") * rows

    def local(tab, idx):
        tab, = _contiguous_grads(tab)
        i = idx.long() - start
        inside = (i >= 0) & (i < rows)
        out = _lookup(tab, torch.where(inside, i, 0))
        return torch.where(inside[..., None], out, torch.zeros((), dtype=out.dtype,
                                                               device=out.device))

    placements = [Partial() if d == mdim else ids.placements[d] for d in range(len(ids.placements))]
    # the table's gradient: each rank's rows of the batch add to it
    batch_dims = {i for i, p in enumerate(ids.placements) if p.is_shard()}
    return _reduced(_local_map(local, placements, (table, ids), table.device_mesh,
                               (_partial_where_split(table.placements, batch_dims), None)))


def unembed(table, x):
    """Logits in f32 from the f32 table (vocabulary-sharded with it)."""
    return torch.matmul(x.float(), table.float().T)


def _gold(logits, labels):
    """``logits[..., labels]``; on logits sharded over their vocabulary each
    rank reads the labels its shard holds and the partial results are summed
    over ``model`` (one nonzero a token)."""
    mdim = _model_dim(logits, -1)
    if mdim is None:
        if _is_dtensor(logits):  # whole rows on every rank: partial sums reduced first
            from torch.distributed.tensor import Replicate

            whole = [p if p.is_shard() and p.dim % logits.ndim != logits.ndim - 1
                     else Replicate() for p in logits.placements]
            logits = logits.redistribute(logits.device_mesh, whole)
        return torch.gather(logits, -1, labels.long()[..., None])[..., 0]
    from torch.distributed.tensor import Partial

    vdim = logits.ndim - 1
    start = logits.device_mesh.get_local_rank("model") * logits.to_local().shape[-1]

    def local(lg, lab):
        lg, = _contiguous_grads(lg)
        i = lab.long() - start
        inside = (i >= 0) & (i < lg.shape[-1])
        g = torch.gather(lg, -1, torch.where(inside, i, 0)[..., None])[..., 0]
        return torch.where(inside, g, torch.zeros((), dtype=g.dtype, device=g.device))

    placements = [Partial() if p.is_shard() and p.dim % logits.ndim == vdim else p
                  for p in logits.placements]
    return _reduced(_local_map(local, placements, (logits, _like(labels, logits, vdim)),
                               logits.device_mesh))


def _like(labels, logits, vdim: int):
    """The DTensor ``labels`` laid out as ``logits`` without its vocabulary
    dim."""
    from torch.distributed.tensor import Replicate

    want = [Replicate() if p.is_shard() and p.dim % logits.ndim == vdim else p
            for p in logits.placements]
    return labels.redistribute(logits.device_mesh, want)


def _logsumexp(logits):
    """``logsumexp`` over the last dim; on logits sharded over their
    vocabulary (``loss_parallel``'s layout) the row maxima and the sums of
    exponentials are reduced over ``model`` from each rank's shard, so the
    logits are never gathered (4 x 2,048 x 151,936 f32 is 4.98 GB a
    microbatch).  The maxima carry no gradient: ``max + log sum exp(x -
    max)`` has the softmax as its gradient whatever the shift."""
    if _model_dim(logits, -1) is None:
        return torch.logsumexp(logits, dim=-1)
    m = _reduced(logits.detach().amax(dim=-1, keepdim=True))
    s = _reduced(torch.exp(logits - m).sum(dim=-1))
    return m.squeeze(-1) + torch.log(s)


def softmax_xent(logits, labels, mask=None):
    """Token-mean cross entropy in f32. labels (B,S) int, mask (B,S)."""
    logits = logits.float()
    logz = _logsumexp(logits)
    gold = _gold(logits, labels)
    nll = logz - gold
    if mask is None:
        return nll.mean()
    mask = mask.float()
    return (nll * mask).sum() / mask.sum().clamp(min=1.0)


# ---------------------------------------------------------------------------
# Rotary position embeddings (RoPE + M-RoPE)
# ---------------------------------------------------------------------------


def _rope_freqs(dim: int, theta: float, device=None):
    return 1.0 / (theta ** (torch.arange(0, dim, 2, dtype=torch.float32, device=device) / dim))


def rope(x, positions, theta: float):
    """x (..., S, H, hd), positions (..., S) -> rotated x (same dtype)."""
    freqs = _rope_freqs(x.shape[-1], theta, x.device)  # (hd/2,)
    ang = positions[..., None].float() * freqs  # (..., S, hd/2)
    cos = torch.cos(ang)[..., None, :]  # (..., S, 1, hd/2)
    sin = torch.sin(ang)[..., None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1).to(x.dtype)


@functools.lru_cache(maxsize=None)
def _mrope_streams(half: int, sections: tuple[int, int, int], device) -> torch.Tensor:
    """The position stream of each of the ``half`` frequency channels, made
    once a device (no host-to-device copy a call)."""
    bounds = torch.cumsum(torch.tensor(sections), 0)
    return torch.searchsorted(bounds, torch.arange(half), right=True).clamp(0, 2).to(device)


def mrope(x, positions3, theta: float, sections: tuple[int, int, int]):
    """Multimodal RoPE (Qwen2-VL): positions3 (3, B, S) are the temporal,
    height and width position ids; the frequency channels are split into
    three sections, each rotated by its own position stream."""
    hd = x.shape[-1]
    freqs = _rope_freqs(hd, theta, x.device)  # (hd/2,)
    which = _mrope_streams(hd // 2, tuple(sections), x.device)  # (hd/2,)
    pos = positions3[which].movedim(0, -1).float()  # (B, S, hd/2): per-channel stream
    ang = pos * freqs
    cos = torch.cos(ang)[..., None, :]
    sin = torch.sin(ang)[..., None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1).to(x.dtype)


# ---------------------------------------------------------------------------
# GQA attention
# ---------------------------------------------------------------------------


def attention_specs(cfg: ModelConfig) -> dict:
    d, h, hkv, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    p = {
        "wq": PSpec((d, h * hd), (None, "model")),
        "wk": PSpec((d, hkv * hd), (None, "model")),
        "wv": PSpec((d, hkv * hd), (None, "model")),
        "wo": PSpec((h * hd, d), ("model", None)),
    }
    if cfg.qkv_bias:
        p["bq"] = PSpec((h * hd,), ("model",), init="zeros")
        p["bk"] = PSpec((hkv * hd,), ("model",), init="zeros")
        p["bv"] = PSpec((hkv * hd,), ("model",), init="zeros")
    return in_bf16(p)


def _qkv(cfg: ModelConfig, p, x):
    B, S, _ = x.shape
    h, hkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    q = torch.matmul(x, mp(p["wq"]))
    k = torch.matmul(x, mp(p["wk"]))
    v = torch.matmul(x, mp(p["wv"]))
    if cfg.qkv_bias:
        q = q + mp(p["bq"])
        k = k + mp(p["bk"])
        v = v + mp(p["bv"])
    return split_heads(q, h), split_heads(k, hkv), split_heads(v, hkv)


def _apply_rope(cfg: ModelConfig, q, k, positions):
    if not cfg.use_rope:
        return q, k
    if cfg.mrope:
        secs = cfg.mrope_sections
        return mrope(q, positions, cfg.rope_theta, secs), mrope(k, positions, cfg.rope_theta, secs)
    return rope(q, positions, cfg.rope_theta), rope(k, positions, cfg.rope_theta)


def chunked_attention(q, k, v, scale, *, causal=True, q_block: int | None = None,
                      out_dtype=None):
    """Query-block-chunked exact attention, the long-sequence plain path.

    q (B,S,H,hq), k (B,T,Hkv,hq), v (B,T,Hkv,hv) -> (B,S,H*hv).  Each
    query block takes its full-row softmax against all T keys, so the
    result is the unchunked one; only a (q_block, T) score tile is live.
    """
    B, S, H, hq = q.shape
    T, hkv = k.shape[1], k.shape[2]
    g = H // hkv
    hv = v.shape[-1]
    out_dtype = out_dtype or v.dtype
    qb = min(q_block or ATTN_Q_BLOCK, S)
    nb = S // qb
    assert nb * qb == S, f"seq {S} not divisible by q_block {qb}"
    # The reference's flash-decoding layout: DTensor K/V sequence-sharded
    # over ``model``, so a score tile stays sharded on its keys.
    am = ambient_mesh()
    if (am is not None and _is_dtensor(k) and "model" in am.mesh_dim_names
            and not DP_OVER_MODEL and T % _sizes(am)["model"] == 0):
        seq = (None, "model", None, None)
        k, v = shard_spec(k, seq), shard_spec(v, seq)
    rows0 = torch.arange(qb, device=q.device)
    cols = torch.arange(T, device=q.device)
    out = []
    for blk in range(nb):
        qblk = q[:, blk * qb:(blk + 1) * qb].reshape(B, qb, hkv, g, hq)
        s = mixed_einsum("bskgh,btkh->bkgst", qblk, k) * scale
        if causal:
            m = (blk * qb + rows0)[:, None] >= cols[None, :]
            s = torch.where(m, s, NEG_INF)
        pr = torch.softmax(s, dim=-1)
        o = mixed_einsum("bkgst,btkh->bskgh", pr.to(v.dtype), v)
        out.append(o.reshape(B, qb, H * hv).to(out_dtype))
    return torch.cat(out, dim=1)


def attend(q, k, v, scale, out_dtype, *, causal: bool = True):
    """Full-sequence attention, q (B,S,H,hq), k (B,T,Hkv,hq), v (B,T,Hkv,hv)
    -> (B,S,H*hv) in ``out_dtype``: the ``flash_attn`` kernel (its plain
    version on CPU and ``meta`` tensors), or :func:`chunked_attention` on
    CPU and ``meta`` tensors longer than ``ATTN_CHUNK_THRESHOLD``; DTensors
    go through :func:`_attend_heads`.  MLA's unequal dims (96 for q.k, 64
    for v) go to the kernels as they are: the tensor-core forward and
    backward take them unpadded (``flash.attention`` pads only for the FMA
    kernels).
    """
    if _is_dtensor(q):
        return _attend_heads(q, k, v, scale, out_dtype, causal)
    if q.device.type in ("cpu", "meta") and q.shape[1] > ATTN_CHUNK_THRESHOLD:
        return chunked_attention(q, k, v, scale, causal=causal, out_dtype=out_dtype)
    return flash.attention(q, k, v, scale, causal=causal).to(out_dtype)


def _attend_heads(q, k, v, scale, out_dtype, causal: bool):
    """:func:`attend` over DTensors, on each rank's whole heads
    (``local_map``): q's heads keep their layout (sharded over ``model`` by
    the column-parallel projection, or replicated), and k/v are laid out to
    match.  Where the KV heads divide over ``model`` as the query heads do,
    a rank's query groups read exactly its KV heads; otherwise (Yi-6B's 4 KV
    heads over 16 ranks) each rank gathers the KV heads and keeps those its
    query groups need."""
    from torch.distributed.tensor import Replicate

    mesh = q.device_mesh
    H, hkv = q.shape[2], k.shape[2]
    mdim = _model_dim(q, 2)

    def keep(dims):  # the placements of q's that shard ``dims``, others replicated
        return [p if p.is_shard() and p.dim in dims else Replicate() for p in q.placements]

    qpl, kv_pl, lo, hi = keep((0,)), keep((0,)), None, None
    if mdim is not None:
        qpl = keep((0, 2))
        if hkv % mesh.shape[mdim] == 0:
            kv_pl = qpl
        else:
            g, per = H // hkv, H // mesh.shape[mdim]
            r = mesh.get_local_rank("model")
            lo, hi = r * per // g, ((r + 1) * per - 1) // g + 1
    q, k, v = (t.redistribute(mesh, pl) if tuple(t.placements) != tuple(pl) else t
               for t, pl in ((q, qpl), (k, kv_pl), (v, kv_pl)))

    def local(ql, kl, vl):
        ql, kl, vl = _contiguous_grads(ql, kl, vl)
        if lo is not None:
            kl, vl = kl[:, :, lo:hi], vl[:, :, lo:hi]
        return attend(ql, kl, vl, scale, out_dtype, causal=causal)

    # gathered KV heads: each rank's gradient covers the heads it read
    kv_grad = None if lo is None else _partial_where_split(kv_pl, {mdim})
    return _local_map(local, qpl, (q, k, v), mesh, (None, kv_grad, kv_grad))


def _attend(cfg: ModelConfig, p, q, k, v, out_dtype, *, causal: bool = True):
    """Attention over rotated q/k and v, then the output projection."""
    o = attend(q, k, v, 1.0 / math.sqrt(cfg.head_dim), out_dtype, causal=causal)
    return row_project(o, p["wo"])


def attention_train(cfg: ModelConfig, p, x, positions, *, causal: bool = True):
    """Full-sequence attention. x (B,S,D) bf16, positions (B,S) or (3,B,S)."""
    q, k, v = _qkv(cfg, p, x)
    q, k = _apply_rope(cfg, q, k, positions)
    return _attend(cfg, p, q, k, v, x.dtype, causal=causal)


def cross_attention_train(cfg: ModelConfig, p, x, memory):
    """Encoder-decoder cross attention, x (B,S,D) over memory (B,T,D): no
    positions, no mask, and, as in the reference, no q/k/v biases (the
    decode path's cross cache and query add them)."""
    B, S, _ = x.shape
    T = memory.shape[1]
    h, hkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    q = split_heads(torch.matmul(x, mp(p["wq"])), h)
    k = torch.matmul(memory, mp(p["wk"])).reshape(B, T, hkv, hd)
    v = torch.matmul(memory, mp(p["wv"])).reshape(B, T, hkv, hd)
    return _attend(cfg, p, q, k, v, x.dtype, causal=False)


def attention_cache_specs(cfg: ModelConfig, batch: int, s_max: int) -> dict:
    """bf16 KV cache (B, Hkv, s_max, hd) a layer, with the reference's
    logical axes: batch on data and heads or sequence on model."""
    hkv, hd = cfg.n_kv_heads, cfg.head_dim
    if batch == 1:
        spec = (None, None, ("data", "model"), None)
    elif hkv >= 16 and hkv % 16 == 0:
        spec = ("data", "model", None, None)
    else:
        spec = ("data", None, "model", None)
    return {
        "k": PSpec((batch, hkv, s_max, hd), spec, init="zeros", dtype=COMPUTE_DTYPE),
        "v": PSpec((batch, hkv, s_max, hd), spec, init="zeros", dtype=COMPUTE_DTYPE),
    }


def decode_positions(cfg: ModelConfig, pos):
    """The rotary positions of one decode step: (B, 1), or for M-RoPE the
    same position in all three streams, (3, B, 1)."""
    if cfg.mrope:
        return pos[None, :, None].expand(3, pos.shape[0], 1)
    return pos[:, None]


def attention_decode(cfg: ModelConfig, p, x, cache, pos):
    """Single-token decode. x (B,1,D), cache {k,v} (B,Hkv,S,hd), pos (B,).

    The new key and value are written at ``pos[0]`` for every row, as
    the reference's ``dynamic_update_slice`` does (its start index is
    clamped into range), but in place: the returned cache is the given
    one.  The scores and the PV product are f32 over upcast operands.
    """
    q, k, v = _qkv(cfg, p, x)  # (B,1,.,hd)
    q, k = _apply_rope(cfg, q, k, decode_positions(cfg, pos))
    kc, vc = cache["k"], cache["v"]
    if _is_dtensor(kc):
        o = _decode_sharded(q, k, v, kc, vc, pos, x.dtype)
    else:
        o = _decode_attend(q, k, v, kc, vc, pos, x.dtype, size=kc.shape[2])
    return row_project(o, p["wo"]), cache


def _write_at(cache_t, new, dim: int, pos, size: int, start: int | None = None):
    """Write ``new`` (one entry along ``dim``) into ``cache_t`` in place at
    ``pos[0]``, clamped into a cache of ``size`` entries.  ``start``:
    ``cache_t`` is the block of such a cache split along ``dim`` that begins
    there, and only the block holding the index changes."""
    at = pos[:1].long().clamp(0, size - 1)
    new = new.to(cache_t.dtype)
    if start is None:
        cache_t.index_copy_(dim, at, new)
        return
    n = cache_t.shape[dim]
    at = at - start
    mine = (at >= 0) & (at < n)
    at = at.clamp(0, n - 1)
    cache_t.index_copy_(dim, at, torch.where(mine, new, cache_t.index_select(dim, at)))


def _key_positions(n: int, start: int | None, device):
    """The positions of a block of ``n`` keys that begins at ``start``."""
    t = torch.arange(n, device=device)
    return t + start if start else t


def _decode_attend(q, k, v, kc, vc, pos, out_dtype, *, size: int, start: int | None = None,
                   shards=None):
    """:func:`attention_decode`'s cache write and attention, on plain
    tensors: the whole cache, or (``start``, ``shards``) a rank's block of a
    cache split along its sequence (:func:`_decode_sharded`)."""
    shards = shards or _SeqShards(None, ())
    b, _, hl, hd = q.shape
    hkl, n = kc.shape[1], kc.shape[2]
    _write_at(kc, k.transpose(1, 2), 2, pos, size, start)
    _write_at(vc, v.transpose(1, 2), 2, pos, size, start)
    qg = q.reshape(b, 1, hkl, hl // hkl, hd).to(kc.dtype)
    # a Python scalar: a device tensor made from one would cost a host sync a layer
    scores = mixed_einsum("bskgh,bkth->bkgst", qg, kc) / math.sqrt(hd)  # (B,hkv,g,1,S)
    tmask = _key_positions(n, start, q.device)[None, :] <= pos[:, None]  # (B,S)
    scores = torch.where(tmask[:, None, None, None, :], scores, NEG_INF)
    probs = shards.softmax(scores)
    o = shards.sum(mixed_einsum("bkgst,bkth->bskgh", probs.to(vc.dtype), vc))
    return o.reshape(b, 1, hl * hd).to(out_dtype)


def _offset(mesh, placements, dim: int, size: int) -> int:
    """The first index along ``dim`` of this rank's block (DTensor's even
    chunks, mesh dims major first)."""
    lo, n = 0, size
    for i, p in enumerate(placements):
        if p.is_shard() and p.dim == dim:
            chunk = -(-n // mesh.shape[i])
            lo += min(mesh.get_local_rank(i) * chunk, n)
            n = chunk
    return lo


class _SeqShards:
    """The softmax and the sums over a key axis split over mesh dims ``dims``
    (the flash-decoding layout): each rank scores its keys, the row maxima
    and the exponential sums are reduced over the ranks, and so are the
    products with the values.  On one rank (no dims) it is the softmax."""

    def __init__(self, mesh, dims):
        self.mesh, self.dims = mesh, tuple(dims)

    def _reduce(self, t, op: str):
        from torch.distributed import _functional_collectives as funcol

        for i in self.dims:
            t = funcol.all_reduce(t, op, (self.mesh, i))
        return t

    def softmax(self, s):
        if not self.dims:
            return torch.softmax(s, dim=-1)
        e = torch.exp(s - self._reduce(s.amax(dim=-1, keepdim=True), "max"))
        return e / self._reduce(e.sum(dim=-1, keepdim=True), "sum")

    def sum(self, t):
        return self._reduce(t, "sum") if self.dims else t


def _decode_sharded(q, k, v, kc, vc, pos, out_dtype):
    """:func:`attention_decode`'s cache write and attention over a DTensor
    cache laid out by ``launch/sharding.state_shardings``: batch over
    ``data``, and KV heads or the sequence over ``model`` (both over
    ``data`` and ``model`` for one row).  Each rank works on its block
    (``local_map``): with heads split, its query heads against its KV
    heads; with the sequence split, all heads against its keys, the rank
    holding ``pos[0]`` writing the new entry, and the softmax and the
    value sums reduced over the ranks that split the keys."""
    from torch.distributed.tensor import Replicate, Shard

    mesh = kc.device_mesh
    S = kc.shape[2]
    cpl = kc.placements
    heads = {i for i, p in enumerate(cpl) if p.is_shard(1)}
    seq = [i for i, p in enumerate(cpl) if p.is_shard(2)]
    qpl = [Shard(0) if p.is_shard(0) else Shard(2) if i in heads else Replicate()
           for i, p in enumerate(cpl)]
    ppl = [Shard(0) if p.is_shard(0) else Replicate() for p in cpl]
    q, k, v = (t.redistribute(mesh, qpl) for t in (q, k, v))
    pos = pos.redistribute(mesh, ppl)
    local = functools.partial(_decode_attend, out_dtype=out_dtype, size=S,
                              start=_offset(mesh, cpl, 2, S), shards=_SeqShards(mesh, seq))
    return _local_map(local, qpl, (q, k, v, kc, vc, pos), mesh)


# ---------------------------------------------------------------------------
# MLA: multi-head latent attention (MiniCPM3 / DeepSeek-V2 style)
# ---------------------------------------------------------------------------


def mla_specs(cfg: ModelConfig) -> dict:
    d, h = cfg.d_model, cfg.n_heads
    qr, kr = cfg.q_lora_rank, cfg.kv_lora_rank
    dn, dr, dv = cfg.qk_nope_dim, cfg.qk_rope_dim, cfg.v_head_dim
    return {
        **in_bf16({
            "q_down": PSpec((d, qr), (None, None)),
            "q_up": PSpec((qr, h * (dn + dr)), (None, "model")),
            "kv_down": PSpec((d, kr + dr), (None, None)),
            "kv_up": PSpec((kr, h * (dn + dv)), (None, "model")),
            "wo": PSpec((h * dv, d), ("model", None)),
        }),
        "q_norm": rmsnorm_spec(qr),
        "kv_norm": rmsnorm_spec(kr),
    }


def _mla_q(cfg: ModelConfig, p, x):
    """The query's no-rope and rope parts, (B,S,h,dn) and (B,S,h,dr), unrotated."""
    B, S, _ = x.shape
    dn, dr = cfg.qk_nope_dim, cfg.qk_rope_dim
    ql = rmsnorm(p["q_norm"], torch.matmul(x, mp(p["q_down"])), cfg.norm_eps)
    q = split_heads(torch.matmul(ql, mp(p["q_up"])), cfg.n_heads)
    return q[..., :dn], q[..., dn:]


def _mla_latent(cfg: ModelConfig, p, x, positions):
    """The normed latent c_kv (B,S,kr) and the rotated rope key (B,S,dr):
    what the decode cache holds."""
    kr = cfg.kv_lora_rank
    kv = torch.matmul(x, mp(p["kv_down"]))
    c_kv = rmsnorm(p["kv_norm"], kv[..., :kr], cfg.norm_eps)
    k_rope = rope(kv[..., kr:][:, :, None, :], positions, cfg.rope_theta)[:, :, 0, :]
    return c_kv, k_rope


def mla_attend(cfg: ModelConfig, p, x, positions):
    """Full-sequence MLA. Returns (out (B,S,D), c_kv, k_rope); the latent
    and the rope key are the prefill's cache entries."""
    B, S, _ = x.shape
    h = cfg.n_heads
    dn, dr, dv = cfg.qk_nope_dim, cfg.qk_rope_dim, cfg.v_head_dim
    q_nope, q_rope = _mla_q(cfg, p, x)
    c_kv, k_rope = _mla_latent(cfg, p, x, positions)
    kvu = split_heads(torch.matmul(c_kv, mp(p["kv_up"])), h)
    k_nope, v = kvu[..., :dn], kvu[..., dn:]
    q = torch.cat([q_nope, rope(q_rope, positions, cfg.rope_theta)], dim=-1)
    k = torch.cat([k_nope, k_rope[:, :, None, :].expand(B, S, h, dr)], dim=-1)
    o = attend(q, k, v, 1.0 / math.sqrt(dn + dr), x.dtype)
    return row_project(o, p["wo"]), c_kv, k_rope


def mla_train(cfg: ModelConfig, p, x, positions):
    return mla_attend(cfg, p, x, positions)[0]


def mla_cache_specs(cfg: ModelConfig, batch: int, s_max: int) -> dict:
    """MLA caches the compressed latent and the rope key: kv_lora_rank +
    qk_rope_dim values a token instead of 2 * n_heads * head_dim."""
    seq = ("data", "model") if batch == 1 else "model"
    b_ax = None if batch == 1 else "data"
    return {
        "c_kv": PSpec((batch, s_max, cfg.kv_lora_rank), (b_ax, seq, None),
                      init="zeros", dtype=COMPUTE_DTYPE),
        "k_rope": PSpec((batch, s_max, cfg.qk_rope_dim), (b_ax, seq, None),
                        init="zeros", dtype=COMPUTE_DTYPE),
    }


def mla_decode(cfg: ModelConfig, p, x, cache, pos):
    """Absorbed-projection MLA decode: attention runs in the latent space
    (W_uk folded into q, W_uv applied after the probability-weighted
    latent sum).  The new latent and rope key are written in place at
    ``pos[0]``, clamped, as in :func:`attention_decode`."""
    B = x.shape[0]
    h = cfg.n_heads
    dn, dr, dv = cfg.qk_nope_dim, cfg.qk_rope_dim, cfg.v_head_dim
    kr = cfg.kv_lora_rank
    q_nope, q_rope = _mla_q(cfg, p, x)
    q_rope = rope(q_rope, pos[:, None], cfg.rope_theta)
    c_new, kr_new = _mla_latent(cfg, p, x, pos[:, None])
    c_cache, r_cache = cache["c_kv"], cache["k_rope"]
    kv_up = split_heads(p["kv_up"], h)
    w_uk = mp(kv_up[..., :dn])  # (kr, h, dn)
    w_uv = mp(kv_up[..., dn:])  # (kr, h, dv)
    q_lat = torch.einsum("bshd,rhd->bshr", q_nope, w_uk)  # (B,1,h,kr)
    scale = 1.0 / math.sqrt(dn + dr)
    if _is_dtensor(c_cache):
        lat = _mla_latent_sharded(q_lat, q_rope, c_new, kr_new, c_cache, r_cache, pos, scale)
    else:
        lat = _mla_latent_attend(q_lat, q_rope, c_new, kr_new, pos, c_cache, r_cache, scale,
                                 size=c_cache.shape[1])  # (B,1,h,kr)
    o = torch.einsum("bshr,rhd->bshd", lat, w_uv.float())
    o = o.reshape(B, 1, h * dv).to(x.dtype)
    return row_project(o, p["wo"]), cache


def _mla_latent_attend(ql, qr, cn, kn, pos, cc, rc, scale, *, size: int,
                       start: int | None = None, shards=None):
    """:func:`mla_decode`'s cache write and latent attention, on plain
    tensors: the whole caches, or (``start``, ``shards``) a rank's block of
    caches split along their sequence (:func:`_mla_latent_sharded`).
    Returns the latent sum (B, 1, h, kr) in f32."""
    shards = shards or _SeqShards(None, ())
    _write_at(cc, cn, 1, pos, size, start)
    _write_at(rc, kn, 1, pos, size, start)
    s_lat = mixed_einsum("bshr,btr->bhst", ql.to(cc.dtype), cc)
    s_rope = mixed_einsum("bshd,btd->bhst", qr.to(rc.dtype), rc)
    scores = (s_lat + s_rope) * scale
    tmask = _key_positions(cc.shape[1], start, ql.device)[None, :] <= pos[:, None]
    scores = torch.where(tmask[:, None, None, :], scores, NEG_INF)
    probs = shards.softmax(scores)
    return shards.sum(mixed_einsum("bhst,btr->bshr", probs.to(cc.dtype), cc))


def _mla_latent_sharded(q_lat, q_rope, c_new, kr_new, c_cache, r_cache, pos, scale):
    """:func:`mla_decode`'s cache write and latent attention over DTensor
    caches (B, S, ·) whose sequence is split over ``model`` (and ``data``
    for one row): each rank scores every head against its latents, the
    rank holding ``pos[0]`` writes the new entry, and the softmax and the
    latent sums are reduced over the ranks that split the sequence
    (:class:`_SeqShards`).  Returns the latent sum (B, 1, h, kr) in f32."""
    from torch.distributed.tensor import Replicate, Shard

    mesh = c_cache.device_mesh
    S = c_cache.shape[1]
    cpl = c_cache.placements
    seq = [i for i, p in enumerate(cpl) if p.is_shard(1)]
    bpl = [Shard(0) if p.is_shard(0) else Replicate() for p in cpl]
    args = [t.redistribute(mesh, bpl) for t in (q_lat, q_rope, c_new, kr_new, pos)]
    local = functools.partial(_mla_latent_attend, scale=scale, size=S,
                              start=_offset(mesh, cpl, 1, S), shards=_SeqShards(mesh, seq))
    return _local_map(local, bpl, (*args, c_cache, r_cache), mesh)


# ---------------------------------------------------------------------------
# MLP
# ---------------------------------------------------------------------------


def mlp_specs(cfg: ModelConfig, d_ff: int | None = None) -> dict:
    d = cfg.d_model
    f = d_ff or cfg.d_ff
    if cfg.act == "silu":  # gated: fused [gate; up]
        return in_bf16({
            "w_in": PSpec((d, 2 * f), (None, "model")),
            "w_out": PSpec((f, d), ("model", None)),
        })
    return in_bf16({
        "w_in": PSpec((d, f), (None, "model")),
        "b_in": PSpec((f,), ("model",), init="zeros"),
        "w_out": PSpec((f, d), ("model", None)),
        "b_out": PSpec((d,), (), init="zeros"),
    })


def split_cols(w, parts: int):
    """A weight of fused column blocks, (..., parts * f) -> (..., parts, f).

    On a DTensor sharded on its columns over ``model`` (the reference's
    layout of a fused [gate; up] projection puts whole blocks on whole
    ranks), the weight is gathered and laid out with ``f`` sharded instead,
    so that each rank holds the same columns of every block and the gated
    product stays local: one all-gather of the weight, where slicing the
    column-sharded product would gather the activations."""
    shape = (*w.shape[:-1], parts, w.shape[-1] // parts)
    mdim = _model_dim(w, -1)
    if mdim is None:
        return w.reshape(shape)
    from torch.distributed.tensor import Replicate, Shard

    mesh = w.device_mesh
    whole = [Replicate() if i == mdim else p for i, p in enumerate(w.placements)]
    v = w.redistribute(mesh, whole).reshape(shape)
    if shape[-1] % mesh.shape[mdim]:
        return v
    return v.redistribute(mesh, [Shard(len(shape) - 1) if i == mdim else p
                                 for i, p in enumerate(v.placements)])


def gated(x, w_in):
    """``silu(x @ gate) * (x @ up)`` of a fused ``[gate; up]`` weight whose
    columns are split over ``model`` (:func:`split_cols`: each rank's
    columns of both halves, so the product stays local)."""
    w = split_cols(mp(w_in), 2)
    gate, up = torch.matmul(x, w[:, 0]), torch.matmul(x, w[:, 1])
    return F.silu(gate.float()).to(x.dtype) * up


def mlp(cfg: ModelConfig, p, x):
    if cfg.act == "silu" and _model_dim(p["w_in"], -1) is not None:
        h = gated(x, p["w_in"])
    elif cfg.act == "silu":
        f = p["w_out"].shape[0]
        gu = torch.matmul(x, mp(p["w_in"]))
        gate, up = gu[..., :f], gu[..., f:]
        h = F.silu(gate.float()).to(x.dtype) * up
    else:
        h = torch.matmul(x, mp(p["w_in"])) + mp(p["b_in"])
        h = F.gelu(h.float(), approximate="tanh").to(x.dtype)  # jax.nn.gelu's default
    out = row_project(h, p["w_out"])
    if cfg.act != "silu":
        out = out + mp(p["b_out"])
    return out
