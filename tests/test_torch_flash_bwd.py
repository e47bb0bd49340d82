"""``flash_attn``'s backward pieces on the CPU: the row statistics the forward
kernels write (``attention_lse_plain``), the softmax the backward kernels
recompute from them, and the wrappers' plain routes, against the reference;
and at unequal q.k and v dims (MLA's 96 and 64, the smoke configs' 24 and
16), which the wrappers take as they are, against ``jax.grad`` of the
reference's ``chunked_attention``.

The same numpy inputs go to both packages.  Tolerance 1e-5: f32 throughout,
sums in another order.  The kernels themselves run only on the card
(``chip_smoke.py`` phase 2 holds them to these plain versions).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.kernels.flash_attn import ops as ref_flash  # noqa: E402
from repro.kernels.flash_attn import ref as ref_attention  # noqa: E402
from repro.models import layers as ref_layers  # noqa: E402
from repro_torch.kernels.flash_attn import ops as flash  # noqa: E402
from repro_torch.models import layers  # noqa: E402

TOL = dict(rtol=1e-5, atol=1e-5)

# (B, S, T, H, Hkv, hd, causal, MLA (q.k dim, v dim) zero-padded to hd)
CASES = {
    "causal": (2, 24, 24, 2, 2, 16, True, None),
    "full": (2, 24, 24, 2, 2, 16, False, None),
    "gqa": (1, 20, 20, 6, 2, 8, True, None),
    "ragged S<T causal": (2, 13, 37, 4, 2, 8, True, None),
    "ragged S>T causal": (1, 37, 13, 4, 1, 8, True, None),
    "ragged S!=T full": (2, 9, 70, 4, 4, 16, False, None),
    "mla padded": (1, 12, 12, 2, 2, 128, True, (96, 64)),
}


def _inputs(B, S, T, H, hkv, hd, causal, mla, seed=0):
    """q, k, v as the kernel takes them (MLA: zero-padded to hd), the output
    gradient, and the scale."""
    rng = np.random.default_rng(seed)
    hq, hv = mla or (hd, hd)
    q, k, v = (np.zeros((B, n, h, hd), np.float32) for n, h in [(S, H), (T, hkv), (T, hkv)])
    q[..., :hq] = rng.standard_normal((B, S, H, hq))
    k[..., :hq] = rng.standard_normal((B, T, hkv, hq))
    v[..., :hv] = rng.standard_normal((B, T, hkv, hv))
    do = rng.standard_normal((B, S, H * hd)).astype(np.float32)
    return q, k, v, do, 1.0 / np.sqrt(hq)


def _reference_lse(q, k, scale, causal):
    """jax.nn.logsumexp of the reference's scaled, masked scores, (B, H, S)."""
    B, S, H, hd = q.shape
    T, hkv = k.shape[1], k.shape[2]
    qg = jnp.asarray(q).reshape(B, S, hkv, H // hkv, hd)
    s = jnp.einsum("bskgh,btkh->bkgst", qg, jnp.asarray(k)) * scale
    if causal:
        mask = jnp.arange(S)[:, None] >= jnp.arange(T)[None, :]
        s = jnp.where(mask[None, None, None], s, ref_attention.NEG_INF)
    return np.asarray(jax.nn.logsumexp(s, axis=-1)).reshape(B, H, S)


@pytest.mark.parametrize("case", CASES)
def test_lse_plain_matches_reference_logsumexp(case):
    B, S, T, H, hkv, hd, causal, mla = CASES[case]
    q, k, v, _, scale = _inputs(*CASES[case])
    got = flash.attention_lse_plain(torch.as_tensor(q), torch.as_tensor(k), torch.as_tensor(v),
                                    scale, causal=causal)
    assert got.dtype == torch.float32 and got.shape == (B, H, S)
    np.testing.assert_allclose(got.numpy(), _reference_lse(q, k, scale, causal), **TOL)
    if mla is not None:  # the padding's zeros leave the statistics unchanged
        hq = mla[0]
        unpadded = flash.attention_lse_plain(torch.as_tensor(q[..., :hq]),
                                             torch.as_tensor(k[..., :hq]), None, scale,
                                             causal=causal)
        np.testing.assert_allclose(got.numpy(), unpadded.numpy(), **TOL)


@pytest.mark.parametrize("case", CASES)
def test_softmax_recomputed_from_lse_is_attention_plains(case):
    """exp(scale S - lse), the backward kernels' P, equals the softmax of
    ``attention_plain``, and P V its output (and the reference's)."""
    B, S, T, H, hkv, hd, causal, mla = CASES[case]
    q, k, v, _, scale = _inputs(*CASES[case])
    qt, kt, vt = (torch.as_tensor(a) for a in (q, k, v))
    scores = flash.attention_scores_plain(qt, kt, scale, causal=causal)
    lse = flash.attention_lse_plain(qt, kt, vt, scale, causal=causal)
    p = torch.exp(scores - lse.reshape(B, hkv, H // hkv, S, 1))
    np.testing.assert_allclose(p.numpy(), torch.softmax(scores, dim=-1).numpy(), **TOL)
    o = torch.einsum("bkgst,btkh->bskgh", p, vt).reshape(B, S, H * hd)
    np.testing.assert_allclose(o.numpy(), flash.attention_plain(qt, kt, vt, scale,
                                                                causal=causal).numpy(), **TOL)
    want = ref_attention.attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), scale,
                                   causal=causal)
    np.testing.assert_allclose(o.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("case", CASES)
def test_wrappers_plain_route_on_cpu_tensors(case):
    """On CPU tensors ``attention_forward`` and ``attention_backward`` take
    their plain versions and launch nothing: the reference's output and row
    statistics, and the f32 gradients of autograd of ``attention_plain``
    (``tests/test_torch_train.py`` holds that to ``jax.vjp`` of the
    reference)."""
    B, S, T, H, hkv, hd, causal, mla = CASES[case]
    q, k, v, do, scale = _inputs(*CASES[case])
    qt, kt, vt, dot = (torch.as_tensor(a) for a in (q, k, v, do))
    before = (flash.attention.launches, flash.attention.backward_launches)
    o, lse = flash.attention_forward(qt, kt, vt, scale, causal=causal)
    got = flash.attention_backward(qt, kt, vt, o, lse, dot, scale, causal)
    assert (flash.attention.launches, flash.attention.backward_launches) == before
    want_o = ref_flash.attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), scale,
                                 causal=causal)
    np.testing.assert_allclose(o.numpy(), np.asarray(want_o), **TOL)
    np.testing.assert_allclose(lse.numpy(), _reference_lse(q, k, scale, causal), **TOL)
    leaves = [t.clone().requires_grad_() for t in (qt, kt, vt)]
    want = torch.autograd.grad(flash.attention_plain(*leaves, scale, causal=causal), leaves,
                               dot)
    for g, w, name in zip(got, want, "qkv"):
        assert g.dtype == torch.float32 and g.shape == w.shape, name
        np.testing.assert_allclose(g.numpy(), w.numpy(), err_msg=name, **TOL)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", ["gqa", "ragged S<T causal", "ragged S!=T full"])
def test_autograd_function_saves_lse_and_casts_gradients(case, dtype):
    """``FlashAttention`` on CPU tensors (its forward and backward both take
    the plain route there): the forward's output, and the f32 gradients of
    ``attention_backward`` from the saved output and ``lse`` cast to the
    inputs' dtype, bit for bit; those within 1e-5 of autograd of
    ``attention_plain``."""
    B, S, T, H, hkv, hd, causal, _ = CASES[case]
    q, k, v, do, scale = _inputs(*CASES[case])
    leaves = [torch.as_tensor(a).to(dtype).requires_grad_() for a in (q, k, v)]
    o = flash.FlashAttention.apply(*leaves, scale, causal)
    got = torch.autograd.grad(o, leaves, torch.as_tensor(do))
    f32 = [t.detach().float().requires_grad_() for t in leaves]
    o_plain = flash.attention_plain(*f32, scale, causal=causal)
    assert torch.equal(o.detach(), o_plain.detach())
    lse = flash.attention_lse_plain(*f32, scale, causal=causal)
    want = flash.attention_backward(*(t.detach() for t in f32), o_plain.detach(), lse,
                                    torch.as_tensor(do), scale, causal)
    exact = torch.autograd.grad(o_plain, f32, torch.as_tensor(do))
    for g, w, e in zip(got, want, exact):
        assert g.dtype == dtype
        assert torch.equal(g, w.to(dtype))
        np.testing.assert_allclose(w.numpy(), e.numpy(), **TOL)


def test_backward_raises_off_cpu_and_cuda():
    """A tensor that is neither on the CPU nor on CUDA (nor ``meta``) never
    reaches a kernel and never takes the plain route; ``meta`` tensors (the
    dry run's shapes) take the plain route, explicitly."""

    class Elsewhere(torch.Tensor):
        @staticmethod
        def __new__(cls, shape, dtype=torch.float32):
            return torch.Tensor._make_wrapper_subclass(cls, shape, dtype=dtype, device="xpu")

        @classmethod
        def __torch_dispatch__(cls, func, types, args=(), kwargs=None):
            raise RuntimeError(f"{func} reached a tensor with no data")

    shapes = [(1, 64, 4, 64), (1, 64, 2, 64), (1, 64, 2, 64), (1, 64, 256), (1, 4, 64),
              (1, 64, 256)]
    before = flash.attention.backward_launches
    args = [Elsewhere(s, torch.bfloat16 if i < 3 else torch.float32)
            for i, s in enumerate(shapes)]
    with pytest.raises(ValueError, match="CUDA"):
        flash.attention_backward(*args, 0.125, True)
    meta = [torch.empty(s, device="meta", dtype=torch.bfloat16 if i < 3 else torch.float32)
            for i, s in enumerate(shapes)]
    dq, dk, dv = flash.attention_backward(*meta, 0.125, True)
    assert dq.device.type == "meta" and dq.shape == shapes[0] and dk.shape == shapes[1]
    assert flash.attention.backward_launches == before


# unequal q.k and v dims at their own dims: (B, S, T, H, Hkv, hq, hv, causal)
UNEQUAL = {
    "mla 96/64 causal": (1, 12, 12, 2, 2, 96, 64, True),
    "mla 96/64 full S<T": (1, 9, 20, 4, 2, 96, 64, False),
    "mla 96/64 causal S>T": (2, 20, 9, 2, 1, 96, 64, True),
    "smoke 24/16 causal S<T": (2, 7, 15, 4, 2, 24, 16, True),
    "smoke 24/16 full": (1, 16, 16, 2, 2, 24, 16, False),
}


def _unequal_inputs(B, S, T, H, hkv, hq, hv, causal, seed=1):
    rng = np.random.default_rng(seed)
    q, k, v = (rng.standard_normal((B, n, h, d)).astype(np.float32)
               for n, h, d in [(S, H, hq), (T, hkv, hq), (T, hkv, hv)])
    do = rng.standard_normal((B, S, H * hv)).astype(np.float32)
    return q, k, v, do, 1.0 / np.sqrt(hq)


def _reference_chunked(q, k, v, do, scale, causal):
    """The reference's ``chunked_attention`` (one query block) on the inputs,
    and ``jax.grad`` of its output against ``do``."""
    S = q.shape[1]

    def f(q, k, v):
        return ref_layers.chunked_attention(q, k, v, scale, causal=causal, q_block=S,
                                            out_dtype=jnp.float32)

    def loss(q, k, v):
        return jnp.sum(f(q, k, v) * jnp.asarray(do))

    args = tuple(jnp.asarray(a) for a in (q, k, v))
    return np.asarray(f(*args)), [np.asarray(g) for g in jax.grad(loss, (0, 1, 2))(*args)]


@pytest.mark.parametrize("case", UNEQUAL)
def test_plain_versions_at_unequal_dims_match_reference_chunked_attention(case):
    """``attention_plain``, ``attention_lse_plain`` and
    ``attention_backward_blocked`` at unequal q.k and v dims: the output,
    the row statistics and dq, dk, dv of ``jax.grad`` of the reference's
    ``chunked_attention``, and autograd of ``attention_plain`` the same."""
    B, S, T, H, hkv, hq, hv, causal = UNEQUAL[case]
    q, k, v, do, scale = _unequal_inputs(*UNEQUAL[case])
    want_o, want = _reference_chunked(q, k, v, do, scale, causal)
    qt, kt, vt, dot = (torch.as_tensor(a) for a in (q, k, v, do))
    o = flash.attention_plain(qt, kt, vt, scale, causal=causal)
    assert o.shape == (B, S, H * hv)
    np.testing.assert_allclose(o.numpy(), want_o, **TOL)
    lse = flash.attention_lse_plain(qt, kt, vt, scale, causal=causal)
    np.testing.assert_allclose(lse.numpy(), _reference_lse(q, k, scale, causal), **TOL)
    blocked = flash.attention_backward_blocked(qt, kt, vt, o, dot, scale, causal, q_block=5)
    leaves = [t.clone().requires_grad_() for t in (qt, kt, vt)]
    autograd = torch.autograd.grad(flash.attention_plain(*leaves, scale, causal=causal), leaves,
                                   dot)
    for name, b, a, w in zip("qkv", blocked, autograd, want):
        assert b.shape == w.shape and a.shape == w.shape, name
        np.testing.assert_allclose(b.numpy(), w, err_msg=f"blocked d{name}", **TOL)
        np.testing.assert_allclose(a.numpy(), w, err_msg=f"autograd d{name}", **TOL)


def _padded_route(q, k, v, scale, causal):
    """The route MLA took before the wrappers took unequal dims: q, k, v
    zero-padded to the kernels' head dim, ``attention_plain``, and each
    head's first hv output columns."""
    B, S, H, hq = q.shape
    hv = v.shape[-1]
    hd = flash.padded_dim(hq, hv)
    o = flash.attention_plain(*(torch.nn.functional.pad(t, (0, hd - t.shape[-1]))
                                for t in (q, k, v)), scale, causal=causal)
    return o.reshape(B, S, H, hd)[..., :hv].reshape(B, S, H * hv)


@pytest.mark.parametrize("case", UNEQUAL)
def test_unequal_dims_through_attend_and_the_function_equal_the_padded_route(case):
    """``layers.attend`` (the plain route on CPU tensors) and ``FlashAttention``
    on CPU tensors at the unpadded dims give the padded route's output and
    gradients; the Function's gradients come back at q's, k's and v's own
    dims and dtype."""
    B, S, T, H, hkv, hq, hv, causal = UNEQUAL[case]
    q, k, v, do, scale = _unequal_inputs(*UNEQUAL[case])
    dot = torch.as_tensor(do)

    def grads(fn):
        leaves = [torch.as_tensor(a).requires_grad_() for a in (q, k, v)]
        out = fn(*leaves)
        return out.detach(), torch.autograd.grad(out, leaves, dot)

    want_o, want = grads(lambda *t: _padded_route(*t, scale, causal))
    for label, fn in [("attend", lambda *t: layers.attend(*t, scale, torch.float32,
                                                          causal=causal)),
                      ("FlashAttention", lambda *t: flash.FlashAttention.apply(*t, scale,
                                                                               causal))]:
        got_o, got = grads(fn)
        np.testing.assert_allclose(got_o.numpy(), want_o.numpy(), err_msg=label, **TOL)
        for name, g, w in zip("qkv", got, want):
            assert g.shape == w.shape and g.dtype == torch.float32, (label, name)
            np.testing.assert_allclose(g.numpy(), w.numpy(), err_msg=f"{label} d{name}", **TOL)


@pytest.mark.parametrize("dtype,hq,hv,want,padded", [
    (torch.bfloat16, 96, 64, "wgmma", 128), (torch.bfloat16, 24, 16, "fma", 32),
    (torch.float32, 96, 64, "fma", 128), (torch.bfloat16, 128, 128, "wgmma", 128),
    (torch.bfloat16, 64, 64, "wgmma", 64), (torch.bfloat16, 32, 32, "fma", 32),
])
def test_route_and_padded_dim_of_unequal_dims(dtype, hq, hv, want, padded):
    """``route`` decides from the dtype and both head dims alone: bf16 at (64,
    64), (128, 128) and MLA's (96, 64) on the tensor cores (forward and
    backward on q, k, v unpadded), all else FMA (on q, k, v padded to
    ``padded_dim`` where their dims differ)."""
    assert flash.route(dtype, hq, hv) == want
    assert flash.padded_dim(hq, hv) == padded
