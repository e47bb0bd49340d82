"""The port's kernel wrappers on CPU tensors (their plain versions) vs the
reference's Pallas kernels in interpret mode, on the same numpy inputs.

Tolerances are those of ``tests/test_kernels.py``: the two sides sum the
same float32 products in a different order.
"""

from __future__ import annotations

import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.kernels.common import assert_allclose  # noqa: E402
from repro.kernels.flash_attn import kernel as ref_flash  # noqa: E402
from repro.kernels.flash_attn import ref as ref_attention  # noqa: E402
from repro.kernels.icm_sweep import kernel as ref_icm  # noqa: E402
from repro.kernels.mln_score import kernel as ref_score  # noqa: E402
from repro.kernels.ngram_sim import kernel as ref_sim  # noqa: E402
from repro_torch.kernels.flash_attn import ops as flash  # noqa: E402
from repro_torch.kernels.icm_sweep import ops as icm  # noqa: E402
from repro_torch.kernels.mln_score import ops as score  # noqa: E402
from repro_torch.kernels.ngram_sim import ops as sim  # noqa: E402


def _t(a):
    return torch.as_tensor(np.asarray(a))


def _sym_nonneg(rng, *shape):
    C = np.abs(rng.standard_normal(shape)).astype(np.float32)
    up = np.triu(C, 1)
    return up + np.swapaxes(up, -1, -2)


@pytest.mark.parametrize("P", [8, 33, 130])
@pytest.mark.parametrize("S", [1, 8, 40])
def test_icm_sweep_matrix(P, S):
    rng = np.random.default_rng(P * 1000 + S)
    u = rng.standard_normal(P).astype(np.float32)
    C = _sym_nonneg(rng, P, P)
    X = (rng.random((S, P)) < 0.3).astype(np.float32)
    want = ref_icm.sweep_matrix(u, C, X, interpret=True)
    got = icm.sweep_matrix(_t(u), _t(C), _t(X))
    assert tuple(got.shape) == (S, P)
    assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("P", [8, 57, 128])
def test_icm_sweep_vector(P):
    rng = np.random.default_rng(P)
    u = rng.standard_normal(P).astype(np.float32)
    C = np.abs(rng.standard_normal((P, P))).astype(np.float32)
    x = (rng.random(P) < 0.5).astype(np.float32)
    want = ref_icm.sweep(u, C, x, interpret=True)
    assert_allclose(icm.sweep(_t(u), _t(C), _t(x)).numpy(), want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("B,P", [(1, 8), (3, 28), (4, 96)])
def test_icm_sweep_batch(B, P):
    rng = np.random.default_rng(B * 100 + P)
    u = rng.standard_normal((B, P)).astype(np.float32)
    C = _sym_nonneg(rng, B, P, P)
    X = (rng.random((B, P)) < 0.4).astype(np.float32)
    want = ref_icm.sweep_batch(u, C, X, interpret=True)
    assert_allclose(icm.sweep_batch(_t(u), _t(C), _t(X)).numpy(), want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("B,S,P", [(2, 1, 28), (3, 5, 33), (2, 28, 28)])
def test_icm_sweep_batched_bsp(B, S, P):
    """The port's one batched form (B, S, P) vs the vmapped Pallas sweep_matrix."""
    rng = np.random.default_rng(B * 10000 + S * 100 + P)
    u = rng.standard_normal((B, P)).astype(np.float32)
    C = _sym_nonneg(rng, B, P, P)
    X = (rng.random((B, S, P)) < 0.3).astype(np.float32)
    want = jax.vmap(lambda a, b, c: ref_icm.sweep_matrix(a, b, c, interpret=True))(u, C, X)
    got = icm.sweep_batched(_t(u), _t(C), _t(X))
    assert tuple(got.shape) == (B, S, P)
    assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("M,N,F", [
    (1, 70, 96), (1, 130, 128), (8, 8, 32), (100, 70, 96),
    # chip_smoke.py's phase-2 shapes: the canopy's second chunk, the stream
    # probe's two ends, a ragged F, and an F that is not a multiple of 4
    (1, 818, 128), (64, 65, 128), (68, 1697, 128), (3, 70, 100), (5, 37, 30),
])
@pytest.mark.parametrize("threshold", [0.0, -2.0, 0.7])
def test_ngram_sim(M, N, F, threshold):
    rng = np.random.default_rng(M + N + F)
    A = rng.standard_normal((M, F)).astype(np.float32)
    B = rng.standard_normal((N, F)).astype(np.float32)
    A /= np.linalg.norm(A, axis=1, keepdims=True)
    B /= np.linalg.norm(B, axis=1, keepdims=True)
    want = ref_sim.sim_above(A, B, threshold, interpret=True)
    got = sim.sim_above(_t(A), _t(B), threshold)
    assert tuple(got.shape) == (M, N)
    assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


def test_ngram_sim_matrix_keeps_every_cosine():
    rng = np.random.default_rng(3)
    A = rng.standard_normal((5, 32)).astype(np.float32)
    B = rng.standard_normal((9, 32)).astype(np.float32)
    A /= np.linalg.norm(A, axis=1, keepdims=True)
    B /= np.linalg.norm(B, axis=1, keepdims=True)
    want = ref_sim.sim_matrix(A, B, interpret=True)
    assert_allclose(sim.sim_matrix(_t(A), _t(B)).numpy(), want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("B,S,P,x_kind", [
    pytest.param(*shape, "binary", id="-".join(map(str, shape)))
    for shape in [(1, 1, 8), (2, 4, 16), (3, 5, 96), (2, 1, 130)]
] + [
    # the cases the CUDA kernel's skip of absent rows must get right: an
    # all-zero x (the linear term alone, 0), X that is not 0/1 (with zeros
    # and -0.0 among its values), and the match sets' sparsity (~7%)
    pytest.param(3, 2, 120, "zero", id="zero-x"),
    pytest.param(2, 3, 130, "real", id="non-binary"),
    pytest.param(4, 1, 496, "sparse", id="sparse-7pct"),
])
def test_mln_score_sets(B, S, P, x_kind):
    rng = np.random.default_rng(B * 100 + S * 10 + P)
    u = rng.standard_normal((B, P)).astype(np.float32)
    C = _sym_nonneg(rng, B, P, P)
    X = {
        "binary": lambda: rng.random((B, S, P)) < 0.4,
        "zero": lambda: np.zeros((B, S, P)),
        "real": lambda: rng.standard_normal((B, S, P)) * (rng.random((B, S, P)) < 0.3) * -1.0,
        "sparse": lambda: rng.random((B, S, P)) < 0.07,
    }[x_kind]().astype(np.float32)
    want = ref_score.score_sets(u, C, X, interpret=True)
    got = score.score_sets(_t(u), _t(C), _t(X))
    assert tuple(got.shape) == (B, S)
    assert_allclose(got.numpy(), want, rtol=2e-5, atol=2e-4)
    if x_kind == "zero":
        assert not got.any()


@pytest.mark.parametrize("n", [1, 5, 8, 33, 127, 128, 496])
def test_tiling_helpers_match_reference(n):
    from repro.kernels import common as ref_common
    from repro_torch.kernels import common

    assert common.pick_tile(n) == ref_common.pick_tile(n)
    assert common.pick_tile(n, 32, 4) == ref_common.pick_tile(n, 32, 4)
    assert common.round_up(n, 8) == ref_common.round_up(n, 8)


# (S, T, H, Hkv, hd): the shapes of tests/test_kernels.py::test_flash_attn, a
# ragged S = T = 100, and S < T (causal stays top-left aligned)
FLASH_SHAPES = [
    (128, 128, 4, 2, 32), (256, 256, 2, 2, 64), (192, 192, 4, 1, 32),
    (100, 100, 4, 2, 16), (40, 100, 4, 2, 8),
]


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("S,T,H,hkv,hd", FLASH_SHAPES)
def test_flash_attn(S, T, H, hkv, hd, causal):
    """The plain version vs the jnp oracle (same math in f32: 1e-5) and vs the
    Pallas kernel in interpret mode (online softmax: 2e-3, as in test_kernels)."""
    rng = np.random.default_rng(S + H)
    B = 2
    q = rng.standard_normal((B, S, H, hd)).astype(np.float32)
    k = rng.standard_normal((B, T, hkv, hd)).astype(np.float32)
    v = rng.standard_normal((B, T, hkv, hd)).astype(np.float32)
    scale = 1.0 / np.sqrt(hd)
    got = flash.attention(_t(q), _t(k), _t(v), scale, causal=causal)
    assert tuple(got.shape) == (B, S, H * hd) and got.dtype == torch.float32
    want = ref_attention.attention(q, k, v, scale, causal=causal)
    assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
    pallas = ref_flash.flash_attention(q, k, v, scale, causal=causal, interpret=True)
    assert_allclose(got.numpy(), pallas, rtol=2e-3, atol=2e-3)


def test_flash_attn_bf16_inputs():
    """bf16 inputs (what the model gives) are upcast and accumulate in f32."""
    rng = np.random.default_rng(7)
    q, k, v = (rng.standard_normal(s).astype(np.float32)
               for s in [(2, 32, 8, 16), (2, 32, 2, 16), (2, 32, 2, 16)])
    qb, kb, vb = (_t(a).to(torch.bfloat16) for a in (q, k, v))
    got = flash.attention(qb, kb, vb, 0.25, causal=True)
    want = ref_attention.attention(*(jax.numpy.asarray(a).astype(jax.numpy.bfloat16)
                                     for a in (q, k, v)), 0.25, causal=True)
    assert got.dtype == torch.float32
    assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("dtype,hd,want", [
    (torch.bfloat16, 128, "wgmma"), (torch.bfloat16, 64, "wgmma"),
    (torch.bfloat16, 32, "fma"), (torch.bfloat16, 16, "fma"), (torch.bfloat16, 8, "fma"),
    (torch.float32, 128, "fma"), (torch.float32, 64, "fma"), (torch.float32, 8, "fma"),
])
def test_flash_attn_route(dtype, hd, want):
    """bf16 at hd 64 or 128 takes the tensor-core kernel; everything else the FMA one."""
    assert flash.route(dtype, hd) == want


def _bf16(a):
    return torch.as_tensor(a).to(torch.bfloat16).float()


def _emulate_wgmma_attention(q, k, v, scale, causal, split=True, bk=64):
    """The tensor-core kernel's rounding on the CPU: bf16 inputs, f32 scores
    in log2 units, an online softmax over key tiles of ``bk``, f32 row sums,
    and P.V from bf16 P: ``P_hi + P_lo`` with ``split``, else ``P_hi`` alone."""
    B, S, H, hd = q.shape
    T, hkv = k.shape[1], k.shape[2]
    g = H // hkv
    qh = q.permute(0, 2, 1, 3)  # (B, H, S, hd)
    kh = k.permute(0, 2, 1, 3).repeat_interleave(g, dim=1)
    vh = v.permute(0, 2, 1, 3).repeat_interleave(g, dim=1)
    c = scale * float(np.log2(np.e))
    rows = torch.arange(S)[:, None]
    m = torch.full((B, H, S, 1), flash.NEG_INF)
    l = torch.zeros((B, H, S, 1))
    o = torch.zeros((B, H, S, hd))
    for k0 in range(0, T, bk):
        cols = torch.arange(k0, min(k0 + bk, T))[None, :]
        x = (qh @ kh[:, :, k0:k0 + bk].transpose(-1, -2)) * c
        if causal:
            x = torch.where(cols > rows, torch.tensor(flash.NEG_INF), x)
        m_new = torch.maximum(m, x.amax(-1, keepdim=True))
        alpha = torch.exp2(m - m_new)
        p = torch.exp2(x - m_new)
        l = l * alpha + p.sum(-1, keepdim=True)
        hi = p.to(torch.bfloat16).float()
        lo = (p - hi).to(torch.bfloat16).float()
        vt = vh[:, :, k0:k0 + bk]
        o = o * alpha + hi @ vt + (lo @ vt if split else 0)
        m = m_new
    o = o / l.clamp_min(1e-30)
    return o.permute(0, 2, 1, 3).reshape(B, S, H * hd)


@pytest.mark.parametrize("B,S,H,hkv,hd", [
    (4, 32, 32, 4, 128),  # Yi-6B's request prefill
    (8, 32, 4, 4, 8),  # the embedding matcher's em_encoder
])
def test_flash_attn_wgmma_rounding_within_check(B, S, H, hkv, hd):
    """The tensor-core kernel's rounding stays within chip_smoke's 2e-3 of the
    f32 reference on bf16 inputs; with one bf16 P it errs far more."""
    rng = np.random.default_rng(B * 1000 + hd)
    q, k, v = (_bf16(rng.standard_normal(s).astype(np.float32))
               for s in [(B, S, H, hd), (B, S, hkv, hd), (B, S, hkv, hd)])
    scale = 1.0 / np.sqrt(hd)
    want = np.asarray(ref_attention.attention(q.numpy(), k.numpy(), v.numpy(), scale,
                                              causal=True))
    got = _emulate_wgmma_attention(q, k, v, scale, causal=True).numpy()
    assert_allclose(got, want, rtol=2e-3, atol=2e-3)
    one = _emulate_wgmma_attention(q, k, v, scale, causal=True, split=False).numpy()
    assert np.abs(one - want).max() > 10 * np.abs(got - want).max()


@pytest.mark.parametrize("S", [1, 496])
def test_icm_sweep_plain_at_path_inputs(S):
    """The plain version vs the Pallas sweep at the k=32 bin's inputs:
    C = w_co * link (symmetric, binary link), binary X, P = 496."""
    rng = np.random.default_rng(S)
    P, w_co = 496, 2.46
    link = np.triu(rng.random((P, P)) < 0.02, 1)
    C = (w_co * (link | link.T)).astype(np.float32)
    u = rng.standard_normal(P).astype(np.float32)
    X = (rng.random((S, P)) < 0.3).astype(np.float32)
    want = ref_icm.sweep_matrix(u, C, X, interpret=True)
    got = icm.sweep_matrix(_t(u), _t(C), _t(X))
    assert tuple(got.shape) == (S, P)
    assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


class _Elsewhere(torch.Tensor):
    """A tensor on a device with neither a kernel nor a plain route (``xpu``),
    holding no data: any operation on it raises."""

    @staticmethod
    def __new__(cls, shape, dtype):
        return torch.Tensor._make_wrapper_subclass(cls, shape, dtype=dtype, device="xpu")

    @classmethod
    def __torch_dispatch__(cls, func, types, args=(), kwargs=None):
        raise RuntimeError(f"{func} reached a tensor with no data")


@pytest.mark.parametrize("hd", [64, 128])
def test_flash_attn_wgmma_route_raises_off_cuda(hd):
    """A bf16 call that would take the tensor-core kernel raises on a tensor
    that is neither on the CPU nor on CUDA (nor ``meta``, the dry run's
    shapes, which take the plain version), and launches nothing."""
    shapes = [(1, 64, 8, hd), (1, 64, 2, hd), (1, 64, 2, hd)]
    q, k, v = (_Elsewhere(s, torch.bfloat16) for s in shapes)
    before = (flash.attention.launches, flash.attention.wgmma_launches)
    with pytest.raises(ValueError, match="CUDA"):
        flash.attention(q, k, v, 0.125)
    meta = [torch.empty(s, device="meta", dtype=torch.bfloat16) for s in shapes]
    assert flash.attention(*meta, 0.125).device.type == "meta"
    assert (flash.attention.launches, flash.attention.wgmma_launches) == before
