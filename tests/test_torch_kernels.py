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
from repro.kernels.icm_sweep import kernel as ref_icm  # noqa: E402
from repro.kernels.mln_score import kernel as ref_score  # noqa: E402
from repro.kernels.ngram_sim import kernel as ref_sim  # noqa: E402
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


@pytest.mark.parametrize("M,N,F", [(1, 70, 96), (1, 130, 128), (8, 8, 32), (100, 70, 96)])
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


@pytest.mark.parametrize("B,S,P", [(1, 1, 8), (2, 4, 16), (3, 5, 96), (2, 1, 130)])
def test_mln_score_sets(B, S, P):
    rng = np.random.default_rng(B * 100 + S * 10 + P)
    u = rng.standard_normal((B, P)).astype(np.float32)
    C = _sym_nonneg(rng, B, P, P)
    X = (rng.random((B, S, P)) < 0.4).astype(np.float32)
    want = ref_score.score_sets(u, C, X, interpret=True)
    got = score.score_sets(_t(u), _t(C), _t(X))
    assert tuple(got.shape) == (B, S)
    assert_allclose(got.numpy(), want, rtol=2e-5, atol=2e-4)


@pytest.mark.parametrize("n", [1, 5, 8, 33, 127, 128, 496])
def test_tiling_helpers_match_reference(n):
    from repro.kernels import common as ref_common
    from repro_torch.kernels import common

    assert common.pick_tile(n) == ref_common.pick_tile(n)
    assert common.pick_tile(n, 32, 4) == ref_common.pick_tile(n, 32, 4)
    assert common.round_up(n, 8) == ref_common.round_up(n, 8)
