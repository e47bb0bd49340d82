"""The port's MLN matcher vs the reference's, on the CPU.

Match masks and component labels must be bit-identical (the drivers turn
labels into maximal messages), scores equal within the kernel tolerance
of ``tests/test_kernels.py``, and the paper's Fig. 1 narrative must hold
on the port, including the collective chain only joint promotion finds.
"""

from __future__ import annotations

import numpy as np
import pytest

pytest.importorskip("torch")

from tests.conftest import random_neighborhood_batch  # noqa: E402
from repro.core import fig1 as ref_fig1  # noqa: E402
from repro.core import mln as ref_mln  # noqa: E402
from repro.core.pipeline import prepare as ref_prepare  # noqa: E402
from repro_torch import interop  # noqa: E402
from repro_torch.core import fig1, matcher as port_matcher, mln  # noqa: E402
from repro_torch.core.driver import run_mmp, run_nomp, run_smp  # noqa: E402
from repro_torch.core.global_grounding import build_global_grounding  # noqa: E402
from repro_torch.core.types import MatchStore  # noqa: E402

WEIGHTS = {"paper": (ref_mln.PAPER_LEARNED, mln.PAPER_LEARNED),
           "pedagogical": (ref_mln.PEDAGOGICAL, mln.PEDAGOGICAL)}


def _matchers(which, collective=True):
    w_ref, w_port = WEIGHTS[which]
    return (ref_mln.MLNMatcher(w_ref, collective=collective),
            mln.MLNMatcher(w_port, collective=collective, device="cpu"))


def _evidence(rng, batch, p_pos=0.15, p_neg=0.1):
    shape = batch.pair_mask.shape
    return rng.random(shape) < p_pos, rng.random(shape) < p_neg


def _assert_same_run(ref, port, batch_ref, ev_pos=None, ev_neg=None):
    batch = interop.batch_from_arrays(batch_ref)
    x_r, lab_r = ref.run_with_messages(batch_ref, ev_pos, ev_neg)
    x_p, lab_p = port.run_with_messages(batch, ev_pos, ev_neg)
    assert x_p.dtype == np.bool_ and lab_p.dtype == np.int32
    np.testing.assert_array_equal(x_p, x_r)
    np.testing.assert_array_equal(lab_p, lab_r)


@pytest.mark.parametrize("which", ["paper", "pedagogical"])
@pytest.mark.parametrize("k", [5, 8])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_random_batches_bit_identical(which, k, seed):
    rng = np.random.default_rng(seed * 31 + k)
    batch = random_neighborhood_batch(rng, B=4, k=k)
    ref, port = _matchers(which)
    _assert_same_run(ref, port, batch)
    _assert_same_run(ref, port, batch, *_evidence(rng, batch))


@pytest.mark.parametrize("which", ["paper", "pedagogical"])
def test_closure_only_bit_identical(which):
    rng = np.random.default_rng(5)
    batch = random_neighborhood_batch(rng, B=3, k=6)
    ref, port = _matchers(which, collective=False)
    ev_pos, ev_neg = _evidence(rng, batch)
    np.testing.assert_array_equal(
        port.closure_only(interop.batch_from_arrays(batch), ev_pos, ev_neg),
        ref.closure_only(batch, ev_pos, ev_neg),
    )
    _assert_same_run(ref, port, batch, ev_pos, ev_neg)


@pytest.fixture(scope="module")
def hepth_packed(hepth_small):
    packed, _, _ = ref_prepare(hepth_small.entities, hepth_small.relations)
    return packed


@pytest.mark.parametrize("which", ["paper", "pedagogical"])
def test_hepth_bins_bit_identical(hepth_packed, which):
    """Whole bins (B > 1 lanes that converge at different rounds)."""
    ref, port = _matchers(which)
    rng = np.random.default_rng(11)
    for k, nb in sorted(hepth_packed.bins.items()):
        _assert_same_run(ref, port, nb)
        _assert_same_run(ref, port, nb, *_evidence(rng, nb, p_pos=0.05, p_neg=0.05))


@pytest.mark.parametrize("which", ["paper", "pedagogical"])
def test_score_agrees(hepth_packed, which):
    ref, port = _matchers(which)
    rng = np.random.default_rng(2)
    for nb in hepth_packed.bins.values():
        x = rng.random(nb.pair_mask.shape) < 0.3
        got = port.score(interop.batch_from_arrays(nb), x)
        assert got.dtype == np.float32 and got.shape == (nb.batch,)
        np.testing.assert_allclose(got, ref.score(nb, x), rtol=2e-5, atol=2e-4)


def test_ground_matches_reference(hepth_packed):
    nb_ref = hepth_packed.bins[16]
    g_r = ref_mln.ground(nb_ref, ref_mln.PAPER_LEARNED)
    g_p = mln.ground(interop.batch_from_arrays(nb_ref), mln.PAPER_LEARNED, device="cpu")
    for f in ("u", "u_raw", "C", "valid"):
        np.testing.assert_array_equal(getattr(g_p, f).numpy(), np.asarray(getattr(g_r, f)))


# -- the paper's Fig. 1 / Fig. 2 instance on the port -------------------------


@pytest.fixture(scope="module")
def fig1_port():
    packed = fig1.packed_cover()
    gg = build_global_grounding(packed.pair_levels, fig1.relations(), mln.PEDAGOGICAL)
    return packed, gg, mln.MLNMatcher(mln.PEDAGOGICAL, device="cpu")


def test_fig1_cover_identical(fig1_packed):
    port = fig1.packed_cover()
    for f in interop.BATCH_FIELDS:
        np.testing.assert_array_equal(getattr(port.bins[8], f), getattr(fig1_packed.bins[8], f))
    assert port.pair_levels == fig1_packed.pair_levels


@pytest.mark.parametrize("scheme", ["nomp", "smp", "mmp"])
def test_fig1_schemes_match_paper(fig1_port, scheme):
    packed, gg, m = fig1_port
    res = {"nomp": lambda: run_nomp(packed, m), "smp": lambda: run_smp(packed, m),
           "mmp": lambda: run_mmp(packed, m, gg)}[scheme]()
    want = {"nomp": fig1.EXPECTED_NOMP, "smp": fig1.EXPECTED_SMP, "mmp": fig1.EXPECTED_MMP}
    assert fig1.names_of(res.matches) == want[scheme]


def test_fig1_collective_chain_matched_jointly(fig1_port):
    """{(a1,a2),(b2,b3),(c2,c3)}: every pair alone has negative delta, and
    only joint promotion matches them (§2.1: 3 x (-5) + 2 x 8 = +1)."""
    _, _, m = fig1_port
    batch = fig1.full_batch()
    x = m.run(batch)
    got = fig1.names_of(MatchStore(batch.pair_gid[x & (batch.pair_gid >= 0)]))
    assert got == fig1.EXPECTED_FULL
    chain = {("a1", "a2"), ("b2", "b3"), ("c2", "c3")}
    greedy = m.closure_only(batch)
    greedy_names = fig1.names_of(MatchStore(batch.pair_gid[greedy & (batch.pair_gid >= 0)]))
    assert chain <= got and not (chain & greedy_names)
    x_ref = ref_mln.MLNMatcher(ref_mln.PEDAGOGICAL).run(ref_fig1.full_batch())
    np.testing.assert_array_equal(x, x_ref)


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_fig1_order_invariance(fig1_port, seed):
    packed, gg, m = fig1_port
    order = list(np.random.default_rng(seed).permutation(packed.num_neighborhoods))
    assert fig1.names_of(run_smp(packed, m, order=order).matches) == fig1.EXPECTED_SMP
    assert fig1.names_of(run_mmp(packed, m, gg, order=order).matches) == fig1.EXPECTED_MMP


def test_fig1_score_arithmetic(fig1_port):
    """The -5/+8 arithmetic: {c1,c2} scores +3; the 3-chain adds +1."""
    _, _, m = fig1_port
    batch = fig1.full_batch()
    x0 = np.zeros(batch.sim_level.shape, dtype=bool)

    def with_pairs(pairs):
        x = x0.copy()
        for a, b in pairs:
            x[0, np.where(batch.pair_gid[0] == fig1.gid_of(a, b))[0][0]] = True
        return x

    s_empty = m.score(batch, x0)[0]
    assert np.isclose(m.score(batch, with_pairs([("c1", "c2")]))[0] - s_empty, 3.0, atol=1e-4)
    base = [("c1", "c2"), ("b1", "b2")]
    chain = [("a1", "a2"), ("b2", "b3"), ("c2", "c3")]
    gain = m.score(batch, with_pairs(base + chain))[0] - m.score(batch, with_pairs(base))[0]
    assert np.isclose(gain, 1.0, atol=1e-4)


def test_axiom_checkers_on_port(fig1_port):
    """Def. 2/3/6 hold for the port's matcher on random instances."""
    _, _, m = fig1_port
    rng = np.random.default_rng(4)
    batch = interop.batch_from_arrays(random_neighborhood_batch(rng, B=3, k=6))
    ev_pos, ev_neg = _evidence(rng, batch)
    assert port_matcher.check_idempotence(m, batch, ev_pos, None)[0]
    more_pos, more_neg = _evidence(rng, batch)
    assert port_matcher.check_monotone_evidence(m, batch, ev_pos, ev_pos | more_pos)[0]
    assert port_matcher.check_monotone_negative(m, batch, ev_neg, ev_neg | more_neg)[0]
    s = rng.random(batch.pair_mask.shape) < 0.2
    t = s | (rng.random(batch.pair_mask.shape) < 0.3)
    p = rng.integers(0, batch.num_pairs, size=batch.batch)
    s[np.arange(batch.batch), p] = False  # Def. 6 is for p not already in T
    t[np.arange(batch.batch), p] = False
    assert port_matcher.check_supermodular(m, batch, s, t, p)[0]
    assert isinstance(m, port_matcher.TypeIIMatcher)
