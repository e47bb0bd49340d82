"""The port's RULES matcher vs the reference's, on the CPU.

RULES is a monotone fixpoint on small integer counts, so its masks must
be bit-identical to the reference's, and ``resolve`` with it must give
the reference's match gids.  RULES has no ``score``, so MMP refuses it
in both packages.
"""

from __future__ import annotations

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from tests.conftest import random_neighborhood_batch  # noqa: E402
from repro.core import pipeline as ref_pipeline  # noqa: E402
from repro.core import rules as ref_rules  # noqa: E402
from repro_torch import interop  # noqa: E402
from repro_torch.core import pipeline, rules  # noqa: E402
from repro_torch.core.mln import ground_structure  # noqa: E402
from repro_torch.data import synthetic  # noqa: E402


def _evidence(rng, batch, p_pos=0.15, p_neg=0.1):
    shape = batch.pair_mask.shape
    return rng.random(shape) < p_pos, rng.random(shape) < p_neg


def _assert_same_run(batch_ref, ev_pos=None, ev_neg=None):
    port = rules.RulesMatcher(device="cpu")
    batch = interop.batch_from_arrays(batch_ref)
    want = ref_rules.RulesMatcher().run(batch_ref, ev_pos, ev_neg)
    got = port.run(batch, ev_pos, ev_neg)
    assert got.dtype == np.bool_ and got.shape == want.shape
    np.testing.assert_array_equal(got, want)
    x, lab = port.run_with_messages(batch, ev_pos, ev_neg)
    np.testing.assert_array_equal(x, want)
    assert lab.dtype == np.int32 and (lab == want.shape[1]).all()


@pytest.mark.parametrize("k", [5, 8])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_random_batches_bit_identical(k, seed):
    rng = np.random.default_rng(seed * 31 + k)
    batch = random_neighborhood_batch(rng, B=4, k=k)
    _assert_same_run(batch)
    _assert_same_run(batch, *_evidence(rng, batch))


@pytest.fixture(scope="module")
def hepth_packed(hepth_small):
    packed, _, _ = ref_pipeline.prepare(hepth_small.entities, hepth_small.relations)
    return packed


def test_hepth_bins_bit_identical(hepth_packed):
    """Whole bins (B > 1 lanes that converge at different iterations)."""
    rng = np.random.default_rng(11)
    for _, nb in sorted(hepth_packed.bins.items()):
        _assert_same_run(nb)
        _assert_same_run(nb, *_evidence(rng, nb, p_pos=0.05, p_neg=0.05))


def test_single_row_fixpoint_equals_batch_row(hepth_packed):
    rng = np.random.default_rng(4)
    for _, nb in sorted(hepth_packed.bins.items()):
        batch = interop.batch_from_arrays(nb)
        lev, valid, n_shared, link = ground_structure(batch, "cpu")
        ev_pos, ev_neg = (torch.as_tensor(m) for m in _evidence(rng, nb, 0.05, 0.05))
        whole = rules.rules_fixpoint_batch(lev, n_shared, link, ev_pos, ev_neg, valid)
        for b in range(nb.batch):
            row = rules._rules_fixpoint(
                lev[b], n_shared[b], link[b], ev_pos[b], ev_neg[b], valid[b])
            assert torch.equal(row, whole[b]), b


@pytest.fixture(scope="module")
def prepared(hepth_small, dblp_small):
    """Per corpus: (reference dataset, port dataset, reference prepare, port prepare),
    the port's dataset made by the port's generator from the fixture's config."""
    out = {}
    for kind, ds_r, (scale, seed) in (("hepth", hepth_small, (0.035, 7)),
                                      ("dblp", dblp_small, (0.035, 11))):
        ds_p = synthetic.make_dataset(
            getattr(synthetic.SynthConfig, kind)(scale=scale, seed=seed))
        ref = ref_pipeline.prepare(ds_r.entities, ds_r.relations)
        port = pipeline.prepare(ds_p.entities, ds_p.relations, device="cpu")
        out[kind] = (ds_r, ds_p, ref, port)
    return out


@pytest.mark.parametrize("kind", ["hepth", "dblp"])
@pytest.mark.parametrize("scheme", ["nomp", "smp"])
def test_resolve_identical(prepared, kind, scheme):
    ds_r, ds_p, (pk_r, gg_r, _), (pk_p, gg_p, _) = prepared[kind]
    want = ref_pipeline.resolve(ds_r.entities, ds_r.relations, scheme=scheme, packed=pk_r,
                                gg=gg_r, matcher=ref_rules.RulesMatcher())
    got = pipeline.resolve(ds_p.entities, ds_p.relations, scheme=scheme, packed=pk_p, gg=gg_p,
                           matcher=rules.RulesMatcher(device="cpu"), device="cpu")
    assert len(want.result.matches) > 0
    np.testing.assert_array_equal(got.result.matches.gids, want.result.matches.gids)
    np.testing.assert_array_equal(got.closed.gids, want.closed.gids)
    for f in ("neighborhood_evals", "messages_emitted", "messages_promoted"):
        assert getattr(got.result, f) == getattr(want.result, f), f


def test_mmp_refuses_rules_in_both_packages(prepared):
    ds_r, ds_p, (pk_r, gg_r, _), (pk_p, gg_p, _) = prepared["hepth"]
    assert not hasattr(rules.RulesMatcher, "score")
    assert rules.RulesMatcher.is_probabilistic is False
    assert rules.RulesMatcher(device="cpu").parallel_backend() == ("rules", None)
    with pytest.raises(AssertionError, match="Type-II"):
        ref_pipeline.resolve(ds_r.entities, ds_r.relations, scheme="mmp", packed=pk_r, gg=gg_r,
                             matcher=ref_rules.RulesMatcher())
    with pytest.raises(AssertionError, match="Type-II"):
        pipeline.resolve(ds_p.entities, ds_p.relations, scheme="mmp", packed=pk_p, gg=gg_p,
                         matcher=rules.RulesMatcher(device="cpu"), device="cpu")
