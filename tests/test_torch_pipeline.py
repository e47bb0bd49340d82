"""The port's pipeline (cover -> grounding -> NO-MP/SMP/MMP -> P/R/F1) vs the
reference's, on the CPU.

The same corpus goes through both packages' ``prepare`` and ``resolve``:
covers, packed arrays and global-grounding arrays are identical, and so
are the match gids, the evaluation and message counters and the P/R/F1.
State carried across with :mod:`repro_torch.interop` gives the same run.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import pytest

pytest.importorskip("torch")

from repro.core import pipeline as ref_pipeline  # noqa: E402
from repro.data import synthetic as ref_synth  # noqa: E402
from repro_torch import interop  # noqa: E402
from repro_torch.core import pipeline  # noqa: E402
from repro_torch.data import synthetic  # noqa: E402

CORPORA = {"hepth": (0.035, 7), "dblp": (0.035, 11)}
SCHEMES = ("nomp", "smp", "mmp")


@pytest.fixture(scope="module")
def runs():
    """Per corpus: (reference dataset, port dataset, ref prepare, port prepare)."""
    out = {}
    for kind, (scale, seed) in CORPORA.items():
        ds_r = ref_synth.make_dataset(getattr(ref_synth.SynthConfig, kind)(scale=scale, seed=seed))
        ds_p = synthetic.make_dataset(getattr(synthetic.SynthConfig, kind)(scale=scale, seed=seed))
        ref = ref_pipeline.prepare(ds_r.entities, ds_r.relations)
        port = pipeline.prepare(ds_p.entities, ds_p.relations, device="cpu")
        out[kind] = (ds_r, ds_p, ref, port)
    return out


@pytest.mark.parametrize("kind", CORPORA)
def test_cover_and_packing_identical(runs, kind):
    _, _, (pk_r, _, _), (pk_p, _, _) = runs[kind]
    assert len(pk_p.cover) == len(pk_r.cover)
    for a, b in zip(pk_p.cover.core + pk_p.cover.full, pk_r.cover.core + pk_r.cover.full):
        np.testing.assert_array_equal(a, b)
    assert sorted(pk_p.bins) == sorted(pk_r.bins)
    for k, nb in pk_r.bins.items():
        for f in interop.BATCH_FIELDS:
            a, b = getattr(pk_p.bins[k], f), getattr(nb, f)
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(pk_p.bin_rows[k], pk_r.bin_rows[k])
    np.testing.assert_array_equal(pk_p.neighborhood_bin, pk_r.neighborhood_bin)
    np.testing.assert_array_equal(pk_p.neighborhood_row, pk_r.neighborhood_row)
    assert pk_p.pair_levels == pk_r.pair_levels


@pytest.mark.parametrize("kind", CORPORA)
def test_global_grounding_identical(runs, kind):
    _, _, (_, gg_r, _), (_, gg_p, _) = runs[kind]
    for f in ("gids", "u", "coup_p", "coup_q"):
        a, b = getattr(gg_p, f), getattr(gg_r, f)
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    assert gg_p.w_co == gg_r.w_co and gg_p._device is None


@pytest.mark.parametrize("kind", CORPORA)
def test_canopies_identical(runs, kind):
    from repro.core.cover import build_canopies as ref_canopies
    from repro_torch.core.cover import build_canopies

    ds_r, ds_p, _, _ = runs[kind]
    want = ref_canopies(ds_r.entities.features, 0.70, 0.90)
    got = build_canopies(ds_p.entities.features, 0.70, 0.90, device="cpu")
    assert len(got) == len(want)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("kind", CORPORA)
@pytest.mark.parametrize("scheme", SCHEMES)
def test_resolve_identical(runs, kind, scheme):
    ds_r, ds_p, (pk_r, gg_r, _), (pk_p, gg_p, _) = runs[kind]
    ref = ref_pipeline.resolve(ds_r.entities, ds_r.relations, scheme=scheme, packed=pk_r, gg=gg_r)
    got = pipeline.resolve(ds_p.entities, ds_p.relations, scheme=scheme, packed=pk_p, gg=gg_p,
                           device="cpu")
    np.testing.assert_array_equal(got.result.matches.gids, ref.result.matches.gids)
    np.testing.assert_array_equal(got.closed.gids, ref.closed.gids)
    for f in ("neighborhood_evals", "messages_emitted", "messages_promoted", "dispatches"):
        assert getattr(got.result, f) == getattr(ref.result, f), f
    assert dataclasses.astuple(pipeline.evaluate(got, ds_p.entities.truth)) == (
        dataclasses.astuple(ref_pipeline.evaluate(ref, ds_r.entities.truth))
    )
    np.testing.assert_array_equal(
        pipeline.upper_bound(got, ds_p.entities.truth).gids,
        ref_pipeline.upper_bound(ref, ds_r.entities.truth).gids,
    )


def test_resolve_from_scratch_and_from_carried_state(runs):
    """``resolve`` with its own ``prepare``, and with the reference's packed
    cover and grounding carried across by :mod:`repro_torch.interop`."""
    ds_r, ds_p, (pk_r, gg_r, _), _ = runs["hepth"]
    ref = ref_pipeline.resolve(ds_r.entities, ds_r.relations, scheme="mmp", packed=pk_r, gg=gg_r)
    scratch = pipeline.resolve(ds_p.entities, ds_p.relations, scheme="mmp", device="cpu")
    carried = pipeline.resolve(
        ds_p.entities, ds_p.relations, scheme="mmp", device="cpu",
        packed=interop.packed_from_arrays(pk_r), gg=interop.grounding_from_arrays(gg_r),
    )
    for res in (scratch, carried):
        np.testing.assert_array_equal(res.result.matches.gids, ref.result.matches.gids)
        assert res.result.messages_emitted == ref.result.messages_emitted
    assert scratch.cover_time_s > 0 and carried.cover_time_s == 0.0


def test_weights_from_numpy():
    from repro.core.mln import PAPER_LEARNED as ref_weights
    from repro_torch.core.mln import PAPER_LEARNED

    w = interop.weights_from_numpy(np.asarray(ref_weights.w_sim, np.float32), ref_weights.w_co)
    assert w.w_co == PAPER_LEARNED.w_co
    np.testing.assert_array_equal(
        np.float32(w.w_sim), np.float32(PAPER_LEARNED.w_sim)
    )
    with pytest.raises(ValueError):
        interop.weights_from_numpy([0.0, 1.0], 2.0)
