"""The port's grounding cache and exporters vs the reference's, on the CPU.

``repro_torch.core.parallel.GroundingCache`` against
``repro.core.parallel.GroundingCache`` on the same cover (``hepth_small``,
four bins k=8/16/24/32) under capacities {1, 2, all} and a one-byte
device budget: the runs' schedules and match gids, the caches' counters
(resident bins and bytes included) and ``EMResult``'s residency fields
are equal; so are they on the multi-round lattice instance.  A changed
row is spliced in with one row re-ground, and a rolled-back splice
leaves the cached tensors as they were.  Last, ``profiler_session`` and
the Chrome-trace and snapshot exporters of ``repro_torch.obs``.
"""

from __future__ import annotations

import dataclasses

import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import parallel as ref_par  # noqa: E402
from repro.core import pipeline as ref_pipeline  # noqa: E402
from repro.core.global_grounding import build_global_grounding as ref_build_gg  # noqa: E402
from repro.core.mln import MLNMatcher as RefMLN  # noqa: E402
from repro.core.mln import PAPER_LEARNED as REF_WEIGHTS  # noqa: E402
from repro.core.rules import RulesMatcher as RefRules  # noqa: E402
from repro.data import synthetic as ref_synth  # noqa: E402
from repro_torch import interop, obs  # noqa: E402
from repro_torch.core import parallel, txn  # noqa: E402
from repro_torch.core.global_grounding import build_global_grounding  # noqa: E402
from repro_torch.core.mln import MLNMatcher, ground  # noqa: E402
from repro_torch.core.rules import RulesMatcher  # noqa: E402
from repro_torch.data import synthetic  # noqa: E402

SCHEDULE = ("rounds", "neighborhood_evals", "messages_emitted", "dispatches",
            "full_rounds", "history", "promote_host_scans",
            "peak_resident_bins", "cache_evictions", "cold_regrounds")
CACHE_COUNTERS = ("ground_calls", "rows_ground", "bin_hits", "splice_calls", "evictions",
                  "cold_regrounds", "peak_resident_bins", "peak_resident_bytes")
WEIGHTS = interop.weights_from_numpy(REF_WEIGHTS.w_sim, REF_WEIGHTS.w_co)


@pytest.fixture(scope="module")
def state(hepth_small):
    """(ref packed, ref gg, port packed, port gg) of hepth_small."""
    pk, gg, _ = ref_pipeline.prepare(hepth_small.entities, hepth_small.relations)
    return pk, gg, interop.packed_from_arrays(pk), interop.grounding_from_arrays(gg)


def _run_both(state, kind, scheme, *, ref_cache, port_cache):
    pk, gg, ppk, pgg = state
    ref_m = RefRules() if kind == "rules" else RefMLN(REF_WEIGHTS)
    port_m = RulesMatcher(device="cpu") if kind == "rules" else MLNMatcher(WEIGHTS, device="cpu")
    ref = ref_par.run_parallel(pk, ref_m, gg, scheme=scheme, gcache=ref_cache)
    port = parallel.run_parallel(ppk, port_m, pgg, scheme=scheme, gcache=port_cache,
                                 device="cpu")
    return ref, port


def _assert_same_run(ref, port):
    np.testing.assert_array_equal(port.matches.gids, ref.matches.gids)
    assert {f: getattr(port, f) for f in SCHEDULE} == {f: getattr(ref, f) for f in SCHEDULE}


def _counters(cache):
    return {c: getattr(cache, c) for c in CACHE_COUNTERS}


@pytest.mark.parametrize("scheme", ["smp", "mmp"])
@pytest.mark.parametrize("capacity", [1, 2, "all"])
def test_bounded_cache_equals_reference(state, capacity, scheme):
    n_bins = len(state[2].bins)
    cap = n_bins if capacity == "all" else capacity
    ref_cache, port_cache = ref_par.GroundingCache(capacity=cap), parallel.GroundingCache(capacity=cap)
    ref, port = _run_both(state, "mln", scheme, ref_cache=ref_cache, port_cache=port_cache)
    _assert_same_run(ref, port)
    assert _counters(port_cache) == _counters(ref_cache)
    assert port_cache.peak_resident_bins <= cap
    if cap < n_bins:
        assert port.cache_evictions > 0 and port.cold_regrounds > 0
    else:
        assert port.cache_evictions == 0


def test_hbm_budget_keeps_one_bin(state):
    ref_cache = ref_par.GroundingCache(hbm_budget_bytes=1)
    port_cache = parallel.GroundingCache(hbm_budget_bytes=1)
    ref, port = _run_both(state, "mln", "mmp", ref_cache=ref_cache, port_cache=port_cache)
    _assert_same_run(ref, port)
    assert ({c: getattr(port_cache, c) for c in CACHE_COUNTERS}
            == {c: getattr(ref_cache, c) for c in CACHE_COUNTERS})
    assert port_cache.peak_resident_bins == 1 and port_cache.evictions > 0


@pytest.mark.parametrize("scheme", ["nomp", "smp"])
def test_rules_spill_mode_equals_reference(state, scheme):
    """Under a bound below the bin count RULES leaves the single fused
    call for per-bin rounds, in both packages."""
    ref, port = _run_both(state, "rules", scheme, ref_cache=ref_par.GroundingCache(capacity=1),
                          port_cache=parallel.GroundingCache(capacity=1))
    _assert_same_run(ref, port)
    assert port.dispatches > 1


@pytest.mark.parametrize("scheme", ["smp", "mmp"])
def test_lattice_under_bounded_caches_equals_reference(scheme):
    pk_r, rel_r, w_r = ref_synth.make_lattice_cover(6, 2)
    gg_r = ref_build_gg(pk_r.pair_levels, rel_r, w_r)
    pk, rel, w = synthetic.make_lattice_cover(6, 2)
    gg = build_global_grounding(pk.pair_levels, rel, w)
    for cap in (1, 2, len(pk.bins)):
        ref_cache = ref_par.GroundingCache(capacity=cap)
        port_cache = parallel.GroundingCache(capacity=cap)
        ref = ref_par.run_parallel(pk_r, RefMLN(w_r), gg_r, scheme=scheme, gcache=ref_cache)
        port = parallel.run_parallel(pk, MLNMatcher(w, device="cpu"), gg, scheme=scheme,
                                     gcache=port_cache, device="cpu")
        _assert_same_run(ref, port)
        assert _counters(port_cache) == _counters(ref_cache)
        assert port.peak_resident_bins <= cap


def _grounding_tuple(g):
    return (g.u, g.u_raw, g.C, g.valid)


def _bin_tensors(packed, k):
    universe = np.asarray(sorted(packed.pair_levels), dtype=np.int64)
    return parallel._prepare_bins(packed, universe)[k]


def test_splice_regrounds_only_the_changed_row_and_rolls_back(state):
    """A changed row is spliced in (one row re-ground, new tensors equal to
    a fresh grounding and to the reference's splice); the cached tensors
    are never written, so a rolled-back ingest restores them exactly."""
    pk_r, _, ppk, _ = state
    k = max(ppk.bins)
    key = ("mln", WEIGHTS, torch.device("cpu"))
    bt = _bin_tensors(ppk, k)
    cache = parallel.GroundingCache()
    first = cache.get(key, k, bt)
    kept = tuple(a.clone() for a in first)
    assert cache.rows_ground == bt.entity_mask.shape[0]

    changed = dataclasses.replace(bt, **{
        f: getattr(bt, f).copy() for f in bt.__dataclass_fields__ if f != "n_rows"
    })
    row = int(np.flatnonzero(changed.pair_mask.any(axis=1))[0])
    p = int(np.flatnonzero(changed.pair_mask[row])[0])
    changed.sim_level[row, p] = 3 if changed.sim_level[row, p] != 3 else 2

    ref_cache = ref_par.GroundingCache()
    ref_bt = ref_par._prepare_bins(pk_r, np.asarray(sorted(pk_r.pair_levels)))[k]
    ref_key = ("mln", REF_WEIGHTS)
    ref_cache.get(ref_key, k, ref_bt)
    ref_bt.sim_level[row, p] = changed.sim_level[row, p]
    want = ref_cache.get(ref_key, k, ref_bt)

    with pytest.raises(RuntimeError, match="ingest fails"):
        with txn.transaction() as t:
            cache.journal_rollback(t)
            spliced = cache.get(key, k, changed)
            assert cache.splice_calls == 1
            assert cache.rows_ground == bt.entity_mask.shape[0] + 1
            fresh = ground(interop.batch_from_arrays(ppk.bins[k]), key[1], device="cpu")
            fresh_rows = ground(
                parallel._rows_batch(changed.entity_ids, changed.entity_mask, changed.coauthor,
                                     changed.sim_level, changed.pair_mask), key[1], device="cpu")
            for a, b, w in zip(spliced, _grounding_tuple(fresh_rows), want):
                np.testing.assert_array_equal(a.numpy(), b.numpy())
                np.testing.assert_array_equal(a.numpy(), np.asarray(w))
            assert not torch.equal(spliced[0], _grounding_tuple(fresh)[0])
            raise RuntimeError("ingest fails")
    assert cache.splice_calls == 0 and cache.rows_ground == bt.entity_mask.shape[0]
    restored = cache.get(key, k, bt)
    assert all(a is b for a, b in zip(restored, first))
    for a, b in zip(restored, kept):
        assert torch.equal(a, b)
    assert cache.bin_hits == 1


def test_profiler_session_and_exporters(tmp_path, monkeypatch, state):
    """profiler_session is a no-op without a logdir and writes a trace
    with one (run_parallel opens one through the environment variable);
    the span log exports as Chrome-trace JSON."""
    _, _, ppk, pgg = state
    monkeypatch.delenv(obs.export.PROFILE_ENV, raising=False)
    with obs.profiler_session() as on:
        assert on is False
    with obs.profiler_session(str(tmp_path / "a")) as on:
        assert on is True
        with obs.profiler_session(str(tmp_path / "b")) as inner:
            assert inner is False  # sessions do not nest
        torch.ones(4).sum()
    assert len(list((tmp_path / "a").glob("trace_*.json"))) == 1
    assert not (tmp_path / "b").exists()

    monkeypatch.setenv(obs.export.PROFILE_ENV, str(tmp_path / "run"))
    obs.reset()
    parallel.run_parallel(ppk, RulesMatcher(device="cpu"), pgg, scheme="smp", device="cpu")
    trace = json.loads(next((tmp_path / "run").glob("trace_*.json")).read_text())
    assert trace["traceEvents"]

    n = obs.write_chrome_trace(str(tmp_path / "spans.json"))
    events = json.loads((tmp_path / "spans.json").read_text())["traceEvents"]
    assert n == len(events) - 1 >= 1
    assert {"rounds.fused", "rounds.ground"} <= {e["name"] for e in events if e["ph"] == "X"}
    snap = obs.write_snapshot(str(tmp_path / "snap.json"))
    assert json.loads((tmp_path / "snap.json").read_text()) == json.loads(json.dumps(snap))
    assert snap["counters"]["em.runs"] == 1
