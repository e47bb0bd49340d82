"""The port's streaming service on the round-parallel engine
(``ServiceConfig(parallel=True)``) vs the reference's, on the CPU.

The same arrival stream goes through both packages' ``ResolveService``
with the parallel engine and its persistent device grounding cache,
unbounded and bounded: every ``IngestReport`` field but the wall time
(re-ground rows, resident bins, evictions, cold re-grounds, upload
bytes included) and the ``state_digest`` must be equal after every
ingest.  An ingest that fails rolls back the service and its grounding
cache; the same batch then commits to the reference's state.
"""

from __future__ import annotations

import dataclasses

import pytest

torch = pytest.importorskip("torch")

from repro.core.mln import PAPER_LEARNED as REF_WEIGHTS  # noqa: E402
from repro.data.synthetic import arrival_stream  # noqa: E402
from repro.stream import ResolveService as RefService  # noqa: E402
from repro.stream import ServiceConfig as RefConfig  # noqa: E402
from repro.stream.digest import state_digest as ref_digest  # noqa: E402
from repro_torch import faults, interop  # noqa: E402
from repro_torch.core import pipeline  # noqa: E402
from repro_torch.core.driver import run_smp  # noqa: E402
from repro_torch.core.mln import MLNMatcher  # noqa: E402
from repro_torch.data import synthetic  # noqa: E402
from repro_torch.stream import ResolveService, ServiceConfig  # noqa: E402
from repro_torch.stream.digest import state_digest  # noqa: E402

N_BATCHES = 3
# name -> (scheme, grounding-cache bounds)
RUNS = {
    "smp": ("smp", {}),
    "mmp": ("mmp", {}),
    "mmp-capacity-1": ("mmp", dict(gcache_capacity=1)),
    "smp-budget-1": ("smp", dict(gcache_hbm_budget=1)),
}
# the fault sites at and after the rounds, where the grounding cache has
# changed when the ingest fails (the sequential stream tests cover the
# earlier sites, which the parallel engine does not reach)
INGEST_SITES = ("rounds", "commit")


def _port_config(scheme: str, **bounds) -> ServiceConfig:
    weights = interop.weights_from_numpy(REF_WEIGHTS.w_sim, REF_WEIGHTS.w_co)
    return ServiceConfig(scheme=scheme, weights=weights, parallel=True, **bounds)


@pytest.fixture(scope="module")
def runs(hepth_small):
    """Per run: per ingest (ref digest, port digest, ref report, port
    report), and both services."""
    out = {}
    for name, (scheme, bounds) in RUNS.items():
        ref = RefService(RefConfig(scheme=scheme, parallel=True, **bounds))
        port = ResolveService(_port_config(scheme, **bounds), device="cpu")
        steps = []
        for b in arrival_stream(hepth_small, N_BATCHES):
            rep_r = ref.ingest(b.names, b.edges, ids=b.ids)
            rep_p = port.ingest(b.names, b.edges, ids=b.ids)
            steps.append((ref_digest(ref), state_digest(port), rep_r, rep_p))
        out[name] = (steps, ref, port)
    return out


@pytest.mark.parametrize("name", RUNS)
def test_state_digest_equals_reference_every_ingest(runs, name):
    steps, _, _ = runs[name]
    digests = [(d_ref, d_port) for d_ref, d_port, *_ in steps]
    assert all(a == b for a, b in digests), digests
    assert len({d for d, _ in digests}) == len(digests)  # every ingest changed the state


@pytest.mark.parametrize("name", RUNS)
def test_ingest_reports_equal_reference(runs, name):
    steps, _, _ = runs[name]
    for _, _, rep_r, rep_p in steps:
        want = {k: v for k, v in dataclasses.asdict(rep_r).items() if k != "wall_time_s"}
        got = {k: v for k, v in dataclasses.asdict(rep_p).items() if k != "wall_time_s"}
        assert got == want
    reports = [rep_p for *_, rep_p in steps]
    assert sum(r.reground_rows for r in reports) > 0
    assert sum(r.upload_bytes for r in reports) > 0
    assert all(r.promote_host_scans == 0 for r in reports)
    bounds = RUNS[name][1]
    if bounds:
        assert max(r.peak_resident_bins for r in reports) == 1
        assert sum(r.cache_evictions for r in reports) > 0
        assert sum(r.cold_regrounds for r in reports) > 0


@pytest.mark.parametrize("name", ["mmp-capacity-1", "smp-budget-1"])
def test_bounded_cache_gives_the_unbounded_matches(runs, name):
    _, _, bounded = runs[name]
    _, _, unbounded = runs[RUNS[name][0]]
    assert bounded.matches.as_set() == unbounded.matches.as_set()
    assert bounded.engine.gcache.peak_resident_bins == 1


def test_parallel_stream_equals_batch(runs):
    """On hepth_small the streamed parallel fixpoint is the port's batch
    ``run_smp`` on the union, as for the sequential engine."""
    ds = synthetic.make_dataset(synthetic.SynthConfig.hepth(scale=0.035, seed=7))
    packed, _, _ = pipeline.prepare(ds.entities, ds.relations, device="cpu")
    batch = run_smp(packed, MLNMatcher(device="cpu"))
    _, _, port = runs["smp"]
    assert port.matches.as_set() == batch.matches.as_set()


@pytest.mark.parametrize("site", INGEST_SITES)
def test_rollback_restores_service_and_grounding_cache(hepth_small, runs, site):
    """An ingest that fails at any stage leaves no trace, the grounding
    cache included (its entries and counters); the batch then commits to
    the reference's state."""
    batches = arrival_stream(hepth_small, N_BATCHES)
    svc = ResolveService(_port_config("mmp"), device="cpu")
    for b in batches[:2]:
        svc.ingest(b.names, b.edges, ids=b.ids)
    cache = svc.engine.gcache
    before = state_digest(svc)
    entries = dict(cache._bins)
    counters = {c: getattr(cache, c) for c in cache._TXN_COUNTERS}
    b = batches[2]
    with faults.injected(faults.FaultPlan.fail_once(site)):
        with pytest.raises(faults.InjectedFault, match=site):
            svc.ingest(b.names, b.edges, ids=b.ids)
    assert state_digest(svc) == before
    assert len(svc.reports) == 2
    assert svc.engine.gcache is cache
    assert cache._bins.keys() == entries.keys()
    assert all(cache._bins[k] is entries[k] for k in entries)
    assert {c: getattr(cache, c) for c in cache._TXN_COUNTERS} == counters
    rep = svc.ingest(b.names, b.edges, ids=b.ids)
    steps, _, _ = runs["mmp"]
    assert state_digest(svc) == steps[2][0]
    want = {k: v for k, v in dataclasses.asdict(steps[2][2]).items() if k != "wall_time_s"}
    got = {k: v for k, v in dataclasses.asdict(rep).items() if k != "wall_time_s"}
    assert got == want


def test_rollback_of_a_spliced_bin_keeps_the_cached_tensors(hepth_small, runs):
    """A rolled-back ingest that spliced a bin leaves the cached tensors
    unchanged: the splice built new ones."""
    batches = arrival_stream(hepth_small, N_BATCHES)
    svc = ResolveService(_port_config("smp"), device="cpu")
    for b in batches[:2]:
        svc.ingest(b.names, b.edges, ids=b.ids)
    cache = svc.engine.gcache
    kept = {k: tuple(a.clone() for a in arrays) for k, (_, arrays, _) in cache._bins.items()}
    b = batches[2]
    with faults.injected(faults.FaultPlan.fail_once("commit")):
        with pytest.raises(faults.InjectedFault):
            svc.ingest(b.names, b.edges, ids=b.ids)
    for k, want in kept.items():
        for a, w in zip(cache._bins[k][1], want):
            assert torch.equal(a, w)
    rep = svc.ingest(b.names, b.edges, ids=b.ids)
    assert rep.reground_rows > 0 and svc.engine.gcache.splice_calls > 0
    steps, _, _ = runs["smp"]
    assert state_digest(svc) == steps[2][0]
