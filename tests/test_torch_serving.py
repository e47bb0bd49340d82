"""The port's serving front-end (``repro_torch.stream.serving``) and its
double-buffered reads, on the CPU: the cases of the reference's
``tests/test_serving.py`` run against the port.

* **Coalescing is schedule-invariant.**  The frontend merges queued
  arrivals into one ingest a flush; the fixpoint equals per-arrival
  synchronous ingest and the batch pipeline, and the coalesced service's
  ``state_digest`` equals the reference's frontend fed the same requests
  (batch formation is deterministic with the queue filled before start).
* **Readers never block on an ingest** (lock-free published snapshot).
* Admission control, coalescing budgets and ticket semantics.
"""

from __future__ import annotations

import threading
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.data.synthetic import arrival_stream as ref_arrival_stream  # noqa: E402
from repro.stream import ResolveService as RefService  # noqa: E402
from repro.stream import ServiceConfig as RefConfig  # noqa: E402
from repro.stream import ServingConfig as RefServingConfig  # noqa: E402
from repro.stream import ServingFrontend as RefFrontend  # noqa: E402
from repro.stream.digest import state_digest as ref_digest  # noqa: E402
from repro_torch import obs  # noqa: E402
from repro_torch.core import pipeline  # noqa: E402
from repro_torch.core.driver import run_mmp, run_smp  # noqa: E402
from repro_torch.core.global_grounding import build_global_grounding  # noqa: E402
from repro_torch.core.mln import MLNMatcher, PAPER_LEARNED  # noqa: E402
from repro_torch.core.types import EntityTable, Relations  # noqa: E402
from repro_torch.data.synthetic import arrival_stream  # noqa: E402
from repro_torch.stream import (  # noqa: E402
    AdmissionError,
    IngestTicket,
    ResolveService,
    ServiceConfig,
    ServingConfig,
    ServingFrontend,
)
from repro_torch.stream.digest import state_digest  # noqa: E402


def _svc(scheme="smp", **cfg) -> ResolveService:
    return ResolveService(ServiceConfig(scheme=scheme, **cfg), device="cpu")


def _cluster_state(clusters) -> frozenset:
    return frozenset(tuple(int(x) for x in c) for c in clusters)


def _coalesced(requests, *, scheme="smp", cfg=None):
    """Queue every request up front, then let the worker coalesce —
    deterministic batch formation (no arrival-timing dependence)."""
    svc = _svc(scheme)
    fe = ServingFrontend(svc, cfg or ServingConfig(max_batch=64, max_delay_ms=0), start=False)
    tickets = [fe.submit(n, e, i) for n, e, i in requests]
    fe.start()
    assert fe.drain(120)
    fe.close()
    for t in tickets:
        assert t.wait(0) is not None
    return svc, tickets


def _ref_coalesced_digest(requests, *, scheme="smp", cfg=None):
    """The reference's frontend fed the same requests the same way."""
    svc = RefService(RefConfig(scheme=scheme))
    fe = RefFrontend(svc, cfg or RefServingConfig(max_batch=64, max_delay_ms=0), start=False)
    for n, e, i in requests:
        fe.submit(n, e, i)
    fe.start()
    assert fe.drain(120)
    fe.close()
    return ref_digest(svc), [len(r.ids) for r in svc.reports]


def _synchronous(requests, *, scheme="smp"):
    svc = _svc(scheme)
    for names, edges, ids in requests:
        svc.ingest(names, edges, ids=ids)
    return svc


def _hepth_requests(ds, batch_size=4):
    return [
        (b.names, b.edges, [int(i) for i in b.ids])
        for b in arrival_stream(ds, batch_size=batch_size)
    ]


# ---------------------------------------------------------------------------
# Differential: coalesced ingest == per-arrival == the reference's frontend
# ---------------------------------------------------------------------------


def test_coalesced_equals_per_arrival_hepth(hepth_small):
    requests = _hepth_requests(hepth_small)
    ref_requests = [(b.names, b.edges, [int(i) for i in b.ids])
                    for b in ref_arrival_stream(hepth_small, batch_size=4)]
    sync = _synchronous(requests, scheme="smp")
    svc, tickets = _coalesced(requests, scheme="smp")
    assert len(svc.reports) < len(requests)  # coalescing really happened
    assert svc.matches.as_set() == sync.matches.as_set()
    assert svc.delta.packed.pair_levels == sync.delta.packed.pair_levels
    assert _cluster_state(svc.clusters()) == _cluster_state(sync.clusters())
    for t, (_, _, ids) in zip(tickets, requests):
        assert t.ids == ids
        assert set(ids) <= set(t.wait(0).ids)
    want, sizes = _ref_coalesced_digest(ref_requests, scheme="smp")
    assert [len(r.ids) for r in svc.reports] == sizes
    assert state_digest(svc) == want


def test_coalesced_equals_per_arrival_hepth_mmp(hepth_small):
    requests = _hepth_requests(hepth_small, batch_size=8)
    sync = _synchronous(requests, scheme="mmp")
    svc, _ = _coalesced(requests, scheme="mmp")
    assert len(svc.reports) < len(requests)
    assert svc.matches.as_set() == sync.matches.as_set()
    packed, gg, _ = pipeline.prepare(hepth_small.entities, hepth_small.relations, device="cpu")
    batch = run_mmp(packed, MLNMatcher(PAPER_LEARNED, device="cpu"), gg)
    assert svc.matches.as_set() == batch.matches.as_set()
    want, _ = _ref_coalesced_digest(requests, scheme="mmp")
    assert state_digest(svc) == want


def _chain_requests():
    """Evidence-lattice-style stream (the reference test's): ``depth``
    stages of ambiguous name pairs, coauthor edges linking stage i to
    stage i-1, one stage a request."""
    depth, per_stage = 6, 4
    names, ids, edges_of = [], [], []
    nid = 0
    prev_stage: list[int] = []
    for _ in range(depth):
        stage = []
        stage_names = []
        base = f"rosalind feynmanova{chr(97 + len(edges_of))}"
        for j in range(per_stage):
            stage_names.append(f"{base}{chr(97 + j)}")
            stage.append(nid)
            nid += 1
        e = list(zip(stage, prev_stage))
        edges_of.append((stage_names, np.asarray(e, dtype=np.int64) if e else None, stage))
        names.extend(stage_names)
        ids.extend(stage)
        prev_stage = stage
    return edges_of, names


@pytest.mark.parametrize("scheme", ["smp", "mmp"])
def test_coalesced_equals_per_arrival_evidence_chain(scheme):
    requests, all_names = _chain_requests()
    sync = _synchronous(requests, scheme=scheme)
    svc, _ = _coalesced(requests, scheme=scheme, cfg=ServingConfig(max_batch=10, max_delay_ms=0))
    assert len(svc.reports) < len(requests)
    assert svc.matches.as_set() == sync.matches.as_set()
    assert len(svc.matches) > 0  # the chain actually resolves
    ents = EntityTable(names=list(all_names))
    rels = sync.delta.relations()
    packed, _, _ = pipeline.prepare(ents, rels, device="cpu")
    matcher = MLNMatcher(PAPER_LEARNED, device="cpu")
    if scheme == "smp":
        batch = run_smp(packed, matcher)
    else:
        batch = run_mmp(packed, matcher, build_global_grounding(packed.pair_levels, rels,
                                                                PAPER_LEARNED))
    assert svc.matches.as_set() == batch.matches.as_set()
    want, _ = _ref_coalesced_digest(requests, scheme=scheme,
                                    cfg=RefServingConfig(max_batch=10, max_delay_ms=0))
    assert state_digest(svc) == want


def test_coalesced_survives_resplit_retraction():
    """The adversarial canopy re-split (match invalidation + candidate
    retraction) fires inside a coalesced flush and still reaches the
    batch fixpoint."""
    names = [f"john smithsonian{chr(97 + i // 26)}{chr(97 + i % 26)}" for i in range(28)]
    first = [i for i in range(28) if i % 2 == 0]
    second = [i for i in range(28) if i % 2 == 1]
    svc = _svc("smp")
    svc.ingest([names[i] for i in first], ids=first)
    fe = ServingFrontend(svc, ServingConfig(max_batch=8, max_delay_ms=0), start=False)
    for i in second:
        fe.submit([names[i]], None, [i])
    fe.start()
    assert fe.drain(60)
    fe.close()
    assert any(r.n_invalidated for r in svc.reports)  # retraction fired
    packed, _, _ = pipeline.prepare(EntityTable(names=list(names)), Relations(edges={}),
                                    device="cpu")
    seq = run_smp(packed, MLNMatcher(PAPER_LEARNED, device="cpu"))
    assert svc.matches.as_set() == seq.matches.as_set()


# ---------------------------------------------------------------------------
# Readers never block on an ingest
# ---------------------------------------------------------------------------


def test_reads_complete_while_writer_lock_held(hepth_small):
    requests = _hepth_requests(hepth_small)
    svc = _synchronous(requests[:4], scheme="smp")
    fe = ServingFrontend(svc, start=False)
    out: dict = {}

    def reader():
        out["resolve"] = fe.resolve(0)
        out["many"] = fe.resolve_many(range(8))
        out["snap"] = fe.snapshot().clusters()

    with svc._lock:  # a writer is mid-commit, forever (as far as readers know)
        t = threading.Thread(target=reader)
        t.start()
        t.join(timeout=5)
        assert not t.is_alive(), "reader blocked on the writer lock"
    assert len(out["many"]) == 8
    assert out["snap"] == svc.snapshot().clusters()
    fe.close()


def test_reader_latency_decoupled_from_ingest(hepth_small):
    requests = _hepth_requests(hepth_small)
    svc = _synchronous(requests[:2], scheme="smp")
    union_names = [n for r in requests[2:] for n in r[0]]
    union_ids = [i for r in requests[2:] for i in r[2]]
    edge_arrays = [r[1] for r in requests[2:] if r[1] is not None and len(r[1])]
    union_edges = np.vstack(edge_arrays) if edge_arrays else None
    lat: list[float] = []
    stop = threading.Event()

    def reader():
        ids = list(range(16))
        while not stop.is_set():
            t0 = time.perf_counter()
            svc.resolve_many(ids)
            lat.append(time.perf_counter() - t0)
            time.sleep(0.001)

    t = threading.Thread(target=reader)
    t.start()
    t0 = time.perf_counter()
    svc.ingest(union_names, union_edges, ids=union_ids)  # one big ingest
    ingest_s = time.perf_counter() - t0
    stop.set()
    t.join()
    assert lat, "reader never ran"
    assert max(lat) < max(0.5 * ingest_s, 0.05), (max(lat), ingest_s)


def test_resolve_observes_only_committed_states(hepth_small):
    batches = arrival_stream(hepth_small, 5)
    ref = _svc("smp")
    expected = {_cluster_state([])}
    for b in batches:
        ref.ingest(b.names, b.edges, ids=b.ids)
        expected.add(_cluster_state(ref.clusters()))
    svc = _svc("smp")
    seen: list[frozenset] = []
    stop = threading.Event()

    def reader():
        # The reader yields between reads: each of the port's CPU tensor ops
        # releases the GIL, and a reader spinning in pure Python makes the
        # writer wait a switch interval to take it back, op after op.
        while not stop.is_set():
            seen.append(_cluster_state(svc.clusters()))
            time.sleep(0.0005)

    t = threading.Thread(target=reader)
    t.start()
    try:
        for b in batches:
            svc.ingest(b.names, b.edges, ids=b.ids)
    finally:
        stop.set()
        t.join()
    bad = [s for s in set(seen) if s not in expected]
    assert not bad, f"reader observed {len(bad)} non-committed states"


# ---------------------------------------------------------------------------
# Admission control / backpressure
# ---------------------------------------------------------------------------


def test_admission_reject_sheds_and_counts():
    obs.reset()
    svc = _svc("smp")
    fe = ServingFrontend(svc, ServingConfig(max_queue=2, admission="reject", max_delay_ms=0),
                         start=False)
    t1 = fe.submit(["ada one"])
    t2 = fe.submit(["ada two"])
    with pytest.raises(AdmissionError):
        fe.submit(["ada three"])
    reg = obs.get_registry()
    assert reg.value("serve.admission.shed") == 1
    assert reg.value("serve.requests") == 2
    fe.start()
    assert fe.drain(60)
    fe.close()
    assert t1.done() and t2.done()
    assert svc.delta.n_entities == 2  # the shed request never ingested


def test_admission_block_timeout_sheds():
    svc = _svc("smp")
    fe = ServingFrontend(svc, ServingConfig(max_queue=1, admission="block", max_delay_ms=0),
                         start=False)
    fe.submit(["bea one"])
    t0 = time.perf_counter()
    with pytest.raises(AdmissionError):
        fe.submit(["bea two"], timeout=0.05)
    assert time.perf_counter() - t0 >= 0.04  # it did wait before shedding
    fe.start()
    assert fe.drain(60)
    fe.close()


def test_admission_block_backpressure_releases():
    svc = _svc("smp")
    fe = ServingFrontend(svc, ServingConfig(max_queue=1, admission="block", max_delay_ms=0),
                         start=False)
    fe.submit(["cleo one"])
    unblocked = threading.Event()

    def producer():
        fe.submit(["cleo two"])  # blocks: queue is at max_queue
        unblocked.set()

    p = threading.Thread(target=producer)
    p.start()
    assert not unblocked.wait(0.1), "submit should have blocked"
    fe.start()  # worker drains -> space -> producer completes
    assert unblocked.wait(30)
    p.join()
    assert fe.drain(60)
    fe.close()
    assert svc.delta.n_entities == 2


@pytest.mark.parametrize("field,value", [
    ("max_batch", 0), ("max_delay_ms", -1.0), ("max_queue", 0), ("admission", "drop"),
    ("max_retries", -1), ("backoff_base_ms", -1.0),
])
def test_serving_config_rejects_bad_knobs(field, value):
    with pytest.raises(ValueError):
        ServingConfig(**{field: value})


# ---------------------------------------------------------------------------
# Coalescing budgets + ticket semantics
# ---------------------------------------------------------------------------


def test_size_budget_shapes_batches():
    obs.reset()
    svc = _svc("smp")
    fe = ServingFrontend(svc, ServingConfig(max_batch=16, max_delay_ms=0), start=False)
    for k in range(10):  # 10 requests x 4 entities, budget 16 -> 4+4+2
        fe.submit([f"dora eleanor{chr(97 + k)}{chr(97 + j)}" for j in range(4)])
    fe.start()
    assert fe.drain(120)
    fe.close()
    assert [len(r.ids) for r in svc.reports] == [16, 16, 8]
    h = obs.get_registry().histogram("serve.batch.coalesced_size").summary()
    assert h["count"] == 3 and h["max"] == 16
    reqs = obs.get_registry().histogram("serve.batch.requests").summary()
    assert reqs["count"] == 3 and reqs["max"] == 4
    waits = obs.get_registry().histogram("serve.queue.wait_ms").summary()
    assert waits["count"] == 10


def test_oversized_request_never_split():
    svc = _svc("smp")
    fe = ServingFrontend(svc, ServingConfig(max_batch=4, max_delay_ms=0), start=False)
    fe.submit([f"edna fitzwilliam{chr(97 + j)}" for j in range(9)])  # > budget
    fe.submit(["edna extra"])
    fe.start()
    assert fe.drain(60)
    fe.close()
    assert [len(r.ids) for r in svc.reports] == [9, 1]  # the big request alone


def test_latency_budget_flushes_partial_batch():
    svc = _svc("smp")
    fe = ServingFrontend(svc, ServingConfig(max_batch=1024, max_delay_ms=25))
    t = fe.submit(["freya gorostiza"])
    report = t.wait(timeout=30)  # would hang forever if only size flushed
    assert len(report.ids) == 1
    fe.close()


def test_ticket_error_and_recovery():
    obs.reset()
    svc = _svc("smp")
    fe = ServingFrontend(svc, ServingConfig(max_delay_ms=0))
    ok1 = fe.submit(["gwen hypatia"], None, [0]).wait(30)
    assert ok1.ids == [0]
    bad = fe.submit(["gwen dup"], None, [0])  # duplicate explicit id
    with pytest.raises(ValueError):
        bad.wait(30)
    ok2 = fe.submit(["gwen later"]).wait(30)  # service still serves
    assert ok2.ids == [1]
    fe.close()
    assert obs.get_registry().value("serve.errors") == 1


def test_ticket_wait_times_out_before_commit():
    t = IngestTicket(["a name"], None, None)
    assert not t.done()
    with pytest.raises(TimeoutError):
        t.wait(0.01)


def test_mixed_explicit_and_auto_ids_coalesce():
    svc = _svc("smp")
    fe = ServingFrontend(svc, ServingConfig(max_batch=64, max_delay_ms=0), start=False)
    ta = fe.submit(["hana ibrahimovic"])          # auto -> 0
    tb = fe.submit(["hana jimenez"], None, [7])   # explicit hole
    tc = fe.submit(["hana kowalczyk"])            # auto -> 8 (past 7)
    fe.start()
    assert fe.drain(60)
    fe.close()
    assert ta.ids == [0] and tb.ids == [7] and tc.ids == [8]
    assert svc.delta.n_entities == 3


def test_close_without_start_fails_tickets():
    svc = _svc("smp")
    fe = ServingFrontend(svc, start=False)
    t = fe.submit(["ines jaramillo"])
    fe.close()
    with pytest.raises(RuntimeError):
        t.wait(1)
    with pytest.raises(RuntimeError):
        fe.submit(["ines again"])


def test_queue_depth_gauge_tracks():
    obs.reset()
    svc = _svc("smp")
    fe = ServingFrontend(svc, ServingConfig(max_delay_ms=0), start=False)
    for k in range(5):
        fe.submit([f"jo kalinowski{chr(97 + k)}"])
    assert obs.get_registry().gauge("serve.queue.depth").value == 5
    fe.start()
    assert fe.drain(60)
    fe.close()
    assert obs.get_registry().gauge("serve.queue.depth").value == 0


def test_context_manager_starts_and_flushes(hepth_small):
    """``with ServingFrontend(...)`` starts the worker and flushes on exit;
    the ``serve.coalesce`` span wraps the nested ``ingest`` span."""
    obs.reset()
    svc = _svc("smp")
    requests = _hepth_requests(hepth_small)[:3]
    with ServingFrontend(svc, ServingConfig(max_delay_ms=0), start=False) as fe:
        tickets = [fe.submit(n, e, i) for n, e, i in requests]
    assert all(t.done() for t in tickets)
    assert svc.delta.n_entities == sum(len(r[0]) for r in requests)
    spans = obs.get_registry().snapshot()["spans"]
    assert "serve.coalesce" in spans and "ingest" in spans
