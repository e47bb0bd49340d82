"""High-traffic serving front-end: continuous ingest batching over
:class:`~repro_torch.stream.service.ResolveService`.

The service's per-ingest cost has a large fixed component (one
``CoverDelta`` maintenance pass + one fixpoint advance per call), so
per-request synchronous ingest is bounded by that fixed cost.  This
module amortizes
that fixed cost the way LLM serving stacks amortize theirs — by
**continuous micro-batch coalescing**: producers enqueue arrivals on an
async queue; a single worker thread drains it, accumulating requests up
to a size budget (``ServingConfig.max_batch`` entities) or a latency
budget (``ServingConfig.max_delay_ms``, measured from the oldest queued
request), and runs each coalesced batch through **one** delta/fixpoint
ingest.

Correctness is free: the message-passing decomposition of the paper
(arXiv 1103.2410) makes the micro-batch the natural unit of work — the
service invariant says *any* split of the arrival sequence into
micro-batches reaches the batch pipeline's fixpoint bit-for-bit, so
coalescing k queued requests into one ingest changes the schedule, not
the fixpoint (``tests/test_torch_serving.py`` pins coalesced ==
per-arrival differentially).

Admission control bounds the queue: at most ``ServingConfig.max_queue``
requests may be waiting.  Past that, policy ``"block"`` makes
``submit`` wait for drain (backpressure propagates to the producer)
while ``"reject"`` sheds the request immediately with
:class:`AdmissionError` (counted in ``serve.admission.shed``).

Thread-safety contract:

* ``submit`` / ``drain`` / ``close`` — safe from any number of
  producer threads (one shared mutex + condvars around the queue).
* The worker thread is the **only** caller of
  ``ResolveService.ingest`` — the single-writer regime the service
  requires — and the only id allocator, so auto-assigned ids are
  race-free.  On the card every kernel launch of the service comes from
  this thread, so it runs under ``torch.cuda.device(service.device)``:
  the kernels' launches use the CUDA runtime's current device, which is
  per thread.
* Reads (``resolve`` / ``resolve_many`` / ``snapshot``) delegate to
  the service's lock-free published-snapshot path: they never block on
  queued or in-flight ingests.

**Graceful degradation**: a
flush that raises is retried up to ``ServingConfig.max_retries`` times
with capped exponential backoff (``backoff_base_ms`` doubling up to
``backoff_max_ms``) — the service's transactional ingest guarantees a
failed attempt left no state behind, so a retry is safe by
construction.  A batch that still fails is **bisected**: each half
retries independently, recursively, until the failure is isolated to a
single request, which is quarantined (its ticket fails with the
original error) while every innocent co-batched ticket commits.  Ids
are assigned per attempt from a local cursor and committed only on
success, so an aborted flush never burns id space or mutates tickets.

Observability (the ``serve.*`` families): gauge ``serve.queue.depth``; histograms
``serve.batch.coalesced_size`` / ``serve.batch.requests`` /
``serve.queue.wait_ms`` / ``serve.backoff_ms``; counters
``serve.requests``, ``serve.entities``, ``serve.batches``,
``serve.admission.shed``, ``serve.errors``, ``serve.retries``,
``serve.quarantined``, ``serve.faults.flush``,
``serve.faults.bisections``; span ``serve.coalesce`` wrapping each
flush (the ``ingest`` span nests inside it).
"""

from __future__ import annotations

import contextlib
import dataclasses
import threading
import time
from collections import deque

import numpy as np
import torch

from repro_torch.obs import get_registry
from repro_torch.obs import span as obs_span
from repro_torch.stream.service import IngestReport, ResolveService, ResolveSnapshot


class AdmissionError(RuntimeError):
    """Request shed by admission control (queue at ``max_queue`` under
    the ``"reject"`` policy, or a ``"block"`` wait that timed out)."""


@dataclasses.dataclass(frozen=True)
class ServingConfig:
    """Knobs of the coalescing front-end.

    The defaults favor throughput: a flush waits up to ``max_delay_ms``
    for the batch to fill.  Latency-sensitive deployments shrink
    ``max_delay_ms`` (0 flushes whatever is queued immediately);
    memory/overload-sensitive ones shrink ``max_queue`` and pick the
    ``"reject"`` policy so producers fail fast instead of stacking up.
    """

    # coalescing size budget: flush once this many entities are batched
    # (a single larger request still flushes alone, never split)
    max_batch: int = 64
    # coalescing latency budget in milliseconds, measured from the
    # enqueue of the *oldest* request in the forming batch; 0 = flush
    # immediately with whatever is already queued
    max_delay_ms: float = 2.0
    # admission bound: maximum queued (not yet ingesting) requests
    max_queue: int = 1024
    # "block": submit waits for queue space (backpressure);
    # "reject": submit raises AdmissionError immediately (shed)
    admission: str = "block"
    # degradation: a failed flush retries this many times (per batch or
    # bisected sub-batch) before the bisection/quarantine path takes over
    max_retries: int = 2
    # backoff before retry attempt k: min(backoff_max_ms,
    # backoff_base_ms * 2**(k-1)) milliseconds
    backoff_base_ms: float = 1.0
    backoff_max_ms: float = 50.0

    def __post_init__(self):
        if self.max_batch < 1:
            raise ValueError("max_batch must be >= 1")
        if self.max_delay_ms < 0:
            raise ValueError("max_delay_ms must be >= 0")
        if self.max_queue < 1:
            raise ValueError("max_queue must be >= 1")
        if self.admission not in ("block", "reject"):
            raise ValueError(
                f"admission must be block|reject, got {self.admission!r}"
            )
        if self.max_retries < 0:
            raise ValueError("max_retries must be >= 0")
        if self.backoff_base_ms < 0 or self.backoff_max_ms < 0:
            raise ValueError("backoff budgets must be >= 0")


class IngestTicket:
    """Handle for one submitted request (future-like).

    ``wait`` blocks until the coalesced ingest containing this request
    commits, then returns the shared :class:`IngestReport` (or raises
    the ingest's exception).  ``ids`` are the global entity ids this
    request's names received — explicit ones echoed back, auto-assigned
    ones filled in at flush time.  All methods are thread-safe.
    """

    __slots__ = ("names", "edges", "ids", "t_enq", "_done", "_report", "_error")

    def __init__(self, names, edges, ids):
        self.names = names
        self.edges = edges
        self.ids = ids
        self.t_enq = time.perf_counter()
        self._done = threading.Event()
        self._report: IngestReport | None = None
        self._error: BaseException | None = None

    def done(self) -> bool:
        return self._done.is_set()

    def wait(self, timeout: float | None = None) -> IngestReport:
        if not self._done.wait(timeout):
            raise TimeoutError("ingest not committed within timeout")
        if self._error is not None:
            raise self._error
        assert self._report is not None
        return self._report

    # -- worker side ------------------------------------------------------

    def _resolve(self, report: IngestReport) -> None:
        self._report = report
        self._done.set()

    def _fail(self, err: BaseException) -> None:
        self._error = err
        self._done.set()


class ServingFrontend:
    """Async ingest queue + coalescer in front of a ``ResolveService``.

    One instance owns one service: the frontend's worker thread must be
    the only ingester (it allocates the auto-assigned entity ids).  Use
    as a context manager, or call :meth:`close` to flush and stop::

        svc = ResolveService(ServiceConfig(scheme="smp"))
        with ServingFrontend(svc, ServingConfig(max_batch=64)) as fe:
            t = fe.submit(["john smith", "j. smith"])
            t.wait()                      # until the coalesced commit
            fe.resolve(0)                 # lock-free committed read
    """

    def __init__(
        self,
        service: ResolveService,
        config: ServingConfig | None = None,
        *,
        start: bool = True,
    ):
        self.service = service
        self.cfg = config if config is not None else ServingConfig()
        self._q: deque[IngestTicket] = deque()
        self._mu = threading.Lock()
        self._not_empty = threading.Condition(self._mu)
        self._not_full = threading.Condition(self._mu)
        self._idle = threading.Condition(self._mu)
        self._closed = False
        self._busy = False  # worker holds an un-committed batch
        self._worker: threading.Thread | None = None
        # the worker is the only id allocator; seed past anything the
        # service has already ingested
        self._next_id = len(service.delta.names)
        self._reg = get_registry()
        if start:
            self.start()

    # -- lifecycle --------------------------------------------------------

    def start(self) -> None:
        """Start the worker thread (idempotent).  Safe to construct
        with ``start=False``, pre-fill the queue, then start — tests
        and benchmarks use that for deterministic coalescing."""
        with self._mu:
            if self._worker is not None or self._closed:
                return
            self._worker = threading.Thread(
                target=self._run, name="serving-frontend", daemon=True
            )
            self._worker.start()

    def close(self, timeout: float | None = None) -> None:
        """Flush everything queued, then stop the worker.  Subsequent
        ``submit`` calls raise; reads keep working (the service
        outlives its frontend)."""
        with self._mu:
            self._closed = True
            self._not_empty.notify_all()
            self._not_full.notify_all()
            w = self._worker
            orphans: list[IngestTicket] = []
            if w is None:  # never started: nobody will flush the queue
                orphans = list(self._q)
                self._q.clear()
        for t in orphans:
            t._fail(RuntimeError("frontend closed before it was started"))
        if w is not None:
            w.join(timeout)

    def __enter__(self) -> "ServingFrontend":
        self.start()
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    # -- producer side ----------------------------------------------------

    def submit(
        self,
        names: list[str],
        edges: np.ndarray | None = None,
        ids: list[int] | None = None,
        *,
        timeout: float | None = None,
    ) -> IngestTicket:
        """Enqueue one arrival for coalesced ingest; returns immediately
        with a ticket (call ``ticket.wait()`` for the commit).

        Safe from any number of producer threads.  When the queue is at
        ``max_queue``: policy ``"reject"`` raises :class:`AdmissionError`
        at once (counted in ``serve.admission.shed``); policy
        ``"block"`` waits for space — bounded by ``timeout`` seconds if
        given, shedding on expiry.
        """
        ticket = IngestTicket(list(names), edges, ids)
        with self._mu:
            if self._closed:
                raise RuntimeError("frontend is closed")
            if len(self._q) >= self.cfg.max_queue:
                if self.cfg.admission == "reject":
                    self._reg.counter("serve.admission.shed").inc()
                    # keep the gauge honest on the shed path too — the
                    # queue didn't change, but the sample is fresh
                    self._reg.gauge("serve.queue.depth").set(len(self._q))
                    raise AdmissionError(
                        f"queue at max_queue={self.cfg.max_queue}, "
                        "request shed"
                    )
                deadline = (
                    None if timeout is None else time.monotonic() + timeout
                )
                while len(self._q) >= self.cfg.max_queue:
                    if self._closed:
                        raise RuntimeError("frontend is closed")
                    remaining = (
                        None if deadline is None
                        else deadline - time.monotonic()
                    )
                    if remaining is not None and remaining <= 0:
                        self._reg.counter("serve.admission.shed").inc()
                        self._reg.gauge("serve.queue.depth").set(len(self._q))
                        raise AdmissionError(
                            "blocked submit timed out waiting for queue "
                            "space, request shed"
                        )
                    self._not_full.wait(remaining)
            self._q.append(ticket)
            self._reg.counter("serve.requests").inc()
            self._reg.counter("serve.entities").inc(len(ticket.names))
            self._reg.gauge("serve.queue.depth").set(len(self._q))
            self._not_empty.notify()
        return ticket

    def drain(self, timeout: float | None = None) -> bool:
        """Block until every request submitted so far has committed
        (queue empty and no batch in flight).  Returns False on
        timeout.  Producer-side convenience for benchmarks/tests."""
        deadline = None if timeout is None else time.monotonic() + timeout
        with self._mu:
            while self._q or self._busy:
                remaining = (
                    None if deadline is None else deadline - time.monotonic()
                )
                if remaining is not None and remaining <= 0:
                    return False
                self._idle.wait(remaining)
            return True

    # -- read side (lock-free, delegates to the published snapshot) -------

    def resolve(self, entity_id: int) -> np.ndarray:
        """Lock-free committed read (see ``ResolveService.resolve``);
        never waits on queued or in-flight ingests."""
        return self.service.resolve(entity_id)

    def resolve_many(self, entity_ids) -> list[np.ndarray]:
        """Lock-free batched committed read; never waits on ingests."""
        return self.service.resolve_many(entity_ids)

    def snapshot(self) -> ResolveSnapshot:
        """The service's current published snapshot (lock-free)."""
        return self.service.snapshot()

    # -- worker side ------------------------------------------------------

    def _run(self) -> None:
        dev = self.service.device
        with (torch.cuda.device(dev) if dev.type == "cuda"
              else contextlib.nullcontext()):
            while True:
                batch = self._collect()
                if batch is None:
                    return
                self._flush(batch)
                with self._mu:
                    self._busy = False
                    self._idle.notify_all()

    def _collect(self) -> list[IngestTicket] | None:
        """Form one coalesced batch: block for the first request, then
        accumulate until the size budget fills or the latency budget
        (from the oldest request's enqueue) expires.  Returns None when
        closed and fully drained."""
        with self._mu:
            while not self._q:
                if self._closed:
                    self._idle.notify_all()
                    return None
                self._not_empty.wait()
            self._busy = True
            first = self._q.popleft()
            batch = [first]
            n = len(first.names)
            deadline = first.t_enq + self.cfg.max_delay_ms / 1e3
            while n < self.cfg.max_batch:
                if self._q:
                    nxt = self._q[0]
                    if n and n + len(nxt.names) > self.cfg.max_batch:
                        break  # requests are never split across batches
                    self._q.popleft()
                    batch.append(nxt)
                    n += len(nxt.names)
                    continue
                remaining = deadline - time.perf_counter()
                if remaining <= 0 or self._closed:
                    break
                # wake on new arrivals; the loop re-checks budget/queue
                self._not_empty.wait(remaining)
            self._reg.gauge("serve.queue.depth").set(len(self._q))
            self._not_full.notify_all()
        return batch

    def _plan_ids(
        self, batch: list[IngestTicket], cursor: int
    ) -> tuple[list[list[int]], list[int], int]:
        """Plan the batch's id assignment from a *local* cursor, queue
        order preserved, without touching ticket or frontend state —
        ``self._next_id`` and ``ticket.ids`` commit only after the
        ingest succeeds, so an aborted flush neither burns id space nor
        leaves tickets claiming ids their names never received."""
        per: list[list[int]] = []
        out: list[int] = []
        for t in batch:
            if t.ids is None:
                tids = list(range(cursor, cursor + len(t.names)))
            else:
                tids = [int(i) for i in t.ids]
            if tids:
                cursor = max(cursor, max(tids) + 1)
            per.append(tids)
            out.extend(tids)
        return per, out, cursor

    def _ingest_once(self, batch: list[IngestTicket]) -> IngestReport:
        """One ingest attempt; commits the id assignment on success."""
        per, ids, cursor = self._plan_ids(batch, self._next_id)
        names = [nm for t in batch for nm in t.names]
        edge_arrays = [
            np.asarray(t.edges, dtype=np.int64)
            for t in batch
            if t.edges is not None and len(t.edges)
        ]
        edges = np.vstack(edge_arrays) if edge_arrays else None
        report = self.service.ingest(names, edges, ids=ids)
        self._next_id = cursor
        for t, tids in zip(batch, per):
            t.ids = tids
        return report

    def _try_ingest(
        self, batch: list[IngestTicket]
    ) -> BaseException | None:
        """Ingest ``batch`` with capped-exponential-backoff retries.
        Settles every ticket and returns None on success; returns the
        last error once ``max_retries`` retries are exhausted (a retry
        is always safe: the transactional ingest rolled the failed
        attempt back completely)."""
        last: BaseException | None = None
        for attempt in range(self.cfg.max_retries + 1):
            if attempt:
                delay_ms = min(
                    self.cfg.backoff_max_ms,
                    self.cfg.backoff_base_ms * 2 ** (attempt - 1),
                )
                self._reg.counter("serve.retries").inc()
                self._reg.histogram("serve.backoff_ms").observe(delay_ms)
                time.sleep(delay_ms / 1e3)
            try:
                report = self._ingest_once(batch)
            except BaseException as err:
                self._reg.counter("serve.faults.flush").inc()
                last = err
                continue
            self._reg.counter("serve.batches").inc()
            self._reg.histogram("serve.batch.coalesced_size").observe(
                sum(len(t.names) for t in batch)
            )
            self._reg.histogram("serve.batch.requests").observe(len(batch))
            for t in batch:
                t._resolve(report)
            return None
        return last

    def _settle(self, batch: list[IngestTicket]) -> None:
        """Commit ``batch``, degrading gracefully: retry, then bisect a
        still-failing batch so the poisoned request is isolated down to
        a singleton and quarantined (ticket fails with the original
        error) while innocent co-batched tickets commit.  Coalescing is
        a schedule change only (service invariant), so splitting a
        batch never changes the fixpoint the survivors reach."""
        err = self._try_ingest(batch)
        if err is None:
            return
        if len(batch) == 1:
            self._reg.counter("serve.quarantined").inc()
            self._reg.counter("serve.errors").inc()
            batch[0]._fail(err)
            return
        self._reg.counter("serve.faults.bisections").inc()
        mid = len(batch) // 2
        self._settle(batch[:mid])
        self._settle(batch[mid:])

    def _flush(self, batch: list[IngestTicket]) -> None:
        """Run one coalesced ingest and settle every ticket in it."""
        n_entities = sum(len(t.names) for t in batch)
        t_flush = time.perf_counter()
        for t in batch:
            self._reg.histogram("serve.queue.wait_ms").observe(
                (t_flush - t.t_enq) * 1e3
            )
        with obs_span(
            "serve.coalesce", requests=len(batch), entities=n_entities
        ):
            self._settle(batch)
