"""Process-wide runtime metrics registry: counters, gauges, histograms.

This is the *runtime* observability substrate — wall-clock, dispatch,
transfer-byte and latency accounting for the serving/engine stack.  It
is deliberately distinct from :mod:`repro_torch.core.metrics`, which holds the
paper's *quality* metrics (precision/recall/F1, soundness/completeness).

Design:

* One process-wide :class:`MetricsRegistry` singleton
  (:func:`get_registry`), matching how the engine objects that record
  into it (``GroundingCache``, ``DevicePromoter``, ``ResolveService``)
  are themselves long-lived.  :func:`reset` clears contents *in place*
  so module-level references held by hot paths stay valid — the pattern
  benchmarks use between cells.
* Every mutation takes the registry lock; instruments are created on
  first touch (``registry.counter("x").inc()``), so call sites never
  pre-register.  Reads (:meth:`MetricsRegistry.snapshot`) take the same
  lock, so a snapshot is internally consistent even under concurrent
  writers — the property ``tests/test_obs.py`` hammers with
  ``ResolveService`` reader threads.
* Histograms keep the **raw samples**, so percentile extraction is
  exact (nearest-rank), not an approximation over fixed buckets —
  ``p50``/``p90``/``p99`` of a resolve-latency histogram are real
  observed latencies.  A ``max_samples`` cap (default 1 << 20) guards a
  long-lived service: past it the histogram degrades gracefully by
  keeping a uniform random reservoir (sum/count/min/max stay exact).

Naming convention (the counter catalog lives in
``docs/ARCHITECTURE.md``): dotted lowercase families —
``ingest.*`` (per-ingest work counters mirroring ``IngestReport``),
``em.*`` (per-run engine counters mirroring ``EMResult``),
``transfer.*`` (host→device upload bytes), ``resolve.*`` (query-path
counters and the latency histogram), ``cover.*`` (packed-array splice
accounting).
"""

from __future__ import annotations

import math
import random
import threading
import time

__all__ = [
    "Counter",
    "Gauge",
    "Histogram",
    "MetricsRegistry",
    "get_registry",
    "reset",
]


class Counter:
    """Monotonically increasing integer; lock provided by the registry."""

    __slots__ = ("name", "value", "_lock")

    def __init__(self, name: str, lock: threading.Lock):
        self.name = name
        self.value = 0
        self._lock = lock

    def inc(self, n: int | float = 1) -> None:
        with self._lock:
            self.value += int(n)


class Gauge:
    """Last-write-wins scalar (e.g. a high-water mark or a config knob)."""

    __slots__ = ("name", "value", "_lock")

    def __init__(self, name: str, lock: threading.Lock):
        self.name = name
        self.value = 0.0
        self._lock = lock

    def set(self, v: float) -> None:
        with self._lock:
            self.value = float(v)

    def max(self, v: float) -> None:
        """Raise the gauge to ``v`` if larger (high-water-mark updates)."""
        with self._lock:
            if v > self.value:
                self.value = float(v)


class Histogram:
    """Exact-percentile histogram over raw float samples.

    Percentiles are nearest-rank over the sorted samples — an observed
    value, never an interpolation.  Beyond ``max_samples`` the sample
    set becomes a uniform reservoir (Vitter's algorithm R) so memory is
    bounded; ``count``/``sum``/``min``/``max`` stay exact regardless.
    """

    __slots__ = ("name", "count", "total", "vmin", "vmax", "samples",
                 "max_samples", "_rng", "_lock")

    def __init__(self, name: str, lock: threading.Lock,
                 max_samples: int = 1 << 20):
        self.name = name
        self.count = 0
        self.total = 0.0
        self.vmin = math.inf
        self.vmax = -math.inf
        self.samples: list[float] = []
        self.max_samples = max_samples
        self._rng = random.Random(0x0B5)
        self._lock = lock

    def observe(self, v: float) -> None:
        v = float(v)
        with self._lock:
            self.count += 1
            self.total += v
            if v < self.vmin:
                self.vmin = v
            if v > self.vmax:
                self.vmax = v
            if len(self.samples) < self.max_samples:
                self.samples.append(v)
            else:  # reservoir: each sample kept with probability n/count
                j = self._rng.randrange(self.count)
                if j < self.max_samples:
                    self.samples[j] = v

    def percentile(self, q: float) -> float:
        """Exact nearest-rank percentile, ``q`` in [0, 100]."""
        with self._lock:
            if not self.samples:
                return 0.0
            s = sorted(self.samples)
            rank = max(int(math.ceil(q / 100.0 * len(s))), 1)
            return s[min(rank, len(s)) - 1]

    def summary(self) -> dict:
        with self._lock:
            n = self.count
            s = sorted(self.samples)

        def pct(q: float) -> float:
            if not s:
                return 0.0
            rank = max(int(math.ceil(q / 100.0 * len(s))), 1)
            return s[min(rank, len(s)) - 1]

        return {
            "count": n,
            "sum": self.total,
            "mean": self.total / n if n else 0.0,
            "min": self.vmin if n else 0.0,
            "max": self.vmax if n else 0.0,
            "p50": pct(50.0),
            "p90": pct(90.0),
            "p99": pct(99.0),
        }


class MetricsRegistry:
    """Thread-safe instrument store + the span log tracing writes into.

    ``spans`` is an append-only list of span records (written by
    :mod:`repro_torch.obs.tracing`: each closing span calls
    :meth:`record_span`), capped at ``max_spans``
    (oldest dropped, ``spans_dropped`` counts them) so a long-lived
    service cannot grow the trace without bound.  ``t0`` anchors the
    Chrome-trace timebase: span timestamps are ``perf_counter`` values,
    exported relative to it.
    """

    def __init__(self, max_spans: int = 1 << 16):
        self._lock = threading.Lock()
        self._counters: dict[str, Counter] = {}
        self._gauges: dict[str, Gauge] = {}
        self._hists: dict[str, Histogram] = {}
        self.spans: list = []
        self.max_spans = max_spans
        self.spans_dropped = 0
        self.tracing = True
        self.t0 = time.perf_counter()

    # -- instrument accessors (create on first touch) ---------------------

    def counter(self, name: str) -> Counter:
        c = self._counters.get(name)
        if c is None:
            with self._lock:
                c = self._counters.setdefault(name, Counter(name, self._lock))
        return c

    def gauge(self, name: str) -> Gauge:
        g = self._gauges.get(name)
        if g is None:
            with self._lock:
                g = self._gauges.setdefault(name, Gauge(name, self._lock))
        return g

    def histogram(self, name: str) -> Histogram:
        h = self._hists.get(name)
        if h is None:
            with self._lock:
                h = self._hists.setdefault(name, Histogram(name, self._lock))
        return h

    def value(self, name: str) -> int:
        """Current value of a counter (0 if never touched)."""
        c = self._counters.get(name)
        return c.value if c is not None else 0

    # -- span log (written by a tracing module) ---------------------------

    def record_span(self, rec) -> None:
        with self._lock:
            if len(self.spans) >= self.max_spans:
                drop = len(self.spans) - self.max_spans + 1
                del self.spans[:drop]
                self.spans_dropped += drop
            self.spans.append(rec)

    def set_tracing(self, enabled: bool) -> None:
        self.tracing = bool(enabled)

    # -- lifecycle --------------------------------------------------------

    def reset(self) -> None:
        """Clear contents in place; instrument objects and the registry
        identity survive, so cached references in hot paths stay valid."""
        with self._lock:
            for c in self._counters.values():
                c.value = 0
            for g in self._gauges.values():
                g.value = 0.0
            for h in self._hists.values():
                h.count = 0
                h.total = 0.0
                h.vmin = math.inf
                h.vmax = -math.inf
                h.samples.clear()
            self.spans.clear()
            self.spans_dropped = 0
            self.t0 = time.perf_counter()

    def snapshot(self) -> dict:
        """One consistent JSON-ready view of everything.

        ``{"counters": {name: int}, "gauges": {name: float},
        "histograms": {name: {count,sum,mean,min,max,p50,p90,p99}},
        "spans": {name: {count, total_s}}, "spans_dropped": int}``

        The per-name span rollup gives stage timings without shipping
        the raw span log.
        """
        with self._lock:
            counters = {n: c.value for n, c in self._counters.items()}
            gauges = {n: g.value for n, g in self._gauges.items()}
            spans = list(self.spans)
            dropped = self.spans_dropped
        hists = {n: h.summary() for n, h in list(self._hists.items())}
        rollup: dict[str, dict] = {}
        for rec in spans:
            agg = rollup.setdefault(rec.name, {"count": 0, "total_s": 0.0})
            agg["count"] += 1
            agg["total_s"] += rec.dur_s
        for agg in rollup.values():
            agg["total_s"] = round(agg["total_s"], 6)
        return {
            "counters": counters,
            "gauges": gauges,
            "histograms": hists,
            "spans": rollup,
            "spans_dropped": dropped,
        }


_REGISTRY = MetricsRegistry()


def get_registry() -> MetricsRegistry:
    """The process-wide registry every engine component records into."""
    return _REGISTRY


def reset() -> None:
    """Clear the process-wide registry in place (see ``reset`` method)."""
    _REGISTRY.reset()
