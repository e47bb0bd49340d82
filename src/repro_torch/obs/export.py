"""Exporters: JSON snapshots, Chrome-trace files, torch.profiler sessions.

Three ways out of the registry:

* :func:`write_snapshot` — ``MetricsRegistry.snapshot()`` as a JSON
  file.
* :func:`write_chrome_trace` — the span log as a Chrome
  ``trace_event`` file (``{"traceEvents": [...]}``, complete ``"X"``
  events in microseconds).  Loads in ``chrome://tracing`` and
  `Perfetto <https://ui.perfetto.dev>`_.
* :func:`profiler_session` — an opt-in ``torch.profiler`` trace around a
  region (``core.parallel.run_parallel`` wraps itself in one).  Enabled
  by passing a ``logdir`` or setting ``REPRO_TORCH_PROFILE_DIR``; a
  no-op otherwise, so the hot path never pays for it.
"""

from __future__ import annotations

import contextlib
import json
import os
import time

from repro_torch.obs.registry import MetricsRegistry, get_registry

__all__ = ["profiler_session", "write_chrome_trace", "write_snapshot"]

PROFILE_ENV = "REPRO_TORCH_PROFILE_DIR"


def write_snapshot(path: str, registry: MetricsRegistry | None = None) -> dict:
    """Dump ``registry.snapshot()`` to ``path`` as JSON; returns it."""
    reg = registry if registry is not None else get_registry()
    snap = reg.snapshot()
    with open(path, "w") as f:
        json.dump(snap, f, indent=2, sort_keys=True)
        f.write("\n")
    return snap


def chrome_trace_events(registry: MetricsRegistry | None = None) -> list[dict]:
    """The span log as Chrome ``trace_event`` dicts (phase ``X``).

    Timestamps are microseconds relative to the registry's ``t0`` (its
    creation or last reset), one ``tid`` per recording thread, so the
    viewer reconstructs the nesting of concurrent ingests and readers.
    """
    reg = registry if registry is not None else get_registry()
    t0 = reg.t0
    events: list[dict] = [{
        "name": "process_name",
        "ph": "M",
        "pid": 0,
        "tid": 0,
        "args": {"name": "repro"},
    }]
    with reg._lock:
        spans = list(reg.spans)
    for rec in spans:
        ev = {
            "name": rec.name,
            "ph": "X",
            "ts": round((rec.t_start - t0) * 1e6, 3),
            "dur": round(rec.dur_s * 1e6, 3),
            "pid": 0,
            "tid": rec.thread_id % (1 << 31),
        }
        args = dict(rec.args) if rec.args else {}
        if rec.parent:
            args["parent"] = rec.parent
        if args:
            ev["args"] = args
        events.append(ev)
    return events


def write_chrome_trace(path: str,
                       registry: MetricsRegistry | None = None) -> int:
    """Write the span log as a Chrome-trace/Perfetto JSON file.

    Returns the number of span events written (excluding metadata).
    Open the file at ``chrome://tracing`` or https://ui.perfetto.dev.
    """
    events = chrome_trace_events(registry)
    with open(path, "w") as f:
        json.dump({"traceEvents": events, "displayTimeUnit": "ms"}, f)
        f.write("\n")
    return len(events) - 1


@contextlib.contextmanager
def profiler_session(logdir: str | None = None):
    """Opt-in ``torch.profiler`` trace around a region.

    Activates when ``logdir`` is given or ``REPRO_TORCH_PROFILE_DIR`` is
    set; yields True when a trace is running, False when it is a no-op.
    On exit the trace is written to ``logdir`` as a Chrome-trace JSON
    file (``trace_<pid>_<ns>.json``).  Sessions do not nest: if a
    profiler is already running (this function's or the caller's own
    ``torch.profiler.profile``), the inner region runs untraced and
    yields False — the outer session owns the trace.
    """
    logdir = logdir or os.environ.get(PROFILE_ENV)
    if not logdir:
        yield False
        return
    import torch
    from torch.profiler import ProfilerActivity, profile

    # torch.profiler does not refuse a second session on its own: the
    # inner stop would end the outer trace, so check first
    if torch.autograd.profiler._is_profiler_enabled:
        yield False
        return
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    prof = profile(activities=activities)
    prof.start()
    try:
        yield True
    finally:
        prof.stop()
        os.makedirs(logdir, exist_ok=True)
        prof.export_chrome_trace(
            os.path.join(logdir, f"trace_{os.getpid()}_{time.time_ns()}.json")
        )
