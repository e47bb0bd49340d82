"""Runtime observability of the port: metrics registry, tracing, transfers.

* :mod:`repro_torch.obs.registry` — process-wide, thread-safe counters /
  gauges / histograms; the drivers publish their ``em.*`` counters and
  the streaming service its ``ingest.*`` family into it.
* :mod:`repro_torch.obs.tracing` — nestable ``span()`` context managers
  with optional device fencing; the span taxonomy is in its docstring.
* :mod:`repro_torch.obs.transfer` — host→device upload-byte accounting.
* :mod:`repro_torch.obs.export` — JSON snapshots, Chrome-trace/Perfetto
  ``trace_event`` files, opt-in ``torch.profiler`` sessions.
"""

from repro_torch.obs.export import (  # noqa: F401
    profiler_session,
    write_chrome_trace,
    write_snapshot,
)
from repro_torch.obs.registry import (  # noqa: F401
    MetricsRegistry,
    get_registry,
    reset,
)
from repro_torch.obs.tracing import Span, SpanRecord, span  # noqa: F401
from repro_torch.obs.transfer import record_transfer, total_upload_bytes  # noqa: F401

__all__ = [
    "MetricsRegistry",
    "Span",
    "SpanRecord",
    "get_registry",
    "profiler_session",
    "record_transfer",
    "reset",
    "span",
    "total_upload_bytes",
    "write_chrome_trace",
    "write_snapshot",
]
