"""Structured tracing spans: nestable context managers over the registry.

A span measures one stage of work — wall-clock by default, with optional
device fencing (:meth:`Span.fence`) so asynchronously launched CUDA
work is attributed to the span that launched it instead of whichever
later host sync happens to absorb it.

Spans nest per thread: a thread-local stack tracks the open span, and
each record carries its parent's name and depth, so both the in-process
nesting tests and the Chrome-trace export (which reconstructs nesting
from timestamps within a ``tid``) see the same tree.  The span taxonomy
is the reference's (``repro.obs.tracing``); the stable stage names the
port's streaming service records are:

    ingest                      one ResolveService.ingest call
      ingest.lsh                MinHash/LSH probe (stream/delta._probe)
      ingest.replay             localized canopy replay
      ingest.cover_splice       incremental assemble + packed splice
      ingest.grounding_splice   GroundingMaintainer delta + array splice
      ingest.rounds             fixpoint advance (engine.advance)
      ingest.commit             atomic cluster/fixpoint publish

Disabling (``registry.set_tracing(False)``) makes :func:`span` yield a
shared no-op whose every method is a pass — the hot path pays one
attribute read.  With tracing ON the cost is two ``perf_counter`` calls
and one locked list append per span.
"""

from __future__ import annotations

import dataclasses
import threading
import time

import torch

from repro_torch.obs.registry import MetricsRegistry, get_registry

__all__ = ["Span", "SpanRecord", "span"]


@dataclasses.dataclass
class SpanRecord:
    """One closed span, as stored in the registry's span log."""

    name: str
    t_start: float  # perf_counter at enter
    dur_s: float
    thread_id: int
    parent: str | None
    depth: int
    args: dict | None = None


_local = threading.local()


def _holds_cuda(value) -> bool:
    """True if ``value`` is, or (in a list, tuple or dict) contains, a CUDA tensor."""
    if isinstance(value, torch.Tensor):
        return value.is_cuda
    if isinstance(value, (list, tuple)):
        return any(_holds_cuda(v) for v in value)
    if isinstance(value, dict):
        return any(_holds_cuda(v) for v in value.values())
    return False


def _stack() -> list:
    st = getattr(_local, "stack", None)
    if st is None:
        st = _local.stack = []
    return st


class Span:
    """An open span; created by :func:`span`, closed by ``__exit__``."""

    __slots__ = ("name", "registry", "args", "t_start", "parent", "depth")

    def __init__(self, name: str, registry: MetricsRegistry,
                 args: dict | None):
        self.name = name
        self.registry = registry
        self.args = args
        self.t_start = 0.0
        self.parent: str | None = None
        self.depth = 0

    def __enter__(self) -> Span:
        st = _stack()
        self.parent = st[-1].name if st else None
        self.depth = len(st)
        st.append(self)
        self.t_start = time.perf_counter()
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        dur = time.perf_counter() - self.t_start
        st = _stack()
        if st and st[-1] is self:
            st.pop()
        self.registry.record_span(SpanRecord(
            name=self.name,
            t_start=self.t_start,
            dur_s=dur,
            thread_id=threading.get_ident(),
            parent=self.parent,
            depth=self.depth,
            args=self.args,
        ))

    def fence(self, value):
        """Wait for the device inside the span when ``value`` holds a CUDA
        tensor — attributes in-flight device work to this span rather than
        to the next host sync.  Returns ``value`` for chaining.  A no-op
        for host values."""
        if _holds_cuda(value):
            torch.cuda.synchronize()
        return value

    def set(self, **kv) -> None:
        """Attach args to the record (shown in the Chrome-trace UI)."""
        if self.args is None:
            self.args = {}
        self.args.update(kv)


class _NoopSpan:
    """Shared do-nothing span returned when tracing is off."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, exc_type, exc, tb):
        return None

    def fence(self, value):
        return value

    def set(self, **kv):
        return None


_NOOP = _NoopSpan()


def span(name: str, registry: MetricsRegistry | None = None, **args):
    """Open a tracing span: ``with span("ingest.replay"): ...``.

    ``args`` become Chrome-trace event args.  When tracing is disabled
    on the registry this returns a shared no-op object.
    """
    reg = registry if registry is not None else get_registry()
    if not reg.tracing:
        return _NOOP
    return Span(name, reg, args or None)
