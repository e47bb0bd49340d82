"""Undo-log transactions: all-or-nothing mutation of host-side state.

``ResolveService.ingest`` threads one mutation pass through the LSH
index, the delta cover, the grounding maintainer, the message pool and
the engine's match store.  A failure anywhere in that pass (a poisoned
request, an injected fault, an OOM in the round loop) must not leave
the service torn — the paper's O(dirty) locality is exactly what makes
this cheap: each ingest touches a bounded dirty neighborhood, so a
journal of the *touched entries* is an O(dirty) undo log, where a
defensive deep copy of the service state would be O(corpus).

Mechanics: a :class:`Transaction` is a LIFO journal of undo closures.
Mutation sites call :func:`active` (thread-local; ``None`` outside an
ingest, so batch pipelines pay one attribute lookup) and journal the
*pre-image* of whatever they are about to clobber:

* ``save_attr(obj, name)``   — attribute rebind (``self.packed = ...``)
* ``save_key(d, k)``         — dict entry write/delete (first touch wins)
* ``save_len(lst)``          — append-only list growth (undo truncates)
* ``set_add`` / ``set_discard`` — journaled set mutation
* ``on_rollback(fn)``        — arbitrary compensation (e.g. cache drop)

First-touch deduplication (keyed on ``(id(container), key)``) keeps the
journal O(distinct entries touched) even when a hot loop rewrites the
same entry repeatedly, and LIFO replay restores every journaled
location to its pre-transaction value regardless of how many times it
was written afterwards.

In-place ndarray writes are either journaled with explicit pre-image
copies (``save_row`` for the feature-row fill-ins in
``DeltaCover._grow``) or provably unobservable after rollback (packed
bin-buffer tail appends write only beyond every published view length,
so restoring ``_bin_seq``/``_bin_arrays`` hides them) — the journal
never silently aliases a buffer that is about to be scribbled on.
"""

from __future__ import annotations

import threading
from contextlib import contextmanager
from typing import Any, Callable, Iterator

_MISSING = object()

_tls = threading.local()


class Transaction:
    """LIFO journal of undo closures with first-touch dedup."""

    __slots__ = ("_ops", "_seen")

    def __init__(self) -> None:
        self._ops: list[Callable[[], None]] = []
        self._seen: set = set()

    def __len__(self) -> int:
        return len(self._ops)

    # -- journal helpers ----------------------------------------------------

    def save_attr(self, obj: Any, name: str) -> None:
        """Journal ``obj.<name>`` (the *reference*, not a copy) so a
        rebind can be undone.  Callers that mutate the referenced object
        in place must journal those entry writes separately."""
        key = (id(obj), "a", name)
        if key in self._seen:
            return
        self._seen.add(key)
        prev = getattr(obj, name, _MISSING)
        if prev is _MISSING:
            def undo() -> None:
                if hasattr(obj, name):
                    delattr(obj, name)
        else:
            def undo() -> None:
                setattr(obj, name, prev)
        self._ops.append(undo)

    def save_key(self, container: dict, key: Any, copy: Callable | None = None) -> None:
        """Journal one dict entry before a write/delete.  ``copy`` takes
        a pre-image copy when the *value* is about to be mutated in
        place (e.g. a set being grown) rather than rebound."""
        k = (id(container), "k", key)
        if k in self._seen:
            return
        self._seen.add(k)
        if key in container:
            prev = container[key]
            if copy is not None:
                prev = copy(prev)

            def undo() -> None:
                container[key] = prev
        else:
            def undo() -> None:
                container.pop(key, None)
        self._ops.append(undo)

    def save_len(self, seq: list) -> None:
        """Journal an append-only list's length; undo truncates back.
        Entry *overwrites* below the journaled length still need
        ``save_item``."""
        k = (id(seq), "l")
        if k in self._seen:
            return
        self._seen.add(k)
        n = len(seq)

        def undo() -> None:
            del seq[n:]
        self._ops.append(undo)

    def save_item(self, seq: list, i: int) -> None:
        """Journal one list slot before an in-place overwrite."""
        k = (id(seq), "i", i)
        if k in self._seen:
            return
        self._seen.add(k)
        prev = seq[i]

        def undo() -> None:
            if i < len(seq):
                seq[i] = prev
        self._ops.append(undo)

    def save_row(self, arr, i: int) -> None:
        """Journal one ndarray row (pre-image copy) before an in-place
        write — the only journaling path that copies data."""
        k = (id(arr), "r", i)
        if k in self._seen:
            return
        self._seen.add(k)
        prev = arr[i].copy()

        def undo() -> None:
            arr[i] = prev
        self._ops.append(undo)

    def set_add(self, s: set, item: Any) -> None:
        if item not in s:
            s.add(item)
            self._ops.append(lambda: s.discard(item))

    def set_discard(self, s: set, item: Any) -> None:
        if item in s:
            s.discard(item)
            self._ops.append(lambda: s.add(item))

    def on_rollback(self, fn: Callable[[], None]) -> None:
        """Register an arbitrary compensation closure (runs in LIFO
        order with the rest of the journal)."""
        self._ops.append(fn)

    # -- lifecycle ----------------------------------------------------------

    def rollback(self) -> int:
        """Replay the journal in reverse; returns the op count."""
        n = len(self._ops)
        while self._ops:
            self._ops.pop()()
        self._seen.clear()
        return n


def active() -> Transaction | None:
    """The current thread's open transaction, or ``None``."""
    return getattr(_tls, "txn", None)


@contextmanager
def transaction() -> Iterator[Transaction]:
    """Open a transaction for the current thread.  The caller owns the
    abort decision: on exception the journal is rolled back and the
    exception re-raised; on success the journal is simply dropped
    (there is no redo side — state is already final)."""
    if getattr(_tls, "txn", None) is not None:
        raise RuntimeError("nested ingest transactions are not supported")
    t = Transaction()
    _tls.txn = t
    try:
        yield t
    except BaseException:
        _tls.txn = None  # mutation during rollback must not re-journal
        t.rollback()
        raise
    finally:
        _tls.txn = None
