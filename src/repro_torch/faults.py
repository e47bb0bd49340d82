"""Deterministic fault injection for the ingest path.

A failure that reproduces is one that can be debugged: a plan names
which hits of which sites fail, and the hits are counted
deterministically.  The injection sites mirror the serving span
taxonomy (:mod:`repro_torch.obs.tracing`); the port's streaming service
reaches the first six, and the last three wait for its write-ahead log
and checkpointer (``ROADMAP.md`` Queue 1 item 8), which also bring back
the reference's crash and poison modes and its seeded chaos plans:

=================  ====================================================
site               fires at
=================  ====================================================
``lsh``            MinHash probe, after entity rows are staged
``replay``         localized canopy replay
``cover_splice``   incremental cover assembly + packed-array splice
``grounding_splice``  grounding delta application (MMP)
``rounds``         the fixpoint round loop
``commit``         match-store commit / snapshot publication
``wal.append``     the write-ahead-log append (before the fsync)
``wal.rotate``     the WAL segment rotation after a checkpoint commits
``ckpt.rename``    the checkpoint tmp-dir -> final atomic rename
=================  ====================================================

``maybe_fail`` raises :class:`InjectedFault` at a failing hit; the
transactional ingest path must roll back and the caller sees a clean
failure.  Plans install process-globally (single-writer ingest means
no per-thread plumbing is needed) via :func:`install` / :func:`clear`
or the :func:`injected` context manager.  With no plan installed,
``maybe_fail`` is one global read and a ``None`` check.
"""

from __future__ import annotations

import threading
from contextlib import contextmanager
from dataclasses import dataclass, field
from typing import Iterator

SITES = (
    "lsh",
    "replay",
    "cover_splice",
    "grounding_splice",
    "rounds",
    "commit",
    "wal.append",
    "wal.rotate",
    "ckpt.rename",
)


class InjectedFault(RuntimeError):
    """A deterministic injected failure (transient-style)."""


@dataclass
class FaultPlan:
    """Which hits of which sites fail.

    ``site_hits`` maps a site name to the set of 1-based hit counts
    that fail (``{"rounds": {1, 2}}`` fails the first two times the
    ``rounds`` site is reached, then passes).
    """

    site_hits: dict[str, frozenset[int]] = field(default_factory=dict)

    def __post_init__(self) -> None:
        for site in self.site_hits:
            if site not in SITES:
                raise ValueError(f"unknown fault site {site!r} (have {SITES})")
        self.site_hits = {k: frozenset(v) for k, v in self.site_hits.items()}
        self._hits: dict[str, int] = {}
        self._lock = threading.Lock()

    @staticmethod
    def fail_once(site: str, hit: int = 1) -> "FaultPlan":
        """Fail exactly the ``hit``-th arrival at ``site``."""
        return FaultPlan(site_hits={site: frozenset({hit})})

    # -- called from maybe_fail --------------------------------------------

    def check(self, site: str) -> None:
        hits = self.site_hits.get(site)
        if hits is None:
            return
        with self._lock:
            n = self._hits.get(site, 0) + 1
            self._hits[site] = n
        if n in hits:
            raise InjectedFault(f"injected fault at site {site!r} (hit {n})")


_plan: FaultPlan | None = None


def install(plan: FaultPlan) -> None:
    global _plan
    _plan = plan


def clear() -> None:
    global _plan
    _plan = None


@contextmanager
def injected(plan: FaultPlan) -> Iterator[FaultPlan]:
    install(plan)
    try:
        yield plan
    finally:
        clear()


def maybe_fail(site: str) -> None:
    """Fault hook; call at the entry of each named ingest stage."""
    plan = _plan
    if plan is not None:
        plan.check(site)
