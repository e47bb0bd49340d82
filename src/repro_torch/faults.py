"""Deterministic fault injection for the ingest path.

Chaos testing only earns its keep when a failure reproduces: every
hook here is seeded and counts deterministically, so a failing CI seed
replays bit-for-bit on a laptop.  The injection sites mirror the
serving span taxonomy (:mod:`repro_torch.obs.tracing`):

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

Modes:

* **raise** (default) — ``maybe_fail`` raises :class:`InjectedFault`;
  the transactional ingest path must roll back and the caller sees a
  clean failure.
* **crash** — ``os._exit(CRASH_EXIT_CODE)``: the process dies without
  unwinding, flushing, or atexit handlers, simulating a SIGKILL'd
  worker.  Crash-recovery tests run this in a subprocess and then
  ``ResolveService.recover`` the durability directory
  (``tests/test_torch_crash.py``).
* **poison** — a request-level fault: ``maybe_fail`` raises whenever
  the in-flight batch contains one of ``poison_names``.  Poison is
  keyed on *names*, not ids, because the serving front-end assigns ids
  per flush attempt — a bisected retry legitimately re-ids a request.

Plans install process-globally (single-writer ingest means no
per-thread plumbing is needed) via :func:`install` / :func:`clear` or
the :func:`injected` context manager.  With no plan installed,
``maybe_fail`` is one global read and a ``None`` check.
"""

from __future__ import annotations

import os
import random
import threading
from contextlib import contextmanager
from dataclasses import dataclass, field
from typing import Iterable, Iterator, Sequence

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

CRASH_EXIT_CODE = 117  # distinguishable from python tracebacks (1) and signals


class InjectedFault(RuntimeError):
    """A deterministic injected failure (transient-style)."""


class PoisonedRequest(ValueError):
    """An injected request-level failure: this batch contains a name
    the active :class:`FaultPlan` declared poisonous."""


@dataclass
class FaultPlan:
    """Which hits of which sites fail, and how.

    ``site_hits`` maps a site name to the set of 1-based hit counts
    that fail (``{"rounds": {1, 2}}`` fails the first two times the
    ``rounds`` site is reached, then passes).  ``crash=True`` switches
    from raising to ``os._exit``.  ``poison_names`` makes any site hit
    whose batch contains one of the names raise
    :class:`PoisonedRequest` (independent of ``site_hits``).
    """

    site_hits: dict[str, frozenset[int]] = field(default_factory=dict)
    crash: bool = False
    poison_names: frozenset[str] = frozenset()
    poison_site: str = "rounds"

    def __post_init__(self) -> None:
        for site in list(self.site_hits) + [self.poison_site]:
            if site not in SITES:
                raise ValueError(f"unknown fault site {site!r} (have {SITES})")
        self.site_hits = {k: frozenset(v) for k, v in self.site_hits.items()}
        self.poison_names = frozenset(self.poison_names)
        self._hits: dict[str, int] = {}
        self._lock = threading.Lock()

    @staticmethod
    def fail_once(site: str, hit: int = 1, *, crash: bool = False) -> "FaultPlan":
        """Fail exactly the ``hit``-th arrival at ``site``."""
        return FaultPlan(site_hits={site: frozenset({hit})}, crash=crash)

    @staticmethod
    def seeded(seed: int, sites: Sequence[str] = SITES, max_hit: int = 3) -> "FaultPlan":
        """A reproducible chaos plan: pick one site and one early hit
        from ``seed``.  Same seed -> same plan, forever."""
        rng = random.Random(seed)
        site = rng.choice(list(sites))
        hit = rng.randint(1, max_hit)
        return FaultPlan(site_hits={site: frozenset({hit})})

    def describe(self) -> str:
        parts = [f"{s}@{sorted(h)}" for s, h in sorted(self.site_hits.items())]
        if self.poison_names:
            parts.append(f"poison[{self.poison_site}]={sorted(self.poison_names)}")
        return ",".join(parts) + (" crash" if self.crash else "")

    # -- called from maybe_fail --------------------------------------------

    def check(self, site: str, names: Iterable[str] | None) -> None:
        if names is not None and self.poison_names and site == self.poison_site:
            bad = self.poison_names.intersection(names)
            if bad:
                raise PoisonedRequest(
                    f"poisoned request at site {site!r}: names {sorted(bad)}"
                )
        hits = self.site_hits.get(site)
        if hits is None:
            return
        with self._lock:
            n = self._hits.get(site, 0) + 1
            self._hits[site] = n
        if n in hits:
            if self.crash:
                os._exit(CRASH_EXIT_CODE)
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


def maybe_fail(site: str, names: Iterable[str] | None = None) -> None:
    """Fault hook; call at the entry of each named ingest stage."""
    plan = _plan
    if plan is not None:
        plan.check(site, names)
