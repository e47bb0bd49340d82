"""Incremental message-passing engine: dirty-seeded fixpoint advance.

Each ingest hands the engine a freshly maintained ``PackedCover`` and
the dirty-neighborhood set; the engine re-enters the sequential batch
drivers (``core.driver``) through their partial-worklist hooks, warm-starting from the previous fixpoint:

* the worklist is seeded with *only* the dirty neighborhoods — clean
  neighborhoods re-enter solely through evidence-driven re-activation
  (``neighborhoods_of_pairs``), exactly as in Algorithm 1/3;
* ``M+`` starts from the carried previous fixpoint (the matcher is
  monotone in entities and evidence, so previous matches remain valid
  as the instance grows — the continuation computes the least fixpoint
  above them, which by Thm. 2/4 equals the from-scratch fixpoint);
* for MMP the maximal-message pool persists across ingests, and step-7
  promotion re-checks every stored group against the current global
  grounding — the "replay of the affected slice" of the pool;
* the round-parallel engine of the reference (``parallel=True``, with
  its device grounding cache) is not ported yet: asking for it raises
  (``ROADMAP.md`` Queue 1 item 5).

Carried matches are *invalidated* when a cover delta retracts their
candidate pair (possible when an oversized canopy re-splits): the whole
match-graph component is dropped and every neighborhood touching it is
marked dirty, so the affected region is re-derived from scratch rather
than trusting evidence that may no longer be derivable.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.core import pairs as pairlib, txn
from repro_torch.core.closure import clusters_of
from repro_torch.core.cover import PackedCover
from repro_torch.core.driver import EMResult, MessagePool, run_mmp, run_smp
from repro_torch.core.global_grounding import GlobalGrounding
from repro_torch.core.types import MatchStore
from repro_torch.obs import span as obs_span

PARALLEL_NOT_PORTED = (
    "the round-parallel engine is not ported yet: see ROADMAP.md, "
    "Queue 1, item 5 (Round-parallel engine)"
)


@dataclasses.dataclass
class AdvanceStats:
    result: EMResult
    n_dirty: int
    n_invalidated: int
    # neighborhood rows re-ground on device: the reference's parallel
    # engine only, so always 0 here
    reground_rows: int = 0


class IncrementalEngine:
    """Dirty-seeded fixpoint advance over a maintained cover.

    Thread-safety contract: the engine is **single-writer, no-reader**
    state.  ``advance`` mutates the persistent fixpoint (``m_plus``) and
    the MMP message pool with no internal locking — it must only ever
    be called by the one thread that owns the ingest path
    (``ResolveService.ingest``).  Concurrent
    *readers* never touch this object: they read the service's
    published :class:`~repro.stream.service.ResolveSnapshot`, which is
    frozen from ``m_plus`` only inside the ingest commit.
    """

    def __init__(self, matcher, *, scheme: str = "smp", parallel: bool = False):
        if scheme not in ("smp", "mmp"):
            raise ValueError(f"streaming scheme must be smp|mmp, got {scheme!r}")
        if parallel:
            raise NotImplementedError(PARALLEL_NOT_PORTED)
        self.matcher = matcher
        self.scheme = scheme
        self.m_plus = MatchStore()
        self.pool = MessagePool()
        self.total_evals = 0
        self.total_rounds = 0
        self.total_dispatches = 0

    def _invalidate(
        self, packed: PackedCover, dirty: set[int]
    ) -> tuple[MatchStore, set[int], int]:
        """Drop carried matches whose pair left the candidate set.

        Retraction is component-granular: evidence flows inside match
        components, so everything a stale pair could have influenced is
        re-derived.  Returns (carried matches, grown dirty set, #dropped).
        """
        cand = packed.pair_levels
        stale = [g for g in self.m_plus.gids if int(g) not in cand]
        if not stale:
            return self.m_plus, dirty, 0
        bad: set[int] = set()
        stale_set = {int(g) for g in stale}
        for comp in clusters_of(self.m_plus):
            cset = {int(x) for x in comp}
            for g in stale_set:
                a, b = pairlib.split_gid(np.int64(g))
                if int(a) in cset:
                    bad |= cset
                    break
        keep = [
            int(g)
            for g in self.m_plus.gids
            if int(pairlib.split_gid(np.int64(g))[0]) not in bad
        ]
        # per-entity query against the splice-maintained incidence
        # lookup — no per-ingest Cover.entity_index() rebuild
        dirty |= packed.neighborhoods_of_entities(bad)
        carried = MatchStore(np.asarray(keep, dtype=np.int64))
        return carried, dirty, len(self.m_plus) - len(carried)

    def advance(
        self,
        packed: PackedCover,
        dirty: list[int],
        gg: GlobalGrounding | None = None,
        *,
        retracted=None,
    ) -> AdvanceStats:
        """Advance the fixpoint over a freshly maintained cover.

        ``gg`` (MMP only) is the *incrementally maintained* global
        grounding — the service patches it via
        ``GroundingMaintainer.apply_delta`` instead of rebuilding it per
        ingest.  ``retracted`` lists the candidate gids the cover delta
        dropped; they are pruned from the persistent message pool so
        stale groups stop being replayed at every promotion pass.

        Not thread-safe: one in-flight call at a time, from the thread
        that owns the ingest path (see the class docstring).
        """
        t = txn.active()
        if t is not None:
            # pool mutations are journaled entry-wise inside MessagePool;
            # the engine's own carried state is plain attribute rebinds
            for a in ("m_plus", "total_evals", "total_rounds",
                      "total_dispatches"):
                t.save_attr(self, a)
        if retracted and self.scheme == "mmp":
            self.pool.discard(retracted)
        carried, dirty_set, dropped = self._invalidate(packed, set(dirty))
        order = sorted(dirty_set)
        with obs_span("ingest.rounds", dirty=len(order)):
            if self.scheme == "smp":
                result = run_smp(
                    packed, self.matcher, order, init_matches=carried
                )
            else:
                assert gg is not None, "mmp needs the global grounding"
                result = run_mmp(
                    packed,
                    self.matcher,
                    gg,
                    order,
                    init_matches=carried,
                    pool=self.pool,
                )
        self.m_plus = result.matches
        self.total_evals += result.neighborhood_evals
        self.total_rounds += result.rounds
        self.total_dispatches += result.dispatches
        return AdvanceStats(
            result=result, n_dirty=len(order), n_invalidated=dropped
        )
