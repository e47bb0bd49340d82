"""Incremental message-passing engine: dirty-seeded fixpoint advance.

Each ingest hands the engine a freshly maintained ``PackedCover`` and
the dirty-neighborhood set; the engine re-enters the batch drivers
(``core.driver`` / ``core.parallel``) through their partial-worklist
hooks, warm-starting from the previous fixpoint:

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
* the parallel engine additionally persists a device
  :class:`~repro_torch.core.parallel.GroundingCache` across ingests:
  bins the cover delta left untouched keep their grounded tensors on
  the device, and dirty bins splice in only the changed rows
  (``AdvanceStats.reground_rows`` counts them — the grounding analogue
  of ``IngestReport.replay_visits``).  The row keys driving the
  signature diff come straight from the
  :class:`~repro_torch.core.cover.CoverDelta` splice
  (``PackedCover.row_keys``), so an ingest's device re-grounding is
  bounded by the very rows the cover splice staged.

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
from repro_torch.core.parallel import GroundingCache, run_parallel
from repro_torch.core.types import MatchStore
from repro_torch.kernels.common import resolve_device
from repro_torch.obs import span as obs_span


@dataclasses.dataclass
class AdvanceStats:
    result: EMResult
    n_dirty: int
    n_invalidated: int
    reground_rows: int = 0  # neighborhood rows re-ground on device (parallel)


class IncrementalEngine:
    """Dirty-seeded fixpoint advance over a maintained cover.

    Thread-safety contract: the engine is **single-writer, no-reader**
    state.  ``advance`` mutates the persistent fixpoint (``m_plus``),
    the MMP message pool, and the device grounding cache with no
    internal locking — it must only ever be called by the one thread
    that owns the ingest path (``ResolveService.ingest``).  Concurrent
    *readers* never touch this object: they read the service's
    published :class:`~repro.stream.service.ResolveSnapshot`, which is
    frozen from ``m_plus`` only inside the ingest commit.
    """

    def __init__(
        self,
        matcher,
        *,
        scheme: str = "smp",
        parallel: bool = False,
        mesh=None,
        gcache_capacity: int | None = None,
        gcache_hbm_budget: int | None = None,
        device=None,
    ):
        """``device`` is where the parallel engine runs (``None`` means
        CUDA and raises without a GPU); the sequential engine runs on the
        matcher's own device and ignores it.  ``mesh`` (sharded serving
        hands the service mesh here) splits the parallel engine's bin
        rows over its ranks; None runs on one device."""
        if scheme not in ("smp", "mmp"):
            raise ValueError(f"streaming scheme must be smp|mmp, got {scheme!r}")
        self.matcher = matcher
        self.scheme = scheme
        self.parallel = parallel
        self.mesh = mesh
        self.device = resolve_device(device) if parallel else None
        self.m_plus = MatchStore()
        self.pool = MessagePool()
        # Persistent device grounding cache (parallel engine only):
        # clean bins keep their grounded tensors on the device across
        # ingests; dirty bins splice in only the changed rows.  Created
        # on the first parallel advance.  ``gcache_capacity`` /
        # ``gcache_hbm_budget`` bound the cache's resident device memory
        # (LRU over bins: cold bins drop their grounded tensors and
        # re-ground on demand, bit for bit).
        self.gcache = None
        self.gcache_capacity = gcache_capacity
        self.gcache_hbm_budget = gcache_hbm_budget
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
            for a in ("m_plus", "gcache", "total_evals", "total_rounds",
                      "total_dispatches"):
                t.save_attr(self, a)
        if retracted and self.scheme == "mmp":
            self.pool.discard(retracted)
        carried, dirty_set, dropped = self._invalidate(packed, set(dirty))
        order = sorted(dirty_set)
        rows_before = 0
        with obs_span("ingest.rounds", dirty=len(order)):
            if self.parallel:
                if self.gcache is None:
                    self.gcache = GroundingCache(
                        capacity=self.gcache_capacity,
                        hbm_budget_bytes=self.gcache_hbm_budget,
                    )
                if t is not None:
                    self.gcache.journal_rollback(t)
                rows_before = self.gcache.rows_ground
                result = run_parallel(
                    packed,
                    self.matcher,
                    gg,
                    scheme=self.scheme,
                    active=order,
                    init_matches=carried,
                    pool=self.pool if self.scheme == "mmp" else None,
                    gcache=self.gcache,
                    mesh=self.mesh,
                    device=self.device,
                )
            elif self.scheme == "smp":
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
        reground = (
            self.gcache.rows_ground - rows_before if self.parallel else 0
        )
        return AdvanceStats(
            result=result,
            n_dirty=len(order),
            n_invalidated=dropped,
            reground_rows=reground,
        )
