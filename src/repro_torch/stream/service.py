"""Resolve-query service: ``ingest(batch)`` / ``resolve(id) -> cluster``.

The user-facing streaming facade.  Each ingest runs the full incremental
path — LSH probe, delta cover maintenance, incremental grounding patch,
dirty-seeded fixpoint advance — and folds the new matches into a
persistent union-find, so resolve queries are O(alpha) lookups between
ingests.  The service's invariant, checked by the streaming tests:
after any sequence of micro-batches its match fixpoint is bit-for-bit
the one the batch pipeline computes over the union of everything
ingested.

Every per-ingest cost tracks the dirty set, not the corpus:

* the canopy replay sweeps only the touched similarity components
  (``IngestReport.replay_visits``);
* for MMP, the global grounding is patched in place via
  ``GroundingMaintainer.apply_delta`` instead of rebuilt
  (``IngestReport.grounding_pair_visits``);
* only dirty neighborhoods seed the fixpoint advance.

On the device (``device=None`` means CUDA and raises without a GPU):
the ``minhash`` signatures of each batch, its ``ngram_sim`` probe, and
the matcher's ``icm_sweep`` sweeps.  The logical state — cover,
grounding, fixpoint, clusters — stays numpy and Python containers on
the host, as in the reference, so :mod:`repro_torch.stream.digest`
hashes the same bytes.

Serving reads don't race ingests — and they don't *wait* on them
either.  The service keeps **double-buffered snapshots**: readers
always resolve against an immutable published :class:`ResolveSnapshot`
(a plain attribute read — no lock), while the in-flight ingest mutates
a private write buffer; the commit section freezes the write buffer
into a fresh snapshot and publishes it by a single reference swap.  A
reader therefore observes the fixpoint before or after an ingest,
never a half-applied one, and its latency is independent of ingest
wall time.

Thread-safety contract (per lock):

* ``_lock`` — the **writer** lock.  Serializes concurrent ``ingest``
  commits and the write-buffer mutation (``uf``/``_members``/
  ``_fixpoint``/``reports``).  Readers never take it.
* ``_published`` — the read buffer.  Immutable once published;
  replaced, never mutated (reference assignment is atomic under the
  GIL), so ``resolve``/``resolve_many``/``snapshot``/``clusters`` are
  lock-free and safe from any number of threads.

``ServiceConfig(parallel=True)`` advances the fixpoint with the
round-parallel engine (:mod:`repro_torch.core.parallel`), whose device
grounding cache persists across ingests and can be bounded
(``gcache_capacity`` / ``gcache_hbm_budget``: an LRU over bins, cold
bins re-ground on demand, bit for bit).  ``ServiceConfig.matcher``
takes a registered family name (:mod:`repro_torch.core.matchers`).

Durability (``ServiceConfig.durability_dir``): every ingest is appended
to a write-ahead log (:mod:`repro_torch.stream.wal`) before any state
mutates, and every ``checkpoint_every`` ingests the logical state is
checkpointed (:mod:`repro_torch.checkpoint.checkpointer`); the logical
state is host-only, so a checkpoint written on the card restores on the
CPU and the other way round.  :meth:`ResolveService.recover` rebuilds a
service from the latest checkpoint plus the WAL tail.  The higher-traffic
front-end (async ingest queue, micro-batch coalescing, admission
control) lives in :mod:`repro_torch.stream.serving` and drives this
service single-writer.

Sharded serving (``shard=``, a :class:`repro_torch.stream.shard.ShardContext`):
one replica a rank, the LSH bucket map partitioned over the ranks and
the parallel engine's bin rows split over them; see
:mod:`repro_torch.stream.shard`.
"""

from __future__ import annotations

import dataclasses
import pickle
import threading
import time
import warnings
from pathlib import Path

import numpy as np

from repro_torch import faults
from repro_torch.checkpoint.checkpointer import Checkpointer
from repro_torch.core import pairs as pairlib, txn
from repro_torch.core.closure import UnionFind
from repro_torch.core.cover import DEFAULT_BINS
from repro_torch.core.global_grounding import GroundingMaintainer
from repro_torch.core.mln import MLNMatcher, MLNWeights, PAPER_LEARNED
from repro_torch.core.parallel import _same_device
from repro_torch.core.types import MatchStore
from repro_torch.kernels.common import resolve_device
from repro_torch.obs import get_registry, total_upload_bytes
from repro_torch.obs import span as obs_span
from repro_torch.stream.delta import DeltaCover
from repro_torch.stream.engine import IncrementalEngine
from repro_torch.stream.index import LSHConfig
from repro_torch.stream.wal import WriteAheadLog

@dataclasses.dataclass
class IngestReport:
    ids: list[int]  # global entity ids assigned to the batch
    n_entities: int  # total entities resolved so far
    n_neighborhoods: int  # current cover size
    n_dirty: int  # neighborhoods re-seeded this ingest
    n_invalidated: int  # carried matches dropped by cover retraction
    neighborhood_evals: int  # matcher evaluations this ingest
    new_matches: int  # matches added this ingest
    replay_visits: int  # ids swept by the localized canopy replay
    grounding_pair_visits: int  # pairs patched in the grounding (mmp)
    wall_time_s: float
    # device rows re-ground this ingest (parallel engine: clean bins hit
    # the persistent grounding cache; 0 on the sequential engine)
    reground_rows: int = 0
    # neighborhood rows (re)staged by the incremental cover assembly +
    # packed-array splice (CoverDelta) — O(dirty), not O(neighborhoods)
    cover_splice_rows: int = 0
    # grounding array rows spliced by GroundingMaintainer.grounding()
    # (mmp) — O(delta), not the O(candidate pairs) full materialization
    grounding_splice_rows: int = 0
    # Bounded serving memory (parallel engine, LRU GroundingCache; 0 on
    # the sequential engine): high-water mark of tensor-resident bins,
    # plus this ingest's LRU evictions and cold re-grounds.
    peak_resident_bins: int = 0
    cache_evictions: int = 0
    cold_regrounds: int = 0
    # step-7 promotion passes on the host coupling-COO walk (every pass
    # of the sequential run_mmp; 0 on the parallel engine's promoter)
    promote_host_scans: int = 0
    # packed-array append accounting (CoverDelta backing buffers):
    # tail rows written by the append path and rows memcpy'd by
    # capacity-doubling growth — amortized O(fresh)
    append_rows: int = 0
    growth_copy_rows: int = 0
    # host->device bytes uploaded during this ingest, summed over the
    # three transfer sites of repro_torch.obs.transfer (all on the
    # round-parallel engine, so 0 on the sequential one) — the
    # per-ingest delta of the cumulative ``transfer.*_bytes`` counters
    upload_bytes: int = 0


# IngestReport fields published as monotone ``ingest.*`` counters;
# n_entities / n_neighborhoods / peak_resident_bins become gauges and
# wall_time_s the ``ingest.wall_ms`` histogram (see _publish_ingest).
_INGEST_COUNTER_FIELDS = (
    "n_dirty",
    "n_invalidated",
    "neighborhood_evals",
    "new_matches",
    "replay_visits",
    "grounding_pair_visits",
    "reground_rows",
    "cover_splice_rows",
    "grounding_splice_rows",
    "cache_evictions",
    "cold_regrounds",
    "promote_host_scans",
    "append_rows",
    "growth_copy_rows",
    "upload_bytes",
)


def _publish_ingest(report: IngestReport) -> IngestReport:
    """Publish an :class:`IngestReport` into the runtime registry.

    The dataclass stays the per-call API; the cumulative ``ingest.*``
    family is the process-wide view.  The ``dirty_frac`` /
    ``replay_frac`` histograms are the O(dirty)-story ratios (work per
    ingest over corpus size).
    """
    reg = get_registry()
    reg.counter("ingest.count").inc()
    for name in _INGEST_COUNTER_FIELDS:
        v = int(getattr(report, name))
        if v:
            reg.counter(f"ingest.{name}").inc(v)
    reg.gauge("ingest.n_entities").set(report.n_entities)
    reg.gauge("ingest.n_neighborhoods").set(report.n_neighborhoods)
    reg.gauge("ingest.peak_resident_bins").max(report.peak_resident_bins)
    reg.histogram("ingest.wall_ms").observe(report.wall_time_s * 1e3)
    reg.histogram("ingest.upload_bytes").observe(report.upload_bytes)
    reg.histogram("ingest.grounding_pair_visits").observe(
        report.grounding_pair_visits
    )
    reg.histogram("ingest.dirty_frac").observe(
        report.n_dirty / max(report.n_neighborhoods, 1)
    )
    reg.histogram("ingest.replay_frac").observe(
        report.replay_visits / max(report.n_entities, 1)
    )
    return report


def _observe_resolve(t0: float, n_queries: int) -> None:
    """Record one resolve call: latency histogram + query counter."""
    reg = get_registry()
    reg.histogram("resolve.latency_ms").observe(
        (time.perf_counter() - t0) * 1e3
    )
    reg.counter("resolve.queries").inc(n_queries)
    reg.counter("resolve.calls").inc()


@dataclasses.dataclass(frozen=True)
class ResolveSnapshot:
    """An immutable, consistent view of the match fixpoint.

    Frozen at the end of an ingest commit (the read buffer of the
    service's double-buffered pair), so a reader thread never observes
    a half-applied ingest.  Resolution against a snapshot is pure dict
    lookups — no locks, no interaction with ongoing ingests.  All
    methods are safe from any number of threads; the backing dicts and
    arrays are never mutated after publication.

    What a reader can observe mid-ingest: exactly the fixpoint of some
    prefix of the ingest sequence.  A snapshot taken at ingest k keeps
    answering for ingest k forever — a polling reader re-calls
    ``ResolveService.snapshot()`` to step forward.
    """

    matches: MatchStore
    n_entities: int
    n_ingests: int
    _root: dict[int, int]  # entity -> cluster root (pre-flattened)
    _members: dict[int, np.ndarray]  # root -> sorted cluster members

    def resolve(self, entity_id: int) -> np.ndarray:
        eid = int(entity_id)
        root = self._root.get(eid)
        if root is None:
            return np.asarray([eid], dtype=np.int64)
        return self._members[root]

    def resolve_many(self, entity_ids) -> list[np.ndarray]:
        t0 = time.perf_counter()
        out = [self.resolve(e) for e in entity_ids]
        _observe_resolve(t0, len(out))
        return out

    def clusters(self) -> list[np.ndarray]:
        return [m for m in self._members.values() if len(m) >= 2]


@dataclasses.dataclass(frozen=True)
class ServiceConfig:
    """Typed configuration for :class:`ResolveService`, the reference's
    fields unchanged.

    ``matcher`` accepts a registered family name (resolved through
    :func:`repro_torch.core.matchers.get_matcher` on the service's
    device), a matcher instance, or ``None`` for the paper's collective
    MLN at ``weights``.  ``parallel`` runs the round-parallel engine;
    ``gcache_capacity`` / ``gcache_hbm_budget`` bound its grounding
    cache's resident bins / bytes (the sequential engine has no cache
    and ignores them).
    """

    scheme: str = "smp"  # 'nomp' | 'smp' | 'mmp'
    matcher: object = None  # family name (str), instance, or None
    weights: MLNWeights = PAPER_LEARNED
    parallel: bool = False
    t_loose: float = 0.70
    t_tight: float = 0.90
    k_max: int = 32
    feature_dim: int = 128
    k_bins: tuple[int, ...] = DEFAULT_BINS
    thresholds: tuple | None = None
    boundary_relation: str = "coauthor"
    lsh: LSHConfig | None = None
    level_cache_max: int | None = None
    gcache_capacity: int | None = None
    gcache_hbm_budget: int | None = None
    durability_dir: str | None = None
    checkpoint_every: int = 0
    wal_fsync: bool = True

    def __post_init__(self):
        if self.scheme not in ("nomp", "smp", "mmp"):
            raise ValueError(f"unknown scheme {self.scheme!r}")
        if self.checkpoint_every < 0:
            raise ValueError("checkpoint_every must be >= 0")
        if not 0.0 < self.t_loose <= self.t_tight <= 1.0:
            raise ValueError("need 0 < t_loose <= t_tight <= 1")
        if self.checkpoint_every > 0 and self.durability_dir is None:
            raise ValueError("checkpoint_every > 0 needs durability_dir")

    def build_matcher(self, device=None):
        if self.matcher is None:
            return MLNMatcher(self.weights, device=device)
        if isinstance(self.matcher, str):
            from repro_torch.core.matchers import get_matcher

            return get_matcher(self.matcher, device=device)
        return self.matcher


class ResolveService:
    """Streaming entity resolution over micro-batches.

    Construct with a :class:`ServiceConfig` (``ResolveService(config)``);
    the accreted constructor keywords of earlier releases still work as
    a deprecated shim (``ResolveService(scheme="mmp", ...)`` warns and
    folds the kwargs into a config).
    """

    def __init__(self, config: ServiceConfig | None = None, *, shard=None,
                 device=None, **deprecated_kwargs):
        """``device`` is where the kernels run: ``None`` means CUDA and
        raises without a GPU; pass ``device="cpu"`` for the plain
        versions on the CPU.

        ``durability_dir`` turns on crash durability: every ingest is
        appended to a write-ahead log (fsync'd unless ``wal_fsync`` is
        off) *before* any in-memory state mutates, and — when
        ``checkpoint_every`` > 0 — every that-many ingests the full
        logical state is snapshotted through
        :class:`repro_torch.checkpoint.checkpointer.Checkpointer` and
        the WAL is rotated/GC'd.  :meth:`recover` rebuilds a service
        from the latest snapshot plus the WAL tail; by stream/batch
        schedule-invariance the recovered fixpoint is bit-for-bit the
        uninterrupted one.

        ``shard`` (a :class:`repro_torch.stream.shard.ShardContext`)
        turns on sharded serving: the LSH bucket map is partitioned
        across the context's ranks (probes merge by cross-rank union)
        and the parallel engine runs its rounds on the context's mesh;
        ``device`` then defaults to the rank's.  The logical state stays
        replicated on every rank — see :mod:`repro_torch.stream.shard`
        for the equivalence argument."""
        if deprecated_kwargs:
            if config is not None:
                raise TypeError(
                    "pass either a ServiceConfig or keyword arguments, "
                    f"not both (got {sorted(deprecated_kwargs)})"
                )
            warnings.warn(
                "ResolveService(**kwargs) is deprecated; pass "
                "ResolveService(ServiceConfig(...)) instead",
                DeprecationWarning,
                stacklevel=2,
            )
            config = ServiceConfig(**deprecated_kwargs)
        cfg = config if config is not None else ServiceConfig()
        self.config = cfg
        self.weights = cfg.weights
        self.scheme = cfg.scheme
        self.shard = shard
        if shard is not None and device is None:
            device = shard.mesh.device
        self.device = resolve_device(device)
        if shard is not None and not _same_device(self.device, shard.mesh.device):
            raise ValueError(
                f"the service on {self.device}, but its shard's rank is on {shard.mesh.device}"
            )
        matcher = cfg.build_matcher(self.device)
        self.delta = DeltaCover(
            t_loose=cfg.t_loose,
            t_tight=cfg.t_tight,
            k_max=cfg.k_max,
            feature_dim=cfg.feature_dim,
            k_bins=cfg.k_bins,
            thresholds=cfg.thresholds,
            boundary_relation=cfg.boundary_relation,
            lsh=cfg.lsh,
            level_cache_max=cfg.level_cache_max,
            shard=shard.spec if shard is not None else None,
            shard_merge=shard.merger.union if shard is not None else None,
            device=self.device,
        )
        # families that score by entity *name* read the live id -> name
        # table the cover maintains; the hook is capability-based so any
        # matcher instance that has it inherits it
        bind = getattr(matcher, "bind_names", None)
        if bind is not None:
            bind(self.delta.names)
        self.engine = IncrementalEngine(
            matcher,
            scheme=cfg.scheme,
            parallel=cfg.parallel,
            mesh=shard.mesh if shard is not None else None,
            gcache_capacity=cfg.gcache_capacity,
            gcache_hbm_budget=cfg.gcache_hbm_budget,
            device=self.device,
        )
        # MMP needs the global grounding; maintained incrementally so no
        # ingest pays the O(corpus) from-scratch build.  The delta's
        # new_edges are boundary-relation tuples, as the maintainer's
        # caller contract requires.
        self.grounding = (
            GroundingMaintainer(cfg.weights) if cfg.scheme == "mmp" else None
        )
        self.uf = UnionFind()
        self._members: dict[int, set[int]] = {}  # uf root -> cluster members
        self._fixpoint = MatchStore()
        # Writer lock: serializes ingest commits and write-buffer
        # mutation.  The read path never takes it (see module docstring).
        self._lock = threading.RLock()
        # Write-buffer freeze caches, maintained incrementally by
        # _add_match so the per-commit publish cost is O(clusters
        # touched this ingest), not O(all clusters):
        self._root_cache: dict[int, int] = {}  # entity -> flattened root
        self._frozen: dict[int, np.ndarray] = {}  # root -> sorted members
        # The read buffer: swapped by reference at the end of each
        # commit, immutable afterwards.
        self._published = ResolveSnapshot(
            matches=self._fixpoint,
            n_entities=0,
            n_ingests=0,
            _root={},
            _members={},
        )
        self.reports: list[IngestReport] = []
        # Durability plane (optional): WAL + checkpointer.  ``_seq`` is
        # the last *assigned* ingest sequence number — aborted ingests
        # consume their seq (an abort marker records the outcome), so
        # replay never confuses a rolled-back batch with a committed one.
        self.durability_dir = cfg.durability_dir
        self.checkpoint_every = int(cfg.checkpoint_every)
        self.wal: WriteAheadLog | None = None
        self._ckpt: Checkpointer | None = None
        self._seq = 0
        self._replaying = False
        if cfg.durability_dir is not None:
            base = Path(cfg.durability_dir)
            self.wal = WriteAheadLog(base / "wal", fsync=cfg.wal_fsync)
            self._ckpt = Checkpointer(str(base / "ckpt"), keep=2)

    # -- ingest path ------------------------------------------------------

    def ingest(
        self,
        names: list[str],
        edges: np.ndarray | None = None,
        ids: list[int] | None = None,
    ) -> IngestReport:
        """Resolve a micro-batch of arriving entity references.

        ``ids`` (optional) are explicit global entity ids — they must be
        fresh; relation ``edges`` are given in global ids and may point
        at earlier arrivals.  Without ``ids``, fresh sequential ids are
        assigned.

        Thread safety: the cover/grounding/engine stages mutate
        unprotected incremental state, so ``ingest`` must be called
        from **one writer at a time** (the commit section additionally
        takes ``_lock`` against racing writers, but the stages before
        it are not serialized).  Readers are unaffected throughout:
        they keep resolving against the previously published snapshot
        until the commit swaps in the new one.

        Failure atomicity: the whole ingest runs inside one
        :func:`repro_torch.core.txn.transaction`.  If *any* stage raises
        — LSH probe, canopy replay, cover splice, grounding patch,
        fixpoint rounds, or the commit itself — the undo journal rolls
        every touched structure back and the service is bit-for-bit the
        state it had before the call.  With durability on, the batch is
        WAL-appended (fsync'd) *before* any state mutates, and an abort
        marker records a rollback so recovery skips it.
        """
        t0 = time.perf_counter()
        if ids is None:
            base = len(self.delta.names)
            ids = list(range(base, base + len(names)))
        else:
            ids = [int(i) for i in ids]
        names = list(names)
        seq = None
        if self.wal is not None and not self._replaying:
            self._seq += 1
            seq = self._seq
            faults.maybe_fail("wal.append", names)
            self.wal.append(seq, names, edges, ids)
        try:
            with txn.transaction():
                report = self._ingest_body(t0, names, edges, ids)
        except BaseException:
            get_registry().counter("ingest.aborts").inc()
            if seq is not None:
                try:
                    self.wal.append_abort(seq)
                except Exception:
                    # Best-effort: without the marker, recovery replays
                    # the batch and (deterministically) re-aborts it.
                    pass
            raise
        if (
            seq is not None
            and self.checkpoint_every
            and seq % self.checkpoint_every == 0
        ):
            self._checkpoint(seq)
        return report

    def _ingest_body(
        self,
        t0: float,
        names: list[str],
        edges: np.ndarray | None,
        ids: list[int],
    ) -> IngestReport:
        """The journaled ingest body (caller holds the open
        transaction)."""
        bytes0 = total_upload_bytes()
        prev_matches = self.engine.m_plus
        with obs_span("ingest", batch=len(ids)):
            d = self.delta.ingest(ids, names, edges)
            grounding_visits = 0
            grounding_splice = 0
            gg = None
            if self.grounding is not None:
                faults.maybe_fail("grounding_splice", names)
                with obs_span("ingest.grounding_splice"):
                    gstats = self.grounding.apply_delta(
                        d.added_pairs, d.retracted_pairs, d.new_edges
                    )
                    grounding_visits = gstats.pairs_visited
                    gg = self.grounding.grounding()
                    grounding_splice = self.grounding.last_splice_rows
            faults.maybe_fail("rounds", names)
            stats = self.engine.advance(
                d.packed, d.dirty, gg, retracted=d.retracted_pairs
            )

            # Commit: the write buffer mutates under the writer lock,
            # then the whole ingest is published to readers in one
            # reference swap — snapshot()/resolve() observe the state
            # before or after this ingest, never mid-way, and never
            # wait on it.
            with self._lock, obs_span("ingest.commit"):
                faults.maybe_fail("commit", names)
                t = txn.active()
                if t is not None:
                    # Attribute-level saves cover both the invalidation
                    # rebinds and the plain rebinds below; entry-level
                    # mutations inside the (possibly kept) dicts are
                    # journaled by _add_match itself.
                    for a in ("uf", "_members", "_root_cache", "_frozen",
                              "_fixpoint", "_published"):
                        t.save_attr(self, a)
                    t.save_len(self.reports)
                new = stats.result.matches.difference(prev_matches)
                if stats.n_invalidated:
                    self.uf = UnionFind()
                    self._members = {}
                    self._root_cache = {}
                    self._frozen = {}
                    new = stats.result.matches.gids
                for g in new:
                    a, b = pairlib.split_gid(np.int64(g))
                    self._add_match(int(a), int(b))
                self._fixpoint = stats.result.matches

                report = IngestReport(
                    ids=ids,
                    n_entities=self.delta.n_entities,
                    n_neighborhoods=len(d.cover),
                    n_dirty=stats.n_dirty,
                    n_invalidated=stats.n_invalidated,
                    neighborhood_evals=stats.result.neighborhood_evals,
                    new_matches=int(len(new)),
                    replay_visits=d.replay_visits,
                    grounding_pair_visits=grounding_visits,
                    wall_time_s=time.perf_counter() - t0,
                    reground_rows=stats.reground_rows,
                    cover_splice_rows=d.cover_splice_rows,
                    grounding_splice_rows=grounding_splice,
                    peak_resident_bins=stats.result.peak_resident_bins,
                    cache_evictions=stats.result.cache_evictions,
                    cold_regrounds=stats.result.cold_regrounds,
                    promote_host_scans=stats.result.promote_host_scans,
                    append_rows=self.delta.cover_delta.last_append_rows,
                    growth_copy_rows=(
                        self.delta.cover_delta.last_growth_copy_rows
                    ),
                    upload_bytes=total_upload_bytes() - bytes0,
                )
                self.reports.append(report)
                _publish_ingest(report)
                # Swap-on-commit: freeze the write buffer into the new
                # read snapshot.  The dict() copies are O(entities)
                # pointer copies; the member arrays are shared with the
                # freeze caches and never mutated after publication.
                self._published = ResolveSnapshot(
                    matches=self._fixpoint,
                    n_entities=self.delta.n_entities,
                    n_ingests=len(self.reports),
                    _root=dict(self._root_cache),
                    _members=dict(self._frozen),
                )
        return report

    # -- durability: checkpoint + WAL recovery ----------------------------

    def _logical_state(self) -> dict:
        """Everything needed to resume bit-for-bit, as one picklable
        dict, with no tensor in it: the cover's device copies (the LSH
        hash table) are dropped by its ``__getstate__``.  Excluded on
        purpose: the matcher (rebuilt by the ctor from ``weights`` at
        recover time), the device grounding cache (lazy; a cold
        re-ground is bit-for-bit), and the obs registry (monotone
        counters, not logical state)."""
        eng = self.engine
        return {
            "seq": self._seq,
            "delta": self.delta,
            "grounding": self.grounding,
            "engine": {
                "m_plus": eng.m_plus,
                "pool": eng.pool,
                "total_evals": eng.total_evals,
                "total_rounds": eng.total_rounds,
                "total_dispatches": eng.total_dispatches,
            },
            "uf": self.uf,
            "members": self._members,
            "fixpoint": self._fixpoint,
            "root_cache": self._root_cache,
            "frozen": self._frozen,
            "published": self._published,
            "reports": self.reports,
        }

    def _load_logical_state(self, state: dict) -> None:
        self._seq = int(state["seq"])
        delta = state["delta"]
        spec = self.shard.spec if self.shard is not None else None
        if delta.index.shard != spec:
            raise ValueError(
                f"the checkpoint holds the LSH buckets of shard {delta.index.shard}, "
                f"and this service is shard {spec}"
            )
        delta.index.merge = self.delta.index.merge  # this process's collective
        self.delta = delta
        self.delta.place(self.device)  # device copies re-made lazily
        self.grounding = state["grounding"]
        eng = state["engine"]
        self.engine.m_plus = eng["m_plus"]
        self.engine.pool = eng["pool"]
        self.engine.total_evals = eng["total_evals"]
        self.engine.total_rounds = eng["total_rounds"]
        self.engine.total_dispatches = eng["total_dispatches"]
        self.engine.gcache = None  # re-grounds lazily, bit-for-bit
        self.uf = state["uf"]
        self._members = state["members"]
        self._fixpoint = state["fixpoint"]
        self._root_cache = state["root_cache"]
        self._frozen = state["frozen"]
        self._published = state["published"]
        self.reports = state["reports"]

    def _checkpoint(self, seq: int) -> None:
        """Snapshot the logical state, then rotate + GC the WAL so
        recovery replays only the post-checkpoint tail.  Ordering
        matters: the checkpoint rename commits *before* any WAL segment
        is dropped, so a crash anywhere in between only leaves extra
        (idempotently skippable) WAL records behind."""
        t0 = time.perf_counter()
        blob = np.frombuffer(
            pickle.dumps(self._logical_state(),
                         protocol=pickle.HIGHEST_PROTOCOL),
            dtype=np.uint8,
        )
        self._ckpt.save(seq, {"service": {"blob": blob}}, meta={"seq": seq})
        self.wal.rotate(seq + 1)
        self.wal.gc(seq)
        reg = get_registry()
        reg.counter("ckpt.saves").inc()
        reg.counter("ckpt.bytes").inc(blob.nbytes)
        reg.gauge("ckpt.last_seq").set(seq)
        reg.histogram("ckpt.save_ms").observe((time.perf_counter() - t0) * 1e3)

    @classmethod
    def recover(
        cls,
        durability_dir: str,
        config: "ServiceConfig | None" = None,
        *,
        device=None,
        **ctor_kwargs,
    ) -> "ResolveService":
        """Rebuild a service from ``durability_dir`` on ``device``
        (``None``: CUDA): restore the latest checkpoint (if any), then
        replay the WAL tail — committed records past the checkpoint, in
        sequence order, skipping aborted ones.  ``config`` (or the
        deprecated ``ctor_kwargs``) must match the original construction
        (scheme/weights/thresholds...); the matcher and device caches
        are rebuilt, everything logical comes from disk, whichever
        device wrote it.  The result is bit-for-bit the fixpoint of an
        uninterrupted run over the same committed batches (schedule
        invariance)."""
        if config is not None:
            shard = ctor_kwargs.pop("shard", None)
            if ctor_kwargs:
                raise TypeError(
                    "pass either a ServiceConfig or keyword arguments, "
                    f"not both (got {sorted(ctor_kwargs)})"
                )
            svc = cls(
                dataclasses.replace(config, durability_dir=durability_dir),
                shard=shard, device=device,
            )
        else:
            svc = cls(durability_dir=durability_dir, device=device, **ctor_kwargs)
        t0 = time.perf_counter()
        ckpt_seq = 0
        step = svc._ckpt.latest_step()
        if step is not None:
            flat, meta = svc._ckpt.restore_raw(step)
            svc._load_logical_state(
                pickle.loads(flat["service|blob"].tobytes())
            )
            ckpt_seq = int(meta.get("seq", step))
        records, aborted = WriteAheadLog.scan(svc.wal.directory)
        replayed = 0
        svc._replaying = True
        try:
            for rec in records:
                if rec.seq <= ckpt_seq or rec.seq in aborted:
                    continue
                try:
                    svc.ingest(rec.names, rec.edges, ids=rec.ids)
                except Exception:
                    # The live run crashed before this batch's abort
                    # marker hit disk; the replay re-derives the same
                    # abort and rollback restores pre-batch state.
                    pass
                replayed += 1
        finally:
            svc._replaying = False
        svc._seq = max(
            [svc._seq, ckpt_seq]
            + [r.seq for r in records]
            + list(aborted)
        )
        reg = get_registry()
        reg.counter("recover.replayed").inc(replayed)
        reg.histogram("recover.wall_ms").observe(
            (time.perf_counter() - t0) * 1e3
        )
        return svc

    def close(self) -> None:
        """Release durability file handles (safe to call twice)."""
        if self.wal is not None:
            self.wal.close()
        if self._ckpt is not None:
            self._ckpt.wait()

    # -- query path -------------------------------------------------------

    @property
    def matches(self) -> MatchStore:
        """Live engine fixpoint — the *write side*.  Coherent only
        between ingests; concurrent readers should prefer
        ``snapshot().matches`` (committed, immutable)."""
        return self.engine.m_plus

    @property
    def total_evals(self) -> int:
        """Cumulative matcher evaluations (write side; read it between
        ingests or accept a momentarily stale value)."""
        return self.engine.total_evals

    def _add_match(self, a: int, b: int) -> None:
        """Union a matched pair into the write buffer (caller holds
        ``_lock``), keeping the root -> members map *and* the freeze
        caches current, so the per-commit publish is O(touched
        clusters) and resolve queries stay O(1) dict lookups."""
        t = txn.active()
        ra, rb = self.uf.find(a), self.uf.find(b)
        if t is not None:
            # Popped member sets are never mutated afterwards (merged is
            # a fresh set), so reference saves suffice.
            t.save_key(self._members, ra)
            t.save_key(self._members, rb)
        ma = self._members.pop(ra, {ra})
        mb = self._members.pop(rb, {rb})
        self.uf.union(a, b)
        merged = ma | mb
        r = self.uf.find(a)
        if t is not None:
            t.save_key(self._members, r)
            t.save_key(self._frozen, ra)
            t.save_key(self._frozen, rb)
            t.save_key(self._frozen, r)
        self._members[r] = merged
        # freeze caches: new sorted array per touched cluster, stale
        # root entries retargeted (fresh array, never in-place — the
        # previous array may be shared with a published snapshot)
        self._frozen.pop(ra, None)
        self._frozen.pop(rb, None)
        self._frozen[r] = np.asarray(sorted(merged), dtype=np.int64)
        for e in merged:
            if self._root_cache.get(e) != r:
                if t is not None:
                    t.save_key(self._root_cache, e)
                self._root_cache[e] = r

    def snapshot(self) -> ResolveSnapshot:
        """The current read buffer: the fixpoint of the last committed
        ingest, frozen.

        Lock-free (a single attribute read) and safe from any thread at
        any time — including while an ingest is in flight, which it
        never waits on.  Successive calls between two commits return
        the identical object; a polling reader re-calls to step to the
        next committed fixpoint."""
        return self._published

    def resolve(self, entity_id: int) -> np.ndarray:
        """Cluster of ``entity_id`` under the last committed fixpoint.

        Lock-free: resolves against the published snapshot, so latency
        is independent of any in-flight ingest.  Safe from any thread.
        Unknown ids resolve to singletons."""
        t0 = time.perf_counter()
        out = self._published.resolve(int(entity_id))
        _observe_resolve(t0, 1)
        return out

    def resolve_many(self, entity_ids) -> list[np.ndarray]:
        """Batched resolve against one consistent committed fixpoint.

        The whole batch is answered from a single published snapshot
        (lock-free — no reader ever waits on an ingest), at O(1) dict
        lookups per query.  Each call lands one sample in the
        ``resolve.latency_ms`` histogram — pure read-path latency now
        that there is no lock wait to include."""
        t0 = time.perf_counter()
        snap = self._published
        out = [snap.resolve(int(e)) for e in entity_ids]
        _observe_resolve(t0, len(out))
        return out

    def clusters(self) -> list[np.ndarray]:
        """Non-singleton clusters of the last committed fixpoint
        (lock-free, reads the published snapshot)."""
        return self._published.clusters()
