"""Sequential message-passing drivers: NO-MP, SMP (Alg. 1), MMP (Alg. 3).

These are the paper's algorithms verbatim: a host-side worklist of
active neighborhoods, the (batched, PyTorch) matcher as the black box,
and host-side message bookkeeping.  The round-parallel engine
(``core/parallel.py``) evaluates whole bins per round instead; Theorems
2/4 (consistency) guarantee both produce the same fixpoint.
"""

from __future__ import annotations

import dataclasses
import time
from collections import deque

import numpy as np

from repro_torch.core import txn
from repro_torch.core.cover import PackedCover
from repro_torch.core.global_grounding import GlobalGrounding
from repro_torch.core.matcher import TypeIIMatcher, TypeIMatcher
from repro_torch.core.types import MatchStore


@dataclasses.dataclass
class EMResult:
    matches: MatchStore
    neighborhood_evals: int
    rounds: int
    messages_emitted: int
    messages_promoted: int
    wall_time_s: float
    history: list[int] = dataclasses.field(default_factory=list)
    # Host->device jitted dispatches issued by the round engine — the
    # quantity the device-resident driver collapses from O(bins x rounds)
    # to O(bins + quiescence points).  Sequential drivers count one
    # dispatch per neighborhood evaluation.
    dispatches: int = 0
    # Host-visible full rounds of the fused engine (the quiescence
    # points): every other round ran inside a fused greedy segment.
    full_rounds: int = 0
    # Serving-memory accounting of the bounded GroundingCache (parallel
    # engine): high-water mark of array-resident bins, LRU evictions and
    # cold re-grounds issued during this run.  Zero everywhere for the
    # sequential drivers and for unbounded caches that never evict.
    peak_resident_bins: int = 0
    cache_evictions: int = 0
    cold_regrounds: int = 0
    # Step-7 promotion passes that fell back to the host coupling-COO
    # walk (driver._promote).  The fused engine promotes on device
    # (parallel.DevicePromoter) and keeps this at 0 — gated in CI; the
    # legacy fused=False loop and the sequential run_mmp count every
    # pass here by design (they ARE the host baseline).
    promote_host_scans: int = 0


# EMResult fields published as monotone ``em.*`` counters; the remaining
# fields are a high-water gauge (peak_resident_bins) and a latency
# histogram (wall_time_s -> em.wall_ms).
_EM_COUNTER_FIELDS = (
    "neighborhood_evals",
    "rounds",
    "full_rounds",
    "dispatches",
    "messages_emitted",
    "messages_promoted",
    "cache_evictions",
    "cold_regrounds",
    "promote_host_scans",
)


def publish_em_result(res: EMResult) -> EMResult:
    """Publish an :class:`EMResult` into the runtime metrics registry.

    The dataclass stays the per-call API; the registry (``em.*`` family)
    is the cumulative, process-wide view the benchmarks snapshot.  Every
    driver (sequential and parallel) routes its result through here, so
    ``em.runs`` counts engine invocations regardless of scheme.
    """
    from repro_torch.obs import get_registry

    reg = get_registry()
    reg.counter("em.runs").inc()
    for name in _EM_COUNTER_FIELDS:
        v = int(getattr(res, name))
        if v:
            reg.counter(f"em.{name}").inc(v)
    reg.gauge("em.peak_resident_bins").max(res.peak_resident_bins)
    reg.gauge("em.matches").max(len(res.matches.gids))
    reg.histogram("em.wall_ms").observe(res.wall_time_s * 1e3)
    return res


def _eval_neighborhood(matcher, packed, n, m_plus, with_messages):
    """Run the matcher on neighborhood n with current evidence projected in."""
    k = int(packed.neighborhood_bin[n])
    row = int(packed.neighborhood_row[n])
    nb = packed.bins[k].row(row)
    ev_pos = m_plus.mask_of(nb.pair_gid)
    if with_messages:
        x, lab = matcher.run_with_messages(nb, ev_pos, None)
        return nb, x[0], lab[0]
    x = matcher.run(nb, ev_pos, None)
    return nb, x[0], None


def _new_gids(nb_row_gid, x, m_plus):
    gids = nb_row_gid[x & (nb_row_gid >= 0)]
    fresh = gids[~np.isin(gids, m_plus.gids)]
    return np.unique(fresh)


def run_nomp(packed: PackedCover, matcher: TypeIMatcher) -> EMResult:
    """Each neighborhood evaluated once, no messages (baseline NO-MP)."""
    t0 = time.perf_counter()
    m_plus = MatchStore()
    evals = 0
    for n in range(packed.num_neighborhoods):
        nb, x, _ = _eval_neighborhood(matcher, packed, n, MatchStore(), False)
        m_plus = m_plus.union(_new_gids(nb.pair_gid[0], x, m_plus))
        evals += 1
    return publish_em_result(
        EMResult(m_plus, evals, 1, 0, 0, time.perf_counter() - t0,
                 dispatches=evals)
    )


def run_smp(
    packed: PackedCover,
    matcher: TypeIMatcher,
    order: list[int] | None = None,
    max_evals: int | None = None,
    *,
    init_matches: MatchStore | None = None,
) -> EMResult:
    """Algorithm 1 (SMP).

    ``order`` doubles as a *partial* worklist hook for the streaming
    engine: with ``init_matches`` set to a previous fixpoint and
    ``order`` to the dirty neighborhoods only, the run continues the
    monotone closure from that state — re-activation through
    ``neighborhoods_of_pairs`` pulls in any neighborhood that new
    evidence touches, so the fixpoint equals a full run (Thm. 2).
    """
    t0 = time.perf_counter()
    n_nb = packed.num_neighborhoods
    seeds = list(order if order is not None else range(n_nb))
    worklist = deque(seeds)
    in_list = [False] * n_nb
    for n in seeds:
        in_list[n] = True
    m_plus = init_matches if init_matches is not None else MatchStore()
    evals = 0
    cap = max_evals or n_nb * 64
    while worklist and evals < cap:
        n = worklist.popleft()
        in_list[n] = False
        nb, x, _ = _eval_neighborhood(matcher, packed, n, m_plus, False)
        new = _new_gids(nb.pair_gid[0], x, m_plus)
        evals += 1
        if len(new):
            m_plus = m_plus.union(new)
            for m in packed.neighborhoods_of_pairs(new):
                if m != n and not in_list[m]:
                    worklist.append(m)
                    in_list[m] = True
    return publish_em_result(
        EMResult(m_plus, evals, 1, 0, 0, time.perf_counter() - t0,
                 dispatches=evals)
    )


# ---------------------------------------------------------------------------
# MMP (Alg. 3) with host-side T* merging (Prop. 3) and step-7 promotion
# ---------------------------------------------------------------------------


class MessagePool:
    """Disjoint maximal messages over global pair gids (the set T)."""

    def __init__(self):
        self.parent: dict[int, int] = {}  # union-find over gids
        # groups() memo: _promote replays the partition once per
        # promotion sweep of every round — rebuilding it from the
        # union-find each time was O(|T|) per pass.  Any mutation
        # (add_message / discard) invalidates.
        self._groups: list[np.ndarray] | None = None

    def _find(self, g: int) -> int:
        # entry writes (inserts and path compressions alike) are
        # journaled into the active ingest transaction, mirroring
        # closure.UnionFind — see its docstring for why compressions
        # must be journaled too
        t = txn.active()
        if t is not None and g not in self.parent:
            t.save_key(self.parent, g)
        p = self.parent.setdefault(g, g)
        while p != self.parent[p]:
            if t is not None:
                t.save_key(self.parent, p)
            self.parent[p] = self.parent[self.parent[p]]
            p = self.parent[p]
        if t is not None:
            t.save_key(self.parent, g)
        self.parent[g] = p
        return p

    def add_message(self, gids: list[int]) -> None:
        """T <- (T u {M})* : union-find merge implements Prop. 3."""
        if len(gids) < 2:
            return
        t = txn.active()
        if t is not None:
            t.save_attr(self, "_groups")
        self._groups = None
        r0 = self._find(gids[0])
        for g in gids[1:]:
            r = self._find(g)
            if r != r0:
                if t is not None:
                    t.save_key(self.parent, r)
                self.parent[r] = r0

    def groups(self) -> list[np.ndarray]:
        """Current disjoint groups (memoized; callers must not mutate)."""
        if self._groups is None:
            by_root: dict[int, list[int]] = {}
            for g in list(self.parent.keys()):
                by_root.setdefault(self._find(g), []).append(g)
            self._groups = [
                np.asarray(sorted(v), dtype=np.int64)
                for v in by_root.values()
                if len(v) >= 2
            ]
        return self._groups

    def discard(self, gids) -> None:
        """Remove gids from the pool, keeping the remaining group structure.

        The streaming engine calls this when a cover delta retracts
        candidate pairs: step-7 promotion already filters retracted gids
        against the current grounding, but pruning them here patches the
        pool in place so groups that shrink below two members stop being
        replayed at every subsequent promotion pass.
        """
        drop = {int(g) for g in gids}
        if not drop or not (drop & self.parent.keys()):
            return
        groups = self.groups()
        t = txn.active()
        if t is not None:
            # the rebuild rebinds ``parent`` wholesale; journaling the
            # old dict ref is enough — subsequent writes hit the new one
            t.save_attr(self, "parent")
            t.save_attr(self, "_groups")
        self.parent = {}
        self._groups = None
        for grp in groups:
            self.add_message([int(g) for g in grp if int(g) not in drop])


def _labels_to_messages(
    nb_gid: np.ndarray,
    lab: np.ndarray,
    m_plus,
    row_mask: np.ndarray | None = None,
) -> list[list[int]]:
    """Component labels -> groups of >= 2 unmatched global pairs.

    Batched: ``nb_gid``/``lab`` may be ``(P,)`` (one neighborhood, the
    sequential driver) or ``(B, P)`` (a whole round's bin, the parallel
    driver).  The per-slot Python walk is replaced by numpy segment ops
    keyed on ``(row, label)``; ``row_mask`` restricts extraction to the
    rows the round actually evaluated.
    """
    nb_gid = np.atleast_2d(np.asarray(nb_gid))
    lab = np.atleast_2d(np.asarray(lab))
    B, P = lab.shape
    ok = (lab < P) & (nb_gid >= 0)
    if row_mask is not None:
        ok &= np.atleast_1d(row_mask)[:, None]
    if not ok.any():
        return []
    rows, _ = np.nonzero(ok)
    gids = nb_gid[ok]
    labs = lab[ok].astype(np.int64)
    unmatched = ~np.isin(gids, m_plus.gids)
    if not unmatched.any():
        return []
    key = rows[unmatched] * np.int64(P) + labs[unmatched]
    gids = gids[unmatched]
    order = np.argsort(key, kind="stable")
    key, gids = key[order], gids[order]
    _, starts, counts = np.unique(key, return_index=True, return_counts=True)
    return [
        gids[s : s + c].tolist() for s, c in zip(starts, counts) if c >= 2
    ]


def _promote(pool: MessagePool, gg: GlobalGrounding, m_plus: MatchStore):
    """Step 7: promote every message with nonneg global delta; to fixpoint.

    Only the group's gids present in the grounding are promoted: in a
    batch run that is the whole group, but the streaming engine replays
    a *persistent* pool against a grounding whose candidate set may have
    retracted some gids (canopy re-splits) — those must not leak back
    into the match store.
    """
    promoted = 0
    new_all: list[np.ndarray] = []
    base = gg.bool_of(m_plus)
    changed = True
    while changed:
        changed = False
        for grp in pool.groups():
            idx = gg.index_of(grp)
            grp = grp[idx >= 0]
            idx = idx[idx >= 0]
            if len(grp) < 2:
                continue
            add = np.zeros_like(base)
            add[idx] = True
            if not np.any(add & ~base):
                continue
            if gg.delta(base, add) >= -1e-6:
                base = base | add
                new_all.append(grp)
                promoted += 1
                changed = True
    if new_all:
        m_plus = m_plus.union(np.concatenate(new_all))
    return m_plus, promoted


def run_mmp(
    packed: PackedCover,
    matcher: TypeIIMatcher,
    gg: GlobalGrounding,
    order: list[int] | None = None,
    max_evals: int | None = None,
    *,
    init_matches: MatchStore | None = None,
    pool: MessagePool | None = None,
) -> EMResult:
    """Algorithm 3 (MMP).

    ``order``/``init_matches``/``pool`` are the streaming hooks: the
    incremental engine passes only the dirty neighborhoods plus the
    persistent maximal-message pool — step-7 promotion re-checks every
    stored group against the *current* global grounding, which is how
    the affected slice of the pool gets replayed after a cover delta.
    """
    t0 = time.perf_counter()
    n_nb = packed.num_neighborhoods
    seeds = list(order if order is not None else range(n_nb))
    worklist = deque(seeds)
    in_list = [False] * n_nb
    for n in seeds:
        in_list[n] = True
    m_plus = init_matches if init_matches is not None else MatchStore()
    if pool is None:
        pool = MessagePool()
    evals = 0
    emitted = 0
    promoted_total = 0
    host_scans = 0
    cap = max_evals or n_nb * 64
    while worklist and evals < cap:
        n = worklist.popleft()
        in_list[n] = False
        nb, x, lab = _eval_neighborhood(matcher, packed, n, m_plus, True)
        evals += 1
        new = _new_gids(nb.pair_gid[0], x, m_plus)
        m_plus = m_plus.union(new)
        for msg in _labels_to_messages(nb.pair_gid[0], lab, m_plus):
            pool.add_message(msg)
            emitted += 1
        m_plus2, promoted = _promote(pool, gg, m_plus)
        host_scans += 1
        promoted_total += promoted
        newly = np.concatenate([new, m_plus2.difference(m_plus)]) if promoted else new
        m_plus = m_plus2
        if len(newly):
            for m in packed.neighborhoods_of_pairs(np.unique(newly)):
                if m != n and not in_list[m]:
                    worklist.append(m)
                    in_list[m] = True
    return publish_em_result(EMResult(
        m_plus, evals, 1, emitted, promoted_total, time.perf_counter() - t0,
        dispatches=evals, promote_host_scans=host_scans,
    ))
