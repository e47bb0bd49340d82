"""Host-side global grounding: exact P_E scoring over the full entity set.

MMP step 7 requires checking ``P_E(M+ u M) >= P_E(M+)`` — the paper notes
that while argmax over P_E is expensive, *evaluating* P_E at a given set
is cheap from the model parameters.  This module materializes the global
(sparse) grounded objective once:

    f(S) = sum_{p in S} u_g(p) + sum_{ {p,q} subset S } w_co * link(p, q)

with u_g from the *full* coauthor graph (so u_local <= u_g, consistent
with matcher monotonicity over sub-instances) and one coupling per
unordered linked candidate-pair pair — the paper's §2.1/§2.2 arithmetic.

Also implements the UB scheme of §6.1: for each candidate pair, condition
on the ground truth of all other pairs and take the single-variable MAP.

Two entry points build the grounding:

* :func:`build_global_grounding` — the batch path: one O(sum deg^2)
  pass over every candidate pair.
* :class:`GroundingMaintainer` — the streaming path: holds the same
  state in patchable form and exposes
  ``apply_delta(added_pairs, retracted_pairs, new_edges)``, doing work
  proportional to the delta (the pairs added/retracted plus the pairs
  incident to new relation edges) instead of the corpus.
  ``grounding()`` materializes a :class:`GlobalGrounding` bit-for-bit
  equal to the from-scratch build over the accumulated state — the
  streaming tests assert that equality at every ingest.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.core import pairs as pairlib, txn
from repro_torch.core.mln import MLNWeights
from repro_torch.core.types import MatchStore, Relations
from repro_torch.obs.registry import get_registry


@dataclasses.dataclass
class GlobalGrounding:
    gids: np.ndarray  # (Np,) sorted candidate pair gids
    u: np.ndarray  # (Np,) f32 global unary
    coup_p: np.ndarray  # (Nc,) int32 index into gids
    coup_q: np.ndarray  # (Nc,) int32 index into gids (p < q)
    w_co: float
    # (device, (u, coup_p, coup_q, w_co) on it) for the round-parallel
    # engine's promoter, cached on the grounding object; None on the
    # sequential path.
    _device: tuple | None = dataclasses.field(
        default=None, repr=False, compare=False
    )

    def __getstate__(self):
        # The device cache is a lazy upload keyed on this object's
        # identity — it is neither durable nor picklable (checkpointing
        # serializes the grounding; recovery repopulates on first use).
        state = {
            f.name: getattr(self, f.name) for f in dataclasses.fields(self)
        }
        state["_device"] = None
        return state

    def __setstate__(self, state):
        for k, v in state.items():
            setattr(self, k, v)

    def index_of(self, gids: np.ndarray) -> np.ndarray:
        idx = np.searchsorted(self.gids, gids)
        idx = np.clip(idx, 0, len(self.gids) - 1)
        ok = self.gids[idx] == gids
        return np.where(ok, idx, -1)

    def score(self, store: MatchStore) -> float:
        """f(S) for a global match set."""
        x = np.zeros(len(self.gids), dtype=bool)
        idx = self.index_of(store.gids)
        x[idx[idx >= 0]] = True
        lin = float(self.u[x].sum())
        quad = float(self.w_co * np.sum(x[self.coup_p] & x[self.coup_q]))
        return lin + quad

    def delta(self, base: np.ndarray, add: np.ndarray) -> float:
        """f(base u add) - f(base), with base/add boolean over gids."""
        new = add & ~base
        lin = float(self.u[new].sum())
        both = base | add
        quad_new = (
            np.sum(both[self.coup_p] & both[self.coup_q])
            - np.sum(base[self.coup_p] & base[self.coup_q])
        )
        return lin + float(self.w_co * quad_new)

    def bool_of(self, store: MatchStore) -> np.ndarray:
        x = np.zeros(len(self.gids), dtype=bool)
        idx = self.index_of(store.gids)
        x[idx[idx >= 0]] = True
        return x


def build_global_grounding(
    pair_levels: dict[int, int],
    relations: Relations,
    weights: MLNWeights,
    *,
    boundary_relation: str = "coauthor",
) -> GlobalGrounding:
    gids = np.array(sorted(pair_levels.keys()), dtype=np.int64)
    n = len(gids)
    adj = relations.adjacency_sets(boundary_relation)
    w_sim = np.asarray(weights.w_sim, dtype=np.float32)
    w_co = float(weights.w_co)

    u = np.zeros(n, dtype=np.float32)
    gid_to_idx = {int(g): i for i, g in enumerate(gids)}
    coup: set[tuple[int, int]] = set()

    for i, g in enumerate(gids):
        a, b = pairlib.split_gid(np.int64(g))
        a, b = int(a), int(b)
        na, nb = adj.get(a, set()), adj.get(b, set())
        u[i] = w_sim[pair_levels[int(g)]] + w_co * len(na & nb)
        # couplings: candidate (c, d) with c ~ a, d ~ b (either orientation)
        for c in na:
            for d in nb:
                if c == d:
                    continue
                j = gid_to_idx.get(int(pairlib.make_gid(c, d)))
                if j is not None and j != i:
                    coup.add((min(i, j), max(i, j)))

    if coup:
        cp = np.array(sorted(coup), dtype=np.int64)
        coup_p, coup_q = cp[:, 0].astype(np.int32), cp[:, 1].astype(np.int32)
    else:
        coup_p = np.zeros(0, dtype=np.int32)
        coup_q = np.zeros(0, dtype=np.int32)
    return GlobalGrounding(gids=gids, u=u, coup_p=coup_p, coup_q=coup_q, w_co=w_co)


# ---------------------------------------------------------------------------
# Incremental maintenance (streaming ingest path)
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class GroundingDelta:
    """Work accounting for one ``apply_delta`` call.

    ``pairs_visited`` counts the candidate pairs whose unary or coupling
    structure was (re)computed — the quantity the streaming tests bound
    by the dirty set to prove the ingest path does no O(corpus) rebuild.
    """

    pairs_added: int = 0
    pairs_retracted: int = 0
    pairs_visited: int = 0
    edges_added: int = 0
    couplings_added: int = 0
    couplings_removed: int = 0


class GroundingMaintainer:
    """Patchable global grounding for the streaming ingest path.

    Holds the grounding state in delta-friendly form — per-pair
    similarity level and common-neighbor *count* (kept as an exact int
    so the materialized unary reproduces the from-scratch float32
    arithmetic bit-for-bit), the coauthor adjacency, an entity ->
    candidate-pair index, and the coupling set keyed by gid pairs.

    ``apply_delta`` patches that state in place:

    * retracted pairs drop their unary and incident couplings —
      O(coupling degree) each;
    * new relation edges update the common-neighbor counts and create
      couplings only for pairs incident to an edge endpoint —
      O(local pair count x local degree);
    * added pairs compute their unary and couplings from the current
      adjacency — O(deg(a) x deg(b)) each, exactly the per-pair cost of
      the batch build.

    The grounding *computation* — adjacency intersections and coupling
    discovery, the O(sum deg^2) cost of the batch build — touches only
    the delta.  ``grounding()`` keeps the array form live and *splices*
    it per delta (:meth:`_splice`): only the pending rows are
    recomputed (``last_splice_rows`` counts them, surfaced as
    ``IngestReport.grounding_splice_rows``); untouched unary entries and
    coupling rows carry over as memcpy.  Only the very first call pays
    the full vectorized materialization.

    Caller contract: every ``new_edges`` batch must be the *boundary
    relation's* tuples (the maintainer has no relation labels to filter
    by — feeding it another relation's edges would diverge from the
    batch build, which grounds only the boundary relation).
    """

    def __init__(self, weights: MLNWeights):
        self.w_sim = np.asarray(weights.w_sim, dtype=np.float32)
        self.w_co = float(weights.w_co)
        self.levels: dict[int, int] = {}  # gid -> similarity level
        self.common: dict[int, int] = {}  # gid -> |adj(a) & adj(b)|
        self.adj: dict[int, set[int]] = {}  # entity -> coauthor neighbors
        self.pairs_of: dict[int, set[int]] = {}  # entity -> candidate gids
        self.coup: set[tuple[int, int]] = set()  # (min gid, max gid)
        self.coup_adj: dict[int, set[int]] = {}  # gid -> coupled gids
        self.total_pair_visits = 0
        self._gg: GlobalGrounding | None = None
        # pending array-splice deltas accumulated since the last
        # grounding() materialization (see _record_* helpers)
        self._pend_add: set[int] = set()
        self._pend_del: set[int] = set()
        self._pend_u: set[int] = set()
        self._pend_cadd: set[tuple[int, int]] = set()
        self._pend_cdel: set[tuple[int, int]] = set()
        self.last_splice_rows = 0
        self.total_splice_rows = 0

    # -- pending-delta bookkeeping (drives the array splice) --------------

    @staticmethod
    def _sadd(s: set, item) -> None:
        t = txn.active()
        if t is not None:
            t.set_add(s, item)
        else:
            s.add(item)

    @staticmethod
    def _sdiscard(s: set, item) -> None:
        t = txn.active()
        if t is not None:
            t.set_discard(s, item)
        else:
            s.discard(item)

    def _record_pair_added(self, g: int) -> None:
        if g in self._pend_del:
            # the live arrays still hold g: a delete+add cancels to a
            # unary patch (the common-neighbor count may have moved)
            self._sdiscard(self._pend_del, g)
            self._sadd(self._pend_u, g)
        else:
            self._sadd(self._pend_add, g)

    def _record_pair_retracted(self, g: int) -> None:
        if g in self._pend_add:
            self._sdiscard(self._pend_add, g)
        else:
            self._sadd(self._pend_del, g)
        self._sdiscard(self._pend_u, g)

    def _record_unary_changed(self, g: int) -> None:
        if g not in self._pend_add:
            self._sadd(self._pend_u, g)

    def _record_coupling_added(self, key: tuple[int, int]) -> None:
        if key in self._pend_cdel:
            self._sdiscard(self._pend_cdel, key)
        else:
            self._sadd(self._pend_cadd, key)

    def _record_coupling_removed(self, key: tuple[int, int]) -> None:
        if key in self._pend_cadd:
            self._sdiscard(self._pend_cadd, key)
        else:
            self._sadd(self._pend_cdel, key)

    def __len__(self) -> int:
        return len(self.levels)

    @staticmethod
    def _gid(a: int, b: int) -> int:
        lo, hi = (a, b) if a < b else (b, a)
        return lo * int(pairlib.GID_STRIDE) + hi

    def _couple(self, g1: int, g2: int) -> int:
        key = (g1, g2) if g1 < g2 else (g2, g1)
        if key in self.coup:
            return 0
        t = txn.active()
        if t is not None:
            t.set_add(self.coup, key)
            t.save_key(self.coup_adj, g1, copy=set)
            t.save_key(self.coup_adj, g2, copy=set)
        else:
            self.coup.add(key)
        self.coup_adj.setdefault(g1, set()).add(g2)
        self.coup_adj.setdefault(g2, set()).add(g1)
        self._record_coupling_added(key)
        return 1

    # -- the delta API ----------------------------------------------------

    def apply_delta(
        self,
        added_pairs: dict[int, int],
        retracted_pairs,
        new_edges: np.ndarray | None = None,
    ) -> GroundingDelta:
        """Patch the grounding: pair additions/retractions + new edges.

        ``added_pairs`` maps gid -> similarity level (levels are
        name-static, so a gid's level never changes between covers);
        ``retracted_pairs`` are gids that left the candidate set (canopy
        re-splits); ``new_edges`` are this ingest's relation tuples.
        Duplicate edges are ignored (set semantics, as in
        ``Relations.adjacency_sets``); self-loops are skipped
        defensively but must be rejected upstream (``DeltaCover.ingest``
        does) — the batch build counts i in adj(i) for a self-loop, so
        accepting one here would break bit-for-bit equality.
        """
        stats = GroundingDelta()
        visited: set[int] = set()
        t = txn.active()
        if t is not None:
            t.save_attr(self, "total_pair_visits")

        # 1. retractions: drop unary + incident couplings.
        for g in retracted_pairs or ():
            g = int(g)
            if g not in self.levels:
                continue
            if t is not None:
                t.save_key(self.levels, g)
                t.save_key(self.common, g)
            del self.levels[g]
            del self.common[g]
            a, b = (int(x) for x in pairlib.split_gid(np.int64(g)))
            if t is not None:
                t.save_key(self.pairs_of, a, copy=set)
                t.save_key(self.pairs_of, b, copy=set)
            self.pairs_of.get(a, set()).discard(g)
            self.pairs_of.get(b, set()).discard(g)
            if t is not None:
                t.save_key(self.coup_adj, g)
            for g2 in self.coup_adj.pop(g, set()):
                if t is not None:
                    t.save_key(self.coup_adj, g2, copy=set)
                self.coup_adj[g2].discard(g)
                key = (g, g2) if g < g2 else (g2, g)
                self._sdiscard(self.coup, key)
                self._record_coupling_removed(key)
                stats.couplings_removed += 1
            self._record_pair_retracted(g)
            visited.add(g)
            stats.pairs_retracted += 1

        # 2. new relation edges: the only pairs whose common-neighbor
        # count or couplings can change have an endpoint on the edge.
        if new_edges is not None and len(new_edges):
            for x, y in np.asarray(new_edges, dtype=np.int64):
                x, y = int(x), int(y)
                if x == y or y in self.adj.get(x, ()):
                    continue  # self-loop / duplicate: no pairwise evidence
                if t is not None:
                    t.save_key(self.adj, x, copy=set)
                    t.save_key(self.adj, y, copy=set)
                self.adj.setdefault(x, set()).add(y)
                self.adj.setdefault(y, set()).add(x)
                stats.edges_added += 1
                for u, v in ((x, y), (y, x)):
                    for g in self.pairs_of.get(u, ()):
                        a, b = (int(t) for t in pairlib.split_gid(np.int64(g)))
                        z = b if a == u else a
                        visited.add(g)
                        nz = self.adj.get(z, set())
                        if v in nz:  # v is a new common neighbor of (u, z)
                            if t is not None:
                                t.save_key(self.common, g)
                            self.common[g] += 1
                            self._record_unary_changed(g)
                        # new couplings through the (u, v) adjacency link:
                        # partner pairs (v, d) with d adjacent to z.
                        for d in nz:
                            if d == v:
                                continue
                            g2 = self._gid(v, d)
                            if g2 != g and g2 in self.levels:
                                stats.couplings_added += self._couple(g, g2)

        # 3. new pairs: unary + couplings from the current adjacency.
        # Coupling discovery is symmetric (c ~ a and d ~ b iff a ~ c and
        # b ~ d), so pairs added later in this loop find their couplings
        # to pairs added earlier — no second pass needed.
        for g, lev in added_pairs.items():
            g = int(g)
            if g in self.levels:
                continue
            a, b = (int(x) for x in pairlib.split_gid(np.int64(g)))
            na = self.adj.get(a, set())
            nb = self.adj.get(b, set())
            if t is not None:
                t.save_key(self.levels, g)
                t.save_key(self.common, g)
                t.save_key(self.pairs_of, a, copy=set)
                t.save_key(self.pairs_of, b, copy=set)
            self.levels[g] = int(lev)
            self.common[g] = len(na & nb)
            self.pairs_of.setdefault(a, set()).add(g)
            self.pairs_of.setdefault(b, set()).add(g)
            self._record_pair_added(g)
            visited.add(g)
            stats.pairs_added += 1
            for c in na:
                for d in nb:
                    if c == d:
                        continue
                    g2 = self._gid(c, d)
                    if g2 != g and g2 in self.levels:
                        stats.couplings_added += self._couple(g, g2)

        stats.pairs_visited = len(visited)
        self.total_pair_visits += stats.pairs_visited
        get_registry().counter("grounding.pair_visits").inc(stats.pairs_visited)
        return stats

    # -- materialization --------------------------------------------------

    def _unary_of(self, gids: np.ndarray) -> np.ndarray:
        """float32 unaries for ``gids``, with exactly the rounding of the
        scalar batch build: f32(w_sim[lev]) + f32(w_co * common)."""
        lv = np.fromiter((self.levels[int(g)] for g in gids), dtype=np.int64,
                         count=len(gids))
        cn = np.fromiter((self.common[int(g)] for g in gids), dtype=np.float64,
                         count=len(gids))
        return self.w_sim[lv] + (self.w_co * cn).astype(np.float32)

    def _build_full(self) -> GlobalGrounding:
        n = len(self.levels)
        # One aligned pass over the dicts, then argsort — no per-element
        # Python boxing or comparison sorts.
        ks = np.fromiter(self.levels.keys(), dtype=np.int64, count=n)
        lv = np.fromiter(self.levels.values(), dtype=np.int64, count=n)
        cn = np.fromiter(
            (self.common[g] for g in self.levels), dtype=np.float64, count=n
        )
        order = np.argsort(ks)
        gids = ks[order]
        # Scalar build computes  f32(w_sim[lev]) + f32(w_co * count)
        # under NEP-50 weak promotion; replicate the rounding exactly.
        u = self.w_sim[lv[order]] + (self.w_co * cn[order]).astype(np.float32)
        if self.coup:
            cp = np.fromiter(
                (g for pair in self.coup for g in pair),
                dtype=np.int64,
                count=2 * len(self.coup),
            ).reshape(-1, 2)
            pi = np.searchsorted(gids, cp[:, 0]).astype(np.int32)
            qi = np.searchsorted(gids, cp[:, 1]).astype(np.int32)
            row_order = np.lexsort((qi, pi))  # build emits sorted (p, q)
            coup_p, coup_q = pi[row_order], qi[row_order]
        else:
            coup_p = np.zeros(0, dtype=np.int32)
            coup_q = np.zeros(0, dtype=np.int32)
        return GlobalGrounding(
            gids=gids, u=u.astype(np.float32), coup_p=coup_p, coup_q=coup_q,
            w_co=self.w_co,
        )

    def _splice(self, gg: GlobalGrounding) -> GlobalGrounding:
        """Patch the live arrays with the pending delta.

        Only the delta's rows are recomputed (``last_splice_rows`` counts
        them); untouched unary entries and coupling rows are carried over
        as memcpy, so per-ingest materialization cost no longer includes
        the O(P) per-pair host pass of the full build.  Coupling rows are
        kept sorted by (gid_p, gid_q), which equals the full build's
        (index_p, index_q) lexsort because gid order and index order
        coincide.
        """
        gids, u = gg.gids, gg.u
        coup_p = gg.coup_p.astype(np.int64)
        coup_q = gg.coup_q.astype(np.int64)

        def _keys(p_idx, q_idx, n):
            return p_idx * np.int64(n) + q_idx

        # 1. coupling deletions, located in the old index space.
        if self._pend_cdel:
            cd = np.asarray(sorted(self._pend_cdel), dtype=np.int64)
            pi = np.searchsorted(gids, cd[:, 0])
            qi = np.searchsorted(gids, cd[:, 1])
            pos = np.searchsorted(
                _keys(coup_p, coup_q, len(gids)), _keys(pi, qi, len(gids))
            )
            coup_p = np.delete(coup_p, pos)
            coup_q = np.delete(coup_q, pos)

        # 2. gid deletions: remove rows, shift surviving indices down.
        if self._pend_del:
            dl = np.asarray(sorted(self._pend_del), dtype=np.int64)
            pos = np.searchsorted(gids, dl)
            gids = np.delete(gids, pos)
            u = np.delete(u, pos)
            if len(coup_p):
                coup_p -= np.searchsorted(pos, coup_p, side="right")
                coup_q -= np.searchsorted(pos, coup_q, side="right")

        # 3. gid insertions: shift indices up, insert rows in gid order.
        if self._pend_add:
            av = np.asarray(sorted(self._pend_add), dtype=np.int64)
            if len(coup_p):
                coup_p += np.searchsorted(av, gids[coup_p])
                coup_q += np.searchsorted(av, gids[coup_q])
            pos = np.searchsorted(gids, av)
            gids = np.insert(gids, pos, av)
            u = np.insert(u, pos, self._unary_of(av))

        # 4. unary patches for pairs whose common-neighbor count moved.
        if self._pend_u:
            uv = np.asarray(sorted(self._pend_u), dtype=np.int64)
            pos = np.searchsorted(gids, uv)
            if u is gg.u:
                u = u.copy()  # never mutate a previously returned grounding
            u[pos] = self._unary_of(uv)

        # 5. coupling insertions in the new index space.
        if self._pend_cadd:
            ca = np.asarray(sorted(self._pend_cadd), dtype=np.int64)
            pi = np.searchsorted(gids, ca[:, 0])
            qi = np.searchsorted(gids, ca[:, 1])
            pos = np.searchsorted(
                _keys(coup_p, coup_q, len(gids)), _keys(pi, qi, len(gids))
            )
            coup_p = np.insert(coup_p, pos, pi)
            coup_q = np.insert(coup_q, pos, qi)

        self.last_splice_rows = (
            len(self._pend_add) + len(self._pend_del) + len(self._pend_u)
            + len(self._pend_cadd) + len(self._pend_cdel)
        )
        return GlobalGrounding(
            gids=gids,
            u=u,
            coup_p=coup_p.astype(np.int32),
            coup_q=coup_q.astype(np.int32),
            w_co=self.w_co,
        )

    def grounding(self) -> GlobalGrounding:
        """The array-form grounding, spliced in place per delta.

        Bit-for-bit equal to ``build_global_grounding`` over the same
        accumulated pairs/edges: the unary is recomputed from the exact
        integer common-neighbor count with the same float32 rounding as
        the scalar batch loop.  The first call materializes the arrays
        from scratch; every later call splices only the rows the pending
        deltas touched (``last_splice_rows``/``total_splice_rows`` count
        them — the array-form analogue of ``GroundingDelta.
        pairs_visited``).
        """
        t = txn.active()
        if t is not None:
            for a in ("_gg", "last_splice_rows", "total_splice_rows"):
                t.save_attr(self, a)
        pending = (
            self._pend_add or self._pend_del or self._pend_u
            or self._pend_cadd or self._pend_cdel
        )
        if self._gg is not None and not pending:
            self.last_splice_rows = 0
            return self._gg
        if self._gg is None:
            self._gg = self._build_full()
            self.last_splice_rows = len(self._gg.gids) + len(self._gg.coup_p)
        else:
            self._gg = self._splice(self._gg)
        self.total_splice_rows += self.last_splice_rows
        get_registry().counter("grounding.splice_rows").inc(self.last_splice_rows)
        # rebind (not clear()) so a journaled pre-ingest reference keeps
        # its contents for rollback
        if t is not None:
            for a in ("_pend_add", "_pend_del", "_pend_u",
                      "_pend_cadd", "_pend_cdel"):
                t.save_attr(self, a)
        self._pend_add = set()
        self._pend_del = set()
        self._pend_u = set()
        self._pend_cadd = set()
        self._pend_cdel = set()
        return self._gg


def ub_matches(gg: GlobalGrounding, truth_gids: np.ndarray) -> MatchStore:
    """§6.1 UB: decide each pair with ground truth of all others as evidence.

    Single-variable conditional MAP: include p iff
    ``u(p) + w_co * |linked true pairs| >= 0`` (ties keep the pair: the
    Type-II output prefers larger sets).  Supermodularity makes the result
    a superset of the full-run matches (upper bound on recall).
    """
    t = np.zeros(len(gg.gids), dtype=bool)
    idx = gg.index_of(np.asarray(sorted(set(int(g) for g in truth_gids)), dtype=np.int64))
    t[idx[idx >= 0]] = True

    boost = np.zeros(len(gg.gids), dtype=np.float32)
    # coupling contributions from ground-truth-true partners
    np.add.at(boost, gg.coup_p, gg.w_co * t[gg.coup_q])
    np.add.at(boost, gg.coup_q, gg.w_co * t[gg.coup_p])
    keep = (gg.u + boost) >= -1e-6
    return MatchStore(gg.gids[keep])
