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

:func:`build_global_grounding` builds it in one O(sum deg^2) pass over
every candidate pair.  It stays numpy on the host: MMP step 7 walks it
one group at a time.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.core import pairs as pairlib
from repro_torch.core.mln import MLNWeights
from repro_torch.core.types import MatchStore, Relations


@dataclasses.dataclass
class GlobalGrounding:
    gids: np.ndarray  # (Np,) sorted candidate pair gids
    u: np.ndarray  # (Np,) f32 global unary
    coup_p: np.ndarray  # (Nc,) int32 index into gids
    coup_q: np.ndarray  # (Nc,) int32 index into gids (p < q)
    w_co: float
    # Device copies of (u, coup_p, coup_q, w_co) for the round-parallel
    # engine, cached on the grounding object; None on the sequential path.
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
