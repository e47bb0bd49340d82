"""Optimal 1:1 bipartite assignment matcher (Hungarian + greedy baseline).

The record-linkage scenario the clustering formulation never touches:
two record sources where every source is internally duplicate-free, so
the right output is a *matching* — each record pairs with at most one
partner — not a transitive cluster.  Sides are encoded by global entity
id parity (even = left source, odd = right source), the convention the
``repro_torch.data.synthetic.make_bipartite`` generator emits.

Edge weights combine the cover's similarity level with the coauthor
signal of the paper's R2 rule::

    w(p) = sim_level(p) + beta * n_shared(p)        (admissible if
                                                     w >= tau and the
                                                     endpoints straddle
                                                     the two sources)

The **optimal** variant solves max-weight bipartite matching per
neighborhood (Hungarian / `scipy.optimize.linear_sum_assignment`, with
an exact bitmask-DP fallback when scipy is absent — neighborhood sides
are <= k_max/2); the **greedy** variant picks admissible edges in
descending weight, skipping used endpoints — the classic baseline the
`benchmarks/fig4_matchers.py` crossing traps separate from the optimum.

Well-behavedness (Defs. 2/3) by construction: the assignment ``A`` is
computed *evidence-independently* from the batch, and the output is the
monotone post-filter ``(A | ev_pos) & valid & ~ev_neg`` — idempotent
(a second run over its own output adds nothing) and monotone in both
evidence sets.  What 1:1 competition fundamentally breaks is Def. 3(i)
entity monotonicity — a newly arrived record can *win* a slot an old
match held — so the family registers ``monotone_entities=False`` and
the streaming deployment contract is group-atomic arrival (all records
of a matching group land in one micro-batch; see ``make_bipartite``).

``score`` is modular — the sum of admissible-edge margins ``w - tau``
over the selected valid pairs — hence supermodular (Def. 6) with
equality, making the family Type-II and MMP-eligible (it simply emits
no multi-pair messages: labels are the trivial ``P`` everywhere, so
NO-MP, SMP and MMP fixpoints coincide).

On the device: the grounded structure (similarity levels, validity and
shared-coauthor counts, :func:`repro_torch.core.mln.ground_structure`)
is computed on the matcher's ``device`` and read back once a call; the
combinatorial solve stays on the host.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.core import pairs as pairlib
from repro_torch.core.mln import ground_structure
from repro_torch.core.types import NeighborhoodBatch
from repro_torch.kernels.common import resolve_device


def _solve_optimal(W: np.ndarray) -> list[tuple[int, int]]:
    """Max-weight bipartite matching on ``W >= 0`` (0 = forbidden edge).

    Returns the selected (row, col) pairs with positive weight.  All
    admissible weights are >= tau > 0, so maximizing with forbidden
    edges at weight 0 and dropping zero-weight selections afterwards is
    exactly max-weight matching over admissible edges.
    """
    try:
        from scipy.optimize import linear_sum_assignment
    except ImportError:
        return _solve_dp(W)
    ri, ci = linear_sum_assignment(W, maximize=True)
    return [(int(i), int(j)) for i, j in zip(ri, ci) if W[i, j] > 0.0]


def _solve_dp(W: np.ndarray) -> list[tuple[int, int]]:
    """Exact bitmask-DP fallback (no scipy): O(nl * 2^nr * nr).

    Neighborhood sides are bounded by k_max/2 (<= 16 at the default
    bins), which keeps the right-side mask space tractable.
    """
    nl, nr = W.shape
    flip = nr > nl
    if flip:
        W = W.T
        nl, nr = W.shape
    if nr > 20:  # pragma: no cover - guarded by k_max
        raise ValueError(f"assignment side {nr} too large for DP fallback")
    full = 1 << nr
    NEG = -1.0e18
    dp = np.full(full, NEG, dtype=np.float64)
    dp[0] = 0.0
    choice = np.full((nl, full), -1, dtype=np.int32)
    masks = np.arange(full, dtype=np.int64)
    for i in range(nl):
        ndp = dp.copy()  # default: left i unassigned
        for j in range(nr):
            if W[i, j] <= 0.0:
                continue
            bit = 1 << j
            src = masks[(masks & bit) == 0]
            cand = dp[src] + W[i, j]
            dst = src | bit
            better = cand > ndp[dst] + 1e-12
            ndp[dst[better]] = cand[better]
            choice[i, dst[better]] = j
        dp = ndp
    mask = int(np.argmax(dp))
    out = []
    for i in range(nl - 1, -1, -1):
        j = int(choice[i, mask])
        if j >= 0:
            out.append((j, i) if flip else (i, j))
            mask ^= 1 << j
    return out


def _solve_greedy(
    W: np.ndarray, keys: np.ndarray
) -> list[tuple[int, int]]:
    """Descending-weight greedy matching; ``keys`` breaks ties
    deterministically (ascending)."""
    ri, ci = np.nonzero(W > 0.0)
    order = np.lexsort((keys[ri, ci], -W[ri, ci]))
    used_l: set[int] = set()
    used_r: set[int] = set()
    out = []
    for e in order:
        i, j = int(ri[e]), int(ci[e])
        if i in used_l or j in used_r:
            continue
        used_l.add(i)
        used_r.add(j)
        out.append((i, j))
    return out


class AssignmentMatcher:
    """1:1 bipartite assignment matcher (``optimal=False`` for greedy).

    Host-only: the per-neighborhood combinatorial solve has no device
    grounding, so the family runs through the sequential drivers
    (``run_nomp``/``run_smp``/``run_mmp``); ``run_parallel`` rejects it
    with a TypeError naming the device-capable families.

    ``device=None`` grounds on CUDA (and raises when there is none); pass
    ``device="cpu"`` to ground on the CPU.
    """

    is_probabilistic = True  # Type-II: has score()

    def __init__(self, *, optimal: bool = True, tau: float = 1.0,
                 beta: float = 0.25, device=None):
        self.optimal = optimal
        self.tau = float(tau)
        self.beta = float(beta)
        self.device = resolve_device(device)

    # -- weights ----------------------------------------------------------
    def _weights(self, batch: NeighborhoodBatch):
        """(w, admissible, valid): admissible edges straddle the parity
        sides and clear tau; all evidence-independent."""
        lev, valid, n_shared, _link = ground_structure(batch, self.device)
        # one read-back a call: the three (B, P) structures stacked (the
        # levels and counts are small integers, exact in float32)
        lev, valid, n_shared = torch.stack(
            [lev.float(), valid.float(), n_shared]
        ).cpu().numpy()
        lev = lev.astype(np.int32)
        valid = valid.astype(bool)
        ids = np.asarray(batch.entity_ids)
        k = batch.k
        ii, jj = pairlib.triu_indices(k)
        par = (ids % 2).astype(np.int8)  # 0 = left source, 1 = right
        straddles = par[:, ii] != par[:, jj]
        w = lev.astype(np.float64) + self.beta * n_shared.astype(np.float64)
        admissible = valid & straddles & (w >= self.tau) & (lev >= 1)
        return w, admissible, valid

    def _assignment(self, batch: NeighborhoodBatch) -> np.ndarray:
        """Evidence-independent per-neighborhood matching mask (B, P)."""
        w, admissible, _valid = self._weights(batch)
        ids = np.asarray(batch.entity_ids)
        B, P = w.shape
        ii, jj = pairlib.triu_indices(batch.k)
        base = np.zeros((B, P), dtype=bool)
        for b in range(B):
            ps = np.nonzero(admissible[b])[0]
            if not len(ps):
                continue
            # left slot = the even-id endpoint of each admissible edge
            li = np.where(ids[b, ii[ps]] % 2 == 0, ii[ps], jj[ps])
            rj = np.where(ids[b, ii[ps]] % 2 == 0, jj[ps], ii[ps])
            lslots = sorted(set(int(s) for s in li))
            rslots = sorted(set(int(s) for s in rj))
            lof = {s: x for x, s in enumerate(lslots)}
            rof = {s: x for x, s in enumerate(rslots)}
            W = np.zeros((len(lslots), len(rslots)), dtype=np.float64)
            keys = np.zeros_like(W, dtype=np.int64)
            pmap: dict[tuple[int, int], int] = {}
            for p, ls, rs in zip(ps, li, rj):
                e = (lof[int(ls)], rof[int(rs)])
                W[e] = w[b, p]
                keys[e] = p
                pmap[e] = int(p)
            pairs = (_solve_optimal(W) if self.optimal
                     else _solve_greedy(W, keys))
            for e in pairs:
                base[b, pmap[e]] = True
        return base

    # -- Type-I interface -------------------------------------------------
    def run(
        self,
        batch: NeighborhoodBatch,
        ev_pos: np.ndarray | None = None,
        ev_neg: np.ndarray | None = None,
    ) -> np.ndarray:
        _w, _adm, valid = self._weights(batch)
        x = self._assignment(batch)
        if ev_pos is not None:
            x = x | np.asarray(ev_pos, dtype=bool)
        x = x & valid
        if ev_neg is not None:
            x = x & ~np.asarray(ev_neg, dtype=bool)
        return x

    def run_with_messages(
        self,
        batch: NeighborhoodBatch,
        ev_pos: np.ndarray | None = None,
        ev_neg: np.ndarray | None = None,
    ) -> tuple[np.ndarray, np.ndarray]:
        x = self.run(batch, ev_pos, ev_neg)
        B, P = x.shape
        return x, np.full((B, P), P, dtype=np.int32)

    # -- Type-II interface ------------------------------------------------
    def score(self, batch: NeighborhoodBatch, x: np.ndarray) -> np.ndarray:
        """Modular: sum of admissible-edge margins over selected pairs."""
        w, admissible, _valid = self._weights(batch)
        sel = np.asarray(x, dtype=bool) & admissible
        return np.where(sel, w - self.tau, 0.0).sum(axis=1)
