"""The MLN collective entity matcher (paper §2.1, Appendix B) in PyTorch.

The matcher is the paper's Markov-Logic-Network matcher [Singla & Domingos
2006] restricted to the monotone/supermodular rule class of Appendix A
(Prop. 4: a single ``Match`` term in each implicant) — the exact class for
which the paper's soundness theory holds.

Grounding.  For a neighborhood with entity slots ``0..k-1`` and candidate
pairs ``p = (i, j)`` on the upper triangle (``P = k(k-1)/2`` slots), the
rule set (Appendix B)::

    similar(e1,e2,L)  => equals(e1,e2)                      w_sim[L]
    coauthor(e1,c1) & coauthor(e2,c2) & equals(c1,c2)
                      => equals(e1,e2)                      w_co

grounds to a supermodular pseudo-Boolean objective over x in {0,1}^P ::

    f(x) = sum_p u_p x_p  +  1/2 sum_{p != q} C_pq x_p x_q

    u_p  = w_sim[level_p] + w_co * n_shared(p)      (reflexive Match(d,d))
    C_pq = w_co * link(p, q)

where ``n_shared(p)`` counts shared coauthors of the pair and
``link(p, q)`` is 1 iff matching q fires the coauthor rule for p.  All
couplings are nonnegative, hence ``P(S) ~ exp f(S)`` is supermodular
(Def. 6) and the matcher is monotone Type-I (Prop. 2).

MAP inference, batched over the neighborhoods of a bin (B lanes):

  1. *closure*: repeated conditional-delta sweeps ``delta = u + x @ C``
     activating every pair with positive delta (monotone; never
     deactivates) — the ``icm_sweep`` kernel.
  2. *collective promotion*: connected components of the mutual
     entailment graph among still-inactive pairs, greedily *peeled* of
     negative-marginal members, then activated wholesale when the joint
     delta is >= 0 (ties prefer the larger set, per the Type-II output
     definition).
  3. repeat 1+2 to fixpoint.

Every loop is a host loop with one device-to-host read of its change
flag per iteration.  Each lane keeps its own ``active`` flag and is
frozen (``torch.where(active, new, old)``) once it converges while the
other lanes go on, so every lane's result equals a run on that lane
alone; the peel loop also keeps its per-lane iteration bound.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.core import pairs as pairlib
from repro_torch.core.types import NeighborhoodBatch
from repro_torch.kernels.common import resolve_device
from repro_torch.kernels.icm_sweep import ops as icm_ops
from repro_torch.kernels.mln_score import ops as score_ops

NEG = -1.0e9  # unary for invalid / padded pairs
TIE_EPS = 1.0e-5  # "delta >= 0" tolerance (largest-tie preference)


@dataclasses.dataclass(frozen=True)
class MLNWeights:
    """Rule weights. w_sim[0] unused (level 0 = not a candidate)."""

    w_sim: tuple[float, float, float, float]
    w_co: float

    def as_tensors(self, device) -> tuple[torch.Tensor, torch.Tensor]:
        return (
            torch.tensor(self.w_sim, dtype=torch.float32, device=device),
            torch.tensor(self.w_co, dtype=torch.float32, device=device),
        )


# Appendix B, learned with Alchemy on the bibliographic data.
PAPER_LEARNED = MLNWeights(w_sim=(0.0, -2.28, -3.84, 12.75), w_co=2.46)
# §2.1 pedagogical weights (R1 = -5, R2 = +8), used by the Fig. 1/2 tests.
PEDAGOGICAL = MLNWeights(w_sim=(0.0, -5.0, -5.0, -5.0), w_co=8.0)


@dataclasses.dataclass
class Grounding:
    """Dense grounded MLN for a batch of neighborhoods, on one device."""

    u: torch.Tensor  # (B, P) f32, NEG where invalid
    u_raw: torch.Tensor  # (B, P) f32, 0 where invalid (for scoring)
    C: torch.Tensor  # (B, P, P) f32, symmetric, zero diag, >= 0
    valid: torch.Tensor  # (B, P) bool


def ground_structure(batch: NeighborhoodBatch, device):
    """Weight-independent grounded structure of a neighborhood batch.

    Returns (lev, valid, n_shared, link), tensors on ``device``:
      lev      (B, P) int32   similarity level (0 = not a candidate)
      valid    (B, P) bool    candidate-pair validity
      n_shared (B, P) f32     shared-coauthor count (reflexive Match(d,d))
      link     (B, P, P) f32  1 iff matching q fires the coauthor rule
                              for p (zero diagonal, masked to valid pairs)
    """
    device = resolve_device(device)
    k = batch.k
    ii_np, jj_np = pairlib.triu_indices(k)
    P = len(ii_np)
    ii = torch.as_tensor(ii_np, dtype=torch.long, device=device)
    jj = torch.as_tensor(jj_np, dtype=torch.long, device=device)

    co = torch.as_tensor(np.asarray(batch.coauthor), device=device).float()  # (B, k, k)
    # Defensive: no self-coauthorship, no padded-slot edges.
    emask = torch.as_tensor(np.asarray(batch.entity_mask), device=device).float()
    co = co * emask[:, :, None] * emask[:, None, :]
    co = co * (1.0 - torch.eye(k, dtype=torch.float32, device=device))

    lev = torch.as_tensor(np.asarray(batch.sim_level, dtype=np.int32), device=device)
    valid = torch.as_tensor(np.asarray(batch.pair_mask, dtype=bool), device=device) & (lev > 0)

    # Reflexive boost: n_shared[b, p] = |{d : co(i,d) & co(j,d)}| (exact
    # small integers, so the summation order does not matter).
    shared = torch.einsum("bid,bjd->bij", co, co)  # (B, k, k) counts
    n_shared = shared[:, ii, jj]  # (B, P)
    n_shared = torch.where(valid, n_shared, torch.zeros_like(n_shared))

    # Couplings: link(p, q) = (co[ip,iq] & co[jp,jq]) | (co[ip,jq] & co[jp,iq])
    co_i = co[:, ii, :]  # (B, P, k)  coauthor rows of first endpoints
    co_j = co[:, jj, :]  # (B, P, k)  coauthor rows of second endpoints
    co_ii = co_i[:, :, ii]  # (B, P, P): co[i_p, i_q]
    co_jj = co_j[:, :, jj]  # co[j_p, j_q]
    co_ij = co_i[:, :, jj]  # co[i_p, j_q]
    co_ji = co_j[:, :, ii]  # co[j_p, i_q]
    link = torch.clamp(co_ii * co_jj + co_ij * co_ji, 0.0, 1.0)
    vf = valid.float()
    pmask2 = vf[:, :, None] * vf[:, None, :]
    link = link * pmask2 * (1.0 - torch.eye(P, dtype=torch.float32, device=device))
    return lev, valid, n_shared, link


def ground(batch: NeighborhoodBatch, weights: MLNWeights, device=None) -> Grounding:
    """Ground the MLN rules on a padded neighborhood batch."""
    device = resolve_device(device)
    w_sim, w_co = weights.as_tensors(device)
    lev, valid, n_shared, link = ground_structure(batch, device)

    u_raw = w_sim[lev.long()] + w_co * n_shared
    u_raw = torch.where(valid, u_raw, torch.zeros_like(u_raw))
    u = torch.where(valid, u_raw, torch.full_like(u_raw, NEG))
    C = (w_co * link).contiguous()
    return Grounding(u=u.contiguous(), u_raw=u_raw.contiguous(), C=C, valid=valid)


# ---------------------------------------------------------------------------
# Inference primitives, batched over the lanes (neighborhoods) of a bin
# ---------------------------------------------------------------------------


def _any(t: torch.Tensor) -> bool:
    """The loop condition: one device-to-host read."""
    return bool(t.any().item())


def _closure(u, C, ev_pos, ev_neg, valid):
    """Monotone greedy closure from ev_pos; ev_neg frozen off. (B, P) bool."""
    x = ev_pos & valid & ~ev_neg
    active = torch.ones(x.shape[0], dtype=torch.bool, device=x.device)
    while _any(active):
        delta = icm_ops.sweep_batch(u, C, x.float())
        # ">= -TIE_EPS": zero-delta additions keep the score and the
        # Type-II output prefers the larger set among ties.  Sound for
        # supermodular f: marginal(p | x) >= 0 and x subset of the optimum
        # O imply marginal(p | O) >= 0, hence p in O (tie-larger unique O).
        new = (delta >= -TIE_EPS) & valid & ~ev_neg
        x2 = torch.where(active[:, None], x | new | (ev_pos & valid), x)
        active = (x2 != x).any(dim=1)
        x = x2
    return x


# the reference's single-lane ``_closure`` and whole-bin ``closure_batch``
# are one batched function here (a converged lane is frozen)
closure_batch = _closure


def _entailment_matrix(u, C, x, ev_neg, valid):
    """X[b, s, q] = 1 iff q in closure(x_b U {s}), for every seed pair s.

    One batched closure over the seed axis: (P, P) @ (P, P) sweeps.
    """
    B, P = u.shape
    eye = torch.eye(P, dtype=torch.bool, device=u.device)
    seeds = eye[None] & valid[:, None, :] & ~ev_neg[:, None, :] & ~x[:, None, :]
    X0 = seeds | x[:, None, :]
    allowed = valid[:, None, :] & ~ev_neg[:, None, :]
    X = X0
    active = torch.ones(B, dtype=torch.bool, device=u.device)
    while _any(active):
        delta = icm_ops.sweep_batched(u, C, X.float())
        new = (delta >= -TIE_EPS) & allowed
        X2 = torch.where(active[:, None, None], X | new | X0, X)
        active = (X2 != X).flatten(1).any(dim=1)
        X = X2
    return X


def _components(adj, nodes):
    """Min-label propagation. adj (B,P,P) bool symmetric, nodes (B,P) bool.

    Returns labels (B, P) int32: equal labels <=> same component; invalid
    nodes get label P (out of band).
    """
    B, P = nodes.shape
    big = torch.full((), P, dtype=torch.int32, device=nodes.device)
    lab = torch.where(
        nodes, torch.arange(P, dtype=torch.int32, device=nodes.device)[None, :], big
    )
    adj = adj & nodes[:, :, None] & nodes[:, None, :]
    active = torch.ones(B, dtype=torch.bool, device=nodes.device)
    while _any(active):
        nbr = torch.where(adj, lab[:, None, :], big)
        lab2 = torch.minimum(lab, nbr.amin(dim=2))
        lab2 = torch.where(active[:, None], lab2, lab)
        active = (lab2 != lab).any(dim=1)
        lab = lab2
    return lab


def _peel_and_promote(u, C, x, lab, valid, ev_neg):
    """Greedy-peel each component, activate those with joint delta >= 0.

    Group matrix G[b, l, p] = 1 iff lab[b, p] == l (l ranges over pair
    slots; component labels are min member indices so G rows are mostly
    empty).  Peeling: drop members with negative marginal (u + C@(x + s))_p
    until none; then activate components whose joint delta >= -TIE_EPS.
    """
    B, P = u.shape
    dev = u.device
    labels = torch.arange(P, dtype=torch.int32, device=dev)
    undecided = valid & ~x & ~ev_neg
    G = (lab[:, None, :] == labels[None, :, None]) & undecided[:, None, :]  # (B, P_l, P)

    xf = x.float()
    base = u + torch.matmul(C, xf[:, :, None])[:, :, 0]  # marginal from the active set

    # Peeling drops at most one member per group per iteration; component
    # size is bounded by the neighborhood entity count k ~ sqrt(2P).  A
    # lane stops as soon as an iteration drops nothing, or at the bound.
    peel_iters = int(np.ceil(np.sqrt(2 * P))) + 2
    it = torch.zeros(B, dtype=torch.int32, device=dev)
    changed = torch.ones(B, dtype=torch.bool, device=dev)
    inf = torch.full((), float("inf"), dtype=torch.float32, device=dev)
    while True:
        run = changed & (it < peel_iters)
        if not _any(run):
            break
        Gf = G.float()
        # marginal of member p of group l: base_p + (s_l @ C)_p
        marg = base[:, None, :] + torch.matmul(Gf, C)  # (B, P_l, P)
        drop = G & (marg < 0.0)
        # drop only the single worst member per group per iteration
        # (argmin returns the first minimum, as the reference's does)
        worst = torch.where(drop, marg, inf).argmin(dim=2)
        any_drop = drop.any(dim=2)
        onehot = F.one_hot(worst, P).bool()
        G2 = G & ~(onehot & any_drop[:, :, None])
        G = torch.where(run[:, None, None], G2, G)
        it = torch.where(run, it + 1, it)
        changed = torch.where(run, any_drop.any(dim=1), changed)

    Gf = G.float()
    lin = torch.matmul(Gf, base[:, :, None])[:, :, 0]  # (B, P_l)
    quad = 0.5 * (torch.matmul(Gf, C) * Gf).sum(dim=2)
    delta = lin + quad
    size = G.sum(dim=2)
    promote = (delta >= -TIE_EPS) & (size > 0)
    newx = (G & promote[:, :, None]).any(dim=1)
    return x | newx


def _round(u, C, ev_pos, ev_neg, valid, x):
    """One outer round of :func:`_infer`: closure, entailment, promotion."""
    x1 = _closure(u, C, ev_pos | x, ev_neg, valid)
    X = _entailment_matrix(u, C, x1, ev_neg, valid)
    mutual = X & X.transpose(1, 2)
    undecided = valid & ~x1 & ~ev_neg
    lab = _components(mutual, undecided)
    x2 = _peel_and_promote(u, C, x1, lab, valid, ev_neg)
    x3 = _closure(u, C, x2 | ev_pos, ev_neg, valid)
    return x3, lab


def _infer(u, C, ev_pos, ev_neg, valid):
    """Full MAP inference for a batch (the reference's vmapped ``_infer_one``).

    Returns (x, lab):

    x   : (B, P) bool final match set (includes evidence).
    lab : (B, P) int32 entailment-component labels of *undecided* pairs
          (the maximal messages), P where not applicable.

    Each outer round runs only the lanes still changing (the others are
    frozen), so every lane's answer is that of a run on it alone.
    """
    B, P = u.shape
    x = torch.zeros_like(valid)
    lab = torch.full((B, P), P, dtype=torch.int32, device=u.device)
    active = torch.ones(B, dtype=torch.bool, device=u.device)
    while _any(active):
        rows = active.nonzero()[:, 0]
        x3, lab3 = _round(u[rows], C[rows], ev_pos[rows], ev_neg[rows], valid[rows], x[rows])
        active = torch.zeros_like(active)
        active[rows] = (x3 != x[rows]).any(dim=1)
        x = x.index_put((rows,), x3)
        lab = lab.index_put((rows,), lab3)
    return x, lab


# ---------------------------------------------------------------------------
# Public matcher
# ---------------------------------------------------------------------------


class MLNMatcher:
    """Supermodular Type-II matcher over padded neighborhood batches.

    run(batch, ev_pos, ev_neg)          -> match mask (B, P) bool [Type-I out]
    run_with_messages(batch, ...)       -> (match mask, component labels)
    score(batch, x)                     -> unnormalized log P_E (B,)
    closure_only(batch, ev_pos, ev_neg) -> greedy-only variant (ablation /
                                           the iterative matchers of App. A)

    ``device=None`` runs on CUDA (and raises when there is none); pass
    ``device="cpu"`` for the plain versions on the CPU.
    """

    def __init__(
        self, weights: MLNWeights = PAPER_LEARNED, collective: bool = True, device=None
    ):
        self.weights = weights
        self.collective = collective
        self.device = resolve_device(device)

    # -- grounding ---------------------------------------------------------
    def ground(self, batch: NeighborhoodBatch) -> Grounding:
        return ground(batch, self.weights, self.device)

    # -- Type-I interface ---------------------------------------------------
    def run(
        self,
        batch: NeighborhoodBatch,
        ev_pos: np.ndarray | None = None,
        ev_neg: np.ndarray | None = None,
    ) -> np.ndarray:
        x, _ = self.run_with_messages(batch, ev_pos, ev_neg)
        return x

    def run_with_messages(
        self,
        batch: NeighborhoodBatch,
        ev_pos: np.ndarray | None = None,
        ev_neg: np.ndarray | None = None,
    ) -> tuple[np.ndarray, np.ndarray]:
        g = self.ground(batch)
        B, P = g.u.shape
        ev_pos = self._mask(ev_pos, (B, P))
        ev_neg = self._mask(ev_neg, (B, P))
        if self.collective:
            x, lab = _infer(g.u, g.C, ev_pos, ev_neg, g.valid)
        else:
            x = closure_batch(g.u, g.C, ev_pos, ev_neg, g.valid)
            lab = torch.full((B, P), P, dtype=torch.int32)
        return x.cpu().numpy(), lab.cpu().numpy()

    # -- Type-II interface ---------------------------------------------------
    def score(self, batch: NeighborhoodBatch, x: np.ndarray) -> np.ndarray:
        """Unnormalized log P_E(x) per neighborhood (exact, cheap)."""
        g = self.ground(batch)
        X = self._mask(x, g.u.shape).float()[:, None, :]
        return score_ops.score_sets(g.u_raw, g.C, X)[:, 0].cpu().numpy()

    def closure_only(self, batch, ev_pos=None, ev_neg=None) -> np.ndarray:
        g = self.ground(batch)
        B, P = g.u.shape
        ev_pos = self._mask(ev_pos, (B, P))
        ev_neg = self._mask(ev_neg, (B, P))
        return closure_batch(g.u, g.C, ev_pos, ev_neg, g.valid).cpu().numpy()

    def _mask(self, m, shape) -> torch.Tensor:
        if m is None:
            return torch.zeros(shape, dtype=torch.bool, device=self.device)
        return torch.as_tensor(np.asarray(m, dtype=bool), device=self.device)
