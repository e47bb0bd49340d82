"""Black-box matcher abstractions (paper §3) + well-behavedness checks.

Type-I  (Def. 1): E(entities, V+, V-) -> matches, with idempotence
(Def. 2) and monotonicity (Def. 3) making it "well-behaved" (Def. 4).
Type-II (Def. 5): additionally exposes P_E; supermodular Type-II
matchers (Def. 6) are monotone Type-I (Prop. 2).

Concretely a matcher here operates on a padded :class:`NeighborhoodBatch`
with evidence masks over the pair axis, and returns a match mask.  The
checkers below verify the axioms *pointwise on given instances*; the
hypothesis property tests drive them across random instances.
"""

from __future__ import annotations

from typing import Protocol, runtime_checkable

import numpy as np

from repro_torch.core.types import NeighborhoodBatch


@runtime_checkable
class TypeIMatcher(Protocol):
    def run(
        self,
        batch: NeighborhoodBatch,
        ev_pos: np.ndarray | None = None,
        ev_neg: np.ndarray | None = None,
    ) -> np.ndarray: ...


@runtime_checkable
class TypeIIMatcher(TypeIMatcher, Protocol):
    def score(self, batch: NeighborhoodBatch, x: np.ndarray) -> np.ndarray: ...

    def run_with_messages(
        self,
        batch: NeighborhoodBatch,
        ev_pos: np.ndarray | None = None,
        ev_neg: np.ndarray | None = None,
    ) -> tuple[np.ndarray, np.ndarray]: ...


# ---------------------------------------------------------------------------
# Axiom checkers (Def. 2/3/6) — return (ok, detail)
# ---------------------------------------------------------------------------


def check_idempotence(matcher: TypeIMatcher, batch, ev_pos=None, ev_neg=None):
    out = matcher.run(batch, ev_pos, ev_neg)
    out2 = matcher.run(batch, out, ev_neg)
    ok = bool(np.array_equal(out, out2))
    return ok, {"first": out, "second": out2}

def check_monotone_evidence(matcher: TypeIMatcher, batch, ev_pos, ev_pos_bigger):
    """Def. 3 (ii): V+ grows => output grows."""
    a = matcher.run(batch, ev_pos, None)
    b = matcher.run(batch, ev_pos_bigger, None)
    ok = bool(np.all(b | ~a))  # a subset of b
    return ok, {"small": a, "big": b}


def check_monotone_negative(matcher: TypeIMatcher, batch, ev_neg, ev_neg_bigger):
    """Def. 3 (iii): V- grows => output shrinks."""
    a = matcher.run(batch, None, ev_neg)
    b = matcher.run(batch, None, ev_neg_bigger)
    ok = bool(np.all(a | ~b))  # b subset of a
    return ok, {"small_neg": a, "big_neg": b}


def check_monotone_entities(matcher: TypeIMatcher, batch_small, batch_big, gid_map):
    """Def. 3 (i): E grows => output grows (compared via global pair gids)."""
    a = matcher.run(batch_small)
    b = matcher.run(batch_big)
    small_gids = set(batch_small.pair_gid[a].tolist()) - {-1}
    big_gids = set(batch_big.pair_gid[b].tolist()) - {-1}
    ok = small_gids <= big_gids
    return ok, {"small": small_gids, "big": big_gids}


def check_supermodular(matcher: TypeIIMatcher, batch, s_mask, t_mask, p_idx):
    """Def. 6 on one instance: S subset T, pair p:
    P(T u p)/P(T) >= P(S u p)/P(S) — in log space, delta(p|T) >= delta(p|S)."""
    assert np.all(t_mask | ~s_mask)
    B = batch.entity_ids.shape[0]
    sp = s_mask.copy()
    tp = t_mask.copy()
    sp[np.arange(B), p_idx] = True
    tp[np.arange(B), p_idx] = True
    ds = matcher.score(batch, sp) - matcher.score(batch, s_mask)
    dt = matcher.score(batch, tp) - matcher.score(batch, t_mask)
    ok = bool(np.all(dt >= ds - 1e-4))
    return ok, {"delta_S": ds, "delta_T": dt}
