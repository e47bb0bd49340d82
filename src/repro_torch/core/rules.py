"""The RULES matcher (paper Appendix B/C): declarative collective rules, in PyTorch.

RULES is the paper's second matcher, modeled after the Dedupalog
framework [Arasu-Re-Suciu 2009].  It is a *Type-I* matcher — no
probability distribution — evaluated as a monotone fixpoint of the
Appendix-B rule set::

    1. similar(e1,e2,3)                                  => equals(e1,e2)
    2. similar(e1,e2,2) & one matched coauthor pair      => equals(e1,e2)
    3. similar(e1,e2,1) & two distinct matched co-pairs  => equals(e1,e2)

"Matched coauthor pair" counts both genuinely-matched candidate pairs
(``link @ x``) and shared coauthors ``d`` (the reflexive ``equals(d,d)``,
``n_shared``).  Per Prop. 5 this negation/transitivity-free fragment is
monotone, so SMP over RULES is sound (Thm. 2); the final transitive
closure (Appendix A) is applied by the caller via
:mod:`repro_torch.core.closure` after message passing terminates.

The fixpoint body is ``n = n_shared + link @ x``, the ``icm_sweep``
kernel's mat-vec.  The counts are small integers, exact in float32 in
any summation order, so the masks are bit-identical to the reference's.
The loop is a host loop with one device-to-host read of its change flag
per iteration; a lane that has converged is idempotent, so the batched
loop equals the per-row one.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.mln import ground_structure
from repro_torch.core.types import NeighborhoodBatch
from repro_torch.kernels.common import resolve_device
from repro_torch.kernels.icm_sweep import ops as icm_ops


def _fixpoint(sweep, lev, n_shared, link, ev_pos, ev_neg, valid):
    """The rule fixpoint with ``sweep`` as the matched-pair count."""
    x0 = ev_pos & valid & ~ev_neg
    x = x0
    while True:
        # matched coauthor-pair count per candidate pair
        n = sweep(n_shared, link, x.float())
        fire = (
            (lev == 3)
            | ((lev == 2) & (n >= 1.0 - 1e-6))
            | ((lev == 1) & (n >= 2.0 - 1e-6))
        )
        x2 = (fire & valid & ~ev_neg) | x0 | x
        changed = bool((x2 != x).any().item())
        x = x2
        if not changed:
            return x


def _rules_fixpoint(lev, n_shared, link, ev_pos, ev_neg, valid):
    """Monotone rule fixpoint for one neighborhood. All (P,)-shaped, link (P, P)."""
    return _fixpoint(icm_ops.sweep, lev, n_shared, link, ev_pos, ev_neg, valid)


def rules_fixpoint_batch(lev, n_shared, link, ev_pos, ev_neg, valid):
    """Rule fixpoint for a whole bin: (B, P) masks, link (B, P, P).

    One ``icm_ops.sweep_batch`` launch per iteration, run until every
    neighborhood converges.
    """
    return _fixpoint(icm_ops.sweep_batch, lev, n_shared, link, ev_pos, ev_neg, valid)


class RulesMatcher:
    """Monotone Type-I matcher over padded neighborhood batches.

    Interface mirrors :class:`repro_torch.core.mln.MLNMatcher` minus the
    Type-II ``score``, so MMP refuses it; ``run_with_messages`` exists for
    driver symmetry but emits no maximal messages (labels = P everywhere)
    because maximality is a Type-II notion (Def. 8 + step 7 need ``P_E``).

    ``device=None`` runs on CUDA (and raises when there is none); pass
    ``device="cpu"`` for the plain ``icm_sweep`` version on the CPU.
    """

    is_probabilistic = False

    def __init__(self, device=None):
        self.device = resolve_device(device)

    def parallel_backend(self) -> tuple[str, None]:
        """Grounding key for the round-parallel engine (core.parallel)."""
        return ("rules", None)

    def run(
        self,
        batch: NeighborhoodBatch,
        ev_pos: np.ndarray | None = None,
        ev_neg: np.ndarray | None = None,
    ) -> np.ndarray:
        lev, valid, n_shared, link = ground_structure(batch, self.device)
        B, P = lev.shape
        ev_pos = self._mask(ev_pos, (B, P))
        ev_neg = self._mask(ev_neg, (B, P))
        x = rules_fixpoint_batch(lev, n_shared, link, ev_pos, ev_neg, valid)
        return x.cpu().numpy()

    def run_with_messages(self, batch, ev_pos=None, ev_neg=None):
        x = self.run(batch, ev_pos, ev_neg)
        B, P = x.shape
        lab = np.full((B, P), P, dtype=np.int32)
        return x, lab

    def _mask(self, m, shape) -> torch.Tensor:
        if m is None:
            return torch.zeros(shape, dtype=torch.bool, device=self.device)
        return torch.as_tensor(np.asarray(m, dtype=bool), device=self.device)
