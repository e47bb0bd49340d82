"""Evaluation metrics (paper §2.2.1 and §6.1).

Two families:

* *Accuracy vs. ground truth* — precision / recall / F1 of a match set
  against the true entity labeling (``EntityTable.truth``).  Recall is
  measured over the true-duplicate pairs that are **candidates** (share
  a similarity level >= 1), matching the paper's setup where blocking
  defines the decision universe (1.3M decisions for HEPTH).
* *Framework properties vs. a reference run* — soundness (fraction of
  M(E) also in E(E)) and completeness (fraction of E(E) recovered by
  M(E)), per §2.2.1 Defs. 1-2.

Naming note: these are the paper's *match-quality* metrics.  Runtime
observability — counters, latency histograms, tracing spans,
device-transfer accounting — lives in :mod:`repro_torch.obs` (its registry is
:mod:`repro_torch.obs.registry`).
"""

from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.core import pairs as pairlib
from repro_torch.core.types import MatchStore


@dataclasses.dataclass
class PRF:
    precision: float
    recall: float
    f1: float
    n_pred: int
    n_true: int

    def row(self, name: str) -> str:
        return (
            f"{name},{self.precision:.4f},{self.recall:.4f},{self.f1:.4f},"
            f"{self.n_pred},{self.n_true}"
        )


def true_pair_gids(truth: np.ndarray, candidate_gids: np.ndarray | None = None) -> np.ndarray:
    """gids of all true-duplicate pairs; optionally restricted to candidates."""
    truth = np.asarray(truth, dtype=np.int64)
    order = np.argsort(truth, kind="stable")
    sorted_t = truth[order]
    out: list[np.ndarray] = []
    start = 0
    n = len(truth)
    while start < n:
        end = start
        while end < n and sorted_t[end] == sorted_t[start]:
            end += 1
        if sorted_t[start] >= 0 and end - start >= 2:
            members = order[start:end]
            ii, jj = np.triu_indices(end - start, k=1)
            out.append(pairlib.make_gid(members[ii], members[jj]))
        start = end
    gids = np.unique(np.concatenate(out)) if out else np.zeros(0, dtype=np.int64)
    if candidate_gids is not None:
        gids = gids[np.isin(gids, candidate_gids)]
    return gids


def prf(matches: MatchStore, truth: np.ndarray, candidate_gids: np.ndarray | None = None) -> PRF:
    true_gids = true_pair_gids(truth, candidate_gids)
    pred = matches.gids
    if len(pred) == 0:
        return PRF(1.0, 0.0, 0.0, 0, len(true_gids))
    hits = int(np.isin(pred, true_gids).sum())
    p = hits / len(pred)
    r = hits / max(len(true_gids), 1)
    f1 = 0.0 if p + r == 0 else 2 * p * r / (p + r)
    return PRF(p, r, f1, len(pred), len(true_gids))


def soundness(m: MatchStore, ref: MatchStore) -> float:
    """Fraction of M(E) that is also in E(E). 1.0 when M(E) is empty."""
    if len(m) == 0:
        return 1.0
    return float(np.isin(m.gids, ref.gids).sum() / len(m))


def completeness(m: MatchStore, ref: MatchStore) -> float:
    """Fraction of E(E) recovered by M(E). 1.0 when E(E) is empty."""
    if len(ref) == 0:
        return 1.0
    return float(np.isin(ref.gids, m.gids).sum() / len(ref))
