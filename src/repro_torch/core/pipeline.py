"""End-to-end EM pipeline: dataset -> cover -> message passing -> metrics.

This is the user-facing entry point gluing together the paper's stages:
canopy covering (§4), packing, global grounding, and a sequential
message-passing scheme (§5).  ``device=None`` runs the kernels on CUDA
and raises when there is no GPU; pass ``device="cpu"`` for the CPU.
"""

from __future__ import annotations

import dataclasses
import time

import numpy as np

from repro_torch.core import metrics as metricslib
from repro_torch.core import similarity as simlib
from repro_torch.core.closure import transitive_closure
from repro_torch.core.cover import PackedCover, build_cover, pack_cover
from repro_torch.core.driver import EMResult, run_mmp, run_nomp, run_smp
from repro_torch.core.global_grounding import GlobalGrounding, build_global_grounding, ub_matches
from repro_torch.core.mln import MLNMatcher, MLNWeights, PAPER_LEARNED
from repro_torch.core.types import EntityTable, MatchStore, Relations
from repro_torch.kernels.common import resolve_device


@dataclasses.dataclass
class Resolved:
    result: EMResult
    packed: PackedCover
    gg: GlobalGrounding
    closed: MatchStore  # transitive closure of the matches
    cover_time_s: float


def prepare(
    entities: EntityTable,
    relations: Relations,
    *,
    weights: MLNWeights = PAPER_LEARNED,
    k_max: int = 32,
    t_loose: float = 0.70,
    t_tight: float = 0.90,
    thresholds=None,
    device=None,
) -> tuple[PackedCover, GlobalGrounding, float]:
    """Build and pack the total cover + the global grounding."""
    t0 = time.perf_counter()
    cover = build_cover(
        entities, relations, t_loose=t_loose, t_tight=t_tight, k_max=k_max, device=device
    )
    packed = pack_cover(
        cover,
        entities,
        relations,
        thresholds=thresholds or simlib.DEFAULT_THRESHOLDS,
    )
    gg = build_global_grounding(packed.pair_levels, relations, weights)
    return packed, gg, time.perf_counter() - t0


def resolve(
    entities: EntityTable,
    relations: Relations,
    *,
    scheme: str = "mmp",
    matcher=None,
    weights: MLNWeights = PAPER_LEARNED,
    parallel: bool = False,
    k_max: int = 32,
    packed: PackedCover | None = None,
    gg: GlobalGrounding | None = None,
    thresholds=None,
    t_loose: float = 0.70,
    device=None,
) -> Resolved:
    """Run the full pipeline with the chosen scheme/matcher."""
    if parallel:
        raise NotImplementedError(
            "the round-parallel engine is not ported yet: see ROADMAP.md, "
            "Queue 1, item 5 (Round-parallel engine)"
        )
    device = resolve_device(device)
    cover_time = 0.0
    if packed is None or gg is None:
        packed, gg, cover_time = prepare(
            entities,
            relations,
            weights=weights,
            k_max=k_max,
            thresholds=thresholds,
            t_loose=t_loose,
            device=device,
        )
    if matcher is None:
        matcher = MLNMatcher(weights, device=device)

    if scheme == "nomp":
        result = run_nomp(packed, matcher)
    elif scheme == "smp":
        result = run_smp(packed, matcher)
    elif scheme == "mmp":
        assert getattr(matcher, "score", None) is not None, (
            "MMP needs a Type-II matcher (score())"
        )
        result = run_mmp(packed, matcher, gg)
    else:
        raise ValueError(f"unknown scheme {scheme!r}")

    closed = transitive_closure(result.matches)
    return Resolved(
        result=result, packed=packed, gg=gg, closed=closed, cover_time_s=cover_time
    )


def evaluate(res: Resolved, truth: np.ndarray) -> metricslib.PRF:
    """P/R/F1 of the (transitively closed) matches against ground truth."""
    return metricslib.prf(res.closed, truth, candidate_gids=res.gg.gids)


def upper_bound(res: Resolved, truth: np.ndarray) -> MatchStore:
    """The paper's UB scheme (§6.1) for this instance."""
    true_gids = metricslib.true_pair_gids(truth, res.gg.gids)
    return ub_matches(res.gg, true_gids)
