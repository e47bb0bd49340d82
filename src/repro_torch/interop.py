"""Carry state across from numpy: MLN weights, packed covers, groundings,
LM parameters and training state.

Every function reads its source's attributes by name and copies them as
numpy arrays, so state made by any producer with the same field names —
the JAX reference included — becomes the port's own objects without
importing that producer.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.cover import Cover, PackedCover
from repro_torch.core.global_grounding import GlobalGrounding
from repro_torch.core.mln import MLNWeights
from repro_torch.core.types import NeighborhoodBatch
from repro_torch.kernels.common import resolve_device

BATCH_FIELDS = (
    "entity_ids", "entity_mask", "coauthor", "sim_level", "pair_gid", "pair_mask",
)


def weights_from_numpy(w_sim, w_co) -> MLNWeights:
    """MLN weights from a length-4 ``w_sim`` and a scalar ``w_co``."""
    w = np.asarray(w_sim, dtype=np.float64).reshape(-1)
    if w.shape != (4,):
        raise ValueError(f"w_sim needs 4 levels, got shape {w.shape}")
    return MLNWeights(w_sim=tuple(float(v) for v in w), w_co=float(w_co))


def batch_from_arrays(src) -> NeighborhoodBatch:
    """A :class:`NeighborhoodBatch` from the six fields of ``src``."""
    return NeighborhoodBatch(*(np.array(getattr(src, f)) for f in BATCH_FIELDS))


def packed_from_arrays(src) -> PackedCover:
    """A :class:`PackedCover` from ``bins``, ``bin_rows``, ``neighborhood_bin``,
    ``neighborhood_row``, ``pair_levels`` and ``cover`` (``core``/``full``)."""
    cover = src.cover
    return PackedCover(
        bins={int(k): batch_from_arrays(b) for k, b in src.bins.items()},
        bin_rows={int(k): np.array(v) for k, v in src.bin_rows.items()},
        neighborhood_bin=np.array(src.neighborhood_bin),
        neighborhood_row=np.array(src.neighborhood_row),
        pair_levels={int(g): int(lv) for g, lv in src.pair_levels.items()},
        cover=Cover(
            core=[np.array(c) for c in cover.core],
            full=[np.array(f) for f in cover.full],
        ),
    )


def grounding_from_arrays(src) -> GlobalGrounding:
    """A :class:`GlobalGrounding` from ``gids``, ``u``, ``coup_p``, ``coup_q``, ``w_co``."""
    return GlobalGrounding(
        gids=np.array(src.gids, dtype=np.int64),
        u=np.array(src.u, dtype=np.float32),
        coup_p=np.array(src.coup_p, dtype=np.int32),
        coup_q=np.array(src.coup_q, dtype=np.int32),
        w_co=float(src.w_co),
    )


def _tensors(tree, device):
    """f32 tensors on ``device`` of a tree of numpy leaves."""
    if isinstance(tree, dict):
        return {k: _tensors(v, device) for k, v in tree.items()}
    return torch.tensor(np.asarray(tree, dtype=np.float32), device=device)


def _numpy(tree):
    if isinstance(tree, dict):
        return {k: _numpy(v) for k, v in tree.items()}
    return tree.detach().cpu().numpy()


def lm_params_from_numpy(cfg, tree, device=None):
    """The port's model for ``cfg`` holding the values of ``tree``: a
    parameter tree shaped as the reference's (nested dicts, the stacked
    layer axis first) with numpy leaves.  ``device=None`` means CUDA."""
    from repro_torch.models.registry import get_model

    return get_model(cfg).load(_tensors(tree, resolve_device(device)))


def train_state_from_numpy(cfg, params_tree, opt_tree=None, device=None) -> dict:
    """``{"params": model, "opt": {"m", "v", "step"}}``: the port's trainable
    model for ``cfg`` (f32 masters) holding ``params_tree``, and its
    optimizer state from ``opt_tree`` (the reference's ``{"m", "v",
    "step"}`` of stacked trees; ``None``: zeros), all numpy leaves."""
    from repro_torch.models.registry import get_model
    from repro_torch.train.trainer import state_from_tree

    dev = resolve_device(device)
    opt = None
    if opt_tree is not None:
        opt = {"m": _tensors(opt_tree["m"], dev), "v": _tensors(opt_tree["v"], dev),
               "step": torch.tensor(np.asarray(opt_tree["step"], np.int32), device=dev)}
    return state_from_tree(get_model(cfg), _tensors(params_tree, dev), opt)


def train_state_to_numpy(model, opt=None) -> tuple[dict, dict | None]:
    """The reference's numpy trees of a training state: the stacked
    parameter tree of ``model``, and ``opt`` as ``{"m", "v", "step"}``
    (``None`` without ``opt``)."""
    from repro_torch.train.trainer import checkpoint_state

    state = _numpy(checkpoint_state(model, opt))
    return state["params"], state.get("opt")
