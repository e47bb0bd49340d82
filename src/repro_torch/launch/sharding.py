"""Launch-level sharding policy: the LM spec layer and the entity-resolution
serving shards.

Models declare *logical* specs over ``("data", "model")`` in their PSpec
trees (plain tuples, the reference's ``PartitionSpec`` entries); the
spec layer applies the launch policies on top, as pure functions of spec
trees and a mesh's axis names and sizes:

* **FSDP** (:func:`fsdp_params`): additionally shard every large
  parameter over ``data`` (ZeRO-3 style); optimizer state inherits the
  layout.
* **pod rewriting** (:func:`repro_torch.launch.mesh.pod_spec`): on a
  multi-pod mesh, batch-bearing dims shard over ``("pod", "data")``;
  parameters never shard over ``pod``.
* **pure data parallelism** (:func:`strip_model`,
  :func:`dp_over_model_spec`): the ``model`` axis becomes more batch.
* **divisibility guard** (:func:`drop_indivisible`): axes whose shard
  count does not divide the dim are dropped (the ``long_500k`` batch of
  1 never shards over ``data``).
* the shardings of inputs, decode state and parameters
  (:func:`input_shardings`, :func:`state_shardings`,
  :func:`param_shardings`): :class:`repro_torch.launch.mesh.
  NamedSharding` trees, DTensor placements over a ``DeviceMesh``.
* **launch heuristics**: microbatch count and remat group size.

The data-parallel ``Trainer`` reads :func:`repro_torch.models.param.
shardings`; the tensor-parallel one lays its parameters out by
:func:`param_shardings`, and the dry run (:mod:`repro_torch.launch.dryrun`)
applies the whole layer, the reference's policy ported exactly.

The EM side partitions two things across the ranks of the service mesh
(:mod:`repro_torch.launch.mesh`): the LSH bucket map, by a deterministic
hash of each bucket (:func:`bucket_shard`, :class:`ShardSpec`), and each
probe's candidate set is put back together by a cross-rank union
(:class:`ShardMerger`).  The bin rows of the round-parallel engine are
split by :mod:`repro_torch.core.parallel`.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.kernels.common import mesh_spans_processes
from repro_torch.launch.mesh import NamedSharding, mesh_axes, pod_spec
from repro_torch.models.param import PSpec, filter_spec, spec_tree_map

FSDP_MIN_SIZE = 1 << 20  # params below 1M elements stay replicated over data

_FNV_OFFSET = 0xCBF29CE484222325
_FNV_PRIME = 0x100000001B3


def bucket_shard(band: int, key: tuple[int, ...], n_shards: int) -> int:
    """Deterministic owner shard of one LSH bucket ``(band, key)``.

    FNV-1a over the band index and the key's minhash values — NOT
    Python's ``hash`` (salted per interpreter), so every rank of a
    sharded service and every re-run of a test computes the same
    partition.  The partition is exhaustive and disjoint by
    construction: exactly one shard owns each bucket.
    """
    h = _FNV_OFFSET
    for v in (band, *key):
        v = int(v) & 0xFFFFFFFFFFFFFFFF
        for _ in range(8):
            h ^= v & 0xFF
            h = (h * _FNV_PRIME) & 0xFFFFFFFFFFFFFFFF
            v >>= 8
    return h % int(n_shards)


@dataclasses.dataclass(frozen=True)
class ShardSpec:
    """This rank's slice of the sharded serving partition.

    ``n_shards`` is the rank count of the serving mesh and ``shard_id``
    this rank's index; the LSH index stores and probes only the buckets
    :func:`bucket_shard` assigns to ``shard_id``, and per-probe candidate
    sets are merged by a cross-rank union.
    """

    n_shards: int
    shard_id: int

    def __post_init__(self):
        if self.n_shards < 1 or not (0 <= self.shard_id < self.n_shards):
            raise ValueError(
                f"invalid shard spec: id {self.shard_id} of {self.n_shards}"
            )

    def owns(self, band: int, key: tuple[int, ...]) -> bool:
        return bucket_shard(band, key, self.n_shards) == self.shard_id


def _pow2(n: int) -> int:
    return 1 << max(n - 1, 0).bit_length() if n else 1


@dataclasses.dataclass(eq=False)
class ShardMerger:
    """Cross-rank union of per-shard candidate-id sets.

    Callable hook for :class:`repro_torch.stream.index.MinHashLSHIndex`:
    each rank probes only its owned buckets, then the probe results are
    united over the mesh so every rank sees the candidate set the
    unsharded index would have produced (the partition is exhaustive, so
    the union is exact — and the caller sorts, so set order never leaks
    into downstream state).  Both gathers run on the mesh's gloo host
    group.
    """

    mesh: object  # repro_torch.launch.mesh.EMMesh

    def __post_init__(self):
        self.merges = 0

    def _gather(self, local: np.ndarray) -> np.ndarray:
        """All-gather equal-shape per-rank blocks, concatenated in rank order."""
        return self.mesh.host_gather(local, "union").reshape((-1,) + local.shape[1:])

    def union(self, ids: set[int]) -> set[int]:
        """Union this shard's candidate ids across every rank: the counts
        first, then the ids padded to a power of two with -1."""
        if not mesh_spans_processes(self.mesh):
            return ids
        self.merges += 1
        local = np.fromiter(sorted(ids), np.int64, len(ids))
        counts = self._gather(np.array([len(local)], np.int64))
        cap = _pow2(int(counts.max()))
        padded = np.full(cap, -1, np.int64)
        padded[: len(local)] = local
        merged = self._gather(padded)
        return set(merged[merged >= 0].tolist())


# ---------------------------------------------------------------------------
# Launch heuristics
# ---------------------------------------------------------------------------


def pick_microbatches(global_batch: int, data_shards: int, seq_len: int,
                      target_tokens: int = 8192) -> int:
    """Largest microbatch count keeping >= target tokens/device/microbatch.

    More microbatches => less live activation memory per grad-accum step
    but shorter matmuls; ~8k tokens per device per microbatch keeps the
    matrix units fed while bounding the remat working set.
    """
    b_loc = max(global_batch // max(data_shards, 1), 1)
    best = 1
    for mb in range(1, b_loc + 1):
        if b_loc % mb:
            continue
        if (b_loc // mb) * seq_len >= target_tokens:
            best = mb
    return best


def default_remat_group(n_layers: int) -> int:
    """Largest divisor of L that is <= ceil(sqrt(L)) (O(sqrt L) schedule)."""
    top = int(np.ceil(np.sqrt(n_layers)))
    for g in range(top, 1, -1):
        if n_layers % g == 0:
            return g
    return 1


# ---------------------------------------------------------------------------
# The LM spec layer
# ---------------------------------------------------------------------------


def _entry_axes(e) -> tuple:
    if e is None:
        return ()
    return tuple(e) if isinstance(e, (tuple, list)) else (e,)


def data_axis_size(mesh) -> int:
    return int(mesh_axes(mesh).get("data", 1))


def fsdp_spec(ps: PSpec, data_size: int) -> PSpec:
    """Shard one more dim of a large param over ``data`` (ZeRO-3)."""
    if ps.size < FSDP_MIN_SIZE or len(ps.shape) < 2:
        return ps
    if ps.init == "embed":
        # embedding tables stay out of FSDP, as in the reference (its
        # vocab-sharded tables cost more in all-gathers than they saved)
        return ps
    entries = list(ps.spec) + [None] * (len(ps.shape) - len(ps.spec))
    used = {a for e in entries for a in _entry_axes(e)}
    if "data" in used:
        return ps
    # Prefer the fan-in dim, then fan-out, then interior dims.  The leading
    # stacked-layer dim is skipped: the layer loop slices it per layer.
    nd = len(ps.shape)
    order = [nd - 2, nd - 1] + list(range(1, nd - 2))
    for d in order:
        if entries[d] is None and ps.shape[d] % data_size == 0 and ps.shape[d] >= data_size:
            entries[d] = "data"
            return dataclasses.replace(ps, spec=tuple(entries))
    return ps


def strip_model(tree):
    """Remove the `model` axis from every param spec (pure-DP layout)."""

    def fix_entry(e):
        if e == "model":
            return None
        if isinstance(e, (tuple, list)):
            kept = tuple(a for a in e if a != "model")
            return kept if kept else None
        return e

    return spec_tree_map(
        lambda ps: dataclasses.replace(ps, spec=tuple(fix_entry(e) for e in ps.spec)), tree)


def dp_over_model_spec(spec: tuple) -> tuple:
    """Rewrite batch specs 'data' -> ('data','model') (pure-DP layout)."""

    def fix(e):
        if e == "data":
            return ("data", "model")
        if isinstance(e, (tuple, list)):
            out = []
            for a in e:
                out.extend(["data", "model"] if a == "data" else [a])
            return tuple(out)
        return e

    return tuple(fix(e) for e in spec)


def fsdp_params(tree, mesh):
    n = data_axis_size(mesh)
    return spec_tree_map(lambda ps: fsdp_spec(ps, n), tree)


def cast_params(tree, dtype):
    """Serve-time dtype override: every f32 leaf declared ``dtype``."""
    return spec_tree_map(
        lambda ps: dataclasses.replace(ps, dtype=dtype) if ps.dtype == torch.float32 else ps,
        tree)


def drop_indivisible(spec: tuple, shape, mesh) -> tuple:
    sizes = mesh_axes(mesh)
    entries = list(spec) + [None] * (len(shape) - len(spec))
    out = []
    for dim, e in zip(shape, entries):
        n = int(np.prod([sizes.get(a, 1) for a in _entry_axes(e)])) if e else 1
        out.append(e if (n == 1 or dim % n == 0) else None)
    return tuple(out)


def input_shardings(api, shape, mesh) -> dict:
    """Shardings of the input batch (pod-aware, divisibility-safe)."""
    sds = api.input_specs(shape)
    psp = api.input_pspecs(shape)
    out = {}
    for name, s in sds.items():
        sp = filter_spec(pod_spec(psp[name], mesh), mesh)
        out[name] = NamedSharding(mesh, drop_indivisible(sp, s.shape, mesh))
    return out


def state_shardings(tree, mesh, *, pod_batch: bool = True):
    """Shardings of a PSpec state tree (the KV cache).  ``pod_batch``:
    'data'-bearing dims also shard over pod (decode state is per request)."""

    def f(ps: PSpec):
        sp = pod_spec(ps.spec, mesh) if pod_batch else ps.spec
        sp = filter_spec(sp, mesh)
        return NamedSharding(mesh, drop_indivisible(sp, ps.shape, mesh))

    return spec_tree_map(f, tree)


def distribute_state(tree, shardings):
    """DTensors of a tree of whole tensors (every rank holding the same):
    each leaf this rank's block under its :class:`~repro_torch.launch.mesh.
    NamedSharding` of ``shardings`` (a tree of the same keys), with no
    collective; ``meta`` leaves give ``meta`` blocks."""
    from torch.distributed.tensor import DTensor

    if isinstance(tree, dict):
        return {k: distribute_state(v, shardings[k]) for k, v in tree.items()}
    ns = shardings
    local = tree[ns.block(tree.shape)]
    return DTensor.from_local(local.contiguous(), ns.mesh, ns.placements, run_check=False,
                              shape=tree.shape, stride=tree.contiguous().stride())


def param_shardings(tree, mesh):
    """Shardings of parameters (never sharded over pod)."""

    def f(ps: PSpec):
        sp = filter_spec(ps.spec, mesh)
        return NamedSharding(mesh, drop_indivisible(sp, ps.shape, mesh))

    return spec_tree_map(f, tree)
