"""Launch-level sharding policy: the entity-resolution serving shards.

Sharded serving partitions two things across the ranks of the service
mesh (:mod:`repro_torch.launch.mesh`): the LSH bucket map, by a
deterministic hash of each bucket (:func:`bucket_shard`,
:class:`ShardSpec`), and each probe's candidate set is put back together
by a cross-rank union (:class:`ShardMerger`).  The bin rows of the
round-parallel engine are split by :mod:`repro_torch.core.parallel`.

This is the EM half of the reference's ``repro.launch.sharding``, and
its launch heuristics :func:`pick_microbatches` and
:func:`default_remat_group`.  The GSPMD half of its LM side —
``data_axis_size``, ``fsdp_spec``, ``strip_model``,
``dp_over_model_spec``, ``fsdp_params``, ``cast_params``,
``drop_indivisible``, ``input_shardings``, ``state_shardings`` and
``param_shardings`` — lays parameters and inputs
over a device mesh; each raises until the multi-device slice
(``ROADMAP.md`` Queue 1 item 15).
"""

from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.kernels.common import mesh_spans_processes
from repro_torch.models.param import unported_fn

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


data_axis_size = unported_fn("data_axis_size", item=15)
fsdp_spec = unported_fn("fsdp_spec", item=15)
strip_model = unported_fn("strip_model", item=15)
dp_over_model_spec = unported_fn("dp_over_model_spec", item=15)
fsdp_params = unported_fn("fsdp_params", item=15)
cast_params = unported_fn("cast_params", item=15)
drop_indivisible = unported_fn("drop_indivisible", item=15)
input_shardings = unported_fn("input_shardings", item=15)
state_shardings = unported_fn("state_shardings", item=15)
param_shardings = unported_fn("param_shardings", item=15)
