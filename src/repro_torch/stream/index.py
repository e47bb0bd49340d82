"""Incremental MinHash-LSH blocking index for streaming ingest.

Arriving entities are shingled into hashed character-3-gram *presence*
vectors over their blocking key (``similarity.block_key``), MinHash
signatures are computed on the device by the ``minhash`` CUDA kernel
(``csrc/minhash.cu``), and the signatures are banded into LSH buckets: two entities collide iff
they agree on all ``rows_per_band`` signature slots of some band.

The index answers one question for delta cover maintenance: *which
existing entities could an arrival be t_loose-similar to?*  Bucket
collisions gate the exact (kernel-computed) similarity probes, so an
ingest costs O(batch x candidates) instead of O(batch x corpus) — the
recall/cost trade of the blocking literature (cf. arXiv 1509.03302):
banding parameters set the similarity level above which recall is
near-1 and below which work is saved.

Device traffic: the hash table goes to the device once, when the index
is built; each ``add`` uploads one presence matrix and reads its
signatures back once.  The bucket dicts stay on the host.

Sharded serving partitions the bucket map: with a ``shard``
(:class:`repro_torch.launch.sharding.ShardSpec`) the index stores and
probes only the buckets it owns, and ``merge`` (a cross-rank union,
:meth:`repro_torch.launch.sharding.ShardMerger.union`) puts each probe's
candidate set back together.  Signatures stay replicated: every rank
runs ``minhash`` over every arrival.
"""

from __future__ import annotations

import dataclasses
from collections import deque

import numpy as np
import torch

from repro_torch.core import similarity as simlib, txn
from repro_torch.kernels.common import resolve_device
from repro_torch.kernels.minhash import ops as minhash_ops


@dataclasses.dataclass(frozen=True)
class LSHConfig:
    """Banding: ``num_bands`` bands of ``rows_per_band`` signature rows.

    Collision probability at Jaccard ``J`` is ``1 - (1 - J^r)^b``; the
    defaults (r=2, b=64) put the S-curve knee near J~0.1 so candidate
    recall at the canopy t_loose threshold is effectively 1 while
    unrelated names rarely collide.

    ``max_ids`` / ``ttl_adds`` bound the bucket tables for long-lived
    serving: ``max_ids`` caps the number of indexed entities (oldest
    evicted first), ``ttl_adds`` evicts entities older than that many
    ``add`` calls.  Both are **off by default** because eviction trades
    exactness for memory — an evicted entity can no longer collide with
    future arrivals, so the delta cover is only guaranteed equal to the
    batch cover for corpora whose >= t_loose partners arrive within the
    retention window.
    """

    num_bands: int = 64
    rows_per_band: int = 2
    shingle_dim: int = 512
    seed: int = 0
    max_ids: int | None = None
    ttl_adds: int | None = None

    @property
    def num_hashes(self) -> int:
        return self.num_bands * self.rows_per_band

    @property
    def bounded(self) -> bool:
        return self.max_ids is not None or self.ttl_adds is not None


def shingle_presence(names: list[str], dim: int) -> np.ndarray:
    """(N, dim) float32 presence matrix of hashed block-key 3-grams.

    Reuses the deterministic FNV hashing of ``ngram_profiles`` so the
    same name always lands on the same shingle slots, then binarizes —
    MinHash needs sets, not counts.
    """
    keys = [simlib.block_key(n) for n in names]
    prof = simlib.ngram_profiles(keys, dim=dim)
    return (prof > 0).astype(np.float32)


class MinHashLSHIndex:
    """Incremental LSH index over MinHash signatures.

    ``add`` ingests a batch (signatures computed on ``device``; ``None``
    means CUDA), ``query``
    returns the union of bucket members colliding with each probe.
    With ``LSHConfig.max_ids`` / ``ttl_adds`` set, the bucket tables are
    bounded: the oldest entities are evicted (and scrubbed from their
    buckets) once the cap or age limit is exceeded.
    """

    def __init__(self, cfg: LSHConfig | None = None, *, shard=None, merge=None,
                 device=None):
        self.cfg = cfg or LSHConfig()
        # bucket-map partitioning for sharded serving: the partition is
        # exhaustive, so the merged set equals the unsharded index's
        # answer exactly; merge runs on EVERY query (it is a collective —
        # all ranks must reach it together, even with an empty local set)
        self.shard = shard
        self.merge = merge
        self.device = resolve_device(device)
        self.table = minhash_ops.hash_table(
            self.cfg.num_hashes, self.cfg.shingle_dim, seed=self.cfg.seed
        )
        # stored transposed, (D, H): a present shingle is one contiguous row
        self._table_t = torch.as_tensor(np.ascontiguousarray(self.table.T), device=self.device)
        # band index -> band key (tuple of signature rows) -> entity ids
        self.buckets: list[dict[tuple, list[int]]] = [
            {} for _ in range(self.cfg.num_bands)
        ]
        self.n_indexed = 0  # currently live (indexed minus evicted)
        self.n_evicted = 0
        self.n_adds = 0
        # eviction bookkeeping, kept only when a bound is configured:
        # per-id band keys (for O(bands) bucket scrubbing), insertion
        # order, and the add-call stamp for TTL.
        self._keys_of: dict[int, list[tuple[int, tuple]]] = {}
        self._added_at: dict[int, int] = {}
        self._order: deque[int] = deque()

    def __getstate__(self):
        # The device copy of the hash table is derived state: pickling
        # (the service's checkpoint) drops it and the device, so the
        # state restores on any device (:meth:`place` re-places it).  The
        # merge hook belongs to this process's group: the restoring
        # service binds its own (the shard spec, data, is kept).
        state = self.__dict__.copy()
        state["device"] = None
        state["_table_t"] = None
        state["merge"] = None
        return state

    def place(self, device) -> None:
        """Compute signatures on ``device`` from now on (the hash table
        is uploaded there at the next call)."""
        self.device = resolve_device(device)
        self._table_t = None

    def signatures(self, names: list[str]) -> np.ndarray:
        if self._table_t is None:
            self._table_t = torch.as_tensor(
                np.ascontiguousarray(self.table.T), device=self.device
            )
        x = torch.as_tensor(
            shingle_presence(names, self.cfg.shingle_dim), device=self.device
        )
        return minhash_ops.minhash_transposed(x, self._table_t).cpu().numpy()

    def _band_keys(self, sig: np.ndarray):
        r = self.cfg.rows_per_band
        for b in range(self.cfg.num_bands):
            yield b, tuple(int(v) for v in sig[b * r : (b + 1) * r])

    def add(self, ids: list[int], names: list[str]) -> np.ndarray:
        """Index a batch; returns the (B, H) signature matrix.

        On a *bounded* index, re-adding an id is tolerated: the old
        bucket entries are scrubbed first and the TTL stamp refreshes.
        An unbounded index keeps the original append-only semantics —
        a re-add duplicates bucket entries and counts in ``n_indexed``
        again (the streaming layer rejects duplicate ids before they
        reach the index).
        """
        sigs = self.signatures(names)
        t = txn.active()
        if t is not None:
            # O(batch x bands) journal: counters, the touched bucket
            # lists (copied pre-image, they are collision-sized), and —
            # bounded index only — the eviction bookkeeping
            t.save_attr(self, "n_adds")
            t.save_attr(self, "n_indexed")
            t.save_attr(self, "n_evicted")
            if self.cfg.bounded:
                t.save_key(self.__dict__, "_order", copy=deque.copy)
        self.n_adds += 1
        for eid, sig in zip(ids, sigs):
            eid = int(eid)
            keys = [
                (b, key) for b, key in self._band_keys(sig)
                if self.shard is None or self.shard.owns(b, key)
            ]
            if self.cfg.bounded and eid in self._keys_of:
                self._scrub(eid)
                self._order.remove(eid)
                self.n_indexed -= 1
            for b, key in keys:
                if t is not None:
                    t.save_key(self.buckets[b], key, copy=list)
                self.buckets[b].setdefault(key, []).append(eid)
            if self.cfg.bounded:
                if t is not None:
                    t.save_key(self._keys_of, eid)
                    t.save_key(self._added_at, eid)
                self._keys_of[eid] = keys
                self._added_at[eid] = self.n_adds
                self._order.append(eid)
            self.n_indexed += 1
        self._evict()
        return sigs

    def _scrub(self, eid: int) -> None:
        """Remove an id's entries from its recorded buckets."""
        t = txn.active()
        if t is not None:
            t.save_key(self._added_at, eid)
            t.save_key(self._keys_of, eid)
        del self._added_at[eid]
        for b, key in self._keys_of.pop(eid):
            members = self.buckets[b].get(key)
            if members is None:
                continue
            if t is not None:
                t.save_key(self.buckets[b], key, copy=list)
            members.remove(eid)
            if not members:
                del self.buckets[b][key]

    def _evict(self) -> None:
        cfg = self.cfg
        while self._order:
            oldest = self._order[0]
            over_cap = cfg.max_ids is not None and len(self._order) > cfg.max_ids
            expired = (
                cfg.ttl_adds is not None
                and self._added_at[oldest] <= self.n_adds - cfg.ttl_adds
            )
            if not (over_cap or expired):
                break
            self._order.popleft()
            self._scrub(oldest)
            self.n_indexed -= 1
            self.n_evicted += 1

    def query(self, sigs: np.ndarray, exclude: set[int] | None = None) -> set[int]:
        """Union of indexed entities colliding with any probe signature.

        Sharded: local buckets cover only the owned slice of the bucket
        map, so the probe result is united across ranks before the
        exclusion — every rank sees the exact unsharded answer.
        """
        out: set[int] = set()
        for sig in np.atleast_2d(sigs):
            for b, key in self._band_keys(sig):
                if self.shard is not None and not self.shard.owns(b, key):
                    continue
                out.update(self.buckets[b].get(key, ()))
        if self.merge is not None:
            out = self.merge(out)
        if exclude:
            out -= exclude
        return out
