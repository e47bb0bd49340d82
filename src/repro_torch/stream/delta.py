"""Delta cover maintenance: arriving batches -> dirty neighborhoods.

The batch cover (``core.cover``) is a deterministic function of the
entity set: canopies seeded in id order, split, boundary-expanded, and
swept for totality.  This module maintains *exactly that cover* under
streaming arrivals without recomputing the O(n^2) similarity structure:

1. **Probe** — the MinHash-LSH index proposes candidate partners for
   each arrival; exact cosine similarities are computed on the device
   (the ``ngram_sim`` CUDA kernel) only for the probed rectangle, and
   entries >= ``t_loose`` are inserted into a sparse similarity graph.
   All intra-batch pairs are probed exactly, so within a micro-batch
   LSH recall does not matter.
2. **Replay** — the canonical canopy sweep (id order, t_tight seed
   suppression — the exact loop of ``build_canopies``) is replayed over
   the sparse graph: cheap host set-ops, no kernel work.  Because the
   sweep is a pure function of the similarity graph, arrival order
   cannot change the result (ingest-order invariance), and because new
   entities get fresh ids, old seeds keep their canopies and only gain
   members.

   The replay is *localized*: suppression and membership only propagate
   along similarity edges, so the sweep decomposes exactly over the
   connected components of the sparse graph.  Each ingest expands a
   frontier from the LSH-touched seeds (the arrivals plus every
   existing entity that gained a similarity edge) to the union of their
   components, re-sweeps only that region, and reuses cached canopies
   for every untouched component — O(region), not O(n), per ingest
   (``last_replay_visits`` counts the region).
3. **Assemble + splice** — ``core.cover.CoverDelta`` (via the
   ``delta=`` path of ``assemble_cover``/``pack_cover``) re-derives
   only the dirty slice of the cover: canopy parts are memoized per
   seed and recomputed only when a member was touched, the totality
   sweep (Def. 7) maintains per-edge cover counts instead of
   re-scanning every neighborhood, and the packed per-bin arrays are
   *spliced* — unchanged bins are reused wholesale, appended-to bins
   concatenate the fresh tail, and only genuinely new rows are staged
   (``DeltaResult.cover_splice_rows`` counts them).  Bit-for-bit equal
   to the scratch
   ``assemble_cover`` + ``pack_cover`` at every ingest.

The **dirty set** returned to the engine is exactly the neighborhoods
whose row key ``(bin, members, intra-relation edges)`` is new this
ingest: membership growth, boundary change, or a new
intra-neighborhood relation tuple all change the key, and an unchanged
key means identical tensors — evaluating such a neighborhood under
unchanged evidence reproduces its old output (idempotence), so
skipping it cannot lose matches.

Exactness caveat: equality with the batch cover needs the sparse graph
to contain every >= t_loose pair, i.e. LSH recall 1 at t_loose.  The
default banding puts the collision S-curve knee far below t_loose.

Everything here is host state (numpy and Python containers) except the
two kernel calls: ``minhash`` in the index and ``ngram_sim`` in the
probe, each on the service's ``device`` with one read-back a call.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch import faults
from repro_torch.core import similarity as simlib, txn
from repro_torch.core.cover import (
    DEFAULT_BINS,
    Cover,
    CoverDelta,
    PackedCover,
)
from repro_torch.core.types import EntityTable, Relations
from repro_torch.kernels.common import resolve_device
from repro_torch.kernels.ngram_sim import ops as sim_ops
from repro_torch.obs import span as obs_span
from repro_torch.stream.index import LSHConfig, MinHashLSHIndex


@dataclasses.dataclass
class DeltaResult:
    cover: Cover
    packed: PackedCover
    dirty: list[int]  # neighborhood indices whose row key is new
    # candidate-pair delta vs the previous cover — the exact input the
    # incremental grounding maintainer consumes (gid -> level / gids):
    added_pairs: dict[int, int] = dataclasses.field(default_factory=dict)
    retracted_pairs: list[int] = dataclasses.field(default_factory=list)
    new_edges: np.ndarray | None = None  # this ingest's relation tuples
    replay_visits: int = 0  # ids swept by the localized canopy replay
    cover_splice_rows: int = 0  # neighborhood rows (re)staged by the splice


class DeltaCover:
    """Incrementally maintained total cover over a growing entity set."""

    def __init__(
        self,
        *,
        t_loose: float = 0.70,
        t_tight: float = 0.90,
        k_max: int = 32,
        feature_dim: int = 128,
        k_bins: tuple[int, ...] = DEFAULT_BINS,
        thresholds=None,
        boundary_relation: str = "coauthor",
        lsh: LSHConfig | None = None,
        level_cache_max: int | None = None,
        shard=None,
        shard_merge=None,
        device=None,
    ):
        self.t_loose = t_loose
        self.t_tight = t_tight
        self.k_max = k_max
        self.feature_dim = feature_dim
        self.k_bins = k_bins
        self.thresholds = thresholds or simlib.DEFAULT_THRESHOLDS
        self.boundary_relation = boundary_relation
        self.device = resolve_device(device)
        # sharded serving: the index keeps only this rank's buckets and
        # unites each probe's candidates over the ranks (stream.shard)
        self.index = MinHashLSHIndex(lsh, shard=shard, merge=shard_merge,
                                     device=self.device)

        self.names: list[str | None] = []  # id -> name (None = hole)
        self.present: set[int] = set()
        self.features = np.zeros((0, feature_dim), dtype=np.float32)
        self.edge_chunks: list[np.ndarray] = []
        # sparse similarity graph: only entries >= t_loose are kept
        self.sim_adj: dict[int, dict[int, float]] = {}
        # persistent packing caches (see pack_cover)
        self.level_cache: dict[int, int] = {}
        # cap on the Jaro-Winkler level memo: eviction is safe (a miss
        # recomputes the level from the name-static strings), so a
        # long-lived service can bound this without losing exactness.
        self.level_cache_max = level_cache_max
        # incremental cover assembly + packed splice state (core.cover):
        # re-derives only the touched slice of the cover per ingest and
        # splices the packed arrays instead of re-staging every row.
        self.cover_delta = CoverDelta(
            k_max=k_max,
            k_bins=k_bins,
            thresholds=self.thresholds,
            boundary_relation=boundary_relation,
        )
        # localized-replay state: seed id -> canopy members, plus the
        # visit counters the O(dirty) tests/benchmarks read.
        self._canopy_cache: dict[int, np.ndarray] = {}
        self._last_region: set[int] = set()
        self.last_replay_visits = 0
        self.total_replay_visits = 0

        self.cover: Cover | None = None
        self.packed: PackedCover | None = None

    def __getstate__(self):
        # Host state only: the device (and the index's device copies,
        # dropped by its own __getstate__) is re-set by :meth:`place`,
        # so a checkpoint written on one device restores on any other.
        state = self.__dict__.copy()
        state["device"] = None
        return state

    def place(self, device) -> None:
        """Run the probe and the index's signatures on ``device``."""
        self.device = resolve_device(device)
        self.index.place(self.device)

    # -- growing state ----------------------------------------------------

    @property
    def n_entities(self) -> int:
        return len(self.present)

    @property
    def total_splice_rows(self) -> int:
        """Cumulative neighborhood rows (re)staged by the cover splice."""
        return self.cover_delta.total_splice_rows

    def entities(self) -> EntityTable:
        return EntityTable(names=list(self.names), features=self.features)

    def relations(self) -> Relations:
        if not self.edge_chunks:
            edges = np.zeros((0, 2), dtype=np.int64)
        else:
            edges = np.concatenate(self.edge_chunks, axis=0)
        return Relations(edges={self.boundary_relation: edges})

    def _grow(self, ids: list[int], names: list[str]) -> None:
        if not ids:
            return
        t = txn.active()
        hi = max(ids) + 1
        grown = hi > len(self.names)
        if t is not None:
            t.save_len(self.names)
            # growth rebinds ``features`` to a fresh concatenation (the
            # old buffer is never written again), so the ref suffices;
            # hole-fill writes into an unchanged buffer journal rows
            t.save_attr(self, "features")
        if grown:
            self.names.extend([None] * (hi - len(self.names)))
            pad = np.zeros((hi - len(self.features), self.feature_dim), np.float32)
            self.features = np.concatenate([self.features, pad])
        feats = simlib.ngram_profiles(
            [simlib.block_key(n) for n in names], dim=self.feature_dim
        )
        for eid, name, f in zip(ids, names, feats):
            if self.names[eid] is not None:
                # mid-loop failure: earlier iterations already wrote —
                # the journal is what makes this raise leave no trace
                raise ValueError(f"entity id {eid} ingested twice")
            if t is not None:
                t.save_item(self.names, eid)
                if not grown:
                    t.save_row(self.features, eid)
                t.set_add(self.present, eid)
                self.names[eid] = name
                self.features[eid] = f
            else:
                self.names[eid] = name
                self.features[eid] = f
                self.present.add(eid)

    # -- probe ------------------------------------------------------------

    def _probe(self, ids: list[int], names: list[str]) -> set[int]:
        """LSH-gated exact similarity probes.

        Returns the set of ids whose similarity adjacency changed — the
        arrivals plus every existing entity that gained an edge — which
        seeds the localized canopy replay's frontier expansion.
        """
        sigs = self.index.add(ids, names)
        # LSH collisions plus the batch itself: intra-batch similarity is
        # always exact, so a service ingesting everything in one batch
        # reproduces build_canopies regardless of banding parameters.
        cands = sorted(self.index.query(sigs) | set(ids))
        touched = set(ids)
        if not cands:
            return touched
        q = torch.as_tensor(
            self.features[np.asarray(ids, dtype=np.int64)], device=self.device
        )
        p = torch.as_tensor(
            self.features[np.asarray(cands, dtype=np.int64)], device=self.device
        )
        sims = sim_ops.sim_above(q, p, 0.0).cpu().numpy()
        t = txn.active()
        for r, a in enumerate(ids):
            row = sims[r]
            for c in np.where(row >= self.t_loose)[0]:
                b = cands[int(c)]
                if b == a:
                    continue
                s = float(row[int(c)])
                if t is not None:
                    t.save_key(self.sim_adj, a, copy=dict)
                    t.save_key(self.sim_adj, b, copy=dict)
                self.sim_adj.setdefault(a, {})[b] = s
                self.sim_adj.setdefault(b, {})[a] = s
                touched.add(b)
        return touched

    # -- replay -----------------------------------------------------------

    def _replay_region(self, touched: set[int]) -> set[int]:
        """Frontier expansion: close the touched ids over the sparse
        similarity graph.  Suppression and membership only propagate
        along similarity edges, so the union of the touched connected
        components is exactly the slice of the sweep that can change."""
        region: set[int] = set()
        stack = [e for e in touched if e in self.present]
        while stack:
            e = stack.pop()
            if e in region:
                continue
            region.add(e)
            stack.extend(o for o in self.sim_adj.get(e, ()) if o not in region)
        return region

    def _canopies(self, touched: set[int]) -> list[np.ndarray]:
        """Localized canonical canopy sweep.

        Re-sweeps only the connected region of the touched ids (exactly
        ``build_canopies`` restricted to it: seeds in ascending id
        order, every >= t_loose partner a member, >= t_tight partners
        suppressed as seeds) and reuses cached canopies everywhere else.
        Bit-for-bit equal to the full sweep (``_canopies_full``) because
        the sweep decomposes over similarity components — O(region)
        set-ops per ingest instead of O(n).
        """
        region = self._replay_region(touched)
        t = txn.active()
        if t is not None:
            t.save_attr(self, "_last_region")
            t.save_attr(self, "last_replay_visits")
            t.save_attr(self, "total_replay_visits")
        self._last_region = region
        self.last_replay_visits = len(region)
        self.total_replay_visits += len(region)
        for seed in region:
            if t is not None:
                t.save_key(self._canopy_cache, seed)
            self._canopy_cache.pop(seed, None)
        suppressed: set[int] = set()
        for e in sorted(region):
            if e in suppressed:
                continue
            nbrs = self.sim_adj.get(e, {})
            if t is not None:
                t.save_key(self._canopy_cache, e)
            self._canopy_cache[e] = np.asarray(
                sorted({e} | set(nbrs)), dtype=np.int64
            )
            for o, s in nbrs.items():
                if s >= self.t_tight:
                    suppressed.add(o)
        return [self._canopy_cache[s] for s in sorted(self._canopy_cache)]

    def canopies(self) -> list[np.ndarray]:
        """Current canopies (seed-id order), from the replay cache."""
        return [self._canopy_cache[s] for s in sorted(self._canopy_cache)]

    def _canopies_full(self) -> list[np.ndarray]:
        """Full-id sweep (the pre-localization loop); kept for the
        equality tests proving the replayed slice reproduces it."""
        suppressed: set[int] = set()
        out: list[np.ndarray] = []
        for e in sorted(self.present):
            if e in suppressed:
                continue
            nbrs = self.sim_adj.get(e, {})
            members = np.asarray(sorted({e} | set(nbrs)), dtype=np.int64)
            out.append(members)
            for o, s in nbrs.items():
                if s >= self.t_tight:
                    suppressed.add(o)
        return out

    # -- ingest -----------------------------------------------------------

    def ingest(
        self,
        ids: list[int],
        names: list[str],
        edges: np.ndarray | None = None,
    ) -> DeltaResult:
        if len(ids) != len(names):
            raise ValueError(f"{len(ids)} ids for {len(names)} names")
        if edges is not None and len(edges):
            edges = np.asarray(edges, dtype=np.int64)
            if np.any(edges[:, 0] == edges[:, 1]):
                # A self-loop carries no pairwise evidence but *would*
                # perturb the batch grounding's common-neighbor counts
                # (adjacency_sets puts i in adj(i)); rejecting it keeps
                # the stream == batch equality contract honest instead
                # of silently diverging.
                raise ValueError("self-loop relation edges are not allowed")
            unknown = sorted(
                {int(e) for e in edges.reshape(-1)} - self.present - set(ids)
            )
            if unknown:
                raise ValueError(
                    f"relation edges reference entities never ingested: "
                    f"{unknown[:5]}{'...' if len(unknown) > 5 else ''}"
                )
        else:
            edges = None
        t = txn.active()
        self._grow(ids, names)
        if edges is not None:
            if t is not None:
                t.save_len(self.edge_chunks)
            self.edge_chunks.append(edges)
        faults.maybe_fail("lsh", names)
        with obs_span("ingest.lsh", batch=len(ids)):
            touched = self._probe(ids, names) if ids else set()

        faults.maybe_fail("replay", names)
        with obs_span("ingest.replay", touched=len(touched)):
            canopies = self._canopies(touched)
        seeds = sorted(self._canopy_cache)
        # the cover-delta's dirt set: the re-swept similarity region plus
        # every endpoint of this ingest's relation edges (boundary
        # expansion and intra-edge row keys read members' adjacency)
        assembly_touched = set(self._last_region)
        if edges is not None and len(edges):
            assembly_touched.update(int(e) for e in edges.reshape(-1))
        # Drive the incremental CoverDelta directly: it maintains the
        # boundary adjacency from new_edges itself (no per-ingest O(E)
        # Relations rebuild) and only reads entity *names*, so the live
        # name list is passed without the O(n) copy of entities().
        faults.maybe_fail("cover_splice", names)
        with obs_span("ingest.cover_splice"):
            cover = self.cover_delta.assemble(
                canopies,
                seeds,
                EntityTable(names=self.names, features=self.features),
                present=self.present,
                touched=assembly_touched,
                new_ids=ids,
                new_edges=edges,
            )
            packed = self.cover_delta.pack(
                cover, prev=self.packed, level_cache=self.level_cache
            )

        # Bound the Jaro-Winkler level memo (oldest-inserted first; pure
        # memo, so eviction never changes the cover or the fixpoint).
        if self.level_cache_max is not None:
            while len(self.level_cache) > self.level_cache_max:
                k = next(iter(self.level_cache))
                if t is not None:
                    t.save_key(self.level_cache, k)
                self.level_cache.pop(k)
        if t is not None:
            t.save_attr(self, "cover")
            t.save_attr(self, "packed")
        self.cover, self.packed = cover, packed
        return DeltaResult(
            cover=cover,
            packed=packed,
            dirty=self.cover_delta.last_dirty,
            added_pairs=self.cover_delta.last_added_pairs,
            retracted_pairs=self.cover_delta.last_retracted_pairs,
            new_edges=edges,
            replay_visits=self.last_replay_visits,
            cover_splice_rows=self.cover_delta.last_splice_rows,
        )
