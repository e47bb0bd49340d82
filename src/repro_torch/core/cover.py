"""Covering (paper §4): canopies + relational boundary => total cover.

Pipeline (paper-faithful):

1. *Canopies* [McCallum-Nigam-Ungar 2000] over the ``Similar`` relation:
   entities are embedded as hashed n-gram profiles; a seed's canopy is
   every entity with cosine >= ``t_loose``; entities within ``t_tight``
   of the seed stop being seeds.  The seed-vs-pool similarity is the
   ``ngram_sim`` kernel (a tiled product) on the profiles, uploaded to
   the device once per :func:`build_canopies`.
2. *Boundary expansion*: each canopy is expanded with every entity that
   shares a relation tuple (Coauthor) with a member => the cover is
   **total** w.r.t. the relations (Def. 7): no tuple is lost.
3. *Packing*: neighborhoods are padded to fixed entity capacity and
   binned by size (k in ``k_bins``) so the batched matcher runs on
   dense, static shapes.  Size-binning is also our structural answer to
   the MapReduce skew the paper reports in §6.3 (see DESIGN §3).

Oversized canopies are split into overlapping windows (stride k/2) in
similarity-sorted order — the standard blocking trade-off; every split
window is boundary-expanded again, so totality is preserved.

The whole construction is a deterministic, locally-decomposable
function of its inputs, which is what the streaming path exploits:
:class:`CoverDelta` memoizes every stage and re-derives only the slice
an ingest touched, splicing the packed arrays in place — bit-for-bit
the scratch build at O(dirty) staging cost (see the class docstring).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core import pairs as pairlib
from repro_torch.core import similarity as simlib, txn
from repro_torch.core.types import EntityTable, NeighborhoodBatch, Relations
from repro_torch.kernels.common import resolve_device
from repro_torch.kernels.ngram_sim import ops as sim_ops
from repro_torch.obs.registry import get_registry

DEFAULT_BINS = (8, 16, 24, 32)


@dataclasses.dataclass
class Cover:
    """A total cover: per neighborhood, core members and full (core+boundary)."""

    core: list[np.ndarray]
    full: list[np.ndarray]
    _entity_index: dict[int, list[int]] | None = dataclasses.field(
        default=None, repr=False, compare=False
    )

    def __len__(self) -> int:
        return len(self.full)

    def entity_index(self) -> dict[int, list[int]]:
        """entity id -> neighborhoods (by full membership).

        Memoized: a Cover is immutable once assembled, and the drivers
        consult this index on every evidence-driven re-activation — an
        O(n) rebuild per worklist step without the cache.
        """
        if self._entity_index is None:
            idx: dict[int, list[int]] = {}
            for n, members in enumerate(self.full):
                for e in members:
                    idx.setdefault(int(e), []).append(n)
            self._entity_index = idx
        return self._entity_index


def build_canopies(
    features: np.ndarray,
    t_loose: float,
    t_tight: float,
    *,
    chunk: int = 1024,
    device=None,
) -> list[np.ndarray]:
    """Deterministic canopy construction (seeds in id order).

    The paper picks random seeds; a fixed seed order is a valid draw and
    keeps the construction reproducible.  Order-invariance of the *match
    output* is the framework's consistency property, tested separately.
    Each seed probes the pool chunk by chunk (one ``ngram_sim`` launch a
    chunk) and reads its similarities back once.
    """
    n = features.shape[0]
    feats = torch.as_tensor(np.asarray(features, dtype=np.float32), device=resolve_device(device))
    remaining = np.ones(n, dtype=bool)
    canopies: list[np.ndarray] = []
    order = np.arange(n)
    for seed in order:
        if not remaining[seed]:
            continue
        q = feats[seed : seed + 1]
        blocks = [
            sim_ops.sim_above(q, feats[lo : min(lo + chunk, n)], 0.0)[0]
            for lo in range(0, n, chunk)
        ]
        sims = torch.cat(blocks).cpu().numpy()
        members = np.where(sims >= t_loose)[0]
        if len(members) == 0:
            members = np.array([seed])
        canopies.append(members.astype(np.int64))
        remaining[sims >= t_tight] = False
        remaining[seed] = False
    return canopies


def _split_oversized(members: np.ndarray, names: list[str], k_core: int) -> list[np.ndarray]:
    if len(members) <= k_core:
        return [members]
    order = np.argsort([names[int(e)] for e in members], kind="stable")
    sorted_members = members[order]
    out = []
    step = max(k_core // 2, 1)
    for lo in range(0, len(sorted_members), step):
        win = sorted_members[lo : lo + k_core]
        if len(win) == 0:
            break
        out.append(win)
        if lo + k_core >= len(sorted_members):
            break
    return out


def _expand_part(
    part: np.ndarray, adj: dict[int, set[int]], k_max: int
) -> tuple[np.ndarray, np.ndarray]:
    """Boundary-expand one split part -> (core, full), clipped to k_max.

    Shared by the scratch build and the incremental :class:`CoverDelta`
    path so the two produce byte-identical neighborhoods (including the
    set-iteration tie-break order of the boundary ranking).
    """
    boundary: set[int] = set()
    part_set = set(int(e) for e in part)
    for e in part:
        boundary |= adj.get(int(e), set())
    boundary -= part_set
    # clip boundary to capacity, preferring high-degree connectors
    room = k_max - len(part)
    if len(boundary) > room:
        ranked = sorted(
            boundary,
            key=lambda b: -len(adj.get(b, set()) & part_set),
        )
        boundary = set(ranked[:room])
    full = np.array(sorted(part_set | boundary), dtype=np.int64)
    core = np.asarray(sorted(part_set), dtype=np.int64)
    return core, full


def _pack_edge_groups(missing, k_max: int) -> list[np.ndarray]:
    """Greedily pack uncovered relation edges into supplementary
    neighborhoods (the Def. 7 totality sweep), a pure function of the
    missing-edge set."""
    out: list[np.ndarray] = []
    group: set[int] = set()
    for a, b in sorted(set(missing)):
        if len(group | {a, b}) > k_max:
            out.append(np.asarray(sorted(group), dtype=np.int64))
            group = set()
        group |= {a, b}
    if group:
        out.append(np.asarray(sorted(group), dtype=np.int64))
    return out


def _pack_leftover_chunks(leftovers: list[int], k_max: int) -> list[np.ndarray]:
    """Chunk uncovered entities (sorted) into k_max-sized neighborhoods."""
    return [
        np.asarray(leftovers[lo : lo + k_max], dtype=np.int64)
        for lo in range(0, len(leftovers), k_max)
    ]


def build_cover(
    entities: EntityTable,
    relations: Relations,
    *,
    t_loose: float = 0.70,
    t_tight: float = 0.90,
    k_max: int = 32,
    feature_dim: int = 128,
    boundary_relation: str = "coauthor",
    device=None,
) -> Cover:
    """Canopies on ``device`` (``None`` means CUDA), then host assembly."""
    if entities.features is None:
        entities.features = simlib.ngram_profiles(
            [simlib.block_key(n) for n in entities.names], dim=feature_dim
        )
    canopies = build_canopies(entities.features, t_loose, t_tight, device=device)
    return assemble_cover(
        canopies,
        entities,
        relations,
        k_max=k_max,
        boundary_relation=boundary_relation,
    )


def assemble_cover(
    canopies: list[np.ndarray],
    entities: EntityTable,
    relations: Relations,
    *,
    k_max: int = 32,
    boundary_relation: str = "coauthor",
    present: set[int] | None = None,
    delta: "CoverDelta | None" = None,
    seeds: list[int] | None = None,
    touched: set[int] | None = None,
    new_ids: list[int] | None = None,
    new_edges: np.ndarray | None = None,
) -> Cover:
    """Deterministic canopies -> total cover assembly (split + boundary +
    totality sweep + leftovers).

    Shared by the batch path (:func:`build_cover`) and the streaming
    delta-maintenance path (:mod:`repro_torch.stream.delta`): given the *same*
    canopies in the same order, both produce the identical Cover, which
    is what makes the streaming fixpoint bit-for-bit equal to the batch
    one.  ``present`` restricts the entity-coverage sweep to ids that
    actually exist (a streaming service ingesting batches out of id
    order has temporary holes in the id space).

    ``delta`` selects the incremental path: the persistent
    :class:`CoverDelta` re-derives only the neighborhoods reachable from
    ``touched`` entity ids (plus the edge/leftover bookkeeping deltas of
    ``new_ids``/``new_edges``) and reuses every other neighborhood from
    its memo — the same Cover as the scratch sweep, at O(dirty) cost.
    ``seeds`` aligns ``canopies`` with their canopy-cache seed ids.
    """
    if delta is not None:
        assert seeds is not None and touched is not None
        return delta.assemble(
            canopies,
            seeds,
            entities,
            relations,
            # the delta only reads len(present) (its O(1) universe
            # guard), so a range stands in for the full id set without
            # an O(n) materialization per ingest
            present=present if present is not None else range(len(entities)),
            touched=touched,
            new_ids=new_ids or [],
            new_edges=new_edges,
        )
    adj = relations.adjacency_sets(boundary_relation)
    core_sets: list[np.ndarray] = []
    full_sets: list[np.ndarray] = []
    seen: set[tuple] = set()
    # reserve boundary room: boundary can add up to k_max - k_core slots
    k_core = max(2, int(k_max * 0.6))
    for members in canopies:
        for part in _split_oversized(members, entities.names, k_core):
            key = tuple(sorted(int(e) for e in part))
            if key in seen or len(part) < 2:
                continue
            seen.add(key)
            core, full = _expand_part(part, adj, k_max)
            core_sets.append(core)
            full_sets.append(full)

    # Totality sweep (Def. 7): boundary clipping above can drop relation
    # tuples, and canopy singletons never enter a neighborhood.  Gather
    # every uncovered relation edge and pack the endpoints into
    # supplementary neighborhoods so that R(E) = U R(C_i) exactly.
    covered_edges: set[tuple[int, int]] = set()
    for members in full_sets:
        ms = [int(e) for e in members]
        mset = set(ms)
        for e in ms:
            for nb in adj.get(e, set()):
                if nb in mset:
                    covered_edges.add((min(e, nb), max(e, nb)))
    missing: list[tuple[int, int]] = []
    for edges in relations.edges.values():
        for a, b in edges:
            a, b = int(a), int(b)
            if a != b and (min(a, b), max(a, b)) not in covered_edges:
                missing.append((min(a, b), max(a, b)))
    for arr in _pack_edge_groups(missing, k_max):
        core_sets.append(arr)
        full_sets.append(arr)

    # Entity coverage (cover definition: union of neighborhoods == E):
    # canopy singletons with no relation edges still need a home.
    covered_entities: set[int] = set()
    for members in full_sets:
        covered_entities.update(int(e) for e in members)
    universe = set(range(len(entities))) if present is None else set(present)
    leftovers = sorted(universe - covered_entities)
    for arr in _pack_leftover_chunks(leftovers, k_max):
        core_sets.append(arr)
        full_sets.append(arr)
    return Cover(core=core_sets, full=full_sets)


def is_total(cover: Cover, relations: Relations, candidate_gids: np.ndarray) -> bool:
    """Check Def. 7 (relations) + blocking totality over candidate pairs."""
    covered = set()
    for members in cover.full:
        ms = set(int(e) for e in members)
        for a in ms:
            for b in ms:
                if a < b:
                    covered.add(int(pairlib.make_gid(a, b)))
    for edges in relations.edges.values():
        for a, b in edges:
            if a == b:
                continue
            if int(pairlib.make_gid(int(a), int(b))) not in covered:
                return False
    return all(int(g) in covered for g in candidate_gids)


# ---------------------------------------------------------------------------
# Packing into padded, size-binned NeighborhoodBatches
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class PackedCover:
    """Size-binned padded tensors + host-side indices for message passing."""

    bins: dict[int, NeighborhoodBatch]  # k -> batch over neighborhoods
    bin_rows: dict[int, np.ndarray]  # k -> neighborhood index per row
    neighborhood_bin: np.ndarray  # (N,) bin k of each neighborhood
    neighborhood_row: np.ndarray  # (N,) row within its bin
    pair_levels: dict[int, int]  # global gid -> sim level (>=1)
    cover: Cover
    # per-neighborhood row keys (bin, members, intra-relation edges) —
    # populated when packing with a row_cache or via the CoverDelta
    # splice path; the streaming path diffs them across ingests to find
    # dirty neighborhoods, and the device GroundingCache fingerprints
    # bin rows with them.
    row_keys: list[tuple] | None = None
    # splice-maintained incidence lookup, attached by the CoverDelta
    # path: (gid -> {row key: refcount}, entity -> {row key: refcount},
    # row key -> neighborhood positions).  The first two dicts are the
    # delta's LIVE maps (maintained in the acquire/release refcount
    # loops, O(dirty) per ingest) and are only valid until the next
    # ingest repacks — exactly the window the engine queries them in;
    # the position map is rebuilt per pack (a dict append inside the
    # bin-sequence walk pack already does).  When absent (batch path),
    # queries fall back to the lazily built CSR / entity index below.
    slot_lookup: tuple[dict, dict, dict] | None = dataclasses.field(
        default=None, repr=False, compare=False
    )
    # memoized slot-incidence CSR (gid -> neighborhoods), see
    # slot_incidence(); a PackedCover is immutable once built.
    _slot_csr: tuple[np.ndarray, np.ndarray, np.ndarray] | None = dataclasses.field(
        default=None, repr=False, compare=False
    )

    @property
    def num_neighborhoods(self) -> int:
        return len(self.neighborhood_bin)

    def rows_for(self, neighborhoods: list[int]) -> dict[int, np.ndarray]:
        """Group a set of neighborhood ids by bin -> row arrays."""
        out: dict[int, list[int]] = {}
        for n in neighborhoods:
            out.setdefault(int(self.neighborhood_bin[n]), []).append(
                int(self.neighborhood_row[n])
            )
        return {k: np.asarray(v, dtype=np.int64) for k, v in out.items()}

    def _positions_of_entity(self, e: int) -> set[int]:
        """Neighborhood positions whose full membership holds ``e``
        (splice-lookup path; callers guard on ``slot_lookup``)."""
        _, ent_rows, pos = self.slot_lookup
        out: set[int] = set()
        for rk in ent_rows.get(int(e), ()):
            out.update(pos.get(rk, ()))
        return out

    def neighborhoods_of_entities(self, ids) -> set[int]:
        """Neighborhoods whose full membership contains any of ``ids``.

        Resolved per query from the splice-maintained lookup when
        present (no per-ingest index rebuild); falls back to the
        memoized ``Cover.entity_index`` on the batch path.
        """
        out: set[int] = set()
        if self.slot_lookup is not None:
            for e in ids:
                out |= self._positions_of_entity(int(e))
            return out
        idx = self.cover.entity_index()
        for e in ids:
            out.update(idx.get(int(e), ()))
        return out

    def neighborhoods_of_pairs(self, gids: np.ndarray) -> list[int]:
        """Neighborhoods containing BOTH endpoints of any of the pairs."""
        if self.slot_lookup is not None:
            out: set[int] = set()
            for g in gids:
                a, b = pairlib.split_gid(np.int64(g))
                out |= self._positions_of_entity(int(a)) & \
                    self._positions_of_entity(int(b))
            return sorted(out)
        idx = self.cover.entity_index()
        out = set()
        for g in gids:
            a, b = pairlib.split_gid(np.int64(g))
            na = idx.get(int(a), [])
            nb = set(idx.get(int(b), []))
            for n in na:
                if n in nb:
                    out.add(n)
        return sorted(out)

    def slot_incidence(self) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
        """CSR incidence: candidate pair gid -> neighborhoods holding it
        as a *candidate slot* (``pair_mask`` true).

        Returns ``(gids, indptr, nbhd)``: sorted unique gids, and for
        gid ``gids[i]`` the neighborhoods ``nbhd[indptr[i]:indptr[i+1]]``.
        This is the structure the round-parallel driver re-activates
        from: it is a subset of :meth:`neighborhoods_of_pairs`
        (endpoint incidence), and the difference is inert — a
        neighborhood holding both endpoints but not the candidate slot
        projects no evidence from that pair, so re-evaluating it can
        produce nothing new (its fixpoint contribution is unchanged).
        Built vectorized from the packed bins and memoized.
        """
        if self._slot_csr is None:
            gid_parts: list[np.ndarray] = []
            nb_parts: list[np.ndarray] = []
            for k, nb in self.bins.items():
                mask = nb.pair_mask & (nb.pair_gid >= 0)
                rows, _ = np.nonzero(mask)
                gid_parts.append(nb.pair_gid[mask])
                nb_parts.append(self.bin_rows[k][rows])
            if gid_parts:
                flat_gid = np.concatenate(gid_parts)
                flat_nb = np.concatenate(nb_parts)
                order = np.argsort(flat_gid, kind="stable")
                flat_gid, flat_nb = flat_gid[order], flat_nb[order]
                uniq, starts = np.unique(flat_gid, return_index=True)
                indptr = np.append(starts, len(flat_gid))
            else:
                uniq = np.zeros(0, dtype=np.int64)
                indptr = np.zeros(1, dtype=np.int64)
                flat_nb = np.zeros(0, dtype=np.int64)
            self._slot_csr = (uniq, indptr, flat_nb)
        return self._slot_csr

    def neighborhoods_of_slot_pairs(self, gids: np.ndarray) -> list[int]:
        """Neighborhoods with any of ``gids`` as a candidate slot (sorted).

        With a splice-maintained ``slot_lookup`` (streaming path) this
        resolves per query — gid -> row keys -> positions — without ever
        materializing the O(total candidate slots) CSR; rows with equal
        keys hold identical tensors, so their positions carry exactly
        the queried slot.
        """
        if self.slot_lookup is not None:
            gid_rows, _, pos = self.slot_lookup
            out: set[int] = set()
            for g in gids:
                for rk in gid_rows.get(int(g), ()):
                    out.update(pos.get(rk, ()))
            return sorted(out)
        uniq, indptr, nbhd = self.slot_incidence()
        if not len(gids) or not len(uniq):
            return []
        g = np.asarray(gids, dtype=np.int64)
        pos = np.searchsorted(uniq, g)
        pos = np.clip(pos, 0, len(uniq) - 1)
        pos = pos[uniq[pos] == g]
        if not len(pos):
            return []
        hits = np.concatenate([nbhd[indptr[i] : indptr[i + 1]] for i in pos])
        return [int(n) for n in np.unique(hits)]


def _bin_of(size: int, k_bins: tuple[int, ...]) -> int:
    return next((kb for kb in k_bins if size <= kb), k_bins[-1])


def _pair_level_fn(names: list[str], thresholds, level_cache: dict[int, int]):
    """Host-side Jaro-Winkler discretization, memoized per global pair.

    Levels are name-static, so a cached entry can never go stale; the
    streaming layer may bound the memo (``DeltaCover.level_cache_max``)
    because a miss just recomputes from the strings.
    """

    def pair_level(a: int, b: int) -> int:
        gid = int(pairlib.make_gid(a, b))
        lev = level_cache.get(gid)
        if lev is None:
            s = simlib.jaro_winkler(simlib.name_key(names[a]), simlib.name_key(names[b]))
            lev = int(simlib.discretize(np.asarray([s]), thresholds)[0])
            if lev == 0 and simlib.abbrev_compatible(names[a], names[b]):
                lev = 1  # abbreviation-aware weak candidate
            elif lev > 0 and simlib.first_name_conflict(names[a], names[b]):
                lev = 0  # full first names of different people: veto
            t = txn.active()
            if t is not None:
                # gids index into `names`: an aborted ingest's entry could
                # otherwise resolve to a *different* name pair after the
                # ids are reused, caching a wrong level forever
                t.save_key(level_cache, gid)
            level_cache[gid] = lev
        return lev

    return pair_level


def _row_key(members: np.ndarray, k: int, adj: dict[int, set[int]]) -> tuple:
    """``(k, members, intra-relation edges)`` — changes whenever anything
    that feeds the staged row tensors changes, so a cached row keyed by
    it can never be reused stale."""
    mkey = tuple(int(e) for e in members[:k])
    intra = tuple(
        (a, b)
        for ai, a in enumerate(mkey)
        for b in mkey[ai + 1 :]
        if b in adj.get(a, set())
    )
    return (k, mkey, intra)


def _stage_row(
    members: np.ndarray, k: int, adj: dict[int, set[int]], pair_level
) -> dict:
    """Stage one neighborhood's padded row tensors (the per-row work of
    :func:`pack_cover`, shared with the :class:`CoverDelta` splice path)."""
    members = members[:k]  # safety clip (build_cover respects k_max)
    P = pairlib.num_pairs(k)
    ii, jj = pairlib.triu_indices(k)

    ids = np.full(k, -1, dtype=np.int64)
    ids[: len(members)] = members
    emask = ids >= 0
    co = np.zeros((k, k), dtype=bool)
    for a_slot in range(len(members)):
        a = int(members[a_slot])
        nbrs = adj.get(a, set())
        for b_slot in range(a_slot + 1, len(members)):
            if int(members[b_slot]) in nbrs:
                co[a_slot, b_slot] = True
                co[b_slot, a_slot] = True

    lev = np.zeros(P, dtype=np.int8)
    gid = np.full(P, -1, dtype=np.int64)
    pmask = np.zeros(P, dtype=bool)
    for p in range(P):
        i, j = int(ii[p]), int(jj[p])
        if not (emask[i] and emask[j]):
            continue
        a, b = int(ids[i]), int(ids[j])
        lv = pair_level(a, b)
        if lv >= 1:
            lev[p] = lv
            gid[p] = pairlib.make_gid(a, b)
            pmask[p] = True
    return dict(ids=ids, emask=emask, co=co, lev=lev, gid=gid, pmask=pmask)


def _stack_rows(rows: list[dict]) -> NeighborhoodBatch:
    return NeighborhoodBatch(
        entity_ids=np.stack([r["ids"] for r in rows]),
        entity_mask=np.stack([r["emask"] for r in rows]),
        coauthor=np.stack([r["co"] for r in rows]),
        sim_level=np.stack([r["lev"] for r in rows]),
        pair_gid=np.stack([r["gid"] for r in rows]),
        pair_mask=np.stack([r["pmask"] for r in rows]),
    )


def pack_cover(
    cover: Cover,
    entities: EntityTable,
    relations: Relations,
    *,
    k_bins: tuple[int, ...] = DEFAULT_BINS,
    thresholds=simlib.DEFAULT_THRESHOLDS,
    boundary_relation: str = "coauthor",
    level_cache: dict[int, int] | None = None,
    row_cache: dict[tuple, dict] | None = None,
    delta: "CoverDelta | None" = None,
    prev: "PackedCover | None" = None,
) -> PackedCover:
    """Pack a cover into size-binned padded tensors.

    ``level_cache`` and ``row_cache`` are optional *persistent* caches
    for the streaming path: ``level_cache`` memoizes the host-side
    Jaro-Winkler discretization per global pair (a pure memo — the
    streaming layer may bound it, see ``DeltaCover.level_cache_max``),
    and ``row_cache`` memoizes fully staged neighborhood rows keyed by
    ``(k, members, intra-relation edges)`` — a key that changes whenever
    anything that feeds the row tensors changes, so stale entries can
    never be reused.  Batch callers omit both and get the original
    behavior; repacking after a micro-batch only stages rows for
    new/changed neighborhoods ("repack only affected bins").

    ``delta``/``prev`` select the incremental splice path: ``delta`` is
    the persistent :class:`CoverDelta` whose :meth:`CoverDelta.assemble`
    produced ``cover``, and ``prev`` is the previous :class:`PackedCover`
    whose per-bin arrays are reused wholesale (unchanged bins) or spliced
    (only freshly staged rows recomputed) — bit-for-bit equal to the
    scratch pack, at O(dirty) staging cost per ingest.
    """
    if delta is not None:
        return delta.pack(cover, prev=prev, level_cache=level_cache)
    adj = relations.adjacency_sets(boundary_relation)
    if level_cache is None:
        level_cache = {}
    pair_level = _pair_level_fn(entities.names, thresholds, level_cache)

    n_nb = len(cover)
    neighborhood_bin = np.zeros(n_nb, dtype=np.int64)
    neighborhood_row = np.zeros(n_nb, dtype=np.int64)
    staged: dict[int, list[dict]] = {k: [] for k in k_bins}
    row_keys: list[tuple] | None = [] if row_cache is not None else None

    for n, members in enumerate(cover.full):
        k = _bin_of(len(members), k_bins)

        row = None
        row_key = None
        if row_cache is not None:
            row_key = _row_key(members, k, adj)
            row_keys.append(row_key)
            row = row_cache.get(row_key)
        if row is None:
            row = _stage_row(members, k, adj, pair_level)
            if row_cache is not None:
                row_cache[row_key] = row

        neighborhood_bin[n] = k
        neighborhood_row[n] = len(staged[k])
        staged[k].append(row)

    bins: dict[int, NeighborhoodBatch] = {}
    bin_rows: dict[int, np.ndarray] = {}
    for k, rows in staged.items():
        if not rows:
            continue
        bins[k] = _stack_rows(rows)
        bin_rows[k] = np.where(neighborhood_bin == k)[0]

    # pair_levels must reflect pairs co-resident in *this* cover — not the
    # level cache, which on the streaming path persists across covers and
    # would leak retracted candidate pairs into the global grounding.
    pair_levels: dict[int, int] = {}
    for rows in staged.values():
        for r in rows:
            for g, lv in zip(r["gid"][r["pmask"]], r["lev"][r["pmask"]]):
                pair_levels[int(g)] = int(lv)
    return PackedCover(
        bins=bins,
        bin_rows=bin_rows,
        neighborhood_bin=neighborhood_bin,
        neighborhood_row=neighborhood_row,
        pair_levels=pair_levels,
        cover=cover,
        row_keys=row_keys,
    )


# ---------------------------------------------------------------------------
# Incremental cover assembly + packed-array splicing (the CoverDelta path)
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class _Part:
    """One memoized canopy part: a neighborhood candidate keyed by its
    sorted core-member tuple, shared by every canopy that emits it."""

    core: np.ndarray
    full: np.ndarray
    row_key: tuple
    emitters: set[int]  # seeds whose canopy emits this part


class CoverDelta:
    """Persistent incremental cover assembly + packed-array splice state.

    The scratch build (:func:`assemble_cover` + :func:`pack_cover`) is a
    deterministic function of ``(canopies, names, relations, present)``;
    every stage decomposes over a local neighborhood of the input, so a
    micro-batch that touches a small entity set can only change a small
    slice of the output.  This class memoizes each stage and re-derives
    only that slice:

    * **canopy parts** — split windows + boundary expansion are memoized
      per canopy seed; a canopy is re-derived only when a member is in
      ``touched`` (canopy re-swept, or a member gained a relation edge).
      Part content is keyed by the sorted core tuple, so the
      first-occurrence dedup of the scratch build becomes "owner =
      minimum emitting seed" (canopies arrive in seed order).
    * **totality sweep** (Def. 7) — per-edge cover counts are maintained
      under part adds/retires and new edges; the supplementary edge
      groups are re-packed only when the missing-edge set changes, and
      diffed by content so unchanged groups are never re-staged.
    * **leftover chunks** — per-entity cover counts maintain the
      uncovered set; chunks are re-packed on change and diffed likewise.
    * **row staging + packing** — rows are staged once per row key
      ``(k, members, intra-edges)`` and spliced into the per-bin padded
      arrays: an untouched bin is reused wholesale, an appended-to bin
      writes only the fresh tail into its capacity-doubling backing
      buffer (published arrays are views; growth copies are amortized
      O(1) per appended row — ``total_growth_copy_rows`` counts them),
      and only a bin whose row sequence changed mid-way is re-stacked
      into a fresh buffer (from memoized rows — no re-staging).
    * **incidence lookups** — ``gid -> row keys`` and ``entity -> row
      keys`` refcount maps are maintained in the same acquire/release
      loops and attached to the packed cover (``PackedCover.
      slot_lookup``), so evidence-driven re-activation queries
      (``neighborhoods_of_slot_pairs`` / ``neighborhoods_of_pairs`` /
      ``neighborhoods_of_entities``) resolve per query instead of
      rebuilding the O(total slots) CSR or the O(n) entity index per
      ingest.
    * **boundary adjacency** — maintained incrementally from
      ``new_edges`` with the same per-edge insertion sequence as
      ``Relations.adjacency_sets`` over the concatenated chunks
      (identical set iteration order, so boundary-ranking tie-breaks
      match the scratch build bit-for-bit) — no per-ingest O(E)
      rebuild.

    The result is bit-for-bit equal to the scratch build at every ingest
    (differential-tested against the reference in
    ``tests/test_torch_stream.py``) with staging work
    proportional to the dirty set: ``last_splice_rows`` counts the rows
    actually (re)staged, the quantity the streaming service reports as
    ``IngestReport.cover_splice_rows``.

    Single boundary relation only: the totality bookkeeping tracks the
    relation whose edges arrive via ``new_edges``, matching the scratch
    build's use of one ``boundary_relation`` (the repo's corpora have
    exactly one relation).
    """

    def __init__(
        self,
        *,
        k_max: int = 32,
        k_bins: tuple[int, ...] = DEFAULT_BINS,
        thresholds=None,
        boundary_relation: str = "coauthor",
    ):
        self.k_max = k_max
        self.k_bins = k_bins
        self.thresholds = thresholds or simlib.DEFAULT_THRESHOLDS
        self.boundary_relation = boundary_relation
        # canopy-level memo
        self._seed_parts: dict[int, list[tuple]] = {}  # seed -> part keys
        self._seed_members: dict[int, np.ndarray] = {}
        self._member_seeds: dict[int, set[int]] = {}  # entity -> seeds
        # part-level memo
        self._parts: dict[tuple, _Part] = {}
        self._containers: dict[int, set[tuple]] = {}  # entity -> part keys
        # totality (Def. 7) bookkeeping
        self._all_edges: set[tuple[int, int]] = set()
        self._edge_cov: dict[tuple[int, int], int] = {}
        self._missing: set[tuple[int, int]] = set()
        self._groups: list[np.ndarray] = []
        self._group_keys: list[tuple] = []
        self._group_row_keys: list[tuple] = []
        self._group_containers: dict[int, set[tuple]] = {}
        # entity coverage / leftovers
        self._present: set[int] = set()
        self._cov_cnt: dict[int, int] = {}
        self._uncovered: set[int] = set()
        self._chunks: list[np.ndarray] = []
        self._chunk_keys: list[tuple] = []
        self._chunk_row_keys: list[tuple] = []
        # staged rows + reference counts
        self._rows: dict[tuple, dict] = {}
        self._row_ref: dict[tuple, int] = {}
        self._lev_ref: dict[int, int] = {}
        self._pair_levels: dict[int, int] = {}
        # splice-maintained incidence refcounts (candidate gid -> row
        # keys, entity -> row keys), updated in the same acquire/release
        # loops as _lev_ref — the query side of
        # PackedCover.neighborhoods_of_{slot_pairs,pairs,entities}.
        self._gid_rows: dict[int, dict[tuple, int]] = {}
        self._ent_rows: dict[int, dict[tuple, int]] = {}
        # per-bin packed splice state: published arrays are views into
        # capacity-doubling backing buffers (appends write only the
        # fresh tail; growth copies are amortized O(appended rows))
        self._bin_seq: dict[int, list[tuple]] = {}
        self._bin_arrays: dict[int, NeighborhoodBatch] = {}
        self._bin_buf: dict[int, dict[str, np.ndarray]] = {}
        # assemble -> pack handoff + per-ingest outputs
        self._pending: tuple | None = None
        self._adj: dict[int, set[int]] = {}
        self._names: list = []
        self.last_dirty: list[int] = []
        self.last_splice_rows = 0
        self.total_splice_rows = 0
        self.last_append_rows = 0
        self.total_append_rows = 0
        self.last_growth_copy_rows = 0
        self.total_growth_copy_rows = 0
        self.last_restack_rows = 0
        self.total_restack_rows = 0
        self.last_added_pairs: dict[int, int] = {}
        self.last_retracted_pairs: list[int] = []

    # -- count maintenance helpers ---------------------------------------

    def _cov_delta(self, e: int, d: int) -> None:
        t = txn.active()
        if t is not None:
            t.save_key(self._cov_cnt, e)
        c = self._cov_cnt.get(e, 0) + d
        if c:
            self._cov_cnt[e] = c
            if e in self._uncovered:
                if t is not None:
                    t.set_discard(self._uncovered, e)
                else:
                    self._uncovered.discard(e)
                self._chunks_stale = True
        else:
            self._cov_cnt.pop(e, None)
            if e in self._present and e not in self._uncovered:
                if t is not None:
                    t.set_add(self._uncovered, e)
                else:
                    self._uncovered.add(e)
                self._chunks_stale = True

    def _edge_delta(self, e: tuple[int, int], d: int) -> None:
        t = txn.active()
        if t is not None:
            t.save_key(self._edge_cov, e)
        c = self._edge_cov.get(e, 0) + d
        self._edge_cov[e] = c
        if c == 0 and e not in self._missing:
            if t is not None:
                t.set_add(self._missing, e)
            else:
                self._missing.add(e)
            self._missing_stale = True
        elif c > 0 and e in self._missing:
            if t is not None:
                t.set_discard(self._missing, e)
            else:
                self._missing.discard(e)
            self._missing_stale = True

    def _full_edges(self, full: np.ndarray):
        """Canonical relation edges with both endpoints in ``full``."""
        fset = set(int(e) for e in full)
        for a in fset:
            for b in self._adj.get(a, ()):
                if a < b and b in fset:
                    yield (a, b)

    @staticmethod
    def _ref_add(index: dict, key, rk: tuple) -> None:
        t = txn.active()
        if t is not None and key not in index:
            t.save_key(index, key)
        d = index.setdefault(key, {})
        if t is not None:
            t.save_key(d, rk)
        d[rk] = d.get(rk, 0) + 1

    @staticmethod
    def _ref_sub(index: dict, key, rk: tuple) -> None:
        t = txn.active()
        d = index[key]
        if t is not None:
            t.save_key(d, rk)
        c = d[rk] - 1
        if c:
            d[rk] = c
        else:
            del d[rk]
            if not d:
                if t is not None:
                    t.save_key(index, key)
                del index[key]

    def _add_part(self, key: tuple, window: np.ndarray, s: int) -> None:
        t = txn.active()
        part = self._parts.get(key)
        if part is not None:
            if t is not None:
                t.set_add(part.emitters, s)
            else:
                part.emitters.add(s)
            return
        core, full = _expand_part(window, self._adj, self.k_max)
        rk = _row_key(full, _bin_of(len(full), self.k_bins), self._adj)
        if t is not None:
            t.save_key(self._parts, key)
        self._parts[key] = _Part(core, full, rk, {s})
        for e in map(int, full):
            if t is not None:
                t.save_key(self._containers, e, copy=set)
            self._containers.setdefault(e, set()).add(key)
            self._cov_delta(e, +1)
        for edge in self._full_edges(full):
            self._edge_delta(edge, +1)
        self._acquires.append(rk)

    def _drop_part(self, key: tuple, s: int) -> None:
        t = txn.active()
        part = self._parts[key]
        if t is not None:
            t.set_discard(part.emitters, s)
        else:
            part.emitters.discard(s)
        if part.emitters:
            return
        for e in map(int, part.full):
            cs = self._containers.get(e)
            if cs is not None:
                if t is not None:
                    t.save_key(self._containers, e, copy=set)
                cs.discard(key)
                if not cs:
                    del self._containers[e]
            self._cov_delta(e, -1)
        for edge in self._full_edges(part.full):
            self._edge_delta(edge, -1)
        self._releases.append(part.row_key)
        if t is not None:
            t.save_key(self._parts, key)
        del self._parts[key]

    # -- assemble ---------------------------------------------------------

    def assemble(
        self,
        canopies: list[np.ndarray],
        seeds: list[int],
        entities: EntityTable,
        relations: Relations | None = None,
        *,
        present,  # any sized collection of the current ids (len-only use)
        touched: set[int],
        new_ids: list[int],
        new_edges: np.ndarray | None,
    ) -> Cover:
        """Incrementally re-derive the total cover after an ingest.

        ``canopies``/``seeds`` are the full current canopy list in seed
        order (clean entries are memo hits); ``touched`` is the set of
        entity ids whose similarity region was re-swept or that gained a
        relation edge this ingest.  Equal to the scratch
        :func:`assemble_cover` over the same inputs.

        ``relations`` is accepted for API symmetry with the scratch path
        but unused: the boundary adjacency is maintained incrementally
        from ``new_edges`` (every relation edge must arrive through it
        exactly once, like every id through ``new_ids``), inserted with
        the same per-edge ``a -> b, b -> a`` sequence in arrival order
        as ``Relations.adjacency_sets`` runs over the concatenated edge
        chunks — identical set insertion history, hence identical set
        iteration order, so the boundary-expansion tie-breaks stay
        bit-for-bit the scratch build's without the per-ingest O(E)
        adjacency rebuild.
        """
        t = txn.active()
        if t is not None:
            # wholesale attribute rebinds below (and in pack) — journal
            # the pre-ingest references once up front; entry-level
            # writes are journaled at their mutation sites
            for a in (
                "_names", "_pending", "_acquires", "_releases",
                "_missing_stale", "_chunks_stale",
                "_groups", "_group_keys", "_group_row_keys",
                "_chunks", "_chunk_keys", "_chunk_row_keys",
            ):
                t.save_attr(self, a)
        if new_edges is not None and len(new_edges):
            for x, y in np.asarray(new_edges, dtype=np.int64):
                x, y = int(x), int(y)
                if x == y:
                    continue  # rejected upstream; adjacency must not self-link
                if t is not None:
                    t.save_key(self._adj, x, copy=set)
                    t.save_key(self._adj, y, copy=set)
                self._adj.setdefault(x, set()).add(y)
                self._adj.setdefault(y, set()).add(x)
        self._names = entities.names
        k_core = max(2, int(self.k_max * 0.6))
        self._acquires: list[tuple] = []
        self._releases: list[tuple] = []
        self._missing_stale = False
        self._chunks_stale = False
        stale_parts: set[tuple] = set()
        stale_groups: set[tuple] = set()

        # 0. present growth: new ids start uncovered until a part/group
        # claims them.
        for e in new_ids:
            e = int(e)
            if t is not None:
                t.set_add(self._present, e)
            else:
                self._present.add(e)
            if self._cov_cnt.get(e, 0) == 0 and e not in self._uncovered:
                if t is not None:
                    t.set_add(self._uncovered, e)
                else:
                    self._uncovered.add(e)
                self._chunks_stale = True
        # the caller's universe must be exactly the accumulated new_ids:
        # this class supports growth only (no entity eviction), and the
        # leftover chunks are computed from the internal set.  The guard
        # is O(1) by design (an O(n) set comparison per ingest would
        # reintroduce the corpus-sized pass this class exists to remove),
        # so it catches shrinkage/extra ids by cardinality only — an
        # equal-cardinality divergence is on the caller (DeltaCover
        # passes the very set new_ids accumulated into).
        if len(present) != len(self._present):
            raise ValueError(
                f"present has {len(present)} ids but {len(self._present)} "
                "were accumulated via new_ids — CoverDelta tracks a "
                "grow-only universe"
            )

        # 1. new relation edges: initial cover counts from the container
        # index, and row-key staleness for neighborhoods that hold both
        # endpoints (their coauthor tensor changes even when membership
        # does not).
        if new_edges is not None and len(new_edges):
            for x, y in np.asarray(new_edges, dtype=np.int64):
                x, y = int(x), int(y)
                if x == y:
                    continue
                edge = (x, y) if x < y else (y, x)
                if edge in self._all_edges:
                    continue
                if t is not None:
                    t.set_add(self._all_edges, edge)
                    t.save_key(self._edge_cov, edge)
                else:
                    self._all_edges.add(edge)
                both = self._containers.get(x, set()) & self._containers.get(y, set())
                self._edge_cov[edge] = len(both)
                if not both:
                    if t is not None:
                        t.set_add(self._missing, edge)
                    else:
                        self._missing.add(edge)
                    self._missing_stale = True
                stale_parts |= both
                stale_groups |= self._group_containers.get(
                    x, set()
                ) & self._group_containers.get(y, set())

        # 2. dirty canopies: any canopy with a touched member (re-swept
        # region, or a member that gained an edge — boundary expansion
        # and clip ranking read members' adjacency only).
        seed_arr = np.asarray(seeds, dtype=np.int64)

        def _seed_pos(e: int) -> int:
            p = int(np.searchsorted(seed_arr, e))
            return p if p < len(seed_arr) and int(seed_arr[p]) == e else -1

        dirty_seeds: set[int] = set()
        for e in touched:
            dirty_seeds |= self._member_seeds.get(e, set())
            if _seed_pos(e) >= 0:
                dirty_seeds.add(e)

        # per-seed diff: windows whose core avoids `touched` and is kept
        # by the new split are reused without any churn.
        plans: list[tuple[int, list[tuple], list[tuple[tuple, np.ndarray]]]] = []
        for s in sorted(dirty_seeds):
            pos = _seed_pos(s)
            old_keys = self._seed_parts.get(s, [])
            new_parts: list[tuple[tuple, np.ndarray]] = []
            if pos >= 0:
                members = canopies[pos]
                for win in _split_oversized(members, self._names, k_core):
                    if len(win) < 2:
                        continue
                    new_parts.append((tuple(sorted(int(e) for e in win)), win))
            new_key_set = {k for k, _ in new_parts}
            kept = {
                k
                for k in old_keys
                if k in new_key_set and not any(e in touched for e in k)
            }
            # update the canopy-member index
            for e in map(int, self._seed_members.get(s, ())):
                ms = self._member_seeds.get(e)
                if ms is not None:
                    if t is not None:
                        t.save_key(self._member_seeds, e, copy=set)
                    ms.discard(s)
                    if not ms:
                        del self._member_seeds[e]
            if t is not None:
                t.save_key(self._seed_members, s)
                t.save_key(self._seed_parts, s)
            if pos >= 0:
                self._seed_members[s] = canopies[pos]
                for e in map(int, canopies[pos]):
                    if t is not None:
                        t.save_key(self._member_seeds, e, copy=set)
                    self._member_seeds.setdefault(e, set()).add(s)
                self._seed_parts[s] = [k for k, _ in new_parts]
            else:
                self._seed_members.pop(s, None)
                self._seed_parts.pop(s, None)
            plans.append((s, [k for k in old_keys if k not in kept],
                          [(k, w) for k, w in new_parts if k not in kept]))

        # two-phase apply: all drops, then all adds — a part key shared
        # by several dirty canopies is fully retired before any emitter
        # re-stages it against the current adjacency.
        for s, drops, _ in plans:
            for key in drops:
                self._drop_part(key, s)
        for s, _, adds in plans:
            for key, win in adds:
                self._add_part(key, win, s)

        # 3. stale row keys: surviving parts whose intra-edge set grew.
        for key in stale_parts:
            part = self._parts.get(key)
            if part is None:
                continue
            rk = _row_key(part.full, _bin_of(len(part.full), self.k_bins), self._adj)
            if rk != part.row_key:
                self._releases.append(part.row_key)
                self._acquires.append(rk)
                if t is not None:
                    t.save_attr(part, "row_key")
                part.row_key = rk

        # 4. totality groups (re-packed only when the missing set moved).
        if self._missing_stale:
            new_groups = _pack_edge_groups(self._missing, self.k_max)
            new_keys = [tuple(int(e) for e in g) for g in new_groups]
            old = dict(zip(self._group_keys, zip(self._groups, self._group_row_keys)))
            new_key_set = set(new_keys)
            for gk, (_, rk) in old.items():
                if gk not in new_key_set:
                    for e in gk:
                        gc = self._group_containers.get(e)
                        if gc is not None:
                            if t is not None:
                                t.save_key(self._group_containers, e, copy=set)
                            gc.discard(gk)
                            if not gc:
                                del self._group_containers[e]
                        self._cov_delta(e, -1)
                    self._releases.append(rk)
            groups: list[np.ndarray] = []
            group_row_keys: list[tuple] = []
            for gk, arr in zip(new_keys, new_groups):
                hit = old.get(gk)
                if hit is not None:
                    arr, rk = hit
                else:
                    rk = _row_key(arr, _bin_of(len(arr), self.k_bins), self._adj)
                    for e in gk:
                        if t is not None:
                            t.save_key(self._group_containers, e, copy=set)
                        self._group_containers.setdefault(e, set()).add(gk)
                        self._cov_delta(e, +1)
                    self._acquires.append(rk)
                groups.append(arr)
                group_row_keys.append(rk)
            self._groups, self._group_keys = groups, new_keys
            self._group_row_keys = group_row_keys
        for gk in stale_groups:
            try:
                i = self._group_keys.index(gk)
            except ValueError:
                continue
            rk = _row_key(
                self._groups[i], _bin_of(len(self._groups[i]), self.k_bins), self._adj
            )
            if rk != self._group_row_keys[i]:
                self._releases.append(self._group_row_keys[i])
                self._acquires.append(rk)
                if t is not None:
                    t.save_item(self._group_row_keys, i)
                self._group_row_keys[i] = rk

        # 5. leftover chunks.
        if self._chunks_stale:
            new_chunks = _pack_leftover_chunks(sorted(self._uncovered), self.k_max)
            new_keys = [tuple(int(e) for e in c) for c in new_chunks]
            old = dict(zip(self._chunk_keys, zip(self._chunks, self._chunk_row_keys)))
            new_key_set = set(new_keys)
            for ck, (_, rk) in old.items():
                if ck not in new_key_set:
                    self._releases.append(rk)
            chunks: list[np.ndarray] = []
            chunk_row_keys: list[tuple] = []
            for ck, arr in zip(new_keys, new_chunks):
                hit = old.get(ck)
                if hit is not None:
                    arr, rk = hit
                else:
                    rk = _row_key(arr, _bin_of(len(arr), self.k_bins), self._adj)
                    self._acquires.append(rk)
                chunks.append(arr)
                chunk_row_keys.append(rk)
            self._chunks, self._chunk_keys = chunks, new_keys
            self._chunk_row_keys = chunk_row_keys

        # 6. walk: first-occurrence order over canopies (owner = minimum
        # emitting seed), then totality groups, then leftover chunks —
        # exactly the scratch emission order.
        core_list: list[np.ndarray] = []
        full_list: list[np.ndarray] = []
        keys: list[tuple] = []
        for s in seeds:
            for key in self._seed_parts.get(int(s), ()):
                part = self._parts[key]
                if min(part.emitters) == s:
                    core_list.append(part.core)
                    full_list.append(part.full)
                    keys.append(part.row_key)
        for arr, rk in zip(self._groups, self._group_row_keys):
            core_list.append(arr)
            full_list.append(arr)
            keys.append(rk)
        for arr, rk in zip(self._chunks, self._chunk_row_keys):
            core_list.append(arr)
            full_list.append(arr)
            keys.append(rk)
        cover = Cover(core=core_list, full=full_list)
        self._pending = (cover, keys)
        return cover

    # -- packed-array backing buffers -------------------------------------

    _ROW_FIELDS = (
        ("entity_ids", "ids"), ("entity_mask", "emask"), ("coauthor", "co"),
        ("sim_level", "lev"), ("pair_gid", "gid"), ("pair_mask", "pmask"),
    )

    def _alloc_buf(self, proto_key: tuple, n: int) -> dict[str, np.ndarray]:
        """Fresh backing buffers shaped like ``proto_key``'s staged row,
        capacity = pow2 >= n."""
        proto = self._rows[proto_key]
        cap = 1 << max(n - 1, 0).bit_length()
        return {
            f: np.empty((cap,) + proto[rf].shape, proto[rf].dtype)
            for f, rf in self._ROW_FIELDS
        }

    def _publish(self, buf: dict[str, np.ndarray], n: int) -> NeighborhoodBatch:
        return NeighborhoodBatch(**{f: buf[f][:n] for f, _ in self._ROW_FIELDS})

    def _bin_append(self, k: int, seq: list[tuple], n0: int) -> NeighborhoodBatch:
        """Append ``seq[n0:]`` to bin ``k``'s buffer: O(fresh rows) writes.

        Rows ``[:n0]`` are already in the buffer (and published as views
        by the previous pack — append never touches them).  When the
        tail outgrows capacity the buffer doubles and the resident rows
        are copied once — amortized O(1) copies per appended row, vs the
        O(bin) memcpy of the former per-append ``np.concatenate``.

        Under an ingest transaction the tail writes themselves need no
        journal: rows ``>= n0`` sit beyond every published view, so a
        rollback (which restores ``_bin_seq``/``_bin_arrays``) leaves
        them unobservable, and the next append to this bin starts from
        the same ``n0`` and overwrites them.  Only the buffer *rebind*
        on growth is journaled.
        """
        t = txn.active()
        n1 = len(seq)
        buf = self._bin_buf[k]
        if next(iter(buf.values())).shape[0] < n1:
            new = self._alloc_buf(seq[0], n1)
            for f, _ in self._ROW_FIELDS:
                new[f][:n0] = buf[f][:n0]
            self.last_growth_copy_rows += n0
            if t is not None:
                t.save_key(self._bin_buf, k)
            self._bin_buf[k] = buf = new
        for i in range(n0, n1):
            row = self._rows[seq[i]]
            for f, rf in self._ROW_FIELDS:
                buf[f][i] = row[rf]
        self.last_append_rows += n1 - n0
        return self._publish(buf, n1)

    def _bin_restack(self, k: int, seq: list[tuple]) -> NeighborhoodBatch:
        """Rebuild bin ``k`` from memoized rows into a FRESH buffer (the
        row sequence changed mid-way, or the bin is new) — never in
        place, since a previous pack's views alias the old buffer."""
        t = txn.active()
        buf = self._alloc_buf(seq[0], len(seq))
        for i, rk in enumerate(seq):
            row = self._rows[rk]
            for f, rf in self._ROW_FIELDS:
                buf[f][i] = row[rf]
        if t is not None:
            t.save_key(self._bin_buf, k)
        self._bin_buf[k] = buf
        self.last_restack_rows += len(seq)
        return self._publish(buf, len(seq))

    # -- pack -------------------------------------------------------------

    def pack(
        self,
        cover: Cover,
        *,
        prev: PackedCover | None = None,
        level_cache: dict[int, int] | None = None,
    ) -> PackedCover:
        """Splice the packed arrays for the cover built by :meth:`assemble`.

        Only rows whose key is new this ingest are staged
        (``last_splice_rows``); per-bin arrays are reused outright when
        the bin's row sequence is unchanged, extended by one concatenate
        when rows were only appended, and re-stacked from memoized rows
        otherwise.  ``prev`` (the previous packed cover) is accepted for
        API symmetry — the splice state lives on this object.
        """
        assert self._pending is not None and self._pending[0] is cover, (
            "pack() must follow the assemble() that built this cover"
        )
        t = txn.active()
        if t is not None:
            for a in (
                "_pending", "_bin_seq", "_bin_arrays", "_bin_buf",
                "last_dirty", "last_splice_rows", "total_splice_rows",
                "last_append_rows", "total_append_rows",
                "last_growth_copy_rows", "total_growth_copy_rows",
                "last_restack_rows", "total_restack_rows",
                "last_added_pairs", "last_retracted_pairs",
            ):
                t.save_attr(self, a)
        _, keys = self._pending
        self._pending = None
        pair_level = _pair_level_fn(
            self._names, self.thresholds, level_cache if level_cache is not None else {}
        )

        # 1. stage rows for acquired keys not yet memoized (the O(dirty)
        # work) — members are recoverable from the row key itself.
        splice_rows = 0
        for rk in self._acquires:
            if rk not in self._rows:
                members = np.asarray(rk[1], dtype=np.int64)
                if t is not None:
                    t.save_key(self._rows, rk)
                self._rows[rk] = _stage_row(members, rk[0], self._adj, pair_level)
                splice_rows += 1

        # 2. reference counting: batch-apply releases then acquires; a
        # key is *fresh* (dirty) iff it was absent from the previous
        # cover, i.e. its refcount was zero and not because this very
        # ingest released it.
        released_to_zero: set[tuple] = set()
        gid_removed: set[int] = set()
        fresh_keys: set[tuple] = set()
        gid_fresh: set[int] = set()
        for rk in self._releases:
            if t is not None:
                t.save_key(self._row_ref, rk)
            self._row_ref[rk] -= 1
            if self._row_ref[rk] == 0:
                released_to_zero.add(rk)
            row = self._rows[rk]
            for g in row["gid"][row["pmask"]]:
                g = int(g)
                if t is not None:
                    t.save_key(self._lev_ref, g)
                self._lev_ref[g] -= 1
                if self._lev_ref[g] == 0:
                    gid_removed.add(g)
                self._ref_sub(self._gid_rows, g, rk)
            for e in rk[1]:
                self._ref_sub(self._ent_rows, e, rk)
        for rk in self._acquires:
            ref = self._row_ref.get(rk, 0)
            if ref == 0 and rk not in released_to_zero:
                fresh_keys.add(rk)
            if t is not None:
                t.save_key(self._row_ref, rk)
            self._row_ref[rk] = ref + 1
            row = self._rows[rk]
            for g, lv in zip(row["gid"][row["pmask"]], row["lev"][row["pmask"]]):
                g = int(g)
                ref_g = self._lev_ref.get(g, 0)
                if t is not None:
                    t.save_key(self._lev_ref, g)
                if ref_g == 0:
                    if t is not None:
                        t.save_key(self._pair_levels, g)
                    self._pair_levels[g] = int(lv)
                    if g not in gid_removed:
                        gid_fresh.add(g)
                self._lev_ref[g] = ref_g + 1
                self._ref_add(self._gid_rows, g, rk)
            for e in rk[1]:
                self._ref_add(self._ent_rows, e, rk)
        retracted = [g for g in gid_removed if self._lev_ref.get(g, 0) == 0]
        for g in retracted:
            if t is not None:
                t.save_key(self._pair_levels, g)
                t.save_key(self._lev_ref, g)
            del self._pair_levels[g]
            del self._lev_ref[g]
        added = {g: self._pair_levels[g] for g in gid_fresh}

        # 3. bin sequences + neighborhood indices (+ the row-key ->
        # positions map that resolves the splice-maintained incidence
        # lookups — built inside the walk pack already does).
        n_nb = len(keys)
        neighborhood_bin = np.zeros(n_nb, dtype=np.int64)
        neighborhood_row = np.zeros(n_nb, dtype=np.int64)
        bin_seqs: dict[int, list[tuple]] = {}
        pos_of_key: dict[tuple, list[int]] = {}
        for n, rk in enumerate(keys):
            k = rk[0]
            seq = bin_seqs.setdefault(k, [])
            neighborhood_bin[n] = k
            neighborhood_row[n] = len(seq)
            seq.append(rk)
            pos_of_key.setdefault(rk, []).append(n)

        # 4. per-bin splice: reuse / append / re-stack, against
        # capacity-doubling backing buffers (appends write only the
        # fresh tail rows; published arrays are views, so rows already
        # visible to a previous PackedCover are never overwritten).
        self.last_append_rows = 0
        self.last_growth_copy_rows = 0
        self.last_restack_rows = 0
        bins: dict[int, NeighborhoodBatch] = {}
        for k, seq in bin_seqs.items():
            old_seq = self._bin_seq.get(k)
            old_arr = self._bin_arrays.get(k)
            if old_arr is not None and old_seq == seq:
                bins[k] = old_arr
            elif (
                old_arr is not None
                and len(seq) > len(old_seq)
                and seq[: len(old_seq)] == old_seq
            ):
                bins[k] = self._bin_append(k, seq, len(old_seq))
            else:
                bins[k] = self._bin_restack(k, seq)
        self._bin_seq = bin_seqs
        self._bin_arrays = dict(bins)
        self._bin_buf = {k: b for k, b in self._bin_buf.items() if k in bins}
        self.total_append_rows += self.last_append_rows
        self.total_growth_copy_rows += self.last_growth_copy_rows
        self.total_restack_rows += self.last_restack_rows
        bin_rows = {k: np.where(neighborhood_bin == k)[0] for k in bins}

        # 5. evict rows that left the cover; publish per-ingest outputs.
        for rk in released_to_zero:
            if self._row_ref.get(rk, 0) == 0:
                if t is not None:
                    t.save_key(self._rows, rk)
                    t.save_key(self._row_ref, rk)
                self._rows.pop(rk, None)
                self._row_ref.pop(rk, None)
        self.last_dirty = [n for n, rk in enumerate(keys) if rk in fresh_keys]
        self.last_splice_rows = splice_rows
        self.total_splice_rows += splice_rows
        self.last_added_pairs = added
        self.last_retracted_pairs = retracted
        # registry-backed view of the splice accounting (cover.* family):
        # cumulative counterparts of the per-ingest last_* fields above
        reg = get_registry()
        reg.counter("cover.splice_rows").inc(splice_rows)
        reg.counter("cover.append_rows").inc(self.last_append_rows)
        reg.counter("cover.growth_copy_rows").inc(self.last_growth_copy_rows)
        reg.counter("cover.restack_rows").inc(self.last_restack_rows)
        self._acquires = []
        self._releases = []
        return PackedCover(
            bins=bins,
            bin_rows=bin_rows,
            neighborhood_bin=neighborhood_bin,
            neighborhood_row=neighborhood_row,
            pair_levels=dict(self._pair_levels),
            cover=cover,
            row_keys=list(keys),
            slot_lookup=(self._gid_rows, self._ent_rows, pos_of_key),
        )
