"""Round-parallel message passing on one GPU (paper §6.3), in PyTorch.

The paper parallelizes the framework in *rounds*: every active
neighborhood is evaluated in parallel (Hadoop Map), the new evidence is
collected and broadcast (Reduce), and the next round's active set is
derived.  Here every active row of a size bin is evaluated in one
batched matcher call, so a round costs a few matcher calls (one a bin)
where the sequential drivers (``core.driver``) make one a neighborhood:

* **Grounding cache** (:class:`GroundingCache`): the grounded structures
  (``u``/``u_raw``/``C``/``valid`` for the MLN, ``lev``/``n_shared``/
  ``link``/``valid`` for RULES) are computed once per ``(matcher, bin)``
  and kept on the device across rounds.  Rows are fingerprinted by the
  packer's row keys (or the raw bytes of the tensors the grounding
  reads), so the streaming engine reuses cached bins across ingests and
  *splices* only the dirty rows' freshly grounded tensors into place
  (``rows_ground`` counts exactly the recomputed rows).  Serving memory
  is boundable: an LRU over bins (``capacity`` / ``hbm_budget_bytes``)
  drops cold bins' tensors and re-grounds them on demand, bit for bit.

* **Fused multi-round closure** (:func:`_fused_rounds`): rounds that
  touch no host state — NO-MP/SMP rounds of the greedy and RULES
  matchers, and the greedy re-activation rounds of SMP/MMP with the
  collective MLN — run in one loop that keeps the match bitset, the
  per-bin active sets and their counts on the device.  Its only host
  read is the loop condition: the per-bin active counts, once a round
  (plus the matcher's own change flags).  The next active set is
  derived on the device from the ``uidx`` slot incidence of the newly
  set bits.  One such loop counts as one dispatch, as the reference's
  ``while_loop`` program does.

* **Quiescence points**: only MMP's maximal-message *pool merge*
  (Algorithm 3 keeps it on the coordinator) runs on the host.  Full
  rounds evaluate each bin's active rows in one call, component labels
  are turned into messages by batched numpy segment ops
  (``driver._labels_to_messages``), and the step-7 promotion fixpoint
  runs batched on the device (:class:`DevicePromoter`): no host walk
  over the global coupling COO (``EMResult.promote_host_scans`` == 0).

Every evaluation runs only the active rows of a bin (the reference runs
the whole bin under a row mask): lanes never interact — the batched
matcher freezes a converged lane — so ``x``, the labels and the bitset
are those of the masked whole-bin call, and ``evals`` still counts the
active rows.  The padding slots of a row (``uidx == Np``) scatter into
a sink slot ``Np`` that is dropped, where the reference's
``.at[...].max(mode="drop")`` drops them.

Consistency (Thms. 2/4) guarantees the round schedule reaches the same
fixpoint as the sequential drivers: the matcher is monotone, evaluating
a non-incident neighborhood is idempotent, and deferring step-7
promotion to quiescence points composes monotone operators whose least
fixpoint is schedule-invariant.  ``fused=False`` keeps the legacy
per-round host loop (one matcher call a bin a round, re-grounding each
time) as the differential baseline.

**Mesh** (``mesh=``, a :class:`repro_torch.launch.mesh.EMMesh`): the
rank count pads every bin's rows to a multiple of it, and each rank
evaluates only the active rows of its slice of each bin.  The loops are
driven by the host, so the collectives sit where the reference's
``psum``s are: the round's hit bitset is OR-reduced over the ranks once
a round (fused loop, full round, legacy round), after which the bitset
— and so the changed slots, the next active sets and their counts — is
the same on every rank with no second collective; ``evals`` and
``history`` count the rows of every rank.  The per-row labels the host
reads for MMP's messages are all-gathered back to whole bins, padded to
equal slices.  The grounding cache and the promoter stay replicated:
every rank grounds whole bins and takes its slice, so the cache's
counters equal the one-rank run's.  A one-rank mesh (``mesh=None``) has
no collective.  The full round and the legacy round run each bin through
the round functions :func:`build_bin_round_fn` / :func:`build_round_fn`
(one callable per spec, mesh and axes): a rank's rows in; the matcher;
the bitset OR-reduced over ``axes``; on a mesh that spans processes, the
rows' ``x`` and labels all-gathered back to whole bins, as the reference
gathers them in its ``shard_map`` body.  With ``axes=()`` a round
function makes no collective, as the reference's makes none over no
axes: the full round calls them so and makes its own collectives once a
round over all its bins (one bitset reduction, and for MMP one gather of
the labels), where a collective a bin would cost an all-reduce and two
all-gathers per bin.  The legacy round reduces and gathers per bin, as
the reference's does.  The dry run lowers :func:`build_round_fn`'s
callable as its EM cell.  Neither is cached: building the closure costs
nothing (the reference caches a jit compile), and an ``EMMesh`` is hashed
by identity, so a cache would only keep every mesh alive.
"""

from __future__ import annotations

import dataclasses
import functools
import hashlib
import time

import numpy as np
import torch

from repro_torch.core import pairs as pairlib
from repro_torch.core.cover import PackedCover
from repro_torch.core.driver import (
    EMResult,
    MessagePool,
    _labels_to_messages,
    _promote,
    publish_em_result,
)
from repro_torch.core.global_grounding import GlobalGrounding
from repro_torch.core.mln import (
    MLNMatcher,
    MLNWeights,
    _infer,
    closure_batch,
    ground,
    ground_structure,
)
from repro_torch.core.rules import rules_fixpoint_batch
from repro_torch.core.types import MatchStore, NeighborhoodBatch
from repro_torch.kernels.common import (
    host_array,
    mesh_spans_processes,
    put_replicated,
    resolve_device,
)
from repro_torch.launch.mesh import EMMesh, em_service_mesh
from repro_torch.obs import profiler_session, record_transfer
from repro_torch.obs import span as obs_span


def make_em_mesh(n_shards: int | None = None, axis: str = "data", device=None) -> EMMesh:
    """The ``(n,)`` mesh over every rank of this process's group (joined
    by ``launch.mesh.init_em_distributed``), or the one-rank mesh on
    ``device`` when it joined none; ``n_shards`` must be the rank count."""
    return em_service_mesh(n_shards, device, axis)


# ---------------------------------------------------------------------------
# Device-resident grounding cache
# ---------------------------------------------------------------------------


def _matcher_cache_key(matcher) -> tuple[str, object]:
    """Capability dispatch: a device-capable family declares
    ``parallel_backend() -> (kind, cfg)``, the grounding-cache key that
    selects its registered ground function below."""
    pb = getattr(matcher, "parallel_backend", None)
    if pb is not None:
        return pb()
    raise TypeError(
        f"matcher {type(matcher).__name__} has no parallel backend "
        f"(registered grounding kinds: {sorted(_GROUND_BUILDERS)}); "
        "host-only families run through the sequential drivers "
        "(run_nomp / run_smp / run_mmp)"
    )


# kind -> builder(cfg, device) -> fn(entity_ids, entity_mask, coauthor,
# sim_level, pair_mask) -> 4-tuple of (B, ...) tensors on ``device``
# with ``valid`` last.
_GROUND_BUILDERS: dict[str, object] = {}


def register_ground_builder(kind: str, builder) -> None:
    _GROUND_BUILDERS[kind] = builder


def _rows_batch(entity_ids, entity_mask, coauthor, sim_level, pair_mask):
    # grounding reads shapes and masks only: pair_gid is never looked at
    return NeighborhoodBatch(
        entity_ids=entity_ids,
        entity_mask=entity_mask,
        coauthor=coauthor,
        sim_level=sim_level,
        pair_gid=pair_mask,
        pair_mask=pair_mask,
    )


def _mln_ground_builder(weights: MLNWeights, device):
    def f(*rows):
        g = ground(_rows_batch(*rows), weights, device)
        return g.u, g.u_raw, g.C, g.valid

    return f


def _rules_ground_builder(_cfg, device):
    def f(*rows):
        lev, valid, n_shared, link = ground_structure(_rows_batch(*rows), device)
        return lev, n_shared, link, valid

    return f


def _embed_ground_builder(matcher, device):
    """Host grounding for the embedding family: pairwise cosine from the
    matcher's append-only per-id embedding memo, placed on ``device``.
    Pure in the entity ids (embeddings are deterministic per id and
    never mutated), so the grounding-cache splice/LRU contract holds
    exactly as for the other kinds; only dirty rows' ids are ever
    (re-)encoded."""

    def f(entity_ids, entity_mask, coauthor, sim_level, pair_mask):
        base, valid = matcher.ground_rows(
            np.asarray(entity_ids), np.asarray(pair_mask)
        )
        B = base.shape[0]
        return (
            torch.as_tensor(base, device=device),
            torch.as_tensor(valid, device=device),
            torch.zeros((B, 1, 1), dtype=torch.float32, device=device),
            torch.zeros((B, 1), dtype=torch.float32, device=device),
        )

    return f


register_ground_builder("mln", _mln_ground_builder)
register_ground_builder("rules", _rules_ground_builder)
register_ground_builder("embed", _embed_ground_builder)


@functools.lru_cache(maxsize=None)
def _ground_bin_fn(kind: str, cfg, device: torch.device):
    """Bin grounding for one ``(kind, cfg, device)`` key: raw row arrays
    -> tensors on ``device``.

    Returns a uniform 4-tuple with ``valid`` last: MLN bins get
    ``(u, u_raw, C, valid)``, RULES bins ``(lev, n_shared, link,
    valid)``, embedding bins ``(base, valid, 0, 0)``.  ``cfg`` must be
    hashable (weights dataclass, matcher instance, or None): an
    embedding matcher is keyed by identity, so two matchers never share
    a memo.
    """
    if kind not in _GROUND_BUILDERS:
        raise TypeError(
            f"no grounding builder registered for kind {kind!r} "
            f"(registered: {sorted(_GROUND_BUILDERS)})"
        )
    return _GROUND_BUILDERS[kind](cfg, device)


def _pow2(n: int) -> int:
    return 1 << max(n - 1, 0).bit_length() if n else 1


class GroundingCache:
    """Per-bin device-resident grounded structures with splice updates
    and an optional LRU bound on resident device memory.

    ``get`` fingerprints every row by the packer's row key when the
    cover was packed with a ``row_cache`` (``PackedCover.row_keys`` —
    the ``(k, members, intra-edges)`` tuple that by contract changes
    whenever anything feeding the row tensors changes; the streaming
    path always has these), falling back to a fixed-size blake2b digest
    of the raw row bytes for covers packed without a row cache.  An
    unchanged bin is served from cache outright; a bin whose rows
    moved/changed is *spliced* — unchanged rows are gathered from the
    cached tensors, only fresh rows are re-ground, padded to a power of
    two (the reference bounds its compile variants so; here the padding
    keeps the transfer accounting equal to the reference's).  The
    streaming engine holds one cache per service so ingests that leave
    a bin untouched never re-ground it; call :meth:`invalidate` to drop
    everything (e.g. after changing matcher weights in place).

    Entries are keyed by ``((kind, cfg, device), k)``.  Cached tensors
    are never written after they are stored: :meth:`splice` builds new
    ones, so the shallow snapshot of :meth:`journal_rollback` stays an
    exact pre-ingest state.

    **Serving-memory bound** (``capacity`` / ``hbm_budget_bytes``): the
    cached ``(B, P, P)`` coupling tensors dominate device memory, so a
    long-lived service can cap how many bins stay resident.  Entries
    are LRU-ordered by :meth:`get`; inserting past the bound drops the
    coldest bins' tensors (their row signatures are kept — host tuples,
    not device memory).  A later ``get`` of an evicted bin *cold
    re-grounds* it from the raw row arrays — grounding is a pure
    function of those arrays, so the recomputed tensors are bit for bit
    the evicted ones and every fixpoint is unchanged.

    Counters (read by tests, ``EMResult`` and ``IngestReport``):
      ``ground_calls``        grounding calls issued
      ``rows_ground``         rows whose grounding was actually recomputed
      ``bin_hits``            bins served without re-grounding any row
      ``splice_calls``        bins updated via :meth:`splice`
      ``evictions``           bins whose device tensors were LRU-dropped
      ``cold_regrounds``      gets that re-ground an evicted (unchanged) bin
      ``peak_resident_bins``  high-water mark of tensor-resident bins
      ``peak_resident_bytes`` high-water mark of tracked device bytes
    """

    def __init__(self, capacity: int | None = None,
                 hbm_budget_bytes: int | None = None):
        if capacity is not None and capacity < 1:
            raise ValueError(f"GroundingCache capacity must be >= 1: {capacity}")
        if hbm_budget_bytes is not None and hbm_budget_bytes <= 0:
            raise ValueError(
                f"GroundingCache hbm_budget_bytes must be > 0: {hbm_budget_bytes}"
            )
        self.capacity = capacity
        self.hbm_budget_bytes = hbm_budget_bytes
        # key -> (sigs, tensors | None, nbytes); dict order == LRU order
        # (oldest first), tensors None for entries evicted but remembered
        self._bins: dict[tuple, tuple[tuple, tuple | None, int]] = {}
        self.ground_calls = 0
        self.rows_ground = 0
        self.bin_hits = 0
        self.splice_calls = 0
        self.evictions = 0
        self.cold_regrounds = 0
        self.peak_resident_bins = 0
        self.peak_resident_bytes = 0
        # per-run window peak: run_parallel resets it at run start so
        # EMResult can report the residency high-water of THAT run,
        # while peak_resident_bins stays the cache-lifetime mark
        self.window_peak_bins = 0

    @property
    def bounded(self) -> bool:
        return self.capacity is not None or self.hbm_budget_bytes is not None

    @property
    def resident_bins(self) -> int:
        return sum(1 for _, arrays, _ in self._bins.values() if arrays is not None)

    @property
    def resident_bytes(self) -> int:
        return sum(n for _, arrays, n in self._bins.values() if arrays is not None)

    def invalidate(self) -> None:
        self._bins.clear()

    _TXN_COUNTERS = (
        "ground_calls", "rows_ground", "bin_hits", "splice_calls",
        "evictions", "cold_regrounds", "peak_resident_bins",
        "peak_resident_bytes", "window_peak_bins",
    )

    def journal_rollback(self, t) -> None:
        """Register restoration of this cache into an ingest transaction.

        The entry tuples and their tensors are never mutated, so a
        shallow copy of the LRU dict plus the counter values is an exact
        pre-ingest snapshot — O(bins), not O(rows).
        """
        prev_bins = dict(self._bins)
        prev_counters = tuple(getattr(self, c) for c in self._TXN_COUNTERS)

        def undo() -> None:
            self._bins = prev_bins
            for c, v in zip(self._TXN_COUNTERS, prev_counters):
                setattr(self, c, v)

        t.on_rollback(undo)

    def begin_peak_window(self) -> None:
        """Start a fresh residency-peak window (bins already resident
        count toward it — they occupy device memory whether or not this
        run touches them)."""
        self.window_peak_bins = self.resident_bins

    @staticmethod
    def _nbytes(arrays: tuple) -> int:
        return sum(a.numel() * a.element_size() for a in arrays)

    def _touch(self, key: tuple) -> None:
        self._bins[key] = self._bins.pop(key)

    def _store(self, key: tuple, sigs: tuple, arrays: tuple) -> None:
        """Insert/refresh an entry as most-recent, then evict the coldest
        tensor-resident entries (never the one just stored) until the
        configured bin-count capacity and byte budget both hold."""
        self._bins.pop(key, None)
        self._bins[key] = (sigs, arrays, self._nbytes(arrays))

        def over() -> bool:
            if self.capacity is not None and self.resident_bins > self.capacity:
                return True
            return (
                self.hbm_budget_bytes is not None
                and self.resident_bins > 1
                and self.resident_bytes > self.hbm_budget_bytes
            )

        while over():
            victim = next(
                k for k, (_, arrays, _) in self._bins.items()
                if arrays is not None and k != key
            )
            vsigs, _, _ = self._bins[victim]
            self._bins[victim] = (vsigs, None, 0)
            # keep LRU position: an evicted entry stays coldest until re-used
            self.evictions += 1
        resident = self.resident_bins
        self.peak_resident_bins = max(self.peak_resident_bins, resident)
        self.window_peak_bins = max(self.window_peak_bins, resident)
        self.peak_resident_bytes = max(
            self.peak_resident_bytes, self.resident_bytes
        )

    @staticmethod
    def _row_sigs(bt: _BinTensors, row_keys: tuple | None = None) -> tuple:
        if row_keys is not None:
            return row_keys
        return tuple(
            hashlib.blake2b(
                bt.entity_ids[r].tobytes()
                + bt.entity_mask[r].tobytes()
                + bt.coauthor[r].tobytes()
                + bt.sim_level[r].tobytes()
                + bt.pair_mask[r].tobytes(),
                digest_size=16,
            ).digest()
            for r in range(bt.n_rows)
        )

    def _ground_rows(self, fn, bt: _BinTensors, rows: np.ndarray):
        """Ground a row subset, padded to a power of two (inert rows)."""
        n = len(rows)
        pad = _pow2(n) - n
        ids = bt.entity_ids[rows]
        em = bt.entity_mask[rows]
        co = bt.coauthor[rows]
        lv = bt.sim_level[rows]
        pm = bt.pair_mask[rows]
        if pad:
            ids = np.concatenate(
                [ids, np.full((pad,) + ids.shape[1:], -1, ids.dtype)]
            )
            em = np.concatenate([em, np.zeros((pad,) + em.shape[1:], em.dtype)])
            co = np.concatenate([co, np.zeros((pad,) + co.shape[1:], co.dtype)])
            lv = np.concatenate([lv, np.zeros((pad,) + lv.shape[1:], lv.dtype)])
            pm = np.concatenate([pm, np.zeros((pad,) + pm.shape[1:], pm.dtype)])
        with obs_span("rounds.ground", rows=n):
            record_transfer("gcache", ids, em, co, lv, pm)
            out = fn(ids, em, co, lv, pm)
        self.ground_calls += 1
        self.rows_ground += n
        # clone: a view would keep the padded rows' storage alive
        return tuple(a[:n].clone() for a in out) if pad else out

    def splice(self, matcher_key, bt: _BinTensors, sigs: tuple,
               cached: tuple[tuple, tuple]) -> tuple:
        """Update a cached bin: gather unchanged rows from the cached
        tensors (by row signature), re-ground *only* the fresh rows, and
        place them at their new positions.

        This is the device-side leg of the O(dirty) ingest path: the
        streaming engine's covers arrive with ``PackedCover.row_keys``
        from the :class:`~repro_torch.core.cover.CoverDelta` splice, so
        the signature diff here sees exactly the spliced rows.  Returns
        new tensors; the cached ones are left as they were (a rolled-back
        ingest restores them).
        """
        old_sigs, old_arrays = cached
        fn = _ground_bin_fn(*matcher_key)
        pos_of = {s: i for i, s in enumerate(old_sigs)}
        src = np.asarray([pos_of.get(s, -1) for s in sigs], dtype=np.int64)
        fresh = np.where(src < 0)[0]
        dev = old_arrays[0].device
        gather = torch.as_tensor(np.where(src >= 0, src, 0), device=dev)
        arrays = tuple(a.index_select(0, gather) for a in old_arrays)
        if len(fresh):
            sub = self._ground_rows(fn, bt, fresh)
            at = torch.as_tensor(fresh, device=dev)
            arrays = tuple(a.index_copy(0, at, s) for a, s in zip(arrays, sub))
            self.splice_calls += 1
        else:
            self.bin_hits += 1
        return arrays

    def get(self, matcher_key, k: int, bt: _BinTensors,
            row_keys: tuple | None = None) -> tuple:
        key = (matcher_key, k)
        sigs = self._row_sigs(bt, row_keys)
        cached = self._bins.get(key)
        if cached is not None and cached[0] == sigs and cached[1] is not None:
            self.bin_hits += 1
            self._touch(key)
            return cached[1]
        if cached is None or cached[1] is None:
            # miss, or LRU-evicted tensors: (cold) re-ground every row —
            # grounding is pure in the row arrays, so this reproduces
            # the dropped tensors bit for bit.
            if cached is not None:
                self.cold_regrounds += 1
            fn = _ground_bin_fn(*matcher_key)
            arrays = self._ground_rows(fn, bt, np.arange(len(sigs)))
        else:
            arrays = self.splice(matcher_key, bt, sigs, (cached[0], cached[1]))
        self._store(key, sigs, arrays)
        return arrays


# ---------------------------------------------------------------------------
# Bin preparation (host side, once per cover)
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class _BinTensors:
    """Per-bin host arrays the grounding and the rounds read."""

    entity_ids: np.ndarray  # (B, k) int, -1 padding
    entity_mask: np.ndarray
    coauthor: np.ndarray
    sim_level: np.ndarray
    pair_mask: np.ndarray
    uidx: np.ndarray  # (B, P) int32 universe index, Np where invalid
    pair_gid: np.ndarray
    n_rows: int  # the bin's own rows; any after them pad B to the rank count


def _prepare_bins(
    packed: PackedCover, universe: np.ndarray, pad_mult: int = 1
) -> dict[int, _BinTensors]:
    """Stage per-bin arrays with each slot's index into the universe
    (``Np`` for a slot that is no candidate pair).  ``pad_mult`` pads
    the batch axis to a multiple of the mesh's rank count; padding rows
    are inert (``pair_mask`` False, ``uidx`` == Np, ``pair_gid`` == -1),
    are never active, and are never ground: the grounding cache sees the
    first ``n_rows`` rows only."""
    out = {}
    Np = len(universe)
    for k, nb in packed.bins.items():
        idx = np.searchsorted(universe, nb.pair_gid)
        idx = np.clip(idx, 0, max(Np - 1, 0))
        ok = (nb.pair_gid >= 0) & (
            universe[idx] == nb.pair_gid if Np else np.zeros_like(nb.pair_mask)
        )
        uidx = np.where(ok, idx, Np).astype(np.int32)
        b = nb.entity_mask.shape[0]
        target = max(-(-b // pad_mult) * pad_mult, pad_mult)

        def _pad(a, fill):
            if target == b:
                return a
            extra = np.full((target - b,) + a.shape[1:], fill, dtype=a.dtype)
            return np.concatenate([a, extra], axis=0)

        bt = _BinTensors(
            entity_ids=_pad(nb.entity_ids, -1),
            entity_mask=_pad(nb.entity_mask, False),
            coauthor=_pad(nb.coauthor, False),
            sim_level=_pad(nb.sim_level.astype(np.int8), 0),
            pair_mask=_pad(nb.pair_mask, False),
            uidx=_pad(uidx, Np),
            pair_gid=_pad(nb.pair_gid, -1),
            n_rows=b,
        )
        record_transfer(
            "prepare", bt.entity_mask, bt.coauthor, bt.sim_level,
            bt.pair_mask, bt.uidx, bt.pair_gid,
        )
        out[k] = bt
    return out


def _take(t: torch.Tensor, rows: torch.Tensor | None) -> torch.Tensor:
    """Rows ``rows`` of ``t`` (all of them for None)."""
    return t if rows is None else t.index_select(0, rows)


def _scatter_bits(uidx: torch.Tensor, x: torch.Tensor, Np: int) -> torch.Tensor:
    """(Np,) bool: the universe slots some row sets in ``x``.  Padding
    slots (``uidx == Np``) land in a sink slot that is dropped."""
    local = torch.zeros(Np + 1, dtype=torch.int32, device=x.device)
    local.scatter_reduce_(0, uidx.reshape(-1), x.reshape(-1).to(torch.int32), "amax")
    return local[:Np] > 0


# ---------------------------------------------------------------------------
# Fused multi-round closure (one dispatch for a whole round sequence)
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class FusedSpec:
    """Static description of a fused multi-round call (the reference
    compiles one program per spec; here nothing compiles)."""

    kinds: tuple[str, ...]  # per-bin matcher kind
    universe_size: int


@dataclasses.dataclass
class _DeviceBin:
    """One bin's tensors for the round loops, on the run's device."""

    g: tuple  # the grounding 4-tuple of the bin's own rows, valid last
    uidx: torch.Tensor  # (B, P) int64, Np where invalid
    safe: torch.Tensor  # uidx clamped into the universe (a gather index)
    inuniv: torch.Tensor  # (B, P) bool: slot is a candidate pair
    active: torch.Tensor  # (B,) bool
    lo: int  # this rank's rows: [lo, hi)
    hi: int


def _eval_bin_x(kind: str, g, ev_pos, ev_neg):
    """Batched matcher evaluation from cached grounding tensors."""
    if kind == "rules":
        lev, n_shared, link, valid = g
        return rules_fixpoint_batch(lev, n_shared, link, ev_pos, ev_neg, valid)
    if kind == "embed":
        base, valid, _z0, _z1 = g
        return (base | ev_pos) & valid & ~ev_neg
    u, _, C, valid = g
    if kind == "mln_greedy":
        return closure_batch(u, C, ev_pos, ev_neg, valid)
    x, _ = _infer(u, C, ev_pos, ev_neg, valid)
    return x


def _active_rows(active: torch.Tensor, n: int, lo: int = 0,
                 hi: int | None = None) -> torch.Tensor | None:
    """The ``n`` rows set in ``active[lo:hi]``, ascending (None: every row
    of the bin), found without reading ``active`` back to the host."""
    if n == active.shape[0]:
        return None
    order = torch.sort((~active[lo:hi]).to(torch.int8), stable=True).indices
    return order[:n] + lo


def _fused_rounds(spec: FusedSpec, bins: list[_DeviceBin], m_bits: torch.Tensor,
                  budget: int, mesh: EMMesh):
    """Multi-round closure: rounds of every bin's active rows until no
    row is active or ``budget`` rounds ran.

    The match bitset, the per-bin active sets and their counts stay on
    the device; each round reads the per-bin active counts back once
    (the loop condition: the whole bins' counts, and this rank's
    slices') and evaluates this rank's active rows.  The hit bitset is
    OR-reduced over the ranks once a round; every rank then holds the
    same bits, so the next active sets need no collective.  Returns
    ``(bits, rounds, evals, history)``.
    """
    Np = spec.universe_size
    bits = m_bits
    actives = [b.active for b in bins]
    split = mesh_spans_processes(mesh)
    rounds = 0
    evals = 0
    history: list[int] = []
    while rounds < budget:
        sums = [a.sum() for a in actives]
        if split:
            sums += [a[b.lo:b.hi].sum() for a, b in zip(actives, bins)]
        counts = torch.stack(sums).tolist()
        per_bin = counts[: len(bins)]
        mine = counts[len(bins):] if split else per_bin
        n_active = sum(per_bin)
        if not n_active:
            break
        history.append(n_active)
        hit = torch.zeros(Np, dtype=torch.bool, device=bits.device)
        for kind, b, act, n in zip(spec.kinds, bins, actives, mine):
            if not n:
                continue
            mesh.rows_evaluated += n
            rows = _active_rows(act, n, b.lo, b.hi)
            inuniv = _take(b.inuniv, rows)
            ev_pos = bits[_take(b.safe, rows)] & inuniv
            x = _eval_bin_x(kind, tuple(_take(a, rows) for a in b.g), ev_pos,
                            torch.zeros_like(ev_pos))
            hit |= _scatter_bits(_take(b.uidx, rows), x & inuniv, Np)
        new_bits = mesh.reduce_bits(hit) | bits
        changed = new_bits & ~bits
        actives = [(changed[b.safe] & b.inuniv).any(dim=1) for b in bins]
        bits = new_bits
        rounds += 1
        evals += n_active
    return bits, rounds, evals, history


# ---------------------------------------------------------------------------
# Device-resident step-7 promotion (quiescence points without host scans)
# ---------------------------------------------------------------------------


def _promote_loop_fn(num_gids: int, k_pad: int):
    """Promotion fixpoint for one (grounding, pool) shape: ``num_gids``
    candidate pairs, ``k_pad`` group rows.

    One call runs the whole ``while changed`` sweep of Algorithm 3
    step 7 on the device: every sweep evaluates ALL groups' global
    deltas against the current base bitset in a single batched
    computation (``lin + w_co * quad`` over the coupling COO) and
    promotes every group with new pairs and a non-negative delta at
    once; the host reads one flag a sweep.  Batching the sweep is sound
    because ``w_co >= 0`` makes ``P_E`` supermodular: a group's delta
    is non-decreasing in the base, so a group promotable against the
    sweep-start base is still promotable after any other promotion of
    that sweep — the closure reached is the same least fixpoint the
    sequential group walk reaches (``driver._promote``, kept as the
    host baseline).
    """

    def f(u, coup_p, coup_q, w_co, gidx, gseg, gvalid, base):
        # (K, Np) membership bitsets of the pool groups, scattered once;
        # padded members carry gseg == k_pad and land in a dropped row.
        add = torch.zeros((k_pad + 1, num_gids), dtype=torch.bool, device=u.device)
        add.index_put_((gseg, gidx), torch.ones((), dtype=torch.bool, device=u.device))
        add = add[:k_pad]
        bits = base
        promoted = torch.zeros((), dtype=torch.int64, device=u.device)
        zero = torch.zeros((), dtype=torch.float32, device=u.device)
        while True:
            new = add & ~bits[None, :]
            has_new = new.any(dim=1) & gvalid
            lin = torch.where(new, u[None, :], zero).sum(dim=1)
            both = bits[None, :] | add
            quad_base = (bits[coup_p] & bits[coup_q]).sum()
            quad_both = (both[:, coup_p] & both[:, coup_q]).sum(dim=1)
            delta = lin + w_co * (quad_both - quad_base).to(torch.float32)
            mask = has_new & (delta >= -1e-6)
            bits = bits | (add & mask[:, None]).any(dim=0)
            promoted = promoted + mask.sum()
            if not bool(mask.any()):
                return bits, promoted

    return f


class DevicePromoter:
    """Step-7 promotion with the delta checks batched on the device.

    The host ``driver._promote`` walks the global coupling COO with
    numpy once per group per sweep — an O(groups x couplings) host scan
    at every quiescence point.  This class keeps the grounding's unary
    and coupling arrays on the device (uploaded once per grounding) and
    ships the pool's group bitsets alongside, so a quiescence point is
    ONE call running the whole promotion fixpoint
    (:func:`_promote_loop_fn`); the host only assembles the group member
    indices (O(pool), memoized per ``MessagePool.groups()`` snapshot)
    and reads back the (Np,) bitset.  ``host_scans`` counts fallbacks to
    the host walk (only taken for ``w_co < 0``, where the
    supermodularity argument for batched sweeps fails).
    """

    def __init__(self, gg: GlobalGrounding, device: torch.device):
        self.gg = gg
        self.device = device
        self.batched_ok = float(gg.w_co) >= 0.0 and len(gg.gids) > 0
        self.dispatches = 0
        self.host_scans = 0
        # (groups list, device tensors): keeps a strong ref to the groups
        # snapshot so identity comparison can never hit a recycled id
        self._groups_memo: tuple[list, tuple | None] | None = None

    def _device_grounding(self) -> tuple:
        # cached ON the grounding object: the streaming maintainer hands
        # out the same GlobalGrounding while no delta is pending, so the
        # upload happens once per grounding *version*, not once per run
        gg = self.gg
        if gg._device is None or gg._device[0] != self.device:
            cp = gg.coup_p.astype(np.int32)
            cq = gg.coup_q.astype(np.int32)
            record_transfer("promoter", gg.u, cp, cq)
            dev = self.device
            gg._device = (dev, (
                torch.as_tensor(gg.u, device=dev),
                torch.as_tensor(cp, device=dev).long(),
                torch.as_tensor(cq, device=dev).long(),
                torch.tensor(float(gg.w_co), dtype=torch.float32, device=dev),
            ))
        return gg._device[1]

    def _group_arrays(self, groups: list[np.ndarray]) -> tuple | None:
        """Flat member-index CSR of the pool groups (pow2-padded), memoized
        on the identity of the ``MessagePool.groups()`` snapshot (the pool
        invalidates it on every mutation)."""
        if self._groups_memo is not None and self._groups_memo[0] is groups:
            return self._groups_memo[1]
        gg = self.gg
        idx_parts: list[np.ndarray] = []
        seg_parts: list[np.ndarray] = []
        n_groups = 0
        for grp in groups:
            idx = gg.index_of(grp)
            idx = idx[idx >= 0]
            if len(idx) < 2:  # retracted below pair size: never promotable
                continue
            idx_parts.append(idx.astype(np.int32))
            seg_parts.append(np.full(len(idx), n_groups, dtype=np.int32))
            n_groups += 1
        if not n_groups:
            out = None
        else:
            gidx = np.concatenate(idx_parts)
            gseg = np.concatenate(seg_parts)
            m_pad = _pow2(len(gidx))
            k_pad = _pow2(n_groups)
            if m_pad > len(gidx):
                pad = m_pad - len(gidx)
                gidx = np.concatenate([gidx, np.zeros(pad, np.int32)])
                gseg = np.concatenate([gseg, np.full(pad, k_pad, np.int32)])
            gvalid = np.zeros(k_pad, dtype=bool)
            gvalid[:n_groups] = True
            record_transfer("promoter", gidx, gseg, gvalid)
            dev = self.device
            out = (
                torch.as_tensor(gidx, device=dev).long(),
                torch.as_tensor(gseg, device=dev).long(),
                torch.as_tensor(gvalid, device=dev),
                k_pad,
            )
        self._groups_memo = (groups, out)
        return out

    def promote(self, pool: MessagePool, m_plus: MatchStore):
        """Drop-in for ``driver._promote``: same (matches, promoted) pair.

        ``promoted`` counts group-promotion events; the batched sweep may
        count a group the sequential walk skipped as already-subsumed
        within the same sweep, so only the *match set* (identical by
        supermodularity) is bit-for-bit comparable across engines.
        """
        groups = pool.groups()
        if not groups:
            return m_plus, 0
        if not self.batched_ok:
            self.host_scans += 1
            with obs_span("rounds.promote", host=True):
                return _promote(pool, self.gg, m_plus)
        garrs = self._group_arrays(groups)
        if garrs is None:
            return m_plus, 0
        gg = self.gg
        gidx, gseg, gvalid, k_pad = garrs
        base0 = gg.bool_of(m_plus)
        fn = _promote_loop_fn(len(gg.gids), k_pad)
        with obs_span("rounds.promote"):
            record_transfer("promoter", base0)
            bits, promoted = fn(
                *self._device_grounding(), gidx, gseg, gvalid,
                torch.as_tensor(base0, device=self.device)
            )
            # int() waits for the device, so the span bills its work
            promoted = int(promoted)
        self.dispatches += 1
        if promoted:
            extra = gg.gids[bits.cpu().numpy() & ~base0]
            if len(extra):
                m_plus = m_plus.union(extra)
        return m_plus, promoted


# ---------------------------------------------------------------------------
# Full (maximal-message) rounds: one call per bin
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class BinRoundSpec:
    """Static description of one bin's host-visible full round."""

    kind: str
    num_pairs: int
    universe_size: int


def _bin_full_round(spec: BinRoundSpec, g, uidx, pmask, m_bits):
    """One full round of one bin's active rows (``g``, ``uidx`` and
    ``pmask`` hold those rows only): evaluate them from cached grounding
    tensors, return per-slot matches, component labels, and the updated
    bitset."""
    Np = spec.universe_size
    inuniv = (uidx < Np) & pmask
    ev_pos = m_bits[uidx.clamp(max=Np - 1)] & inuniv
    ev_neg = torch.zeros_like(ev_pos)
    if spec.kind == "mln":
        u, _, C, valid = g
        x, lab = _infer(u, C, ev_pos, ev_neg, valid)
    else:
        x = _eval_bin_x(spec.kind, g, ev_pos, ev_neg)
        lab = torch.full(x.shape, spec.num_pairs, dtype=torch.int32, device=x.device)
    return x, lab, _scatter_bits(uidx, x & inuniv, Np) | m_bits


def build_bin_round_fn(spec: BinRoundSpec, mesh: EMMesh, axes: tuple[str, ...]):
    """The full round of one bin over ``mesh``: a callable ``(g, uidx,
    pmask, active, m_bits) -> (x, lab, bits)`` taking this rank's slice of
    the bin's rows (``g`` the cached grounding tensors, ``active`` a host
    bool mask of the slice's active rows; slices of equal length on every
    rank).  Only the active rows are evaluated (lanes never interact): the
    reference evaluates the inactive ones too and masks them out of the
    bitset, here their ``x`` is False and their labels ``num_pairs``.  The
    bitset is OR-reduced over ``axes``, and on a mesh that spans processes
    the rows' ``x`` and labels come back gathered, whole bins in rank
    order; with ``axes=()`` there is no collective and all three are this
    rank's."""
    gather = bool(axes) and mesh_spans_processes(mesh)

    def round_fn(g, uidx, pmask, active, m_bits):
        mine = np.flatnonzero(active)
        n, P = pmask.shape
        if len(mine) == n:  # every row: nothing to place
            x, lab, bits = _bin_full_round(spec, g, uidx, pmask, m_bits)
        else:
            dev = pmask.device
            x = torch.zeros((n, P), dtype=torch.bool, device=dev)
            lab = torch.full((n, P), spec.num_pairs, dtype=torch.int32, device=dev)
            bits = m_bits
            if len(mine):
                rows = torch.as_tensor(mine, device=dev)
                x[rows], lab[rows], bits = _bin_full_round(
                    spec, tuple(a[rows] for a in g), uidx[rows], pmask[rows], m_bits)
        mesh.rows_evaluated += len(mine)
        bits = _reduce_bits(mesh, axes, bits)
        if gather:
            x, lab = (mesh.gather_rows(t).flatten(0, 1) for t in (x, lab))
        return x, lab, bits

    return round_fn


def _reduce_bits(mesh: EMMesh, axes: tuple[str, ...], bits):
    """OR ``bits`` over the mesh axes ``axes`` (an EM mesh has one)."""
    unknown = set(axes) - set(mesh.axis_names)
    if unknown:
        raise ValueError(f"axes {sorted(unknown)} are not the mesh's {mesh.axis_names}")
    return mesh.reduce_bits(bits) if axes else bits


# ---------------------------------------------------------------------------
# Legacy per-round host loop (the differential baseline)
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class RoundSpec:
    """Static description of one bin's round function."""

    num_pairs: int
    universe_size: int
    matcher_kind: str  # 'mln' | 'mln_greedy' | 'rules'
    weights: MLNWeights | None


def _device_round(spec: RoundSpec, device, entity_mask, coauthor, sim_level,
                  pair_mask, uidx, m_bits):
    """One legacy round of a bin's rows: re-grounds from the raw arrays
    on every call (the per-round overhead the grounding cache and the
    fused engine remove — kept as the differential baseline)."""
    Np = spec.universe_size
    uidx = torch.as_tensor(uidx, device=device).long()
    pmask = torch.as_tensor(pair_mask, device=device)
    ev_pos = m_bits[uidx.clamp(max=Np - 1)] & (uidx < Np) & pmask
    ev_neg = torch.zeros_like(ev_pos)

    # only shapes and masks are read by the grounding
    batch = _rows_batch(entity_mask, entity_mask, coauthor, sim_level, pair_mask)
    if spec.matcher_kind == "rules":
        lev, valid, n_shared, link = ground_structure(batch, device)
        x = rules_fixpoint_batch(lev, n_shared, link, ev_pos, ev_neg, valid)
        lab = torch.full(x.shape, spec.num_pairs, dtype=torch.int32, device=device)
    else:
        g = ground(batch, spec.weights, device)
        if spec.matcher_kind == "mln_greedy":
            x = closure_batch(g.u, g.C, ev_pos, ev_neg, g.valid)
            lab = torch.full(x.shape, spec.num_pairs, dtype=torch.int32, device=device)
        else:
            x, lab = _infer(g.u, g.C, ev_pos, ev_neg, g.valid)
    return x, lab, _scatter_bits(uidx, x & pmask, Np) | m_bits


def build_round_fn(spec: RoundSpec, mesh: EMMesh, axes: tuple[str, ...]):
    """The legacy round of one bin over ``mesh``: a callable ``(entity_mask,
    coauthor, sim_level, pair_mask, uidx, m_bits) -> (x, lab, bits)`` over
    this rank's rows (host arrays, equal row counts on every rank), which
    re-grounds them (:func:`_device_round`), ORs the bitset over ``axes``,
    and on a mesh that spans processes gathers the rows' ``x`` and labels
    back to the whole batch in rank order (none of it with ``axes=()``)."""
    gather = bool(axes) and mesh_spans_processes(mesh)

    def round_fn(entity_mask, coauthor, sim_level, pair_mask, uidx, m_bits):
        x, lab, bits = _device_round(spec, mesh.device, entity_mask, coauthor, sim_level,
                                     pair_mask, uidx, m_bits)
        bits = _reduce_bits(mesh, axes, bits)
        if gather:
            x, lab = (mesh.gather_rows(t).flatten(0, 1) for t in (x, lab))
        return x, lab, bits

    return round_fn


def _matcher_spec(matcher, k: int, Np: int) -> RoundSpec:
    kind, weights = _matcher_cache_key(matcher)
    if kind not in ("mln", "rules"):
        raise TypeError(
            f"legacy per-round loop supports only the 'mln'/'rules' kinds, "
            f"got {kind!r}; use the fused engine"
        )
    if kind == "mln" and not getattr(matcher, "collective", True):
        kind = "mln_greedy"
    return RoundSpec(
        num_pairs=pairlib.num_pairs(k),
        universe_size=Np,
        matcher_kind=kind,
        weights=weights,
    )


def _pad_rows(arrs: list[np.ndarray], mult: int) -> list[np.ndarray]:
    """Pad the batch axis to a multiple of the shard count.

    Padding rows are all-zero: ``pair_mask`` False everywhere makes them
    inert (no candidate pairs, no scatters — `x & pair_mask` is False).
    """
    b = arrs[0].shape[0]
    target = max(-(-b // mult) * mult, mult)
    if target == b:
        return arrs
    return [
        np.concatenate([a, np.zeros((target - b,) + a.shape[1:], a.dtype)])
        for a in arrs
    ]


# ---------------------------------------------------------------------------
# Drivers
# ---------------------------------------------------------------------------


def _seed_bits(universe: np.ndarray, m_plus: MatchStore) -> np.ndarray:
    Np = len(universe)
    bits = np.zeros(Np, dtype=bool)
    if len(m_plus):
        idx = np.searchsorted(universe, m_plus.gids)
        idx = np.clip(idx, 0, Np - 1)
        bits[idx[universe[idx] == m_plus.gids]] = True
    return bits


def _set_bits(bits: np.ndarray, universe: np.ndarray, gids: np.ndarray) -> None:
    if not len(gids):
        return
    idx = np.searchsorted(universe, gids)
    idx = np.clip(idx, 0, max(len(universe) - 1, 0))
    bits[idx[universe[idx] == gids]] = True


def _same_device(a: torch.device, b: torch.device) -> bool:
    """Equal devices, where a CUDA device without an index stands for any."""
    return a.type == b.type and (None in (a.index, b.index) or a.index == b.index)


def run_parallel(
    packed: PackedCover,
    matcher,
    gg: GlobalGrounding | None = None,
    *,
    scheme: str = "smp",
    mesh=None,
    max_rounds: int = 256,
    fast_rounds: bool = True,
    active: list[int] | None = None,
    init_matches: MatchStore | None = None,
    pool: MessagePool | None = None,
    gcache: GroundingCache | None = None,
    fused: bool = True,
    device=None,
) -> EMResult:
    """Round-parallel NO-MP / SMP / MMP on one device or over a mesh.

    See :func:`_run_parallel_impl` for the engine semantics; this entry
    point additionally (a) runs the whole call inside an opt-in
    ``torch.profiler`` session (:func:`repro_torch.obs.profiler_session`,
    enabled via ``REPRO_TORCH_PROFILE_DIR``) and (b) publishes the
    :class:`EMResult` counters into the runtime metrics registry
    (``em.*`` family).

    ``device=None`` means CUDA and raises without a GPU; pass
    ``device="cpu"`` for the plain kernel versions.  It must be the
    matcher's device.  ``mesh`` (a :class:`repro_torch.launch.mesh.EMMesh`,
    e.g. :func:`make_em_mesh`) splits every bin's rows over its ranks;
    every rank must make the same call, and ``device`` then defaults to
    the mesh's.  ``mesh=None`` runs on one device.
    """
    if mesh is not None and not isinstance(mesh, EMMesh):
        raise TypeError(f"mesh must be an EMMesh (launch.mesh), not {type(mesh).__name__}")
    dev = resolve_device(mesh.device if mesh is not None and device is None else device)
    if mesh is None:
        mesh = EMMesh.local(dev)
    elif not _same_device(mesh.device, dev):
        raise ValueError(f"run_parallel on {dev}, but the mesh's rank is on {mesh.device}")
    mdev = getattr(matcher, "device", None)
    if mdev is not None and not _same_device(mdev, dev):
        raise ValueError(f"run_parallel on {dev}, but the matcher runs on {mdev}")
    with profiler_session():
        res = _run_parallel_impl(
            packed, matcher, gg, scheme=scheme, max_rounds=max_rounds,
            fast_rounds=fast_rounds, active=active, init_matches=init_matches,
            pool=pool, gcache=gcache, fused=fused, device=dev, mesh=mesh,
        )
    return publish_em_result(res)


def _run_parallel_impl(
    packed: PackedCover,
    matcher,
    gg: GlobalGrounding | None,
    *,
    scheme: str,
    max_rounds: int,
    fast_rounds: bool,
    active: list[int] | None,
    init_matches: MatchStore | None,
    pool: MessagePool | None,
    gcache: GroundingCache | None,
    fused: bool,
    device: torch.device,
    mesh: EMMesh,
) -> EMResult:
    """Round-parallel NO-MP / SMP / MMP.

    scheme='nomp' runs one round with no evidence exchange;
    scheme='smp' exchanges match bitsets per round (Alg. 1 in rounds);
    scheme='mmp' additionally maintains the maximal-message pool and the
    step-7 promotion (needs a Type-II matcher and ``gg``).

    ``active``/``init_matches``/``pool`` are the streaming hooks
    (mirroring the sequential drivers): seed round 1 with only the
    dirty neighborhoods and continue the closure from a previous
    fixpoint / maximal-message pool.

    ``gcache`` is the persistent grounding cache: the streaming engine
    passes one per service so clean bins are never re-ground across
    ingests; batch callers get a per-run cache (grounding still happens
    exactly once per bin per cover, across all rounds).  A *bounded*
    cache (``GroundingCache(capacity=...)`` or ``hbm_budget_bytes=...``)
    is honored per call: bin tensors are fetched just in time, so at
    most ``capacity`` bins stay resident between calls and cold bins
    re-ground on demand — same fixpoint bit for bit, compute traded for
    bounded device memory.

    ``fast_rounds`` (SMP and MMP with the collective MLN): re-activation
    rounds run the *greedy closure* variant — evidence-driven
    propagation needs no entailment matrix, which is the entire O(P^3)
    cost of a full round.  Those greedy rounds run inside one fused
    loop; a full round (maximal-message inference for MMP, full
    collective MAP for SMP) runs first and again at every quiescence
    point, so the final fixpoint is closed under the full matcher on
    every neighborhood: greedy closure under evidence is sound
    (Prop. 6), and termination still requires a full round to have
    produced nothing new (Thm. 2/4).

    ``fused=False`` selects the legacy per-round host loop (one call per
    bin per round, re-grounding every time) — the differential baseline.
    """
    t0 = time.perf_counter()
    if scheme == "mmp":
        assert gg is not None and getattr(matcher, "score", None) is not None
    dev = device

    universe = np.sort(np.asarray(sorted(packed.pair_levels.keys()), dtype=np.int64))
    Np = len(universe)
    if Np == 0:  # no candidate pairs anywhere: nothing to resolve
        return EMResult(
            init_matches if init_matches is not None else MatchStore(),
            0, 0, 0, 0, time.perf_counter() - t0,
        )

    if not fused:
        return _run_parallel_legacy(
            packed, matcher, gg, scheme=scheme, max_rounds=max_rounds,
            fast_rounds=fast_rounds, active=active, init_matches=init_matches,
            pool=pool, t0=t0, universe=universe, device=dev, mesh=mesh,
        )

    bins = _prepare_bins(packed, universe, pad_mult=mesh.size)
    bin_ks = sorted(bins)
    gcache = gcache if gcache is not None else GroundingCache()
    mkey = (*_matcher_cache_key(matcher), dev)

    _rk_memo: dict[int, tuple | None] = {}

    def bin_row_keys(k):
        # packer row keys (streaming path) double as grounding fingerprints
        if packed.row_keys is None:
            return None
        if k not in _rk_memo:
            _rk_memo[k] = tuple(packed.row_keys[int(n)] for n in packed.bin_rows[k])
        return _rk_memo[k]

    run_grounds: dict[int, tuple] = {}

    def ground_of(k):
        """Fetch one bin's grounded device tensors.

        Unbounded cache: memoized per run — exactly one ``get`` per bin
        per cover.  Bounded cache: fetched per call, so between calls
        only the LRU's ``capacity`` bins stay resident and a cold bin
        re-grounds on demand — the run never pins every bin's
        ``(B, P, P)`` tensors for its whole lifetime.
        """
        if gcache.bounded:
            return gcache.get(mkey, k, bins[k], bin_row_keys(k))
        g = run_grounds.get(k)
        if g is None:
            g = run_grounds[k] = gcache.get(mkey, k, bins[k], bin_row_keys(k))
        return g

    dev_uidx = {k: torch.as_tensor(bins[k].uidx, device=dev).long() for k in bin_ks}
    dev_pmask = {k: torch.as_tensor(bins[k].pair_mask, device=dev) for k in bin_ks}
    dev_safe = {k: dev_uidx[k].clamp(max=Np - 1) for k in bin_ks}
    dev_inuniv = {k: (dev_uidx[k] < Np) & dev_pmask[k] for k in bin_ks}
    evictions0 = gcache.evictions
    cold0 = gcache.cold_regrounds
    gcache.begin_peak_window()

    # A fused call holds EVERY bin's grounded tensors at once — transient
    # full residency, which would defeat a memory bound tighter than the
    # bin count.  In *spill mode* the run instead routes everything
    # through the per-bin full-round loop: each call stages one bin's
    # tensors and releases them, so peak device residency really is
    # capacity (+ the one bin in flight) — memory bought with extra
    # calls and cold re-grounds, never with a different fixpoint.
    spill_mode = gcache.hbm_budget_bytes is not None or (
        gcache.capacity is not None and gcache.capacity < len(bin_ks)
    )

    base_kind = mkey[0]
    if base_kind == "mln" and not getattr(matcher, "collective", True):
        base_kind = "mln_greedy"
    if scheme == "mmp" and base_kind not in ("mln", "mln_greedy"):
        raise TypeError(
            f"parallel MMP is wired to the MLN device promoter; kind "
            f"{base_kind!r} emits no multi-pair messages, so run_mmp "
            "(sequential) or scheme='smp' reach the identical fixpoint"
        )

    # step-7 promotion runs on the device (batched delta checks, zero
    # host coupling-COO scans); the promoter counts any host fallback.
    promoter = DevicePromoter(gg, dev) if scheme == "mmp" else None

    m_plus = init_matches if init_matches is not None else MatchStore()
    m_bits = _seed_bits(universe, m_plus)
    if pool is None:
        pool = MessagePool()
    active = (
        list(active) if active is not None else list(range(packed.num_neighborhoods))
    )
    evals = 0
    emitted = 0
    promoted_total = 0
    rounds = 0
    full_rounds = 0
    dispatches = 0
    history: list[int] = []

    def masks_for(act_list):
        masks = {
            k: np.zeros(bins[k].entity_mask.shape[0], dtype=bool) for k in bin_ks
        }
        for n in act_list:
            masks[int(packed.neighborhood_bin[n])][
                int(packed.neighborhood_row[n])
            ] = True
        return masks

    def live_rows(act_list):
        """Drop provably inert rows: a neighborhood whose every candidate
        slot is already matched can add no matches (output is a subset of
        its valid slots) and can emit no maximal messages (messages range
        over *undecided* pairs) — evaluating it in a full round is a
        no-op in every driver.  Cost is O(|act_list| slots)."""
        keep = []
        for k, rows in packed.rows_for(act_list).items():
            bt = bins[k]
            uidx = bt.uidx[rows]
            un = bt.pair_mask[rows] & (uidx < Np) & ~m_bits[
                np.minimum(uidx, Np - 1)
            ]
            live = np.asarray(rows)[un.any(axis=1)]
            keep.extend(int(packed.bin_rows[k][r]) for r in live)
        return sorted(keep)

    # this rank's rows of each (padded) bin
    row_slice = {k: mesh.row_slice(bins[k].entity_mask.shape[0]) for k in bin_ks}

    def fused_call(kind, act_masks, budget):
        nonlocal dispatches
        spec = FusedSpec(kinds=tuple(kind for _ in bin_ks), universe_size=Np)
        per_bin = [
            _DeviceBin(
                g=ground_of(k), uidx=dev_uidx[k], safe=dev_safe[k],
                inuniv=dev_inuniv[k],
                active=torch.as_tensor(act_masks[k], device=dev),
                lo=row_slice[k][0], hi=row_slice[k][1],
            )
            for k in bin_ks
        ]
        with obs_span("rounds.fused", kind=kind):
            bits, r, ev, hist = _fused_rounds(
                spec, per_bin, put_replicated(m_bits, mesh), budget, mesh
            )
            # np.array, not .numpy(): callers mutate m_bits in place
            # (_set_bits), and on the CPU .numpy() shares the tensor's memory
            bits = np.array(host_array(bits))
        dispatches += 1
        return bits, r, ev, hist

    def finish():
        return EMResult(
            matches=m_plus,
            neighborhood_evals=evals,
            rounds=rounds,
            messages_emitted=emitted,
            messages_promoted=promoted_total,
            wall_time_s=time.perf_counter() - t0,
            history=history,
            dispatches=dispatches,
            full_rounds=full_rounds,
            peak_resident_bins=gcache.window_peak_bins,
            cache_evictions=gcache.evictions - evictions0,
            cold_regrounds=gcache.cold_regrounds - cold0,
            promote_host_scans=promoter.host_scans if promoter else 0,
        )

    collective = base_kind == "mln"

    def full_round_over(act_list):
        """One host-visible full round: one call per bin with active
        rows, each rank on its slice; one bitset reduction, and for MMP
        one gather of the labels, a round (the rows' ``x`` is not
        gathered: the host reads it only through the bitset).  Returns
        (newly matched gids, messages).  Mutates m_bits/m_plus."""
        nonlocal dispatches, evals, rounds, full_rounds, m_bits, m_plus
        act_masks = masks_for(act_list)
        history.append(len(act_list))
        rounds += 1
        full_rounds += 1
        want_labels = scheme == "mmp" and collective
        m_bits_dev = put_replicated(m_bits, mesh)
        hit = torch.zeros(Np, dtype=torch.bool, device=dev)
        labelled = []  # (bin, its active rows, this rank's (m, P) labels)
        with obs_span("rounds.full", active=len(act_list)):
            for k in bin_ks:
                am = act_masks[k]
                if not am.any():
                    continue
                lo, hi = row_slice[k]
                rows_np = np.flatnonzero(am)
                mine = rows_np[(rows_np >= lo) & (rows_np < hi)]
                dispatches += 1
                evals += len(rows_np)
                P = bins[k].pair_mask.shape[1]
                spec = BinRoundSpec(kind=base_kind, num_pairs=P, universe_size=Np)
                # no collective a bin: the round's own come after the loop
                round_fn = build_bin_round_fn(spec, mesh, ())
                active_local = np.zeros(hi - lo, dtype=bool)
                active_local[mine - lo] = True
                sl = slice(lo, hi)
                _, lab, bits = round_fn(tuple(a[sl] for a in ground_of(k)), dev_uidx[k][sl],
                                        dev_pmask[k][sl], active_local, m_bits_dev)
                hit |= bits
                if want_labels:
                    labelled.append((k, rows_np, lab))
            new_bits = np.array(host_array(mesh.reduce_bits(hit))) | m_bits
        round_msgs: list[list[int]] = []
        if labelled:
            flat = torch.cat([lab.reshape(-1) for _, _, lab in labelled])
            every = host_array(mesh.gather_rows(flat))  # (ranks, sum m*P)
            off = 0
            for k, rows_np, lab in labelled:
                m, P = lab.shape
                whole = every[:, off:off + m * P].reshape(mesh.size * m, P)
                off += m * P
                round_msgs += _labels_to_messages(
                    bins[k].pair_gid[rows_np], whole[rows_np], m_plus
                )
        newly = universe[new_bits & ~m_bits]
        m_bits = new_bits
        m_plus = m_plus.union(newly)
        return newly, round_msgs

    if scheme == "nomp":
        # one round, no exchange: a single fused call for cheap
        # matchers, one call per bin for the collective MLN — and per
        # bin in spill mode, where an all-bins fused call would hold
        # every bin's tensors at once.
        if active:
            if collective or spill_mode:
                full_round_over(active)
            else:
                bits, rounds, evals, history = fused_call(
                    base_kind, masks_for(active), 1
                )
                m_plus = m_plus.union(universe[bits & ~m_bits])
        return finish()

    if scheme == "smp" and not collective and not spill_mode:
        # greedy/rules matchers: the whole multi-round closure is ONE
        # fused call — every round body is a cheap batched fixpoint.
        # (In spill mode this falls through to the per-bin round loop
        # below, which stages one bin's tensors at a time.)
        if active:
            bits, rounds, evals, history = fused_call(
                base_kind, masks_for(active), max_rounds
            )
            m_plus = m_plus.union(universe[bits & ~m_bits])
        return finish()

    # -- SMP and MMP: host-visible full rounds + fused greedy segments. ---
    # Re-activation rounds only propagate evidence, so they run as
    # greedy closure inside the fused loop; a full round over every
    # neighborhood runs at each quiescence point (and first), so the
    # fixpoint is closed under the full matcher (Prop. 6 + Thm. 2/4).
    # Spill mode disables the fused segments outright (they stage every
    # bin at once): each round is per-bin full calls.
    greedy_ok = fast_rounds and collective and not spill_mode
    full_round = True
    seeds = list(active)
    bits0 = m_bits.copy()

    def certify_rows():
        """Neighborhoods a quiescence full round must re-check: the
        seeds plus every neighborhood slot-incident to a bit set during
        this run.  Any other neighborhood was at the carried fixpoint
        with unchanged evidence projection, so the full matcher can add
        nothing there — on the streaming path this keeps quiescence
        checks O(dirty + affected), not O(unresolved corpus)."""
        cand = set(seeds)
        changed = universe[m_bits & ~bits0]
        if len(changed):
            cand.update(packed.neighborhoods_of_slot_pairs(changed))
        return sorted(cand)

    active = live_rows(active)
    if scheme == "mmp" and seeds and not active:
        # every seed is inert, but the (streaming-persistent) pool must
        # still be replayed against the current grounding — exactly what
        # run_mmp's step 7 does after evaluating those seeds
        m_plus2, promoted = promoter.promote(pool, m_plus)
        promoted_total += promoted
        if promoted:
            extra = m_plus2.difference(m_plus)
            m_plus = m_plus2
            _set_bits(m_bits, universe, extra)
            active = packed.neighborhoods_of_slot_pairs(extra)
    while active and rounds < max_rounds:
        if greedy_ok and not full_round:
            bits, r, ev, hist = fused_call(
                "mln_greedy", masks_for(active), max_rounds - rounds
            )
            rounds += r
            evals += ev
            history += hist
            newly = universe[bits & ~m_bits]
            m_bits = bits
            m_plus = m_plus.union(newly)
            if scheme == "mmp":
                m_plus2, promoted = promoter.promote(pool, m_plus)
                promoted_total += promoted
                if promoted:
                    extra = m_plus2.difference(m_plus)
                    m_plus = m_plus2
                    _set_bits(m_bits, universe, extra)
                    active = packed.neighborhoods_of_slot_pairs(extra)
                    if active:
                        continue
            # greedy closure quiescent: one full round over every
            # certifiable neighborhood that still has an undecided
            # candidate slot (fresh maximal messages / collective
            # promotions) before declaring the fixpoint
            full_round = True
            active = live_rows(certify_rows())
            continue

        newly, round_msgs = full_round_over(active)
        if scheme == "mmp":
            for msg in round_msgs:
                pool.add_message(msg)
                emitted += 1
            m_plus2, promoted = promoter.promote(pool, m_plus)
            promoted_total += promoted
            if promoted:
                extra = m_plus2.difference(m_plus)
                newly = np.unique(np.concatenate([newly, extra]))
                m_plus = m_plus2
                _set_bits(m_bits, universe, extra)
        active = (
            packed.neighborhoods_of_slot_pairs(newly) if len(newly) else []
        )
        if greedy_ok and active:
            full_round = False
    return finish()


def _run_parallel_legacy(
    packed: PackedCover,
    matcher,
    gg: GlobalGrounding | None,
    *,
    scheme: str,
    max_rounds: int,
    fast_rounds: bool,
    active: list[int] | None,
    init_matches: MatchStore | None,
    pool: MessagePool | None,
    t0: float,
    universe: np.ndarray,
    device: torch.device,
    mesh: EMMesh,
) -> EMResult:
    """The pre-fusion host round loop: one call per bin per round,
    re-grounding from raw arrays every time, per-row message walks.
    Kept as the differential baseline (the tests assert bit-for-bit
    equality with the fused engine).  Over a mesh each bin's selected
    rows are padded to a multiple of the rank count (:func:`_pad_rows`)
    and each rank evaluates its slice; the bitset is OR-reduced and the
    rows' ``x``/labels all-gathered a call."""
    Np = len(universe)
    bins = _prepare_bins(packed, universe)

    m_plus = init_matches if init_matches is not None else MatchStore()
    m_bits = _seed_bits(universe, m_plus)
    if pool is None:
        pool = MessagePool()
    active = (
        list(active) if active is not None else list(range(packed.num_neighborhoods))
    )
    evals = 0
    emitted = 0
    promoted_total = 0
    rounds = 0
    dispatches = 0
    host_scans = 0
    history: list[int] = []

    # MMP fast rounds: greedy closure for re-activations, full maximal-
    # message inference on the first round and at each quiescence point.
    full_round = True

    while active and rounds < max_rounds:
        history.append(len(active))
        rounds += 1
        new_bits = m_bits.copy()
        round_msgs: list[list[int]] = []
        use_greedy = (
            scheme == "mmp" and fast_rounds and not full_round
            and isinstance(matcher, MLNMatcher) and matcher.collective
        )
        m_bits_dev = put_replicated(m_bits, mesh)
        for k, rows in sorted(packed.rows_for(active).items()):
            bt = bins[k]
            gid_rows = bt.pair_gid[rows]
            n_rows = len(rows)
            spec = _matcher_spec(matcher, k, Np)
            if use_greedy:
                spec = dataclasses.replace(spec, matcher_kind="mln_greedy")
            sel = _pad_rows(
                [bt.entity_mask[rows], bt.coauthor[rows], bt.sim_level[rows],
                 bt.pair_mask[rows], bt.uidx[rows]], mesh.size,
            )
            lo, hi = mesh.row_slice(len(sel[0]))
            mesh.rows_evaluated += max(min(hi, n_rows) - lo, 0)
            round_fn = build_round_fn(spec, mesh, tuple(mesh.axis_names))
            x, lab, bits = round_fn(*(a[lo:hi] for a in sel), m_bits_dev)
            x, lab = x[:n_rows], lab[:n_rows]
            dispatches += 1
            x = host_array(x)
            new_bits |= host_array(bits)
            evals += n_rows
            if scheme == "mmp":
                round_msgs.extend(_labels_to_messages(gid_rows, host_array(lab), m_plus))
            if scheme == "nomp":
                # no exchange: collect matches directly, never re-activate
                for r in range(n_rows):
                    sel_gids = gid_rows[r][x[r] & (gid_rows[r] >= 0)]
                    m_plus = m_plus.union(sel_gids)

        if scheme == "nomp":
            break

        newly = universe[new_bits & ~m_bits]
        m_bits = new_bits
        m_plus = m_plus.union(newly)

        if scheme == "mmp":
            for msg in round_msgs:
                pool.add_message(msg)
                emitted += 1
            m_plus2, promoted = _promote(pool, gg, m_plus)
            host_scans += 1
            promoted_total += promoted
            if promoted:
                extra = m_plus2.difference(m_plus)
                newly = np.unique(np.concatenate([newly, extra]))
                m_plus = m_plus2
                _set_bits(m_bits, universe, extra)

        active = packed.neighborhoods_of_pairs(newly) if len(newly) else []

        if scheme == "mmp" and fast_rounds:
            if active:
                full_round = False  # evidence to propagate: greedy rounds
            elif use_greedy or not full_round:
                # quiescent after greedy rounds: one full round to emit
                # fresh maximal messages before declaring the fixpoint
                full_round = True
                active = list(range(packed.num_neighborhoods))

    return EMResult(
        matches=m_plus,
        neighborhood_evals=evals,
        rounds=rounds,
        messages_emitted=emitted,
        messages_promoted=promoted_total,
        wall_time_s=time.perf_counter() - t0,
        history=history,
        dispatches=dispatches,
        promote_host_scans=host_scans,
    )
