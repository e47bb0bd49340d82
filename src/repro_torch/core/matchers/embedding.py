"""Embedding-similarity matcher: batched encoder forward + score memo.

The expensive-scorer case the neighborhood decomposition exists to
amortize (the LLM-EM line of PAPERS.md): every pairwise score is a
cosine between per-entity embeddings produced by a *batched* encoder
forward pass.  The matcher keeps an append-only per-entity embedding
memo, so under stream ingest only the **dirty** (never-seen) entity ids
are re-encoded — one batched encoder invocation per matcher call, with
``encode_calls`` / ``encoded_ids`` counters the O(dirty) tests assert
against.

Three encoders:

``hash``
    A deterministic synthetic encoder: entity ids ``2m`` / ``2m + 1``
    share a bucket vector plus small per-id noise (cosine ~0.98 inside
    a bucket, ~0 across buckets).  Needs no names — works on any
    neighborhood batch — and is the default for tests/benchmarks.
``ngram``
    Character-trigram profiles (:func:`repro_torch.core.similarity.
    ngram_profiles`) of the entity's *name*; bind the id -> name table
    with :meth:`EmbeddingMatcher.bind_names` (the streaming
    ``DeltaCover.names`` list is a valid target).
``lm``
    A real model forward: name bytes -> tokens -> prefill logits,
    mean-pooled and L2-normalized via :meth:`repro_torch.serve.engine.Engine.
    encode` on a tiny dense LM (the ``em_encoder`` config), on the
    matcher's ``device``: each prefill runs the ``flash_attn`` kernel
    once a layer.  Ids without a bound name fall back to the hash
    embedding, keeping the encoder total and deterministic.  Its weights
    are drawn on the CPU from a ``torch.Generator`` seeded with ``seed``
    and then placed on the device, so a card run and a CPU run agree;
    ``lm_params`` hands in a model instead (e.g. another producer's
    weights carried across by :func:`repro_torch.interop.
    lm_params_from_numpy`).

``hash`` and ``ngram`` are host numpy, as is the cosine of the memo's
vectors, so their masks and scores are those of the reference bit for
bit.

Well-behavedness: embeddings are deterministic per entity id and
evidence-independent, so the output ``(sim >= tau | ev_pos) & pair_mask
& ~ev_neg`` is idempotent and monotone in both evidence sets (Defs.
2/3); pairwise-independent scores make entity monotonicity hold too.
``score`` is modular (sum of ``sim - tau`` margins) hence supermodular
with equality (Def. 6).  The family emits no multi-pair messages
(labels = P), so NO-MP, SMP and MMP fixpoints coincide; on device it
registers the host-ground backend kind ``"embed"`` in
:mod:`repro_torch.core.parallel`.
"""

from __future__ import annotations

import numpy as np

from repro_torch.core import pairs as pairlib
from repro_torch.core.types import NeighborhoodBatch
from repro_torch.kernels.common import resolve_device

# the ``lm`` encoder's model: a 2-layer dense LM over byte tokens
EM_ENCODER = dict(name="em_encoder", family="dense", n_layers=2, d_model=32,
                  n_heads=4, n_kv_heads=4, d_ff=64, vocab_size=256)


def _hash_embed(ids: np.ndarray, dim: int, seed: int) -> np.ndarray:
    """Deterministic per-id embedding: bucket (id // 2) + per-id noise."""
    out = np.empty((len(ids), dim), dtype=np.float32)
    for n, i in enumerate(ids):
        i = int(i)
        base = np.random.default_rng((seed, 7, i // 2)).standard_normal(dim)
        base /= np.linalg.norm(base)
        noise = np.random.default_rng((seed, 11, i)).standard_normal(dim)
        noise /= np.linalg.norm(noise)
        v = base + 0.15 * noise
        out[n] = (v / np.linalg.norm(v)).astype(np.float32)
    return out


class EmbeddingMatcher:
    """Type-II matcher scoring pairs by embedding cosine >= ``tau``.

    ``device=None`` runs on CUDA (and raises when there is none); pass
    ``device="cpu"`` for the CPU.  The device runs the ``lm`` encoder
    and the parallel engine's ``embed`` grounding tensors.
    """

    is_probabilistic = True

    def __init__(self, *, encoder: str = "hash", tau: float = 0.92,
                 dim: int = 32, seed: int = 0, lm_params=None, device=None):
        if encoder not in ("hash", "ngram", "lm"):
            raise ValueError(f"unknown encoder {encoder!r}")
        self.encoder = encoder
        self.tau = float(tau)
        self.dim = int(dim)
        self.seed = int(seed)
        self.device = resolve_device(device)
        self._memo: dict[int, np.ndarray] = {}  # append-only: id -> vec
        self._names: list | None = None  # id -> name view (mutated by owner)
        self._lm_params = lm_params  # lm encoder: a model to use, else drawn
        self._engine = None  # lazy: lm encoder only
        self.encode_calls = 0  # batched encoder invocations
        self.encoded_ids = 0  # total ids ever encoded (O(dirty) counter)

    def bind_names(self, names_ref: list) -> None:
        """Attach the id -> name table (e.g. ``DeltaCover.names``); a
        live reference, read at encode time."""
        self._names = names_ref

    # -- encoding ----------------------------------------------------------
    def _name_of(self, i: int):
        if self._names is not None and 0 <= i < len(self._names):
            return self._names[i]
        return None

    def _lm_engine(self):
        if self._engine is None:
            from repro_torch.configs.base import ModelConfig
            from repro_torch.models.param import init_params
            from repro_torch.models.registry import get_model
            from repro_torch.serve.engine import Engine

            api = get_model(ModelConfig(**EM_ENCODER))
            params = self._lm_params
            if params is None:
                params = api.load(
                    init_params(api.param_specs(), seed=self.seed, device="cpu")
                )
            self._engine = Engine(api, params, batch=8, s_max=32, device=self.device)
        return self._engine

    def _encode_batch(self, ids: np.ndarray) -> np.ndarray:
        """One batched encoder forward over ``ids`` (all unseen)."""
        if self.encoder == "hash":
            return _hash_embed(ids, self.dim, self.seed)
        names = [self._name_of(int(i)) for i in ids]
        known = [n for n, nm in enumerate(names) if nm is not None]
        out = _hash_embed(ids, self.dim, self.seed)  # nameless fallback
        if not known:
            return out
        if self.encoder == "ngram":
            from repro_torch.core.similarity import ngram_profiles

            vecs = ngram_profiles([names[n] for n in known], dim=self.dim)
        else:  # lm
            prompts = [
                np.frombuffer(
                    names[n].encode("utf-8", "ignore"), dtype=np.uint8
                ).astype(np.int32)[:32]
                for n in known
            ]
            prompts = [p if len(p) else np.zeros(1, np.int32) for p in prompts]
            vecs = self._lm_engine().encode(prompts)
        if vecs.shape[1] != out.shape[1]:
            out = np.zeros((len(ids), vecs.shape[1]), dtype=np.float32)
            out[:, 0] = 1.0  # nameless fallback: shared unit axis
        out[known] = vecs
        return out

    def _ensure(self, ids: np.ndarray) -> None:
        """Encode the not-yet-memoized ids in one batched call."""
        fresh = np.unique(ids[ids >= 0])
        fresh = np.array(
            [i for i in fresh if int(i) not in self._memo], dtype=np.int64
        )
        if not len(fresh):
            return
        vecs = self._encode_batch(fresh)
        self.encode_calls += 1
        self.encoded_ids += len(fresh)
        for i, v in zip(fresh, vecs):
            self._memo[int(i)] = v

    # -- grounding ---------------------------------------------------------
    def ground_rows(
        self, entity_ids: np.ndarray, pair_mask: np.ndarray
    ) -> tuple[np.ndarray, np.ndarray]:
        """(base, valid) masks for raw (B, k) id rows — the parallel
        backend's host grounding (kind ``"embed"``)."""
        ids = np.asarray(entity_ids)
        pm = np.asarray(pair_mask, dtype=bool)
        self._ensure(ids)
        B, k = ids.shape
        ii, jj = pairlib.triu_indices(k)
        dim = len(next(iter(self._memo.values()))) if self._memo else self.dim
        E = np.zeros((B, k, dim), dtype=np.float32)
        for b in range(B):
            for s in range(k):
                v = self._memo.get(int(ids[b, s]))
                if v is not None:
                    E[b, s] = v
        sims = (E[:, ii] * E[:, jj]).sum(axis=-1)
        base = (sims >= self.tau) & pm
        return base, pm

    def _sims(self, batch: NeighborhoodBatch) -> np.ndarray:
        ids = np.asarray(batch.entity_ids)
        pm = np.asarray(batch.pair_mask, dtype=bool)
        self._ensure(ids)
        k = batch.k
        ii, jj = pairlib.triu_indices(k)
        dim = len(next(iter(self._memo.values()))) if self._memo else self.dim
        E = np.zeros(ids.shape + (dim,), dtype=np.float32)
        for b in range(ids.shape[0]):
            for s in range(ids.shape[1]):
                v = self._memo.get(int(ids[b, s]))
                if v is not None:
                    E[b, s] = v
        return np.where(pm, (E[:, ii] * E[:, jj]).sum(axis=-1), -1.0)

    # -- Type-I interface --------------------------------------------------
    def run(
        self,
        batch: NeighborhoodBatch,
        ev_pos: np.ndarray | None = None,
        ev_neg: np.ndarray | None = None,
    ) -> np.ndarray:
        pm = np.asarray(batch.pair_mask, dtype=bool)
        x = self._sims(batch) >= self.tau
        if ev_pos is not None:
            x = x | np.asarray(ev_pos, dtype=bool)
        x = x & pm
        if ev_neg is not None:
            x = x & ~np.asarray(ev_neg, dtype=bool)
        return x

    def run_with_messages(
        self,
        batch: NeighborhoodBatch,
        ev_pos: np.ndarray | None = None,
        ev_neg: np.ndarray | None = None,
    ) -> tuple[np.ndarray, np.ndarray]:
        x = self.run(batch, ev_pos, ev_neg)
        B, P = x.shape
        return x, np.full((B, P), P, dtype=np.int32)

    # -- Type-II interface -------------------------------------------------
    def score(self, batch: NeighborhoodBatch, x: np.ndarray) -> np.ndarray:
        """Modular: sum of cosine margins over the selected valid pairs."""
        pm = np.asarray(batch.pair_mask, dtype=bool)
        sims = self._sims(batch)
        sel = np.asarray(x, dtype=bool) & pm
        return np.where(sel, sims - self.tau, 0.0).sum(axis=1)

    # -- parallel backend --------------------------------------------------
    def parallel_backend(self) -> tuple[str, "EmbeddingMatcher"]:
        """Host-ground backend key for the round-parallel engine."""
        return ("embed", self)
