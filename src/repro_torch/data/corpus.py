"""LM training data: the synthetic corpus (numpy only, no device).

Documents are synthesized from a power-law unigram model (Zipfian token
frequencies, like natural text) with a controllable rate of
*near-duplicate* documents, the workload of the EM-based corpus dedup
(:mod:`repro_torch.data.dedup`).

Determinism and restartability: batch ``i`` is a pure function of
``(seed, i)`` (counter-based RNG), so a restored run resumes at ``step``
with no loader state to persist.  That holds across numpy releases too:
the Zipf draws come from :func:`zipf`, numpy 2.0's sampler written over
the generator's uniform doubles, where ``Generator.zipf`` itself changed
its algorithm in a later release and draws other corpora there.

:class:`Loader` prefetches batches on the host; with a ``mesh`` it hands
each rank its rows of every global batch (:func:`shard_batch`), so a
restart on another rank count replays the same global batches.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np

_INT64_MAX = float(np.iinfo(np.int64).max)


def _pow(x: float, y: float) -> float:
    """libm's ``pow``, per element (numpy's vectorised ``power`` may differ
    from it in the last place), with C's inf on overflow."""
    try:
        return math.pow(x, y)
    except OverflowError:
        return math.inf


_pow_each = np.frompyfunc(_pow, 2, 1)


def zipf(rng: np.random.Generator, a: float, size) -> np.ndarray:
    """Zipf(``a``) int64 samples of shape ``size``, as numpy 2.0's
    ``Generator.zipf`` draws them from ``rng``: Devroye's rejection method,
    two uniform doubles ``u, v`` an attempt, ``U = 1 - u``,
    ``X = floor(U ** (-1 / (a - 1)))``, kept when ``X`` fits an int64 and
    ``v X (T - 1) / (b - 1) <= T / b`` with ``T = (1 + 1 / X) ** (a - 1)`` and
    ``b = 2 ** (a - 1)``.  The attempts are evaluated in bulk, then the
    generator is left exactly past the last attempt used."""
    n = int(np.prod(size))
    if n == 0:
        return np.zeros(size, dtype=np.int64)
    am1 = a - 1.0
    b = 2.0 ** am1
    start = rng.bit_generator.state
    parts, found, used = [], 0, 0
    while found < n:
        m = 2 * (n - found) + 64  # attempts drawn in this pass
        u = rng.random(2 * m)
        U, V = 1.0 - u[0::2], u[1::2]
        X = np.floor(_pow_each(U, -1.0 / am1).astype(np.float64))
        ok = (X >= 1.0) & (X <= _INT64_MAX)
        Xs = np.where(ok, X, 1.0)
        T = _pow_each(1.0 + 1.0 / Xs, am1).astype(np.float64)
        ok &= V * Xs * (T - 1.0) / (b - 1.0) <= T / b
        idx = np.flatnonzero(ok)[: n - found]
        parts.append(X[idx])
        found += len(idx)
        used += int(idx[-1]) + 1 if found == n else m
    rng.bit_generator.state = start
    rng.random(2 * used)
    return np.concatenate(parts).astype(np.int64).reshape(size)


@dataclasses.dataclass(frozen=True)
class CorpusConfig:
    vocab_size: int = 32000
    seq_len: int = 1024
    global_batch: int = 8
    seed: int = 0
    # document model
    doc_len_mean: int = 512
    dup_rate: float = 0.15  # fraction of near-duplicate docs
    zipf_a: float = 1.2


class TokenStream:
    """Deterministic (seed, step) -> batch of token ids + targets."""

    def __init__(self, cfg: CorpusConfig):
        self.cfg = cfg

    def batch(self, step: int) -> dict[str, np.ndarray]:
        cfg = self.cfg
        rng = np.random.default_rng(np.random.SeedSequence([cfg.seed, step, 0xC0FFEE]))
        # Zipf over vocab, shifted so token 0 is reserved for padding/BOS
        z = zipf(rng, cfg.zipf_a, (cfg.global_batch, cfg.seq_len + 1))
        toks = (z % (cfg.vocab_size - 1)).astype(np.int32) + 1
        return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}

    def batches(self, start_step: int = 0):
        step = start_step
        while True:
            yield self.batch(step)
            step += 1


def make_documents(cfg: CorpusConfig, n_docs: int) -> tuple[list[np.ndarray], np.ndarray]:
    """Document collection with injected near-duplicates (for dedup).

    Returns (docs, dup_of) where ``dup_of[i]`` is the index of the
    original document i duplicates, or -1 for originals: the ground truth
    for evaluating the dedup pipeline.
    """
    rng = np.random.default_rng(cfg.seed)
    docs: list[np.ndarray] = []
    dup_of = np.full(n_docs, -1, dtype=np.int64)
    for d in range(n_docs):
        if docs and rng.random() < cfg.dup_rate:
            # near-duplicate of an earlier doc: token dropout + noise
            j = int(rng.integers(0, len(docs)))
            src = docs[j]
            keep = rng.random(len(src)) > 0.03
            dup = src[keep].copy()
            flips = rng.random(len(dup)) < 0.01
            dup[flips] = rng.integers(1, cfg.vocab_size, size=int(flips.sum()))
            docs.append(dup)
            dup_of[d] = dup_of[j] if dup_of[j] >= 0 else j
        else:
            n = max(16, int(rng.normal(cfg.doc_len_mean, cfg.doc_len_mean / 4)))
            z = zipf(rng, cfg.zipf_a, n)
            docs.append((z % (cfg.vocab_size - 1)).astype(np.int32) + 1)
    return docs, dup_of


def batch_dim(x) -> int:
    """The global-batch dim of a batch leaf (M-RoPE positions are (3, B, S))."""
    return 1 if (len(x.shape) >= 2 and x.shape[0] == 3) else 0


def shard_batch(batch: dict, mesh, data_axes=("data",), microbatched: bool = False) -> dict:
    """This rank's rows of a host batch, on its device: each leaf's batch
    dim (:func:`batch_dim`, one further right for a pre-split batch's
    leading microbatch axis) sharded over the mesh's ``data_axes``, the
    major axis first, as the reference's ``NamedSharding(mesh,
    P(data_axes))`` lays the batch out.  A pre-split batch is sharded
    microbatch by microbatch: rank ``r`` holds rows of every microbatch."""
    from repro_torch.launch.mesh import NamedSharding

    axes = tuple(a for a in data_axes if a in mesh.mesh_dim_names) or None
    sizes = dict(zip(mesh.mesh_dim_names, mesh.shape))
    ranks = int(np.prod([sizes[a] for a in axes or ()]))
    out = {}
    for k, v in batch.items():
        d = batch_dim(v[0] if microbatched else v) + int(microbatched)
        if v.shape[d] % ranks:
            raise ValueError(f"{k}: {v.shape[d]} rows do not split over {ranks} ranks")
        spec = [None] * v.ndim
        spec[d] = axes
        out[k] = NamedSharding(mesh, tuple(spec)).local(np.asarray(v))
    return out


class Loader:
    """Prefetching loader: ``prefetch`` batches are drawn ahead of the one
    handed out, so batch synthesis can overlap a step.  Yields host (numpy)
    global batches from ``start_step`` on, or with a ``mesh`` (a
    ``DeviceMesh``) this rank's rows on its device (:func:`shard_batch`)."""

    def __init__(self, cfg: CorpusConfig, mesh=None, prefetch: int = 2,
                 start_step: int = 0, data_axes=("data",)):
        self.stream = TokenStream(cfg)
        self.mesh = mesh
        self.prefetch = prefetch
        self.start_step = start_step
        self.data_axes = data_axes

    def __iter__(self):
        import collections

        q: collections.deque = collections.deque()
        step = self.start_step
        while True:
            while len(q) <= self.prefetch:
                b = self.stream.batch(step)
                if self.mesh is not None:
                    b = shard_batch(b, self.mesh, self.data_axes)
                q.append(b)
                step += 1
            yield q.popleft()
