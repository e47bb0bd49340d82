"""Batched serving engine: prefill + greedy decode over a KV cache.

A deliberately small but real engine, the reference's
(``repro.serve.engine``): a fixed decode batch, a request list served
in groups (a short group is padded with copies of its last prompt),
greedy sampling.  Every prefill runs the ``flash_attn`` kernel in each
layer; decode attention is plain tensor code over the cache.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.kernels.common import resolve_device
from repro_torch.models.param import init_params
from repro_torch.models.registry import ModelAPI


@dataclasses.dataclass
class Request:
    prompt: np.ndarray  # (S,) int32
    max_new: int = 16
    out: list[int] = dataclasses.field(default_factory=list)


class Engine:
    """Serves ``api``'s model ``params`` on ``device`` (``None``: CUDA)."""

    def __init__(self, api: ModelAPI, params, batch: int, s_max: int, device=None):
        assert api.prefill is not None, f"{api.cfg.family} has no prefill"
        self.device = resolve_device(device)
        self.api = api
        self.params = params.to(self.device)
        self.batch = batch
        self.s_max = s_max

    def _prefill(self, tokens: np.ndarray):
        toks = torch.as_tensor(tokens, device=self.device)
        return self.api.prefill(self.params, toks, self.s_max)

    def _decode(self, cache, batch: dict):
        return self.api.decode(self.params, cache, batch)

    def generate(self, prompts: list[np.ndarray], max_new: int = 16) -> list[list[int]]:
        """Serve a list of equal-length prompts in batches."""
        outs: list[list[int]] = []
        for lo in range(0, len(prompts), self.batch):
            group = prompts[lo : lo + self.batch]
            pad = self.batch - len(group)
            toks = np.stack(list(group) + [group[-1]] * pad)
            outs.extend(self._generate_batch(toks, max_new)[: len(group)])
        return outs

    def encode(self, prompts: list[np.ndarray]) -> np.ndarray:
        """Embed token sequences: one prefill per padded batch, mean-pool
        the logits over real positions, L2-normalize.  Returns (N, vocab)
        float32.

        As in the reference, ``prefill`` returns the last position's
        logits only, and the tokens are zero-padded to ``s_max``: every
        vector is the normalized logits at position ``s_max - 1``.
        """
        out = []
        for lo in range(0, len(prompts), self.batch):
            group = prompts[lo : lo + self.batch]
            pad = self.batch - len(group)
            lens = np.array([len(p) for p in group] + [len(group[-1])] * pad, np.int32)
            toks = np.zeros((self.batch, self.s_max), np.int32)
            for i, p in enumerate(list(group) + [group[-1]] * pad):
                toks[i, : len(p)] = p[: self.s_max]
            logits, _cache = self._prefill(toks)
            mask = np.arange(self.s_max)[None, :] < np.minimum(lens, self.s_max)[:, None]
            pooled = logits.cpu().numpy() * mask[:, :, None]
            pooled = pooled.sum(axis=1) / np.maximum(mask.sum(axis=1, keepdims=True), 1)
            norm = np.linalg.norm(pooled, axis=-1, keepdims=True)
            pooled = pooled / np.maximum(norm, 1e-9)
            out.append(pooled[: len(group)].astype(np.float32))
        return np.concatenate(out, axis=0)

    def _generate_batch(self, tokens: np.ndarray, max_new: int) -> list[list[int]]:
        B, S = tokens.shape
        logits, cache = self._prefill(tokens)
        seqs: list[list[int]] = [[] for _ in range(B)]
        cur = torch.argmax(logits[:, -1, :], dim=-1).to(torch.int32)
        for t in range(max_new):
            for b, tok in enumerate(cur.tolist()):
                seqs[b].append(tok)
            batch = {
                "tokens": cur[:, None],
                "pos": torch.full((B,), S + t, dtype=torch.int32, device=self.device),
            }
            logits, cache = self._decode(cache, batch)
            cur = torch.argmax(logits[:, 0, :], dim=-1).to(torch.int32)
        return seqs


def demo_engine(api: ModelAPI, batch: int = 2, s_max: int = 64, seed: int = 0, device=None):
    """An engine over random weights drawn on ``device`` (``None``: CUDA)."""
    dev = resolve_device(device)
    params = api.load(init_params(api.param_specs(), seed=seed, device=dev))
    return Engine(api, params, batch, s_max, device=dev)
