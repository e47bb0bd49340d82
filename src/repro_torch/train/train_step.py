"""Train-step factory: microbatched gradient accumulation over a trainable model.

``make_train_step(api, opt_cfg, microbatches=n)`` returns
``train_step(model, opt_state, batch) -> (model, opt_state, metrics)``.
``model`` is ``api.load(tree, trainable=True)``; its f32 master
parameters are updated in place, and ``opt_state`` holds the moments
keyed by the model's parameter names (``optimizer.init_opt_state`` of
``dict(model.named_parameters())``).

With ``microbatches > 1`` the batch is split on the host first
(:func:`split_microbatches`): every leaf has a leading microbatch axis,
and the gradients are accumulated in f32 as ``acc + g / n``, microbatch
by microbatch from zero, in the reference's order.  Activation
checkpointing happens inside the model's layer loop
(``cfg.remat_group``, :mod:`repro_torch.models.scan_utils`).

The reference's compressed cross-pod exchange (``compress_pods=True``)
and its dry-run specs (``microbatched_specs``) need a device mesh; they
wait for the multi-device slice (``ROADMAP.md`` Queue 1 item 15).
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.models.param import unported, unported_fn
from repro_torch.models.registry import ModelAPI
from repro_torch.train.optimizer import OptConfig, adamw_update


def _batch_dim(x) -> int:
    """The global-batch dim of a batch leaf (positions are (3, B, S))."""
    return 1 if (x.ndim >= 2 and x.shape[0] == 3) else 0


def split_microbatches(batch: dict, n: int) -> dict:
    """Host-side (B, ...) -> (n, B/n, ...) split, microbatch axis leading."""
    if n <= 1:
        return batch

    def f(x):
        x = np.asarray(x)
        d = _batch_dim(x)
        B = x.shape[d]
        assert B % n == 0, f"batch {B} not divisible by microbatches {n}"
        y = x.reshape(*x.shape[:d], n, B // n, *x.shape[d + 1:])
        return np.moveaxis(y, d, 0)

    return {k: f(v) for k, v in batch.items()}


microbatched_specs = unported_fn("microbatched_specs", item=15)


def make_train_step(api: ModelAPI, opt_cfg: OptConfig, *, microbatches: int = 1,
                    compress_pods: bool = False, mesh=None):
    """Build the train step for this model (see the module docstring)."""
    if compress_pods or mesh is not None:
        raise unported("the compressed cross-pod train step", item=15)

    def grads_of(model, mb):
        names, params = zip(*model.named_parameters())
        loss, metrics = api.loss(model, mb)
        grads = torch.autograd.grad(loss, params, allow_unused=True)
        # a leaf the loss never reads (Whisper's cross-attention biases)
        # has the gradient 0, as under jax.grad
        grads = {n: torch.zeros_like(p) if g is None else g
                 for n, p, g in zip(names, params, grads)}
        return loss.detach(), {k: v.detach() for k, v in metrics.items()}, grads

    def compute_grads(model, batch):
        if microbatches == 1:
            return grads_of(model, batch)
        acc, losses, metricses = None, [], []
        for i in range(microbatches):
            loss, metrics, grads = grads_of(model, {k: v[i] for k, v in batch.items()})
            if acc is None:
                acc = {n: torch.zeros(g.shape, dtype=torch.float32, device=g.device)
                       for n, g in grads.items()}
            acc = {n: acc[n] + grads[n].float() / microbatches for n in acc}
            losses.append(loss)
            metricses.append(metrics)
        metrics = {k: torch.stack([m[k] for m in metricses]).mean() for k in metricses[0]}
        return torch.stack(losses).mean(), metrics, acc

    def train_step(model, opt_state, batch):
        loss, metrics, grads = compute_grads(model, batch)
        params = dict(model.named_parameters())
        new_params, opt_state, opt_metrics = adamw_update(opt_cfg, params, grads, opt_state)
        with torch.no_grad():
            for name, p in params.items():
                p.copy_(new_params[name])
        return model, opt_state, {"loss": loss, **metrics, **opt_metrics}

    return train_step
