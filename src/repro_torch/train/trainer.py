"""Training loop: restartable, preemption-aware, checkpointed, on one device.

Responsibilities:
  * build the trainable model and the optimizer state (or restore the
    latest checkpoint);
  * drive the train step over the deterministic data stream (batch ``i``
    is a pure function of the seed, so a restart at step N replays the
    exact schedule);
  * periodic and preemption-triggered checkpointing (setting
    ``preempted`` makes the loop save synchronously and stop; the
    launcher restarts the job, which resumes from that step).

The state is checkpointed in the reference's layout, ``{"params": <stacked
tree>, "opt": {"m", "v", "step"}}``, so a checkpoint written by either
package restores in the other.  In memory the parameters are the model's
per-layer f32 masters and the moments are keyed by the model's parameter
names; :func:`repro_torch.models.param.stacked_tree` and ``layer_slices``
convert.  The device is CUDA unless ``device`` says otherwise (``None``
raises without a GPU).  Training on a device mesh (``mesh=``) waits for
the multi-device slice (``ROADMAP.md`` Queue 1 item 15).
"""

from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from repro_torch.checkpoint.checkpointer import Checkpointer
from repro_torch.data.corpus import CorpusConfig, TokenStream
from repro_torch.kernels.common import resolve_device
from repro_torch.models.param import unported
from repro_torch.models.param import in_f32, init_params, layer_slices, stacked_tree
from repro_torch.models.registry import ModelAPI
from repro_torch.train.optimizer import OptConfig, init_opt_state
from repro_torch.train.train_step import make_train_step, split_microbatches


@dataclasses.dataclass
class TrainerConfig:
    steps: int = 100
    ckpt_every: int = 50
    log_every: int = 10
    microbatches: int = 1
    seed: int = 0
    ckpt_dir: str | None = None
    keep_ckpts: int = 3
    async_ckpt: bool = True


def checkpoint_state(model, opt: dict | None = None) -> dict:
    """The training state in the reference's checkpoint layout (``params``
    alone without ``opt``).  Leaves may share the live tensors' memory: the
    Checkpointer copies them to the host when it saves."""
    params = {k: p.detach() for k, p in model.named_parameters()}
    if opt is None:
        return {"params": stacked_tree(params)}
    return {"params": stacked_tree(params),
            "opt": {"m": stacked_tree(opt["m"]), "v": stacked_tree(opt["v"]),
                    "step": opt["step"]}}


def state_from_tree(api: ModelAPI, tree: dict, opt_tree: dict | None = None) -> dict:
    """The trainable model of a reference-shaped parameter tree of tensors,
    and its optimizer state: ``opt_tree`` ({"m", "v", "step"}, stacked
    trees) slice by slice, or zeros."""
    model = api.load(tree, trainable=True)
    params = dict(model.named_parameters())
    if opt_tree is None:
        return {"params": model, "opt": init_opt_state(params)}
    opt = {name: {k: t.float().clone() for k, t in layer_slices(opt_tree[name], params).items()}
           for name in ("m", "v")}
    opt["step"] = opt_tree["step"].to(torch.int32)
    return {"params": model, "opt": opt}


class Trainer:
    def __init__(self, api: ModelAPI, data_cfg: CorpusConfig, opt_cfg: OptConfig,
                 cfg: TrainerConfig, mesh=None, device=None):
        if mesh is not None:
            raise unported("training on a device mesh", item=15)
        self.api = api
        self.device = resolve_device(device)
        self.data = TokenStream(data_cfg)
        self.opt_cfg = opt_cfg
        self.cfg = cfg
        self.preempted = False  # set by a signal handler in production
        self.ckpt = (
            Checkpointer(cfg.ckpt_dir, keep=cfg.keep_ckpts, async_save=cfg.async_ckpt)
            if cfg.ckpt_dir
            else None
        )
        self.step_fn = make_train_step(api, opt_cfg, microbatches=cfg.microbatches)

    # -- state ---------------------------------------------------------------
    def init_state(self):
        """The model drawn from ``cfg.seed`` (every leaf in f32), zero moments."""
        tree = init_params(in_f32(self.api.param_specs()), seed=self.cfg.seed,
                           device=self.device)
        return state_from_tree(self.api, tree), 0

    def restore_or_init(self):
        if self.ckpt is not None:
            latest = self.ckpt.latest_step()
            if latest is not None:
                specs = self.api.param_specs()
                templates = {"params": specs, "opt": {
                    "m": specs, "v": specs, "step": np.zeros((), np.int32)}}
                got = self.ckpt.restore(latest, templates, device=self.device)
                return state_from_tree(self.api, got["params"], got["opt"]), latest
        return self.init_state()[0], 0

    # -- loop ----------------------------------------------------------------
    def run(self) -> dict:
        state, start = self.restore_or_init()
        params, opt = state["params"], state["opt"]
        losses = []
        t0 = time.perf_counter()
        step = start
        for step in range(start, self.cfg.steps):
            batch = split_microbatches(self.data.batch(step), self.cfg.microbatches)
            batch = {k: torch.as_tensor(v, device=self.device) for k, v in batch.items()}
            params, opt, metrics = self.step_fn(params, opt, batch)
            if (step + 1) % self.cfg.log_every == 0 or step == start:
                losses.append((step + 1, float(metrics["loss"])))
            if self.ckpt and ((step + 1) % self.cfg.ckpt_every == 0 or self.preempted):
                self.ckpt.save(step + 1, checkpoint_state(params, opt))
                if self.preempted:
                    self.ckpt.wait()
                    break
        if self.ckpt:
            self.ckpt.save(self.cfg.steps, checkpoint_state(params, opt))
            self.ckpt.wait()
        wall = time.perf_counter() - t0
        return {
            "params": params,
            "opt": opt,
            "losses": losses,
            "steps_done": step + 1,
            "wall_time_s": wall,
        }
