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
raises without a GPU).

**On a mesh** (``mesh=``, a ``DeviceMesh`` of ``data`` and/or ``pod``
ranks spanning the joined process group; one process a rank) training is
data-parallel: every rank holds the whole model and its moments, takes
its rows of each global batch (:func:`repro_torch.data.corpus.
shard_batch`), and applies the mean gradient over the ranks
(:func:`repro_torch.train.train_step.make_train_step`).  The reference
lays parameters out by ``shardings(specs, mesh)``, which on such a mesh
drops the absent ``model`` axis; it also keeps the ``data`` entries of
the MoE expert weights, which its compiler gathers back at each use.
Here every leaf is whole on every rank (``Replicate()``): the same step
in memory that fits a rank.  After every step the ranks compare
their parameters' :func:`~repro_torch.train.train_step.replica_digest`
and raise if they differ.

**On a tensor-parallel mesh** (a ``model`` axis of more than one rank, as
the reference's ``Trainer`` takes whatever mesh it is given) each
parameter is laid out by the reference's specs
(:func:`~repro_torch.train.train_step.distribute_model`), the moments are
each rank's shards, the batch's rows are DTensors over the data-parallel
axes, and after every step the ranks that must hold the same bits are
compared (:func:`~repro_torch.train.train_step.tp_replicas_agree`).
Checkpoints gather the whole leaves on every rank first
(:func:`~repro_torch.train.train_step.gathered_state`).  Rank 0 writes the checkpoints, in the same
layout as one device; ``restore_or_init`` re-places a checkpoint of any
rank count under the current mesh (``Checkpointer.restore(mesh=,
shardings=)``), which makes a restart elastic.
"""

from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.checkpoint.checkpointer import Checkpointer
from repro_torch.data.corpus import CorpusConfig, TokenStream, shard_batch
from repro_torch.kernels.common import resolve_device
from repro_torch.launch.mesh import mesh_device
from repro_torch.models.param import in_f32, init_params, layer_slices, stacked_tree
from repro_torch.models.registry import ModelAPI
from repro_torch.train.optimizer import OptConfig, init_opt_state
from repro_torch.train.train_step import (
    data_parallel_group,
    distribute_model,
    dtensor_batch,
    gathered_state,
    local_opt_state,
    make_train_step,
    replicas_agree,
    split_microbatches,
    tensor_parallel,
    tp_replicas_agree,
)


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
    Checkpointer copies them to the host when it saves.  A tensor-parallel
    model's leaves are gathered whole first (a collective of every rank)."""
    params, opt = gathered_state(model, opt)
    if opt is None:
        return {"params": stacked_tree(params)}
    return {"params": stacked_tree(params),
            "opt": {"m": stacked_tree(opt["m"]), "v": stacked_tree(opt["v"]),
                    "step": opt["step"]}}


def state_from_tree(api: ModelAPI, tree: dict, opt_tree: dict | None = None,
                    mesh=None) -> dict:
    """The trainable model of a reference-shaped parameter tree of tensors,
    and its optimizer state: ``opt_tree`` ({"m", "v", "step"}, stacked
    trees) slice by slice, or zeros.  ``mesh`` (tensor-parallel): the model
    laid out over it, and the moments this rank's blocks of theirs."""
    model = api.load(tree, trainable=True)
    params = dict(model.named_parameters())
    tp = tensor_parallel(mesh)
    if tp:
        from repro_torch.train.train_step import param_layout

        layout = param_layout(api, mesh, params)
        model = distribute_model(model, api, mesh)
    if opt_tree is None:
        return {"params": model, "opt": local_opt_state(model) if tp else init_opt_state(params)}

    def block(name, t):
        return t[layout[name].block(t.shape)] if tp else t

    opt = {name: {k: block(k, t).float().clone()
                  for k, t in layer_slices(opt_tree[name], params).items()}
           for name in ("m", "v")}
    opt["step"] = opt_tree["step"].to(torch.int32)
    return {"params": model, "opt": opt}


class Trainer:
    def __init__(self, api: ModelAPI, data_cfg: CorpusConfig, opt_cfg: OptConfig,
                 cfg: TrainerConfig, mesh=None, device=None):
        self.mesh = mesh
        self.tp = tensor_parallel(mesh)
        self.group = None
        if mesh is not None:
            self.group = data_parallel_group(mesh)
            here = mesh_device(mesh)
            if device is not None and resolve_device(device).type != here.type:
                raise ValueError(f"device {device}, but this rank of the mesh is on {here}")
            device = here
            self.dp_axes = tuple(a for a in ("pod", "data") if a in mesh.mesh_dim_names)
        self.api = api
        self.device = resolve_device(device)
        self.writer = mesh is None or dist.get_rank() == 0
        self.data = TokenStream(data_cfg)
        self.opt_cfg = opt_cfg
        self.cfg = cfg
        self.preempted = False  # set by a signal handler in production
        self.ckpt = (
            Checkpointer(cfg.ckpt_dir, keep=cfg.keep_ckpts, async_save=cfg.async_ckpt)
            if cfg.ckpt_dir
            else None
        )
        self.step_fn = make_train_step(api, opt_cfg, microbatches=cfg.microbatches, mesh=mesh)

    # -- state ---------------------------------------------------------------
    def init_state(self):
        """The model drawn from ``cfg.seed`` (every leaf in f32), zero moments."""
        tree = init_params(in_f32(self.api.param_specs()), seed=self.cfg.seed,
                           device=self.device)
        return state_from_tree(self.api, tree, mesh=self.mesh), 0

    def restore_or_init(self):
        if self.ckpt is not None:
            latest = self.ckpt.latest_step()
            if latest is not None:
                specs = self.api.param_specs()
                templates = {"params": specs, "opt": {
                    "m": specs, "v": specs, "step": np.zeros((), np.int32)}}
                if self.mesh is None:
                    got = self.ckpt.restore(latest, templates, device=self.device)
                else:
                    from torch.distributed.tensor import Replicate

                    got = self.ckpt.restore(latest, templates, mesh=self.mesh, shardings={
                        "params": Replicate(), "opt": Replicate()})
                return state_from_tree(self.api, got["params"], got["opt"], self.mesh), latest
        return self.init_state()[0], 0

    def _save(self, step: int, params, opt) -> None:
        """Rank 0 writes the checkpoint; a tensor-parallel state is gathered
        by every rank first."""
        if self.writer or self.tp:
            state = checkpoint_state(params, opt)
            if self.writer:
                self.ckpt.save(step, state)

    # -- loop ----------------------------------------------------------------
    def run(self) -> dict:
        state, start = self.restore_or_init()
        params, opt = state["params"], state["opt"]
        del state  # else the first moments stay alive beside every step's new ones
        losses, digests = [], []
        micro = self.cfg.microbatches
        t0 = time.perf_counter()
        step = start
        saved = None
        for step in range(start, self.cfg.steps):
            batch = split_microbatches(self.data.batch(step), micro)
            if self.mesh is None:
                batch = {k: torch.as_tensor(v, device=self.device) for k, v in batch.items()}
            else:
                batch = shard_batch(batch, self.mesh, self.dp_axes, microbatched=micro > 1)
                if self.tp:
                    batch = dtensor_batch(batch, self.mesh, self.dp_axes, micro > 1)
            params, opt, metrics = self.step_fn(params, opt, batch)
            if self.tp:
                agree, digest = tp_replicas_agree(params, opt, self.mesh)
                if not agree:
                    raise RuntimeError(f"the ranks' shards disagree after step {step + 1}")
                digests.append((step + 1, digest))
            elif self.mesh is not None:
                agree, digest = replicas_agree(dict(params.named_parameters()), self.group)
                if not agree:
                    raise RuntimeError(f"the replicas' parameters differ after step {step + 1}")
                digests.append((step + 1, digest))
            if (step + 1) % self.cfg.log_every == 0 or step == start:
                losses.append((step + 1, float(metrics["loss"])))
            if self.ckpt and ((step + 1) % self.cfg.ckpt_every == 0 or self.preempted):
                self._save(step + 1, params, opt)
                saved = step + 1
                if self.preempted:
                    self.ckpt.wait()
                    break
        # the reference saves the last step once more; the same state under
        # the same step is written once here (5.6 GB for Qwen1.5-0.5B)
        if self.ckpt and saved != self.cfg.steps:
            self._save(self.cfg.steps, params, opt)
        if self.ckpt:
            self.ckpt.wait()
        if self.mesh is not None:
            dist.barrier(self.group)  # every rank returns once the checkpoint is written
        wall = time.perf_counter() - t0
        return {
            "params": params,
            "opt": opt,
            "losses": losses,
            "digests": digests,
            "steps_done": step + 1,
            "wall_time_s": wall,
        }
