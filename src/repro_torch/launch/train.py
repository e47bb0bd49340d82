"""Training launcher: ``python -m repro_torch.launch.train --arch <id> ...``

Trains one architecture with random initial weights on the synthetic
Zipf corpus through the restartable :class:`repro_torch.train.trainer.
Trainer`, on CUDA unless ``--device cpu`` is given (without a GPU and
without ``--device cpu`` it raises).  ``--smoke`` takes the
architecture's reduced config.  As the reference's launcher does, it sets
``remat_group`` to :func:`repro_torch.launch.sharding.default_remat_group`
of the depth, and prints the reference's lines: the run, each logged
loss, and the total.  With ``--ckpt-dir`` a rerun resumes from the
latest checkpoint there, whatever rank count wrote it.

**Several ranks.**  Started as N processes with ``REPRO_SHARD_COORD``
(``host:port`` or ``file:///path``), ``REPRO_SHARD_N`` = N and
``REPRO_SHARD_ID`` = 0..N-1 in each, it joins one process group
(:func:`repro_torch.launch.mesh.init_em_distributed`: a card a rank by
``rank_device``, the backend by ``choose_backend``: gloo for ranks that
share a card or the CPU, NCCL with a card each), builds a ``("data",)``
``DeviceMesh`` over the ranks, prints ``devices=N``, and trains
data-parallel: ``--batch`` is the global batch, split over the ranks.
The reference's launcher advertises a ``--dry`` compile analysis in its
docstring, but its argument parser has no such flag and it builds only a
``("data",)`` mesh; so this launcher has neither.  The compile analysis is
the dry run, :mod:`repro_torch.launch.dryrun`.
"""

from __future__ import annotations

import argparse
import dataclasses

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from repro_torch.configs.base import ARCH_IDS, get_config, smoke_config
from repro_torch.data.corpus import CorpusConfig
from repro_torch.kernels.common import resolve_device
from repro_torch.launch import sharding as shardlib
from repro_torch.launch.mesh import init_em_distributed
from repro_torch.models.registry import get_model
from repro_torch.train.optimizer import OptConfig
from repro_torch.train.trainer import Trainer, TrainerConfig


def main(argv=None) -> dict:
    """Train, print the reference's lines, and return ``Trainer.run``'s result."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True, choices=ARCH_IDS)
    ap.add_argument("--smoke", action="store_true",
                    help="use the reduced same-family config")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None, help="torch device (default: cuda)")
    args = ap.parse_args(argv)

    cfg = smoke_config(args.arch) if args.smoke else get_config(args.arch)
    cfg = dataclasses.replace(cfg, remat_group=shardlib.default_remat_group(cfg.n_layers))
    api = get_model(cfg)
    mesh = None
    if init_em_distributed(device=args.device):
        n = dist.get_world_size()
        mesh = DeviceMesh(resolve_device(args.device).type, torch.arange(n),
                          mesh_dim_names=("data",))
    print(f"arch={cfg.name} devices={mesh.size() if mesh is not None else 1} "
          f"steps={args.steps}")

    data = CorpusConfig(vocab_size=cfg.vocab_size, seq_len=args.seq,
                        global_batch=args.batch, seed=args.seed)
    tcfg = TrainerConfig(steps=args.steps, microbatches=args.microbatches,
                         ckpt_dir=args.ckpt_dir, seed=args.seed)
    trainer = Trainer(api, data, OptConfig(lr=args.lr, total_steps=args.steps), tcfg,
                      mesh=mesh, device=args.device)
    out = trainer.run()
    for step, loss in out["losses"]:
        print(f"step {step:5d}  loss {loss:.4f}")
    print(f"done: {out['steps_done']} steps in {out['wall_time_s']:.1f}s")
    return out


if __name__ == "__main__":
    main()
