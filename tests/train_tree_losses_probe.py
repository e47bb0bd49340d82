"""Each step's loss and gradient norm of a family's full-width training on
the card, as phase ``train_families`` of ``chip_smoke.py`` runs it, on the
port of each tree given: the repo's root, or an older commit unpacked
beside it (``git archive <commit> | tar -x -C DIR``).

For each ``DIR`` a process of its own imports that tree's ``chip_smoke``
and ``repro_torch``, builds its kernels, and trains ``ARCH`` at its
published widths and ``LAYERS`` layers through ``Trainer`` from the
Trainer's own seed-0 draw: the synthetic corpus, 8 x 2,048 tokens a step in
2 microbatches, AdamW at ``LR`` warmed up over 2 steps, 4 steps.  So two
trees' lines differ only by what changed in the port between them.  Each
line carries the card's name and power limit.  Not collected by pytest;
needs a CUDA card (about 40 s a tree)::

    python3 tests/train_tree_losses_probe.py minicpm3_4b:8:1e-4 . DIR [DIR ...]
"""

from __future__ import annotations

import subprocess
import sys
import time
from pathlib import Path


def one(tree: Path, arch: str, layers: int, lr: float) -> None:
    sys.path[:0] = [str(tree / "src"), str(tree)]
    import dataclasses

    import torch

    import chip_smoke
    from repro_torch.configs.base import get_config
    from repro_torch.data.corpus import CorpusConfig
    from repro_torch.launch.sharding import default_remat_group
    from repro_torch.models.registry import get_model
    from repro_torch.train.optimizer import OptConfig
    from repro_torch.train.trainer import Trainer, TrainerConfig

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True).stdout.strip()
    chip_smoke.phase_build(False)
    dev = torch.device("cuda:0")
    cfg = dataclasses.replace(get_config(arch), n_layers=layers,
                              remat_group=default_remat_group(layers))
    api = get_model(cfg)
    data = CorpusConfig(vocab_size=cfg.vocab_size, seq_len=chip_smoke.TRAIN_SEQ,
                        global_batch=chip_smoke.TRAIN_BATCH, seed=0)
    t = Trainer(api, data, OptConfig(lr=lr, warmup_steps=2),
                TrainerConfig(steps=4, log_every=1, microbatches=chip_smoke.TRAIN_MICRO),
                device=dev)
    rows, step_fn = [], t.step_fn

    def logged(model, opt, b):
        out = step_fn(model, opt, b)
        rows.append((float(out[2]["loss"]), float(out[2]["grad_norm"])))
        return out

    t.step_fn = logged
    t0 = time.perf_counter()
    with chip_smoke.expandable_segments(dev):
        t.run()
    print(f"[tree] {card}: {tree}: {arch} {layers} layers, lr {lr}: "
          + "; ".join(f"step {i + 1} loss {loss:.4f} gnorm {g:.4g}"
                      for i, (loss, g) in enumerate(rows))
          + f" ({time.perf_counter() - t0:.1f} s)", flush=True)


def main(argv: list[str]) -> int:
    if argv[0] == "--one":
        arch, layers, lr = argv[2].split(":")
        one(Path(argv[1]), arch, int(layers), float(lr))
        return 0
    rc = 0
    for tree in argv[1:]:
        rc |= subprocess.run([sys.executable, __file__, "--one", tree, argv[0]]).returncode
    return rc


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
