"""How MiniCPM3-4B's loss moves over its first AdamW steps at full width, on
the card, and whether the card's run follows the CPU's.

Phase ``train_families`` of ``chip_smoke.py`` trains MiniCPM3-4B at its
published widths and 32 of its 62 layers, 4 steps of 8 x 2,048 tokens in 2
microbatches, AdamW warmed up over 2 steps.  This script measures, with the
phase's data and settings:

1. at 32 layers and lr 1e-3, 1e-4 and 1e-5: each step's loss, the
   gradients' global norm before clipping, and the largest |logit| and the
   logits' standard deviation over the first row of the step's batch,
   computed on the state the step starts from, and the vocabulary entry
   whose |logit| is the largest (the corpus draws token ids by Zipf's law:
   the smallest are the most frequent);
2. at lr 1e-3 and 1e-4, 2, 8 and 16 layers: each step's loss and gradient
   norm;
3. at 8 layers and lr 1e-3, from one seed-0 draw made on the card and
   copied to the CPU, 4 steps of 4 x 256 tokens on each: both sides' losses
   and gradient norms, and the whole model's change over the 4 steps on the
   card against the CPU's (the norm of the difference over the norm of the
   CPU's change, and the worst leaf).

Each line carries the card's name and power limit.  Not collected by
pytest; needs a CUDA card (about 5 minutes):

    PYTHONPATH=src python3 tests/train_family_probe.py
"""

from __future__ import annotations

import dataclasses
import subprocess
import sys
import time
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import chip_smoke  # noqa: E402
from repro_torch.configs.base import get_config  # noqa: E402
from repro_torch.data.corpus import CorpusConfig  # noqa: E402
from repro_torch.launch.sharding import default_remat_group  # noqa: E402
from repro_torch.models import transformer  # noqa: E402
from repro_torch.models.param import in_f32, init_params  # noqa: E402
from repro_torch.models.registry import get_model  # noqa: E402
from repro_torch.train.optimizer import OptConfig  # noqa: E402
from repro_torch.train.trainer import Trainer, TrainerConfig, state_from_tree  # noqa: E402

ARCH = "minicpm3_4b"
STEPS = chip_smoke.FAMILY_STEPS


def config(layers: int):
    return dataclasses.replace(get_config(ARCH), n_layers=layers,
                               remat_group=default_remat_group(layers))


def train(dev, cfg, lr: float, batch: int, seq: int, micro: int, tree=None,
          logits: bool = False):
    """``cfg`` through ``Trainer`` for STEPS steps (from ``tree``, else the
    seed-0 draw on ``dev``): a record a step, and the last state."""
    api = get_model(cfg)
    data = CorpusConfig(vocab_size=cfg.vocab_size, seq_len=seq, global_batch=batch, seed=0)
    t = Trainer(api, data, OptConfig(lr=lr, warmup_steps=2),
                TrainerConfig(steps=STEPS, log_every=1, microbatches=micro), device=dev)
    if tree is not None:
        t.init_state = lambda: (state_from_tree(api, chip_smoke._tree_to(tree, dev)), 0)
    rows, step_fn = [], t.step_fn

    def probed(model, opt, b):
        row = {}
        if logits:
            with torch.no_grad():
                tok = b["tokens"].reshape(-1, b["tokens"].shape[-1])[:1]
                hidden, _ = transformer.forward_train(
                    cfg, model, tok, transformer.make_positions(cfg, tok))
                z = transformer.logits_of(cfg, model, hidden).float()
                row.update(max_logit=float(z.abs().max()), logit_std=float(z.std()),
                           top=int(z.abs().amax(dim=(0, 1)).argmax()))
                del hidden, z
        out = step_fn(model, opt, b)
        m = out[2]
        row.update(loss=float(m["loss"]), grad_norm=float(m["grad_norm"]), lr=float(m["lr"]))
        rows.append(row)
        return out

    t.step_fn = probed
    return rows, t.run()


def show(rows) -> str:
    return "; ".join(
        f"step {i + 1} loss {r['loss']:.4f} gnorm {r['grad_norm']:.4g} lr {r['lr']:.3g}"
        + (f" max|logit| {r['max_logit']:.3f} (token {r['top']}) std {r['logit_std']:.3f}"
           if "max_logit" in r
           else "") for i, r in enumerate(rows))


def main() -> int:
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True).stdout.strip()
    chip_smoke.phase_build(False)
    dev = torch.device("cuda:0")
    batch, seq, micro = chip_smoke.TRAIN_BATCH, chip_smoke.TRAIN_SEQ, chip_smoke.TRAIN_MICRO
    for lr in (1e-3, 1e-4, 1e-5):
        t0 = time.perf_counter()
        with chip_smoke.expandable_segments(dev):
            rows = train(dev, config(32), lr, batch, seq, micro, logits=True)[0]
        chip_smoke._free(dev)
        print(f"[probe] {card}: 32 layers, lr {lr}, {batch} x {seq}: {show(rows)} "
              f"({time.perf_counter() - t0:.1f} s)", flush=True)
    for lr in (1e-3, 1e-4):
        for layers in (2, 8, 16):
            with chip_smoke.expandable_segments(dev):
                rows = train(dev, config(layers), lr, batch, seq, micro)[0]
            chip_smoke._free(dev)
            print(f"[probe] {card}: {layers} layers, lr {lr}, {batch} x {seq}: {show(rows)}",
                  flush=True)

    cfg, cpu = config(8), torch.device("cpu")
    tree = init_params(in_f32(get_model(cfg).param_specs()), seed=0, device=dev)
    host = chip_smoke._tree_to(tree, cpu)
    del tree
    start = {n: p.detach().clone() for n, p in
             state_from_tree(get_model(cfg), host)["params"].named_parameters()}
    ends, seconds = {}, {}
    for name, d in [("card", dev), ("cpu", cpu)]:
        t0 = time.perf_counter()
        rows, out = train(d, cfg, 1e-3, 4, 256, 1, tree=host)
        ends[name] = {n: p.detach().to(cpu, copy=True)
                      for n, p in out["params"].named_parameters()}
        seconds[name] = time.perf_counter() - t0
        print(f"[probe] {card}: 8 layers on the {name}, lr 0.001, 4 x 256: {show(rows)}",
              flush=True)
        del out
        chip_smoke._free(dev)
    diff = sum(float(((ends["card"][n] - ends["cpu"][n]).double() ** 2).sum()) for n in start)
    base = sum(float(((ends["cpu"][n] - start[n]).double() ** 2).sum()) for n in start)
    worst = max(start, key=lambda n: float((ends["card"][n] - ends["cpu"][n]).norm())
                / max(float((ends["cpu"][n] - start[n]).norm()), 1e-30))
    w = (float((ends["card"][worst] - ends["cpu"][worst]).norm())
         / float((ends["cpu"][worst] - start[worst]).norm()))
    print(f"[probe] {card}: 8 layers, the change over 4 steps, card against CPU: "
          f"|d| / |change| {(diff / base) ** 0.5:.4g} for the whole model, worst leaf {worst} "
          f"{w:.4g} (s: card {seconds['card']:.1f}, cpu {seconds['cpu']:.1f})", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
