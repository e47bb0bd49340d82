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

With ``--follow`` it measures instead, at lr 1e-4 (``FAMILY_LR``), for
MiniCPM3-4B at 8 layers and Falcon-Mamba-7B at 2 and 1 (``FOLLOW``; ``--follow
ARCH:LAYERS ...`` picks entries), whether the card's training follows the
CPU's over the 4 steps where the loss of the phase's own run rises:

4. the phase's run at full size (8 x 2,048 tokens in 2 microbatches) from
   the Trainer's own seed-0 draw, at MiniCPM3's 4 and 8 layers and
   Falcon-Mamba's 1 and 2: each step's loss and gradient norm; for
   MiniCPM3 the same run again with every attention (forward and
   backward) through the plain PyTorch version on the card instead of the
   ``flash_attn`` kernels, and each step's loss difference;
5. from one seed-0 draw made on the card and copied to the CPU, the card
   at each size of a short ladder of smaller batches until a run shows the
   rise (a step's loss above the one before it, or, where the entry allows
   it, a gradient norm above twice the first step's; else the ladder's
   last size), then the CPU at that size
   (products as f32, no remat: the same numbers, faster): both sides'
   losses and gradient norms, each step's relative loss difference, and
   the model's change over the 4 steps on the card against the CPU's.

Each line carries the card's name and power limit.  Not collected by
pytest; needs a CUDA card (about 5 minutes; ``--follow`` about 15):

    PYTHONPATH=src python3 tests/train_family_probe.py [--follow [ARCH:LAYERS ...]]
"""

from __future__ import annotations

import contextlib
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
from repro_torch.kernels.flash_attn import ops as flash  # noqa: E402
from repro_torch.launch.sharding import default_remat_group  # noqa: E402
from repro_torch.models import transformer  # noqa: E402
from repro_torch.models.param import in_f32, init_params  # noqa: E402
from repro_torch.models.registry import get_model  # noqa: E402
from repro_torch.train.optimizer import OptConfig  # noqa: E402
from repro_torch.train.trainer import Trainer, TrainerConfig, state_from_tree  # noqa: E402

ARCH = "minicpm3_4b"
STEPS = chip_smoke.FAMILY_STEPS


def config(layers: int, arch: str = ARCH):
    return dataclasses.replace(get_config(arch), n_layers=layers,
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
    if "--follow" in sys.argv[1:]:
        picked = sys.argv[sys.argv.index("--follow") + 1:]
        follow(dev, card, follow=[f for f in FOLLOW if not picked
                                  or f"{f[0]}:{f[1]}" in picked])
        return 0
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


# (arch, layers of the card-vs-CPU comparison, layers of the full-size runs,
# the (batch, sequence, microbatches) the comparison tries, smallest first,
# and whether a gradient-norm spike alone counts as the rise): the CPU's 4
# steps at these sizes take minutes on the card machine's host
FOLLOW = [
    ("minicpm3_4b", 8, (4, 8), [(1, 2048, 1), (2, 2048, 2)], True),
    ("falcon_mamba_7b", 2, (1, 2), [(1, 512, 1), (1, 1024, 1)], True),
    ("falcon_mamba_7b", 1, (), [(1, 2048, 1), (2, 2048, 2)], False),
]


@contextlib.contextmanager
def plain_attention():
    """Every ``flash.attention`` call inside the block through
    ``attention_plain`` (autograd of its f32 scores), on the card too."""
    kernel = flash.attention
    flash.attention = lambda q, k, v, scale, *, causal=True: flash.attention_plain(
        q, k, v, scale, causal=causal)
    try:
        yield
    finally:
        flash.attention = kernel


def rises(rows, spike: bool = True) -> bool:
    """A step's loss above the one before it, or, with ``spike``, a gradient
    norm above twice the first step's."""
    return (any(b["loss"] > a["loss"] for a, b in zip(rows, rows[1:]))
            or spike and any(r["grad_norm"] > 2 * rows[0]["grad_norm"] for r in rows[1:]))


def loss_diffs(rows, ref) -> str:
    return ", ".join(f"{abs(a['loss'] - b['loss']) / abs(b['loss']):.3g}"
                     for a, b in zip(rows, ref))


def follow(dev, card: str, lr: float = chip_smoke.FAMILY_LR, follow=FOLLOW,
           full=(chip_smoke.TRAIN_BATCH, chip_smoke.TRAIN_SEQ,
                 chip_smoke.TRAIN_MICRO)) -> None:
    """Parts 4 and 5 of the module docstring, for each entry of ``follow``."""
    cpu = torch.device("cpu")
    for arch, layers, full_layers, ladder, spike in follow:
        attention = chip_smoke._attention_layers(config(1, arch)) > 0
        for n in full_layers:
            t0 = time.perf_counter()
            try:
                with chip_smoke.expandable_segments(dev):
                    rows = train(dev, config(n, arch), lr, *full)[0]
            except torch.OutOfMemoryError:
                print(f"[probe] {card}: {arch} {n} layers: out of memory", flush=True)
                continue
            finally:
                chip_smoke._free(dev)
            print(f"[probe] {card}: {arch} {n} layers, lr {lr}, {full[0]} x {full[1]} in "
                  f"{full[2]} microbatches, the kernels: {show(rows)} "
                  f"({time.perf_counter() - t0:.1f} s)", flush=True)
            if not attention:
                continue
            t0 = time.perf_counter()
            try:
                with chip_smoke.expandable_segments(dev), plain_attention():
                    plain = train(dev, config(n, arch), lr, *full)[0]
            except torch.OutOfMemoryError:
                print(f"[probe] {card}: {arch} {n} layers, the plain attention: out of "
                      "memory", flush=True)
                continue
            finally:
                chip_smoke._free(dev)
            print(f"[probe] {card}: {arch} {n} layers, lr {lr}, the plain attention on the "
                  f"card: {show(plain)}; |loss - plain| / plain a step: "
                  f"{loss_diffs(rows, plain)} ({time.perf_counter() - t0:.1f} s)", flush=True)

        cfg = config(layers, arch)
        tree = init_params(in_f32(get_model(cfg).param_specs()), seed=0, device=dev)
        host = chip_smoke._tree_to(tree, cpu)
        del tree
        chip_smoke._free(dev)
        start = {n: p.detach().clone() for n, p in
                 state_from_tree(get_model(cfg), host)["params"].named_parameters()}
        for size in ladder:
            rows, out = train(dev, cfg, lr, *size, tree=host)
            card_end = {n: p.detach().to(cpu, copy=True)
                        for n, p in out["params"].named_parameters()}
            del out
            chip_smoke._free(dev)
            print(f"[probe] {card}: {arch} {layers} layers on the card, lr {lr}, "
                  f"{size[0]} x {size[1]} in {size[2]} microbatch(es): {show(rows)}"
                  f"{'' if rises(rows, spike) else ' (no rise)'}", flush=True)
            if rises(rows, spike):
                break
        t0 = time.perf_counter()
        with chip_smoke.cpu_products_in_f32(True), chip_smoke._no_remat(True):
            cpu_rows, out = train(cpu, cfg, lr, *size, tree=host)
        cpu_end = {n: p.detach() for n, p in out["params"].named_parameters()}
        del out
        print(f"[probe] {card}: {arch} {layers} layers on the CPU, lr {lr}, "
              f"{size[0]} x {size[1]}: {show(cpu_rows)}; |card - cpu| / cpu a step: "
              f"{loss_diffs(rows, cpu_rows)} ({time.perf_counter() - t0:.1f} s)", flush=True)
        diff = sum(float(((card_end[n] - cpu_end[n]).double() ** 2).sum()) for n in start)
        base = sum(float(((cpu_end[n] - start[n]).double() ** 2).sum()) for n in start)
        worst = max(start, key=lambda n: float((card_end[n] - cpu_end[n]).norm())
                    / max(float((cpu_end[n] - start[n]).norm()), 1e-30))
        w = (float((card_end[worst] - cpu_end[worst]).norm())
             / max(float((cpu_end[worst] - start[worst]).norm()), 1e-30))
        print(f"[probe] {card}: {arch} {layers} layers, the change over {len(rows)} steps, card "
              f"against CPU: |d| / |change| {(diff / base) ** 0.5:.4g} for the whole model, "
              f"worst leaf {worst} {w:.4g}", flush=True)
        del host, start, card_end, cpu_end


if __name__ == "__main__":
    sys.exit(main())
