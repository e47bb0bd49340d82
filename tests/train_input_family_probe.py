"""How a family's loss moves over its first AdamW steps at full width on
the card, at a given depth and learning rate.

Phase ``train_families`` of ``chip_smoke.py`` trains Qwen2-VL-7B (1,024
vision patches a sequence of 2,048 tokens) and Whisper-medium (448 tokens
over 1,500 stub frames) through ``make_train_step``
(``chip_smoke.train_with_inputs``), and the families of ``TRAIN_FAMILIES``
(Moonlight, MiniCPM3, Falcon-Mamba) through ``Trainer``
(``chip_smoke.train_with_restart``, here without a restart), 8 sequences a
step in 2 microbatches, AdamW warmed up over 2 steps.  Each argument
``ARCH:LAYERS:LR:STEPS:TOKENS`` runs that training from a seed-0 draw and
prints each step's loss, gradient norm, ms and peak memory, then the busy
share of one more step and a microbatch's forward, backward and AdamW
times; a run whose loss does not fall, or that runs out of memory, prints
why and the next one runs.  Last, ``python -m repro_torch.launch.train
--arch qwen2_vl_7b --smoke --steps 2``.  Not collected by pytest; needs a
CUDA card (about 2 minutes for these)::

    python3 tests/train_input_family_probe.py whisper_medium:24:1e-4:4:448 \\
        qwen2_vl_7b:5:1e-4:6:2048 qwen2_vl_7b:5:5e-5:4:2048 \\
        qwen2_vl_7b:5:2.5e-5:4:2048 qwen2_vl_7b:6:1e-4:2:2048 \\
        falcon_mamba_7b:2:2.5e-5:4:2048 minicpm3_4b:8:1e-4:4:2048
"""

from __future__ import annotations

import dataclasses
import sys
import time
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import chip_smoke as c  # noqa: E402
from repro_torch.configs.base import get_config  # noqa: E402
from repro_torch.launch.sharding import default_remat_group  # noqa: E402


def main(specs: list[str]) -> None:
    dev = torch.device("cuda:0")
    c.phase_build(False)
    c._count_blocked()
    for spec in specs:
        arch, n, lr, steps, text = spec.split(":")
        n, lr, steps, text = int(n), float(lr), int(steps), int(text)
        cfg = dataclasses.replace(get_config(arch), n_layers=n,
                                  remat_group=default_remat_group(n))
        t = time.perf_counter()
        tag = f"probe {arch} {n} lr {lr}"
        try:
            with c.expandable_segments(dev):
                if arch in {a for a, *_ in c.TRAIN_INPUT_FAMILIES}:
                    run = c.train_with_inputs(dev, tag, cfg, steps, text, c.TRAIN_BATCH,
                                              c.TRAIN_MICRO, lr=lr)
                    model, opt = run["model"], run["opt"]
                    batch = c.family_batch(cfg, run["data"], steps)
                else:
                    run = c.train_with_restart(dev, tag, cfg, steps, None, text, c.TRAIN_BATCH,
                                               c.TRAIN_MICRO, lr=lr)
                    model, opt = run["resumed"]["params"], run["resumed"]["opt"]
                    batch = run["trainer"].data.batch(steps)
                c.train_step_split(dev, "probe", run["api"], run["opt_cfg"], model, opt, batch,
                                   c.TRAIN_MICRO)
                del run, model, opt
        except (RuntimeError, torch.OutOfMemoryError) as e:
            c.log(f"[probe] {arch} {n} lr {lr}: {type(e).__name__}: {str(e)[:300]}")
        c._free(dev)
        c.log(f"[probe] {spec} {time.perf_counter() - t:.1f} s")
    t = time.perf_counter()
    lines, counts = c.run_train_launcher(["--arch", "qwen2_vl_7b", "--smoke", "--steps", "2"])
    c.log(f"[probe] launcher {time.perf_counter() - t:.1f} s {counts} " + " | ".join(lines))
    c.log(c.subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                            "--format=csv,noheader"], capture_output=True, text=True,
                           check=True).stdout.strip())


if __name__ == "__main__":
    main(sys.argv[1:])
