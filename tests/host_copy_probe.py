"""What the card-vs-CPU checks of ``chip_smoke.py`` wait on, on the card
machine's host: a product of bf16 matrices on the CPU against the same
product in f32 (``chip_smoke.cpu_products_in_f32``), and 4 GiB of bf16 copied
from the card to the CPU by ``.to("cpu")`` against ``chip_smoke._tree_to``
(through a page-locked buffer).  Prints each time beside the card's name and
power limit.  Not collected by pytest; needs a CUDA card (about 30 s)::

    python3 tests/host_copy_probe.py
"""

from __future__ import annotations

import subprocess
import sys
import time
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import chip_smoke  # noqa: E402


def seconds(fn, reps: int = 3) -> float:
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / reps


def main() -> None:
    a, b = torch.randn(1088, 3584), torch.randn(3584, 18944)
    for dt in (torch.bfloat16, torch.float32):
        x, y = a.to(dt), b.to(dt)
        print(f"CPU product 1,088 x 3,584 by 3,584 x 18,944 in {str(dt)[6:]} on "
              f"{torch.get_num_threads()} threads: {seconds(lambda: x @ y) * 1e3:.1f} ms")
    with chip_smoke.cpu_products_in_f32(True):
        x, y = a.bfloat16(), b.bfloat16()
        print(f"  the bf16 product under cpu_products_in_f32: "
              f"{seconds(lambda: x @ y) * 1e3:.1f} ms")
    big = torch.randn(2 << 30, device="cuda", dtype=torch.bfloat16)
    for name, fn in [(".to('cpu')", lambda: big.to("cpu")),
                     ("chip_smoke._tree_to", lambda: chip_smoke._tree_to(big, "cpu"))]:
        s = seconds(fn, reps=2)
        print(f"4 GiB of bf16, card to CPU, {name}: {s:.2f} s ({4 / s:.2f} GiB/s)")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip())


if __name__ == "__main__":
    main()
