"""Two readers of a ``torch.profiler`` trace's device events, on the card.

``chip_smoke.py`` sums the device's kernels, copies and sets of a profiled
run to give its busy share.  ``prof.events()`` builds the host-side event
tree before it lists them, which takes seconds for a long trace;
``chip_smoke._device_events`` reads the same events from the raw trace.
This script profiles one serving run of 8 layers of Yi-6B and of
Falcon-Mamba-7B (random weights, 4 requests of 32 tokens, 8 new) and
prints, for each reader, the events, their summed microseconds, the
device-to-host copies, the seconds the reading took, and whether the
event names agree.  Not collected by pytest; needs a CUDA card:

    PYTHONPATH=src python3 tests/trace_reader_probe.py
"""

from __future__ import annotations

import dataclasses
import sys
import time
from pathlib import Path

import numpy as np
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import chip_smoke  # noqa: E402
from repro_torch.configs.base import get_config  # noqa: E402
from repro_torch.kernels.common import resolve_device  # noqa: E402
from repro_torch.models.registry import get_model  # noqa: E402
from repro_torch.serve.engine import demo_engine  # noqa: E402


def main() -> int:
    chip_smoke.phase_build(False)
    dev = resolve_device("cuda:0")
    for arch, layers in [("yi_6b", 8), ("falcon_mamba_7b", 8)]:
        cfg = dataclasses.replace(get_config(arch), n_layers=layers)
        engine = demo_engine(get_model(cfg), batch=4, s_max=40, device=dev)
        requests = list(np.random.default_rng(0).integers(1, 1000, (4, 32), np.int32))
        engine.generate(requests, 8)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            engine.generate(requests, 8)
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        raw = chip_smoke._device_events(prof)
        t1 = time.perf_counter()
        tree = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
        t2 = time.perf_counter()
        print(f"{arch} {layers} layers: raw trace {len(raw)} events, "
              f"{sum(us for _, us in raw):.3f} us, d2h {sum('DtoH' in n for n, _ in raw)}, "
              f"read in {t1 - t0:.3f} s; prof.events() {len(tree)} events, "
              f"{sum(e.time_range.elapsed_us() for e in tree):.3f} us, "
              f"d2h {sum('DtoH' in e.name for e in tree)}, read in {t2 - t1:.3f} s; names "
              f"equal {sorted(n for n, _ in raw) == sorted(e.name for e in tree)}")
        del engine
        chip_smoke._free(dev)
    return 0


if __name__ == "__main__":
    sys.exit(main())
