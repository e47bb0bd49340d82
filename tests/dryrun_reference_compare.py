"""One-off CPU comparison of the dry run's records: the reference's
(``repro.launch.dryrun``, lowered and compiled by XLA for 512 host devices)
beside the port's (``repro_torch.launch.dryrun``, counted on ``meta``
tensors over a ``fake`` process group), cell by cell.  Not a test: it
takes minutes (the reference compiles each step); ``PERF.md`` §6 quotes it.

Usage (from the repository root)::

    PYTHONPATH=src python tests/dryrun_reference_compare.py [ARCH:SHAPE ...] [--em]

By default ``qwen1_5_0_5b:train_4k`` and the EM cell on the (16, 16) mesh.
Prints one JSON line a cell: both records' FLOPs, bytes, collective wire
bytes by kind, cross-pod bytes and memory.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import textwrap
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
KEYS = ("hlo_flops", "hlo_bytes", "collective_wire_bytes", "collective_cross_pod_bytes",
        "collectives_by_kind", "n_collectives", "unknown_whiles", "mem", "lower_s", "compile_s")

# The reference's make_production_mesh calls jax.make_mesh, whose axes are
# Explicit by default in this JAX, where its with_sharding_constraint pins
# then assert instead of constraining; its lowering needs Auto axes (the
# behaviour of the JAX it was written for), so the script asks for them.
REFERENCE = textwrap.dedent(
    """
    import json, sys
    from repro.launch import dryrun
    import jax
    _make_mesh = jax.make_mesh

    def auto_make_mesh(shape, names, **kw):
        kw.setdefault("axis_types", (jax.sharding.AxisType.Auto,) * len(names))
        return _make_mesh(shape, names, **kw)

    jax.make_mesh = auto_make_mesh
    cell = sys.argv[1]
    if cell == "em":
        rec = dryrun.lower_em_cell(False)
    else:
        arch, shape = cell.split(":")
        rec = dryrun.lower_cell(arch, shape, False)
    print("RECORD " + json.dumps(rec))
    """
)


def reference(cell: str) -> dict:
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu")
    out = subprocess.run([sys.executable, "-c", REFERENCE, cell], capture_output=True,
                         text=True, env=env, timeout=3600)
    if out.returncode:
        raise RuntimeError(out.stderr[-3000:])
    line = [ln for ln in out.stdout.splitlines() if ln.startswith("RECORD ")][-1]
    return json.loads(line[len("RECORD "):])


def port(cell: str) -> dict:
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.launch import dryrun

    if cell == "em":
        return dryrun.lower_em_cell(False)
    arch, shape = cell.split(":")
    return dryrun.lower_cell(arch, shape, False)


def main(argv: list[str]) -> int:
    cells = [a for a in argv[1:] if a != "--em"] or ["qwen1_5_0_5b:train_4k"]
    if "--em" in argv or len(argv) == 1:
        cells.append("em")
    for cell in cells:
        t0 = time.perf_counter()
        ref = reference(cell)
        t1 = time.perf_counter()
        got = port(cell)
        t2 = time.perf_counter()
        print(json.dumps({"cell": cell, "reference": {k: ref.get(k) for k in KEYS},
                          "port": {k: got.get(k) for k in KEYS},
                          "wall_s": {"reference": round(t1 - t0, 1),
                                     "port": round(t2 - t1, 1)}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv))
