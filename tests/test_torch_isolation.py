"""The PyTorch port stands alone: no JAX, no ``repro``, and no silent CPU fallback."""

from __future__ import annotations

import re
import subprocess
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

ROOT = Path(__file__).resolve().parent.parent
PORT = ROOT / "src" / "repro_torch"

_IMPORT_ALL = r"""
import importlib, pkgutil, sys
sys.modules["jax"] = None  # any import of jax now raises ImportError
sys.path.insert(0, {src!r})
sys.path.insert(0, {root!r})
import repro_torch
names = [m.name for m in pkgutil.walk_packages(repro_torch.__path__, "repro_torch.")]
for name in names:
    importlib.import_module(name)
import chip_smoke  # noqa: F401
leaked = sorted(
    m for m, mod in sys.modules.items()
    if mod is not None and (m.split(".")[0] in ("repro", "jax", "jaxlib"))
)
assert not leaked, leaked
print(len(names))
"""


def test_port_imports_without_jax_or_reference():
    code = _IMPORT_ALL.format(src=str(ROOT / "src"), root=str(ROOT))
    out = subprocess.run(
        [sys.executable, "-c", code], capture_output=True, text=True, timeout=120,
        cwd=str(ROOT / "tests"),
    )
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.strip().splitlines()[-1]) >= 20  # every module was imported


@pytest.mark.parametrize("path", sorted(
    str(p.relative_to(ROOT)) for p in [*PORT.rglob("*.py"), ROOT / "chip_smoke.py"]
))
def test_no_jax_or_reference_import_in_source(path):
    src = (ROOT / path).read_text()
    bad = re.findall(r"^\s*(?:import|from)\s+(jax|repro)\b", src, flags=re.M)
    assert not bad, f"{path} imports {bad}"


def test_entry_points_need_a_gpu_unless_asked_for_cpu(monkeypatch):
    """device=None means CUDA: without a GPU the entry points raise, never fall back."""
    from repro_torch.core import pipeline
    from repro_torch.core.cover import build_cover
    from repro_torch.core.mln import MLNMatcher
    from repro_torch.data.synthetic import SynthConfig, make_dataset

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    ds = make_dataset(SynthConfig.hepth(scale=0.035, seed=7))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        pipeline.resolve(ds.entities, ds.relations)
    with pytest.raises(RuntimeError):
        pipeline.prepare(ds.entities, ds.relations)
    with pytest.raises(RuntimeError):
        MLNMatcher()
    with pytest.raises(RuntimeError):
        build_cover(ds.entities, ds.relations)
    assert MLNMatcher(device="cpu").device.type == "cpu"


def test_parallel_engine_not_ported_yet():
    from repro_torch.core import pipeline
    from repro_torch.data.synthetic import SynthConfig, make_dataset

    ds = make_dataset(SynthConfig.hepth(scale=0.035, seed=7))
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        pipeline.resolve(ds.entities, ds.relations, parallel=True, device="cpu")


@pytest.mark.parametrize("name", ["icm_sweep", "ngram_sim", "mln_score"])
def test_wrappers_use_plain_version_only_for_cpu_tensors(name):
    """A CPU tensor runs the plain version and launches nothing."""
    import numpy as np

    from repro_torch.kernels.icm_sweep import ops as icm
    from repro_torch.kernels.mln_score import ops as score
    from repro_torch.kernels.ngram_sim import ops as sim

    rng = np.random.default_rng(0)
    t = lambda *s: torch.as_tensor(rng.random(s).astype(np.float32))  # noqa: E731
    wrapper, args = {
        "icm_sweep": (icm.sweep_batched, (t(2, 8), t(2, 8, 8), t(2, 3, 8))),
        "ngram_sim": (sim.sim_above, (t(1, 16), t(5, 16), 0.5)),
        "mln_score": (score.score_sets, (t(2, 8), t(2, 8, 8), t(2, 3, 8))),
    }[name]
    before = wrapper.launches
    out = wrapper(*args)
    assert out.device.type == "cpu" and out.dtype == torch.float32
    assert wrapper.launches == before


@pytest.mark.parametrize("name", ["icm_sweep", "ngram_sim", "mln_score"])
def test_wrappers_raise_on_non_cuda_devices(name):
    """Off the CPU a wrapper launches its CUDA kernel or raises: a tensor on
    another device never reaches the kernel and never takes the plain path."""
    from repro_torch.kernels.icm_sweep import ops as icm
    from repro_torch.kernels.mln_score import ops as score
    from repro_torch.kernels.ngram_sim import ops as sim

    t = lambda *s: torch.empty(s, device="meta")  # noqa: E731
    wrapper, args = {
        "icm_sweep": (icm.sweep_batched, (t(2, 8), t(2, 8, 8), t(2, 3, 8))),
        "ngram_sim": (sim.sim_above, (t(1, 16), t(5, 16), 0.5)),
        "mln_score": (score.score_sets, (t(2, 8), t(2, 8, 8), t(2, 3, 8))),
    }[name]
    before = wrapper.launches
    with pytest.raises(ValueError, match="CUDA"):
        wrapper(*args)
    assert wrapper.launches == before
