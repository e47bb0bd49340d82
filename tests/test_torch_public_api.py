"""The port's curated public surface against the reference's: the same 15
names in ``__all__``, each resolved lazily (PEP 562) to the port's object
from the module that mirrors the reference's.
"""

from __future__ import annotations

import importlib
import subprocess
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

import repro  # noqa: E402
import repro_torch  # noqa: E402

SRC = Path(__file__).resolve().parent.parent / "src"


def test_all_equals_the_reference():
    assert repro_torch.__all__ == repro.__all__
    assert len(repro_torch.__all__) == 15


@pytest.mark.parametrize("name", repro.__all__)
def test_name_is_the_ports_object_from_the_mirrored_module(name):
    module = repro_torch._EXPORTS[name]
    assert module == "repro_torch" + repro._EXPORTS[name].removeprefix("repro")
    got = getattr(repro_torch, name)
    assert got is getattr(importlib.import_module(module), name)
    assert got.__module__.startswith("repro_torch.")


def test_unknown_name_raises_attribute_error():
    with pytest.raises(AttributeError, match="no attribute 'NotAName'"):
        repro_torch.NotAName  # noqa: B018
    assert not hasattr(repro_torch, "run_smp")


def test_dir_lists_the_names():
    assert set(repro.__all__) <= set(dir(repro_torch))


def test_import_loads_nothing_until_a_name_is_touched():
    """Without jax, ``import repro_torch`` loads none of the service, the
    matchers or ``torch.distributed``; touching a name loads its module."""
    code = f"""
import sys
sys.modules["jax"] = None
sys.path.insert(0, {str(SRC)!r})
import repro_torch
loaded = [m for m in sys.modules if m.startswith(("repro_torch.stream", "repro_torch.core",
                                                  "torch.distributed"))]
assert not loaded, loaded
svc = repro_torch.ResolveService
assert "repro_torch.stream.service" in sys.modules
assert svc.__module__ == "repro_torch.stream.service"
assert not any(m == "repro" or m.startswith("repro.") for m in sys.modules)
print("ok")
"""
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=120)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip() == "ok"
