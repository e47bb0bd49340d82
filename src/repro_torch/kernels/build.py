"""Build and load the port's CUDA kernels.

Every ``csrc/*.cu`` source is compiled for Hopper (``sm_90a``) by its own
``nvcc`` process, all started together, and the objects are linked into
one shared library with a plain C interface, loaded with :mod:`ctypes`.
The library lands in ``src/repro_torch/_build/`` under a name keyed by a
hash of the sources and flags, so a tree builds once and an edited
source rebuilds.  Nothing is built at import: the first kernel launch
(or :func:`library`) builds.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path

PKG = Path(__file__).resolve().parent.parent
CSRC = PKG / "csrc"
BUILD_DIR = PKG / "_build"
ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]
NVCC_FLAGS = [*ARCH_FLAGS, "-std=c++17", "-O3", "-Xcompiler", "-fPIC"]

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# exported C entry points: (argument types); each returns a cudaError_t
SIGNATURES = {
    "repro_icm_sweep": [_P, _P, _P, _P, _I, _I, _I, _P],
    "repro_ngram_sim": [_P, _P, _P, _I, _I, _I, _F, _P],
    "repro_mln_score": [_P, _P, _P, _P, _I, _I, _I, _P],
    "repro_minhash": [_P, _P, _P, _I, _I, _I, _I, _I, _P],
    "repro_flash_attn": [_P] * 5 + [_I] * 6 + [_F, _I, _I, _P],
    "repro_flash_attn_sm90": [_P] * 7 + [_I] * 7 + [_F, _I, _P],
    "repro_flash_attn_sm90_plan": [_I] * 3,
    "repro_flash_attn_sm90_instances": [_P, _I],
    "repro_flash_attn_bwd": [_P] * 10 + [_I] * 6 + [_F, _I, _I, _P],
    "repro_flash_attn_bwd_sm90": [_P] * 17 + [_I] * 7 + [_F, _I, _P],
    "repro_flash_attn_bwd_sm90_plan": [_I] * 6 + [_P],
    "repro_flash_attn_bwd_sm90_instances": [_P, _I],
}

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None


def nvcc() -> str:
    path = shutil.which("nvcc")
    if path is None and Path("/usr/local/cuda/bin/nvcc").exists():
        path = "/usr/local/cuda/bin/nvcc"
    if path is None:
        raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit")
    return path


def _sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu"))


def library_path() -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for f in sorted(CSRC.glob("*.cu*")):
        h.update(f.name.encode())
        h.update(f.read_bytes())
    return BUILD_DIR / f"librepro_torch_{h.hexdigest()[:16]}.so"


def build(ptxas_verbose: bool = False) -> Path:
    """Compile the sources in parallel and link them; returns the library path.

    With ``ptxas_verbose`` each kernel's registers, spills and shared memory
    (``-Xptxas -v``) are printed as the sources compile.
    """
    target = library_path()
    if target.exists():
        return target
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    exe = nvcc()
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        objs = [Path(tmp) / f"{src.stem}.o" for src in _sources()]
        procs = [
            subprocess.Popen(
                [exe, *NVCC_FLAGS, *(["-Xptxas", "-v"] if ptxas_verbose else []),
                 "-I", str(CSRC), "-c", str(src), "-o", str(obj)],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
            )
            for src, obj in zip(_sources(), objs)
        ]
        logs = [p.communicate()[0] for p in procs]
        failed = [(src.name, log) for src, p, log in zip(_sources(), procs, logs) if p.returncode]
        if ptxas_verbose:
            for src, log in zip(_sources(), logs):
                print(f"--- {src.name}\n{log}", flush=True)
        if failed:
            raise RuntimeError(
                "nvcc failed:\n" + "\n".join(f"--- {name}\n{log}" for name, log in failed)
            )
        so = Path(tmp) / target.name
        link = subprocess.run(
            [exe, *ARCH_FLAGS, "-shared", *map(str, objs), "-o", str(so)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        )
        if link.returncode:
            raise RuntimeError(f"nvcc link failed:\n{link.stdout}")
        os.replace(so, target)
    return target


def library() -> ctypes.CDLL:
    """The loaded kernel library, built on first use."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            for name, argtypes in SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            _lib = lib
    return _lib


def check(name: str, rc: int) -> None:
    """Raise if a launch returned a CUDA error code."""
    if rc != 0:
        raise RuntimeError(f"{name} launch failed with CUDA error {rc}")
