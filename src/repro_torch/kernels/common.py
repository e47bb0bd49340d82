"""Shared helpers for the port's kernels: tiling, tolerances, devices, meshes.

Routing policy (``ops.py`` of every kernel): a wrapper runs its kernel's
plain PyTorch version only because the tensors it was given lie on the
CPU, or on ``meta`` (shapes without data: the dry run's abstract step,
where there is nothing to launch on).  On a CUDA tensor it launches the
hand-written kernel (built by :mod:`repro_torch.kernels.build`) or
raises; there is no fallback and no switch that turns the kernels off.
"""

from __future__ import annotations

import numpy as np
import torch


def takes_plain(t: torch.Tensor) -> bool:
    """Whether a wrapper runs its plain version on ``t``: a CPU tensor, or a
    ``meta`` one (no data; never a CUDA tensor)."""
    return t.device.type in ("cpu", "meta")


def round_up(x: int, m: int) -> int:
    return (x + m - 1) // m * m


def pick_tile(n: int, preferred: int = 128, floor: int = 8) -> int:
    """Largest power-of-two tile <= preferred that keeps padding sane."""
    if n >= preferred:
        return preferred
    t = floor
    while t * 2 <= max(n, floor):
        t *= 2
    return max(t, floor)


def assert_allclose(a, b, rtol=1e-5, atol=1e-5, msg=""):
    def _np(x):
        return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)

    np.testing.assert_allclose(_np(a), _np(b), rtol=rtol, atol=atol, err_msg=msg)


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: ``None`` means ``"cuda"``.

    Never falls back to the CPU on its own: without a GPU, asking for
    CUDA raises, and the caller has to pass ``device="cpu"``.  On CUDA
    float32 products stay in full float32: the matcher decides against
    ``TIE_EPS = 1e-5`` and TF32 would round its weights.  bfloat16
    products (the LM stack's projections) accumulate in float32, as the
    reference's ``preferred_element_type`` asks.
    """
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "repro_torch runs on a CUDA device by default and none is "
                "available; pass device='cpu' to run on the CPU"
            )
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
        if torch.get_float32_matmul_precision() != "highest":
            raise RuntimeError(
                "float32 matmul precision is "
                f"{torch.get_float32_matmul_precision()!r}; repro_torch needs 'highest'"
            )
    elif dev.type != "cpu":
        raise RuntimeError(f"unsupported device {dev}")
    return dev


def check_operand(
    name: str, t: torch.Tensor, shape: tuple, device: torch.device,
    dtype: torch.dtype = torch.float32,
) -> None:
    """Raise unless ``t`` is a contiguous ``dtype`` tensor of ``shape`` on ``device``,
    a CUDA device (the kernels take nothing else)."""
    if device.type != "cuda":
        raise ValueError(f"{name}: the CUDA kernels take CUDA tensors, not {device}")
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise ValueError(f"{name} has dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


# ---------------------------------------------------------------------------
# Mesh helpers (sharded serving: repro_torch.launch.mesh.EMMesh)
# ---------------------------------------------------------------------------


def mesh_spans_processes(mesh) -> bool:
    """True when ``mesh`` has more than one rank (one process a rank)."""
    return mesh is not None and mesh.size > 1


def put_replicated(x, mesh) -> torch.Tensor:
    """Upload a host array to this rank's device: every rank holds the
    same host state, so a replicated value is a plain upload."""
    return torch.as_tensor(np.asarray(x), device=mesh.device)


def put_sharded(x, mesh, axis: int = 0) -> torch.Tensor:
    """This rank's slice of ``x`` along ``axis``, on its device: the axis
    padded to a multiple of the rank count and split evenly
    (``EMMesh.row_slice``; the last slices may be short or empty)."""
    x = np.asarray(x)
    lo, hi = mesh.row_slice(x.shape[axis])
    return torch.as_tensor(np.take(x, np.arange(lo, hi), axis=axis), device=mesh.device)


def host_array(x) -> np.ndarray:
    """Bring a (replicated) device tensor back to the host as numpy."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)
