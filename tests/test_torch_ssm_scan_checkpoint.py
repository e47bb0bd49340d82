"""The SSM's chunked scan, checkpointed by chunk under autograd, on the CPU.

``repro_torch.models.ssm._scan`` runs each chunk through
``torch.utils.checkpoint`` when a gradient is needed: the graph keeps the
chunk's inputs and its carried (B, d_inner, N) state, and the backward
recomputes the chunk.  The recompute runs the same operations on the same
inputs, so the output and every gradient must equal, bit for bit, a run
that keeps the chunks' internals (``ssm.checkpoint`` replaced by a plain
call).  At a narrow width (d_inner 64, N 8) with S = 3 x chunk + 5: several
chunks and a ragged last one.

Memory: the bytes autograd saves for one ``ssm_forward`` are counted with
``torch.autograd.graph.saved_tensors_hooks``, keyed by storage.  Without
the checkpoint each of the scan's log2(chunk) doubling steps keeps two
(B, chunk, d_inner, N) f32 tensors; with it the whole forward keeps at
most SAVED_UNITS x B*S*d_inner*4 bytes (the conv window, the f32 dt and
gate tensors, the projections' inputs), whatever the chunk and N.
"""

from __future__ import annotations

import contextlib
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import base  # noqa: E402
from repro_torch.models import registry, ssm  # noqa: E402
from repro_torch.models.param import in_f32, init_params  # noqa: E402

# the smoke config at d_model 32: d_inner 64, N 8
CFG = dataclasses.replace(base.smoke_config("falcon_mamba_7b"), d_model=32)
B = 2
SAVED_UNITS = 16  # of B * S * d_inner * 4 bytes (about 14 measured)


@contextlib.contextmanager
def chunk_checkpoint(on: bool):
    """With ``on`` false, the scan's chunks run as plain calls."""
    original = ssm.checkpoint
    if not on:
        ssm.checkpoint = lambda fn, *args, **kwargs: fn(*args)
    try:
        yield
    finally:
        ssm.checkpoint = original


def _mixer(cfg=CFG):
    api = registry.get_model(cfg)
    model = api.load(init_params(in_f32(api.param_specs()), seed=0, device="cpu"),
                     trainable=True)
    return api, model, model.layers[0].mixer


def _input(S: int, seed: int = 0):
    x = np.random.default_rng(seed).standard_normal((B, S, CFG.d_model)).astype(np.float32)
    return torch.as_tensor(x).to(torch.bfloat16).requires_grad_()


def _saved_bytes(fn) -> int:
    """The bytes of the distinct storages autograd saves while ``fn`` runs."""
    storages = {}

    def pack(t):
        s = t.untyped_storage()
        storages[s.data_ptr()] = s.nbytes()
        return t

    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        out = fn()
    return out, sum(storages.values())


@pytest.mark.parametrize("chunk", [8, 16])
def test_forward_and_gradients_bitwise(chunk):
    _, _, p = _mixer()
    x = _input(3 * chunk + 5)
    runs = []
    for on in (True, False):
        with chunk_checkpoint(on):
            y = ssm.ssm_forward(CFG, p, x, chunk=chunk)
            leaves = [x, *p.parameters()]
            grads = torch.autograd.grad(y.float().square().sum(), leaves)
        runs.append((y.detach(), grads))
    (y1, g1), (y0, g0) = runs
    assert torch.equal(y1, y0)
    names = ["x", *(n for n, _ in p.named_parameters())]
    assert {"in_proj", "conv_w", "conv_b", "x_proj", "dt_proj", "dt_bias", "A_log", "D",
            "out_proj"} <= set(names)
    for name, a, b in zip(names, g1, g0):
        assert torch.equal(a, b), name
        assert bool(a.abs().max() > 0), name


@pytest.mark.parametrize("remat_group", [0, 2])
def test_model_loss_and_gradients_bitwise(remat_group):
    """The smoke model's loss and every gradient through ``api.loss``: the
    chunk checkpoints nested inside the layer loop's remat."""
    cfg = dataclasses.replace(base.smoke_config("falcon_mamba_7b"), n_layers=4,
                              remat_group=remat_group)
    api, model, _ = _mixer(cfg)
    rng = np.random.default_rng(3)
    S = 3 * 16 + 5
    batch = {k: torch.as_tensor(rng.integers(1, cfg.vocab_size - 1, (B, S)).astype(np.int32))
             for k in ("tokens", "labels")}
    params = [p for _, p in model.named_parameters()]
    runs = []
    for on in (True, False):
        with chunk_checkpoint(on):
            loss, _ = api.loss(model, batch)
            runs.append((loss.detach(), torch.autograd.grad(loss, params)))
    (l1, g1), (l0, g0) = runs
    assert torch.equal(l1, l0)
    for (name, _), a, b in zip(model.named_parameters(), g1, g0):
        assert torch.equal(a, b), name


@pytest.mark.parametrize("chunk", [8, 16])
def test_saved_bytes_bounded(chunk):
    _, _, p = _mixer()
    S = 3 * chunk + 5
    x = _input(S)
    unit = B * S * CFG.d_inner * 4
    _, kept = _saved_bytes(lambda: ssm.ssm_forward(CFG, p, x, chunk=chunk))
    assert kept <= SAVED_UNITS * unit, kept / unit
    with chunk_checkpoint(False):
        _, whole = _saved_bytes(lambda: ssm.ssm_forward(CFG, p, x, chunk=chunk))
    # the chunks' internals: about 2 log2(chunk) (B, chunk, d_inner, N) f32
    # tensors a chunk, N times the unit each
    assert whole > 2 * SAVED_UNITS * unit, whole / unit


def test_no_grad_saves_nothing():
    _, _, p = _mixer()
    x = _input(3 * 16 + 5)
    with torch.no_grad():
        y, kept = _saved_bytes(lambda: ssm.ssm_forward(CFG, p, x, chunk=16))
    assert kept == 0
    assert torch.equal(y, ssm.ssm_forward(CFG, p, x, chunk=16).detach())
