"""The port's ``Trainer`` for the MoE (Moonlight), MLA (MiniCPM3) and SSM
(Falcon-Mamba, its chunked scan checkpointed by chunk) families on the
CPU, at their smoke configs.

Against the reference's ``Trainer``: both start from one seed-0 draw of
the reference's ``init_params`` (carried to the port by
``interop.train_state_from_numpy``) with zero moments, and train 3 steps in
2 microbatches on the same corpus.  The logged losses agree within LOGITS,
and the state after step 3 follows the reference's as
``tests/test_torch_train_loop.py`` holds a continuation: each leaf's change
within CHANGE_REL of the reference's change (norm over norm), each moment
leaf within CHANGE_REL of its largest reference entry.  A skipped update
passes LOGITS and must fail the change check (a planted fault).

Both packages compute in f32 here (``models.layers.COMPUTE_DTYPE``, bf16 by
default).  AdamW's first steps move each element by about lr times the sign
of its gradient, so in bf16 one rounding of a near-zero gradient becomes an
update of full size, and the two packages round differently (the reference
jits its step); the MoE's routing also sits on near ties in bf16
(``tests/test_torch_train_tp.py``).  In f32 the changes measure the port,
not the rounding.

Restart: a run stopped at its step-2 checkpoint and restarted to step 3 is
bit for bit the uninterrupted run (parameters, both moments and the step),
as ``tests/test_torch_train_loop.py`` holds it for the dense decoder, in
the default bf16 compute.
"""

from __future__ import annotations

import contextlib
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs import base as ref_base  # noqa: E402
from repro.data.corpus import CorpusConfig as RefCorpusConfig  # noqa: E402
from repro.models import layers as ref_layers  # noqa: E402
from repro.models import param as ref_param  # noqa: E402
from repro.models import registry as ref_registry  # noqa: E402
from repro.train import optimizer as ref_opt  # noqa: E402
from repro.train import trainer as ref_trainer  # noqa: E402
from repro_torch import interop  # noqa: E402
from repro_torch.configs import base  # noqa: E402
from repro_torch.data.corpus import CorpusConfig  # noqa: E402
from repro_torch.models import layers, registry  # noqa: E402
from repro_torch.train import optimizer  # noqa: E402
from repro_torch.train.trainer import Trainer, TrainerConfig  # noqa: E402
from test_torch_train_loop import _state, assert_follows_reference  # noqa: E402

ARCHS = ["moonshot_v1_16b_a3b", "minicpm3_4b", "falcon_mamba_7b"]
LOGITS = dict(rtol=2e-2, atol=2e-2)
STEPS, MICRO = 3, 2
DATA = dict(seq_len=16, global_batch=4, seed=0)
OPT = dict(lr=1e-3, warmup_steps=2)


@contextlib.contextmanager
def f32_compute():
    """Both packages' models compute in f32 inside the block."""
    old = ref_layers.COMPUTE_DTYPE, layers.COMPUTE_DTYPE
    ref_layers.COMPUTE_DTYPE, layers.COMPUTE_DTYPE = jnp.float32, torch.float32
    try:
        yield
    finally:
        ref_layers.COMPUTE_DTYPE, layers.COMPUTE_DTYPE = old


def _trainer(arch, steps, ckpt_dir=None):
    cfg = base.smoke_config(arch)
    data = CorpusConfig(vocab_size=cfg.vocab_size, **DATA)
    tcfg = TrainerConfig(steps=steps, ckpt_every=2, log_every=1, microbatches=MICRO,
                         ckpt_dir=ckpt_dir)
    return Trainer(registry.get_model(cfg), data, optimizer.OptConfig(**OPT), tcfg,
                   device="cpu")


@functools.lru_cache(maxsize=None)
def reference_run(arch):
    """The reference's Trainer over STEPS steps in f32 from its jitted seed-0
    draw: (the draw as numpy, its flat start state, the losses, the flat
    state after the last step)."""
    rcfg = ref_base.smoke_config(arch)
    rapi = ref_registry.get_model(rcfg)
    with f32_compute():
        rparams = jax.jit(lambda: ref_param.init_params(rapi.param_specs(), seed=0))()
        ref = ref_trainer.Trainer(
            rapi, RefCorpusConfig(vocab_size=rcfg.vocab_size, **DATA), ref_opt.OptConfig(**OPT),
            ref_trainer.TrainerConfig(steps=STEPS, log_every=1, microbatches=MICRO))
        start = {"params": rparams, "opt": ref_opt.init_opt_state(rparams)}
        ref.init_state = lambda: (start, 0)
        want = ref.run()
    return (jax.tree.map(np.asarray, rparams), _state(start["params"], start["opt"]),
            want["losses"], _state(want["params"], want["opt"]))


def port_run(arch, skip_update_at=None):
    """The port's Trainer in f32 from the reference's draw: its losses and
    flat state; ``skip_update_at`` (a planted fault): the step whose
    parameter update is undone."""
    draw = reference_run(arch)[0]
    port = _trainer(arch, STEPS)
    port.init_state = lambda: (interop.train_state_from_numpy(
        base.smoke_config(arch), draw, device="cpu"), 0)
    if skip_update_at is not None:
        inner = port.step_fn

        def step_fn(model, opt, batch):
            if int(opt["step"]) + 1 != skip_update_at:
                return inner(model, opt, batch)
            kept = {k: p.detach().clone() for k, p in model.named_parameters()}
            model, opt, metrics = inner(model, opt, batch)
            with torch.no_grad():
                for k, p in model.named_parameters():
                    p.copy_(kept[k])
            return model, opt, metrics

        port.step_fn = step_fn
    with f32_compute():
        out = port.run()
    return out["losses"], _state(*interop.train_state_to_numpy(out["params"], out["opt"]))


@pytest.mark.parametrize("arch", ARCHS)
def test_trainer_matches_reference(arch):
    _, start, want_losses, want = reference_run(arch)
    got_losses, got = port_run(arch)
    assert [s for s, _ in got_losses] == [s for s, _ in want_losses] == list(range(1, STEPS + 1))
    np.testing.assert_allclose([x for _, x in got_losses], [x for _, x in want_losses],
                               **LOGITS)
    assert_follows_reference(got, want, start)


@pytest.mark.parametrize("arch", ARCHS)
def test_a_skipped_update_is_caught(arch):
    """A planted fault: the port skips step 2's parameter update.  Every
    parameter stays within LOGITS of the reference's, but the change check
    fails."""
    _, start, _, want = reference_run(arch)
    _, got = port_run(arch, skip_update_at=2)
    for key, w in want["params"].items():
        np.testing.assert_allclose(got["params"][key], w, **LOGITS, err_msg=key)
    with pytest.raises(AssertionError, match="change of"):
        assert_follows_reference(got, want, start)


@pytest.mark.parametrize("arch", ARCHS)
def test_restart_is_bitwise(arch, tmp_path):
    full = _trainer(arch, STEPS, str(tmp_path / "full")).run()
    _trainer(arch, 2, str(tmp_path / "cut")).run()
    resumed = _trainer(arch, STEPS, str(tmp_path / "cut")).run()
    assert [s for s, _ in resumed["losses"]] == [3]
    assert resumed["losses"] == full["losses"][2:]
    a, b = dict(full["params"].named_parameters()), dict(resumed["params"].named_parameters())
    assert a.keys() == b.keys()
    for name in a:
        assert torch.equal(a[name], b[name]), name
        for k in ("m", "v"):
            assert torch.equal(full["opt"][k][name], resumed["opt"][k][name]), (k, name)
    assert int(full["opt"]["step"]) == int(resumed["opt"]["step"]) == STEPS
