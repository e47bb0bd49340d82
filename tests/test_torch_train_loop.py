"""The port's Trainer on the CPU: the counterparts of
``tests/test_train_infra.py`` (the loss falls, a restart is bitwise,
preemption saves and stops, microbatched equals single), and checkpoints
shared with the reference's Trainer in both directions.

A checkpoint written by the reference's Trainer is restored by the port's,
which then follows the reference's own continuation over four AdamW steps:
the losses and every parameter within LOGITS; each leaf's change over the
four steps within CHANGE_REL of the reference's change (norm over norm);
each leaf of the moments within CHANGE_REL of its largest reference entry.
Those scaled bounds matter: a change is about 4e-3, below LOGITS'
absolute floor, so LOGITS alone would pass a skipped update.

The key bias's change is held in the whole model's change instead of
alone.  Its gradient nearly vanishes in exact arithmetic (the softmax is
shift-invariant; only the rotated part survives), and AdamW divides each
element by its own scale, so bf16 rounding becomes updates of full size:
the reference against itself, with XLA's excess precision on and off,
differs there by 0.385 of the change, and by at most 0.010 on every
other leaf.  Its moments are held leaf by leaf as every other leaf's.
"""

from __future__ import annotations

import shutil
import threading

import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.checkpoint.checkpointer import Checkpointer as RefCheckpointer  # noqa: E402
from repro.configs import base as ref_base  # noqa: E402
from repro.data.corpus import CorpusConfig as RefCorpusConfig  # noqa: E402
from repro.models import param as ref_param  # noqa: E402
from repro.models import registry as ref_registry  # noqa: E402
from repro.train import optimizer as ref_opt  # noqa: E402
from repro.train import trainer as ref_trainer  # noqa: E402
from repro_torch import interop  # noqa: E402
from repro_torch.checkpoint.checkpointer import Checkpointer  # noqa: E402
from repro_torch.configs import base  # noqa: E402
from repro_torch.data.corpus import CorpusConfig  # noqa: E402
from repro_torch.models import param, registry  # noqa: E402
from repro_torch.train import optimizer, train_step  # noqa: E402
from repro_torch.train.trainer import Trainer, TrainerConfig  # noqa: E402
from test_torch_train_families import _flat, loss_and_grads_agree  # noqa: E402

ARCH = "qwen1_5_0_5b"
LOGITS = dict(rtol=2e-2, atol=2e-2)
CHANGE_REL = 5e-2  # per leaf: |change - ref change| / |ref change|; moments max-scaled
NOISY_CHANGE = ("/layers/attn/bk",)  # held in the whole model's change, see the docstring


def _mk_trainer(tmp, steps, ckpt_every=4, microbatches=1, log_every=2, async_ckpt=False):
    cfg = base.smoke_config(ARCH)
    data = CorpusConfig(vocab_size=cfg.vocab_size, seq_len=16, global_batch=4, seed=0)
    tcfg = TrainerConfig(steps=steps, ckpt_every=ckpt_every, log_every=log_every,
                         microbatches=microbatches, ckpt_dir=tmp, async_ckpt=async_ckpt)
    return Trainer(registry.get_model(cfg), data, optimizer.OptConfig(lr=1e-3, warmup_steps=2),
                   tcfg, device="cpu")


def _mk_ref_trainer(tmp, steps, log_every=1):
    cfg = ref_base.smoke_config(ARCH)
    data = RefCorpusConfig(vocab_size=cfg.vocab_size, seq_len=16, global_batch=4, seed=0)
    tcfg = ref_trainer.TrainerConfig(steps=steps, ckpt_every=4, log_every=log_every,
                                     ckpt_dir=tmp, async_ckpt=False)
    return ref_trainer.Trainer(ref_registry.get_model(cfg), data,
                               ref_opt.OptConfig(lr=1e-3, warmup_steps=2), tcfg)


@pytest.mark.parametrize("arch", ["yi_6b", "qwen1_5_0_5b", "qwen2_72b"])
def test_dense_loss_and_gradients_match_reference(arch):
    """The dense decoders' part of ``tests/test_torch_train_families.py``."""
    loss_and_grads_agree(arch)


def test_train_loss_decreases(tmp_path):
    out = _mk_trainer(str(tmp_path / "a"), steps=12).run()
    losses = [loss for _, loss in out["losses"]]
    assert losses[-1] < losses[0], losses
    assert out["steps_done"] == 12 and out["wall_time_s"] > 0


@pytest.mark.parametrize("async_ckpt", [False, True], ids=["sync", "async"])
def test_checkpoint_restart_bitwise(tmp_path, async_ckpt):
    """Stop at step 8, restart, finish: bit for bit the uninterrupted run,
    with the saves written in the caller's thread or in the background (on
    the CPU, where the next step updates the saved tensors in place)."""
    d1, d2 = str(tmp_path / "x"), str(tmp_path / "y")
    full = _mk_trainer(d1, steps=10).run()
    _mk_trainer(d2, steps=8, async_ckpt=async_ckpt).run()
    resumed = _mk_trainer(d2, steps=10, async_ckpt=async_ckpt).run()
    assert resumed["losses"][0][0] == 9  # resumed at step 8
    a, b = dict(full["params"].named_parameters()), dict(resumed["params"].named_parameters())
    for name in a:
        assert torch.equal(a[name], b[name]), name
    for k in ("m", "v"):
        for name in a:
            assert torch.equal(full["opt"][k][name], resumed["opt"][k][name]), (k, name)
    assert int(full["opt"]["step"]) == int(resumed["opt"]["step"]) == 10


def test_async_save_keeps_the_state_as_saved(tmp_path, monkeypatch):
    """An async save writes the state as it was when ``save`` was called,
    though the caller updates its CPU tensors in place before the write
    (held back here until they have)."""
    release, write = threading.Event(), Checkpointer._write

    def held_write(self, *args):
        release.wait()
        write(self, *args)

    monkeypatch.setattr(Checkpointer, "_write", held_write)
    live = {"w": torch.arange(1024, dtype=torch.float32), "step": torch.tensor(3)}
    want = {k: v.clone() for k, v in live.items()}
    ckpt = Checkpointer(str(tmp_path), async_save=True)
    ckpt.save(1, {"state": live})
    live["w"].add_(1.0)
    live["step"].add_(1)
    release.set()
    ckpt.wait()
    got = ckpt.restore(1, {"state": want}, device="cpu")["state"]
    for k in want:
        assert torch.equal(got[k], want[k]), k


def test_preemption_checkpoints_and_stops(tmp_path):
    t = _mk_trainer(str(tmp_path / "p"), steps=100, ckpt_every=1000)
    t.preempted = True
    out = t.run()
    assert out["steps_done"] == 1
    assert Checkpointer(str(tmp_path / "p")).latest_step() is not None


def test_microbatched_train_matches_single():
    """Gradient accumulation over 2 microbatches equals one full-batch step
    (up to the accumulation order's float error), as in the reference."""
    cfg = base.smoke_config(ARCH)
    api = registry.get_model(cfg)
    tree = param.init_params(param.in_f32(api.param_specs()), seed=0, device="cpu")
    batch = api.demo_batch(base.ShapeConfig("t", 16, 4, "train"))
    out = []
    for n in (1, 2):
        model = api.load(tree, trainable=True)
        opt = optimizer.init_opt_state(dict(model.named_parameters()))
        step = train_step.make_train_step(api, optimizer.OptConfig(lr=1e-3), microbatches=n)
        split = train_step.split_microbatches(batch, n)
        model, _, metrics = step(model, opt, {k: torch.as_tensor(v) for k, v in split.items()})
        out.append((dict(model.named_parameters()), metrics))
    (p1, m1), (p2, m2) = out
    np.testing.assert_allclose(float(m1["loss"]), float(m2["loss"]), rtol=1e-5)
    for name in p1:
        np.testing.assert_allclose(p1[name].detach().numpy(), p2[name].detach().numpy(),
                                   rtol=2e-3, atol=2e-4, err_msg=name)


def test_unported_train_options_raise():
    """The compressed step needs a mesh with a ``pod`` axis; a mesh whose
    ``model`` axis has more than one rank (tensor parallelism) raises in
    the Trainer, naming ROADMAP.md Queue 1 item 17."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh
    from torch.testing._internal.distributed.fake_pg import FakeStore

    api = registry.get_model(base.smoke_config(ARCH))
    with pytest.raises(ValueError, match="pod"):
        train_step.make_train_step(api, optimizer.OptConfig(), compress_pods=True)
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=2)
    try:
        mesh = DeviceMesh("cpu", torch.arange(2).reshape(1, 2), mesh_dim_names=("data", "model"))
        with pytest.raises(NotImplementedError, match="item 17"):
            Trainer(api, CorpusConfig(), optimizer.OptConfig(), TrainerConfig(), mesh=mesh,
                    device="cpu")
    finally:
        dist.destroy_process_group()


def _rel_norm(a, b) -> float:
    return float(np.linalg.norm((a.astype(np.float64) - b).ravel()) / np.linalg.norm(b.ravel()))


def assert_follows_reference(got: dict, want: dict, start: dict) -> None:
    """The port's training state ``got`` after the reference's continuation
    ``want``, both from ``start`` (flat ``{"params", "m", "v"}`` maps and a
    ``step``): parameters within LOGITS, each leaf's change within
    CHANGE_REL (norm over norm), each moment leaf within CHANGE_REL of its
    largest reference entry."""
    assert int(got["step"]) == int(want["step"])
    p, w, s = got["params"], want["params"], start["params"]
    assert p.keys() == w.keys() == s.keys()
    for key in w:
        assert p[key].shape == w[key].shape and p[key].dtype == np.float32, key
        np.testing.assert_allclose(p[key], w[key], **LOGITS, err_msg=key)
        if key not in NOISY_CHANGE:
            err = _rel_norm(p[key] - s[key], w[key] - s[key])
            assert err <= CHANGE_REL, f"change of {key}: {err:.3g} > {CHANGE_REL}"
    whole = [np.concatenate([(t[k] - s[k]).ravel() for k in sorted(w)]) for t in (p, w)]
    assert _rel_norm(*whole) <= CHANGE_REL, f"the whole change: {_rel_norm(*whole):.3g}"
    for name in ("m", "v"):
        for key, b in want[name].items():
            err = np.abs(got[name][key].astype(np.float64) - b).max() / np.abs(b).max()
            assert err <= CHANGE_REL, f"{name} of {key}: {err:.3g} > {CHANGE_REL}"


def _state(params, opt) -> dict:
    """A flat training state of the reference's nested numpy trees."""
    flat = lambda t: _flat(jax.tree.map(np.asarray, t))  # noqa: E731
    return {"params": flat(params), "m": flat(opt["m"]), "v": flat(opt["v"]),
            "step": opt["step"]}


@pytest.fixture(scope="module")
def reference_continuation(tmp_path_factory):
    """The reference's Trainer runs 4 steps and checkpoints, then runs
    steps 5-8 from that checkpoint: (a copy of the step-4 checkpoint, the
    step-4 state, the reference's losses and state after step 8)."""
    tmp = tmp_path_factory.mktemp("ref")
    ref_dir, start_dir = tmp / "ref", tmp / "start"
    _mk_ref_trainer(str(ref_dir), steps=4).run()
    shutil.copytree(ref_dir, start_dir)
    rapi = ref_registry.get_model(ref_base.smoke_config(ARCH))
    rparams = ref_param.init_params(rapi.param_specs(), seed=0)
    start = RefCheckpointer(str(start_dir)).restore(
        4, {"params": rparams, "opt": ref_opt.init_opt_state(rparams)})
    want = _mk_ref_trainer(str(ref_dir), steps=8).run()
    return (start_dir, _state(start["params"], start["opt"]), want["losses"],
            _state(want["params"], want["opt"]))


def _port_continuation(start_dir, port_dir, skip_update_at=None):
    """The port's Trainer restored from the step-4 checkpoint, run to step
    8; ``skip_update_at`` (a planted fault): the step whose parameter update
    is undone."""
    shutil.copytree(start_dir, port_dir)
    trainer = _mk_trainer(str(port_dir), steps=8, log_every=1)
    if skip_update_at is not None:
        inner = trainer.step_fn

        def step_fn(model, opt, batch):
            if int(opt["step"]) + 1 != skip_update_at:
                return inner(model, opt, batch)
            kept = {k: p.detach().clone() for k, p in model.named_parameters()}
            model, opt, metrics = inner(model, opt, batch)
            with torch.no_grad():
                for k, p in model.named_parameters():
                    p.copy_(kept[k])
            return model, opt, metrics

        trainer.step_fn = step_fn
    out = trainer.run()
    return out["losses"], _state(*interop.train_state_to_numpy(out["params"], out["opt"]))


def test_reference_checkpoint_restores_and_continues(tmp_path, reference_continuation):
    """The port's Trainer restores the reference's step-4 checkpoint and runs
    steps 5-8 as the reference does from it: the losses within LOGITS, the
    state as ``assert_follows_reference`` holds it."""
    start_dir, start, want_losses, want = reference_continuation
    losses, got = _port_continuation(start_dir, tmp_path / "port")
    assert [s for s, _ in losses] == [s for s, _ in want_losses] == [5, 6, 7, 8]
    np.testing.assert_allclose([x for _, x in losses], [x for _, x in want_losses], **LOGITS)
    assert int(got["step"]) == 8
    assert_follows_reference(got, want, start)


def test_a_skipped_update_is_caught(tmp_path, reference_continuation):
    """A planted fault: the port skips step 6's parameter update.  Every
    parameter stays within LOGITS of the reference's, but the change
    check fails."""
    start_dir, start, _, want = reference_continuation
    _, got = _port_continuation(start_dir, tmp_path / "port", skip_update_at=6)
    for key, w in want["params"].items():
        np.testing.assert_allclose(got["params"][key], w, **LOGITS, err_msg=key)
    with pytest.raises(AssertionError, match="change of"):
        assert_follows_reference(got, want, start)


def test_port_checkpoint_restores_in_the_reference(tmp_path):
    """A checkpoint the port's Trainer writes has the reference's flat keys:
    the reference's Checkpointer restores it into its own state tree."""
    out = _mk_trainer(str(tmp_path), steps=2).run()
    rapi = ref_registry.get_model(ref_base.smoke_config(ARCH))
    rparams = ref_param.init_params(rapi.param_specs(), seed=0)
    template = {"params": rparams, "opt": ref_opt.init_opt_state(rparams)}
    got = RefCheckpointer(str(tmp_path)).restore(2, template)
    params, opt = interop.train_state_to_numpy(out["params"], out["opt"])
    want = {"params": params, "opt": opt}
    assert jax.tree.structure(got) == jax.tree.structure(want)
    for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(want)):
        np.testing.assert_array_equal(np.asarray(a), b)


def test_train_state_round_trips_through_numpy():
    cfg = base.smoke_config("moonshot_v1_16b_a3b")
    api = registry.get_model(cfg)
    tree = jax.tree.map(np.asarray, jax.jit(lambda: ref_param.init_params(
        ref_registry.get_model(ref_base.smoke_config("moonshot_v1_16b_a3b")).param_specs(),
        seed=3))())
    rng = np.random.default_rng(0)
    opt = {"m": jax.tree.map(lambda a: rng.standard_normal(a.shape).astype(np.float32), tree),
           "v": jax.tree.map(lambda a: rng.random(a.shape).astype(np.float32), tree),
           "step": np.int32(7)}
    state = interop.train_state_from_numpy(cfg, tree, opt, device="cpu")
    assert all(p.requires_grad and p.dtype == torch.float32 for p in state["params"].parameters())
    assert state["params"].state_dict().keys() == state["opt"]["m"].keys()
    params, back = interop.train_state_to_numpy(state["params"], state["opt"])
    for a, b in zip(jax.tree.leaves(params), jax.tree.leaves(tree)):
        np.testing.assert_array_equal(a, b)
    for k in ("m", "v"):
        for a, b in zip(jax.tree.leaves(back[k]), jax.tree.leaves(opt[k])):
            np.testing.assert_array_equal(a, b)
    assert int(back["step"]) == 7
    assert registry.get_model(cfg).loss is not None and api.cfg == cfg
