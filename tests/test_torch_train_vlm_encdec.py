"""Training the VLM (Qwen2-VL) and the encoder-decoder (Whisper) with the
inputs beside their tokens, and the attention gradient at their shapes, on
the CPU against the reference.

(a), (b): two steps of the port's ``make_train_step`` (2 microbatches) on
each smoke config, the VLM's batches carrying vision patches at a square
grid of M-RoPE positions, the encoder-decoder's stub audio frames, against
the reference's jitted ``make_train_step``, both from the reference's
seed-0 draw with zero moments, on the same numpy batches.  Both packages
compute in f32 here (``models.layers.COMPUTE_DTYPE``), as
``tests/test_torch_train_trainer_families.py`` sets it: AdamW's first steps
move each element by about lr times the sign of its gradient, so in bf16
one rounding of a near-zero gradient becomes an update of full size (the
VLM's untied embedding, whose rows see a token or two, moved 5-6% apart
from the reference's in bf16 whatever the warm-up).  Tolerances are that
file's: the losses and every parameter within LOGITS, each leaf's change
within CHANGE_REL of the reference's (norm over norm), each moment leaf
within CHANGE_REL of its largest reference entry (in f32 the port follows
within 1e-4).  A planted fault, the patches or frames fed as zeros, must
fail the check.  ``tests/test_torch_train.py`` holds the f32 pieces of a
step (the attention backward within 1e-5, AdamW within 1e-6); a whole step
is held as a whole step.

(c): the plain attention backward, ``attention_backward_blocked`` in query
blocks that leave a ragged last block and torch autograd of
``attention_plain``, against ``jax.vjp`` of the reference's
``kernels/flash_attn/ref.py`` ``attention`` within 1e-5 (f32 throughout,
sums in another order), at the shapes these families give the kernel: a GQA
group of 7, a non-causal S = T that is not a multiple of the block, and a
non-causal S < T (cross attention).
"""

from __future__ import annotations

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs import base as ref_base  # noqa: E402
from repro.kernels.flash_attn import ref as ref_attention  # noqa: E402
from repro.models import param as ref_param  # noqa: E402
from repro.models import registry as ref_registry  # noqa: E402
from repro.train import optimizer as ref_opt  # noqa: E402
from repro.train import train_step as ref_train_step  # noqa: E402
from repro_torch import interop  # noqa: E402
from repro_torch.configs import base  # noqa: E402
from repro_torch.data.corpus import CorpusConfig, TokenStream  # noqa: E402
from repro_torch.kernels.flash_attn import ops as flash  # noqa: E402
from repro_torch.models import registry  # noqa: E402
from repro_torch.train import optimizer, train_step  # noqa: E402
from test_torch_train_families import _flat  # noqa: E402
from test_torch_train_trainer_families import f32_compute  # noqa: E402

LOGITS = dict(rtol=2e-2, atol=2e-2)
CHANGE_REL = 5e-2  # per leaf: |change - ref change| / |ref change|; moments max-scaled
OP_BY_OP = {"xla_allow_excess_precision": False}
OPT = dict(lr=1e-3, warmup_steps=2)
STEPS, MICRO = 2, 2
PATCHES = 16  # the VLM smoke config's patches as a 4 x 4 grid (its own 8 form none)
SHAPES = {"qwen2_vl_7b": (4, 32), "whisper_medium": (4, 16)}  # batch, text tokens


def _cfgs(arch):
    """The reference's and the port's smoke configs of ``arch``."""
    rcfg, cfg = ref_base.smoke_config(arch), base.smoke_config(arch)
    if cfg.vision_dim:
        rcfg = dataclasses.replace(rcfg, vision_patches=PATCHES)
        cfg = dataclasses.replace(cfg, vision_patches=PATCHES)
    return rcfg, cfg


def family_batch(arch: str, cfg, seed: int) -> dict:
    """Step ``seed``'s tokens and labels of the synthetic Zipf corpus (the
    Trainer's) with the family's inputs beside them, from numpy: the VLM's
    patch embeddings after 4 tokens, placed as a square grid of one frame in
    the M-RoPE streams (text (i, i, i); patches (t0, t0 + row, t0 + col);
    the text after resumes at the largest position + 1); the
    encoder-decoder's frames (B, encoder_frames, d_model)."""
    B, S = SHAPES[arch]
    rng = np.random.default_rng(seed)
    out = TokenStream(CorpusConfig(vocab_size=cfg.vocab_size, seq_len=S, global_batch=B,
                                   seed=0)).batch(seed)
    if cfg.vision_dim:
        P, text = cfg.vision_patches, 4
        side = int(round(P ** 0.5))
        grid = np.arange(P)
        pos = np.zeros((3, S), np.int32)
        pos[:, :text] = np.arange(text)
        pos[0, text:text + P] = text
        pos[1, text:text + P] = text + grid // side
        pos[2, text:text + P] = text + grid % side
        pos[:, text + P:] = pos[:, :text + P].max() + 1 + np.arange(S - text - P)
        out["positions"] = np.broadcast_to(pos[:, None], (3, B, S)).copy()
        out["vision_embeds"] = rng.normal(0, 0.3, (B, P, cfg.vision_dim)).astype(np.float32)
        out["vision_pos"] = np.broadcast_to(text + grid, (B, P)).astype(np.int32).copy()
    if cfg.family == "encdec":
        out["frames"] = rng.normal(0, 0.3, (B, cfg.encoder_frames, cfg.d_model)).astype(
            np.float32)
    return out


def _state(params, opt) -> dict:
    flat = lambda t: _flat(jax.tree.map(np.asarray, t))  # noqa: E731
    return {"params": flat(params), "m": flat(opt["m"]), "v": flat(opt["v"]),
            "step": int(opt["step"])}


@functools.lru_cache(maxsize=None)
def reference_steps(arch):
    """The reference's seed-0 draw (numpy trees), and its losses and state
    after ``STEPS`` steps from it with zero moments, in f32 compute."""
    rcfg, _ = _cfgs(arch)
    rapi = ref_registry.get_model(rcfg)
    with f32_compute():
        params = jax.jit(lambda: ref_param.init_params(rapi.param_specs(), seed=0))()
        ost = ref_opt.init_opt_state(params)
        start = jax.tree.map(np.asarray, params)
        batches = [{k: jnp.asarray(v) for k, v in _split(arch, s).items()} for s in range(STEPS)]
        step = jax.jit(ref_train_step.make_train_step(
            rapi, ref_opt.OptConfig(**OPT), microbatches=MICRO)).lower(
            params, ost, batches[0]).compile(compiler_options=OP_BY_OP)
        losses = []
        for b in batches:
            params, ost, m = step(params, ost, b)
            losses.append(float(m["loss"]))
    return start, losses, _state(params, ost)


def _split(arch, step: int) -> dict:
    return train_step.split_microbatches(family_batch(arch, _cfgs(arch)[1], step), MICRO)


@functools.lru_cache(maxsize=None)
def port_steps(arch, drop: str | None = None):
    """The port's losses and state after ``STEPS`` steps of
    ``make_train_step`` from the reference's draw, in f32 compute;
    ``drop`` (a planted fault): an input the port's batches carry as
    zeros."""
    start, _, _ = reference_steps(arch)
    cfg = _cfgs(arch)[1]
    with f32_compute():
        state = interop.train_state_from_numpy(cfg, start, device="cpu")
        model, opt = state["params"], state["opt"]
        step = train_step.make_train_step(registry.get_model(cfg), optimizer.OptConfig(**OPT),
                                          microbatches=MICRO)
        losses = []
        for s in range(STEPS):
            b = {k: torch.as_tensor(v) for k, v in _split(arch, s).items()}
            if drop:
                b[drop] = torch.zeros_like(b[drop])
            model, opt, m = step(model, opt, b)
            losses.append(float(m["loss"]))
    return losses, _state(*interop.train_state_to_numpy(model, opt))


def _rel_norm(a, b) -> float:
    return float(np.linalg.norm((a.astype(np.float64) - b).ravel()) / np.linalg.norm(b.ravel()))


def assert_follows(arch, got: dict, want: dict, start: dict) -> None:
    """The port's state ``got`` after the reference's ``want``, both from the
    draw ``start`` with zero moments: parameters within LOGITS, each leaf's
    change within CHANGE_REL (a leaf the loss does not read unchanged), each
    moment leaf within CHANGE_REL of its largest reference entry.  A key
    bias with no rotation after it (Whisper's) has a gradient of 0 in exact
    arithmetic and rounding's in f32: its change is held in the whole
    model's, and its moments are not held."""
    assert got["step"] == want["step"] == STEPS
    p, w = got["params"], want["params"]
    s = _flat(start)
    noisy = () if _cfgs(arch)[1].use_rope else ("attn/bk",)
    assert p.keys() == w.keys() == s.keys()
    for key in w:
        assert p[key].shape == w[key].shape and p[key].dtype == np.float32, key
        np.testing.assert_allclose(p[key], w[key], **LOGITS, err_msg=key)
        if not np.any(w[key] != s[key]):  # a leaf the loss does not read, still 0
            assert np.array_equal(p[key], s[key]), f"{key} moved"
        elif not key.endswith(noisy):
            err = _rel_norm(p[key] - s[key], w[key] - s[key])
            assert err <= CHANGE_REL, f"change of {key}: {err:.3g} > {CHANGE_REL}"
    whole = [np.concatenate([(t[k] - s[k]).ravel() for k in sorted(w)]) for t in (p, w)]
    assert _rel_norm(*whole) <= CHANGE_REL, f"the whole change: {_rel_norm(*whole):.3g}"
    for name in ("m", "v"):
        for key, b in want[name].items():
            if key.endswith(noisy):
                continue
            scale = np.abs(b).max()
            err = np.abs(got[name][key].astype(np.float64) - b).max() / (scale or 1.0)
            assert err <= CHANGE_REL, f"{name} of {key}: {err:.3g} > {CHANGE_REL}"


@pytest.mark.parametrize("arch", ["qwen2_vl_7b", "whisper_medium"])
def test_train_steps_with_inputs_follow_reference(arch):
    """(a) the VLM with vision patches and grid positions, (b) the
    encoder-decoder with frames: the port's steps follow the reference's."""
    start, want_losses, want = reference_steps(arch)
    got_losses, got = port_steps(arch)
    np.testing.assert_allclose(got_losses, want_losses, **LOGITS)
    assert_follows(arch, got, want, start)


@pytest.mark.parametrize("arch, drop", [("qwen2_vl_7b", "vision_embeds"),
                                        ("whisper_medium", "frames")])
def test_a_step_that_drops_the_inputs_is_caught(arch, drop):
    """A planted fault: the port's batches carry the patches or frames as
    zeros.  The losses stay within LOGITS, but the state check fails."""
    start, want_losses, want = reference_steps(arch)
    got_losses, got = port_steps(arch, drop)
    np.testing.assert_allclose(got_losses, want_losses, **LOGITS)
    with pytest.raises(AssertionError, match="change of|m of|v of"):
        assert_follows(arch, got, want, start)


# (B, S, T, H, Hkv, hd, causal, query block): a GQA group of 7 (Qwen2-VL's
# 28/4), a ragged non-causal S = T (Whisper's encoder: 1,500 is 23 x 64 +
# 28), a non-causal S < T (its cross attention: 448 over 1,500)
BACKWARD_CASES = [
    (1, 40, 40, 14, 2, 16, True, 16),
    (2, 100, 100, 4, 4, 16, False, 32),
    (2, 28, 100, 4, 4, 8, False, 8),
    (1, 36, 100, 7, 1, 8, False, 16),
]


@pytest.mark.parametrize("case", BACKWARD_CASES, ids=lambda c: "B{}S{}T{}H{}kv{}hd{}{}qb{}".format(
    *c[:6], "causal" if c[6] else "full", c[7]))
def test_attention_backward_at_the_families_shapes(case):
    """(c) dq, dk, dv of ``attention_backward_blocked`` and of torch autograd
    of ``attention_plain`` against ``jax.vjp`` of the reference's
    ``attention``, within 1e-5."""
    B, S, T, H, hkv, hd, causal, qb = case
    rng = np.random.default_rng(7)
    q, k, v = (rng.standard_normal(s).astype(np.float32)
               for s in [(B, S, H, hd), (B, T, hkv, hd), (B, T, hkv, hd)])
    do = rng.standard_normal((B, S, H * hd)).astype(np.float32)
    scale = 1.0 / np.sqrt(hd)
    qt, kt, vt = (torch.tensor(x, requires_grad=True) for x in (q, k, v))
    o = flash.attention_plain(qt, kt, vt, scale, causal=causal)
    autograd = torch.autograd.grad(o, (qt, kt, vt), torch.tensor(do))
    blocked = flash.attention_backward_blocked(
        torch.tensor(q), torch.tensor(k), torch.tensor(v), o.detach(), torch.tensor(do), scale,
        causal, q_block=qb)
    out, vjp = jax.vjp(lambda a, b, c: ref_attention.attention(a, b, c, scale, causal=causal),
                       jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    want = vjp(jnp.asarray(do))
    np.testing.assert_allclose(o.detach().numpy(), np.asarray(out), atol=1e-5, rtol=1e-5)
    for name, a, b, w in zip("qkv", autograd, blocked, want):
        for what, g in (("autograd", a), ("blocked", b)):
            assert g.dtype == torch.float32 and g.shape == w.shape, (what, name)
            np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-5, rtol=1e-5,
                                       err_msg=f"{what} d{name}")
