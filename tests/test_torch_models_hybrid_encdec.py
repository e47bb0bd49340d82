"""The port's hybrid (Jamba) and encoder-decoder (Whisper) families vs the
reference, on the CPU; and the weight draw's bf16 leaves for every family.

Smoke configs; weights from the reference's ``init_params`` carried
across with ``interop.lm_params_from_numpy``; inputs made from a seed with
numpy.  Tolerances are those of ``tests/test_torch_models.py``: one bf16
layer within 1e-2 (BF16), logits and stacks of layers within 2e-2
(LOGITS).  Neither family has a prefill: a prompt goes in as decode steps.
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs import base as ref_base  # noqa: E402
from repro.models import encdec as ref_encdec  # noqa: E402
from repro.models import hybrid as ref_hybrid  # noqa: E402
from repro.models import layers as ref_layers  # noqa: E402
from repro.models import param as ref_param  # noqa: E402
from repro.models import registry as ref_registry  # noqa: E402
from repro_torch import interop  # noqa: E402
from repro_torch.configs import base  # noqa: E402
from repro_torch.models import encdec, hybrid, layers, param, registry  # noqa: E402

BF16 = dict(rtol=1e-2, atol=1e-2)
LOGITS = dict(rtol=2e-2, atol=2e-2)
HYBRID, ENCDEC = "jamba_v0_1_52b", "whisper_medium"


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().cpu().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _bf16(a):
    """The same bf16 values in both frameworks (numpy f32 rounded once)."""
    return jnp.asarray(a).astype(jnp.bfloat16), torch.as_tensor(a).to(torch.bfloat16)


def _tokens(cfg, shape, seed):
    return np.random.default_rng(seed).integers(1, cfg.vocab_size - 1, shape).astype(np.int32)


def _ref_params(arch, biases: float = 0.0):
    """The reference's smoke-config weights; ``biases`` > 0 draws the zero-init
    q/k/v biases from N(0, biases) instead."""
    rcfg = ref_base.smoke_config(arch)
    rapi = ref_registry.get_model(rcfg)
    rparams = jax.tree.map(np.asarray, jax.jit(
        lambda: ref_param.init_params(rapi.param_specs(), seed=0))())
    if biases:
        rng = np.random.default_rng(21)
        for stack_name in ("enc_layers", "dec_layers"):
            for group in rparams[stack_name].values():
                for b in ("bq", "bk", "bv"):
                    if b in group:
                        group[b] = rng.normal(0, biases, group[b].shape).astype(np.float32)
    return rcfg, rapi, rparams


@pytest.fixture(scope="module")
def models():
    """(arch, biases) -> (ref cfg, ref api, ref params, port cfg, port api, port model)."""
    cache = {}

    def get(arch, biases: float = 0.0):
        if (arch, biases) not in cache:
            rcfg, rapi, rparams = _ref_params(arch, biases)
            cfg = base.smoke_config(arch)
            model = interop.lm_params_from_numpy(cfg, rparams, device="cpu")
            cache[arch, biases] = (rcfg, rapi, rparams, cfg, registry.get_model(cfg), model)
        return cache[arch, biases]

    return get


def _port_tree(ref_tree, like):
    """A reference-shaped tree (a cache) as torch tensors of ``like``'s dtypes."""
    if isinstance(ref_tree, dict):
        return {k: _port_tree(v, like[k]) for k, v in ref_tree.items()}
    return torch.as_tensor(_np(ref_tree)).to(like.dtype)


def _zeros(specs):
    return param.spec_tree_map(lambda ps: torch.zeros(ps.shape, dtype=ps.dtype), specs)


# ---------------------------------------------------------------------------
# layers
# ---------------------------------------------------------------------------


def test_layernorm_matches_reference():
    rng = np.random.default_rng(0)
    x = (3 + 2 * rng.standard_normal((2, 8, 64))).astype(np.float32)
    p = {"scale": (1 + 0.1 * rng.standard_normal(64)).astype(np.float32),
         "bias": (0.1 * rng.standard_normal(64)).astype(np.float32)}
    xj, xt = _bf16(x)
    for eps in (1e-5, 1e-6):
        got = layers.layernorm({k: torch.as_tensor(v) for k, v in p.items()}, xt, eps)
        want = jax.jit(ref_layers.layernorm, static_argnums=2)(
            {k: jnp.asarray(v) for k, v in p.items()}, xj, eps)
        assert got.dtype == torch.bfloat16
        np.testing.assert_allclose(_np(got), _np(want), **BF16)
    assert set(layers.layernorm_spec(64)) == {"scale", "bias"}
    assert layers.layernorm_spec(64)["bias"].init == "zeros"


def test_cross_attention_train_matches_reference(models):
    """The cross attention over a longer memory (S != T), no mask; biases
    set nonzero, which it does not add (the reference's form)."""
    rcfg, _, rparams, cfg, _, model = models(ENCDEC, 0.5)
    rp = jax.tree.map(lambda a: a[1], rparams["dec_layers"])["cross_attn"]
    tp = model.dec_layers[1].cross_attn
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 6, cfg.d_model)).astype(np.float32)
    mem = rng.standard_normal((2, cfg.encoder_frames, cfg.d_model)).astype(np.float32)
    (xj, xt), (mj, mt) = _bf16(x), _bf16(mem)
    got = layers.cross_attention_train(cfg, tp, xt, mt)
    want = jax.jit(ref_layers.cross_attention_train, static_argnums=0)(rcfg, rp, xj, mj)
    assert tuple(got.shape) == (2, 6, cfg.d_model) and got.dtype == torch.bfloat16
    np.testing.assert_allclose(_np(got), _np(want), **LOGITS)


# ---------------------------------------------------------------------------
# the hybrid (Jamba)
# ---------------------------------------------------------------------------


def test_hybrid_tree_and_load(models):
    rcfg, rapi, rparams, cfg, api, model = models(HYBRID)
    per = cfg.period or cfg.attn_layer_period
    assert [hybrid._is_attn(cfg, i) for i in range(per)] == \
        [ref_hybrid._is_attn(rcfg, i) for i in range(per)]
    assert [hybrid._is_moe(cfg, i) for i in range(per)] == \
        [ref_hybrid._is_moe(rcfg, i) for i in range(per)]
    assert len(model.periods) == hybrid._n_periods(cfg) == ref_hybrid._n_periods(rcfg)
    with pytest.raises(AssertionError):  # a depth is cut in whole periods only
        hybrid._n_periods(dataclasses.replace(cfg, n_layers=cfg.n_layers + 1))
    sd = model.state_dict()
    attn = f"periods.0.l{cfg.attn_layer_offset}"
    assert sd[f"{attn}.mixer.wq"].dtype == torch.bfloat16
    assert sd["periods.0.l1.ffn.router"].dtype == torch.float32
    assert sd["periods.0.l0.mixer.A_log"].dtype == torch.float32
    assert sd["embed"].dtype == sd["lm_head"].dtype == sd["periods.0.l0.ln1"].dtype == torch.float32
    np.testing.assert_array_equal(
        _np(sd["periods.0.l1.ffn.w_in"]),
        np.asarray(jnp.asarray(rparams["periods"]["l1"]["ffn"]["w_in"][0])
                   .astype(jnp.bfloat16).astype(jnp.float32)))


def test_hybrid_forward_train_matches_reference(models):
    """Hidden states and logits within LOGITS, against the reference run op
    by op (``jax.disable_jit``), which rounds to bf16 after every op as the
    port does.  Compiled, XLA's fusions keep some intermediates in f32; on
    this input that moves one token's near-tie expert choice (a 2e-3 gap
    between its 2nd and 3rd router probabilities) in the reference itself,
    compiled against op by op."""
    rcfg, rapi, rparams, cfg, api, model = models(HYBRID)
    B, S = 2, 16
    toks = _tokens(cfg, (B, S), 4)
    with jax.disable_jit():
        want_h, want_aux = ref_hybrid.forward_train(rcfg, rparams, jnp.asarray(toks))
    got_h, got_aux = hybrid.forward_train(cfg, model, torch.as_tensor(toks))
    assert got_h.dtype == torch.bfloat16 and tuple(got_h.shape) == (B, S, cfg.d_model)
    np.testing.assert_allclose(_np(got_h), _np(want_h), **LOGITS)
    got = hybrid.logits_of(cfg, model, got_h)
    want = ref_layers.unembed(jnp.asarray(rparams["lm_head"]), want_h)
    np.testing.assert_allclose(_np(got), _np(want), **LOGITS)
    assert float(want_aux) > 2 * 0.9  # two MoE sublayers, each about K = 2 at uniform routing
    np.testing.assert_allclose(float(got_aux), float(want_aux), rtol=1e-2)


def test_hybrid_decode_step_matches_reference(models):
    """A prompt fed as decode steps from a zero cache in both packages, then
    one more step of the port from the reference's own cache."""
    rcfg, rapi, rparams, cfg, api, model = models(HYBRID)
    B, S, s_max = 2, 6, 8
    toks = _tokens(cfg, (B, S), 5)
    decode = jax.jit(rapi.decode)
    rcache = jax.tree.map(lambda ps: jnp.zeros(ps.shape, ps.dtype), rapi.cache_specs(B, s_max),
                          is_leaf=lambda x: isinstance(x, ref_param.PSpec))
    cache = _zeros(api.cache_specs(B, s_max))
    assert jax.tree.map(np.shape, rcache) == param.spec_tree_map(
        lambda ps: ps.shape, api.cache_specs(B, s_max))
    for t in range(S - 1):
        batch = {"tokens": toks[:, t:t + 1], "pos": np.full((B,), t, np.int32)}
        want, rcache = decode(rparams, rcache, jax.tree.map(jnp.asarray, batch))
        got, out = api.decode(model, cache, {k: torch.as_tensor(v) for k, v in batch.items()})
        assert out is cache  # updated in place
        assert got.dtype == torch.float32 and tuple(got.shape) == (B, 1, cfg.vocab_size)
        np.testing.assert_allclose(_np(got), _np(want), **LOGITS)
    batch = {"tokens": toks[:, S - 1:], "pos": np.full((B,), S - 1, np.int32)}
    want, _ = decode(rparams, rcache, jax.tree.map(jnp.asarray, batch))
    got, _ = api.decode(model, _port_tree(rcache, cache),
                        {k: torch.as_tensor(v) for k, v in batch.items()})
    np.testing.assert_allclose(_np(got), _np(want), **LOGITS)


# ---------------------------------------------------------------------------
# the encoder-decoder (Whisper)
# ---------------------------------------------------------------------------


def _frames(cfg, B, seed):
    return np.random.default_rng(seed).normal(
        0, 0.3, (B, cfg.encoder_frames, cfg.d_model)).astype(np.float32)


def test_encdec_encode_and_decode_train_match_reference(models):
    rcfg, rapi, rparams, cfg, api, model = models(ENCDEC)
    fj, ft = _bf16(_frames(cfg, 2, 7))
    want_m = jax.jit(ref_encdec.encode, static_argnums=0)(rcfg, rparams, fj)
    got_m = encdec.encode(cfg, model, ft)
    assert got_m.dtype == torch.bfloat16 and tuple(got_m.shape) == tuple(want_m.shape)
    # bf16 memory after two layers and a LayerNorm: the largest difference
    # within 2e-2 of the largest value (as for the VLM's hidden states)
    assert np.abs(_np(got_m) - _np(want_m)).max() <= 2e-2 * np.abs(_np(want_m)).max()
    toks = _tokens(cfg, (2, 10), 8)
    # both decoders over the same (reference) memory
    mem_j, mem_t = _bf16(_np(want_m))
    want_h = jax.jit(ref_encdec.decode_train, static_argnums=0)(
        rcfg, rparams, jnp.asarray(toks), mem_j)
    got_h = encdec.decode_train(cfg, model, torch.as_tensor(toks), mem_t)
    np.testing.assert_allclose(_np(got_h), _np(want_h), **LOGITS)
    want = ref_layers.unembed(jnp.asarray(rparams["embed"]), want_h)
    np.testing.assert_allclose(_np(encdec.logits_of(cfg, model, got_h)), _np(want), **LOGITS)


def test_encdec_cross_cache_and_decode_step_match_reference(models):
    rcfg, rapi, rparams, cfg, api, model = models(ENCDEC)
    B, S, s_max = 2, 5, 8
    mem_j, mem_t = _bf16(_np(jax.jit(ref_encdec.encode, static_argnums=0)(
        rcfg, rparams, _bf16(_frames(cfg, B, 9))[0])))
    rcross = jax.jit(ref_encdec.build_cross_cache, static_argnums=0)(rcfg, rparams, mem_j)
    cross = encdec.build_cross_cache(cfg, model, mem_t)
    for name in ("k", "v"):
        assert cross[name].dtype == torch.bfloat16
        assert tuple(cross[name].shape) == rcross[name].shape == (
            cfg.n_layers, B, cfg.n_kv_heads, cfg.encoder_frames, cfg.head_dim)
        np.testing.assert_allclose(_np(cross[name]), _np(rcross[name]), **BF16)

    specs = api.cache_specs(B, s_max)
    cache = _zeros(specs)
    for name in ("k", "v"):
        cache["layers"]["cross"][name].copy_(cross[name])
    rcache = jax.tree.map(lambda ps: jnp.zeros(ps.shape, ps.dtype), rapi.cache_specs(B, s_max),
                          is_leaf=lambda x: isinstance(x, ref_param.PSpec))
    rcache["layers"]["cross"] = rcross
    decode = jax.jit(rapi.decode)
    toks = _tokens(cfg, (B, S), 10)
    for t in range(S - 1):
        batch = {"tokens": toks[:, t:t + 1], "pos": np.full((B,), t, np.int32)}
        want, rcache = decode(rparams, rcache, jax.tree.map(jnp.asarray, batch))
        got, out = api.decode(model, cache, {k: torch.as_tensor(v) for k, v in batch.items()})
        assert out is cache and tuple(got.shape) == (B, 1, cfg.vocab_size)
        np.testing.assert_allclose(_np(got), _np(want), **LOGITS)
    # one step more from the reference's cache, carried across
    batch = {"tokens": toks[:, S - 1:], "pos": np.full((B,), S - 1, np.int32)}
    want, _ = decode(rparams, rcache, jax.tree.map(jnp.asarray, batch))
    got, _ = api.decode(model, _port_tree(rcache, cache),
                        {k: torch.as_tensor(v) for k, v in batch.items()})
    np.testing.assert_allclose(_np(got), _np(want), **LOGITS)


@pytest.mark.parametrize("biases", [0.0, 0.5])
def test_cross_attention_bias_quirk(biases, models):
    """decode_train's cross attention adds no q/k/v bias; the decode path
    (build_cross_cache, _cross_decode) adds them.  Zero biases: the two
    paths agree (the prefill-vs-forward tolerance); nonzero: they differ, in
    both packages alike, and the port equals the reference on each path."""
    rcfg, rapi, rparams, cfg, api, model = models(ENCDEC, biases)
    B, S = 2, 6
    mem_j, mem_t = _bf16(_np(jax.jit(ref_encdec.encode, static_argnums=0)(
        rcfg, rparams, _bf16(_frames(cfg, B, 11))[0])))
    toks = _tokens(cfg, (B, S), 12)

    rcache = jax.tree.map(lambda ps: jnp.zeros(ps.shape, ps.dtype), rapi.cache_specs(B, S),
                          is_leaf=lambda x: isinstance(x, ref_param.PSpec))
    rcache["layers"]["cross"] = jax.jit(ref_encdec.build_cross_cache, static_argnums=0)(
        rcfg, rparams, mem_j)
    cache = _zeros(api.cache_specs(B, S))
    for name, t in encdec.build_cross_cache(cfg, model, mem_t).items():
        cache["layers"]["cross"][name].copy_(t)
    decode = jax.jit(rapi.decode)
    want_steps, got_steps = [], []
    for t in range(S):
        batch = {"tokens": toks[:, t:t + 1], "pos": np.full((B,), t, np.int32)}
        w, rcache = decode(rparams, rcache, jax.tree.map(jnp.asarray, batch))
        g, cache = api.decode(model, cache, {k: torch.as_tensor(v) for k, v in batch.items()})
        want_steps.append(_np(w)[:, 0])
        got_steps.append(_np(g)[:, 0])
    want_steps, got_steps = np.stack(want_steps, 1), np.stack(got_steps, 1)
    want_train = _np(ref_layers.unembed(jnp.asarray(rparams["embed"]), jax.jit(
        ref_encdec.decode_train, static_argnums=0)(rcfg, rparams, jnp.asarray(toks), mem_j)))
    got_train = _np(encdec.logits_of(cfg, model, encdec.decode_train(
        cfg, model, torch.as_tensor(toks), mem_t)))
    np.testing.assert_allclose(got_steps, want_steps, **LOGITS)
    np.testing.assert_allclose(got_train, want_train, **LOGITS)
    for steps, train in [(want_steps, want_train), (got_steps, got_train)]:
        gap = np.abs(steps - train).max()
        if biases:
            assert gap > 0.1, gap
        else:
            np.testing.assert_allclose(steps, train, rtol=5e-2, atol=5e-2)


# ---------------------------------------------------------------------------
# the registry: no prefill for either family
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", [HYBRID, ENCDEC])
def test_input_specs_and_demo_batch_match_reference(arch):
    cfg, rcfg = base.smoke_config(arch), ref_base.smoke_config(arch)
    api, rapi = registry.get_model(cfg), ref_registry.get_model(rcfg)
    assert api.prefill is None and rapi.prefill is None
    for kind in ("train", "decode"):
        shape = base.ShapeConfig("s", seq_len=8, global_batch=2, kind=kind)
        got, want = api.input_specs(shape), rapi.input_specs(shape)
        assert list(got) == list(want)
        assert {k: v.shape for k, v in got.items()} == {k: v.shape for k, v in want.items()}
        gb, wb = api.demo_batch(shape), rapi.demo_batch(shape)
        for k in want:
            np.testing.assert_array_equal(gb[k], wb[k])
    if arch == ENCDEC:
        frames = api.input_specs(base.ShapeConfig("s", 8, 2, "train"))["frames"]
        assert frames == registry.InputSpec((2, cfg.encoder_frames, cfg.d_model), torch.bfloat16)


# ---------------------------------------------------------------------------
# the weight draw: each leaf cast as it is drawn
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", base.ARCH_IDS)
def test_init_params_draw_loads_the_same_state_dict(arch):
    """Every family's smoke model loads the same state_dict, bit for bit,
    from the draw that casts each bf16 leaf as it is drawn as from an all-f32
    draw of the same seed; and the leaves the draw keeps in f32 are exactly
    those the model holds in f32."""
    cfg = base.smoke_config(arch)
    api = registry.get_model(cfg)
    specs = api.param_specs()
    all_f32 = param.spec_tree_map(lambda ps: dataclasses.replace(ps, dtype=torch.float32), specs)
    new = param.init_params(specs, seed=5, device="cpu")
    old = param.init_params(all_f32, seed=5, device="cpu")
    assert any(t.dtype == torch.bfloat16 for t in param.leaves(new))
    got, want = api.load(new).state_dict(), api.load(old).state_dict()
    assert list(got) == list(want)
    for key in want:
        assert got[key].dtype == want[key].dtype, key
        assert torch.equal(got[key], want[key]), key
    f32_params = sum(t.numel() for t in want.values() if t.dtype == torch.float32)
    assert f32_params == sum(t.numel() for t in param.leaves(new) if t.dtype == torch.float32)
