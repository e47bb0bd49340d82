"""The port's LM stack (configs, params, layers, dense decoder) vs the reference.

Weights come from the reference's ``init_params`` and are carried across
with ``interop.lm_params_from_numpy``; inputs are made from a seed with
numpy.  Tolerances: single bf16 layers within 1e-2 (one bf16 rounding
step, 2^-8 relative, taken in another order); logits within 2e-2, the
reference's own prefill-vs-forward tolerance
(``tests/test_models_smoke.py``).  The port's prefill keeps attention
probabilities in f32 (the flash kernel's plain version), where the
reference's fused path rounds them to bf16 before the PV product.
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs import base as ref_base  # noqa: E402
from repro.models import layers as ref_layers  # noqa: E402
from repro.models import param as ref_param  # noqa: E402
from repro.models import registry as ref_registry  # noqa: E402
from repro_torch import interop  # noqa: E402
from repro_torch.configs import base  # noqa: E402
from repro_torch.models import layers, param, registry, transformer  # noqa: E402

DENSE = ["yi_6b", "qwen1_5_0_5b", "qwen2_72b"]
DECODE_ONLY = ["jamba_v0_1_52b", "whisper_medium"]  # the hybrid and encdec: no prefill
BF16 = dict(rtol=1e-2, atol=1e-2)
LOGITS = dict(rtol=2e-2, atol=2e-2)


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().cpu().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _bf16(a):
    """The same bf16 values in both frameworks (numpy f32 rounded once)."""
    return jnp.asarray(a).astype(jnp.bfloat16), torch.as_tensor(a).to(torch.bfloat16)


def _torch_tree(tree):
    return jax.tree.map(lambda a: torch.as_tensor(np.asarray(a)), tree)


@pytest.fixture(scope="module")
def dense_models():
    """arch -> (ref cfg, ref api, ref params, port cfg, port api, port model)."""
    cache = {}

    def get(arch):
        if arch not in cache:
            rcfg = ref_base.smoke_config(arch)
            rapi = ref_registry.get_model(rcfg)
            rparams = jax.jit(lambda: ref_param.init_params(rapi.param_specs(), seed=0))()
            cfg = base.smoke_config(arch)
            model = interop.lm_params_from_numpy(
                cfg, jax.tree.map(np.asarray, rparams), device="cpu")
            cache[arch] = (rcfg, rapi, rparams, cfg, registry.get_model(cfg), model)
        return cache[arch]

    return get


# ---------------------------------------------------------------------------
# configs and parameter declarations
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("which", ["get_config", "smoke_config"])
@pytest.mark.parametrize("arch", ref_base.ARCH_IDS)
def test_configs_equal_reference(arch, which):
    assert base.ARCH_IDS == ref_base.ARCH_IDS
    got = getattr(base, which)(arch)
    want = getattr(ref_base, which)(arch)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert got.head_dim == want.head_dim and got.family == want.family


def _flat(tree, prefix=""):
    if not isinstance(tree, dict):
        return {prefix: tree}
    out = {}
    for k, v in tree.items():
        out.update(_flat(v, f"{prefix}{k}."))
    return out


@pytest.mark.parametrize("arch", ref_base.ARCH_IDS)
def test_param_count_full_configs(arch):
    """The port's count of the reference's declaration equals the reference's,
    and for every family the port declares the same tree itself (shapes,
    init laws, axis names)."""
    ref_specs = ref_registry.get_model(ref_base.get_config(arch)).param_specs()
    want = ref_param.param_count(ref_specs)
    carried = jax.tree.map(
        lambda ps: param.PSpec(tuple(ps.shape), tuple(ps.spec), ps.init, ps.scale),
        ref_specs, is_leaf=lambda x: isinstance(x, ref_param.PSpec),
    )
    assert param.param_count(carried) == want
    cfg = base.get_config(arch)
    specs = registry.get_model(cfg).param_specs()
    assert param.param_count(specs) == want
    got, ref = _flat(specs), _flat(carried)
    assert sorted(got) == sorted(ref)
    for path, ps in got.items():
        r = ref[path]
        assert (ps.shape, ps.init, ps.scale) == (r.shape, r.init, r.scale), path
        assert ps.spec == tuple(e if not isinstance(e, list) else tuple(e) for e in r.spec), path


def test_init_params_laws_and_determinism():
    specs = {
        "w": param.PSpec((256, 512)),
        "emb": param.PSpec((300, 64), init="embed", scale=0.02),
        "z": param.PSpec((7,), init="zeros"),
        "o": param.PSpec((5,), init="ones"),
        "stk": param.stack(3, {"a": param.PSpec((64, 32))}),
    }
    a = param.init_params(specs, seed=3, device="cpu")
    b = param.init_params(specs, seed=3, device="cpu")
    c = param.init_params(specs, seed=4, device="cpu")
    for (ka, va), (kb, vb) in zip(_flat(a).items(), _flat(b).items()):
        assert ka == kb and torch.equal(va, vb)
    assert not torch.equal(a["w"], c["w"])
    assert tuple(a["stk"]["a"].shape) == (3, 64, 32)
    assert abs(a["w"].std().item() - 1 / np.sqrt(256)) < 0.05 / np.sqrt(256)
    assert abs(a["emb"].std().item() - 0.02) < 0.002
    assert torch.equal(a["z"], torch.zeros(7)) and torch.equal(a["o"], torch.ones(5))
    # every leaf has its own generator: equal shapes do not give equal draws
    two = param.init_params({"x": param.PSpec((64, 64)), "y": param.PSpec((64, 64))}, seed=0,
                            device="cpu")
    assert not torch.equal(two["x"], two["y"])


def test_init_params_default_device_needs_a_gpu(monkeypatch):
    """device=None means CUDA, as at every other entry point: without a GPU it raises."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    specs = {"w": param.PSpec((4, 8))}
    with pytest.raises(RuntimeError, match="device='cpu'"):
        param.init_params(specs, seed=0)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        param.init_params(specs, seed=0, device=None)
    assert param.init_params(specs, seed=0, device="cpu")["w"].device.type == "cpu"


def test_state_dict_keys_name_reference_leaves(dense_models):
    rcfg, rapi, rparams, cfg, api, model = dense_models("qwen1_5_0_5b")
    leaves = _flat(jax.tree.map(np.asarray, rparams))
    sd = model.state_dict()
    expected = set()
    for path in leaves:
        parts = path.rstrip(".").split(".")
        if parts[0] == "layers":
            expected |= {".".join(["layers", str(i), *parts[1:]]) for i in range(cfg.n_layers)}
        else:
            expected.add(".".join(parts))
    assert set(sd) == expected
    np.testing.assert_array_equal(
        sd["layers.1.attn.wq"].float().numpy(),
        leaves["layers.attn.wq."][1].astype(jnp.bfloat16).astype(np.float32),
    )
    assert sd["layers.0.attn.wq"].dtype == torch.bfloat16 and sd["embed"].dtype == torch.float32


@pytest.mark.parametrize("arch", DECODE_ONLY)
def test_unported_variants_raise(arch):
    """The hybrid and encdec families have no prefill, as in the reference:
    ``prefill`` is None and ``Engine`` refuses them."""
    from repro_torch.serve import engine

    for which in ("get_config", "smoke_config"):
        api = registry.get_model(getattr(base, which)(arch))
        assert api.prefill is None
        assert ref_registry.get_model(getattr(ref_base, which)(arch)).prefill is None
    with pytest.raises(AssertionError, match=f"{api.cfg.family} has no prefill"):
        engine.Engine(api, api.load(param.init_params(api.param_specs(), device="cpu")),
                      batch=2, s_max=16, device="cpu")


def test_input_specs_and_demo_batch_match_reference():
    api = registry.get_model(base.smoke_config("yi_6b"))
    shape = base.ShapeConfig("s", seq_len=8, global_batch=2, kind="train")
    ref_api = ref_registry.get_model(ref_base.smoke_config("yi_6b"))
    for kind in ("train", "decode"):
        s = dataclasses.replace(shape, kind=kind)
        got, want = api.input_specs(s), ref_api.input_specs(s)
        assert {k: v.shape for k, v in got.items()} == {k: v.shape for k, v in want.items()}
        for k, v in api.demo_batch(s).items():
            np.testing.assert_array_equal(v, ref_api.demo_batch(s)[k])


# ---------------------------------------------------------------------------
# layers vs the reference
# ---------------------------------------------------------------------------


def test_rmsnorm_and_rope():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 8, 4, 16)).astype(np.float32)
    scale = (1 + 0.1 * rng.standard_normal(16)).astype(np.float32)
    xj, xt = _bf16(x)
    got = layers.rmsnorm(torch.as_tensor(scale), xt, 1e-6)
    want = jax.jit(ref_layers.rmsnorm, static_argnums=2)(jnp.asarray(scale), xj, 1e-6)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(_np(got), _np(want), **BF16)
    pos = np.broadcast_to(np.arange(100, 108, dtype=np.int32), (2, 8))
    for theta in (1e4, 5e6):
        got = layers.rope(xt, torch.as_tensor(pos), theta)
        want = jax.jit(ref_layers.rope, static_argnums=2)(xj, jnp.asarray(pos), theta)
        np.testing.assert_allclose(_np(got), _np(want), **BF16)
    np.testing.assert_allclose(
        layers._rope_freqs(16, 5e6).numpy(), np.asarray(ref_layers._rope_freqs(16, 5e6)),
        rtol=1e-6)


@pytest.mark.parametrize("arch", DENSE)
def test_qkv_mlp_and_decode_attention(arch, dense_models):
    rcfg, rapi, rparams, cfg, api, model = dense_models(arch)
    rng = np.random.default_rng(1)
    rp = jax.tree.map(lambda a: a[0], rparams["layers"])  # layer 0
    tp = _torch_tree(rp)
    x = rng.standard_normal((2, 8, cfg.d_model)).astype(np.float32)
    xj, xt = _bf16(x)
    ref_qkv = jax.jit(ref_layers._qkv, static_argnums=0)
    for g, w in zip(layers._qkv(cfg, tp["attn"], xt), ref_qkv(rcfg, rp["attn"], xj)):
        assert tuple(g.shape) == w.shape
        np.testing.assert_allclose(_np(g), _np(w), **BF16)
    np.testing.assert_allclose(
        _np(layers.mlp(cfg, tp["ffn"], xt)),
        _np(jax.jit(ref_layers.mlp, static_argnums=0)(rcfg, rp["ffn"], xj)), **BF16)

    B, S = 2, 16
    k0 = rng.standard_normal((B, cfg.n_kv_heads, S, cfg.head_dim)).astype(np.float32)
    v0 = rng.standard_normal((B, cfg.n_kv_heads, S, cfg.head_dim)).astype(np.float32)
    kj, kt = _bf16(k0)
    vj, vt = _bf16(v0)
    x1 = x[:, :1]
    x1j, x1t = _bf16(x1)
    pos = np.full((B,), 5, np.int32)
    want, wcache = jax.jit(ref_layers.attention_decode, static_argnums=0)(
        rcfg, rp["attn"], x1j, {"k": kj, "v": vj}, jnp.asarray(pos))
    got, gcache = layers.attention_decode(
        cfg, tp["attn"], x1t, {"k": kt, "v": vt}, torch.as_tensor(pos))
    assert gcache["k"] is kt  # written in place
    np.testing.assert_allclose(_np(got), _np(want), **BF16)
    for name in ("k", "v"):
        np.testing.assert_allclose(_np(gcache[name]), _np(wcache[name]), **BF16)


@pytest.mark.parametrize("causal", [True, False])
def test_attention_train_matches_reference(causal, dense_models):
    rcfg, rapi, rparams, cfg, api, model = dense_models("qwen2_72b")
    rp = jax.tree.map(lambda a: a[1], rparams["layers"])["attn"]
    x = np.random.default_rng(2).standard_normal((2, 24, cfg.d_model)).astype(np.float32)
    xj, xt = _bf16(x)
    pos = np.broadcast_to(np.arange(24, dtype=np.int32), (2, 24))
    got = layers.attention_train(cfg, _torch_tree(rp), xt, torch.as_tensor(pos), causal=causal)
    want = jax.jit(ref_layers.attention_train, static_argnums=0, static_argnames="causal")(
        rcfg, rp, xj, jnp.asarray(pos), causal=causal)
    np.testing.assert_allclose(_np(got), _np(want), **LOGITS)


# ---------------------------------------------------------------------------
# the dense decoder: prefill and decode vs the reference, and vs its own forward
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", DENSE)
def test_prefill_and_decode_match_reference(arch, dense_models):
    rcfg, rapi, rparams, cfg, api, model = dense_models(arch)
    B, S, s_max = 2, 8, 16
    toks = np.random.default_rng(3).integers(1, cfg.vocab_size - 1, (B, S)).astype(np.int32)
    want, rcache = jax.jit(lambda p, t: rapi.prefill(p, t, s_max))(rparams, jnp.asarray(toks))
    got, cache = api.prefill(model, torch.as_tensor(toks), s_max)
    assert tuple(got.shape) == (B, 1, cfg.vocab_size) and got.dtype == torch.float32
    np.testing.assert_allclose(_np(got), _np(want), **LOGITS)
    for name in ("k", "v"):
        gk, wk = _np(cache["layers"][name]), _np(rcache["layers"][name])
        assert gk.shape == wk.shape
        # layer 0 sees the same inputs; later layers follow an attention
        # whose probabilities the reference rounds to bf16: the reference's
        # decode-vs-forward tolerance
        np.testing.assert_allclose(gk[0], wk[0], **BF16)
        np.testing.assert_allclose(gk, wk, rtol=5e-2, atol=5e-2)

    decode = jax.jit(rapi.decode)
    nxt = np.asarray(jnp.argmax(want[:, -1], axis=-1)).astype(np.int32)
    for t in range(2):  # teacher-forced with the reference's greedy tokens
        batch = {"tokens": nxt[:, None], "pos": np.full((B,), S + t, np.int32)}
        want, rcache = decode(rparams, rcache, jax.tree.map(jnp.asarray, batch))
        got, cache = api.decode(model, cache, {k: torch.as_tensor(v) for k, v in batch.items()})
        np.testing.assert_allclose(_np(got), _np(want), **LOGITS)
        nxt = np.asarray(jnp.argmax(want[:, 0], axis=-1)).astype(np.int32)


@pytest.mark.parametrize("arch", DENSE)
def test_prefill_decode_consistency(arch, dense_models):
    """Greedy continuation via prefill+decode == teacher-forced forward (the
    reference's own check, on the port)."""
    rcfg, rapi, rparams, cfg, api, model = dense_models(arch)
    B, S, s_max = 2, 8, 16
    toks = torch.as_tensor(
        np.random.default_rng(0).integers(1, cfg.vocab_size - 1, (B, S)).astype(np.int32))
    logits_p, cache = api.prefill(model, toks, s_max)
    hidden, aux = transformer.forward_train(cfg, model, toks, transformer.make_positions(cfg, toks))
    assert float(aux) == 0.0
    logits_t = transformer.logits_of(cfg, model, hidden)
    np.testing.assert_allclose(_np(logits_p[:, -1]), _np(logits_t[:, -1]), **LOGITS)
    nxt = torch.argmax(logits_p[:, -1, :], dim=-1).to(torch.int32)
    logits_d, _ = api.decode(
        model, cache, {"tokens": nxt[:, None], "pos": torch.full((B,), S, dtype=torch.int32)})
    toks2 = torch.cat([toks, nxt[:, None]], dim=1)
    hidden2, _ = transformer.forward_train(cfg, model, toks2, transformer.make_positions(cfg, toks2))
    logits_t2 = transformer.logits_of(cfg, model, hidden2)
    np.testing.assert_allclose(_np(logits_d[:, 0]), _np(logits_t2[:, -1]), rtol=5e-2, atol=5e-2)
