"""The port's MoE, MLA, VLM and SSM families vs the reference, on the CPU.

Smoke configs; weights from the reference's ``init_params`` carried
across with ``interop.lm_params_from_numpy``; inputs made from a seed with
numpy.  Tolerances are those of ``tests/test_torch_models.py``: one bf16
layer within 1e-2 (BF16), logits within 2e-2 (LOGITS).  Routing is
discrete: expert choices must be equal wherever the reference's gap
between consecutive top-(k+1) router probabilities exceeds 1e-4 (the two
packages' f32 router products differ by ~1e-7), and the MoE outputs are
compared on those tokens.
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs import base as ref_base  # noqa: E402
from repro.kernels.flash_attn import ref as ref_flash  # noqa: E402
from repro.models import layers as ref_layers  # noqa: E402
from repro.models import moe as ref_moe  # noqa: E402
from repro.models import param as ref_param  # noqa: E402
from repro.models import registry as ref_registry  # noqa: E402
from repro.models import ssm as ref_ssm  # noqa: E402
from repro.models import transformer as ref_transformer  # noqa: E402
from repro.serve import engine as ref_engine  # noqa: E402
from repro_torch import interop  # noqa: E402
from repro_torch.configs import base  # noqa: E402
from repro_torch.kernels.flash_attn import ops as flash  # noqa: E402
from repro_torch.models import layers, moe, param, registry, ssm, ssm_lm, transformer  # noqa: E402
from repro_torch.serve import engine  # noqa: E402

BF16 = dict(rtol=1e-2, atol=1e-2)
LOGITS = dict(rtol=2e-2, atol=2e-2)
MARGIN = 1e-4
MOE = ["llama4_scout_17b_a16e", "moonshot_v1_16b_a3b"]
FAMILIES = [*MOE, "minicpm3_4b", "qwen2_vl_7b", "falcon_mamba_7b"]
B_SERVE, S_MAX = 4, 16


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().cpu().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _bf16(a):
    """The same bf16 values in both frameworks (numpy f32 rounded once)."""
    return jnp.asarray(a).astype(jnp.bfloat16), torch.as_tensor(a).to(torch.bfloat16)


def _tokens(cfg, shape, seed):
    return np.random.default_rng(seed).integers(1, cfg.vocab_size - 1, shape).astype(np.int32)


@pytest.fixture(scope="module")
def models():
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


@pytest.fixture(scope="module")
def ref_engines(models):
    """arch -> the reference's Engine (batch B_SERVE, s_max S_MAX): its jitted
    prefill and decode, compiled once for the prefill and generate tests."""
    cache = {}

    def get(arch):
        if arch not in cache:
            rcfg, rapi, rparams, *_ = models(arch)
            cache[arch] = ref_engine.Engine(rapi, rparams, B_SERVE, S_MAX)
        return cache[arch]

    return get


# ---------------------------------------------------------------------------
# the registry, the parameter trees and the VLM's inputs
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", [a for a in base.ARCH_IDS
                                  if a not in ("jamba_v0_1_52b", "whisper_medium")])
def test_registry_builds_every_ported_arch(arch):
    for cfg in (base.get_config(arch), base.smoke_config(arch)):
        api = registry.get_model(cfg)
        ref_specs = ref_registry.get_model(
            ref_base.get_config(arch) if cfg.name == base.get_config(arch).name
            else ref_base.smoke_config(arch)).cache_specs(2, 16)
        got = api.cache_specs(2, 16)
        want = jax.tree.map(lambda ps: (tuple(ps.shape), jnp.dtype(ps.dtype).name), ref_specs,
                            is_leaf=lambda x: isinstance(x, ref_param.PSpec))
        have = param.spec_tree_map(lambda ps: (ps.shape, str(ps.dtype)[6:]), got)
        assert have == want


@pytest.mark.parametrize("arch", FAMILIES)
def test_f32_leaves_stay_f32(arch, models):
    """The leaves the reference reads without mp() keep their f32 values."""
    rcfg, rapi, rparams, cfg, api, model = models(arch)
    sd = model.state_dict()
    flat = {}
    for name, leaf in jax.tree_util.tree_leaves_with_path(rparams):
        flat[".".join(str(getattr(k, "key", k)) for k in name)] = np.asarray(leaf)
    checked = 0
    for key, t in sd.items():
        parts = key.split(".")
        if parts[0] != "layers" or parts[-1] not in param.F32_LEAVES:
            continue
        want = flat[".".join(["layers", *parts[2:]])][int(parts[1])]
        assert t.dtype == torch.float32, key
        np.testing.assert_array_equal(t.numpy(), want)
        checked += 1
    assert checked == {"minicpm3_4b": 2, "falcon_mamba_7b": 2}.get(arch, 1 if arch in MOE else 0) \
        * cfg.n_layers


def test_vlm_input_specs_and_demo_batch():
    cfg, rcfg = base.smoke_config("qwen2_vl_7b"), ref_base.smoke_config("qwen2_vl_7b")
    api, rapi = registry.get_model(cfg), ref_registry.get_model(rcfg)
    for kind in ("train", "decode"):
        shape = base.ShapeConfig("s", seq_len=16, global_batch=2, kind=kind)
        got, want = api.input_specs(shape), rapi.input_specs(shape)
        assert list(got) == list(want)
        for k in got:
            assert got[k].shape == want[k].shape
            assert str(got[k].dtype)[6:] == jnp.dtype(want[k].dtype).name
        gb, wb = api.demo_batch(shape, seed=3), rapi.demo_batch(shape, seed=3)
        assert list(gb) == list(wb)
        for k in gb:
            assert gb[k].dtype == wb[k].dtype
            np.testing.assert_array_equal(gb[k], wb[k])


# ---------------------------------------------------------------------------
# layers: M-RoPE, chunked attention, MLA
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("sections,hd", [((2, 3, 3), 16), ((16, 24, 24), 128)])
def test_mrope_three_streams(sections, hd):
    rng = np.random.default_rng(0)
    B, S = 2, 12
    x = rng.standard_normal((B, S, 3, hd)).astype(np.float32)
    pos3 = rng.integers(0, 4000, (3, B, S)).astype(np.int32)  # distinct streams
    xj, xt = _bf16(x)
    got = layers.mrope(xt, torch.as_tensor(pos3), 1e6, sections)
    want = jax.jit(ref_layers.mrope, static_argnums=(2, 3))(xj, jnp.asarray(pos3), 1e6, sections)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(_np(got), _np(want), **BF16)
    # equal streams give plain RoPE
    same = np.broadcast_to(pos3[:1], pos3.shape).copy()
    np.testing.assert_array_equal(
        _np(layers.mrope(xt, torch.as_tensor(same), 1e6, sections)),
        _np(layers.rope(xt, torch.as_tensor(same[0]), 1e6)))


@pytest.mark.parametrize("causal", [True, False])
def test_chunked_attention_qk_dim_differs_from_v(causal):
    rng = np.random.default_rng(1)
    B, S, H, hkv, hq, hv = 2, 32, 4, 2, 24, 16
    q, k, v = (rng.standard_normal(s).astype(np.float32)
               for s in [(B, S, H, hq), (B, S, hkv, hq), (B, S, hkv, hv)])
    (qj, qt), (kj, kt), (vj, vt) = _bf16(q), _bf16(k), _bf16(v)
    scale = 1.0 / np.sqrt(hq)
    got = layers.chunked_attention(qt, kt, vt, scale, causal=causal, q_block=8,
                                   out_dtype=torch.float32)
    want = jax.jit(ref_layers.chunked_attention, static_argnames=("causal", "q_block"))(
        qj, kj, vj, jnp.float32(scale), causal=causal, q_block=8)
    assert tuple(got.shape) == (B, S, H * hv)
    np.testing.assert_allclose(_np(got), _np(want), **BF16)
    # against the flash kernel's plain version, v zero-padded to q's dim
    plain = flash.attention_plain(qt, kt, torch.nn.functional.pad(vt, (0, hq - hv)), scale,
                                  causal=causal)
    plain = plain.reshape(B, S, H, hq)[..., :hv].reshape(B, S, H * hv)
    np.testing.assert_allclose(_np(got), _np(plain), **BF16)
    # the padded path below the threshold, and the chunked one above it
    near = layers.attend(qt, kt, vt, scale, torch.float32, causal=causal)
    np.testing.assert_allclose(_np(near), _np(plain), rtol=1e-6, atol=1e-6)
    ref_plain = ref_flash.attention(qj, kj, jnp.pad(vj, ((0, 0),) * 3 + ((0, hq - hv),)),
                                    scale, causal=causal)
    np.testing.assert_allclose(_np(near), _np(ref_plain).reshape(B, S, H, hq)[..., :hv]
                               .reshape(B, S, H * hv), **BF16)


def test_attend_takes_the_chunked_path_above_the_threshold(monkeypatch):
    rng = np.random.default_rng(2)
    q, k, v = (torch.as_tensor(rng.standard_normal((1, 16, 2, 8)).astype(np.float32))
               for _ in range(3))
    calls = []
    real = layers.chunked_attention
    monkeypatch.setattr(layers, "chunked_attention", lambda *a, **kw: calls.append(1) or real(
        *a, **kw))
    below = layers.attend(q, k, v, 0.3, torch.float32)
    assert not calls
    monkeypatch.setattr(layers, "ATTN_CHUNK_THRESHOLD", 8)
    monkeypatch.setattr(layers, "ATTN_Q_BLOCK", 4)
    above = layers.attend(q, k, v, 0.3, torch.float32)
    assert calls == [1]
    np.testing.assert_allclose(_np(above), _np(below), rtol=1e-5, atol=1e-6)


def _layer0(rparams):
    return jax.tree.map(lambda a: a[0], rparams["layers"])


def test_mla_train_and_decode(models):
    rcfg, rapi, rparams, cfg, api, model = models("minicpm3_4b")
    rp = _layer0(rparams)["attn"]
    tp = model.layers[0].attn
    rng = np.random.default_rng(4)
    B, S = 2, 12
    x = rng.standard_normal((B, S, cfg.d_model)).astype(np.float32)
    xj, xt = _bf16(x)
    pos = np.broadcast_to(np.arange(S, dtype=np.int32), (B, S))
    got = layers.mla_train(cfg, tp, xt, torch.as_tensor(pos))
    want = jax.jit(ref_layers.mla_train, static_argnums=0)(rcfg, rp, xj, jnp.asarray(pos))
    np.testing.assert_allclose(_np(got), _np(want), **LOGITS)

    s_max = 16
    c0 = rng.standard_normal((B, s_max, cfg.kv_lora_rank)).astype(np.float32)
    r0 = rng.standard_normal((B, s_max, cfg.qk_rope_dim)).astype(np.float32)
    (cj, ct), (rj, rt) = _bf16(c0), _bf16(r0)
    x1j, x1t = _bf16(x[:, :1])
    for p_ in (7, 40):  # a write inside the cache, and one clamped to its end
        at = np.full((B,), p_, np.int32)
        want, wcache = jax.jit(ref_layers.mla_decode, static_argnums=0)(
            rcfg, rp, x1j, {"c_kv": cj, "k_rope": rj}, jnp.asarray(at))
        got, gcache = layers.mla_decode(cfg, tp, x1t, {"c_kv": ct.clone(), "k_rope": rt.clone()},
                                        torch.as_tensor(at))
        np.testing.assert_allclose(_np(got), _np(want), **BF16)
        for name in ("c_kv", "k_rope"):
            np.testing.assert_allclose(_np(gcache[name]), _np(wcache[name]), **BF16)


# ---------------------------------------------------------------------------
# MoE routing and FFN
# ---------------------------------------------------------------------------


def _ref_routing(rcfg, router, x, group):
    """The reference's routing (repro/models/moe.py:63-76) on x (T, D):
    experts (G, g, K), sorted-probability margins (G, g) and kept mask
    (choice-major queues, in numpy on the reference's experts)."""
    E, K = rcfg.n_experts, rcfg.experts_per_token
    top, idx = jax.jit(lambda r, xt: jax.lax.top_k(jax.nn.softmax(
        jnp.einsum("gtd,de->gte", xt.astype(jnp.float32), r), axis=-1), K + 1))(
        router, x.reshape(-1, group, x.shape[-1]))
    top, idx = np.asarray(top), np.asarray(idx)[..., :K]
    margin = (top[..., :-1] - top[..., 1:]).min(axis=-1)
    G, g = idx.shape[:2]
    within = np.zeros_like(idx)
    for grp in range(G):
        filled = np.zeros(E, int)
        for k in range(K):  # choice-major: every token's k-th choice, in token order
            for t in range(g):
                within[grp, t, k] = filled[idx[grp, t, k]]
                filled[idx[grp, t, k]] += 1
    return idx, margin, within < ref_moe._capacity(group, rcfg)


@pytest.mark.parametrize("arch,change,group", [
    ("llama4_scout_17b_a16e", {}, 512),  # K = 1: the raw gate
    ("moonshot_v1_16b_a3b", {}, 512),  # K = 2: renormalised gates
    ("moonshot_v1_16b_a3b", {}, 16),  # two groups of 16
    ("moonshot_v1_16b_a3b", {"n_shared_experts": 1}, 512),
])
def test_moe_ffn_matches_reference(arch, change, group, models):
    if change:  # a variant of the smoke config: its FFN's weights alone
        rcfg = dataclasses.replace(ref_base.smoke_config(arch), **change)
        cfg = dataclasses.replace(base.smoke_config(arch), **change)
        rp = jax.jit(lambda: ref_param.init_params(ref_moe.moe_specs(rcfg), seed=0))()
        tp = param.layer_group({k: torch.as_tensor(np.asarray(v))[None] for k, v in rp.items()},
                               0)
    else:
        rcfg, _, rparams, cfg, _, model = models(arch)
        rp, tp = _layer0(rparams)["ffn"], model.layers[0].ffn
    assert tp["router"].dtype == torch.float32 and tp["w_in"].dtype == torch.bfloat16
    rng = np.random.default_rng(6)
    B, S = 2, 16
    # a shared direction in every token crowds one expert past its capacity
    x = (rng.standard_normal((B, S, cfg.d_model)) + 3 * rng.standard_normal(cfg.d_model))
    x = x.astype(np.float32)
    xj, xt = _bf16(x)
    want, waux = jax.jit(ref_moe.moe_ffn, static_argnums=0, static_argnames="group_size")(
        rcfg, rp, xj, group_size=group)
    got, gaux = moe.moe_ffn(cfg, tp, xt, group_size=group)
    idx, margin, kept = _ref_routing(rcfg, jnp.asarray(rp["router"]),
                                     xj.reshape(B * S, -1), min(group, B * S))
    assert not kept.all(), "the reference drops no token: the capacity is not exercised"
    _, gidx, ggate, gwithin = moe.route(cfg, tp["router"], xt.reshape(-1, min(group, B * S),
                                                                      cfg.d_model))
    clear = margin > MARGIN
    assert clear.mean() > 0.9
    np.testing.assert_array_equal(gidx.numpy()[clear], idx[clear])
    # every token routes the same, so the queues and the drops are the same
    if clear.all():
        np.testing.assert_array_equal((gwithin < moe._capacity(min(group, B * S), cfg)).numpy(),
                                      kept)
        np.testing.assert_array_equal((ggate > 0).numpy(), kept)
    rows = clear.reshape(B, S)
    np.testing.assert_allclose(_np(got)[rows], _np(want)[rows], **BF16)
    np.testing.assert_allclose(float(gaux), float(waux), rtol=0, atol=1e-6)


def test_top_k_puts_the_lower_index_first_on_ties():
    probs = torch.tensor([[0.1, 0.3, 0.3, 0.3], [0.25, 0.25, 0.25, 0.25]])
    vals, idx = moe.top_k(probs, 3)
    want_v, want_i = jax.lax.top_k(jnp.asarray(probs.numpy()), 3)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(want_i))
    np.testing.assert_array_equal(vals.numpy(), np.asarray(want_v))


# ---------------------------------------------------------------------------
# SSM
# ---------------------------------------------------------------------------


def test_ssm_forward_and_decode(models):
    rcfg, rapi, rparams, cfg, api, model = models("falcon_mamba_7b")
    rp = _layer0(rparams)["mixer"]
    tp = model.layers[0].mixer
    rng = np.random.default_rng(7)
    B, S = 2, 20
    x = rng.standard_normal((B, S, cfg.d_model)).astype(np.float32)
    xj, xt = _bf16(x)
    # 2.5 chunks of 8 in the port; the reference's own call takes one chunk of 20
    got = ssm.ssm_forward(cfg, tp, xt, chunk=8)
    want = jax.jit(ref_ssm.ssm_forward, static_argnums=0, static_argnames="chunk")(
        rcfg, rp, xj, chunk=4)
    np.testing.assert_allclose(_np(got), _np(want), **BF16)
    np.testing.assert_allclose(_np(ssm.ssm_forward(cfg, tp, xt)), _np(got), **BF16)

    conv0 = rng.standard_normal((B, cfg.ssm_conv - 1, cfg.d_inner)).astype(np.float32)
    h0 = rng.standard_normal((B, cfg.d_inner, cfg.ssm_state)).astype(np.float32)
    (cj, ct), x1 = _bf16(conv0), _bf16(x[:, :1])
    want, wcache = jax.jit(ref_ssm.ssm_decode, static_argnums=0)(
        rcfg, rp, x1[0], {"conv": cj, "h": jnp.asarray(h0)})
    cache = {"conv": ct.clone(), "h": torch.as_tensor(h0).clone()}
    got, gcache = ssm.ssm_decode(cfg, tp, x1[1], cache)
    assert gcache["h"] is cache["h"] and gcache["h"].dtype == torch.float32
    assert gcache["conv"].dtype == torch.bfloat16
    np.testing.assert_allclose(_np(got), _np(want), **BF16)
    np.testing.assert_allclose(_np(gcache["conv"]), _np(wcache["conv"]), **BF16)
    np.testing.assert_allclose(_np(gcache["h"]), _np(wcache["h"]), **BF16)


# ---------------------------------------------------------------------------
# the models: forward, prefill, decode, serving
# ---------------------------------------------------------------------------


def test_vlm_forward_train_with_vision(models):
    """Projected patches at their positions, three distinct position streams."""
    rcfg, rapi, rparams, cfg, api, model = models("qwen2_vl_7b")
    rng = np.random.default_rng(8)
    B, S, P = 2, 16, cfg.vision_patches
    toks = _tokens(cfg, (B, S), 8)
    vis = rng.normal(0, 0.3, (B, P, cfg.vision_dim)).astype(np.float32)
    vpos = np.stack([np.sort(rng.choice(S, P, replace=False)) for _ in range(B)]).astype(np.int32)
    pos3 = np.stack([np.arange(S), np.arange(S) // 4, np.arange(S) % 4])[:, None, :]
    pos3 = np.broadcast_to(pos3, (3, B, S)).astype(np.int32).copy()
    want_h, _ = jax.jit(ref_transformer.forward_train, static_argnums=0)(
        rcfg, rparams, jnp.asarray(toks), jnp.asarray(pos3),
        {"vision_embeds": jnp.asarray(vis), "vision_pos": jnp.asarray(vpos)})
    got_h, aux = transformer.forward_train(
        cfg, model, torch.as_tensor(toks), torch.as_tensor(pos3),
        {"vision_embeds": torch.as_tensor(vis), "vision_pos": torch.as_tensor(vpos)})
    assert float(aux) == 0.0
    # bf16 hidden states after two layers: the largest difference within 2e-2 of the largest value
    assert np.abs(_np(got_h) - _np(want_h)).max() <= 2e-2 * np.abs(_np(want_h)).max()
    got = transformer.logits_of(cfg, model, got_h)
    want = ref_transformer.logits_of(rcfg, rparams, want_h)
    np.testing.assert_allclose(_np(got), _np(want), **LOGITS)
    # the patches changed the result
    plain, _ = transformer.forward_train(cfg, model, torch.as_tensor(toks), torch.as_tensor(pos3))
    assert np.abs(_np(plain) - _np(got_h)).max() > 0.5


@pytest.mark.parametrize("arch", FAMILIES)
def test_prefill_and_decode_match_reference(arch, models, ref_engines):
    rcfg, rapi, rparams, cfg, api, model = models(arch)
    ref = ref_engines(arch)
    B, S = B_SERVE, 8
    toks = _tokens(cfg, (B, S), 3)
    want, rcache = ref._prefill(rparams, jnp.asarray(toks))
    got, cache = api.prefill(model, torch.as_tensor(toks), S_MAX)
    assert tuple(got.shape) == (B, 1, cfg.vocab_size) and got.dtype == torch.float32
    np.testing.assert_allclose(_np(got), _np(want), **LOGITS)
    for name, leaf in cache["layers"].items():
        w = _np(rcache["layers"][name])
        assert tuple(leaf.shape) == w.shape
        assert str(leaf.dtype)[6:] == jnp.dtype(rcache["layers"][name].dtype).name
        # layer 0 sees the same inputs (the MLA prefill cache: c_kv, k_rope)
        np.testing.assert_allclose(_np(leaf)[0], w[0], **(BF16 if name != "h" else LOGITS))
    nxt = np.asarray(jnp.argmax(want[:, -1], axis=-1)).astype(np.int32)
    for t in range(2):  # teacher-forced with the reference's greedy tokens
        batch = {"tokens": nxt[:, None], "pos": np.full((B,), S + t, np.int32)}
        want, rcache = ref._decode(rparams, rcache, jax.tree.map(jnp.asarray, batch))
        got, cache = api.decode(model, cache, {k: torch.as_tensor(v) for k, v in batch.items()})
        np.testing.assert_allclose(_np(got), _np(want), **LOGITS)
        nxt = np.asarray(jnp.argmax(want[:, 0], axis=-1)).astype(np.int32)


def _forward_logits(arch, cfg, model, toks):
    if arch == "falcon_mamba_7b":
        return ssm_lm.logits_of(cfg, model, ssm_lm.forward_train(cfg, model, toks))
    hidden, _ = transformer.forward_train(cfg, model, toks, transformer.make_positions(cfg, toks))
    return transformer.logits_of(cfg, model, hidden)


@pytest.mark.parametrize("arch", ["minicpm3_4b", "qwen2_vl_7b", "falcon_mamba_7b"])
def test_prefill_decode_consistency(arch, models):
    """Greedy continuation via prefill+decode == teacher-forced forward (the
    reference's own check, on the port).  Not for MoE: its capacity follows
    the group's token count, so a decode step of B tokens drops other
    choices than the forward over B * S does (the reference's check leaves
    MoE out too)."""
    rcfg, rapi, rparams, cfg, api, model = models(arch)
    B, S, s_max = 2, 8, 16
    toks = torch.as_tensor(_tokens(cfg, (B, S), 0))
    logits_p, cache = api.prefill(model, toks, s_max)
    np.testing.assert_allclose(_np(logits_p[:, -1]),
                               _np(_forward_logits(arch, cfg, model, toks)[:, -1]), **LOGITS)
    nxt = torch.argmax(logits_p[:, -1, :], dim=-1).to(torch.int32)
    logits_d, _ = api.decode(
        model, cache, {"tokens": nxt[:, None], "pos": torch.full((B,), S, dtype=torch.int32)})
    toks2 = torch.cat([toks, nxt[:, None]], dim=1)
    np.testing.assert_allclose(_np(logits_d[:, 0]),
                               _np(_forward_logits(arch, cfg, model, toks2)[:, -1]),
                               rtol=5e-2, atol=5e-2)


def test_forward_train_aux_sums_the_layers(models):
    """The router sees the attention's output, which differs between the
    packages by bf16 rounding (``test_moe_ffn_matches_reference`` holds the
    aux within 1e-6 on one input): the sum within 1e-2 relative."""
    rcfg, rapi, rparams, cfg, api, model = models("moonshot_v1_16b_a3b")
    toks = _tokens(cfg, (2, 16), 9)
    pos = np.broadcast_to(np.arange(16, dtype=np.int32), (2, 16))
    _, want = jax.jit(ref_transformer.forward_train, static_argnums=0)(
        rcfg, rparams, jnp.asarray(toks), jnp.asarray(pos))
    _, got = transformer.forward_train(cfg, model, torch.as_tensor(toks), torch.as_tensor(pos))
    assert float(want) > 2 * 0.9  # each layer's aux is about K = 2 at uniform routing
    np.testing.assert_allclose(float(got), float(want), rtol=1e-2)


@pytest.mark.parametrize("arch", FAMILIES)
def test_generate_matches_reference(arch, models, ref_engines):
    """Engine.generate: tokens equal until the first step whose reference
    top-1/top-2 margin is within the logits tolerance."""
    rcfg, rapi, rparams, cfg, api, model = models(arch)
    ref = ref_engines(arch)
    B, S, max_new = B_SERVE, 8, 4
    prompts = list(_tokens(cfg, (3, S), 5))  # a short group, padded
    want = ref.generate(prompts, max_new=max_new)
    got = engine.Engine(api, model, B, S_MAX, device="cpu").generate(prompts, max_new=max_new)
    assert [len(g) for g in got] == [max_new] * len(prompts)
    # the reference's margins along its own greedy path
    toks = np.stack(prompts + [prompts[-1]])
    logits, cache = ref._prefill(rparams, jnp.asarray(toks))
    compared = 0
    for t in range(max_new):
        last = np.asarray(logits[:, -1, :], np.float32)
        top2 = np.sort(last, axis=-1)[:, -2:]
        cur = last.argmax(-1).astype(np.int32)
        for b in range(len(prompts)):
            if got[b][:t] == want[b][:t]:
                if top2[b, 1] - top2[b, 0] > LOGITS["atol"]:
                    assert got[b][t] == want[b][t], (b, t, got[b], want[b])
                    compared += 1
        logits, cache = ref._decode(rparams, cache, {
            "tokens": jnp.asarray(cur[:, None]), "pos": jnp.full((B,), S + t, jnp.int32)})
    assert compared >= 1
