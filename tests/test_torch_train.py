"""The port's training pieces vs the reference, on the CPU: the loss, the
attention backward, remat, AdamW, the schedule, the microbatch split, the
launch heuristics and the launcher.

The same numpy inputs go to both packages.  Tolerances: the blocked
attention backward within 1e-5 (f32 throughout, sums in another order);
AdamW within 1e-6 (the same f32 operations; pow and cos may differ in
the last place); ``softmax_xent`` within 1e-6; remat bit for bit (the
recompute repeats the same operations).
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs import base as ref_base  # noqa: E402
from repro.kernels.flash_attn import ops as ref_flash  # noqa: E402
from repro.launch import sharding as ref_sharding  # noqa: E402
from repro.models import layers as ref_layers  # noqa: E402
from repro.train import optimizer as ref_opt  # noqa: E402
from repro.train import train_step as ref_train_step  # noqa: E402
from repro_torch.configs import base  # noqa: E402
from repro_torch.kernels.flash_attn import ops as flash  # noqa: E402
from repro_torch.launch import sharding  # noqa: E402
from repro_torch.launch import train as launch_train  # noqa: E402
from repro_torch.models import layers, param, registry  # noqa: E402
from repro_torch.train import optimizer, train_step  # noqa: E402

TIGHT = dict(rtol=1e-6, atol=1e-6)


def _t(a, grad=False):
    return torch.tensor(np.asarray(a), requires_grad=grad)


@pytest.mark.parametrize("masked", [False, True])
def test_softmax_xent_matches_reference(masked):
    rng = np.random.default_rng(0)
    logits = (3 * rng.standard_normal((3, 7, 50))).astype(np.float32)
    labels = rng.integers(0, 50, (3, 7)).astype(np.int32)
    mask = (rng.random((3, 7)) > 0.4).astype(np.float32) if masked else None
    want = ref_layers.softmax_xent(jnp.asarray(logits), jnp.asarray(labels),
                                   None if mask is None else jnp.asarray(mask))
    got = layers.softmax_xent(_t(logits), _t(labels), None if mask is None else _t(mask))
    assert got.dtype == torch.float32 and got.shape == ()
    np.testing.assert_allclose(float(got), float(want), **TIGHT)
    bf = layers.softmax_xent(_t(logits).to(torch.bfloat16), _t(labels))
    assert bf.dtype == torch.float32  # bf16 logits are upcast first


# (B, S, T, H, Hkv, hd, causal, q_block): GQA causal S = T, full S != T,
# causal S < T and S > T, the last two with a query length that is not a
# multiple of the block
BACKWARD_CASES = [
    (2, 32, 32, 4, 2, 16, True, 8),
    (2, 24, 40, 4, 1, 8, False, 8),
    (1, 20, 36, 6, 3, 8, True, 8),
    (1, 36, 20, 2, 2, 16, True, 16),
]


@pytest.mark.parametrize("case", BACKWARD_CASES, ids=lambda c: "B{}S{}T{}H{}kv{}hd{}{}qb{}".format(
    *c[:6], "causal" if c[6] else "full", c[7]))
def test_attention_backward_blocked(case):
    """dq, dk, dv against torch autograd of ``attention_plain`` and against
    ``jax.vjp`` of the reference's attention, within 1e-5."""
    B, S, T, H, hkv, hd, causal, qb = case
    rng = np.random.default_rng(1)
    q, k, v = (rng.standard_normal(s).astype(np.float32)
               for s in [(B, S, H, hd), (B, T, hkv, hd), (B, T, hkv, hd)])
    do = rng.standard_normal((B, S, H * hd)).astype(np.float32)
    scale = 1.0 / np.sqrt(hd)
    qt, kt, vt = _t(q, True), _t(k, True), _t(v, True)
    o = flash.attention(qt, kt, vt, scale, causal=causal)
    want_t = torch.autograd.grad(o, (qt, kt, vt), _t(do))
    got = flash.attention_backward_blocked(
        _t(q), _t(k), _t(v), o.detach(), _t(do), scale, causal, q_block=qb)
    out, vjp = jax.vjp(lambda a, b, c: ref_flash.attention(a, b, c, scale, causal=causal),
                       jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    want_j = vjp(jnp.asarray(do))
    np.testing.assert_allclose(o.detach().numpy(), np.asarray(out), atol=1e-5, rtol=1e-5)
    for g, wt, wj, name in zip(got, want_t, want_j, "qkv"):
        assert g.dtype == torch.float32 and g.shape == wt.shape, name
        np.testing.assert_allclose(g.numpy(), wt.numpy(), atol=1e-5, rtol=1e-5, err_msg=name)
        np.testing.assert_allclose(g.numpy(), np.asarray(wj), atol=1e-5, rtol=1e-5,
                                   err_msg=name)


def test_attention_backward_casts_to_input_dtype():
    rng = np.random.default_rng(2)
    q, k, v = (torch.tensor(rng.standard_normal(s), dtype=torch.bfloat16)
               for s in [(1, 8, 2, 8), (1, 8, 2, 8), (1, 8, 2, 8)])
    o = flash.attention_plain(q, k, v, 0.5)
    dq, dk, dv = flash.attention_backward_blocked(q, k, v, o, torch.ones_like(o), 0.5)
    assert dq.dtype == dk.dtype == dv.dtype == torch.bfloat16


def test_attend_mla_padding_passes_the_gradient():
    """``attend`` hands MLA's q.k dim 96 and v dim 64 to ``flash.attention``
    as they are (its forward kernel takes them zero-padded to 128, each
    head's first 64 columns kept; its backward takes them unpadded): the
    gradients through it equal those of the unpadded attention."""
    rng = np.random.default_rng(3)
    B, S, H, hq, hv = 1, 12, 2, 96, 64
    q, k = (_t(rng.standard_normal((B, S, H, hq)).astype(np.float32), True) for _ in range(2))
    v = _t(rng.standard_normal((B, S, H, hv)).astype(np.float32), True)
    do = _t(rng.standard_normal((B, S, H * hv)).astype(np.float32))
    scale = 1.0 / np.sqrt(hq)
    got = torch.autograd.grad(layers.attend(q, k, v, scale, torch.float32), (q, k, v), do)
    s = torch.einsum("bshd,bthd->bhst", q, k) * scale
    s = torch.where(torch.tril(torch.ones(S, S, dtype=torch.bool)), s, flash.NEG_INF)
    o = torch.einsum("bhst,bthd->bshd", torch.softmax(s, -1), v).reshape(B, S, H * hv)
    want = torch.autograd.grad(o, (q, k, v), do)
    for g, w in zip(got, want):
        assert g.shape == w.shape
        np.testing.assert_allclose(g.numpy(), w.numpy(), atol=1e-5, rtol=1e-5)


def _grads(cfg, tree, batch):
    api = registry.get_model(cfg)
    model = api.load(tree, trainable=True)
    names, params = zip(*model.named_parameters())
    loss, metrics = api.loss(model, batch)
    return loss, metrics, dict(zip(names, torch.autograd.grad(loss, params)))


@pytest.mark.parametrize("arch", ["qwen1_5_0_5b", "moonshot_v1_16b_a3b", "falcon_mamba_7b"])
def test_remat_groups_give_equal_gradients(arch):
    """``remat_group`` 0, 1 and 2 over 4 layers: loss, aux and every
    gradient bit for bit."""
    cfg = dataclasses.replace(base.smoke_config(arch), n_layers=4)
    api = registry.get_model(cfg)
    tree = param.init_params(param.in_f32(api.param_specs()), seed=0, device="cpu")
    batch = {k: torch.as_tensor(v) for k, v in
             api.demo_batch(base.ShapeConfig("t", 16, 2, "train")).items()}
    runs = [_grads(dataclasses.replace(cfg, remat_group=g), tree, batch) for g in (0, 1, 2)]
    loss0, metrics0, grads0 = runs[0]
    for loss, metrics, grads in runs[1:]:
        assert torch.equal(loss, loss0) and torch.equal(metrics["aux"], metrics0["aux"])
        assert grads.keys() == grads0.keys()
        for name in grads0:
            assert torch.equal(grads[name], grads0[name]), name


@pytest.mark.parametrize("arch", ref_base.ARCH_IDS)
def test_trainable_load_casts_at_use(arch):
    """A trainable load keeps every leaf an f32 master that requires a
    gradient and casts at use; a served load casts once.  On the same f32
    draw both give the same loss and aux, bit for bit."""
    cfg = base.smoke_config(arch)
    api = registry.get_model(cfg)
    tree = param.init_params(param.in_f32(api.param_specs()), seed=1, device="cpu")
    assert all(t.dtype == torch.float32 for t in param.leaves(tree))
    served, trained = api.load(tree), api.load(tree, trainable=True)
    assert all(p.dtype == torch.float32 and p.requires_grad for p in trained.parameters())
    assert not any(p.requires_grad for p in served.parameters())
    assert any(p.dtype == torch.bfloat16 for p in served.parameters())
    assert served.state_dict().keys() == trained.state_dict().keys()
    batch = {k: torch.as_tensor(v) for k, v in
             api.demo_batch(base.ShapeConfig("t", 16, 2, "train")).items()}
    with torch.no_grad():
        (l_s, m_s), (l_t, m_t) = api.loss(served, batch), api.loss(trained, batch)
    assert torch.equal(l_s, l_t) and torch.equal(m_s["aux"], m_t["aux"])


def test_stacked_tree_round_trip():
    cfg = base.smoke_config("jamba_v0_1_52b")
    api = registry.get_model(cfg)
    tree = param.init_params(param.in_f32(api.param_specs()), seed=0, device="cpu")
    model = api.load(tree, trainable=True)
    flat = {k: p.detach() for k, p in model.named_parameters()}
    back = param.stacked_tree(flat)
    got, want = param.leaves(back), param.leaves(tree)
    assert len(got) == len(want) and all(torch.equal(a, b) for a, b in zip(got, want))
    slices = param.layer_slices(back, flat)
    assert all(torch.equal(slices[k], flat[k]) for k in flat)


def _opt_inputs(seed: int, big: bool):
    rng = np.random.default_rng(seed)
    shapes = {"a": (3, 4), "b": {"c": (5,), "d": (2, 2, 3)}}

    def draw(scale):
        def f(s):
            if isinstance(s, dict):
                return {k: f(v) for k, v in s.items()}
            return (scale * rng.standard_normal(s)).astype(np.float32)
        return f(shapes)

    params, grads = draw(1.0), draw(3.0 if big else 0.05)
    m, v = draw(0.01), jax.tree.map(np.abs, draw(1e-3))
    return params, grads, {"m": m, "v": v, "step": np.int32(seed)}


@pytest.mark.parametrize("big", [False, True], ids=["unclipped", "clipped"])
@pytest.mark.parametrize("step", [0, 3, 150])
def test_adamw_update_matches_reference(step, big):
    """Identical params, gradients and state: new params, m, v, the global
    norm and the learning rate within 1e-6 of the reference's."""
    params, grads, state = _opt_inputs(step, big)
    cfg = optimizer.OptConfig(lr=1e-3, warmup_steps=10, total_steps=200)
    rcfg = ref_opt.OptConfig(lr=1e-3, warmup_steps=10, total_steps=200)
    to_j = lambda t: jax.tree.map(jnp.asarray, t)  # noqa: E731
    to_t = lambda t: jax.tree.map(torch.as_tensor, t)  # noqa: E731
    wp, ws, wm = ref_opt.adamw_update(rcfg, to_j(params), to_j(grads), to_j(state))
    gp, gs, gm = optimizer.adamw_update(cfg, to_t(params), to_t(grads), to_t(state))
    assert (float(gm["grad_norm"]) > 1.0) == big
    for got, want in [(gp, wp), (gs["m"], ws["m"]), (gs["v"], ws["v"])]:
        for a, b in zip(param.leaves(got), jax.tree.leaves(want)):
            assert a.dtype == torch.float32
            np.testing.assert_allclose(a.numpy(), np.asarray(b), **TIGHT)
    assert int(gs["step"]) == int(ws["step"]) == step + 1
    for k in ("grad_norm", "lr"):
        np.testing.assert_allclose(float(gm[k]), float(wm[k]), rtol=1e-6)


def test_init_opt_state_and_schedule_match_reference():
    cfg = optimizer.OptConfig(lr=3e-4, warmup_steps=7, total_steps=40, min_lr_ratio=0.2)
    rcfg = ref_opt.OptConfig(lr=3e-4, warmup_steps=7, total_steps=40, min_lr_ratio=0.2)
    for s in [0, 1, 3, 7, 8, 20, 39, 40, 41, 100]:
        got = optimizer.schedule(cfg, torch.tensor(s, dtype=torch.int32))
        want = ref_opt.schedule(rcfg, jnp.int32(s))
        assert got.dtype == torch.float32
        np.testing.assert_allclose(float(got), float(want), rtol=1e-6, atol=1e-12)
    st = optimizer.init_opt_state({"w": torch.ones(2, 3, dtype=torch.bfloat16)})
    assert st["m"]["w"].dtype == st["v"]["w"].dtype == torch.float32
    assert st["step"].dtype == torch.int32 and int(st["step"]) == 0


def test_split_microbatches_matches_reference():
    rng = np.random.default_rng(0)
    batch = {
        "tokens": np.arange(8 * 4).reshape(8, 4),
        "positions": np.arange(3 * 8 * 4).reshape(3, 8, 4),
        "vision_embeds": rng.standard_normal((8, 5, 6)).astype(np.float32),
    }
    for n in (1, 2, 4):
        got = train_step.split_microbatches(batch, n)
        want = ref_train_step.split_microbatches(batch, n)
        for k in batch:
            np.testing.assert_array_equal(got[k], np.asarray(want[k]))
    out = train_step.split_microbatches(batch, 2)
    assert out["tokens"].shape == (2, 4, 4) and out["positions"].shape == (2, 3, 4, 4)
    np.testing.assert_array_equal(out["positions"][1], batch["positions"][:, 4:])


def test_launch_heuristics_match_reference():
    assert sharding.pick_microbatches(256, 16, 4096) == 8
    assert sharding.default_remat_group(24) == 4
    for args in [(256, 16, 4096), (32, 16, 32768), (128, 32, 32768), (4, 16, 128), (8, 1, 2048)]:
        assert sharding.pick_microbatches(*args) == ref_sharding.pick_microbatches(*args)
    for L in [1, 2, 12, 24, 28, 32, 48, 62, 64, 80]:
        assert sharding.default_remat_group(L) == ref_sharding.default_remat_group(L)


def test_launch_train_smoke_on_cpu(capsys, tmp_path):
    """The launcher trains the smoke config on the CPU, prints the
    reference's lines, and sets remat_group by the reference's rule."""
    out = launch_train.main(["--arch", "qwen1_5_0_5b", "--smoke", "--device", "cpu",
                             "--steps", "3", "--batch", "4", "--seq", "16",
                             "--microbatches", "2", "--lr", "1e-3",
                             "--ckpt-dir", str(tmp_path)])
    text = capsys.readouterr().out.splitlines()
    assert text[0] == "arch=qwen1.5-smoke devices=1 steps=3"
    assert text[1].startswith("step     1  loss ") and text[-1].startswith("done: 3 steps in ")
    assert out["steps_done"] == 3 and all(np.isfinite(loss) for _, loss in out["losses"])
    assert out["params"].cfg.remat_group == sharding.default_remat_group(2) == 2
    assert (tmp_path / "step_000000003" / "manifest.json").exists()


def test_loader_prefetches_the_reference_batches():
    from repro.data import corpus as ref_corpus
    from repro_torch.data import corpus

    got = iter(corpus.Loader(corpus.CorpusConfig(vocab_size=300, seq_len=8, global_batch=2),
                             start_step=3))
    want = iter(ref_corpus.Loader(ref_corpus.CorpusConfig(vocab_size=300, seq_len=8,
                                                          global_batch=2), start_step=3))
    for _ in range(3):
        g, w = next(got), next(want)
        assert g.keys() == w.keys()
        for k in g:
            np.testing.assert_array_equal(g[k], w[k])
