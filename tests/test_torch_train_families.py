"""``ModelAPI.loss`` and every leaf's gradient vs ``jax.value_and_grad`` of
the reference's loss, for each architecture's smoke config, on the CPU.

The reference's seed-0 weights are carried across with
``interop.train_state_from_numpy`` (f32 masters, cast at use as the
reference casts); the inputs are ``demo_batch`` of one train shape, the
same numpy arrays for both.  Tolerances are the port's LM ones
(``tests/test_torch_models_families.py``): the loss, xent and aux within
LOGITS, and each gradient leaf within GRAD_REL of its largest reference
entry (max |d| / max |ref|), as well as element by element within
LOGITS.  The scaled bound matters: most projection gradients of a smoke
model are a few 1e-3, below LOGITS' absolute floor.

GRAD_REL is bf16's own spread, measured: the reference's bf16 gradients
differ from its gradients with f32 compute by up to 0.036 of a leaf's
largest entry (minicpm3_4b's ``q_down``), and the port's from the
reference's by up to 0.035 (jamba_v0_1_52b's ``A_log``).  A key bias
without a position rotation (Whisper's) has a gradient of zero in exact
arithmetic, the softmax being shift-invariant, and rounding noise in
bf16: it is held below GRAD_FLOOR of the model's largest gradient entry
on both sides instead.

The reference is compiled with XLA's ``xla_allow_excess_precision`` off,
so it rounds to bf16 after every op as its op-by-op run
(``jax.disable_jit``) and the port do: compiled by default, XLA's fusions
keep some bf16 intermediates in f32, which moves near-tie MoE routing
(the hybrid's serving test compares op by op for that reason).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs import base as ref_base  # noqa: E402
from repro.models import param as ref_param  # noqa: E402
from repro.models import registry as ref_registry  # noqa: E402
from repro_torch import interop  # noqa: E402
from repro_torch.configs import base  # noqa: E402
from repro_torch.models import param, registry  # noqa: E402

LOGITS = dict(rtol=2e-2, atol=2e-2)
GRAD_REL = 5e-2  # max |d| / max |ref| per leaf: bf16's spread, see the docstring
GRAD_FLOOR = 1e-3  # share of the largest entry: a gradient that is zero in exact arithmetic
SHAPE = dict(seq_len=16, global_batch=2)
OP_BY_OP = {"xla_allow_excess_precision": False}


def _flat(tree, prefix=""):
    if not isinstance(tree, dict):
        return {prefix: np.asarray(tree)}
    out = {}
    for k, v in tree.items():
        out.update(_flat(v, f"{prefix}/{k}"))
    return out


def assert_leaves_agree(got: dict, want: dict, what: str, exact_zero=()) -> None:
    """Every leaf of ``got`` within GRAD_REL of ``want``'s, relative to that
    leaf's largest reference entry, and element by element within LOGITS.
    The leaves named in ``exact_zero`` are zero in exact arithmetic: below
    GRAD_FLOOR of the largest reference entry on both sides."""
    assert got.keys() == want.keys()
    floor = GRAD_FLOOR * max(np.abs(w).max() for w in want.values())
    for key, w in want.items():
        g = got[key]
        assert g.shape == w.shape and g.dtype == np.float32, key
        if key in exact_zero:
            assert max(np.abs(g).max(), np.abs(w).max()) <= floor, f"{what} {key} is not ~0"
            continue
        diff, scale = np.abs(g.astype(np.float64) - w).max(), np.abs(w).max()
        err = diff / scale if scale > 0 else diff
        assert err <= GRAD_REL, f"{what} {key}: max |d| / max |ref| = {err:.3g} > {GRAD_REL}"
        np.testing.assert_allclose(g, w, **LOGITS, err_msg=f"{what} {key}")


def _ref_value_and_grad(rapi, rparams, batch):
    fn = jax.value_and_grad(rapi.loss, has_aux=True)
    return jax.jit(fn).lower(rparams, batch).compile(compiler_options=OP_BY_OP)(rparams, batch)


@functools.lru_cache(maxsize=None)
def loss_and_grads(arch):
    """The port's and the reference's (loss, metrics, flat gradients) on one
    seed-0 draw and one ``demo_batch``, as numpy."""
    rcfg = ref_base.smoke_config(arch)
    rapi = ref_registry.get_model(rcfg)
    rparams = jax.tree.map(np.asarray, jax.jit(
        lambda: ref_param.init_params(rapi.param_specs(), seed=0))())
    batch = rapi.demo_batch(ref_base.ShapeConfig("t", kind="train", **SHAPE))
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    (want, want_m), want_g = _ref_value_and_grad(rapi, rparams, jbatch)

    cfg = base.smoke_config(arch)
    api = registry.get_model(cfg)
    model = interop.train_state_from_numpy(cfg, rparams, device="cpu")["params"]
    got, got_m = api.loss(model, {k: torch.as_tensor(v) for k, v in batch.items()})
    names, params = zip(*model.named_parameters())
    grads = torch.autograd.grad(got, params, allow_unused=True)
    got_g = param.stacked_tree({n: torch.zeros_like(p) if g is None else g
                                for n, p, g in zip(names, params, grads)})
    port = (got.item(), {k: v.item() for k, v in got_m.items()},
            _flat(jax.tree.map(lambda t: t.detach().numpy(), got_g)))
    ref = (float(want), {k: float(v) for k, v in want_m.items()}, _flat(want_g))
    return port, ref


def loss_and_grads_agree(arch):
    (got, got_m, got_g), (want, want_m, want_g) = loss_and_grads(arch)
    np.testing.assert_allclose(got, want, **LOGITS)
    np.testing.assert_allclose(got_m["xent"], want_m["xent"], **LOGITS)
    np.testing.assert_allclose(got_m["aux"], want_m["aux"], **LOGITS)
    no_rope = not base.smoke_config(arch).use_rope
    assert_leaves_agree(got_g, want_g, "gradient",
                        exact_zero=[k for k in want_g if no_rope and k.endswith("attn/bk")])


# the dense decoders are in test_torch_train_loop.py, the hybrid and the
# encoder-decoder in test_torch_train_hybrid_encdec.py (each file < 30 s)
@pytest.mark.parametrize("arch", ["llama4_scout_17b_a16e", "moonshot_v1_16b_a3b", "minicpm3_4b",
                                  "qwen2_vl_7b", "falcon_mamba_7b"])
def test_loss_and_gradients_match_reference(arch):
    loss_and_grads_agree(arch)


@pytest.mark.parametrize("fault", ["zeroed", "scaled by 0.9"])
def test_a_wrong_projection_gradient_is_caught(fault):
    """Planted faults: the port's gradient of the layers' ``wq`` set to zero
    (what a kernel outside autograd does to the attention branch), or 10%
    short, fails the gradient check, which LOGITS element by element alone
    would let pass: all its entries lie below LOGITS' absolute floor."""
    (_, _, got_g), (_, _, want_g) = loss_and_grads("moonshot_v1_16b_a3b")
    key = next(k for k in want_g if k.endswith("/wq"))
    planted = got_g[key] * (0.0 if fault == "zeroed" else 0.9)
    assert np.allclose(planted, want_g[key], **LOGITS)
    with pytest.raises(AssertionError, match=key):
        assert_leaves_agree(dict(got_g, **{key: planted}), want_g, "gradient")
