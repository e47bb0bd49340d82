"""The port's serving engine and launcher vs the reference's, on the CPU.

Weights come from the reference's ``init_params`` and are carried across
with ``interop.lm_params_from_numpy``; prompts are made from a seed with
numpy (or from the names of ``hepth_small``).  Greedy tokens must agree
wherever the reference's top-1/top-2 logit margin is above 2e-2, the
logits tolerance of ``tests/test_torch_models.py``: below it, bf16
rounding taken in another order may pick the other token.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs import base as ref_base  # noqa: E402
from repro.configs.base import ModelConfig as RefModelConfig  # noqa: E402
from repro.models import registry as ref_registry  # noqa: E402
from repro.serve import engine as ref_engine  # noqa: E402
from repro_torch import interop  # noqa: E402
from repro_torch.configs import base  # noqa: E402
from repro_torch.configs.base import ModelConfig  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.models import registry  # noqa: E402
from repro_torch.serve import engine  # noqa: E402

TOL = 2e-2

# the embedding matcher's ``lm`` encoder (repro/core/matchers/embedding.py)
EM_ENCODER = dict(name="em_encoder", family="dense", n_layers=2, d_model=32,
                  n_heads=4, n_kv_heads=4, d_ff=64, vocab_size=256)


def _pair(rcfg, cfg, batch, s_max):
    """The reference's demo engine and the port's engine over the same weights."""
    ref = ref_engine.demo_engine(ref_registry.get_model(rcfg), batch=batch, s_max=s_max, seed=0)
    model = interop.lm_params_from_numpy(cfg, jax.tree.map(np.asarray, ref.params), device="cpu")
    return ref, engine.Engine(registry.get_model(cfg), model, batch, s_max, device="cpu")


def _reference_margins(ref, prompts, max_new):
    """Greedy tokens and top-1/top-2 margins of the reference, step by step."""
    toks, margins = [], []
    for lo in range(0, len(prompts), ref.batch):
        group = prompts[lo : lo + ref.batch]
        tokens = np.stack(list(group) + [group[-1]] * (ref.batch - len(group)))
        logits, cache = ref._prefill(ref.params, jnp.asarray(tokens))
        seq, mar = [], []
        for t in range(max_new):
            last = np.asarray(logits[:, -1, :], np.float32)
            top2 = np.sort(last, axis=-1)[:, -2:]
            cur = last.argmax(-1).astype(np.int32)
            seq.append(cur)
            mar.append(top2[:, 1] - top2[:, 0])
            batch = {"tokens": jnp.asarray(cur[:, None]),
                     "pos": jnp.full((ref.batch,), tokens.shape[1] + t, jnp.int32)}
            logits, cache = ref._decode(ref.params, cache, batch)
        toks.extend(np.stack(seq, 1)[: len(group)].tolist())
        margins.extend(np.stack(mar, 1)[: len(group)].tolist())
    return toks, margins


@pytest.mark.parametrize("arch", ["yi_6b", "qwen2_72b"])
def test_generate_matches_reference(arch):
    ref, eng = _pair(ref_base.smoke_config(arch), base.smoke_config(arch), batch=2, s_max=16)
    rng = np.random.default_rng(5)
    vocab = eng.api.cfg.vocab_size
    prompts = [rng.integers(1, vocab - 1, size=8).astype(np.int32) for _ in range(3)]
    max_new = 5
    got = eng.generate(prompts, max_new=max_new)  # the short group is padded
    want = ref.generate(prompts, max_new=max_new)
    ref_toks, margins = _reference_margins(ref, prompts, max_new)
    assert ref_toks == want
    assert [len(g) for g in got] == [max_new] * len(prompts)
    compared = 0
    for g, w, m in zip(got, want, margins):
        for t in range(max_new):
            if g[t] != w[t]:
                assert m[t] <= TOL, (t, g, w, m)
                break  # later tokens continue another sequence
            compared += m[t] > TOL
    assert compared >= 1


def test_encode_matches_reference(hepth_small):
    """The ``lm`` encoder of the embedding matcher: names -> byte tokens ->
    prefill logits at position ``s_max - 1`` (a padding position, the
    reference's quirk), L2-normalized."""
    ref, eng = _pair(RefModelConfig(**EM_ENCODER), ModelConfig(**EM_ENCODER), batch=8, s_max=32)
    names = hepth_small.entities.names[:19]
    prompts = [
        np.frombuffer(n.encode("utf-8", "ignore"), dtype=np.uint8).astype(np.int32)[:32]
        for n in names
    ]
    got = eng.encode(prompts)
    want = ref.encode(prompts)
    assert got.shape == want.shape == (len(names), 256) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)
    np.testing.assert_allclose(np.linalg.norm(got, axis=-1), 1.0, rtol=1e-5)
    # the quirk: each vector is the normalized last-position logits of its padded prompt
    toks = np.zeros((8, 32), np.int32)
    toks[0, : len(prompts[0])] = prompts[0]
    logits, _ = eng._prefill(toks)
    row = logits[0, 0].numpy()
    np.testing.assert_allclose(got[0], row / np.linalg.norm(row), rtol=1e-5, atol=1e-6)


def test_launcher_serves_a_smoke_model_on_cpu(capsys):
    outs = serve.main(["--arch", "yi_6b", "--smoke", "--device", "cpu", "--requests", "3",
                       "--batch", "2", "--prompt-len", "8", "--max-new", "4", "--s-max", "16"])
    assert [len(o) for o in outs] == [4, 4, 4]
    assert all(0 <= t < 512 for o in outs for t in o)
    line = capsys.readouterr().out.strip().splitlines()[-1]
    assert line.startswith("yi-smoke: 3 requests, 12 tokens, ")


def test_launcher_modes_not_ported(capsys):
    # --em serves the sharded EM service (one rank here, on the CPU)
    digest = serve.main(["--em", "--device", "cpu", "--scale", "0.02", "--batches", "2"])
    line = capsys.readouterr().out.strip().splitlines()[-1]
    assert line.startswith("shard 0/1: ") and f"digest {digest[:12]} (replicas agree)" in line
    for arch in ("jamba_v0_1_52b", "whisper_medium"):  # the hybrid and encdec: no prefill
        with pytest.raises(SystemExit, match="has no prefill path"):
            serve.main(["--arch", arch, "--smoke", "--device", "cpu"])
