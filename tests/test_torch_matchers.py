"""The port's matcher registry and families (``repro_torch.core.matchers``)
vs the reference's (``repro.core.matchers``), on the CPU.

The same seeded inputs go through both packages: the registry's names and
capability flags, every family's masks, labels and scores on a random
neighborhood batch and on the bipartite corpus's bins, the sequential
schemes and the round-parallel engine on that corpus, and the ``lm``
encoder with the reference's weights carried across.  The streaming
service with each family is in ``tests/test_torch_matchers_stream.py``.
Masks, labels and gids must be equal; scores agree within 1e-5 (relative,
and absolute near 0); ``lm`` embeddings within ``LM_TOL``.
"""

from __future__ import annotations

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro.core import pipeline as ref_pipeline  # noqa: E402
from repro.core import matchers as ref_matchers  # noqa: E402
from repro.core.driver import run_smp as ref_run_smp  # noqa: E402
from repro.core.matchers import assignment as ref_assignment  # noqa: E402
from repro.core.matchers.embedding import EmbeddingMatcher as RefEmbedding  # noqa: E402
from repro.core.parallel import run_parallel as ref_run_parallel  # noqa: E402
from repro.data.synthetic import make_bipartite as ref_make_bipartite  # noqa: E402
from repro_torch import interop  # noqa: E402
from repro_torch.configs.base import ModelConfig  # noqa: E402
from repro_torch.core import matchers, pipeline  # noqa: E402
from repro_torch.core.driver import run_mmp, run_nomp, run_smp  # noqa: E402
from repro_torch.core.matchers import assignment  # noqa: E402
from repro_torch.core.matchers.embedding import EM_ENCODER, EmbeddingMatcher  # noqa: E402
from repro_torch.core.parallel import run_parallel  # noqa: E402
from repro_torch.data.synthetic import make_bipartite  # noqa: E402
from tests.conftest import random_neighborhood_batch  # noqa: E402

FAMILIES = ref_matchers.list_matchers()
TYPE_II = [n for n in FAMILIES if ref_matchers.matcher_info(n).type_ii]
DEVICE = [n for n in FAMILIES if ref_matchers.matcher_info(n).device_parallel]
HOST_ONLY = [n for n in FAMILIES if not ref_matchers.matcher_info(n).device_parallel]
# lm embeddings, port against reference: both round the em_encoder's bf16
# projections, each its own way (3.0e-3 the largest entry difference
# measured on 400 hepth names)
LM_TOL = 4e-3
INFO_FIELDS = ("type_ii", "emits_messages", "monotone_entities", "supermodular",
               "device_parallel", "description")


def _pair(name, **cfg):
    """The reference's family and the port's, built from the same config."""
    return ref_matchers.get_matcher(name, **cfg), matchers.get_matcher(name, device="cpu", **cfg)


def _as_set(gids) -> set[int]:
    return set(int(g) for g in np.asarray(gids))


@pytest.fixture(scope="module")
def bip():
    """make_bipartite(40, seed=1), packed by both packages (equal covers)."""
    ref_ds = ref_make_bipartite(40, seed=1)
    ds = make_bipartite(40, seed=1)
    assert ds.entities.names == ref_ds.entities.names
    ref_packed, ref_gg, _ = ref_pipeline.prepare(ref_ds.entities, ref_ds.relations)
    packed, gg, _ = pipeline.prepare(ds.entities, ds.relations, device="cpu")
    assert sorted(packed.bins) == sorted(ref_packed.bins)
    for k, nb in packed.bins.items():
        assert np.array_equal(nb.pair_gid, np.asarray(ref_packed.bins[k].pair_gid))
    return dict(ref_ds=ref_ds, ds=ds, ref_packed=ref_packed, ref_gg=ref_gg, packed=packed, gg=gg)


# ---------------------------------------------------------------------------
# The registry
# ---------------------------------------------------------------------------


def test_registry_names_and_flags_equal_the_reference():
    assert matchers.list_matchers() == ref_matchers.list_matchers()
    for name in FAMILIES:
        ref, port = ref_matchers.matcher_info(name), matchers.matcher_info(name)
        assert port.name == name
        for f in INFO_FIELDS:
            assert getattr(port, f) == getattr(ref, f), (name, f)
    with pytest.raises(KeyError, match="unknown matcher family"):
        matchers.get_matcher("no_such_family")


def test_register_matcher_latest_wins():
    info = matchers.matcher_info("rules")
    try:
        shadow = matchers.register_matcher(
            "rules", lambda **cfg: "shadow", type_ii=False, emits_messages=False,
            monotone_entities=False, supermodular=False, device_parallel=True)
        assert matchers.get_matcher("rules") == "shadow" and shadow.build() == "shadow"
    finally:
        matchers.register_matcher(
            "rules", info.factory, **{f: getattr(info, f) for f in INFO_FIELDS})
    assert matchers.matcher_info("rules") == info


@pytest.mark.parametrize("name", FAMILIES)
def test_factories_pass_the_device_through(name):
    m = matchers.get_matcher(name, device="cpu")
    assert m.device.type == "cpu"
    assert hasattr(m, "parallel_backend") == matchers.matcher_info(name).device_parallel
    assert (getattr(m, "score", None) is not None) == matchers.matcher_info(name).type_ii


# ---------------------------------------------------------------------------
# Masks, labels and scores per family
# ---------------------------------------------------------------------------


def _evidence(rng, pair_mask):
    pm = np.asarray(pair_mask, dtype=bool)
    return pm & (rng.random(pm.shape) < 0.15), pm & (rng.random(pm.shape) < 0.05)


def _batches(source, bip):
    bins = bip["ref_packed"].bins
    if source == "random":
        # at the shape of the corpus's smallest bin, which the reference has
        # compiled its grounding for already
        k = min(bins)
        return [random_neighborhood_batch(np.random.default_rng(0), B=bins[k].batch, k=k)]
    return [bins[k] for k in sorted(bins)]


@pytest.mark.parametrize("source", ["random", "bipartite"])
@pytest.mark.parametrize("name", FAMILIES)
def test_masks_labels_and_scores_equal(name, source, bip):
    ref, port = _pair(name)
    rng = np.random.default_rng(5)
    for rb in _batches(source, bip):
        pb = interop.batch_from_arrays(rb)
        for ev_pos, ev_neg in [(None, None), _evidence(rng, rb.pair_mask)]:
            want = np.asarray(ref.run(rb, ev_pos, ev_neg))
            got = port.run(pb, ev_pos, ev_neg)
            assert got.dtype == bool and np.array_equal(got, want), name
            if name in TYPE_II:
                wx, wl = ref.run_with_messages(rb, ev_pos, ev_neg)
                gx, gl = port.run_with_messages(pb, ev_pos, ev_neg)
                assert np.array_equal(gx, np.asarray(wx)) and np.array_equal(gl, np.asarray(wl))
                x = want | (rng.random(want.shape) < 0.2)
                np.testing.assert_allclose(port.score(pb, x), np.asarray(ref.score(rb, x)),
                                           rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("shape", [(1, 1), (3, 4), (5, 3), (6, 6), (2, 7)])
def test_hungarian_scipy_and_bitmask_dp_agree(shape):
    """The exact DP (no scipy) and ``linear_sum_assignment`` pick the same
    matching; the port's solvers give the reference's pairs."""
    pytest.importorskip("scipy")
    rng = np.random.default_rng(sum(shape))
    for _ in range(5):
        W = np.where(rng.random(shape) < 0.6, 1.0 + 3.0 * rng.random(shape), 0.0)
        opt = sorted(assignment._solve_optimal(W))
        dp = sorted(assignment._solve_dp(W))
        assert dp == opt
        assert opt == sorted(ref_assignment._solve_optimal(W))
        assert dp == sorted(ref_assignment._solve_dp(W))
        keys = rng.permutation(W.size).reshape(shape)
        assert assignment._solve_greedy(W, keys) == ref_assignment._solve_greedy(W, keys)


# ---------------------------------------------------------------------------
# Schemes, the round-parallel engine, the streaming service
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def ref_runs(bip):
    """The reference's smp fixpoint per family on the bipartite corpus: the
    round-parallel engine for the device families (the reference holds it
    equal to its sequential drivers), the sequential driver for the others."""
    out = {}
    for n in FAMILIES:
        m = ref_matchers.get_matcher(n)
        out[n] = (ref_run_parallel(bip["ref_packed"], m, scheme="smp") if n in DEVICE
                  else ref_run_smp(bip["ref_packed"], m))
    return out


@pytest.mark.parametrize("name", FAMILIES)
def test_schemes_equal_the_reference(name, bip, ref_runs):
    """NO-MP == SMP (== MMP for Type II) in the port, each equal to the
    reference's fixpoint."""
    m = matchers.get_matcher(name, device="cpu")
    runs = [run_nomp(bip["packed"], m), run_smp(bip["packed"], m)]
    if name in TYPE_II:
        runs.append(run_mmp(bip["packed"], m, bip["gg"]))
    for r in runs:
        assert _as_set(r.matches.gids) == _as_set(ref_runs[name].matches.gids), name


@pytest.mark.parametrize("name", DEVICE)
def test_run_parallel_equals_the_reference(name, bip, ref_runs):
    got = run_parallel(bip["packed"], matchers.get_matcher(name, device="cpu"), scheme="smp",
                       device="cpu")
    want = ref_runs[name]
    assert _as_set(got.matches.gids) == _as_set(want.matches.gids)
    assert (got.rounds, got.neighborhood_evals, got.dispatches, got.history) == (
        want.rounds, want.neighborhood_evals, want.dispatches, list(want.history))


@pytest.mark.parametrize("name", HOST_ONLY)
def test_run_parallel_rejects_host_only_families(name, bip):
    with pytest.raises(TypeError, match="parallel"):
        run_parallel(bip["packed"], matchers.get_matcher(name, device="cpu"), scheme="smp",
                     device="cpu")
    with pytest.raises(TypeError, match="parallel"):
        ref_run_parallel(bip["ref_packed"], ref_matchers.get_matcher(name), scheme="smp")


def test_parallel_mmp_refuses_the_embedding_family(bip):
    with pytest.raises(TypeError, match="run_mmp"):
        run_parallel(bip["packed"], matchers.get_matcher("embedding", device="cpu"), bip["gg"],
                     scheme="mmp", device="cpu")


# ---------------------------------------------------------------------------
# The lm encoder
# ---------------------------------------------------------------------------


def test_lm_encoder_with_the_reference_weights(hepth_small):
    """``encoder="lm"`` with the reference's ``demo_engine`` weights carried
    across.  The two packages round the bf16 projections' activations
    differently (up to 3.0e-3 an entry on these names), so embeddings are
    held within ``LM_TOL``; ``ground_rows`` masks must be equal wherever the
    reference's cosine is further from ``tau`` than the embeddings' error
    can move it (for unit vectors, ``2 e + e**2`` with ``e`` the largest
    row error in the L2 norm)."""
    names = list(hepth_small.entities.names)[:40]
    ref_m = RefEmbedding(encoder="lm")
    ref_m.bind_names(names)
    ref_params = jax.tree.map(np.asarray, ref_m._lm_engine().params)
    model = interop.lm_params_from_numpy(ModelConfig(**EM_ENCODER), ref_params, device="cpu")
    m = EmbeddingMatcher(encoder="lm", lm_params=model, device="cpu")
    m.bind_names(names)
    k = 8
    ids = np.arange(40, dtype=np.int64).reshape(5, k)
    ids[4, 6:] = -1  # a padded row
    pm = np.ones((5, k * (k - 1) // 2), dtype=bool)
    base, valid = m.ground_rows(ids, pm)
    want_base, want_valid = ref_m.ground_rows(ids, pm)
    assert m.encode_calls == ref_m.encode_calls == 1
    assert sorted(m._memo) == sorted(ref_m._memo) == list(range(38))
    E = np.stack([m._memo[i] for i in range(38)])
    want_E = np.stack([ref_m._memo[i] for i in range(38)])
    assert E.shape == want_E.shape == (38, EM_ENCODER["vocab_size"])
    np.testing.assert_allclose(E, want_E, rtol=0, atol=LM_TOL)
    e = float(np.linalg.norm(E - want_E, axis=1).max())
    ii, jj = np.triu_indices(k, 1)
    cos = (want_E[np.maximum(ids[:, ii], 0)] * want_E[np.maximum(ids[:, jj], 0)]).sum(-1)
    clear = (np.abs(cos - ref_m.tau) > 2 * e + e * e) & (ids[:, ii] >= 0) & (ids[:, jj] >= 0)
    assert clear.sum() > 0
    assert np.array_equal(base[clear], np.asarray(want_base)[clear])
    assert np.array_equal(valid, np.asarray(want_valid))


def test_lm_encoder_default_weights_are_drawn_on_the_cpu():
    """The default weights come from a CPU generator seeded with ``seed``:
    two matchers of one seed agree exactly, another seed differs."""
    names = ["a. smith", "alan smith", "b. jones"]
    vecs = []
    for seed in (0, 0, 1):
        m = EmbeddingMatcher(encoder="lm", seed=seed, device="cpu")
        m.bind_names(names)
        m._ensure(np.arange(3))
        vecs.append(np.stack([m._memo[i] for i in range(3)]))
    assert np.array_equal(vecs[0], vecs[1])
    assert not np.allclose(vecs[0], vecs[2])
