"""The port's round-parallel engine (``repro_torch.core.parallel``) vs the
reference's (``repro.core.parallel``), on the CPU: batch runs.

The same cover and global grounding (carried across with
:mod:`repro_torch.interop`) go through both packages' ``run_parallel``:
the match gids and the round schedule (rounds, evals, messages,
dispatches, full rounds, history, host scans) must be equal bit for bit,
for every scheme, fused and legacy, MLN and RULES.  The cover is
``hepth_small`` packed at ``k_max=16`` (bins k=8 and k=16): the
reference compiles a program per bin shape and row count, and the
larger bins would double this file's time; the grounding-cache tests
(``test_torch_parallel_cache.py``) and the card run the k=24/32 bins.
Also here: ``resolve(parallel=True)``, the entry points' device rules
and the refusals.
"""

from __future__ import annotations

import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import fig1 as ref_fig1  # noqa: E402
from repro.core import parallel as ref_par  # noqa: E402
from repro.core import pipeline as ref_pipeline  # noqa: E402
from repro.core.global_grounding import build_global_grounding as ref_build_gg  # noqa: E402
from repro.core.mln import MLNMatcher as RefMLN  # noqa: E402
from repro.core.mln import PAPER_LEARNED as REF_WEIGHTS  # noqa: E402
from repro.core.mln import PEDAGOGICAL as REF_PEDAGOGICAL  # noqa: E402
from repro.core.rules import RulesMatcher as RefRules  # noqa: E402
from repro.data import synthetic as ref_synth  # noqa: E402
from repro_torch import interop, obs  # noqa: E402
from repro_torch.core import fig1, parallel, pipeline, txn  # noqa: E402
from repro_torch.core.driver import run_mmp, run_nomp, run_smp  # noqa: E402
from repro_torch.core.global_grounding import build_global_grounding  # noqa: E402
from repro_torch.core.mln import PEDAGOGICAL, MLNMatcher, ground  # noqa: E402
from repro_torch.core.rules import RulesMatcher  # noqa: E402
from repro_torch.data import synthetic  # noqa: E402

# the EMResult fields both engines must agree on
SCHEDULE = ("rounds", "neighborhood_evals", "messages_emitted", "dispatches",
            "full_rounds", "history", "promote_host_scans")
# (matcher, scheme, fused, fast_rounds)
RUNS = [
    *(("mln", s, f, fr) for s in ("nomp", "smp", "mmp") for f in (True, False)
      for fr in (True, False)),
    *(("rules", s, f, True) for s in ("nomp", "smp") for f in (True, False)),
]


def _port_matcher(kind):
    if kind == "rules":
        return RulesMatcher(device="cpu")
    return MLNMatcher(interop.weights_from_numpy(REF_WEIGHTS.w_sim, REF_WEIGHTS.w_co),
                      device="cpu")


def _ref_matcher(kind):
    return RefRules() if kind == "rules" else RefMLN(REF_WEIGHTS)


K_MAX = 16


@pytest.fixture(scope="module")
def state(hepth_small):
    """(ref packed, ref gg, port packed, port gg) of hepth_small."""
    pk, gg, _ = ref_pipeline.prepare(hepth_small.entities, hepth_small.relations, k_max=K_MAX)
    return pk, gg, interop.packed_from_arrays(pk), interop.grounding_from_arrays(gg)


def _run_both(state, kind, scheme, **kw):
    pk, gg, ppk, pgg = state
    ref = ref_par.run_parallel(pk, _ref_matcher(kind), gg, scheme=scheme, **kw)
    port = parallel.run_parallel(ppk, _port_matcher(kind), pgg, scheme=scheme, device="cpu",
                                 **kw)
    return ref, port


def _assert_same_run(ref, port):
    np.testing.assert_array_equal(port.matches.gids, ref.matches.gids)
    assert {f: getattr(port, f) for f in SCHEDULE} == {f: getattr(ref, f) for f in SCHEDULE}


@pytest.mark.parametrize("kind,scheme,fused,fast_rounds", RUNS)
def test_run_parallel_equals_reference(state, kind, scheme, fused, fast_rounds):
    ref, port = _run_both(state, kind, scheme, fused=fused, fast_rounds=fast_rounds)
    _assert_same_run(ref, port)
    assert port.messages_promoted == ref.messages_promoted
    assert len(port.history) == port.rounds
    if fused:
        assert port.promote_host_scans == 0


@pytest.mark.parametrize("kind,scheme", [("mln", "nomp"), ("mln", "smp"), ("mln", "mmp"),
                                         ("rules", "smp")])
def test_run_parallel_equals_sequential_drivers(state, kind, scheme):
    """Thms. 2/4 inside the port: the round schedule reaches the
    sequential drivers' fixpoint."""
    _, _, ppk, pgg = state
    m = _port_matcher(kind)
    seq = {"nomp": lambda: run_nomp(ppk, m), "smp": lambda: run_smp(ppk, m),
           "mmp": lambda: run_mmp(ppk, m, pgg)}[scheme]()
    par = parallel.run_parallel(ppk, m, pgg, scheme=scheme, device="cpu")
    np.testing.assert_array_equal(par.matches.gids, seq.matches.gids)


def test_rules_smp_is_one_dispatch(state):
    ref, port = _run_both(state, "rules", "smp")
    assert port.dispatches == ref.dispatches == 1
    assert port.rounds > 1  # the whole multi-round closure in one call


def test_resolve_parallel_equals_reference(hepth_small):
    ds = synthetic.make_dataset(synthetic.SynthConfig.hepth(scale=0.035, seed=7))
    ref = ref_pipeline.resolve(hepth_small.entities, hepth_small.relations, scheme="mmp",
                               parallel=True, k_max=K_MAX)
    port = pipeline.resolve(ds.entities, ds.relations, scheme="mmp", parallel=True,
                            k_max=K_MAX, device="cpu")
    _assert_same_run(ref.result, port.result)
    np.testing.assert_array_equal(port.closed.gids, ref.closed.gids)


def test_fig1_mmp_promotes_on_the_device():
    """Fig. 1 is the paper's promotion example: messages must actually be
    promoted through the device promoter, as in the reference."""
    pk_r = ref_fig1.packed_cover()
    ref = ref_par.run_parallel(
        pk_r, RefMLN(REF_PEDAGOGICAL),
        ref_build_gg(pk_r.pair_levels, ref_fig1.relations(), REF_PEDAGOGICAL), scheme="mmp",
    )
    pk = fig1.packed_cover()
    gg = build_global_grounding(pk.pair_levels, fig1.relations(), PEDAGOGICAL)
    port = parallel.run_parallel(pk, MLNMatcher(PEDAGOGICAL, device="cpu"), gg, scheme="mmp",
                                 device="cpu")
    _assert_same_run(ref, port)
    assert port.messages_promoted > 0
    assert port.promote_host_scans == 0
    assert fig1.names_of(port.matches) == fig1.EXPECTED_MMP


def test_entry_points_default_to_cuda(monkeypatch, state):
    """device=None means CUDA: without a GPU the parallel entry points
    raise, never fall back."""
    from repro_torch.stream import ResolveService, ServiceConfig
    from repro_torch.stream.engine import IncrementalEngine

    _, _, ppk, pgg = state
    m = MLNMatcher(device="cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    ds = synthetic.make_dataset(synthetic.SynthConfig.hepth(scale=0.035, seed=7))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        pipeline.resolve(ds.entities, ds.relations, parallel=True)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        parallel.run_parallel(ppk, m, pgg, scheme="smp")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        IncrementalEngine(m, parallel=True)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ResolveService(ServiceConfig(parallel=True, gcache_capacity=2))
    assert IncrementalEngine(m, parallel=True, device="cpu").device.type == "cpu"


def test_refusals(state):
    _, _, ppk, pgg = state
    with pytest.raises(NotImplementedError, match="item 9"):
        parallel.run_parallel(ppk, MLNMatcher(device="cpu"), pgg, mesh=object(), device="cpu")
    with pytest.raises(TypeError, match="no grounding builder registered for kind 'nowhere'"):
        parallel._ground_bin_fn("nowhere", None, torch.device("cpu"))
    assert "embed" in parallel._GROUND_BUILDERS  # the embedding family's, beside mln and rules
    with pytest.raises(TypeError, match="parallel backend"):
        parallel.run_parallel(ppk, object(), pgg, device="cpu")
    with pytest.raises(AssertionError):  # no score(): not a Type-II matcher
        parallel.run_parallel(ppk, RulesMatcher(device="cpu"), pgg, scheme="mmp", device="cpu")

    class ScoredRules(RulesMatcher):
        def score(self, batch, x):
            raise AssertionError("never called")

    with pytest.raises(TypeError, match="MLN device promoter"):
        parallel.run_parallel(ppk, ScoredRules(device="cpu"), pgg, scheme="mmp", device="cpu")
    elsewhere = MLNMatcher(device="cpu")
    elsewhere.device = torch.device("cuda", 0)
    with pytest.raises(ValueError, match="matcher runs on"):
        parallel.run_parallel(ppk, elsewhere, pgg, device="cpu")
    with pytest.raises(ValueError):
        parallel.GroundingCache(capacity=0)
