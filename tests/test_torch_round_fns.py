"""The EM round functions (``core/parallel.py`` ``build_round_fn`` and
``build_bin_round_fn``) on 1, 2 and 4 gloo CPU ranks against the reference's
on a one-device mesh: ``x``, the labels and the bitset bit for bit, for the
``mln``, ``mln_greedy`` and ``rules`` kinds.

The inputs are a random padded neighborhood batch drawn with numpy from a
seed (``tests/torch_round_fn_worker.py`` ``round_fn_inputs``; 10 rows, so 4
ranks pad it), a random universe bitset and a random set of active rows for
the full round.  The reference runs in process (its jitted round functions
on ``jax.make_mesh((1,), ("data",))``); the port's one rank runs in process
on the one-rank mesh, and 2 and 4 ranks run as worker processes on a file
store, their rows gathered back by the round functions themselves.  The
workers also run ``run_parallel`` over their ranks, whose full rounds call
the round functions without collectives and make their own once a round.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

sys.path.insert(0, str(Path(__file__).parent))
from torch_round_fn_worker import B, KINDS, round_fn_inputs, run  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
WORKER = str(Path(__file__).parent / "torch_round_fn_worker.py")
SEED = 5
TIMEOUT_S = 120


def _reference() -> dict:
    from repro.core import parallel as par
    from repro.core.mln import PAPER_LEARNED

    (ids, emask, co, lev, pmask, uidx), Np, m_bits, active = round_fn_inputs(SEED)
    mesh = jax.make_mesh((1,), ("data",), devices=jax.devices()[:1])
    P = pmask.shape[1]
    k = emask.shape[1]
    out = {}
    for kind in KINDS:
        spec = par.RoundSpec(k=k, num_pairs=P, universe_size=Np, matcher_kind=kind,
                             weights=PAPER_LEARNED)
        fn = par.build_round_fn(spec, mesh, ("data",))
        out[f"round/{kind}"] = fn(jnp.asarray(emask), jnp.asarray(co), jnp.asarray(lev),
                                  jnp.asarray(pmask), jnp.asarray(uidx), jnp.asarray(m_bits))
        ground = "rules" if kind == "rules" else "mln"
        g = par._ground_bin_fn(ground, None if kind == "rules" else PAPER_LEARNED)(
            jnp.asarray(ids), jnp.asarray(emask), jnp.asarray(co), jnp.asarray(lev),
            jnp.asarray(pmask))
        bspec = par.BinRoundSpec(kind=kind, k=k, batch=B, num_pairs=P, universe_size=Np)
        bfn = par.build_bin_round_fn(bspec, mesh, ("data",))
        out[f"bin/{kind}"] = bfn(*g, jnp.asarray(uidx), jnp.asarray(pmask),
                                 jnp.asarray(active), jnp.asarray(m_bits))
    return {key: [np.asarray(t).tolist() for t in v] for key, v in out.items()}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The reference's results, and the port's on 1, 2 and 4 ranks."""
    base = tmp_path_factory.mktemp("round_fns")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), REPRO_SHARD_TIMEOUT_S="60")
    procs = {}
    for n in (2, 4):
        store = base / f"store{n}"
        procs[n] = [subprocess.Popen([sys.executable, WORKER, str(store), str(n), str(r),
                                      str(SEED)], env=env, stdout=subprocess.PIPE,
                                     stderr=subprocess.PIPE, text=True)
                    for r in range(n)]
    from repro_torch.launch.mesh import EMMesh

    got = {"reference": _reference(), 1: run(EMMesh.local("cpu"), SEED)}
    for n, ps in procs.items():
        outs = [p.communicate(timeout=TIMEOUT_S) for p in ps]
        for p, (_, err) in zip(ps, outs):
            assert p.returncode == 0, err[-3000:]
        line = [ln for ln in outs[0][0].splitlines() if ln.startswith("RESULT ")][-1]
        got[n] = json.loads(line[len("RESULT "):])
    return got


@pytest.mark.parametrize("ranks", [1, 2, 4])
@pytest.mark.parametrize("fn", ["round", "bin"])
@pytest.mark.parametrize("kind", KINDS)
def test_round_fns_equal_the_reference_bit_for_bit(runs, ranks, fn, kind):
    """Every row of the legacy round; the full round's active rows (the
    reference evaluates the inactive ones too and masks them out of the
    bitset, the port does not evaluate them) and its whole bitset."""
    want = runs["reference"][f"{fn}/{kind}"]
    got = runs[ranks][f"{fn}/{kind}"]
    rows = round_fn_inputs(SEED)[3] if fn == "bin" else np.ones(B, bool)
    for name, w, g in zip(("x", "labels"), want, got):
        np.testing.assert_array_equal(np.asarray(g)[rows], np.asarray(w)[rows], err_msg=name)
    np.testing.assert_array_equal(np.asarray(got[2]), np.asarray(want[2]), err_msg="bits")
    assert np.asarray(got[0])[rows].any()  # the matcher matched something
    if fn == "bin":
        assert not np.asarray(got[0])[~rows].any()



@pytest.mark.parametrize("ranks", [2, 4])
@pytest.mark.parametrize("scheme", ["smp", "mmp"])
def test_full_rounds_make_one_reduction_and_one_gather_a_round(runs, ranks, scheme):
    """Over ranks, ``run_parallel`` makes one bitset reduction a round
    (fused or full) and, for MMP's messages, one gather of the labels a
    full round, however many bins a full round evaluates (two here)."""
    got = runs[ranks]["collectives"][scheme]
    assert got["full_rounds"] >= 1
    assert got["bits"] == got["rounds"]
    assert got["rows"] == (got["full_rounds"] if scheme == "mmp" else 0)
