"""Sharded serving across processes: 1, 2 and 4 gloo ranks on the CPU
against the reference's single-host digest.

Each spawn starts N copies of ``tests/torch_shard_worker.py`` on one
``torch.distributed`` group (a file store under ``tmp_path``, so no TCP
port can be raced for) and runs its jobs in order on it: every rank's
digest must equal the reference's single-process one, bit for bit, and
the ranks must agree among themselves (``AGREE 1``, a cross-rank digest
gather).  The two spawns start before the reference's baselines are
computed in this process, and run beside them.
"""

from __future__ import annotations

import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

pytest.importorskip("torch")

from repro.data.synthetic import SynthConfig, arrival_stream, make_dataset  # noqa: E402
from repro.stream.digest import match_digest, state_digest  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
WORKER = str(Path(__file__).parent / "torch_shard_worker.py")
TIMEOUT_S = 240  # a spawn's whole run; each collective times out after 60 s
SPAWNS = {
    1: ["hepth:mmp:-1"],
    2: ["hepth:mmp:-1", "hepth:smp:-1", "lattice:smp", "lattice:mmp", "hepth:smp:5",
        "lattice:mmp:legacy", "lattice:nomp:legacy"],
    4: ["hepth:mmp:-1"],
}


def _spawn(n: int, jobs: list[str], store: Path) -> list[subprocess.Popen]:
    env = {
        **os.environ,
        "PYTHONPATH": str(ROOT / "src"),
        "OMP_NUM_THREADS": "1",
        "REPRO_SHARD_COORD": store.as_uri(),
        "REPRO_SHARD_N": str(n),
        "REPRO_SHARD_TIMEOUT_S": "60",
    }
    return [
        subprocess.Popen([sys.executable, WORKER, *jobs], stdout=subprocess.PIPE,
                         stderr=subprocess.PIPE, text=True,
                         env={**env, "REPRO_SHARD_ID": str(i)})
        for i in range(n)
    ]


def _collect(procs: list[subprocess.Popen]) -> list[tuple[int, str, str]]:
    """Every rank's (rc, stdout, stderr); every rank is killed on failure."""
    outs = []
    try:
        for p in procs:
            out, err = p.communicate(timeout=TIMEOUT_S)
            outs.append((p.returncode, out, err))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    return outs


def _ref_hepth(scheme: str, perm_seed: int = -1) -> str:
    from repro.stream.service import ResolveService, ServiceConfig

    batches = arrival_stream(make_dataset(SynthConfig.hepth(scale=0.02, seed=3)), 3)
    order = list(range(len(batches)))
    if perm_seed >= 0:
        order = [int(i) for i in np.random.default_rng(perm_seed).permutation(len(batches))]
    svc = ResolveService(ServiceConfig(scheme=scheme, parallel=True))
    for i in order:
        b = batches[i]
        svc.ingest(list(b.names), b.edges, ids=[int(x) for x in b.ids])
    return state_digest(svc)


def _ref_lattice(scheme: str, fused: bool = True) -> str:
    from repro.core.global_grounding import build_global_grounding
    from repro.core.mln import MLNMatcher
    from repro.core.parallel import run_parallel
    from repro.data.synthetic import make_lattice_cover

    packed, relations, weights = make_lattice_cover(depth=6, width=4)
    gg = build_global_grounding(packed.pair_levels, relations, weights) if scheme == "mmp" else None
    res = run_parallel(packed, MLNMatcher(weights), gg, scheme=scheme, fused=fused)
    return match_digest(res.matches)


@pytest.fixture(scope="module")
def battery(tmp_path_factory):
    """(ranks' outputs by spawn size, the reference's digests by job)."""
    tmp = tmp_path_factory.mktemp("shard_stores")
    procs = {n: _spawn(n, jobs, tmp / f"store{n}") for n, jobs in SPAWNS.items()}
    try:
        expect = {
            "hepth:mmp:-1": _ref_hepth("mmp"),
            "hepth:smp:-1": _ref_hepth("smp"),
            "hepth:smp:5": _ref_hepth("smp", 5),
            "lattice:smp": _ref_lattice("smp"),
            "lattice:mmp": _ref_lattice("mmp"),
            "lattice:mmp:legacy": _ref_lattice("mmp", fused=False),
            "lattice:nomp:legacy": _ref_lattice("nomp", fused=False),
        }
    finally:
        outs = {n: _collect(p) for n, p in procs.items()}
    return outs, expect


def _rank_lines(outs, n: int):
    for rc, out, err in outs[n]:
        assert rc == 0, f"rank failed rc={rc}\n{out}\n{err[-3000:]}"
        # "BACKEND gloo", "DIGEST <job> <hex>", "AGREE <job> <0|1>"
        yield {tuple(ln.split()[:-1]): ln.split()[-1] for ln in out.splitlines() if ln}


@pytest.mark.parametrize("n, job", [
    (1, "hepth:mmp:-1"),
    (2, "hepth:mmp:-1"),
    (4, "hepth:mmp:-1"),
    (2, "hepth:smp:-1"),
    (2, "lattice:smp"),
    (2, "lattice:mmp"),
    (2, "hepth:smp:5"),
    (2, "lattice:mmp:legacy"),
    (2, "lattice:nomp:legacy"),
])
def test_ranks_digest_equals_reference_single_host(battery, n, job):
    outs, expect = battery
    ranks = list(_rank_lines(outs, n))
    assert len(ranks) == n
    for lines in ranks:
        assert lines[("BACKEND",)] == "gloo"
        assert lines[("DIGEST", job)] == expect[job]
        assert lines[("AGREE", job)] == "1"
        # split rounds: the bitset reduced over the ranks (one rank: never)
        assert (int(lines[("BITS", job)]) > 0) == (n > 1)
        if job.startswith("hepth"):
            assert (int(lines[("UNION", job)]) > 0) == (n > 1)  # one a probe
    # every evaluated row was evaluated by exactly one rank
    evals = {int(lines[("EVALS", job)]) for lines in ranks}
    assert len(evals) == 1
    local = [int(lines[("LOCAL", job)]) for lines in ranks]
    assert sum(local) == evals.pop() and (n == 1 or max(local) < sum(local))


def test_permuted_schedule_is_the_arrival_order_fixpoint(battery):
    """The reference's schedule invariance, on the ranks: the permuted smp
    run's digest is the arrival-order one (ids preserved)."""
    outs, expect = battery
    assert expect["hepth:smp:5"] == expect["hepth:smp:-1"]
    for lines in _rank_lines(outs, 2):
        assert lines[("DIGEST", "hepth:smp:5")] == lines[("DIGEST", "hepth:smp:-1")]
