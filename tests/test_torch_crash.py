"""Crash recovery of the port's durable ``ResolveService``: a worker killed
at every fault site recovers to the reference's uninterrupted digest.

The file is also the worker.  Run as a script::

    python tests/test_torch_crash.py <durability_dir> <scheme> <site> <ckpt_every> <hit>

it ingests the fault corpus's schedule (``tests/faultcorpus.py``:
``SynthConfig.hepth(scale=0.02, seed=3)`` in 4 batches, rebuilt here with
the port's generator) on the CPU with durability on and a crash plan armed
at ``site`` hit ``hit``, and dies there by ``os._exit(CRASH_EXIT_CODE)``: no
unwinding, no flush, no atexit, as a killed worker.  The worker imports
``repro_torch`` and numpy only (``jax`` is blocked), so each case costs a
torch import and four small ingests.  It exits 0 only if the site was never
reached (the parent asserts it was).

The matrix is the reference's: every site of ``faults.SITES``; the ingest
sites at hit 3 (two clean commits and the first checkpoint, then death
mid-batch 3), the checkpoint sites (``ckpt.rename``, ``wal.rotate``) at
hits 1 and 2 (inside the first and the second checkpoint).  The parent
recovers the directory with ``ResolveService.recover``, re-submits the
batches past the recovered sequence number and holds the ``state_digest``
to the reference's uninterrupted MMP run.
"""

from __future__ import annotations

import os
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

REPO = Path(__file__).resolve().parent.parent
SCALE, SEED, N_BATCHES = 0.02, 3, 4  # tests/faultcorpus.py's schedule
CKPT_SITES = ("ckpt.rename", "wal.rotate")
SITES = ("lsh", "replay", "cover_splice", "grounding_splice", "rounds", "commit",
         "wal.append", "wal.rotate", "ckpt.rename")
CRASH_MATRIX = [(site, hit) for site in SITES for hit in ((1, 2) if site in CKPT_SITES else (3,))]


def _batches():
    from repro_torch.data.synthetic import SynthConfig, arrival_stream, make_dataset

    return arrival_stream(make_dataset(SynthConfig.hepth(scale=SCALE, seed=SEED)), N_BATCHES)


def _worker(dur_dir: str, scheme: str, site: str, ckpt_every: str, hit: str) -> int:
    sys.modules["jax"] = None  # the worker runs the port alone
    sys.path.insert(0, str(REPO / "src"))
    from repro_torch import faults
    from repro_torch.stream import ResolveService, ServiceConfig

    svc = ResolveService(
        ServiceConfig(scheme=scheme, durability_dir=dur_dir, checkpoint_every=int(ckpt_every)),
        device="cpu",
    )
    faults.install(faults.FaultPlan.fail_once(site, hit=int(hit), crash=True))
    for b in _batches():
        svc.ingest(b.names, b.edges, ids=b.ids)
    return 0


# ---------------------------------------------------------------------------
# The tests (the parent process)
# ---------------------------------------------------------------------------


def _run_worker(dur: Path, site: str, hit: int) -> subprocess.CompletedProcess:
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    return subprocess.run(
        [sys.executable, str(Path(__file__).resolve()), str(dur), "mmp", site, "2", str(hit)],
        cwd=REPO, env=env, capture_output=True, timeout=300,
    )


@pytest.fixture(scope="module")
def crashed(tmp_path_factory):
    """Every case's worker, four at a time: (site, hit) -> (dir, process)."""
    base = tmp_path_factory.mktemp("crash")
    dirs = {case: base / f"{case[0]}-hit{case[1]}" for case in CRASH_MATRIX}
    with ThreadPoolExecutor(max_workers=4) as pool:
        procs = dict(zip(CRASH_MATRIX, pool.map(lambda c: _run_worker(dirs[c], *c),
                                                CRASH_MATRIX)))
    return {case: (dirs[case], procs[case]) for case in CRASH_MATRIX}


@pytest.fixture(scope="module")
def base_digest_mmp():
    import faultcorpus
    from repro.stream.digest import state_digest as ref_digest

    batches = _batches()
    for a, b in zip(batches, faultcorpus.batches()):  # the same schedule
        assert a.names == b.names and list(a.ids) == list(b.ids)
    return ref_digest(faultcorpus.run_uninterrupted("mmp"))


def test_matrix_is_the_references():
    from repro import faults as ref_faults
    from repro_torch import faults

    assert SITES == faults.SITES == ref_faults.SITES


@pytest.mark.parametrize("site,hit", CRASH_MATRIX, ids=[f"{s}-hit{h}" for s, h in CRASH_MATRIX])
def test_crash_recovery_matrix(site, hit, crashed, base_digest_mmp):
    """Killed mid-batch between the WAL append and the commit, mid-checkpoint
    before the tmp-dir rename, or at the WAL rotation: recovery plus the
    re-submitted tail reaches the uninterrupted digest, bit for bit."""
    from repro_torch.faults import CRASH_EXIT_CODE
    from repro_torch.stream import ResolveService, ServiceConfig
    from repro_torch.stream.digest import state_digest

    dur, proc = crashed[(site, hit)]
    assert proc.returncode == CRASH_EXIT_CODE, (
        f"worker did not crash at {site}: rc={proc.returncode}\n"
        f"{proc.stderr.decode()[-2000:]}"
    )
    rec = ResolveService.recover(
        str(dur), ServiceConfig(scheme="mmp", durability_dir=str(dur), checkpoint_every=2),
        device="cpu",
    )
    # seq k holds batch k-1; a crash before the append leaves a seq gap the
    # resumed producer re-submits
    for b in _batches()[rec._seq:]:
        rec.ingest(b.names, b.edges, ids=b.ids)
    assert state_digest(rec) == base_digest_mmp, f"crash at {site} diverged"
    rec.close()


if __name__ == "__main__":
    sys.exit(_worker(*sys.argv[1:6]))
