"""Fault tolerance of the port (``repro_torch.faults``, the write-ahead log,
the checkpointer and the durable ``ResolveService``) against the reference,
on the CPU: the in-process cases of the reference's ``tests/test_faults.py``.

1. **Rollback**: an ingest aborted at any injected site leaves the service
   bit for bit where it was (``state_digest``), across in-order, permuted
   and re-split schedules; finishing the stream reaches the reference's
   uninterrupted digest.
2. **Durability**: the WAL's byte format is the reference's (each package
   scans the other's log); checkpoints are atomic with keep-K GC; recovery
   from checkpoint + WAL tail reaches the reference's digest, and the
   checkpointed state holds no tensor (so it restores on any device).
3. **Isolation and degradation** through the serving front-end: a poisoned
   request is bisected into quarantine, transient faults retry with capped
   backoff, a failed flush commits no ids, seeded chaos plans replay.

The crash matrix (a worker killed at every site) is in
``tests/test_torch_crash.py``.
"""

from __future__ import annotations

import io
import json
import os
import pickle

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import faultcorpus  # noqa: E402
from repro import faults as ref_faults  # noqa: E402
from repro.checkpoint.checkpointer import Checkpointer as RefCheckpointer  # noqa: E402
from repro.checkpoint.checkpointer import _flatten as ref_flatten  # noqa: E402
from repro.stream.digest import state_digest as ref_digest  # noqa: E402
from repro.stream.wal import WriteAheadLog as RefWAL  # noqa: E402
from repro_torch import faults, obs  # noqa: E402
from repro_torch.checkpoint.checkpointer import Checkpointer, _flatten  # noqa: E402
from repro_torch.data.synthetic import SynthConfig, arrival_stream, make_dataset  # noqa: E402
from repro_torch.faults import (  # noqa: E402
    CRASH_EXIT_CODE,
    FaultPlan,
    InjectedFault,
    PoisonedRequest,
)
from repro_torch.stream import ResolveService, ServiceConfig  # noqa: E402
from repro_torch.stream.digest import state_digest  # noqa: E402
from repro_torch.stream.serving import AdmissionError, ServingConfig, ServingFrontend  # noqa: E402
from repro_torch.stream.wal import WriteAheadLog  # noqa: E402

SMP_SITES = ("lsh", "replay", "cover_splice", "rounds", "commit")
MMP_SITES = ("lsh", "replay", "cover_splice", "grounding_splice", "rounds", "commit")


@pytest.fixture(autouse=True)
def _clean_faults():
    faults.clear()
    yield
    faults.clear()


@pytest.fixture(scope="module")
def batches():
    """The fault corpus's schedule, made by the port's generator (the
    reference's own, equal batch for batch)."""
    ours = arrival_stream(make_dataset(SynthConfig.hepth(scale=0.02, seed=3)),
                          faultcorpus.N_BATCHES)
    theirs = faultcorpus.batches()
    assert len(ours) == len(theirs) == faultcorpus.N_BATCHES
    for a, b in zip(ours, theirs):
        assert a.names == b.names and list(a.ids) == list(b.ids)
        assert (a.edges is None) == (b.edges is None)
        assert a.edges is None or np.array_equal(a.edges, b.edges)
    return ours


@pytest.fixture(scope="module")
def base_digest_smp():
    return ref_digest(faultcorpus.run_uninterrupted("smp"))


@pytest.fixture(scope="module")
def base_digest_mmp():
    return ref_digest(faultcorpus.run_uninterrupted("mmp"))


def _svc(scheme="smp", **cfg) -> ResolveService:
    return ResolveService(ServiceConfig(scheme=scheme, **cfg), device="cpu")


def _ingest(svc, b):
    return svc.ingest(b.names, b.edges, ids=b.ids)


# ---------------------------------------------------------------------------
# The fault plans
# ---------------------------------------------------------------------------


def test_fault_plans_equal_the_reference():
    assert faults.SITES == ref_faults.SITES
    assert CRASH_EXIT_CODE == ref_faults.CRASH_EXIT_CODE == 117
    for seed in range(20):
        ours, theirs = FaultPlan.seeded(seed), ref_faults.FaultPlan.seeded(seed)
        assert ours.site_hits == theirs.site_hits
        assert ours.describe() == theirs.describe()
    plan = FaultPlan(site_hits={"rounds": {1, 3}}, crash=True, poison_names={"x", "a"})
    ref = ref_faults.FaultPlan(site_hits={"rounds": {1, 3}}, crash=True, poison_names={"x", "a"})
    assert plan.describe() == ref.describe() == "rounds@[1, 3],poison[rounds]=['a', 'x'] crash"
    with pytest.raises(ValueError, match="unknown fault site"):
        FaultPlan(site_hits={"nowhere": {1}})


def test_poison_fires_only_at_its_site_and_on_its_names():
    faults.install(FaultPlan(poison_names={"bad name"}, poison_site="commit"))
    faults.maybe_fail("rounds", ["bad name"])  # another site: passes
    faults.maybe_fail("commit", ["good name"])  # other names: pass
    faults.maybe_fail("commit")  # no names: passes
    with pytest.raises(PoisonedRequest, match="bad name"):
        faults.maybe_fail("commit", ["good name", "bad name"])


# ---------------------------------------------------------------------------
# 1. Transactional rollback: aborted ingest == never submitted
# ---------------------------------------------------------------------------


@pytest.mark.parametrize(
    "scheme,site", [("smp", s) for s in SMP_SITES] + [("mmp", s) for s in MMP_SITES],
)
def test_rollback_differential(scheme, site, batches, base_digest_smp, base_digest_mmp):
    """Abort batch 3 at every ingest site; the state must equal pre-submit
    exactly, and finishing the stream must reach the reference's digest."""
    svc = _svc(scheme)
    _ingest(svc, batches[0])
    _ingest(svc, batches[1])
    before = state_digest(svc)
    with faults.injected(FaultPlan.fail_once(site)):
        with pytest.raises(InjectedFault):
            _ingest(svc, batches[2])
    assert state_digest(svc) == before, f"rollback left residue at {site}"
    _ingest(svc, batches[2])
    _ingest(svc, batches[3])
    base = base_digest_smp if scheme == "smp" else base_digest_mmp
    assert state_digest(svc) == base, f"abort at {site} perturbed the stream"


@pytest.mark.parametrize("order", [[1, 0, 3, 2], [3, 2, 1, 0]])
def test_rollback_differential_permuted_schedule(order, batches):
    clean = _svc("smp")
    for i in order:
        _ingest(clean, batches[i])
    svc = _svc("smp")
    for k, i in enumerate(order):
        if k == 2:  # abort mid-schedule, then re-run the same batch
            before = state_digest(svc)
            with faults.injected(FaultPlan.fail_once("rounds")):
                with pytest.raises(InjectedFault):
                    _ingest(svc, batches[i])
            assert state_digest(svc) == before
        _ingest(svc, batches[i])
    assert state_digest(svc) == state_digest(clean)


@pytest.mark.parametrize("scheme", ["smp", "mmp"])
def test_rollback_differential_retraction_schedule(scheme):
    names, first, second = (faultcorpus.RESPLIT_NAMES, faultcorpus.RESPLIT_FIRST,
                            faultcorpus.RESPLIT_SECOND)
    clean = _svc(scheme)
    clean.ingest([names[i] for i in first], ids=first)
    clean.ingest([names[i] for i in second], ids=second)
    assert clean.reports[-1].n_invalidated > 0  # the retraction fired
    svc = _svc(scheme)
    svc.ingest([names[i] for i in first], ids=first)
    before = state_digest(svc)
    for site in ("cover_splice", "rounds", "commit"):
        with faults.injected(FaultPlan.fail_once(site)):
            with pytest.raises(InjectedFault):
                svc.ingest([names[i] for i in second], ids=second)
        assert state_digest(svc) == before, f"retraction rollback: {site}"
    svc.ingest([names[i] for i in second], ids=second)
    assert state_digest(svc) == state_digest(clean)


def test_rollback_on_natural_error(batches):
    svc = _svc("smp")
    _ingest(svc, batches[0])
    before = state_digest(svc)
    with pytest.raises(ValueError):
        _ingest(svc, batches[0])  # same ids again
    assert state_digest(svc) == before
    _ingest(svc, batches[1])  # stream continues cleanly


def test_wal_append_fault_rolls_back_and_recovers(tmp_path, batches):
    """A fault at the WAL append aborts before any state mutates; the
    consumed sequence number is a harmless gap on replay."""
    svc = _svc("smp", durability_dir=str(tmp_path))
    _ingest(svc, batches[0])
    before = state_digest(svc)
    with faults.injected(FaultPlan.fail_once("wal.append")):
        with pytest.raises(InjectedFault):
            _ingest(svc, batches[1])
    assert state_digest(svc) == before
    _ingest(svc, batches[1])
    svc.close()
    rec = ResolveService.recover(str(tmp_path), scheme="smp", device="cpu")
    assert state_digest(rec) == state_digest(svc)
    assert rec._seq == 3  # the gap (seq 2, never logged) is consumed too
    rec.close()


@pytest.mark.parametrize("site", ["ckpt.rename", "wal.rotate"])
def test_fault_after_the_commit_keeps_the_batch(site, tmp_path, batches, base_digest_mmp):
    """A fault in the checkpoint's rename or the WAL's rotation comes after
    the batch committed: ``ingest`` raises, the batch stays, no checkpoint
    is half-visible, and recovery gives the committed state — as in the
    reference, run the same way."""
    from repro.stream import ResolveService as RefService
    from repro.stream import ServiceConfig as RefConfig

    def run(svc, plans, digest, dur):
        _ingest(svc, batches[0])
        with plans.injected(plans.FaultPlan.fail_once(site)):
            with pytest.raises(Exception, match="injected fault"):
                _ingest(svc, batches[1])
        svc.close()
        return (digest(svc), svc._ckpt.all_steps(),
                sorted(p.name for p in (dur / "wal").iterdir()))

    port_dir, ref_dir = tmp_path / "port", tmp_path / "ref"
    got = run(_svc("mmp", durability_dir=str(port_dir), checkpoint_every=2), faults,
              state_digest, port_dir)
    want = run(RefService(RefConfig(scheme="mmp", durability_dir=str(ref_dir),
                                    checkpoint_every=2)), ref_faults, ref_digest, ref_dir)
    assert got == want
    assert got[1] == ([] if site == "ckpt.rename" else [2])
    rec = ResolveService.recover(str(port_dir), scheme="mmp", checkpoint_every=2, device="cpu")
    assert state_digest(rec) == got[0]
    for b in batches[rec._seq:]:
        _ingest(rec, b)
    assert state_digest(rec) == base_digest_mmp
    rec.close()


# ---------------------------------------------------------------------------
# 2. Durability: the WAL, the checkpointer, recovery
# ---------------------------------------------------------------------------


def test_wal_roundtrip_and_abort_markers(tmp_path):
    obs.reset()
    wal = WriteAheadLog(tmp_path)
    n = wal.append(1, ["a"], None, [0])
    wal.append(2, ["b"], np.array([[0, 1]], dtype=np.int64), [1])
    wal.append_abort(2)
    wal.append(3, ["c"], None, [2])
    wal.close()
    records, aborted = WriteAheadLog.scan(tmp_path)
    assert [r.seq for r in records] == [1, 2, 3]
    assert aborted == {2}
    assert records[1].names == ["b"]
    assert records[1].edges.tolist() == [[0, 1]]
    reg = obs.get_registry()
    assert reg.value("wal.appends") == 4 and reg.value("wal.bytes") >= 4 * n // 2


def test_wal_torn_tail_truncated(tmp_path):
    wal = WriteAheadLog(tmp_path)
    wal.append(1, ["a"], None, [0])
    wal.append(2, ["b"], None, [1])
    wal.close()
    seg = sorted(tmp_path.glob("wal-*.log"))[-1]
    good = seg.stat().st_size
    with open(seg, "ab") as f:  # a crash mid-append: garbage tail
        f.write(b"\xff" * 11)
    records, _ = WriteAheadLog.scan(tmp_path)
    assert [r.seq for r in records] == [1, 2]
    assert seg.stat().st_size == good  # scan repaired the tail
    wal = WriteAheadLog(tmp_path)  # and the log is appendable again
    wal.append(3, ["c"], None, [2])
    wal.close()
    records, _ = WriteAheadLog.scan(tmp_path)
    assert [r.seq for r in records] == [1, 2, 3]


def test_wal_rotate_gc(tmp_path):
    wal = WriteAheadLog(tmp_path)
    wal.append(1, ["a"], None, [0])
    wal.append(2, ["b"], None, [1])
    wal.rotate(3)
    wal.append(3, ["c"], None, [2])
    assert wal.gc(2) == 1  # the seq 1-2 segment is checkpoint-covered
    wal.close()
    records, _ = WriteAheadLog.scan(tmp_path)
    assert [r.seq for r in records] == [3]


def _write_log(wal_cls, directory):
    wal = wal_cls(directory, fsync=False)
    wal.append(1, ["ann lee", "a. lee"], np.array([[0, 1]], dtype=np.int64), [0, 1])
    wal.append(2, ["bo chen"], None, [2])
    wal.append_abort(2)
    wal.rotate(3)
    wal.append(3, ["c. diaz"], None, [7])
    wal.close()


@pytest.mark.parametrize("writer", ["port", "reference"])
def test_each_package_scans_the_others_log(writer, tmp_path):
    """The same appends give the same bytes, segment for segment, and each
    package's ``scan`` reads the other's log."""
    _write_log(WriteAheadLog, tmp_path / "port")
    _write_log(RefWAL, tmp_path / "reference")
    segs = {w: sorted((tmp_path / w).glob("wal-*.log")) for w in ("port", "reference")}
    assert [p.name for p in segs["port"]] == [p.name for p in segs["reference"]]
    for a, b in zip(segs["port"], segs["reference"]):
        assert a.read_bytes() == b.read_bytes()
    for reader in (WriteAheadLog, RefWAL):
        records, aborted = reader.scan(tmp_path / writer)
        assert [(r.seq, r.names, r.ids) for r in records] == [
            (1, ["ann lee", "a. lee"], [0, 1]), (2, ["bo chen"], [2]), (3, ["c. diaz"], [7])]
        assert records[0].edges.tolist() == [[0, 1]] and records[1].edges is None
        assert aborted == {2}


def _state(rng):
    return {"params": {"w": torch.as_tensor(rng.random((3, 4), dtype=np.float32)),
                       "b": np.arange(4, dtype=np.int32)},
            "layers": [np.ones(2, np.float32), (np.zeros(1), None)],
            "step": np.int64(7)}


def test_checkpoint_keys_equal_the_reference():
    """The flattening gives the reference's key strings (dict keys sorted,
    sequence indices, None empty)."""
    tree = _state(np.random.default_rng(0))
    ref_tree = {"params": {"w": tree["params"]["w"].numpy(), "b": tree["params"]["b"]},
                "layers": tree["layers"], "step": tree["step"]}
    ours, theirs = _flatten(tree), ref_flatten(ref_tree)
    assert list(ours) == list(theirs) == ["layers/0", "layers/1/0", "params/b", "params/w",
                                          "step"]
    for k in ours:
        assert np.array_equal(ours[k], theirs[k])


@pytest.mark.parametrize("async_save", [False, True])
def test_checkpointer_keep_k_and_restore(async_save, tmp_path):
    rng = np.random.default_rng(1)
    ck = Checkpointer(str(tmp_path), keep=2, async_save=async_save)
    states = {}
    for step in (1, 2, 3):
        states[step] = _state(rng)
        ck.save(step, {"s": states[step]}, meta={"step": step})
    ck.wait()
    assert ck.all_steps() == [2, 3] and ck.latest_step() == 3
    out = ck.restore(3, {"s": states[1]}, device="cpu")["s"]
    assert isinstance(out["params"]["w"], torch.Tensor) and out["params"]["w"].device.type == "cpu"
    assert torch.equal(out["params"]["w"], states[3]["params"]["w"])
    assert np.array_equal(out["params"]["b"].numpy(), states[3]["params"]["b"])
    assert isinstance(out["layers"][1], tuple) and out["layers"][1][1] is None
    flat, meta = ck.restore_raw(3)
    assert meta == {"step": 3} and sorted(flat) == sorted(f"s|{k}" for k in _flatten(states[3]))
    # the reference reads the port's checkpoint (the same files)
    ref_flat, ref_meta = RefCheckpointer(str(tmp_path), keep=2).restore_raw(3)
    assert ref_meta == meta and all(np.array_equal(ref_flat[k], flat[k]) for k in flat)


def test_checkpointer_refuses_bad_shapes_and_meshes(tmp_path):
    ck = Checkpointer(str(tmp_path))
    ck.save(1, {"s": {"w": np.zeros((2, 3), np.float32)}})
    with pytest.raises(ValueError, match="shape mismatch"):
        ck.restore(1, {"s": {"w": np.zeros((3, 2), np.float32)}}, device="cpu")
    with pytest.raises(ValueError, match="unsupported placement"):
        ck.restore(1, {"s": {"w": np.zeros((2, 3), np.float32)}}, device="cpu",
                   shardings={"s": None})
    # a mesh and its placements restore (sharded serving's elastic path)
    from torch.distributed.tensor import Shard

    from repro_torch.core.parallel import make_em_mesh

    got = ck.restore(1, {"s": {"w": np.zeros((2, 3), np.float32)}},
                     mesh=make_em_mesh(device="cpu"), shardings={"s": Shard(0)})
    assert torch.equal(got["s"]["w"], torch.zeros((2, 3)))


def test_checkpoint_rename_is_atomic(tmp_path):
    """A fault before the rename leaves a complete ``.tmp`` that never
    shadows the previous checkpoint; the next save replaces it."""
    ck = Checkpointer(str(tmp_path), keep=3)
    ck.save(1, {"s": {"w": np.ones(2)}})
    with faults.injected(FaultPlan.fail_once("ckpt.rename")):
        with pytest.raises(InjectedFault):
            ck.save(2, {"s": {"w": np.full(2, 2.0)}})
    assert ck.all_steps() == [1] and (tmp_path / "step_000000002.tmp").is_dir()
    manifest = json.loads((tmp_path / "step_000000002.tmp" / "manifest.json").read_text())
    assert manifest["step"] == 2 and manifest["keys"] == ["s|w"]
    ck.save(2, {"s": {"w": np.full(2, 2.0)}})
    assert ck.all_steps() == [1, 2] and not (tmp_path / "step_000000002.tmp").exists()
    assert ck.restore_raw(2)[0]["s|w"].tolist() == [2.0, 2.0]


def test_checkpoint_cadence_and_recovery(tmp_path, batches, base_digest_mmp):
    obs.reset()
    svc = _svc("mmp", durability_dir=str(tmp_path), checkpoint_every=2)
    for b in batches:
        _ingest(svc, b)
    want = state_digest(svc)
    assert want == base_digest_mmp
    svc.close()
    assert svc._ckpt.all_steps() == [2, 4]
    reg = obs.get_registry()
    assert reg.value("ckpt.saves") == 2 and reg.gauge("ckpt.last_seq").value == 4
    assert reg.value("ckpt.bytes") > 0 and reg.histogram("ckpt.save_ms").summary()["count"] == 2
    # the WAL was collected up to the last checkpoint
    assert [p.name for p in sorted((tmp_path / "wal").iterdir())] == ["wal-0000000000000005.log"]
    rec = ResolveService.recover(str(tmp_path), scheme="mmp", checkpoint_every=2, device="cpu")
    assert state_digest(rec) == want
    assert rec._seq == 4  # fresh ingests resume past the recovered tail
    assert reg.value("recover.replayed") == 0
    rec.close()


def test_wal_only_recovery(tmp_path, batches, base_digest_smp):
    obs.reset()
    svc = _svc("smp", durability_dir=str(tmp_path))
    for b in batches:
        _ingest(svc, b)
    svc.close()
    cfg = ServiceConfig(scheme="smp", durability_dir="ignored: recover sets it")
    rec = ResolveService.recover(str(tmp_path), cfg, device="cpu")
    assert state_digest(rec) == base_digest_smp
    assert obs.get_registry().value("recover.replayed") == len(batches)
    assert obs.get_registry().histogram("recover.wall_ms").summary()["count"] == 1
    rec.close()
    with pytest.raises(TypeError, match="not both"):
        ResolveService.recover(str(tmp_path), cfg, scheme="smp", device="cpu")


@pytest.mark.parametrize("parallel", [False, True])
def test_logical_state_holds_no_tensor(parallel, tmp_path, batches):
    """The checkpointed state pickles without any tensor (a pickler that
    refuses one), so a checkpoint written on one device restores on any."""

    class NoTensors(pickle.Pickler):
        def persistent_id(self, obj):
            if isinstance(obj, torch.Tensor):
                raise TypeError(f"a tensor in the logical state: {tuple(obj.shape)}")
            return None

    svc = _svc("mmp", parallel=parallel, durability_dir=str(tmp_path), checkpoint_every=2)
    for b in batches[:2]:
        _ingest(svc, b)
    NoTensors(io.BytesIO(), protocol=pickle.HIGHEST_PROTOCOL).dump(svc._logical_state())
    svc.close()
    rec = ResolveService.recover(str(tmp_path), scheme="mmp", parallel=parallel,
                                 checkpoint_every=2, device="cpu")
    assert rec.delta.device.type == "cpu" and rec.delta.index.device.type == "cpu"
    clean = _svc("mmp", parallel=parallel)
    for b in batches:
        _ingest(clean, b)
    for b in batches[2:]:
        _ingest(rec, b)
    assert state_digest(rec) == state_digest(clean)
    rec.close()


# ---------------------------------------------------------------------------
# 3. Poison isolation, retries, id commits, chaos
# ---------------------------------------------------------------------------


def test_poison_bisection_settles_innocents(batches):
    obs.reset()
    b = batches[0]
    bad = b.names[0]
    svc = _svc("smp")
    cfg = ServingConfig(max_batch=64, max_delay_ms=100.0, max_retries=1,
                        backoff_base_ms=0.1, backoff_max_ms=0.5)
    fe = ServingFrontend(svc, cfg, start=False)
    tickets = [fe.submit([nm]) for nm in b.names[:4]]
    faults.install(FaultPlan(poison_names={bad}, poison_site="rounds"))
    fe.start()
    assert fe.drain(timeout=60.0)
    with pytest.raises(PoisonedRequest):
        tickets[0].wait(timeout=10.0)
    reports = [t.wait(timeout=10.0) for t in tickets[1:]]
    assert all(r.new_matches >= 0 for r in reports)
    for t in tickets[1:]:
        assert t.ids is not None and len(t.ids) == 1
        assert fe.resolve(t.ids[0]) is not None
    assert tickets[0].ids is None  # the quarantined ticket never got ids
    reg = obs.get_registry()
    assert reg.value("serve.quarantined") == 1
    assert reg.value("serve.errors") == 1  # once per quarantine, not per try
    assert reg.value("serve.faults.bisections") >= 1
    faults.clear()
    fe.close()


def test_transient_fault_retries_to_success(batches):
    obs.reset()
    b = batches[0]
    svc = _svc("smp")
    cfg = ServingConfig(max_delay_ms=50.0, max_retries=3, backoff_base_ms=0.1,
                        backoff_max_ms=0.5)
    fe = ServingFrontend(svc, cfg, start=False)
    tickets = [fe.submit([nm]) for nm in b.names[:3]]
    faults.install(FaultPlan(site_hits={"rounds": {1, 2}}))
    fe.start()
    assert fe.drain(timeout=60.0)
    for t in tickets:
        t.wait(timeout=10.0)
    reg = obs.get_registry()
    assert reg.value("serve.retries") == 2
    assert reg.value("serve.faults.flush") == 2
    assert reg.value("serve.quarantined") == 0
    assert reg.value("serve.errors") == 0
    faults.clear()
    fe.close()


def test_backoff_is_capped_under_sustained_faults(batches):
    obs.reset()
    svc = _svc("smp")
    cfg = ServingConfig(max_delay_ms=10.0, max_retries=5, backoff_base_ms=1.0,
                        backoff_max_ms=3.0)
    fe = ServingFrontend(svc, cfg, start=False)
    ticket = fe.submit([batches[0].names[0]])
    faults.install(FaultPlan(site_hits={"rounds": frozenset(range(1, 50))}))
    fe.start()
    assert fe.drain(timeout=60.0)
    with pytest.raises(InjectedFault):
        ticket.wait(timeout=10.0)
    summ = obs.get_registry().histogram("serve.backoff_ms").summary()
    assert summ["count"] == 5
    assert summ["max"] <= 3.0  # the cap binds (uncapped would reach 16)
    assert obs.get_registry().value("serve.quarantined") == 1
    faults.clear()
    fe.close()


def test_failed_flush_commits_no_ids(batches):
    obs.reset()
    b = batches[0]
    svc = _svc("smp")
    fe = ServingFrontend(svc, ServingConfig(max_delay_ms=10.0, max_retries=0), start=False)
    doomed = fe.submit(list(b.names[:2]))
    faults.install(FaultPlan(site_hits={"rounds": frozenset(range(1, 50))}))
    fe.start()
    assert fe.drain(timeout=60.0)
    with pytest.raises(InjectedFault):
        doomed.wait(timeout=10.0)
    assert doomed.ids is None  # never committed
    assert fe._next_id == 0  # no id space burned
    faults.clear()
    ok = fe.submit(list(b.names[:2]))
    ok.wait(timeout=30.0)
    assert ok.ids == [0, 1]  # allocation starts where nothing happened
    fe.close()


def test_queue_depth_gauge_fresh_on_shed():
    obs.reset()
    svc = _svc("smp")
    fe = ServingFrontend(svc, ServingConfig(max_queue=1, admission="reject", max_delay_ms=0.0),
                         start=False)
    fe.submit(["a name"])
    with pytest.raises(AdmissionError):
        fe.submit(["b name"])
    reg = obs.get_registry()
    assert reg.gauge("serve.queue.depth").value == 1
    assert reg.value("serve.admission.shed") == 1
    fe.start()
    assert fe.drain(timeout=30.0)
    fe.close()


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_chaos_smoke_seeded(seed, batches, base_digest_smp):
    """A seeded plan (the reference's for the same seed): re-submitting any
    aborted batch reaches the reference's clean digest."""
    seed = int(os.environ.get("REPRO_CHAOS_SEED", seed))
    svc = _svc("smp")
    aborted = []
    faults.install(FaultPlan.seeded(seed))
    try:
        for i, b in enumerate(batches):
            try:
                _ingest(svc, b)
            except InjectedFault:
                aborted.append(i)
                _ingest(svc, b)  # immediate retry on rolled-back state
    finally:
        faults.clear()
    assert state_digest(svc) == base_digest_smp, f"seed {seed} (aborts at {aborted}) diverged"
