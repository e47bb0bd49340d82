"""The port's streaming service (``repro_torch.stream``) vs the reference's
(``repro.stream``), on the CPU.

The same seeded inputs go through both packages: MinHash signatures and
hash tables, the LSH index's buckets, the delta cover's per-ingest output,
the incremental global grounding, and whole ``ResolveService`` runs, whose
``state_digest`` must be equal after every ingest.  Everything compared
is integer or boolean state, so every comparison is exact.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core.mln import PAPER_LEARNED as REF_WEIGHTS  # noqa: E402
from repro.data.synthetic import arrival_stream  # noqa: E402
from repro.kernels.minhash import kernel as ref_kernel  # noqa: E402
from repro.kernels.minhash import ops as ref_mh_ops  # noqa: E402
from repro.kernels.minhash import ref as ref_mh  # noqa: E402
from repro.stream import ResolveService as RefService  # noqa: E402
from repro.stream import ServiceConfig as RefConfig  # noqa: E402
from repro.stream import delta as ref_delta  # noqa: E402
from repro.stream import index as ref_index  # noqa: E402
from repro.stream.digest import state_digest as ref_digest  # noqa: E402
from repro_torch import faults, interop  # noqa: E402
from repro_torch.core import pipeline  # noqa: E402
from repro_torch.core.cover import CoverDelta, assemble_cover, pack_cover  # noqa: E402
from repro_torch.core.driver import run_smp  # noqa: E402
from repro_torch.core.global_grounding import build_global_grounding  # noqa: E402
from repro_torch.core.mln import MLNMatcher  # noqa: E402
from repro_torch.data import synthetic  # noqa: E402
from repro_torch.kernels.minhash import ops as mh  # noqa: E402
from repro_torch.stream import ResolveService, ServiceConfig  # noqa: E402
from repro_torch.stream import delta as port_delta  # noqa: E402
from repro_torch.stream import index as port_index  # noqa: E402
from repro_torch.stream.digest import state_digest  # noqa: E402

INGEST_SITES = ("lsh", "replay", "cover_splice", "grounding_splice", "rounds", "commit")
# (scheme, batches, arrival order): in order, and permuted (holes in the id space)
SCHEDULES = {
    "smp": ("smp", 4, None),
    "mmp": ("mmp", 4, None),
    "smp-permuted": ("smp", 5, [2, 0, 4, 1, 3]),
    "mmp-permuted": ("mmp", 5, [2, 0, 4, 1, 3]),
}


def _presence(rng, N, D, density=9 / 512):
    x = rng.random((N, D)) < density
    x[[0, N // 2, N - 1]] = False  # rows with no shingle give EMPTY
    return x.astype(np.float32)


def _port_config(scheme: str) -> ServiceConfig:
    weights = interop.weights_from_numpy(REF_WEIGHTS.w_sim, REF_WEIGHTS.w_co)
    return ServiceConfig(scheme=scheme, weights=weights)


def _batches(hepth_small, n, order):
    batches = arrival_stream(hepth_small, n)
    return [batches[i] for i in (order if order is not None else range(len(batches)))]


# ---------------------------------------------------------------------------
# minhash: plain version vs the jnp oracle and the Pallas kernel
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("N,H,D", [(1, 128, 512), (67, 128, 512), (5, 8, 40)])
def test_minhash_plain_equals_reference(N, H, D):
    rng = np.random.default_rng(N * 1000 + D)
    X = _presence(rng, N, D, density=9 / 512 if D == 512 else 0.2)
    A = ref_mh_ops.hash_table(H, D, seed=N)
    want = np.asarray(ref_mh.minhash(X, A))
    got = mh.minhash_plain(torch.as_tensor(X), torch.as_tensor(A))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    assert (want[0] == mh.EMPTY).all() and (want[-1] == mh.EMPTY).all()


# chip_smoke.py's phase-2 shapes: one row, the schedule's largest batch,
# the per-ingest call, a ragged table, and a D that is not a multiple of 4
MINHASH_SHAPES = [(1, 128, 512), (67, 128, 512), (5, 8, 40), (64, 128, 512), (9, 33, 70)]


@pytest.mark.parametrize("N,H,D", MINHASH_SHAPES)
def test_minhash_plain_equals_pallas_interpret(N, H, D):
    rng = np.random.default_rng(N * 7 + D)
    X = _presence(rng, N, D, density=9 / 512 if D == 512 else 0.2)
    A = ref_mh_ops.hash_table(H, D, seed=N + 1)
    want = np.asarray(ref_kernel.minhash(X, A, interpret=True))
    got = mh.minhash(torch.as_tensor(X), torch.as_tensor(A))  # CPU: the plain version
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("N,H,D", MINHASH_SHAPES)
def test_minhash_transposed_equals_pallas_interpret(N, H, D):
    """The entry the streaming index takes, fed the table stored (D, H)."""
    rng = np.random.default_rng(N * 11 + D)
    X = _presence(rng, N, D, density=9 / 512 if D == 512 else 0.2)
    A = ref_mh_ops.hash_table(H, D, seed=N + 2)
    want = np.asarray(ref_kernel.minhash(X, A, interpret=True))
    At = torch.as_tensor(np.ascontiguousarray(A.T))
    got = mh.minhash_transposed(torch.as_tensor(X), At)  # CPU: the plain version
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


def test_minhash_plain_chunks_large_batches():
    """More rows than one step of the plain version holds: same result as
    one row at a time."""
    rng = np.random.default_rng(3)
    X = torch.as_tensor(_presence(rng, 1100, 64, density=0.1))
    A = torch.as_tensor(mh.hash_table(16, 64, seed=3))
    rows = torch.cat([mh.minhash_plain(X[i : i + 1], A) for i in range(0, 1100, 97)])
    np.testing.assert_array_equal(mh.minhash_plain(X, A)[::97].numpy(), rows.numpy())


@pytest.mark.parametrize("seed", [0, 1, 7])
def test_hash_table_byte_identical(seed):
    want = ref_mh_ops.hash_table(128, 512, seed=seed)
    got = mh.hash_table(128, 512, seed=seed)
    assert got.dtype == want.dtype and got.tobytes() == want.tobytes()


def test_shingle_presence_identical(hepth_small):
    names = list(hepth_small.entities.names)
    want = ref_index.shingle_presence(names, 512)
    got = port_index.shingle_presence(names, 512)
    assert got.dtype == want.dtype and got.tobytes() == want.tobytes()


# ---------------------------------------------------------------------------
# MinHashLSHIndex: signatures and every bucket, unbounded and bounded
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("bound", [{}, {"max_ids": 40}, {"ttl_adds": 2}])
def test_lsh_index_identical(hepth_small, bound):
    ref = ref_index.MinHashLSHIndex(ref_index.LSHConfig(**bound))
    port = port_index.MinHashLSHIndex(port_index.LSHConfig(**bound), device="cpu")
    assert port.table.tobytes() == ref.table.tobytes()
    for b in arrival_stream(hepth_small, 5):
        ids = [int(i) for i in b.ids]
        s_ref, s_port = ref.add(ids, b.names), port.add(ids, b.names)
        np.testing.assert_array_equal(s_port, s_ref)
        assert port.buckets == ref.buckets
        assert (port.n_indexed, port.n_evicted, port.n_adds) == (
            ref.n_indexed, ref.n_evicted, ref.n_adds)
        assert port.query(s_port) == ref.query(s_ref)


# ---------------------------------------------------------------------------
# DeltaCover: cover, packed bins, row keys and the per-ingest delta
# ---------------------------------------------------------------------------


def _assert_same_delta(rp, rr):
    assert len(rp.cover) == len(rr.cover)
    for a, b in zip(rp.cover.core + rp.cover.full, rr.cover.core + rr.cover.full):
        np.testing.assert_array_equal(a, b)
    pp, pr = rp.packed, rr.packed
    assert sorted(pp.bins) == sorted(pr.bins)
    for k, nb in pr.bins.items():
        for f in interop.BATCH_FIELDS:
            a, b = getattr(pp.bins[k], f), getattr(nb, f)
            assert a.dtype == b.dtype, (k, f)
            np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(pp.bin_rows[k], pr.bin_rows[k])
    np.testing.assert_array_equal(pp.neighborhood_bin, pr.neighborhood_bin)
    np.testing.assert_array_equal(pp.neighborhood_row, pr.neighborhood_row)
    assert pp.pair_levels == pr.pair_levels
    assert pp.row_keys == pr.row_keys
    assert rp.dirty == rr.dirty
    assert rp.added_pairs == rr.added_pairs
    assert rp.retracted_pairs == rr.retracted_pairs
    assert (rp.replay_visits, rp.cover_splice_rows) == (rr.replay_visits, rr.cover_splice_rows)


@pytest.mark.parametrize("schedule", [(4, None), (5, [2, 0, 4, 1, 3])])
def test_delta_cover_identical_every_ingest(hepth_small, schedule):
    ref = ref_delta.DeltaCover()
    port = port_delta.DeltaCover(device="cpu")
    for b in _batches(hepth_small, *schedule):
        ids = [int(i) for i in b.ids]
        rr = ref.ingest(ids, list(b.names), b.edges)
        rp = port.ingest(ids, list(b.names), b.edges)
        _assert_same_delta(rp, rr)
        assert port.sim_adj.keys() == ref.sim_adj.keys()


def _same_packed(a, b) -> bool:
    return (
        sorted(a.bins) == sorted(b.bins)
        and all(
            np.array_equal(getattr(a.bins[k], f), getattr(b.bins[k], f))
            for k in b.bins for f in interop.BATCH_FIELDS
        )
        and all(np.array_equal(a.bin_rows[k], b.bin_rows[k]) for k in b.bins)
        and np.array_equal(a.neighborhood_bin, b.neighborhood_bin)
        and np.array_equal(a.neighborhood_row, b.neighborhood_row)
        and a.pair_levels == b.pair_levels
    )


def test_port_splice_equals_port_scratch_every_ingest(hepth_small):
    """Inside the port: the localized replay equals the full sweep, the
    spliced cover equals the scratch ``assemble_cover`` + ``pack_cover``,
    the same splice driven through their ``delta=`` / ``prev=`` entry
    points gives it too, and the maintained grounding equals
    ``build_global_grounding``, after every ingest of a permuted schedule."""
    svc = ResolveService(_port_config("mmp"), device="cpu")
    d = svc.delta
    twin, twin_packed, twin_levels = CoverDelta(), None, {}
    for b in _batches(hepth_small, 5, [2, 0, 4, 1, 3]):
        svc.ingest(b.names, b.edges, ids=b.ids)
        canopies = d.canopies()
        assert all(np.array_equal(a, c) for a, c in zip(canopies, d._canopies_full()))
        assert len(canopies) == len(d._canopies_full())
        entities, relations = d.entities(), d.relations()
        scratch = pack_cover(
            assemble_cover(canopies, entities, relations, present=d.present),
            entities, relations,
        )
        assert _same_packed(d.packed, scratch)
        touched = set(d._last_region) | {int(e) for e in np.asarray(b.edges).reshape(-1)}
        cover = assemble_cover(
            canopies, entities, relations, present=d.present, delta=twin,
            seeds=sorted(d._canopy_cache), touched=touched,
            new_ids=[int(i) for i in b.ids], new_edges=b.edges if len(b.edges) else None,
        )
        twin_packed = pack_cover(
            cover, entities, relations, delta=twin, prev=twin_packed, level_cache=twin_levels,
        )
        assert _same_packed(twin_packed, d.packed)
        assert twin_packed.row_keys == d.packed.row_keys
        want = build_global_grounding(d.packed.pair_levels, relations, svc.weights)
        got = svc.grounding.grounding()
        for f in ("gids", "u", "coup_p", "coup_q"):
            np.testing.assert_array_equal(getattr(got, f), getattr(want, f))


# ---------------------------------------------------------------------------
# Whole services: digests, reports and groundings after every ingest
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def service_runs(hepth_small):
    """Per schedule: per ingest (ref digest, port digest, ref report, port
    report, ref grounding arrays, port grounding arrays), and both services."""
    out = {}
    for name, (scheme, n, order) in SCHEDULES.items():
        ref = RefService(RefConfig(scheme=scheme))
        port = ResolveService(_port_config(scheme), device="cpu")
        steps = []
        for b in _batches(hepth_small, n, order):
            rep_r = ref.ingest(b.names, b.edges, ids=b.ids)
            rep_p = port.ingest(b.names, b.edges, ids=b.ids)
            gg = [None, None]
            if scheme == "mmp":
                gg = [dataclasses.astuple(s.grounding.grounding())[:5] for s in (ref, port)]
            steps.append((ref_digest(ref), state_digest(port), rep_r, rep_p, *gg))
        out[name] = (steps, ref, port)
    return out


@pytest.mark.parametrize("schedule", SCHEDULES)
def test_service_state_digest_equals_reference_every_ingest(service_runs, schedule):
    steps, _, _ = service_runs[schedule]
    digests = [(d_ref, d_port) for d_ref, d_port, *_ in steps]
    assert all(a == b for a, b in digests), digests
    assert len({d for d, _ in digests}) == len(digests)  # every ingest changed the state


@pytest.mark.parametrize("schedule", SCHEDULES)
def test_service_ingest_reports_equal_reference(service_runs, schedule):
    steps, _, _ = service_runs[schedule]
    for _, _, rep_r, rep_p, *_ in steps:
        want = {k: v for k, v in dataclasses.asdict(rep_r).items() if k != "wall_time_s"}
        got = {k: v for k, v in dataclasses.asdict(rep_p).items() if k != "wall_time_s"}
        assert got == want
        assert rep_p.wall_time_s > 0


def test_grounding_maintainer_identical_every_ingest(service_runs):
    steps, _, _ = service_runs["mmp"]
    for *_, gg_ref, gg_port in steps:
        for a, b in zip(gg_port[:4], gg_ref[:4]):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)
        assert gg_port[4] == gg_ref[4]


@pytest.mark.parametrize("schedule", SCHEDULES)
def test_service_reads_equal_reference(service_runs, schedule):
    _, ref, port = service_runs[schedule]
    assert port.matches.as_set() == ref.matches.as_set()
    assert sorted(map(tuple, port.clusters())) == sorted(map(tuple, ref.clusters()))
    ids = list(range(port.delta.n_entities)) + [10**6]
    for a, b in zip(port.resolve_many(ids), ref.resolve_many(ids)):
        np.testing.assert_array_equal(a, b)
    assert port.snapshot().n_ingests == ref.snapshot().n_ingests


def test_stream_equals_batch_in_the_port(service_runs, hepth_small):
    """On hepth_small, as the reference's own test asserts, the streamed
    fixpoint is the port's batch ``run_smp`` on the union."""
    ds = synthetic.make_dataset(synthetic.SynthConfig.hepth(scale=0.035, seed=7))
    packed, _, _ = pipeline.prepare(ds.entities, ds.relations, device="cpu")
    batch = run_smp(packed, MLNMatcher(device="cpu"))
    for name in ("smp", "smp-permuted"):
        _, _, port = service_runs[name]
        assert port.matches.as_set() == batch.matches.as_set()


# ---------------------------------------------------------------------------
# Rollback: an ingest that fails at any stage leaves no trace
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("site", INGEST_SITES)
def test_rollback_at_every_ingest_site(hepth_small, service_runs, site):
    """The failing batch fills holes in the id space (arrivals out of
    order), so the rollback must restore entries, not only lengths."""
    assert set(INGEST_SITES) <= set(faults.SITES)
    scheme, n, order = SCHEDULES["mmp-permuted"]
    batches = _batches(hepth_small, n, order)
    svc = ResolveService(_port_config(scheme), device="cpu")
    for b in batches[:3]:
        svc.ingest(b.names, b.edges, ids=b.ids)
    before = state_digest(svc)
    b = batches[3]
    with faults.injected(faults.FaultPlan.fail_once(site)):
        with pytest.raises(faults.InjectedFault, match=site):
            svc.ingest(b.names, b.edges, ids=b.ids)
    assert state_digest(svc) == before
    assert len(svc.reports) == 3
    # the same batch then commits, to the reference's state
    svc.ingest(b.names, b.edges, ids=b.ids)
    steps, _, _ = service_runs["mmp-permuted"]
    assert state_digest(svc) == steps[3][0]


def test_deprecated_kwargs_shim():
    """The reference's keyword constructor still works, with a warning."""
    with pytest.warns(DeprecationWarning):
        svc = ResolveService(scheme="mmp", device="cpu")
    assert svc.config.scheme == "mmp" and svc.grounding is not None
    with pytest.raises(TypeError):
        ResolveService(ServiceConfig(), scheme="smp", device="cpu")
