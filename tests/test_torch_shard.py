"""Sharded serving in one process: the port against ``repro`` on the CPU.

The bucket partition, the partitioned LSH index, the one-rank shard
context, ``run_parallel`` on a one-rank mesh, the checkpoint restore
under DTensor placements and ``launch.serve --em``.  The runs across
processes (N gloo ranks) are in ``test_torch_shard_mesh.py``.
"""

from __future__ import annotations

import re

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.data.synthetic import SynthConfig as RefSynthConfig  # noqa: E402
from repro.data.synthetic import arrival_stream as ref_arrival_stream  # noqa: E402
from repro.data.synthetic import make_dataset as ref_make_dataset  # noqa: E402
from repro.launch import sharding as ref_sharding  # noqa: E402
from repro.stream import index as ref_index  # noqa: E402
from repro.stream.digest import state_digest as ref_digest  # noqa: E402
from repro_torch.data.synthetic import SynthConfig, make_dataset  # noqa: E402
from repro_torch.launch import mesh as port_mesh  # noqa: E402
from repro_torch.launch.sharding import ShardSpec, bucket_shard  # noqa: E402
from repro_torch.stream import index as port_index  # noqa: E402

CPU = torch.device("cpu")


def test_bucket_shard_bit_identical_to_reference():
    rng = np.random.default_rng(0)
    keys = [
        (int(b), tuple(int(v) for v in rng.integers(0, 1 << 31, size=2)))
        for b in rng.integers(0, 64, size=512)
    ]
    for n in (1, 2, 4):
        owners = [bucket_shard(b, k, n) for b, k in keys]
        assert owners == [ref_sharding.bucket_shard(b, k, n) for b, k in keys]
        specs = [ShardSpec(n, i) for i in range(n)]
        for (b, k), o in zip(keys, owners):
            # exhaustive + disjoint: exactly one shard owns each bucket
            assert [s.owns(b, k) for s in specs] == [i == o for i in range(n)]
    assert len({bucket_shard(b, k, 4) for b, k in keys}) == 4


@pytest.mark.parametrize("n, i", [(2, 2), (0, 0), (4, -1)])
def test_shard_spec_validation(n, i):
    with pytest.raises(ValueError, match="invalid shard spec"):
        ShardSpec(n_shards=n, shard_id=i)
    with pytest.raises(ValueError, match="invalid shard spec"):
        ref_sharding.ShardSpec(n_shards=n, shard_id=i)


def test_partitioned_index_union_equals_unsharded_and_reference():
    """N bucket-partitioned port indexes, answers united in process, give
    the unsharded port index's and the reference index's answer."""
    ds = make_dataset(SynthConfig.hepth(scale=0.02, seed=3))
    ids = list(range(len(ds.entities.names)))
    names = list(ds.entities.names)
    cfg = port_index.LSHConfig()
    base = port_index.MinHashLSHIndex(cfg, device="cpu")
    base.add(ids, names)
    ref = ref_index.MinHashLSHIndex(ref_index.LSHConfig())
    ref.add(ids, names)
    probe = base.signatures(names[:17])
    expect = base.query(probe)
    assert expect == ref.query(ref.signatures(names[:17]))
    for n in (2, 4):
        replicas = [port_index.MinHashLSHIndex(cfg, shard=ShardSpec(n, i), device="cpu")
                    for i in range(n)]
        for rep in replicas:
            rep.add(ids, names)
        for b in range(cfg.num_bands):
            # the bucket maps are disjoint slices of the unsharded map
            keys = [set(rep.buckets[b]) for rep in replicas]
            assert sum(map(len, keys)) == len(set().union(*keys))
            assert set().union(*keys) == set(base.buckets[b])
        assert set().union(*(rep.query(probe) for rep in replicas)) == expect
        # the merge hook sees each rank's local answer on every query
        seen = []
        merged = port_index.MinHashLSHIndex(
            cfg, shard=ShardSpec(n, 0), device="cpu",
            merge=lambda s: seen.append(set(s)) or set(expect),
        )
        merged.add(ids, names)
        assert merged.query(probe, exclude={0}) == expect - {0}
        assert seen == [replicas[0].query(probe)]


def test_one_rank_context_is_the_identity():
    """A one-rank ShardContext: every bucket owned, the union a no-op, and
    the ShardCoordinator's digest that of the plain port service and of
    the reference's service."""
    from repro.stream.service import ResolveService as RefService
    from repro.stream.service import ServiceConfig as RefConfig
    from repro_torch.stream import ResolveService, ServiceConfig
    from repro_torch.stream.digest import state_digest
    from repro_torch.stream.shard import ShardContext, ShardCoordinator

    ctx = ShardContext.create(device="cpu")
    assert (ctx.n_shards, ctx.shard_id, ctx.mesh.backend) == (1, 0, "local")
    assert ctx.spec.owns(0, (1, 2)) and ctx.merger.union({3, 5}) == {3, 5}
    assert ctx.merger.merges == 0

    plain = ResolveService(ServiceConfig(scheme="smp", parallel=True), device="cpu")
    coord = ShardCoordinator(ctx, config=ServiceConfig(scheme="smp", parallel=True))
    with pytest.warns(DeprecationWarning, match="ShardCoordinator"):
        shim = ShardCoordinator(ctx, scheme="smp", parallel=True)
    ref = RefService(RefConfig(scheme="smp", parallel=True))
    for b in ref_arrival_stream(ref_make_dataset(RefSynthConfig.hepth(scale=0.02, seed=3)), 3):
        for svc in (plain, coord, shim, ref):
            svc.ingest(list(b.names), b.edges)
    assert coord.digest() == state_digest(plain) == ref_digest(ref) == shim.digest()
    assert coord.digests_agree()
    assert coord.service.device == CPU and coord.service.engine.mesh is ctx.mesh
    assert np.array_equal(coord.resolve(0), plain.resolve(0))
    assert coord.snapshot().n_ingests == 3


def test_run_parallel_on_a_one_rank_mesh_gives_the_gids_of_no_mesh():
    from repro_torch.core import pipeline
    from repro_torch.core.mln import MLNMatcher
    from repro_torch.core.parallel import make_em_mesh, run_parallel

    ds = make_dataset(SynthConfig.hepth(scale=0.035, seed=7))
    packed, gg, _ = pipeline.prepare(ds.entities, ds.relations, k_max=16, device="cpu")
    m = MLNMatcher(device="cpu")
    mesh = make_em_mesh(device="cpu")
    for scheme in ("smp", "mmp"):
        for fused in (True, False):
            a = run_parallel(packed, m, gg, scheme=scheme, mesh=mesh, device="cpu",
                             fused=fused)
            b = run_parallel(packed, m, gg, scheme=scheme, device="cpu", fused=fused)
            assert np.array_equal(a.matches.gids, b.matches.gids)
            assert (a.neighborhood_evals, a.rounds, a.history) == (
                b.neighborhood_evals, b.rounds, b.history)
    assert mesh.stats == {}  # one rank: no collective
    with pytest.raises(ValueError, match="2 processes"):
        make_em_mesh(2, device="cpu")


def _fake_mesh(size: int, rank: int) -> port_mesh.EMMesh:
    """A rank of a ``size``-rank mesh without a group: enough for the
    placements, which make no collective."""
    return port_mesh.EMMesh(size=size, rank=rank, device=CPU, backend="gloo")


def test_checkpoint_restore_under_placements(tmp_path):
    """``Shard(0)`` on a one-rank mesh gives the whole array (the
    reference's elastic restore); on a wider mesh each rank its slice,
    the axis padded to a multiple of the rank count; ``Replicate()``
    the whole array everywhere."""
    from torch.distributed.tensor import Replicate, Shard

    from repro.checkpoint.checkpointer import Checkpointer as RefCheckpointer
    from repro_torch.checkpoint.checkpointer import Checkpointer
    from repro_torch.core.parallel import make_em_mesh

    ck = Checkpointer(str(tmp_path))
    w = np.arange(64, dtype=np.float32).reshape(8, 8)
    b = np.arange(5, dtype=np.int32)
    ck.save(3, {"w": w, "s": {"b": b, "w": w}})
    got = ck.restore(3, {"w": np.zeros((8, 8), np.float32)}, mesh=make_em_mesh(device="cpu"),
                     shardings={"w": Shard(0)})
    assert torch.equal(got["w"], torch.as_tensor(w))
    ref = RefCheckpointer(str(tmp_path)).restore(3, {"w": np.zeros((8, 8), np.float32)})
    np.testing.assert_array_equal(np.asarray(ref["w"]), got["w"].numpy())
    tmpl = {"s": {"b": np.zeros(5, np.int32), "w": np.zeros((8, 8), np.float32)}}
    for rank, rows in enumerate([slice(0, 3), slice(3, 5)]):
        out = ck.restore(3, tmpl, mesh=_fake_mesh(2, rank),
                         shardings={"s": {"b": Shard(0), "w": Replicate()}})
        assert torch.equal(out["s"]["b"], torch.as_tensor(b[rows]))
        assert torch.equal(out["s"]["w"], torch.as_tensor(w))
    cols = ck.restore(3, {"w": w}, mesh=_fake_mesh(4, 3), shardings={"w": Shard(1)})
    assert torch.equal(cols["w"], torch.as_tensor(w[:, 6:8]))
    with pytest.raises(ValueError, match="placement"):
        ck.restore(3, {"w": w}, device="cpu", shardings={"w": "rows"})


def test_row_slices_pad_to_the_rank_count():
    slices = [_fake_mesh(4, r).row_slice(10) for r in range(4)]
    assert slices == [(0, 3), (3, 6), (6, 9), (9, 10)]
    assert [_fake_mesh(4, r).row_slice(2) for r in range(4)] == [(0, 1), (1, 2), (2, 2), (2, 2)]
    assert _fake_mesh(1, 0).row_slice(7) == (0, 7)


def test_backend_rule():
    cuda = torch.device("cuda", 0)
    assert port_mesh.choose_backend(CPU, 4) == "gloo"
    assert port_mesh.choose_backend(cuda, 4, n_devices=4) == "nccl"  # a card each
    assert port_mesh.choose_backend(cuda, 2, n_devices=1) == "gloo"  # ranks share a card
    with pytest.raises(RuntimeError, match="no CUDA device"):
        port_mesh.choose_backend(cuda, 2, n_devices=0)
    with pytest.raises(ValueError, match="no collective backend"):
        port_mesh.choose_backend(torch.device("meta"), 2)


def test_no_coordinator_joins_nothing(monkeypatch):
    import torch.distributed as dist

    monkeypatch.delenv("REPRO_SHARD_COORD", raising=False)
    assert port_mesh.init_em_distributed(device="cpu") is False
    assert not (dist.is_available() and dist.is_initialized())


def test_serve_em_prints_the_reference_line(capsys):
    from repro.launch import serve as ref_serve
    from repro_torch.launch import serve

    argv = ["--em", "--scale", "0.02", "--batches", "3"]
    digest = serve.main([*argv, "--device", "cpu"])
    line = capsys.readouterr().out.strip().splitlines()[-1]
    shape = (r"shard 0/1: (\d+) refs in [\d.]+s \([\d.]+ refs/s\), (\d+) clusters, "
             r"digest ([0-9a-f]{12}) \(replicas agree\)")
    got = re.fullmatch(shape, line)
    assert got and got.group(3) == digest[:12]
    with pytest.warns(DeprecationWarning):
        ref_serve.em_main(argv)
    want = re.fullmatch(shape, capsys.readouterr().out.strip().splitlines()[-1])
    assert want and want.groups() == got.groups()
