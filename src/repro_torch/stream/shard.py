"""Sharded serving coordinator: one service replica a rank.

The paper's decomposition maps onto a ``torch.distributed`` group of
ranks with no new algorithm: bins are the neighborhoods, so splitting
each bin's rows over the ranks partitions the neighborhoods across
processes, and the OR-reduced match bitset of :mod:`repro_torch.core.parallel`
*is* the cross-process boundary-message pass.  What this module adds is
the serving topology around that engine:

* **Replicated logical state.**  Every rank runs the same
  ``ResolveService`` and ingests every micro-batch in the same order.
  Host-side maintenance (canopy replay, cover splice, union-find) is
  deterministic, so the logical state stays bit for bit identical on
  every rank; :func:`repro_torch.stream.digest.state_digest` is the
  machine-checked witness.  Only the LSH bucket map and the bin rounds
  are partitioned.

* **Partitioned LSH bucket map.**  Each rank stores and probes only the
  buckets :func:`repro_torch.launch.sharding.bucket_shard` assigns to it
  (a deterministic FNV hash — routing needs no directory), and each
  probe's candidate set is put back together by a cross-rank union
  (:class:`repro_torch.launch.sharding.ShardMerger`).  The partition is
  exhaustive and disjoint, and the probe sorts the union, so the
  candidate sets — and everything downstream — are the unsharded ones.

* **Partitioned bin rounds.**  The engine gets the service mesh;
  ``run_parallel`` splits every bin's rows over it (rows padded to a
  multiple of the rank count) and ORs each round's matches over the
  ranks.

Equivalence argument, in one line: the sharded run makes the same
deterministic host schedule on every rank, and every partitioned step
(bucket probe, bin round) puts its exact unsharded result back together
before any state depends on it — so the fixpoint is bit for bit the
single-process one (Thms. 2/4 make the fixpoint schedule-invariant in
the first place; here even the schedule is identical).
"""

from __future__ import annotations

import dataclasses
import hashlib

import numpy as np

from repro_torch.launch.mesh import EMMesh
from repro_torch.launch.sharding import ShardMerger, ShardSpec


@dataclasses.dataclass(frozen=True)
class ShardContext:
    """This rank's view of the sharded serving topology.

    ``spec`` partitions the LSH bucket map, ``mesh`` the bin rows,
    ``merger`` unites probe candidate sets.  On a one-rank mesh every
    component is the identity: ``spec`` owns every bucket,
    ``merger.union`` is a no-op and the mesh makes no collective — so a
    one-shard service is the unsharded service.
    """

    mesh: EMMesh
    spec: ShardSpec
    merger: ShardMerger

    @classmethod
    def create(cls, n_shards: int | None = None, device=None) -> "ShardContext":
        """Build the context for this process on its device (``None``:
        ``cuda:{local_rank % device_count}``; ``"cpu"`` for the CPU).

        Joins the ``torch.distributed`` group first when the
        ``REPRO_SHARD_COORD`` environment is set (see
        :func:`repro_torch.launch.mesh.init_em_distributed`), then takes
        the mesh over every rank.
        """
        from repro_torch.launch.mesh import em_service_mesh, init_em_distributed

        init_em_distributed(device=device)
        mesh = em_service_mesh(n_shards, device=device)
        spec = ShardSpec(n_shards=mesh.size, shard_id=mesh.rank)
        return cls(mesh=mesh, spec=spec, merger=ShardMerger(mesh))

    @property
    def n_shards(self) -> int:
        return self.spec.n_shards

    @property
    def shard_id(self) -> int:
        return self.spec.shard_id


class ShardCoordinator:
    """Thin ingest router over one rank's :class:`ResolveService`.

    Construction wires the shard context through the service: the LSH
    index gets the bucket partition and the merge hook, the engine the
    mesh.  ``ingest`` routes a micro-batch into the local replica (every
    rank calls it with the same batch — the probe union and the rounds'
    reductions are the synchronization points), and
    ``digest``/``digests_agree`` expose the equivalence oracle.
    """

    def __init__(self, ctx: ShardContext | None = None, config=None,
                 **service_kwargs):
        """``config`` is a :class:`repro_torch.stream.service.ServiceConfig`;
        bare service keywords still work as a deprecated shim.  The
        service runs on the context's device."""
        import warnings

        from repro_torch.stream.service import ResolveService, ServiceConfig

        self.ctx = ctx if ctx is not None else ShardContext.create()
        if service_kwargs:
            if config is not None:
                raise TypeError(
                    "pass either config= or service keywords, not both "
                    f"(got {sorted(service_kwargs)})"
                )
            warnings.warn(
                "ShardCoordinator(**service_kwargs) is deprecated; pass "
                "ShardCoordinator(ctx, config=ServiceConfig(...)) instead",
                DeprecationWarning,
                stacklevel=2,
            )
            config = ServiceConfig(**service_kwargs)
        self.service = ResolveService(config, shard=self.ctx)

    def ingest(self, names, edges=None, **kwargs):
        """Route one micro-batch to the owning shards.

        Ownership is per LSH bucket, and an arrival's buckets are spread
        across ranks by the FNV partition — so every ingest touches every
        rank.  All ranks MUST ingest the same batches in the same order:
        the probe union and the round reductions are collectives.
        """
        return self.service.ingest(names, edges, **kwargs)

    def resolve(self, entity_id: int):
        return self.service.resolve(entity_id)

    def snapshot(self):
        return self.service.snapshot()

    def digest(self) -> str:
        from repro_torch.stream.digest import state_digest

        return state_digest(self.service)

    def digests_agree(self) -> bool:
        """Cross-rank check that every replica holds the same state.

        All-gathers the 32-byte state digest over the mesh; on a one-rank
        context this is trivially True.
        """
        raw = hashlib.sha256(self.digest().encode()).digest()
        local = np.frombuffer(raw, dtype=np.uint8).copy()
        return all(np.array_equal(g, local) for g in self.merged_digests(local))

    def merged_digests(self, local: np.ndarray) -> list[np.ndarray]:
        """Every rank's ``local``, in rank order."""
        return list(self.ctx.mesh.host_gather(local.astype(np.uint8), "digest"))
