"""Rank worker for the port's sharded-equivalence battery.

Usage: ``python torch_shard_worker.py JOB [JOB ...]`` with each ``JOB``
one of

* ``hepth:<scheme>:<perm_seed>`` — stream ``SynthConfig.hepth(scale=0.02,
  seed=3)`` in 3 batches through a
  :class:`~repro_torch.stream.shard.ShardCoordinator` (``parallel=True``);
  ``perm_seed`` -1 keeps arrival order, otherwise it seeds a permutation
  of the batches (ids preserved through ``ingest(..., ids=...)``);
* ``lattice:<scheme>[:legacy]`` — ``run_parallel`` on the evidence
  lattice ``make_lattice_cover(depth=6, width=4)`` over the rank mesh
  (``legacy``: ``fused=False``).

The topology comes from ``REPRO_SHARD_COORD`` / ``REPRO_SHARD_N`` /
``REPRO_SHARD_ID``, set by the parent test; every job runs on the CPU on
one process group, in order.  Prints ``DIGEST <job> <hex>`` and ``AGREE
<job> <0|1>`` for each job, with ``EVALS <job> <n>`` (the run's
evaluated rows, the same on every rank), ``LOCAL <job> <n>`` (those this
rank evaluated) and ``BITS`` / ``UNION <job> <calls>`` (its
collectives), and ``BACKEND <name>``.  Imports only ``repro_torch``.
"""

from __future__ import annotations

import sys


def run_job(ctx, job: str) -> tuple[str, bool, int]:
    import numpy as np

    from repro_torch.stream.digest import match_digest

    mode, scheme, *rest = job.split(":")
    if mode == "lattice":
        from repro_torch.core.global_grounding import build_global_grounding
        from repro_torch.core.mln import MLNMatcher
        from repro_torch.core.parallel import run_parallel
        from repro_torch.data.synthetic import make_lattice_cover

        packed, relations, weights = make_lattice_cover(depth=6, width=4)
        gg = (build_global_grounding(packed.pair_levels, relations, weights)
              if scheme == "mmp" else None)
        res = run_parallel(packed, MLNMatcher(weights, device="cpu"), gg, scheme=scheme,
                           mesh=ctx.mesh, fused=rest != ["legacy"])
        return match_digest(res.matches), True, res.neighborhood_evals

    from repro_torch.data.synthetic import SynthConfig, arrival_stream, make_dataset
    from repro_torch.stream.service import ServiceConfig
    from repro_torch.stream.shard import ShardCoordinator

    batches = arrival_stream(make_dataset(SynthConfig.hepth(scale=0.02, seed=3)), 3)
    order = list(range(len(batches)))
    perm_seed = int(rest[0])
    if perm_seed >= 0:
        order = [int(i) for i in np.random.default_rng(perm_seed).permutation(len(batches))]
    coord = ShardCoordinator(ctx, config=ServiceConfig(scheme=scheme, parallel=True))
    for i in order:
        b = batches[i]
        coord.ingest(list(b.names), b.edges, ids=[int(x) for x in b.ids])
    return coord.digest(), coord.digests_agree(), coord.service.engine.total_evals


def main() -> None:
    import torch

    torch.set_num_threads(1)
    from repro_torch.stream.shard import ShardContext

    ctx = ShardContext.create(device="cpu")
    print("BACKEND", ctx.mesh.backend, flush=True)
    for job in sys.argv[1:]:
        ctx.mesh.reset_stats()
        digest, agree, evals = run_job(ctx, job)
        print("DIGEST", job, digest)
        print("EVALS", job, evals)
        print("LOCAL", job, ctx.mesh.rows_evaluated)
        for what in ("bits", "union"):
            print(what.upper(), job, ctx.mesh.stats.get(what, [0])[0])
        print("AGREE", job, int(agree), flush=True)


if __name__ == "__main__":
    main()
