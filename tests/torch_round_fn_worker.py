"""Rank worker for the EM round functions over gloo CPU ranks.

Usage: ``python torch_round_fn_worker.py STORE RANKS RANK SEED`` (``STORE``
a file-store path every rank shares).  Each rank draws the same random
neighborhood batch from ``SEED`` (:func:`round_fn_inputs`), takes its
slice of the rows padded to a multiple of the rank count, and runs
``build_round_fn`` and ``build_bin_round_fn`` of
:mod:`repro_torch.core.parallel` for the ``mln``, ``mln_greedy`` and
``rules`` kinds; then ``run_parallel`` on a small hepth cover for ``smp``
and ``mmp`` (:func:`collective_counts`).  Rank 0 prints ``RESULT <json>``:
each round function's gathered ``x`` and labels (the padded rows cut off)
and its bitset, and each lattice run's collectives and rounds.  Imports
only ``repro_torch``.
"""

from __future__ import annotations

import json
import sys

import numpy as np

KINDS = ("mln", "mln_greedy", "rules")
B, K = 10, 6  # rows of the batch (not a multiple of 4: padding is exercised), entities a row


def round_fn_inputs(seed: int):
    """A random padded batch: (entity_ids, entity_mask, coauthor, sim_level,
    pair_mask, uidx), the universe size, the seeded bitset and each row's
    activity for the full round."""
    from repro_torch.core import pairs as pairlib

    rng = np.random.default_rng(seed)
    P = pairlib.num_pairs(K)
    n_live = rng.integers(2, K + 1, size=B)
    ids = np.full((B, K), -1, dtype=np.int64)
    for b in range(B):
        ids[b, : n_live[b]] = rng.choice(100, size=n_live[b], replace=False)
    emask = ids >= 0
    co = rng.random((B, K, K)) < 0.35
    co = np.triu(co, 1)
    co = co | co.transpose(0, 2, 1)
    co &= emask[:, :, None] & emask[:, None, :]
    ii, jj = pairlib.triu_indices(K)
    pmask = emask[:, ii] & emask[:, jj]
    lev = np.where(pmask, rng.integers(0, 4, size=(B, P)), 0).astype(np.int8)
    pmask = pmask & (lev > 0)
    Np = 64
    uidx = np.where(pmask, rng.integers(0, Np, size=(B, P)), Np).astype(np.int32)
    m_bits = rng.random(Np) < 0.2
    active = rng.random(B) < 0.7
    return (ids, emask, co, lev, pmask, uidx), Np, m_bits, active


def _pad(a: np.ndarray, mult: int) -> np.ndarray:
    target = -(-a.shape[0] // mult) * mult
    return np.concatenate([a, np.zeros((target - a.shape[0],) + a.shape[1:], a.dtype)])


def run(mesh, seed: int) -> dict:
    """Every kind through both round functions on ``mesh``: this rank's rows."""
    import torch

    from repro_torch.core import parallel as par
    from repro_torch.core.mln import PAPER_LEARNED

    arrays, Np, m_bits, active = round_fn_inputs(seed)
    ids, emask, co, lev, pmask, uidx = (_pad(a, mesh.size) for a in arrays)
    lo, hi = mesh.row_slice(ids.shape[0])
    dev = mesh.device
    bits = torch.as_tensor(m_bits, device=dev)
    out = {}
    for kind in KINDS:
        P = pmask.shape[1]
        spec = par.RoundSpec(num_pairs=P, universe_size=Np, matcher_kind=kind,
                             weights=PAPER_LEARNED)
        fn = par.build_round_fn(spec, mesh, tuple(mesh.axis_names))
        x, lab, b = fn(emask[lo:hi], co[lo:hi], lev[lo:hi], pmask[lo:hi], uidx[lo:hi], bits)
        out[f"round/{kind}"] = (x, lab, b)

        ground = "rules" if kind == "rules" else "mln"
        g = par._ground_bin_fn(ground, None if kind == "rules" else PAPER_LEARNED, dev)(
            ids[lo:hi], emask[lo:hi], co[lo:hi], lev[lo:hi], pmask[lo:hi])
        bspec = par.BinRoundSpec(kind=kind, num_pairs=P, universe_size=Np)
        bfn = par.build_bin_round_fn(bspec, mesh, tuple(mesh.axis_names))
        act = _pad(active, mesh.size)[lo:hi]
        x, lab, b = bfn(g, torch.as_tensor(uidx[lo:hi], device=dev).long(),
                        torch.as_tensor(pmask[lo:hi], device=dev), act, bits)
        out[f"bin/{kind}"] = (x, lab, b)
    return {k: [np.asarray(x.cpu())[:B].tolist(), np.asarray(lab.cpu())[:B].tolist(),
                np.asarray(b.cpu()).tolist()] for k, (x, lab, b) in out.items()}


def collective_counts(mesh) -> dict:
    """``run_parallel`` (fused, MLN) over ``mesh`` for ``smp`` and ``mmp`` on
    a small hepth draw packed at ``k_max=16`` (two bins, both active in
    each full round): the mesh's bitset reductions and row gathers, and the
    run's rounds and full rounds."""
    from repro_torch.core import pipeline
    from repro_torch.core.mln import PAPER_LEARNED, MLNMatcher
    from repro_torch.core.parallel import run_parallel
    from repro_torch.data import synthetic

    ds = synthetic.make_dataset(synthetic.SynthConfig.hepth(scale=0.035, seed=7))
    packed, gg, _ = pipeline.prepare(ds.entities, ds.relations, k_max=16, device="cpu")
    out = {}
    for scheme in ("smp", "mmp"):
        mesh.reset_stats()
        res = run_parallel(packed, MLNMatcher(PAPER_LEARNED, device="cpu"),
                           gg if scheme == "mmp" else None, scheme=scheme, mesh=mesh)
        out[scheme] = {"bits": mesh.stats.get("bits", [0])[0],
                       "rows": mesh.stats.get("rows", [0])[0],
                       "rounds": res.rounds, "full_rounds": res.full_rounds}
    return out


def main(argv: list[str]) -> int:
    store, n, rank, seed = argv[1], int(argv[2]), int(argv[3]), int(argv[4])
    from repro_torch.launch.mesh import em_service_mesh, init_em_distributed

    init_em_distributed(f"file://{store}", n, rank, device="cpu")
    mesh = em_service_mesh(n, device="cpu")
    got = run(mesh, seed)
    got["collectives"] = collective_counts(mesh)
    if rank == 0:
        print("RESULT " + json.dumps(got), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv))
