"""Canonical sha256 digest of a :class:`ResolveService`'s logical state.

The fault-tolerance tests compare *states*, not just match sets: an
aborted ingest must leave the service bit-for-bit where it was.
``state_digest`` folds every piece of logical state into one hash so
those comparisons are a string equality.  The code is the reference's
(``repro.stream.digest``) unchanged: the port keeps its logical state
in numpy and Python containers, so the two packages' services hash
the same bytes after the same ingests, and a ``torch.Tensor`` in the
state is refused (``_feed`` raises on unknown types).

What "canonical" means here:

* **Sets and dicts are order-normalized.**  Rollback restores set
  *contents* exactly, but a rebuilt ``set()`` may iterate in a
  different order than the original (CPython table geometry is
  insertion-history dependent), so anything unordered is sorted before
  hashing.
* **Union-find structure is cluster-normalized.**  Root identity
  depends on union order; the digest hashes the partition (sorted
  tuples of sorted members), not the parent pointers.
* **Caches and device state are excluded**: the matcher (pure
  function of the weights), ``GlobalGrounding._device`` (lazy upload
  cache), the LSH index's device copy of its hash table, the obs
  registry (monotone counters, not logical state), and the packed
  cover's *backing buffers* — only the
  published array views are hashed, because rolled-back tail appends
  legitimately leave garbage beyond every published view length.
"""

from __future__ import annotations

import dataclasses
import hashlib

import numpy as np


def _feed(h, obj) -> None:
    """Recursively fold ``obj`` into hash ``h``, type-tagged so that
    e.g. ``[1, 2]`` and ``[(1, 2)]`` cannot collide."""
    if obj is None:
        h.update(b"\x00N")
    elif isinstance(obj, (bool, np.bool_)):
        h.update(b"\x00B1" if obj else b"\x00B0")
    elif isinstance(obj, (int, np.integer)):
        h.update(f"\x00i{int(obj)}".encode())
    elif isinstance(obj, (float, np.floating)):
        h.update(f"\x00f{float(obj).hex()}".encode())
    elif isinstance(obj, str):
        b = obj.encode()
        h.update(f"\x00s{len(b)}:".encode())
        h.update(b)
    elif isinstance(obj, bytes):
        h.update(f"\x00b{len(obj)}:".encode())
        h.update(obj)
    elif isinstance(obj, np.ndarray):
        a = np.ascontiguousarray(obj)
        h.update(f"\x00a{a.dtype.str}{a.shape}:".encode())
        h.update(a.tobytes())
    elif isinstance(obj, (list, tuple)):
        h.update(f"\x00l{len(obj)}:".encode())
        for x in obj:
            _feed(h, x)
    elif isinstance(obj, dict):
        h.update(f"\x00d{len(obj)}:".encode())
        for k in sorted(obj, key=repr):
            _feed(h, k)
            _feed(h, obj[k])
    elif isinstance(obj, (set, frozenset)):
        h.update(f"\x00S{len(obj)}:".encode())
        for x in sorted(obj, key=repr):
            _feed(h, x)
    else:
        raise TypeError(f"state_digest: unhashable state type {type(obj)!r}")


def _pool_partition(pool) -> list[tuple[int, ...]]:
    """The message pool as a canonical partition, via a *non-mutating*
    root walk (``pool._find`` would path-compress and journal)."""
    by_root: dict[int, list[int]] = {}
    for g in pool.parent:
        p = int(g)
        while pool.parent[p] != p:
            p = pool.parent[p]
        by_root.setdefault(p, []).append(int(g))
    return sorted(tuple(sorted(v)) for v in by_root.values())


def match_digest(matches) -> str:
    """Hex sha256 of a match fixpoint alone (a :class:`MatchStore` or a
    gid array) — the equivalence oracle for engine-level runs that have
    no surrounding service."""
    h = hashlib.sha256()
    gids = getattr(matches, "gids", matches)
    _feed(h, ["m_plus", np.sort(np.asarray(gids, dtype=np.int64))])
    return h.hexdigest()


def state_digest(service) -> str:
    """Hex sha256 over the service's canonicalized logical state."""
    h = hashlib.sha256()
    d = service.delta
    _feed(h, ["names", d.names])
    cov = d.cover
    if cov is not None:
        _feed(h, ["cover.core", list(cov.core)])
        _feed(h, ["cover.full", list(cov.full)])
    p = d.packed
    if p is not None:
        _feed(h, ["pair_levels", p.pair_levels])
        _feed(h, ["row_keys", p.row_keys])
        _feed(h, ["bin_rows", p.bin_rows])
        _feed(h, ["nb_bin", p.neighborhood_bin])
        _feed(h, ["nb_row", p.neighborhood_row])
        for k in sorted(p.bins):
            nb = p.bins[k]
            _feed(h, ["bin", k, nb.entity_ids, nb.entity_mask, nb.coauthor,
                      nb.sim_level, nb.pair_gid, nb.pair_mask])
    eng = service.engine
    _feed(h, ["m_plus", eng.m_plus.gids])
    _feed(h, ["pool", _pool_partition(eng.pool)])
    _feed(h, ["fixpoint", service._fixpoint.gids])
    _feed(h, ["clusters",
              sorted(tuple(sorted(m)) for m in service._members.values())])
    pub = service._published
    _feed(h, ["published", pub.matches.gids, pub.n_entities, pub.n_ingests,
              sorted(tuple(int(x) for x in arr)
                     for arr in pub._members.values())])
    g = service.grounding
    if g is not None:
        _feed(h, ["g.levels", g.levels])
        _feed(h, ["g.common", g.common])
        _feed(h, ["g.coup", g.coup])
        _feed(h, ["g.pairs_of", g.pairs_of])
        _feed(h, ["g.adj", g.adj])
        _feed(h, ["g.coup_adj", g.coup_adj])
        _feed(h, ["g.pend", g._pend_add, g._pend_del, g._pend_u,
                  g._pend_cadd, g._pend_cdel])
        gg = g._gg
        if gg is not None:
            for f in dataclasses.fields(gg):
                if f.name == "_device":
                    continue
                _feed(h, [f"gg.{f.name}", getattr(gg, f.name)])
    return h.hexdigest()
