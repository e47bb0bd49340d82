"""The port's numpy host layer gives the reference's arrays, byte for byte."""

from __future__ import annotations

import numpy as np
import pytest

pytest.importorskip("torch")

from repro.core import pairs as ref_pairs  # noqa: E402
from repro.core import similarity as ref_sim  # noqa: E402
from repro.data import synthetic as ref_synth  # noqa: E402
from repro_torch.core import pairs as port_pairs  # noqa: E402
from repro_torch.core import similarity as port_sim  # noqa: E402
from repro_torch.data import synthetic as port_synth  # noqa: E402


def _same_array(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return a.dtype == b.dtype and a.shape == b.shape and a.tobytes() == b.tobytes()


@pytest.mark.parametrize("kind,scale,seed", [("hepth", 0.035, 7), ("dblp", 0.035, 11)])
def test_make_dataset_byte_identical(kind, scale, seed):
    ref = ref_synth.make_dataset(getattr(ref_synth.SynthConfig, kind)(scale=scale, seed=seed))
    port = port_synth.make_dataset(getattr(port_synth.SynthConfig, kind)(scale=scale, seed=seed))
    assert port.entities.names == ref.entities.names
    assert _same_array(port.entities.truth, ref.entities.truth)
    assert _same_array(port.paper_of, ref.paper_of)
    assert port.author_names == ref.author_names
    assert sorted(port.relations.edges) == sorted(ref.relations.edges)
    for name, e in ref.relations.edges.items():
        assert _same_array(port.relations.edges[name], e)


@pytest.mark.parametrize("seed", [0, 1])
def test_make_bipartite_and_arrival_stream_byte_identical(seed):
    ref = ref_synth.make_bipartite(24, seed=seed)
    port = port_synth.make_bipartite(24, seed=seed)
    assert port.entities.names == ref.entities.names
    assert _same_array(port.entities.truth, ref.entities.truth)
    assert _same_array(port.relations.all_edges(), ref.relations.all_edges())
    for a, b in zip(port_synth.arrival_stream(port, 4), ref_synth.arrival_stream(ref, 4)):
        assert a.names == b.names and _same_array(a.ids, b.ids) and _same_array(a.edges, b.edges)


def test_make_lattice_cover_byte_identical():
    pk_r, rel_r, w_r = ref_synth.make_lattice_cover(depth=6, width=4)
    pk_p, rel_p, w_p = port_synth.make_lattice_cover(depth=6, width=4)
    assert (w_p.w_sim, w_p.w_co) == (w_r.w_sim, w_r.w_co)
    assert _same_array(rel_p.edges["coauthor"], rel_r.edges["coauthor"])
    assert pk_p.pair_levels == pk_r.pair_levels
    for k, nb in pk_r.bins.items():
        for f in ("entity_ids", "entity_mask", "coauthor", "sim_level", "pair_gid", "pair_mask"):
            assert _same_array(getattr(pk_p.bins[k], f), getattr(nb, f)), f


@pytest.mark.parametrize("k", [2, 5, 8, 32])
def test_pair_indexing_identical(k):
    for a, b in zip(port_pairs.triu_indices(k), ref_pairs.triu_indices(k)):
        assert _same_array(a, b)
    assert port_pairs.num_pairs(k) == ref_pairs.num_pairs(k)
    ids = np.arange(2 * k, dtype=np.int64)
    assert _same_array(port_pairs.make_gid(ids[:k], ids[k:]), ref_pairs.make_gid(ids[:k], ids[k:]))


def test_similarity_profiles_and_levels_identical(hepth_small):
    names = hepth_small.entities.names[:60]
    keys = [ref_sim.block_key(n) for n in names]
    assert keys == [port_sim.block_key(n) for n in names]
    assert _same_array(port_sim.ngram_profiles(keys), ref_sim.ngram_profiles(keys))
    assert _same_array(port_sim.jw_matrix(names, names), ref_sim.jw_matrix(names, names))
