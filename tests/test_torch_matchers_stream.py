"""The matcher families inside the port's streaming service, against the
reference's, on the CPU.

``ServiceConfig(matcher=<name>)`` resolves every registered family on the
service's device and streams the bipartite corpus to the batch fixpoint; the embedding family's O(dirty) encoder counters and the state
digest equal the reference's after every ingest, on the sequential and the
parallel engine; and the service binds its live ``DeltaCover.names`` to the
name encoders.
"""

from __future__ import annotations

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import matchers as ref_matchers  # noqa: E402
from repro.core.matchers.embedding import EmbeddingMatcher as RefEmbedding  # noqa: E402
from repro.data.synthetic import arrival_stream as ref_arrival_stream  # noqa: E402
from repro.data.synthetic import make_bipartite as ref_make_bipartite  # noqa: E402
from repro.stream import ResolveService as RefService  # noqa: E402
from repro.stream import ServiceConfig as RefConfig  # noqa: E402
from repro.stream.digest import state_digest as ref_digest  # noqa: E402
from repro_torch.core import matchers, pipeline  # noqa: E402
from repro_torch.core.driver import run_smp  # noqa: E402
from repro_torch.core.matchers.embedding import EmbeddingMatcher  # noqa: E402
from repro_torch.data.synthetic import arrival_stream, make_bipartite  # noqa: E402
from repro_torch.stream import ResolveService, ServiceConfig  # noqa: E402
from repro_torch.stream.digest import state_digest  # noqa: E402

FAMILIES = ref_matchers.list_matchers()


def _as_set(gids) -> set[int]:
    return set(int(g) for g in np.asarray(gids))


@pytest.fixture(scope="module")
def bip():
    return ref_make_bipartite(40, seed=1), make_bipartite(40, seed=1)


@pytest.mark.parametrize("name", FAMILIES)
def test_service_takes_every_family_by_name(name, bip):
    """``ServiceConfig(matcher=<name>)`` builds the family on the service's
    device; the stream reaches the batch fixpoint (which
    ``tests/test_torch_matchers.py`` holds equal to the reference's)."""
    ds = bip[1]
    packed, _, _ = pipeline.prepare(ds.entities, ds.relations, device="cpu")
    batch = run_smp(packed, matchers.get_matcher(name, device="cpu"))
    svc = ResolveService(ServiceConfig(matcher=name, scheme="smp"), device="cpu")
    assert svc.engine.matcher.device.type == "cpu"
    assert matchers.matcher_info(name).factory is not None
    for b in arrival_stream(ds, 5):
        svc.ingest(b.names, b.edges, ids=b.ids)
    assert _as_set(svc.matches.gids) == _as_set(batch.matches.gids), name
    assert len(svc.matches) > 0


@pytest.mark.parametrize("parallel", [False, True])
def test_embedding_counters_under_a_stream_equal_the_reference(parallel, bip):
    """The embedding family re-encodes only dirty entities: after every
    ingest, ``encode_calls``/``encoded_ids`` and the state digest equal the
    reference's."""
    ref_m = ref_matchers.get_matcher("embedding")
    port_m = matchers.get_matcher("embedding", device="cpu")
    ref_svc = RefService(RefConfig(matcher=ref_m, scheme="smp", parallel=parallel))
    svc = ResolveService(ServiceConfig(matcher=port_m, scheme="smp", parallel=parallel),
                         device="cpu")
    seen = 0
    for rb, b in zip(ref_arrival_stream(bip[0], 6), arrival_stream(bip[1], 6)):
        ref_svc.ingest(rb.names, rb.edges, ids=rb.ids)
        svc.ingest(b.names, b.edges, ids=b.ids)
        seen += len(b.ids)
        assert (port_m.encode_calls, port_m.encoded_ids) == (ref_m.encode_calls,
                                                             ref_m.encoded_ids)
        assert port_m.encoded_ids == seen
        assert state_digest(svc) == ref_digest(ref_svc)
    assert 0 < port_m.encode_calls <= port_m.encoded_ids == len(bip[1].entities)


def test_service_binds_the_cover_names_to_name_encoders(hepth_small):
    """The service's ``bind_names`` hook hands the matcher the live
    ``DeltaCover.names`` list, so the ngram encoder reads arriving names."""
    m = EmbeddingMatcher(encoder="ngram", device="cpu")
    ref_m = RefEmbedding(encoder="ngram")
    svc = ResolveService(ServiceConfig(matcher=m, scheme="smp"), device="cpu")
    ref_svc = RefService(RefConfig(matcher=ref_m, scheme="smp"))
    assert m._names is svc.delta.names
    for b in arrival_stream(hepth_small, 3):
        svc.ingest(b.names, b.edges, ids=b.ids)
        ref_svc.ingest(b.names, b.edges, ids=b.ids)
    assert state_digest(svc) == ref_digest(ref_svc)
    ids = sorted(m._memo)
    assert ids == sorted(ref_m._memo) and len(ids) == len(hepth_small.entities)
    for i in ids:
        assert np.array_equal(m._memo[i], ref_m._memo[i])
