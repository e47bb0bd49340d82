"""The port's corpus and EM-based dedup (``repro_torch.data``) vs the reference.

The same numpy inputs go through both packages; documents, token batches,
signatures, clusters and keep masks must be equal bit for bit.  The port's
dedup runs on the CPU (``device="cpu"``: each kernel's plain version).
"""

from __future__ import annotations

import hashlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.data import corpus as ref_corpus  # noqa: E402
from repro.data import dedup as ref_dedup  # noqa: E402
from repro_torch.data import corpus, dedup  # noqa: E402


def _e2e_docs():
    """``tests/test_e2e_em.py``'s 16 documents: 12 random ones, every third
    followed by a near-duplicate, over 4 crawl sources."""
    rng = np.random.default_rng(0)
    base = [rng.integers(0, 1000, size=200) for _ in range(12)]
    docs, source = [], []
    for i, d in enumerate(base):
        docs.append(d)
        source.append(i % 4)
        if i % 3 == 0:
            d2 = d.copy()
            d2[::17] += 1
            docs.append(d2)
            source.append(i % 4)
    return docs, np.asarray(source)


def _generated(seed, n):
    docs, _ = ref_corpus.make_documents(ref_corpus.CorpusConfig(seed=seed), n)
    return docs, np.arange(n) % 8


CORPORA = {"e2e16": _e2e_docs, "seed1_120": lambda: _generated(1, 120),
           "seed2_200": lambda: _generated(2, 200)}


@pytest.fixture(scope="module")
def reports():
    """(corpus, scheme) -> (docs, source, reference report, port report)."""
    cache = {}

    def get(name, scheme):
        if (name, scheme) not in cache:
            docs, source = CORPORA[name]()
            want = ref_dedup.dedup_documents(docs, source_of=source, scheme=scheme)
            got = dedup.dedup_documents(docs, source_of=source, scheme=scheme, device="cpu")
            cache[name, scheme] = (docs, source, want, got)
        return cache[name, scheme]

    return get


@pytest.mark.parametrize("cfg", [
    dict(seed=1), dict(seed=2), dict(seed=3, dup_rate=0.5, doc_len_mean=40, vocab_size=300),
])
def test_make_documents_equals_reference(cfg):
    docs, dup_of = corpus.make_documents(corpus.CorpusConfig(**cfg), 150)
    want_docs, want_dup = ref_corpus.make_documents(ref_corpus.CorpusConfig(**cfg), 150)
    np.testing.assert_array_equal(dup_of, want_dup)
    assert (dup_of >= 0).any() and len(docs) == len(want_docs) == 150
    for d, w in zip(docs, want_docs):
        assert d.dtype == w.dtype
        np.testing.assert_array_equal(d, w)


# numpy 2.0's Generator.zipf(a, size=shape) from default_rng(9): the first 16
# hex digits of the sha256 of its int64 samples, and the generator's next double
ZIPF_2_0 = {
    (1.2, (3, 40)): ("0ea9af60431aaaee", 0.7137538355538985),
    (1.05, (64,)): ("c470f6eb4d2224a9", 0.1697841074047921),
    (2.5, (9,)): ("2dc3a1a751b30c67", 0.9232382080702205),
}


def test_zipf_is_numpy_2_0s_sampler():
    """The port draws Zipf samples with numpy 2.0's algorithm on any numpy
    (a later release changed ``Generator.zipf``): numpy 2.0's draws, and the
    generator left where numpy 2.0 leaves it."""
    rng = np.random.default_rng(1)
    np.testing.assert_array_equal(corpus.zipf(rng, 1.2, 8), [6, 6585, 53, 1099, 6, 2, 3, 1031])
    assert corpus.zipf(rng, 1.2, (2, 0)).shape == (2, 0)
    for (a, shape), (digest, after) in ZIPF_2_0.items():
        rng = np.random.default_rng(9)
        z = corpus.zipf(rng, a, shape)
        assert z.shape == shape and z.dtype == np.int64
        assert hashlib.sha256(z.tobytes()).hexdigest()[:16] == digest
        assert rng.random() == after


@pytest.mark.parametrize("cfg", [dict(), dict(seed=7, seq_len=33, global_batch=3, vocab_size=50)])
def test_token_stream_equals_reference(cfg):
    got = corpus.TokenStream(corpus.CorpusConfig(**cfg))
    want = ref_corpus.TokenStream(ref_corpus.CorpusConfig(**cfg))
    stream = got.batches(start_step=5)
    for step in (0, 1, 5, 6, 1000):
        b, w = got.batch(step), want.batch(step)
        assert list(b) == list(w) == ["tokens", "labels"]
        for k in b:
            assert b[k].dtype == w[k].dtype
            np.testing.assert_array_equal(b[k], w[k])
        np.testing.assert_array_equal(b["tokens"][:, 1:], b["labels"][:, :-1])
    for step in (5, 6):  # the restartable stream resumes at its step
        np.testing.assert_array_equal(next(stream)["tokens"], want.batch(step)["tokens"])


def test_doc_signature_equals_reference():
    docs, _ = _generated(4, 60)
    short = [np.array([5]), np.array([], dtype=np.int64), np.array([3, 9]), np.arange(40)]
    for d in docs + short:
        assert dedup._doc_signature(d) == ref_dedup._doc_signature(d)
    for n, chars in [(2, 16), (5, 8)]:
        got = dedup._doc_signature(docs[0], n, chars)
        assert got == ref_dedup._doc_signature(docs[0], n, chars)
    assert dedup.DOC_WEIGHTS.w_sim == ref_dedup.DOC_WEIGHTS.w_sim
    assert dedup.DOC_WEIGHTS.w_co == ref_dedup.DOC_WEIGHTS.w_co
    assert dedup.DOC_THRESHOLDS == ref_dedup.DOC_THRESHOLDS


@pytest.mark.parametrize("scheme", ["smp", "mmp"])
@pytest.mark.parametrize("name", list(CORPORA))
def test_dedup_report_equals_reference(name, scheme, reports):
    docs, source, want, got = reports(name, scheme)
    assert (got.n_docs, got.n_clusters, got.n_removed) == (
        want.n_docs, want.n_clusters, want.n_removed)
    assert got.n_clusters > 0 and got.n_removed > 0
    assert len(got.clusters) == len(want.clusters)
    for c, w in zip(got.clusters, want.clusters):
        np.testing.assert_array_equal(c, w)
    assert got.keep_mask.dtype == bool
    np.testing.assert_array_equal(got.keep_mask, want.keep_mask)
    assert got.keep_mask.sum() == len(docs) - got.n_removed


@pytest.mark.parametrize("name", ["e2e16", "seed2_200"])
def test_filter_corpus_equals_reference(name, reports):
    docs, source, want, got = reports(name, "smp")
    kept, want_kept = dedup.filter_corpus(docs, got), ref_dedup.filter_corpus(docs, want)
    assert len(kept) == len(want_kept) == len(docs) - got.n_removed
    for d, w in zip(kept, want_kept):
        np.testing.assert_array_equal(d, w)


def test_dedup_without_sources_and_its_device(monkeypatch):
    """No sources: every document in one, as in the reference.  ``device=None``
    means CUDA: without a GPU it raises, never falls back."""
    docs, _ = _e2e_docs()
    want = ref_dedup.dedup_documents(docs)
    got = dedup.dedup_documents(docs, device="cpu")
    np.testing.assert_array_equal(got.keep_mask, want.keep_mask)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        dedup.dedup_documents(docs)
