"""EM-based corpus dedup: the paper's technique in the LM data path.

Exact-hash dedup misses near-duplicates; pairwise MinHash misses
*transitive* duplicate families (A~B, B~C but A!~C on surface
similarity).  That is the collective-EM problem, so the paper's
machinery runs over documents:

* entities  = documents (hashed shingle profiles as "names");
* Similar   = shingle-profile cosine, discretized to levels 1..3;
* relation  = ``SameSource`` (documents from one crawl or source, the
  analogue of Coauthor: relational, not textual, evidence);
* matcher   = the same supermodular MLN, weights re-interpreted for the
  document domain; SMP/MMP message passing across canopy neighborhoods.

The clusters drive :func:`filter_corpus`, which keeps one representative
of each duplicate family.  It is the bibliographic pipeline's own code
path, so on the card the canopies run ``ngram_sim`` and every MLN
closure and entailment step runs ``icm_sweep``.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.core.closure import clusters_of
from repro_torch.core.mln import MLNMatcher, MLNWeights
from repro_torch.core.pipeline import resolve
from repro_torch.core.types import EntityTable, Relations

# Weights for the document domain: level-3 shingle similarity is
# near-duplication; one shared-source link plus level-2 is enough.
DOC_WEIGHTS = MLNWeights(w_sim=(0.0, -2.0, -1.0, 8.0), w_co=1.6)
# MinHash-signature JW levels (near-dups land at ~0.84-0.95; random doc
# signatures over a 26-letter alphabet have a ~0.6-0.75 JW baseline).
DOC_THRESHOLDS = (0.78, 0.82, 0.875)


def _doc_signature(doc: np.ndarray, n: int = 3, chars: int = 32) -> str:
    """MinHash shingle signature rendered as a string.

    Hash every ``n``-token shingle, keep the ``chars`` smallest hashes
    (order-invariant, robust to local edits: classic MinHash), and render
    them as letters so the name machinery (n-gram profiles and
    Jaro-Winkler levels) applies unchanged.
    """
    d = np.asarray(doc, dtype=np.int64)
    if len(d) < n:
        d = np.pad(d, (0, n - len(d)), constant_values=1)
    # rolling polynomial hash of shingles, vectorized
    h = np.zeros(len(d) - n + 1, dtype=np.uint64)
    for i in range(n):
        h = h * np.uint64(1099511628211) + d[i : len(d) - n + 1 + i].astype(np.uint64)
        h ^= h >> np.uint64(29)
    mins = np.sort(np.unique(h))[:chars]
    return "".join(chr(ord("a") + int(m % np.uint64(26))) for m in mins)


@dataclasses.dataclass
class DedupReport:
    n_docs: int
    n_clusters: int
    n_removed: int
    keep_mask: np.ndarray
    clusters: list[np.ndarray]


def dedup_documents(
    docs: list[np.ndarray],
    source_of: np.ndarray | None = None,
    *,
    weights: MLNWeights = DOC_WEIGHTS,
    scheme: str = "smp",
    k_max: int = 24,
    device=None,
) -> DedupReport:
    """Run collective EM over documents on ``device`` (``None``: CUDA),
    return the duplicate clusters."""
    names = [_doc_signature(d) for d in docs]
    entities = EntityTable(names=names, truth=None)

    if source_of is None:
        source_of = np.zeros(len(docs), dtype=np.int64)
    # SameSource relation: a windowed clique per source.  A chain would
    # give a candidate pair no *shared* neighbor, and the MLN's relational
    # rule needs one (coauthor(e1,c) & coauthor(e2,c)); a window-4 clique
    # keeps the relation sparse while giving every nearby same-source
    # pair common neighbors.
    edges = []
    recent: dict[int, list[int]] = {}
    window = 4
    for i, s in enumerate(np.asarray(source_of).tolist()):
        for j in recent.get(s, []):
            edges.append((j, i))
        recent.setdefault(s, []).append(i)
        recent[s] = recent[s][-window:]
    rel = Relations(
        edges={
            "coauthor": np.asarray(edges, dtype=np.int64)
            if edges
            else np.zeros((0, 2), dtype=np.int64)
        }
    )

    res = resolve(
        entities,
        rel,
        scheme=scheme,
        matcher=MLNMatcher(weights, device=device),
        weights=weights,
        k_max=k_max,
        thresholds=DOC_THRESHOLDS,
        t_loose=0.60,
        device=device,
    )
    clusters = clusters_of(res.closed)

    keep = np.ones(len(docs), dtype=bool)
    removed = 0
    for c in clusters:
        for dup in c[1:]:  # keep the first member as representative
            keep[int(dup)] = False
            removed += 1
    return DedupReport(
        n_docs=len(docs),
        n_clusters=len(clusters),
        n_removed=removed,
        keep_mask=keep,
        clusters=clusters,
    )


def filter_corpus(docs: list[np.ndarray], report: DedupReport) -> list[np.ndarray]:
    return [d for d, k in zip(docs, report.keep_mask) if k]
