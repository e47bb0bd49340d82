"""Synthetic bibliographic datasets mirroring the paper's HEPTH / DBLP.

The paper evaluates on two author-reference corpora:

* **HEPTH** — 58,515 author references, 29,555 papers, 13,092 authors;
  names are often *abbreviated* ("J. Doe"), causing name clashes and
  fewer, larger canopies (13K neighborhoods / 1.3M candidate pairs).
* **DBLP** — 50,195 references, 19,408 papers, 21,278 authors; full
  names with *manually injected mutations*; smaller neighborhoods
  (30K neighborhoods / 0.5M pairs).

Neither corpus ships with this repo, so we generate the same *shape* of
data with controlled ground truth:

1. sample unique authors (first/last names from phoneme pools, with a
   tunable rate of colliding surnames + first initials — the
   disambiguation stress the collective matcher exists for);
2. sample a community-structured coauthorship graph (authors write
   papers with their community — recurring coauthor patterns are what
   rule R2/R4 exploits);
3. emit one *reference* per (paper, author) with a style-dependent
   surface form: HEPTH-style abbreviates the first name, DBLP-style
   keeps full names and injects typo mutations.

The generator is deterministic per seed; ``scale`` ~ references count.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.core.types import EntityTable, Relations

_FIRST = [
    "james", "john", "robert", "michael", "william", "david", "mary",
    "maria", "anna", "wei", "lei", "jun", "yan", "hiro", "kenji", "sara",
    "laura", "marco", "andrea", "pavel", "ivan", "olga", "rahul", "amit",
    "priya", "chen", "ming", "tao", "yuki", "akira", "hans", "peter",
    "klaus", "pierre", "jean", "luc", "carlos", "jose", "ana", "sofia",
]
_COMMON_LAST = [
    "smith", "johnson", "lee", "wang", "chen", "kumar", "singh", "patel",
    "mueller", "schmidt", "rossi", "ferrari", "ivanov", "petrov", "sato",
    "tanaka", "kim", "park", "nguyen", "tran", "garcia", "martinez",
]
_SYL_A = ["an", "ber", "cas", "dor", "el", "fal", "gor", "hab", "ir", "jas",
          "kol", "lam", "mor", "nev", "os", "pal", "qui", "ras", "sol", "tem",
          "ul", "var", "wes", "xan", "yor", "zel"]
_SYL_B = ["ak", "bel", "cot", "din", "er", "fas", "gul", "hom", "is", "jor",
          "ket", "lov", "mun", "nor", "ot", "pes", "quin", "rit", "sun", "tov",
          "ur", "vin", "wit", "xi", "yev", "zor"]
_SYL_C = ["a", "ez", "i", "man", "o", "ski", "sen", "son", "ton", "u", "ova"]


def _surname_pool(rng: np.random.Generator, size: int) -> tuple[list[str], np.ndarray]:
    """Zipf-weighted surname pool: a head of common names + a long tail
    of procedurally generated rare surnames (real bibliographic corpora
    have thousands of distinct surnames; the paper's HEPTH ambiguity
    comes from *abbreviation*, not from everyone being named Smith)."""
    pool = list(_COMMON_LAST)
    seen = set(pool)
    while len(pool) < size:
        s = (
            _SYL_A[int(rng.integers(0, len(_SYL_A)))]
            + _SYL_B[int(rng.integers(0, len(_SYL_B)))]
            + (_SYL_C[int(rng.integers(0, len(_SYL_C)))] if rng.random() < 0.6 else "")
        )
        if s not in seen:
            seen.add(s)
            pool.append(s)
    ranks = np.arange(1, len(pool) + 1, dtype=np.float64)
    w = 1.0 / (ranks + 25.0)
    return pool, w / w.sum()


@dataclasses.dataclass(frozen=True)
class SynthConfig:
    n_authors: int = 400
    n_papers: int = 600
    style: str = "hepth"  # 'hepth' (abbreviated) | 'dblp' (full + typos)
    refs_per_paper: int = 3  # mean coauthors per paper
    n_communities: int = 0  # 0 = auto (n_authors / 12)
    surname_collision_rate: float = 0.35
    typo_rate: float = 0.15
    abbrev_rate: float = 0.75  # hepth only
    chain_motifs: int = 0  # engineered Fig-1 chains/rings (see below)
    seed: int = 0

    @staticmethod
    def hepth(scale: float = 1.0, seed: int = 0) -> "SynthConfig":
        return SynthConfig(
            n_authors=int(400 * scale),
            n_papers=int(600 * scale),
            style="hepth",
            surname_collision_rate=0.12,
            chain_motifs=max(2, int(8 * scale)),
            seed=seed,
        )

    @staticmethod
    def dblp(scale: float = 1.0, seed: int = 0) -> "SynthConfig":
        return SynthConfig(
            n_authors=int(500 * scale),
            n_papers=int(550 * scale),
            style="dblp",
            typo_rate=0.30,
            surname_collision_rate=0.15,
            chain_motifs=max(2, int(8 * scale)),
            seed=seed,
        )


def _typo(rng: np.random.Generator, s: str) -> str:
    if len(s) < 4:
        return s
    op = rng.integers(0, 3)
    i = int(rng.integers(1, len(s) - 1))
    if op == 0:  # drop
        return s[:i] + s[i + 1 :]
    if op == 1:  # swap adjacent
        return s[: i - 1] + s[i] + s[i - 1] + s[i + 1 :]
    c = chr(ord("a") + int(rng.integers(0, 26)))  # substitute
    return s[:i] + c + s[i + 1 :]


@dataclasses.dataclass
class SynthDataset:
    entities: EntityTable
    relations: Relations
    paper_of: np.ndarray  # (N,) paper id per reference
    author_names: list[str]  # canonical name per true author

    @property
    def n_refs(self) -> int:
        return len(self.entities)


def make_dataset(cfg: SynthConfig) -> SynthDataset:
    rng = np.random.default_rng(cfg.seed)
    n_comm = cfg.n_communities or max(8, cfg.n_authors // 12)

    # --- unique authors, with engineered surname/initial collisions -----
    # Canonical names are kept *unique* (middle initials break exact
    # clashes): the ambiguity we want is partial — shared surname and
    # first initial ("wei chen" vs "wang chen") so abbreviated references
    # collide but full references do not.  That is the disambiguation the
    # collective matcher resolves through coauthors.
    last_pool, last_w = _surname_pool(rng, max(150, int(cfg.n_authors * 1.5)))
    canon: list[str] = []
    seen_names: set[str] = set()
    for a in range(cfg.n_authors):
        for _attempt in range(20):
            if a > 0 and rng.random() < cfg.surname_collision_rate:
                # engineered partial collision: share an existing author's
                # surname; sometimes also the first initial (the paper's
                # "J. Doe vs John Doe" abbreviation ambiguity)
                prev = canon[int(rng.integers(0, len(canon)))]
                last = prev.split()[-1]
                prevfirst = prev.split()[0]
                # same surname; same first *initial* only rarely — an
                # identical abbreviated form for two authors is
                # irreducibly ambiguous (even the paper's matcher FPs
                # there), so keep its base rate low like real HEPTH
                pool = [f for f in _FIRST if f[0] == prevfirst[0] and f != prevfirst]
                first = (
                    pool[int(rng.integers(0, len(pool)))]
                    if pool and rng.random() < 0.12
                    else _FIRST[int(rng.integers(0, len(_FIRST)))]
                )
            else:
                first = _FIRST[int(rng.integers(0, len(_FIRST)))]
                last = last_pool[int(rng.choice(len(last_pool), p=last_w))]
            name = f"{first} {last}"
            if name not in seen_names:
                break
            # exact clash: disambiguate with a middle initial
            mid = chr(ord("a") + int(rng.integers(0, 26)))
            name = f"{first} {mid}. {last}"
            if name not in seen_names:
                break
        seen_names.add(name)
        canon.append(name)

    community = rng.integers(0, n_comm, size=cfg.n_authors)

    # --- papers: pick coauthor sets inside a community ------------------
    names: list[str] = []
    truth: list[int] = []
    paper_of: list[int] = []
    coauthor_edges: list[tuple[int, int]] = []
    by_comm: dict[int, np.ndarray] = {
        c: np.where(community == c)[0] for c in range(n_comm)
    }

    for p in range(cfg.n_papers):
        c = int(rng.integers(0, n_comm))
        pool = by_comm[c]
        if len(pool) == 0:
            continue
        n_auth = int(np.clip(rng.poisson(cfg.refs_per_paper - 1) + 1, 1, 6))
        n_auth = min(n_auth, len(pool))
        authors = rng.choice(pool, size=n_auth, replace=False)
        ref_ids = []
        for a in authors:
            parts = canon[int(a)].split()
            first, last = parts[0], parts[-1]
            if cfg.style == "hepth" and rng.random() < cfg.abbrev_rate:
                surface = f"{first[0]}. {last}"
            else:
                surface = canon[int(a)]
            if rng.random() < cfg.typo_rate:
                surface = _typo(rng, surface)
            ref = len(names)
            names.append(surface)
            truth.append(int(a))
            paper_of.append(p)
            ref_ids.append(ref)
        for i in range(len(ref_ids)):
            for j in range(i + 1, len(ref_ids)):
                coauthor_edges.append((ref_ids[i], ref_ids[j]))

    # --- collective-chain motifs (the paper's Fig. 1 at scale) ----------
    # Open chains: a level-3 seed pair + level-1 links hanging off it;
    # neighborhoods split by surname, so deciding link j needs link j+1's
    # match as a *message* (NO-MP < SMP).  Rings: every pair is level-1
    # and only the joint activation is positive (SMP < MMP: maximal
    # messages complete the cycle) — the {(a1,a2),(b2,b3),(c2,c3)} story.
    _LONG_FIRST = ("alessandro", "konstantin", "maximilian", "sebastiano",
                   "evangelina", "bartholomew")

    def _fresh_author(tag: int) -> int:
        # long first names put the full-vs-abbreviated JW in level 1
        # (weak candidate), which is what makes the chain collective;
        # random surnames keep the chain links in *different* canopies
        # (shared-surname n-grams would merge the chain locally)
        a = len(canon)
        surname = "".join(
            chr(ord("a") + int(rng.integers(0, 26))) for _ in range(8)
        )
        canon.append(f"{_LONG_FIRST[tag % len(_LONG_FIRST)]} {surname}")
        return a

    def _pair_refs(a: int, p_id: int, abbrev: bool) -> tuple[int, int]:
        parts = canon[a].split()
        full = canon[a]
        weak = f"{parts[0][0]}. {parts[-1]}" if abbrev else full
        r1, r2 = len(names), len(names) + 1
        names.extend([full, weak])
        truth.extend([a, a])
        paper_of.extend([p_id, p_id])
        return r1, r2

    tag = 0
    for m in range(cfg.chain_motifs):
        ring = m % 2 == 1
        length = 4 + int(rng.integers(0, 2))
        authors = [_fresh_author(tag + i) for i in range(length)]
        tag += length
        refs = [
            _pair_refs(a, cfg.n_papers + m, abbrev=(ring or i > 0))
            for i, a in enumerate(authors)
        ]
        hops = range(length) if ring else range(length - 1)
        for i in hops:
            j = (i + 1) % length
            # two shared papers: ref1s co-occur and ref2s co-occur, so
            # the MLN coupling link(pair_i, pair_j) fires
            coauthor_edges.append((refs[i][0], refs[j][0]))
            coauthor_edges.append((refs[i][1], refs[j][1]))

    edges = (
        np.asarray(coauthor_edges, dtype=np.int64)
        if coauthor_edges
        else np.zeros((0, 2), dtype=np.int64)
    )
    return SynthDataset(
        entities=EntityTable(names=names, truth=np.asarray(truth, dtype=np.int64)),
        relations=Relations(edges={"coauthor": edges}),
        paper_of=np.asarray(paper_of, dtype=np.int64),
        author_names=canon,
    )


# ---------------------------------------------------------------------------
# Evidence-lattice instance (deep multi-round message passing)
# ---------------------------------------------------------------------------

# Lattice rule weights: a candidate pair has u = -5; each matched
# predecessor contributes w_co = 3, so a pair fires only when BOTH of
# its predecessors are matched (-5 + 6 = +1 > 0 > -5 + 3), and no local
# or global group is jointly promotable (3u + 2w = -9 < 0; any suffix
# group's delta inherits the negative single-predecessor entailment).
# Seeds get n_shared = 2 anchor coauthors: u = -5 + 2*3 = +1.
def make_lattice_cover(depth: int, width: int, k: int = 8):
    """Hand-packed evidence lattice: resolution takes ``depth`` rounds.

    ``width`` chains (an even number, grouped into partner pairs).
    Pair ``(c, i)`` becomes matchable only once *both* its predecessors
    ``(c, i-1)`` and ``(partner(c), i-1)`` are matched — evidence must
    flow one neighborhood hop per round, which makes this the paper's
    §2.1 message-passing chain scaled to a benchmarkable instance.
    Because single-predecessor entailment is negative, neighborhoods
    emit no multi-pair maximal messages, so MMP needs the same rounds
    as SMP (no step-7 shortcut) — the multi-round configuration the
    round-parallel engine is benchmarked on.

    Chain-pair lengths are *staggered* between ``depth // 2`` and
    ``depth``: the active frontier shrinks as shorter chains finish,
    so the per-round active-set size varies — the shape-instability a
    per-round gather/dispatch engine pays recompiles for, and the
    statistical-skew effect §6.3 reports on the real corpora.

    Returns ``(packed, relations, weights)`` ready for the drivers; the
    global grounding for MMP comes from ``build_global_grounding(
    packed.pair_levels, relations, weights)``.
    """
    from repro_torch.core import pairs as pairlib
    from repro_torch.core.cover import Cover, PackedCover
    from repro_torch.core.mln import MLNWeights
    from repro_torch.core.types import NeighborhoodBatch

    assert width >= 2 and width % 2 == 0 and depth >= 1
    weights = MLNWeights(w_sim=(0.0, -5.0, -5.0, -5.0), w_co=3.0)
    n_pairs_of_chains = width // 2
    depths = [
        int(round(depth // 2 + (depth - depth // 2) * (j + 1) / n_pairs_of_chains))
        for j in range(n_pairs_of_chains)
    ]

    def chain_depth(c: int) -> int:
        return depths[c // 2]

    def a_id(c: int, i: int) -> int:
        return 2 * (c * depth + i)

    def b_id(c: int, i: int) -> int:
        return a_id(c, i) + 1

    n_chain_ents = 2 * width * depth

    def anchor(c: int, j: int) -> int:
        return n_chain_ents + 2 * c + j

    edges: list[tuple[int, int]] = []
    pair_levels: dict[int, int] = {}
    for c in range(width):
        p = c ^ 1  # partner chain
        edges += [
            (anchor(c, 0), a_id(c, 0)), (anchor(c, 0), b_id(c, 0)),
            (anchor(c, 1), a_id(c, 0)), (anchor(c, 1), b_id(c, 0)),
        ]
        for i in range(chain_depth(c)):
            pair_levels[int(pairlib.make_gid(a_id(c, i), b_id(c, i)))] = 1
            if i:
                edges += [
                    (a_id(c, i), a_id(c, i - 1)), (b_id(c, i), b_id(c, i - 1)),
                    (a_id(c, i), a_id(p, i - 1)), (b_id(c, i), b_id(p, i - 1)),
                ]
    edge_arr = np.asarray(edges, dtype=np.int64)
    relations = Relations(edges={"coauthor": edge_arr})
    adj: dict[int, set[int]] = {}
    for x, y in edges:
        adj.setdefault(x, set()).add(y)
        adj.setdefault(y, set()).add(x)

    P = pairlib.num_pairs(k)
    ii, jj = pairlib.triu_indices(k)
    members_of: list[np.ndarray] = []
    rows = []
    for i in range(depth):
        for c in range(width):
            if i >= chain_depth(c):
                continue
            p = c ^ 1
            mem = [a_id(c, i), b_id(c, i)]
            if i:
                mem += [a_id(c, i - 1), b_id(c, i - 1),
                        a_id(p, i - 1), b_id(p, i - 1)]
            else:
                mem += [anchor(c, 0), anchor(c, 1)]
            mem = sorted(mem)
            members_of.append(np.asarray(mem, dtype=np.int64))
            ids = np.full(k, -1, dtype=np.int64)
            ids[: len(mem)] = mem
            emask = ids >= 0
            co = np.zeros((k, k), dtype=bool)
            for s in range(len(mem)):
                for t in range(s + 1, len(mem)):
                    if mem[t] in adj.get(mem[s], ()):
                        co[s, t] = co[t, s] = True
            lev = np.zeros(P, dtype=np.int8)
            gid = np.full(P, -1, dtype=np.int64)
            pmask = np.zeros(P, dtype=bool)
            for s in range(P):
                x, y = int(ii[s]), int(jj[s])
                if not (emask[x] and emask[y]):
                    continue
                g = int(pairlib.make_gid(int(ids[x]), int(ids[y])))
                if g in pair_levels:
                    lev[s] = 1
                    gid[s] = g
                    pmask[s] = True
            rows.append(dict(ids=ids, emask=emask, co=co, lev=lev, gid=gid,
                             pmask=pmask))

    nb = NeighborhoodBatch(
        entity_ids=np.stack([r["ids"] for r in rows]),
        entity_mask=np.stack([r["emask"] for r in rows]),
        coauthor=np.stack([r["co"] for r in rows]),
        sim_level=np.stack([r["lev"] for r in rows]),
        pair_gid=np.stack([r["gid"] for r in rows]),
        pair_mask=np.stack([r["pmask"] for r in rows]),
    )
    n_nb = len(rows)
    packed = PackedCover(
        bins={k: nb},
        bin_rows={k: np.arange(n_nb, dtype=np.int64)},
        neighborhood_bin=np.full(n_nb, k, dtype=np.int64),
        neighborhood_row=np.arange(n_nb, dtype=np.int64),
        pair_levels=pair_levels,
        cover=Cover(core=members_of, full=members_of),
    )
    return packed, relations, weights


# ---------------------------------------------------------------------------
# Synthetic arrival streams (for repro.stream)
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class ArrivalBatch:
    """One micro-batch of arriving references, in *global* entity ids.

    ``edges`` may reference earlier arrivals (boundary-crossing relation
    tuples are exactly what delta cover maintenance has to handle); in
    the paper-shaped generator every coauthor edge is intra-paper, so
    cutting at paper boundaries keeps each edge inside one batch.
    """

    ids: np.ndarray  # (B,) int64 global reference ids
    names: list[str]
    truth: np.ndarray  # (B,) int64 ground-truth author ids
    edges: np.ndarray  # (E, 2) int64 coauthor edges, global ids

    def __len__(self) -> int:
        return len(self.names)


def truncate(ds: SynthDataset, n_refs: int) -> SynthDataset:
    """Prefix of a dataset: the first ``n_refs`` references plus every
    relation edge among them — the "corpus as of arrival t" instance a
    from-scratch re-run would resolve (used by the streaming tests and
    benchmarks as the baseline at each arrival point)."""
    out_edges = {}
    for name, e in ds.relations.edges.items():
        keep = (e[:, 0] < n_refs) & (e[:, 1] < n_refs)
        out_edges[name] = e[keep]
    return SynthDataset(
        entities=EntityTable(
            names=ds.entities.names[:n_refs],
            truth=None if ds.entities.truth is None else ds.entities.truth[:n_refs],
        ),
        relations=Relations(edges=out_edges),
        paper_of=ds.paper_of[:n_refs],
        author_names=ds.author_names,
    )


def arrival_stream(
    ds: SynthDataset,
    n_batches: int | None = None,
    *,
    batch_size: int | None = None,
) -> list[ArrivalBatch]:
    """Split a dataset into paper-aligned micro-batches (id order).

    References arrive paper by paper (ids are emitted in paper order by
    the generator), mimicking a live bibliographic feed; each coauthor
    edge is assigned to the batch of its latest endpoint.

    Pass either ``n_batches`` or ``batch_size`` (target references per
    micro-batch) — the latter is the natural knob for long streams,
    where the batch count grows with the corpus (the streaming
    benchmark drives thousands of micro-batches this way).
    """
    n = ds.n_refs
    if batch_size is not None:
        if n_batches is not None:
            raise ValueError("pass n_batches or batch_size, not both")
        n_batches = max(1, round(n / max(1, batch_size)))
    elif n_batches is None:
        raise ValueError("pass n_batches or batch_size")
    n_batches = max(1, min(n_batches, n))
    # candidate cut points: paper boundaries (id i starts a new paper)
    bounds = [
        i for i in range(1, n) if ds.paper_of[i] != ds.paper_of[i - 1]
    ]
    cuts = []
    for j in range(1, n_batches):
        target = round(j * n / n_batches)
        if not bounds:
            break
        best = min(bounds, key=lambda b: abs(b - target))
        if best not in cuts:
            cuts.append(best)
    cuts = sorted(cuts)
    starts = [0] + cuts
    stops = cuts + [n]

    edges = ds.relations.edges.get("coauthor")
    if edges is None:
        edges = np.zeros((0, 2), dtype=np.int64)
    latest = np.maximum(edges[:, 0], edges[:, 1]) if len(edges) else np.zeros(0)

    out = []
    for lo, hi in zip(starts, stops):
        if lo >= hi:
            continue
        sel = (latest >= lo) & (latest < hi) if len(edges) else np.zeros(0, bool)
        out.append(
            ArrivalBatch(
                ids=np.arange(lo, hi, dtype=np.int64),
                names=ds.entities.names[lo:hi],
                truth=ds.entities.truth[lo:hi],
                edges=edges[sel] if len(edges) else edges,
            )
        )
    return out


# ---------------------------------------------------------------------------
# Bipartite 1:1 record-linkage corpus (the assignment-matcher scenario)
# ---------------------------------------------------------------------------


def make_bipartite(
    n_groups: int = 60,
    *,
    double_rate: float = 0.4,
    trap_rate: float = 0.2,
    seed: int = 0,
) -> SynthDataset:
    """Two duplicate-free record sources with known 1:1 ground truth.

    Interleaves a *left* and a *right* source so each true pair is the
    global-id pair ``(2m, 2m + 1)`` — the parity convention the
    assignment and embedding matchers key their sides/buckets on.
    Matching groups are canopy-disjoint (each group shares a distinct
    random name token) and ``paper_of`` is the group id, so
    :func:`arrival_stream`'s paper-boundary cuts yield **group-atomic**
    micro-batches — the streaming deployment contract for 1:1 families
    (a matching group never straddles an ingest).

    Three group shapes:

    * **singleton** — one true pair, identical names (level 3).
    * **double** — two true pairs (level 3) whose cross pairs sit at
      level 2: every family resolves it, the optimum just has to prefer
      the two exact matches over the two near-misses.
    * **trap** — a double plus 6 *anchor* records coauthored with both
      ``L1`` and ``R2``, pushing the crossing pair's shared-coauthor
      count to 6.  Greedy assignment takes the boosted cross edge
      (``2 + 0.25*6 = 3.5 > 3``) and mis-pairs the group; the Hungarian
      optimum keeps the exact matches (``3 + 3 > 3.5 + 2.25``); the
      MLN, with no 1:1 constraint, matches the cross pair *as well*
      (``u = w_sim[2] + 6 w_co > 0``) — the quality separation
      ``benchmarks/fig4_matchers.py`` reports.

    Anchor names are random (level-0 pairs: never candidates) and each
    group contributes an even record count, preserving the parity phase.
    """
    rng = np.random.default_rng(seed)
    consonants = "bcdfghjklmnpqrstvwxz"
    vowels = "aeiou"

    seen: set[str] = set()

    def _word(length: int) -> str:
        while True:
            s = "".join(
                (consonants if i % 2 == 0 else vowels)[
                    int(rng.integers(0, len(consonants if i % 2 == 0 else vowels)))
                ]
                for i in range(length)
            )
            if s not in seen:
                seen.add(s)
                return s

    names: list[str] = []
    truth: list[int] = []
    paper_of: list[int] = []
    coauthor_edges: list[tuple[int, int]] = []
    canon: list[str] = []

    def _add(name: str, author: int, group: int) -> int:
        ref = len(names)
        names.append(name)
        truth.append(author)
        paper_of.append(group)
        return ref

    def _new_author(name: str) -> int:
        canon.append(name)
        return len(canon) - 1

    for g in range(n_groups):
        token = _word(8)
        surname = _word(9)
        r = rng.random()
        kind = "trap" if r < trap_rate else (
            "double" if r < trap_rate + double_rate else "singleton"
        )
        name1 = f"{token} {surname}"
        a1 = _new_author(name1)
        l1 = _add(name1, a1, g)
        r1 = _add(name1, a1, g)
        assert l1 % 2 == 0 and r1 == l1 + 1
        if kind == "singleton":
            continue
        # second pair: same token, surname two *adjacent* substitutions
        # away (chars absent from the original name, so Jaro counts two
        # clean mismatches).  At this name length the cross pairs land
        # at JW ~0.956 -> similarity level 2, while the trigram profile
        # keeps cosine >= the canopy t_loose, so the whole group stays
        # one canopy.
        fresh = [c for c in "abcdefghijklmnopqrstuvwxyz" if c not in name1]
        alt = list(surname)
        alt[3], alt[4] = fresh[0], fresh[1]
        name2 = f"{token} {''.join(alt)}"
        a2 = _new_author(name2)
        l2 = _add(name2, a2, g)
        r2 = _add(name2, a2, g)
        if kind == "trap":
            for _ in range(6):
                anchor = _add(f"zq{_word(7)}", _new_author(f"zq{_word(7)}"), g)
                coauthor_edges.append((l1, anchor))
                coauthor_edges.append((anchor, r2))

    edges = (
        np.asarray(coauthor_edges, dtype=np.int64)
        if coauthor_edges
        else np.zeros((0, 2), dtype=np.int64)
    )
    return SynthDataset(
        entities=EntityTable(names=names, truth=np.asarray(truth, dtype=np.int64)),
        relations=Relations(edges={"coauthor": edges}),
        paper_of=np.asarray(paper_of, dtype=np.int64),
        author_names=canon,
    )
