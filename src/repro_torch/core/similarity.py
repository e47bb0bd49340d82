"""String similarity: Jaro-Winkler (paper-faithful) + hashed n-gram profiles.

The paper (Appendix B) computes Jaro-Winkler between author names and
discretizes to levels {1, 2, 3}.  We implement exact Jaro-Winkler on the
host for grounding the MLN, and hashed character-n-gram count profiles so
that *blocking* (canopies) runs as dense linear algebra on the GPU via the
``ngram_sim`` CUDA kernel (cosine over profiles).
"""

from __future__ import annotations

import numpy as np

# ---------------------------------------------------------------------------
# Jaro-Winkler (exact, scalar; vectorized drivers below)
# ---------------------------------------------------------------------------


def jaro(s1: str, s2: str) -> float:
    if s1 == s2:
        return 1.0
    len1, len2 = len(s1), len(s2)
    if len1 == 0 or len2 == 0:
        return 0.0
    match_dist = max(len1, len2) // 2 - 1
    match_dist = max(match_dist, 0)
    s1_matches = [False] * len1
    s2_matches = [False] * len2
    matches = 0
    for i, c1 in enumerate(s1):
        lo = max(0, i - match_dist)
        hi = min(len2, i + match_dist + 1)
        for j in range(lo, hi):
            if s2_matches[j] or s2[j] != c1:
                continue
            s1_matches[i] = True
            s2_matches[j] = True
            matches += 1
            break
    if matches == 0:
        return 0.0
    # transpositions
    t = 0
    j = 0
    for i in range(len1):
        if not s1_matches[i]:
            continue
        while not s2_matches[j]:
            j += 1
        if s1[i] != s2[j]:
            t += 1
        j += 1
    t //= 2
    m = float(matches)
    return (m / len1 + m / len2 + (m - t) / m) / 3.0


def jaro_winkler(s1: str, s2: str, p: float = 0.1, max_prefix: int = 4) -> float:
    j = jaro(s1, s2)
    prefix = 0
    for c1, c2 in zip(s1, s2):
        if c1 != c2 or prefix >= max_prefix:
            break
        prefix += 1
    return j + prefix * p * (1.0 - j)


def name_key(name: str) -> str:
    """Surname-first comparison form ("peter wesjor" -> "wesjor peter").

    Jaro-Winkler boosts common *prefixes*; on "first last" order that
    makes "hans quihom" ~ "hans mordin" score 0.8+ (same first name,
    different person).  Bibliographic matching compares surname-first,
    which puts the discriminating token in the prefix.
    """
    t = name.lower().split()
    if len(t) < 2:
        return name.lower()
    return " ".join([t[-1]] + t[:-1])


def block_key(name: str) -> str:
    """Canopy/blocking normal form: "surname first-initial".

    Abbreviated and full forms of one author map to the same key
    ("alessandro rossi" and "a. rossi" -> "rossi a"), so the canopy
    groups them; n-gram cosine on raw strings fails exactly there (the
    long first name dominates the profile).
    """
    t = name.lower().replace(".", "").split()
    if len(t) < 2:
        return name.lower()
    return f"{t[-1]} {t[0][0]}"


def first_name_conflict(a: str, b: str) -> bool:
    """Veto: two *full* (unabbreviated) first names that are genuinely
    different people ("james habsuni" vs "hans habsuni" — the surname
    prefix makes raw JW land at level 2, but no amount of coauthor
    evidence should merge them).  Typo variants ("david"/"davib") keep
    a high first-name JW and are not vetoed; abbreviated forms are
    handled by :func:`abbrev_compatible` instead.
    """
    ta, tb = a.lower().split(), b.lower().split()
    if len(ta) < 2 or len(tb) < 2:
        return False
    fa, fb = ta[0].rstrip("."), tb[0].rstrip(".")
    if not fa or not fb:
        return False
    if fa[0] != fb[0]:
        return True  # "j." can never abbreviate "hans"
    if len(fa) <= 1 or len(fb) <= 1:
        return False  # abbreviated, same initial: compatible
    # typo variants ("david"/"davib") sit at ~0.87+; unrelated first
    # names ("james"/"hans") at ~0.78 and below
    return jaro_winkler(fa, fb) < 0.84


def jw_matrix(names_a: list[str], names_b: list[str]) -> np.ndarray:
    out = np.zeros((len(names_a), len(names_b)), dtype=np.float32)
    for i, a in enumerate(names_a):
        for j, b in enumerate(names_b):
            out[i, j] = jaro_winkler(a, b)
    return out


# ---------------------------------------------------------------------------
# Discretization (paper: similarity in {1,2,3}, 3 = most similar)
# ---------------------------------------------------------------------------

# Levels are *candidate* thresholds: below LEVEL1 the pair is not a
# candidate at all (it never enters a Similar() tuple).
# Calibrated on the surname-first JW score distributions of the
# synthetic HEPTH/DBLP generators (true-pair 10%-quantile ~0.90; false-
# pair 99.5%-quantile ~0.95): level 3 = outright match, level 2 = needs
# two coauthor firings, level 1 = weak candidate (one coauthor).
DEFAULT_THRESHOLDS = (0.86, 0.93, 0.96)  # level >=1, >=2, >=3


def abbrev_compatible(a: str, b: str) -> bool:
    """Abbreviation-aware weak-candidate test ("j. doe" ~ "john doe").

    True iff one name is an initial form of the other: same surname,
    same first initial, and at least one side abbreviated.  Such pairs
    enter the Similar relation at level 1 only — a *weak* candidate
    (negative w_sim[1]) that matches only with coauthor support, which
    is exactly the disambiguation the collective matcher provides
    ("J. Doe" is ambiguous between "John Doe" and "Jane Doe" until a
    matching coauthor appears — paper App. D).
    """
    ta, tb = a.lower().split(), b.lower().split()
    if len(ta) < 2 or len(tb) < 2 or ta[-1] != tb[-1]:
        return False
    fa, fb = ta[0].rstrip("."), tb[0].rstrip(".")
    if not fa or not fb or fa[0] != fb[0]:
        return False
    abbrev = len(fa) == 1 or len(fb) == 1
    return abbrev and fa != fb


def discretize(sim: np.ndarray, thresholds=DEFAULT_THRESHOLDS) -> np.ndarray:
    t1, t2, t3 = thresholds
    lev = np.zeros(sim.shape, dtype=np.int8)
    lev[sim >= t1] = 1
    lev[sim >= t2] = 2
    lev[sim >= t3] = 3
    return lev


# ---------------------------------------------------------------------------
# Hashed character n-gram profiles (dense blocking features)
# ---------------------------------------------------------------------------


def ngram_profiles(
    names: list[str], dim: int = 128, n: int = 3, seed: int = 0
) -> np.ndarray:
    """(N, dim) float32 L2-normalized hashed n-gram count vectors.

    Dense, fixed width => canopy similarity becomes A @ A.T on the device.
    """
    mask = (1 << 64) - 1
    rng_mix = 0x9E3779B97F4A7C15 ^ seed
    out = np.zeros((len(names), dim), dtype=np.float32)
    for idx, name in enumerate(names):
        s = "^" + name.lower() + "$"
        for i in range(max(1, len(s) - n + 1)):
            g = s[i : i + n]
            h = 1469598103934665603
            for ch in g.encode("utf-8"):
                h = ((h ^ ch) * 1099511628211) & mask  # FNV-1a, wrap at 64b
            h ^= rng_mix
            out[idx, h % dim] += 1.0
    norms = np.linalg.norm(out, axis=1, keepdims=True)
    norms[norms == 0.0] = 1.0
    return out / norms
