"""Matcher plug-in registry: the paper's black-box matcher, as an API.

The framework's central claim (§3, Defs. 1–6) is that the neighborhood
decomposition + message passing scales *any* well-behaved EM algorithm.
This package is where "any" becomes concrete: a matcher family registers
itself under a name with a declared **capability surface**
(:class:`MatcherInfo`), and everything downstream — the sequential
drivers, the round-parallel engine, the streaming service, the
conformance test matrix — consumes the family through that declaration
instead of `isinstance` checks.

Capability surface (what a registration declares):

* ``type_ii`` — the family implements Def. 5: ``score(batch, x)``
  (unnormalized log P_E) and ``run_with_messages`` in addition to the
  Type-I ``run``.  MMP (Alg. 3) requires it.
* ``emits_messages`` — ``run_with_messages`` can return non-trivial
  component labels (multi-pair maximal messages, Def. 8).  Families
  whose output needs no joint activation return ``labels == P``
  everywhere; for them NO-MP, SMP and MMP have identical fixpoints.
* ``monotone_entities`` — Def. 3(i) holds (more entities never lose
  matches).  Genuinely false for 1:1 assignment families, where a new
  record can *outcompete* an old match; the property suite skips the
  checker where the family declares it cannot hold.
* ``supermodular`` — Def. 6 holds for ``score`` (hence monotone by
  Prop. 2); checked by the property suite when declared.
* ``device_parallel`` — the family exposes ``parallel_backend()``
  (a ``(kind, cfg)`` grounding key) so :mod:`repro_torch.core.parallel` can
  cache/splice its groundings and fuse its rounds on device.

Every factory takes ``device`` (``None`` means CUDA and raises without a
GPU; pass ``device="cpu"`` for the plain kernel versions on the CPU)
and passes it to the family, which runs its grounding, kernels and
encoder there.

Usage::

    from repro_torch.core.matchers import get_matcher
    matcher = get_matcher("hungarian")            # defaults, on CUDA
    matcher = get_matcher("embedding", encoder="ngram", tau=0.92, device="cpu")

Built-in families: ``mln`` / ``mln_greedy`` (the paper's collective MLN
matcher, :mod:`repro_torch.core.mln`), ``rules`` (dedupalog-style Type-I,
:mod:`repro_torch.core.rules`), ``hungarian`` / ``hungarian_greedy`` (optimal
vs greedy 1:1 bipartite assignment, :mod:`repro_torch.core.matchers.
assignment`), and ``embedding`` (batched-encoder cosine scorer,
:mod:`repro_torch.core.matchers.embedding`).
"""

from __future__ import annotations

import dataclasses
from typing import Callable

from repro_torch.core.matcher import (  # noqa: F401  (re-export: axiom surface)
    TypeIMatcher,
    TypeIIMatcher,
    check_idempotence,
    check_monotone_entities,
    check_monotone_evidence,
    check_monotone_negative,
    check_supermodular,
)


@dataclasses.dataclass(frozen=True)
class MatcherInfo:
    """One registered matcher family: factory + capability declaration."""

    name: str
    factory: Callable[..., object]
    type_ii: bool  # Def. 5: has score() / run_with_messages()
    emits_messages: bool  # can emit multi-pair maximal messages (Def. 8)
    monotone_entities: bool  # Def. 3(i) declared to hold
    supermodular: bool  # Def. 6 declared to hold for score()
    device_parallel: bool  # has parallel_backend() for core.parallel
    description: str = ""

    def build(self, **cfg):
        return self.factory(**cfg)


_REGISTRY: dict[str, MatcherInfo] = {}


def register_matcher(
    name: str,
    factory: Callable[..., object],
    *,
    type_ii: bool,
    emits_messages: bool,
    monotone_entities: bool,
    supermodular: bool,
    device_parallel: bool,
    description: str = "",
) -> MatcherInfo:
    """Register a matcher family under ``name``.

    Re-registering a name replaces the entry (latest wins) so tests can
    shadow a family with an instrumented variant.
    """
    info = MatcherInfo(
        name=name,
        factory=factory,
        type_ii=type_ii,
        emits_messages=emits_messages,
        monotone_entities=monotone_entities,
        supermodular=supermodular,
        device_parallel=device_parallel,
        description=description,
    )
    _REGISTRY[name] = info
    return info


def get_matcher(name: str, **cfg):
    """Instantiate a registered family: ``get_matcher("hungarian")``
    (``cfg`` goes to the factory, ``device`` among it)."""
    return matcher_info(name).build(**cfg)


def matcher_info(name: str) -> MatcherInfo:
    if name not in _REGISTRY:
        raise KeyError(
            f"unknown matcher family {name!r}; registered: {list_matchers()}"
        )
    return _REGISTRY[name]


def list_matchers() -> tuple[str, ...]:
    return tuple(sorted(_REGISTRY))


# --------------------------------------------------------------------------
# Built-in families
# --------------------------------------------------------------------------


def _mln_factory(collective: bool):
    def build(weights=None, **cfg):
        from repro_torch.core.mln import PAPER_LEARNED, MLNMatcher

        return MLNMatcher(
            weights if weights is not None else PAPER_LEARNED,
            collective=collective,
            **cfg,
        )

    return build


def _rules_factory(**cfg):
    from repro_torch.core.rules import RulesMatcher

    return RulesMatcher(**cfg)


def _assignment_factory(optimal: bool):
    def build(**cfg):
        from repro_torch.core.matchers.assignment import AssignmentMatcher

        return AssignmentMatcher(optimal=optimal, **cfg)

    return build


def _embedding_factory(**cfg):
    from repro_torch.core.matchers.embedding import EmbeddingMatcher

    return EmbeddingMatcher(**cfg)


register_matcher(
    "mln",
    _mln_factory(collective=True),
    type_ii=True,
    emits_messages=True,
    monotone_entities=True,
    supermodular=True,
    device_parallel=True,
    description="Paper's collective MLN matcher (Appendix B weights)",
)
register_matcher(
    "mln_greedy",
    _mln_factory(collective=False),
    type_ii=True,
    emits_messages=False,
    monotone_entities=True,
    supermodular=True,
    device_parallel=True,
    description="MLN closure-only ablation (no collective promotion)",
)
register_matcher(
    "rules",
    _rules_factory,
    type_ii=False,
    emits_messages=False,
    monotone_entities=False,
    supermodular=False,
    device_parallel=True,
    description="Dedupalog-style hard-rule Type-I matcher (Appendix C)",
)
register_matcher(
    "hungarian",
    _assignment_factory(optimal=True),
    type_ii=True,
    emits_messages=False,
    monotone_entities=False,  # 1:1 competition: a new record can win a slot
    supermodular=True,  # modular score => supermodular with equality
    device_parallel=False,  # host combinatorial solve; sequential drivers
    description="Optimal 1:1 bipartite assignment (Hungarian) matcher",
)
register_matcher(
    "hungarian_greedy",
    _assignment_factory(optimal=False),
    type_ii=True,
    emits_messages=False,
    monotone_entities=False,
    supermodular=True,
    device_parallel=False,
    description="Greedy mutual-best assignment baseline",
)
register_matcher(
    "embedding",
    _embedding_factory,
    type_ii=True,
    emits_messages=False,
    monotone_entities=True,  # pairwise-independent scores
    supermodular=True,  # modular score
    device_parallel=True,  # host-ground backend kind "embed"
    description="Embedding-similarity matcher (batched encoder forward)",
)

__all__ = [
    "MatcherInfo",
    "TypeIMatcher",
    "TypeIIMatcher",
    "check_idempotence",
    "check_monotone_entities",
    "check_monotone_evidence",
    "check_monotone_negative",
    "check_supermodular",
    "get_matcher",
    "list_matchers",
    "matcher_info",
    "register_matcher",
]
