"""Large-scale collective entity matching in PyTorch, with CUDA kernels for Hopper.

A port of the JAX package ``repro``, which stays the reference: module
names mirror it (``repro_torch.core.pipeline`` is ``repro.core.pipeline``),
and the tests hold each module against its counterpart.  The package
imports ``torch`` and ``numpy``, never ``jax`` and nothing of ``repro``.

Entry points (``core.pipeline.resolve``/``prepare``, ``core.mln.MLNMatcher``,
``core.matchers.get_matcher``, ``core.cover.build_cover``,
``stream.ResolveService`` and its ``recover``) run on CUDA unless the caller passes
``device="cpu"``; the CUDA kernels under ``csrc/`` are built with ``nvcc``
at first use (see :mod:`repro_torch.kernels.build`).

The curated public surface, ``repro``'s own, re-exported lazily (PEP 562)
so ``import repro_torch`` loads none of the service, the matchers or
``torch.distributed`` until a name is first touched:

* streaming service — :class:`ResolveService`, :class:`ServiceConfig`,
  :class:`ResolveSnapshot`, :class:`IngestReport`, the
  :class:`ServingFrontend` traffic front-end with :class:`ServingConfig`,
  and the sharded :class:`ShardCoordinator` with :class:`ShardContext`;
* matcher plug-in registry — :func:`get_matcher`,
  :func:`register_matcher`, :func:`list_matchers`, :func:`matcher_info`,
  :class:`MatcherInfo` (see :mod:`repro_torch.core.matchers`);
* observability — :func:`get_registry` (metrics snapshot via
  ``get_registry().snapshot()``) and :func:`write_snapshot`.
"""

from __future__ import annotations

_EXPORTS = {
    "IngestReport": "repro_torch.stream.service",
    "ResolveService": "repro_torch.stream.service",
    "ResolveSnapshot": "repro_torch.stream.service",
    "ServiceConfig": "repro_torch.stream.service",
    "ServingConfig": "repro_torch.stream.serving",
    "ServingFrontend": "repro_torch.stream.serving",
    "ShardContext": "repro_torch.stream.shard",
    "ShardCoordinator": "repro_torch.stream.shard",
    "MatcherInfo": "repro_torch.core.matchers",
    "get_matcher": "repro_torch.core.matchers",
    "list_matchers": "repro_torch.core.matchers",
    "matcher_info": "repro_torch.core.matchers",
    "register_matcher": "repro_torch.core.matchers",
    "get_registry": "repro_torch.obs",
    "write_snapshot": "repro_torch.obs",
}

__all__ = sorted(_EXPORTS)


def __getattr__(name: str):
    target = _EXPORTS.get(name)
    if target is None:
        raise AttributeError(f"module 'repro_torch' has no attribute {name!r}")
    import importlib

    return getattr(importlib.import_module(target), name)


def __dir__():
    return sorted(set(globals()) | set(_EXPORTS))
