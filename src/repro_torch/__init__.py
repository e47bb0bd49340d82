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
"""
