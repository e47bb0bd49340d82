"""Parameter declarations: shapes, axis names and init laws.

Models declare their parameters as a tree (nested ``dict``) of
:class:`PSpec`.  From that one declaration come

* ``init_params``  — materialized tensors on a device, one explicit
  ``torch.Generator`` per leaf, each leaf cast to its declared dtype as it
  is drawn (:func:`in_bf16` declares the leaves a model computes with);
* ``abstract_params`` — ``meta``-device stand-ins (shapes and dtypes, no
  storage), PyTorch's counterpart of ``jax.ShapeDtypeStruct``;
* ``shardings``    — a :class:`repro_torch.launch.mesh.NamedSharding` tree
  over a ``DeviceMesh`` (DTensor placements per mesh dim);
* ``param_count``  — the exact parameter count.

A loaded model is a tree of :class:`Params` modules, read as ``p[name]``
the way the layer functions read the reference's parameter dicts.  A
served model holds frozen leaves at their compute dtypes
(:func:`layer_group`); a trainable one (``load(..., trainable=True)``)
holds every leaf as an f32 master :func:`master`, cast with ``mp()`` at
each use, as the reference trains.  :func:`stacked_tree` and
:func:`layer_slices` carry a model's per-layer tensors to the reference's
stacked tree and back.

``PSpec.spec`` names the logical mesh axes of each dimension as a plain
tuple (``("model", None)``), the reference's ``PartitionSpec`` entries;
:func:`filter_spec` drops the axes a physical mesh lacks (the ``model``
axis of a data-parallel mesh).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable

import numpy as np
import torch
from torch import nn

from repro_torch.kernels.common import resolve_device

# Layer leaves the reference reads in f32, without its mp() cast: the MoE
# router, MLA's q_norm and kv_norm scales, the SSM's A_log and D.  Rounding
# them to bf16 would move expert choices and the recurrence.
F32_LEAVES = frozenset({"router", "q_norm", "kv_norm", "A_log", "D"})


@dataclasses.dataclass(frozen=True)
class PSpec:
    """One parameter tensor: shape, logical axes, initialization."""

    shape: tuple[int, ...]
    spec: tuple = ()
    init: str = "normal"  # 'normal' | 'zeros' | 'ones' | 'embed' | 'ssm_dt' | 'ssm_a'
    scale: float | None = None  # None -> 1/sqrt(fan_in)
    dtype: Any = torch.float32

    @property
    def size(self) -> int:
        return int(np.prod(self.shape)) if self.shape else 1


def _is_leaf(x) -> bool:
    return isinstance(x, PSpec)


def spec_tree_map(fn: Callable[[PSpec], Any], tree):
    """Apply ``fn`` to every PSpec of a nested dict, keeping its structure."""
    if _is_leaf(tree):
        return fn(tree)
    return {k: spec_tree_map(fn, v) for k, v in tree.items()}


def leaves(tree) -> list:
    """The leaves of a nested dict in sorted-key order (JAX's flattening order)."""
    if not isinstance(tree, dict):
        return [tree]
    return [leaf for k in sorted(tree) for leaf in leaves(tree[k])]


def stack(n: int, tree):
    """Prepend a stacked-layer axis of size n to every PSpec in a tree."""
    return spec_tree_map(
        lambda ps: dataclasses.replace(ps, shape=(n, *ps.shape), spec=(None, *ps.spec)),
        tree,
    )


def in_bf16(tree):
    """``tree`` with every leaf declared bf16: the projections, biases and
    expert weights that the families' ``load`` casts to bf16.  The leaves a
    model reads in f32 (``F32_LEAVES``, embeddings, LM heads, norms,
    learned positions) keep the default f32."""
    return spec_tree_map(lambda ps: dataclasses.replace(ps, dtype=torch.bfloat16), tree)


def in_f32(tree):
    """``tree`` with every leaf declared f32: the training draw, in the
    reference's dtype (its ``init_params`` draws every leaf in f32)."""
    return spec_tree_map(lambda ps: dataclasses.replace(ps, dtype=torch.float32), tree)


def unported(what: str, item: int):
    return NotImplementedError(f"{what} is not ported yet (ROADMAP.md Queue 1 item {item})")


def unported_fn(name: str, item: int):
    """A stand-in for the reference's function ``name`` that raises
    :func:`unported`."""
    def stub(*args, **kwargs):
        raise unported(name, item)

    stub.__name__ = stub.__qualname__ = name
    return stub


def abstract_params(tree):
    """``meta``-device tensors of each leaf's shape and dtype (no storage)."""
    return spec_tree_map(lambda ps: torch.empty(ps.shape, dtype=ps.dtype, device="meta"), tree)


def filter_spec(spec: tuple, mesh) -> tuple:
    """Drop mesh axes the physical mesh does not have (e.g. one rank)."""
    names = set(mesh.mesh_dim_names)

    def keep(entry):
        if entry is None:
            return None
        if isinstance(entry, (tuple, list)):
            kept = tuple(e for e in entry if e in names)
            return kept if kept else None
        return entry if entry in names else None

    return tuple(keep(e) for e in spec)


def shardings(tree, mesh):
    """The :class:`~repro_torch.launch.mesh.NamedSharding` tree of a PSpec
    tree over a ``DeviceMesh``."""
    from repro_torch.launch.mesh import NamedSharding

    return spec_tree_map(lambda ps: NamedSharding(mesh, filter_spec(ps.spec, mesh)), tree)


def _leaf_seed(seed: int, index: int) -> int:
    return int(np.random.SeedSequence([seed, index]).generate_state(1, np.uint64)[0])


def _materialize(ps: PSpec, gen: torch.Generator, device) -> torch.Tensor:
    f32 = torch.float32
    if ps.init == "zeros":
        return torch.zeros(ps.shape, dtype=ps.dtype, device=device)
    if ps.init == "ones":
        return torch.ones(ps.shape, dtype=ps.dtype, device=device)
    if ps.init == "ssm_a":
        # mamba A_log init: log(1..N) broadcast over channels
        n = ps.shape[-1]
        a = torch.log(torch.arange(1, n + 1, dtype=f32, device=device))
        return a.expand(ps.shape).to(ps.dtype).clone()
    if ps.init == "ssm_dt":
        # dt bias ~ softplus^-1 of uniform(1e-3, 1e-1)
        u = torch.rand(ps.shape, generator=gen, dtype=f32, device=device) * (1e-1 - 1e-3) + 1e-3
        return torch.log(torch.expm1(u)).to(ps.dtype)
    fan_in = ps.shape[-2] if len(ps.shape) >= 2 else max(ps.shape[-1], 1)
    if ps.init == "embed":
        fan_in = 1.0
    scale = ps.scale if ps.scale is not None else 1.0 / math.sqrt(fan_in)
    w = torch.randn(ps.shape, generator=gen, dtype=f32, device=device)
    return w.mul_(scale).to(ps.dtype)


def init_params(tree, seed: int = 0, device=None):
    """Materialize a PSpec tree into tensors on ``device`` (``None``: CUDA,
    which raises without a GPU; pass ``device="cpu"`` for the CPU).

    Leaf ``i`` (in sorted-key order) draws from its own generator on the
    device, seeded from ``(seed, i)``, under the reference's init laws:
    normal with scale 1/sqrt(fan_in), embeddings at 0.02, zeros, ones.
    Each leaf is drawn in f32 and cast to its declared dtype at once, so
    the peak is the tree at its declared dtypes plus the largest leaf in
    f32; a bf16 leaf holds the values ``load`` would have cast from an f32
    draw.
    The draws are not JAX's: tests that need the reference's weights
    carry them across (``interop.lm_params_from_numpy``).
    """
    device = resolve_device(device)
    index = iter(range(len(leaves(tree))))

    def walk(t):
        if _is_leaf(t):
            gen = torch.Generator(device=device)
            gen.manual_seed(_leaf_seed(seed, next(index)))
            return _materialize(t, gen, device)
        return {k: walk(t[k]) for k in sorted(t)}

    return walk(tree)


def param_count(tree) -> int:
    return sum(ps.size for ps in leaves(tree))


class Params(nn.Module):
    """A module whose parameters and submodules also read as ``p[name]``."""

    def __getitem__(self, name: str):
        return getattr(self, name)


def frozen(t: torch.Tensor) -> nn.Parameter:
    return nn.Parameter(t, requires_grad=False)


def master(t: torch.Tensor) -> nn.Parameter:
    """A trainable f32 copy of ``t``: the reference's f32 master, cast with
    mp() at each use."""
    return nn.Parameter(t.detach().float().clone(), requires_grad=True)


def f32_param(t: torch.Tensor, trainable: bool = False) -> nn.Parameter:
    """A leaf the model reads in f32 (norms, embeddings, heads)."""
    return master(t) if trainable else frozen(t.float())


def layer_group(stacked: dict, i: int, trainable: bool = False) -> Params:
    """Layer ``i``'s slice of a stacked parameter group.

    Served (``trainable=False``): projections and biases go to bf16 once,
    here (the reference keeps f32 masters and casts them with mp() at
    every use, which gives the same numbers); a leaf already drawn in bf16
    is kept as a view of its stacked tensor.  The leaves in ``F32_LEAVES``
    stay f32, copied out of the stacked tensor.  Trainable: every leaf an
    f32 :func:`master`."""
    g = Params()
    for name in sorted(stacked):
        leaf = stacked[name][i]
        if trainable:
            leaf = master(leaf)
        elif name in F32_LEAVES:
            leaf = frozen(leaf.float().clone())
        else:
            leaf = frozen(leaf.to(torch.bfloat16))
        g.register_parameter(name, leaf)
    return g


def _split_key(key: str) -> tuple[tuple[str, ...], int | None]:
    """A state-dict key's path in the reference's tree and its layer index:
    ``"layers.3.attn.wq"`` -> ``(("layers", "attn", "wq"), 3)``."""
    parts = key.split(".")
    index = [int(p) for p in parts if p.isdigit()]
    return tuple(p for p in parts if not p.isdigit()), (index[0] if index else None)


def stacked_tree(flat: dict) -> dict:
    """The reference-shaped tree of per-layer tensors keyed by state-dict
    names: each key's numeric part is its index on the stacked axis
    (``layers.3.attn.wq`` is ``tree["layers"]["attn"]["wq"][3]``)."""
    groups: dict = {}
    for key, t in flat.items():
        path, i = _split_key(key)
        groups.setdefault(path, []).append((i, t))
    tree: dict = {}
    for path, items in groups.items():
        node = tree
        for name in path[:-1]:
            node = node.setdefault(name, {})
        if items[0][0] is None:
            node[path[-1]] = items[0][1]
        else:
            node[path[-1]] = torch.stack([t for _, t in sorted(items, key=lambda it: it[0])])
    return tree


def layer_slices(tree: dict, keys) -> dict:
    """The inverse of :func:`stacked_tree`: each state-dict key's tensor,
    read out of the stacked ``tree`` (a view of its stacked leaf)."""
    out = {}
    for key in keys:
        path, i = _split_key(key)
        node = tree
        for name in path:
            node = node[name]
        out[key] = node if i is None else node[i]
    return out
