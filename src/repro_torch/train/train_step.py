"""Train-step factory: microbatched gradient accumulation over a trainable
model, on one device or data-parallel over a mesh of ranks.

``make_train_step(api, opt_cfg, microbatches=n)`` returns
``train_step(model, opt_state, batch) -> (model, opt_state, metrics)``.
``model`` is ``api.load(tree, trainable=True)``; its f32 master
parameters are updated in place, and ``opt_state`` holds the moments
keyed by the model's parameter names (``optimizer.init_opt_state`` of
``dict(model.named_parameters())``).

With ``microbatches > 1`` the batch is split on the host first
(:func:`split_microbatches`): every leaf has a leading microbatch axis,
and the gradients are accumulated in f32 as ``acc + g / n``, microbatch
by microbatch from zero, in the reference's order.  Activation
checkpointing happens inside the model's layer loop
(``cfg.remat_group``, :mod:`repro_torch.models.scan_utils`).

**Over a mesh** (``mesh=``, a ``DeviceMesh`` of ``data`` and/or ``pod``
ranks) every rank holds the whole model and its rows of each
microbatch (:func:`repro_torch.data.corpus.shard_batch`).  The reference
computes one logical program over the global batch; here each rank
accumulates its local gradient, and one bucketed all-reduce a step makes
the mean over the ranks.  Every loss is a token mean with no mask and
every rank holds as many tokens, so the mean of the ranks' means is the
global mean, and the same for the MoE router's aux loss when each rank
holds whole routing groups (:func:`check_moe_groups` raises otherwise).
Every rank then applies the same reduced gradient, so the replicas stay
bit-identical (:func:`replica_digest`).

``compress_pods=True`` (a mesh with a ``pod`` axis) is the reference's
compressed cross-pod step: ``train_step(model, opt_state, err, batch) ->
(model, opt_state, err, metrics)``.  Each pod's gradient is reduced over
its ``data`` ranks at full precision, then across pods through
:func:`repro_torch.train.compress.tree_compressed_psum` leaf by leaf of
the reference's stacked tree, with the residual ``err`` in that layout
(:func:`error_state_of`); then AdamW, and the loss and metrics are
averaged over ``pod``.

**Tensor parallelism** (a mesh whose ``model`` axis has more than one
rank: ``("data", "model")`` or ``("pod", "data", "model")``): the model's
parameters are DTensors laid out by the reference's specs
(:func:`distribute_model`, ``launch/sharding.param_shardings``), and the
batch's leaves DTensors with their rows over the data-parallel axes
(:func:`dtensor_batch`).  The loss runs on them under the ambient mesh
(``models.layers.use_mesh``), so DTensor places the layers' collectives
and the activation pins lay the activations out; the loss is the global
token mean.  Each gradient comes back laid out by DTensor's propagation
(partial sums over ``data``, among others); the microbatches' gradients
are accumulated so and redistributed once to their parameter's layout,
which reduces them over the data-parallel axes only.  AdamW steps each
rank's local shards in place, with the global norm summed over each
leaf's sharded mesh dims (:func:`sharded_global_norm`); the moments are
local shards too.  A checkpoint gathers the full leaves
(:func:`gathered_state`), so it keeps the reference's layout and restores
onto any ``(data, model)`` shape.

Each data-parallel step keeps ``step.stats``: the host seconds in
collectives (synchronized) and the bytes all-reduced by this rank in its
last call.  A tensor-parallel step's collectives are DTensor's and it
keeps no stats: a caller that wants them runs the step inside
``launch.hlo_analysis.OpCounter``, which counts them by kind (and, with
``timed``, synchronizes around each).
"""

from __future__ import annotations

import hashlib
import time

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.data.corpus import batch_dim as _batch_dim
from repro_torch.launch.mesh import mesh_axes, mesh_device
from repro_torch.models.moe import GROUP_SIZE
from repro_torch.models.param import layer_slices, leaves, stacked_tree
from repro_torch.models.registry import ModelAPI
from repro_torch.train import compress as complib
from repro_torch.train.optimizer import OptConfig, adamw_update

BUCKET_ELEMS = 1 << 26  # f32 elements an all-reduce bucket: 256 MB


def split_microbatches(batch: dict, n: int) -> dict:
    """Host-side (B, ...) -> (n, B/n, ...) split, microbatch axis leading."""
    if n <= 1:
        return batch

    def f(x):
        x = np.asarray(x)
        d = _batch_dim(x)
        B = x.shape[d]
        assert B % n == 0, f"batch {B} not divisible by microbatches {n}"
        y = x.reshape(*x.shape[:d], n, B // n, *x.shape[d + 1:])
        return np.moveaxis(y, d, 0)

    return {k: f(v) for k, v in batch.items()}


def microbatched_specs(batch_specs: dict, pspecs: dict, n: int):
    """Abstract batch leaves and spec tuples for a pre-split batch (the dry
    run's): shape (B, ...) -> (n, B/n, ...) as ``meta`` tensors, the spec
    entries shifted right by the new leading (unsharded) axis."""
    if n <= 1:
        return batch_specs, pspecs
    out_s, out_p = {}, {}
    for name, sds in batch_specs.items():
        shape = list(sds.shape)
        d = _batch_dim(sds)
        assert shape[d] % n == 0
        shape[d] //= n
        out_s[name] = torch.empty((n, *shape), dtype=sds.dtype, device="meta")
        out_p[name] = (None, *pspecs[name])
    return out_s, out_p


def check_moe_groups(cfg, local_tokens: int, ranks: int, group_size: int = GROUP_SIZE):
    """Raise unless every MoE routing group of a microbatch lies on one rank.

    The reference routes a microbatch's ``ranks * local_tokens`` tokens in
    groups of ``g = min(group_size, tokens)`` consecutive tokens, and sizes
    each group's capacity from ``g``.  A rank computes its own groups, so
    they are the reference's only when ``g`` divides its share."""
    if ranks == 1 or not cfg.n_experts:
        return
    g = min(group_size, local_tokens * ranks)
    if local_tokens % g:
        raise ValueError(
            f"MoE routing groups of {g} tokens straddle ranks: {ranks} ranks hold "
            f"{local_tokens} tokens each of a microbatch; the data-parallel step needs "
            f"a multiple of {g} tokens a rank (rows a rank x sequence length)")


def replica_digest(named: dict) -> str:
    """A digest of a state's bits: sha256 over each leaf's name and the
    int64 sum of its bits read as integers (exact, in any order, on any
    device), leaves in sorted-name order.  Replicas that agree give one
    digest; a single changed bit changes it."""
    h = hashlib.sha256()
    for name in sorted(named):
        t = named[name].detach().contiguous()
        ints = t.view({8: torch.int64, 4: torch.int32, 2: torch.int16, 1: torch.uint8}[
            t.element_size()])
        h.update(name.encode())
        h.update(int(ints.sum(dtype=torch.int64)).to_bytes(8, "little", signed=True))
    return h.hexdigest()


def state_digest(model, opt: dict) -> str:
    """:func:`replica_digest` of a whole training state: the parameters, the
    moments and the step."""
    named = {f"params/{k}": p for k, p in model.named_parameters()}
    for k in ("m", "v"):
        named.update({f"{k}/{n}": t for n, t in opt[k].items()})
    named["step"] = opt["step"]
    return replica_digest(named)


def replicas_agree(named: dict, group=None) -> tuple[bool, str]:
    """Whether every rank of ``group`` holds a state of this rank's
    :func:`replica_digest`, and that digest."""
    mine = replica_digest(named)
    if not dist.is_initialized() or dist.get_world_size(group) == 1:
        return True, mine
    got = [None] * dist.get_world_size(group)
    dist.all_gather_object(got, mine, group=group)
    return all(d == mine for d in got), mine


def tensor_parallel(mesh) -> bool:
    """Whether ``mesh`` lays the model over a ``model`` axis of more than one rank."""
    return mesh is not None and mesh_axes(mesh).get("model", 1) > 1


def data_parallel_group(mesh):
    """The process group of a mesh's data-parallel ranks (every rank; a
    tensor-parallel mesh reduces over DTensor's groups, and this is the
    group of every rank)."""
    sizes = mesh_axes(mesh)
    if tensor_parallel(mesh):
        return dist.group.WORLD
    if len(sizes) == 1:
        return mesh.get_group()
    if mesh.size() != dist.get_world_size():
        raise ValueError(f"a {mesh.shape} mesh in a group of {dist.get_world_size()} "
                         "ranks: the data-parallel mesh spans every rank")
    return dist.group.WORLD


def error_state_of(model) -> dict:
    """Zero f32 residuals of the compressed step, on the model's device, in
    the reference's stacked layout of its parameters."""
    params = dict(model.named_parameters())
    shapes = stacked_tree({k: torch.empty(p.shape, device="meta") for k, p in params.items()})
    return complib.init_error_state(shapes, device=next(iter(params.values())).device)


class _Collectives:
    """Bucketed mean all-reduces on a group, timed on the host clock."""

    def __init__(self, device):
        self.device = device
        self.stats = {"collective_s": 0.0, "bytes": 0}

    def reset(self):
        self.stats.update(collective_s=0.0, bytes=0)

    def timed(self, fn):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        t0 = time.perf_counter()
        out = fn()
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self.stats["collective_s"] += time.perf_counter() - t0
        return out

    def mean(self, named: dict, group) -> dict:
        """Each tensor's mean over ``group``: f32 buckets of at most
        ``BUCKET_ELEMS`` elements, summed by one all-reduce each and divided
        by the rank count; returns views of the buckets."""
        n = dist.get_world_size(group)
        out, bucket, size = {}, [], 0
        names = list(named)
        for i, name in enumerate(names):
            bucket.append(name)
            size += named[name].numel()
            if size < BUCKET_ELEMS and i + 1 < len(names):
                continue
            flat = torch.cat([named[k].float().reshape(-1) for k in bucket])
            self.timed(lambda: dist.all_reduce(flat, group=group))
            self.stats["bytes"] += flat.numel() * 4
            flat.div_(n)
            for k, part in zip(bucket, flat.split([named[k].numel() for k in bucket])):
                out[k] = part.view(named[k].shape)
            bucket, size = [], 0
        return out

    def scalars_mean(self, values: dict, group) -> dict:
        names = sorted(values)
        vec = torch.stack([values[k].float() for k in names])
        self.timed(lambda: dist.all_reduce(vec, group=group))
        vec = vec / dist.get_world_size(group)
        return dict(zip(names, vec.unbind()))


def make_train_step(api: ModelAPI, opt_cfg: OptConfig, *, microbatches: int = 1,
                    compress_pods: bool = False, mesh=None):
    """Build the train step for this model (see the module docstring)."""
    if compress_pods and (mesh is None or "pod" not in mesh.mesh_dim_names):
        raise ValueError("compress_pods=True needs a mesh with a 'pod' axis")
    if tensor_parallel(mesh):
        if compress_pods:
            raise ValueError("the compressed cross-pod step is data-parallel: its mesh "
                             "has no model axis of more than one rank")
        return _tensor_parallel_step(api, opt_cfg, microbatches, mesh)
    ranks = int(np.prod(mesh.shape)) if mesh is not None else 1
    if mesh is not None:
        dp_group = data_parallel_group(mesh)

    def grads_of(model, mb):
        names, params = zip(*model.named_parameters())
        loss, metrics = api.loss(model, mb)
        grads = torch.autograd.grad(loss, params, allow_unused=True)
        # a leaf the loss never reads (Whisper's cross-attention biases)
        # has the gradient 0, as under jax.grad
        grads = {n: torch.zeros_like(p) if g is None else g
                 for n, p, g in zip(names, params, grads)}
        return loss.detach(), {k: v.detach() for k, v in metrics.items()}, grads

    def compute_grads(model, batch):
        tokens = batch["tokens"]
        check_moe_groups(api.cfg, tokens[0].numel() if microbatches > 1 else tokens.numel(),
                         ranks)
        if microbatches == 1:
            return grads_of(model, batch)
        acc, losses, metricses = None, [], []
        for i in range(microbatches):
            loss, metrics, grads = grads_of(model, {k: v[i] for k, v in batch.items()})
            if acc is None:
                acc = {n: torch.zeros(g.shape, dtype=torch.float32, device=g.device)
                       for n, g in grads.items()}
            acc = {n: acc[n] + grads[n].float() / microbatches for n in acc}
            losses.append(loss)
            metricses.append(metrics)
        metrics = {k: torch.stack([m[k] for m in metricses]).mean() for k in metricses[0]}
        return torch.stack(losses).mean(), metrics, acc

    def apply(model, grads, opt_state):
        params = dict(model.named_parameters())
        new_params, opt_state, opt_metrics = adamw_update(opt_cfg, params, grads, opt_state)
        with torch.no_grad():
            for name, p in params.items():
                p.copy_(new_params[name])
        return opt_state, opt_metrics

    if mesh is None:
        def train_step(model, opt_state, batch):
            loss, metrics, grads = compute_grads(model, batch)
            opt_state, opt_metrics = apply(model, grads, opt_state)
            return model, opt_state, {"loss": loss, **metrics, **opt_metrics}

        return train_step

    comm = _Collectives(mesh_device(mesh))

    if not compress_pods:
        def train_step(model, opt_state, batch):
            comm.reset()
            loss, metrics, grads = compute_grads(model, batch)
            grads = comm.mean(grads, dp_group)
            means = comm.scalars_mean({"loss": loss, **metrics}, dp_group)
            opt_state, opt_metrics = apply(model, grads, opt_state)
            return model, opt_state, {**means, **opt_metrics}

        train_step.stats = comm.stats
        return train_step

    pod_group = mesh.get_group("pod")
    inner = mesh_axes(mesh).get("data", 1) > 1
    data_group = mesh.get_group("data") if inner else None

    def train_step(model, opt_state, err, batch):
        comm.reset()
        loss, metrics, grads = compute_grads(model, batch)
        values = {"loss": loss, **metrics}
        if inner:  # the pod's gradient: full precision over its data ranks
            grads = comm.mean(grads, data_group)
            values = comm.scalars_mean(values, data_group)
        names = list(grads)
        stacked = stacked_tree(grads)
        del grads
        out, err = comm.timed(lambda: complib.tree_compressed_psum(stacked, pod_group, err))
        comm.stats["bytes"] += sum(4 * t.numel() + 4 for t in leaves(stacked))
        del stacked
        opt_state, opt_metrics = apply(model, layer_slices(out, names), opt_state)
        values = comm.scalars_mean(values, pod_group)
        return model, opt_state, err, {**values, **opt_metrics}

    train_step.stats = comm.stats
    return train_step



# ---------------------------------------------------------------------------
# Tensor parallelism over ``model``
# ---------------------------------------------------------------------------


def param_layout(api: ModelAPI, mesh, names, specs=None) -> dict:
    """Each parameter name's :class:`~repro_torch.launch.mesh.NamedSharding`
    under the reference's layout (``launch/sharding.param_shardings`` of
    ``specs``, by default the model's): a layer's leaf takes its stacked
    leaf's spec without the layer axis."""
    from repro_torch.launch.mesh import NamedSharding
    from repro_torch.launch.sharding import param_shardings

    tree = param_shardings(api.param_specs() if specs is None else specs, mesh)
    out = {}
    for name, ns in layer_slices_of(tree, names).items():
        spec = ns.spec[1:] if any(part.isdigit() for part in name.split(".")) else ns.spec
        out[name] = NamedSharding(mesh, spec)
    return out


def layer_slices_of(tree: dict, names) -> dict:
    """The leaf of ``tree`` (stacked, reference-shaped) that each parameter
    name reads, without indexing it."""
    out = {}
    for name in names:
        node = tree
        for part in name.split("."):
            if not part.isdigit():
                node = node[part]
        out[name] = node
    return out


def distribute_model(model, api: ModelAPI, mesh, specs=None):
    """Lay a whole-leaf model out over ``mesh`` (by ``specs``, the dry run's
    FSDP or pure-DP layouts; by default the model's own): every parameter
    becomes a DTensor parameter holding this rank's block of it (no
    collective; every rank holds the same whole model first).  Returns the
    model."""
    from torch import nn
    from torch.distributed.tensor import DTensor

    named = dict(model.named_parameters())
    layout = param_layout(api, mesh, named, specs)
    for name, p in named.items():
        ns = layout[name]
        local = p.detach()[ns.block(p.shape)].contiguous()
        dt = DTensor.from_local(local, mesh, ns.placements, run_check=False,
                                shape=p.shape, stride=p.detach().contiguous().stride())
        owner = model.get_submodule(name.rpartition(".")[0]) if "." in name else model
        setattr(owner, name.rpartition(".")[2], nn.Parameter(dt, requires_grad=p.requires_grad))
    return model


def dtensor_batch(batch: dict, mesh, data_axes=("pod", "data"), microbatched: bool = False):
    """This rank's rows of each batch leaf (:func:`repro_torch.data.corpus.
    shard_batch`'s) as DTensors over ``mesh``: the batch dim sharded over
    the data-parallel axes, replicated over ``model``."""
    from torch.distributed.tensor import DTensor

    from repro_torch.launch.mesh import NamedSharding

    axes = tuple(a for a in data_axes if a in mesh.mesh_dim_names) or None
    out = {}
    for k, v in batch.items():
        d = _batch_dim(v[0] if microbatched else v) + int(microbatched)
        spec = [None] * v.ndim
        spec[d] = axes
        out[k] = DTensor.from_local(v, mesh, NamedSharding(mesh, tuple(spec)).placements,
                                    run_check=False)
    return out


def sharded_global_norm(grads: dict, placements: dict, mesh):
    """The global norm of a tree whose leaves are this rank's shards: each
    leaf's sum of squares is summed over the mesh dims that shard it (one
    all-reduce per set of such dims), then over the leaves in sorted order."""
    groups: dict = {}
    for name in sorted(grads):
        dims = tuple(i for i, p in enumerate(placements[name]) if p.is_shard())
        sq = torch.sum(torch.square(grads[name].float()))
        groups[dims] = sq if dims not in groups else groups[dims] + sq
    total = None
    for dims in sorted(groups):
        sq = groups[dims]
        for i in dims:
            dist.all_reduce(sq, group=mesh.get_group(i))
        total = sq if total is None else total + sq
    return torch.sqrt(total)


def gathered_state(model, opt: dict | None = None) -> tuple[dict, dict | None]:
    """The whole leaves of a tensor-parallel model's parameters, and of its
    moments (this rank's shards, laid out as their parameters); a collective
    every rank makes.  A model of whole leaves is returned as it is."""
    from torch.distributed.tensor import DTensor

    named = {k: p.detach() for k, p in model.named_parameters()}
    if not any(isinstance(p, DTensor) for p in named.values()):
        return named, opt
    params = {k: p.full_tensor() for k, p in named.items()}
    if opt is None:
        return params, None
    return params, {"m": whole_leaves(model, opt["m"]), "v": whole_leaves(model, opt["v"]),
                    "step": opt["step"]}


def whole_leaves(model, shards: dict) -> dict:
    """The whole tensors of this rank's ``shards`` of a tensor-parallel
    model's leaves (moments, gradients), keyed and laid out as its
    parameters; a collective every rank makes."""
    from torch.distributed.tensor import DTensor

    named = dict(model.named_parameters())
    out = {}
    for name, t in shards.items():
        p = named[name]
        out[name] = DTensor.from_local(t, p.device_mesh, p.placements, run_check=False,
                                       shape=p.shape, stride=p.stride()).full_tensor()
    return out


def local_opt_state(model) -> dict:
    """Zero moments of this rank's shards, and ``step`` 0."""
    from repro_torch.train.optimizer import init_opt_state

    return init_opt_state({k: p.to_local() for k, p in model.named_parameters()})


def tp_replicas_agree(model, opt: dict, mesh) -> tuple[bool, str]:
    """Whether the ranks that should hold the same bits do: each leaf's
    block (parameter and moments) equal on every rank that holds the same
    block of it (the same coordinate on the mesh dims that shard it), and
    the step equal everywhere.  Returns the verdict and this rank's digest
    of its blocks."""
    coord = tuple(mesh.get_coordinate())
    mine = {}
    for name, p in model.named_parameters():
        key = tuple(c for c, pl in zip(coord, p.placements) if pl.is_shard())
        mine[name] = (key, replica_digest({"p": p.detach().to_local(), "m": opt["m"][name],
                                           "v": opt["v"][name]}))
    mine["step"] = ((), replica_digest({"step": opt["step"]}))
    got = [None] * dist.get_world_size()
    dist.all_gather_object(got, mine)
    ok = all(their[name][1] == digest for their in got
             for name, (key, digest) in mine.items() if their[name][0] == key)
    return ok, hashlib.sha256("".join(d for _, (_, d) in sorted(mine.items())).encode()
                              ).hexdigest()


def tensor_parallel_grads(api: ModelAPI, model, batch: dict, mesh, microbatches: int = 1):
    """The loss and metrics (means over the microbatches, plain tensors), each
    parameter's gradient (this rank's shard, f32, in its parameter's
    layout: reduced over the data-parallel axes) and their global norm, of
    a tensor-parallel model on a batch of DTensors (:func:`dtensor_batch`;
    pre-split into ``microbatches``)."""
    from torch.distributed.tensor import DTensor
    from torch.distributed.tensor.experimental import implicit_replication

    from repro_torch.models.layers import use_mesh

    def whole(t):
        return t.full_tensor() if isinstance(t, DTensor) else t

    names, params = zip(*model.named_parameters())
    tokens = batch["tokens"]
    mb0 = tokens[0] if microbatches > 1 else tokens
    dp_ranks = int(np.prod([mesh_axes(mesh).get(a, 1) for a in ("pod", "data")]))
    check_moe_groups(api.cfg, mb0.to_local().numel(), dp_ranks)
    with use_mesh(mesh), implicit_replication():
        acc, losses, metricses = None, [], []
        for i in range(microbatches):
            mb = {k: v[i] for k, v in batch.items()} if microbatches > 1 else batch
            loss, metrics = api.loss(model, mb)
            grads = torch.autograd.grad(loss, params, allow_unused=True)
            grads = [torch.zeros_like(p) if g is None else g for p, g in zip(params, grads)]
            if acc is None:
                acc = [torch.zeros_like(g, dtype=torch.float32) for g in grads]
            acc = [a + g.float() / microbatches for a, g in zip(acc, grads)]
            losses.append(whole(loss.detach()))
            metricses.append({k: whole(v.detach()) for k, v in metrics.items()})
        grads = {n: g.redistribute(mesh, p.placements).to_local()
                 for n, p, g in zip(names, params, acc)}
        values = {"loss": torch.stack(losses).mean()}
        for k in metricses[0]:
            values[k] = torch.stack([m[k] for m in metricses]).mean()
        norm = sharded_global_norm(grads, {n: p.placements for n, p in zip(names, params)}, mesh)
    return values, grads, norm


def _tensor_parallel_step(api: ModelAPI, opt_cfg: OptConfig, microbatches: int, mesh):
    """The train step over a tensor-parallel mesh (module docstring)."""

    def train_step(model, opt_state, batch):
        values, grads, norm = tensor_parallel_grads(api, model, batch, mesh, microbatches)
        names = list(grads)
        params = dict(model.named_parameters())
        local = {n: params[n].detach().to_local() for n in names}
        new, opt_state, opt_metrics = adamw_update(opt_cfg, local, grads, opt_state, norm=norm)
        with torch.no_grad():
            for n in names:
                local[n].copy_(new[n])
        return model, opt_state, {**values, **opt_metrics}

    return train_step
