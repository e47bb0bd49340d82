"""The entity-resolution service mesh: ranks of a ``torch.distributed`` group.

The reference's mesh is a ``jax.sharding.Mesh`` of shape ``(n,)`` over
the axis ``("data",)``, with ``shard_map``/``psum``/``all_gather`` for
collectives.  Here the mesh is :class:`EMMesh`, a thin object over a
process group: one rank a process, each on one device.

**Backend rule**, decided before the group is created
(:func:`choose_backend`) and printed on standard error:

* CPU ranks use gloo.
* CUDA ranks with a card each use NCCL (rank ``r`` takes
  ``cuda:{local_rank % device_count}``, so this holds when there are no
  more ranks on the host than cards).
* Several CUDA ranks on one card use gloo: NCCL refuses two ranks on
  one GPU.  The device collectives — the match-bitset ``all_reduce``
  and the row ``all_gather`` of :mod:`repro_torch.core.parallel` — then
  run through gloo's CUDA versions of those two collectives, which stage
  the tensors through host memory themselves.

Any other layout raises, and nothing tries NCCL and falls back to gloo.
Host objects — the probe's candidate-id union and the digest gather —
always go through a gloo group made beside the device group.  Every
group gets a timeout (``REPRO_SHARD_TIMEOUT_S``, default 300 s), so a
rank that dies does not leave the others blocked for gloo's 30 minutes.

**Training meshes** (the reference's GSPMD half) are
``torch.distributed.device_mesh.DeviceMesh`` objects with named dims:
:func:`make_production_mesh` builds ``(data=16, model=16)`` or
``(pod=2, data=16, model=16)``; ``pod`` is pure data parallelism
(parameters replicated across pods, only the batch sharded over it).  A
sharding (:class:`NamedSharding`) is a mesh plus one DTensor placement
per mesh dim, ``Shard(d)`` or ``Replicate()``, converted from a logical
spec tuple (``PSpec.spec``): a tensor dim whose entry names several axes,
``("pod", "data")``, is ``Shard(d)`` on each of them, the major axis
first, so rank ``(p, d)`` holds the block that JAX gives device
``(p, d)``.  Model code declares specs over ``("data", "model")``;
:func:`pod_spec` rewrites batch-bearing specs so that on a multi-pod mesh
the batch also shards over ``pod``.

The two kinds of mesh stay apart because they serve different engines.
The EM engine needs one flat row split, host-driven collectives counted
by kind, and a gloo host group beside the device group; a training step
needs named dims, one process group a dim (``get_group("pod")``) and
DTensor's placement algebra, which ``DeviceMesh`` gives and ``EMMesh``
would only copy.  :meth:`EMMesh.ranks_of` gives a training mesh's flat
rank view where an EM-side helper (the checkpointer's placement) needs
one.
"""

from __future__ import annotations

import dataclasses
import datetime
import os
import sys
import time

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.kernels.common import mesh_spans_processes, resolve_device

DEFAULT_TIMEOUT_S = 300.0


# ---------------------------------------------------------------------------
# Training meshes: named DeviceMesh dims, logical specs -> DTensor placements
# ---------------------------------------------------------------------------


def make_production_mesh(*, multi_pod: bool = False, device_type: str = "cuda"):
    """The production ``DeviceMesh``: ``(16, 16)`` over ``("data", "model")``,
    or ``(2, 16, 16)`` over ``("pod", "data", "model")``, on ranks 0..n-1
    of the joined process group (which needs at least 256 or 512 ranks; a
    ``fake`` group of that size lays the mesh out without devices)."""
    from torch.distributed.device_mesh import DeviceMesh

    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    ranks = torch.arange(int(np.prod(shape))).reshape(shape)
    return DeviceMesh(device_type, ranks, mesh_dim_names=axes)


def mesh_axes(mesh) -> dict[str, int]:
    """A mesh's axis sizes by name, in mesh order."""
    return dict(zip(mesh.mesh_dim_names, mesh.shape))


def mesh_device(mesh) -> torch.device:
    """This rank's device on a ``DeviceMesh``: its type, and for CUDA the
    current card (``init_em_distributed`` sets it from the backend rule)."""
    if mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(mesh.device_type)


def _entry_axes(e) -> tuple:
    if e is None:
        return ()
    return tuple(e) if isinstance(e, (tuple, list)) else (e,)


def pod_spec(spec: tuple, mesh) -> tuple:
    """Rewrite 'data' -> ('pod', 'data') when the mesh has a pod axis."""
    if "pod" not in mesh.mesh_dim_names:
        return tuple(spec)

    def fix(entry):
        if entry == "data":
            return ("pod", "data")
        if isinstance(entry, (tuple, list)):
            out = []
            for e in entry:
                out.extend(["pod", "data"] if e == "data" else [e])
            return tuple(out)
        return entry

    return tuple(fix(e) for e in spec)


@dataclasses.dataclass(frozen=True, eq=False)
class NamedSharding:
    """A logical spec laid over a ``DeviceMesh``: ``spec`` names mesh axes
    per tensor dim (``None``, an axis, or a tuple of axes, major first);
    ``placements`` holds one DTensor placement per mesh dim."""

    mesh: object
    spec: tuple

    @property
    def placements(self) -> tuple:
        from torch.distributed.tensor import Replicate, Shard

        names = list(self.mesh.mesh_dim_names)
        owner: dict[str, int] = {}
        for d, entry in enumerate(self.spec):
            axes = _entry_axes(entry)
            missing = [a for a in axes if a not in names]
            if missing:
                raise ValueError(f"spec {self.spec} names {missing}, not in mesh {names}")
            order = [names.index(a) for a in axes]
            if order != sorted(order):
                raise ValueError(f"spec entry {entry} is not in mesh order {names}: a "
                                 "DTensor shards one dim over mesh dims major first")
            for a in axes:
                if a in owner:
                    raise ValueError(f"spec {self.spec} shards two dims over {a!r}")
                owner[a] = d
        return tuple(Shard(owner[a]) if a in owner else Replicate() for a in names)

    def block(self, shape, coordinate=None) -> tuple[slice, ...]:
        """The slices of a ``shape`` tensor that the rank at ``coordinate``
        (default: this rank's) holds: each ``Shard(d)`` in mesh order cuts
        dim ``d``'s current piece into ``size`` chunks of ``ceil`` length
        (DTensor's layout; on dims the shard count divides, JAX's)."""
        if coordinate is None:
            coordinate = self.mesh.get_coordinate()
        lo, n = [0] * len(shape), list(shape)
        for c, size, p in zip(coordinate, self.mesh.shape, self.placements):
            if p.is_shard():
                d = p.dim
                chunk = -(-n[d] // size)
                start = min(c * chunk, n[d])
                lo[d] += start
                n[d] = min(chunk, n[d] - start)
        return tuple(slice(a, a + b) for a, b in zip(lo, n))

    def local(self, x) -> torch.Tensor:
        """This rank's block of the whole host array or tensor ``x``, on its
        device."""
        part = x[self.block(x.shape)]
        if isinstance(part, np.ndarray):
            part = np.ascontiguousarray(part)
        return torch.as_tensor(part, device=mesh_device(self.mesh))


def data_sharding(mesh, spec: tuple) -> NamedSharding:
    """The sharding of an *input/state* spec (the batch shards over pod)."""
    return NamedSharding(mesh, pod_spec(spec, mesh))


def param_sharding(mesh, spec: tuple) -> NamedSharding:
    """The sharding of a *parameter* spec (pod-replicated by design)."""
    return NamedSharding(mesh, tuple(spec))


# ---------------------------------------------------------------------------
# EM serving meshes (multi-process sharded resolution)
# ---------------------------------------------------------------------------

# the process group this process joined (init_em_distributed), and the
# meshes made on it: one gloo host group a (device, axis), because
# new_group is itself a collective every rank must reach in step
_joined: dict = {}
_meshes: dict = {}


def _timeout() -> datetime.timedelta:
    return datetime.timedelta(
        seconds=float(os.environ.get("REPRO_SHARD_TIMEOUT_S", DEFAULT_TIMEOUT_S))
    )


def choose_backend(device: torch.device, world_size: int,
                   n_devices: int | None = None) -> str:
    """The device group's backend for ``world_size`` ranks on ``device``'s
    type: gloo on the CPU, NCCL when every CUDA rank has a card of its
    own, gloo when CUDA ranks share a card."""
    if device.type == "cpu":
        return "gloo"
    if device.type != "cuda":
        raise ValueError(f"no collective backend for ranks on {device}")
    n = torch.cuda.device_count() if n_devices is None else n_devices
    if n < 1:
        raise RuntimeError("CUDA ranks asked for, but no CUDA device is visible")
    return "nccl" if world_size <= n else "gloo"


def rank_device(device, local_rank: int) -> torch.device:
    """Rank ``local_rank``'s device: ``cuda:{local_rank % device_count}``
    unless ``device`` says otherwise (``"cpu"``, or that same card)."""
    dev = resolve_device(device)
    if dev.type != "cuda":
        return dev
    want = local_rank % torch.cuda.device_count()
    if dev.index is not None and dev.index != want:
        raise ValueError(
            f"unsupported layout: local rank {local_rank} takes cuda:{want}, "
            f"not {dev} (the backend rule assumes every rank sees every card)"
        )
    return torch.device("cuda", want)


def _local_rank(rank: int) -> int:
    return int(os.environ.get("LOCAL_RANK", rank))


def init_em_distributed(
    coordinator: str | None = None,
    num_processes: int | None = None,
    process_id: int | None = None,
    *,
    device=None,
) -> bool:
    """Join (or skip) a ``torch.distributed`` group for sharded serving.

    Arguments default to the ``REPRO_SHARD_COORD`` / ``REPRO_SHARD_N`` /
    ``REPRO_SHARD_ID`` environment variables, so rank workers need no
    plumbing.  ``REPRO_SHARD_COORD`` is ``host:port`` (a TCP store at
    ``tcp://host:port``) or a full init-method URL such as
    ``file:///path`` (a file store: no port to race for).  Returns False
    — without touching ``torch.distributed`` — when no coordinator is
    configured, so single-process callers can call this unconditionally.
    ``device`` follows :func:`rank_device`; the backend
    :func:`choose_backend`.
    """
    coordinator = coordinator or os.environ.get("REPRO_SHARD_COORD")
    if not coordinator:
        return False
    if _joined:
        return True
    if num_processes is None:
        num_processes = int(os.environ.get("REPRO_SHARD_N", "1"))
    if process_id is None:
        process_id = int(os.environ.get("REPRO_SHARD_ID", "0"))
    dev = rank_device(device, _local_rank(process_id))
    backend = choose_backend(dev, num_processes)
    print(f"repro_torch shard {process_id}/{num_processes}: backend {backend} on {dev}",
          file=sys.stderr, flush=True)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    dist.init_process_group(
        backend,
        init_method=coordinator if "://" in coordinator else "tcp://" + coordinator,
        world_size=num_processes,
        rank=process_id,
        timeout=_timeout(),
    )
    _joined["device"] = dev
    return True


@dataclasses.dataclass(eq=False)
class EMMesh:
    """A 1-D ``("data",)`` mesh of ``size`` ranks, seen from rank ``rank``.

    Device collectives run on the default process group (``backend``);
    host gathers on ``host_group`` (gloo).  A one-rank mesh has no group
    and every collective is the identity.  ``stats`` counts the
    collectives by kind — ``bits`` (match-bitset reductions), ``rows``
    (row gathers), ``union`` (probe unions), ``digest`` — as ``[calls,
    seconds]``, seconds of host wall around each call, the wait for the
    slowest rank included;
    ``rows_evaluated`` counts the bin rows this rank's matcher calls
    evaluated (``run_parallel`` adds to it).
    """

    size: int
    rank: int
    device: torch.device
    backend: str  # "gloo" | "nccl" | "local" (one rank, no group)
    host_group: object = None
    axis_names: tuple[str, ...] = ("data",)

    def __post_init__(self):
        self.reset_stats()

    @classmethod
    def local(cls, device=None, axis: str = "data") -> "EMMesh":
        """The one-rank mesh on ``device``: no group, no collective."""
        dev = resolve_device(device)
        if dev.type == "cuda" and dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
        return cls(size=1, rank=0, device=dev, backend="local", axis_names=(axis,))

    @classmethod
    def ranks_of(cls, mesh) -> "EMMesh":
        """The flat rank view of a training ``DeviceMesh`` spanning the
        joined group: ranks in mesh order (the row-major flattening of its
        coordinate), this rank's device; no host group."""
        coord = mesh.get_coordinate()
        rank = int(np.ravel_multi_index(tuple(coord), tuple(mesh.shape)))
        return cls(size=int(np.prod(mesh.shape)), rank=rank, device=mesh_device(mesh),
                   backend=dist.get_backend() if mesh.size() > 1 else "local",
                   axis_names=tuple(mesh.mesh_dim_names))

    def row_slice(self, n: int) -> tuple[int, int]:
        """This rank's rows of an ``n``-row axis padded to a multiple of
        the rank count: ``[rank * m, (rank + 1) * m)`` clipped to ``n``,
        ``m = ceil(n / size)`` (``torch.chunk``'s split)."""
        m = max(-(-n // self.size), 1)
        lo = min(self.rank * m, n)
        return lo, min(lo + m, n)

    def reset_stats(self) -> None:
        self.stats: dict[str, list] = {}
        self.rows_evaluated = 0

    def _timed(self, what: str, fn):
        t0 = time.perf_counter()
        out = fn()
        if self.backend == "nccl":
            torch.cuda.synchronize(self.device)  # NCCL returns before it is done
        s = self.stats.setdefault(what, [0, 0.0])
        s[0] += 1
        s[1] += time.perf_counter() - t0
        return out

    def reduce_bits(self, bits: torch.Tensor) -> torch.Tensor:
        """OR a bool tensor over the ranks (uint8 ``MAX`` all-reduce)."""
        if not mesh_spans_processes(self):
            return bits
        u8 = bits.to(torch.uint8)
        self._timed("bits", lambda: dist.all_reduce(u8, op=dist.ReduceOp.MAX))
        return u8 > 0

    def gather_rows(self, t: torch.Tensor) -> torch.Tensor:
        """All-gather every rank's equal-shape ``t`` along a new leading
        axis: ``(size, *t.shape)``, rank order."""
        if not mesh_spans_processes(self):
            return t[None]
        send = t.to(torch.uint8) if t.dtype == torch.bool else t.contiguous()
        out = [torch.empty_like(send) for _ in range(self.size)]
        self._timed("rows", lambda: dist.all_gather(out, send))
        got = torch.stack(out)
        return got > 0 if t.dtype == torch.bool else got

    def host_gather(self, arr: np.ndarray, what: str) -> np.ndarray:
        """All-gather a host array over the gloo host group:
        ``(size, *arr.shape)``, rank order."""
        if not mesh_spans_processes(self):
            return np.asarray(arr)[None]
        send = torch.from_numpy(np.ascontiguousarray(arr))
        out = [torch.empty_like(send) for _ in range(self.size)]
        self._timed(what, lambda: dist.all_gather(out, send, group=self.host_group))
        return np.stack([o.numpy() for o in out])


def em_service_mesh(n_shards: int | None = None, device=None, axis: str = "data") -> EMMesh:
    """1-D ``("data",)`` mesh over every rank of the joined process group,
    or the one-rank mesh on ``device`` when this process joined none
    (:func:`repro_torch.core.parallel.make_em_mesh` is this mesh too, so
    the serving stack can hand either to ``run_parallel``)."""
    if not dist.is_available() or not dist.is_initialized():
        if n_shards not in (None, 1):
            raise ValueError(
                f"a {n_shards}-rank mesh needs {n_shards} processes: set "
                "REPRO_SHARD_COORD / REPRO_SHARD_N / REPRO_SHARD_ID in each"
            )
        return EMMesh.local(device, axis)
    n, r = dist.get_world_size(), dist.get_rank()
    if n_shards not in (None, n):
        raise ValueError(f"asked for {n_shards} shards in a group of {n} ranks")
    dev = rank_device(device if device is not None else _joined.get("device"),
                      _local_rank(r))
    key = (dev, axis)
    if key not in _meshes:
        host = dist.new_group(backend="gloo", timeout=_timeout())
        _meshes[key] = EMMesh(size=n, rank=r, device=dev, backend=dist.get_backend(),
                              host_group=host, axis_names=(axis,))
    return _meshes[key]
