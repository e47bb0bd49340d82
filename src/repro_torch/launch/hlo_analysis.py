"""Per-rank accounting of a partitioned step: operations, bytes, collectives.

The reference reads XLA's compiled, partitioned program as text
(``compiled.as_text()``), recovers each ``while`` loop's trip count, and
sums per device the FLOPs of its dots, convolutions and elementwise ops,
an HBM-traffic proxy, and every collective with its bytes, replica groups
and whether those groups cross a pod.  The port compiles no program, so it
has no HLO text and no parser: :class:`OpCounter` is a
``TorchDispatchMode`` that sees the operations one rank runs, once
DTensor has desugared each global op into local ops and collectives
(modes run before tensor subclasses; returning ``NotImplemented`` for a
DTensor op lets DTensor run and hands its local ops back).  Shapes are
then local, so every number is per rank, as the reference's are per
device.  :func:`analyze` turns its records into the reference's keys.

What has no counterpart, and why:

* **loop trip counts** (the reference's ``known_trip_count`` and its
  condition-constant recovery): the dry run traces one microbatch and one
  remat group of layers and scales the records itself
  (:meth:`OpCounter.scaled`), so there is no loop to find;
* **fusion boundaries**: eager PyTorch has none, so the bytes proxy counts
  each operation's result, and the operands of matrix products and
  reductions, once (the reference counts a fusion's boundary);
* **``bf16_upcast_bytes``**: XLA's CPU backend rewrites bf16 buffers into
  f32 round trips, an artefact of lowering for the host; no such rewrite
  happens here, so it is 0;
* ``unknown_whiles`` counts the host loops of unknown trip count that the
  caller ran once (the EM matcher's fixpoints, one read of a change flag
  each: :attr:`Counts.host_reads`), as the reference counts its
  ``while`` loops whose trip count it could not recover.

Kept from the reference: :data:`WIRE_FACTOR` (an all-reduce moves its
bytes twice, reduce-scatter then all-gather), the cross-pod rule (a
group whose ranks fall on both sides of ``pod_boundary``), and the sums
of :func:`analyze`.
"""

from __future__ import annotations

import dataclasses
import time
import weakref

import torch
from torch.utils._python_dispatch import TorchDispatchMode

WIRE_FACTOR = {
    "all-reduce": 2.0, "all-gather": 1.0, "reduce-scatter": 1.0,
    "all-to-all": 1.0, "collective-permute": 1.0, "ragged-all-to-all": 1.0,
}

# collectives by the reference's HLO names: the functional ones DTensor
# issues, and the c10d ones of ``torch.distributed`` calls
COLLECTIVE_KINDS = {
    "_c10d_functional": {
        "all_reduce": "all-reduce",
        "all_reduce_coalesced": "all-reduce",
        "all_gather_into_tensor": "all-gather",
        "all_gather_into_tensor_coalesced": "all-gather",
        "reduce_scatter_tensor": "reduce-scatter",
        "reduce_scatter_tensor_coalesced": "reduce-scatter",
        "all_to_all_single": "all-to-all",
        "broadcast": "collective-permute",
    },
    "c10d": {
        "allreduce_": "all-reduce",
        "allgather_": "all-gather",
        "_allgather_base_": "all-gather",
        "allgather_into_tensor_coalesced_": "all-gather",
        "reduce_scatter_": "reduce-scatter",
        "_reduce_scatter_base_": "reduce-scatter",
        "alltoall_": "all-to-all",
        "alltoall_base_": "all-to-all",
        "broadcast_": "collective-permute",
    },
}

# products whose operands are read from memory (the reference counts a
# dot's operands; an elementwise op's operands are fused away)
_READS_OPERANDS = {"mm", "addmm", "bmm", "baddbmm", "convolution", "sum", "mean", "amax",
                   "max", "logsumexp", "_softmax", "_log_softmax", "index_select", "gather",
                   "index", "embedding", "scatter", "index_copy", "index_put", "cat"}


def _dtensor():
    from torch.distributed.tensor import DTensor

    return DTensor


def _flop_registry():
    from torch.utils.flop_counter import flop_registry

    return flop_registry


def _tensors(tree):
    out = []
    for a in tree if isinstance(tree, (list, tuple)) else (tree,):
        if isinstance(a, torch.Tensor):
            out.append(a)
        elif isinstance(a, (list, tuple)):
            out.extend(_tensors(a))
    return out


def _group_ranks(args, kwargs, functional: bool) -> tuple[int, ...]:
    """The global ranks of a collective's group: a functional collective
    names its group, a c10d one passes it (every rank when it cannot be
    read back)."""
    import torch.distributed as dist

    if functional:
        from torch.distributed.distributed_c10d import _resolve_process_group

        name = args[-1] if isinstance(args[-1], str) else kwargs.get("group_name")
        return tuple(dist.get_process_group_ranks(_resolve_process_group(name)))
    for a in args:
        if isinstance(a, torch.ScriptObject):
            try:
                pg = dist.ProcessGroup.unbox(a)
                return tuple(dist.get_process_group_ranks(pg))
            except (AttributeError, RuntimeError, ValueError):
                break
    return tuple(range(dist.get_world_size()))


@dataclasses.dataclass
class Counts:
    """What one rank ran: matmul FLOPs (``FlopCounterMode``'s registry),
    elementwise and reduction FLOPs (one an element), the bytes proxy, and
    the collectives in issue order (kind, result bytes, the group's global
    ranks, host seconds when timed)."""

    matmul_flops: float = 0.0
    other_flops: float = 0.0
    bytes: float = 0.0
    collectives: list = dataclasses.field(default_factory=list)
    peak_bytes: int = 0
    host_reads: int = 0  # values read back to the host (a loop's change flag)

    @property
    def flops(self) -> float:
        return self.matmul_flops + self.other_flops

    def add(self, other: "Counts", mult: float = 1.0) -> None:
        """Add ``mult`` times ``other`` (the peak is the larger one's)."""
        self.matmul_flops += other.matmul_flops * mult
        self.other_flops += other.other_flops * mult
        self.bytes += other.bytes * mult
        self.collectives += [dict(c, mult=c.get("mult", 1.0) * mult) for c in other.collectives]
        self.peak_bytes = max(self.peak_bytes, other.peak_bytes)
        self.host_reads += int(other.host_reads * mult)

    def minus(self, other: "Counts") -> "Counts":
        """What this run did beyond ``other`` (a run of one more unit of
        layers): the sums' differences, and the collectives by (kind,
        bytes, group) whose count grew, each with the growth as its
        multiplier."""
        def tally(colls):
            out: dict = {}
            for c in colls:
                key = (c["kind"], c["bytes"], tuple(c.get("ranks", ())))
                out[key] = out.get(key, 0.0) + c.get("mult", 1.0)
            return out

        mine, theirs = tally(self.collectives), tally(other.collectives)
        return Counts(
            matmul_flops=self.matmul_flops - other.matmul_flops,
            other_flops=self.other_flops - other.other_flops,
            bytes=self.bytes - other.bytes,
            collectives=[{"kind": k, "bytes": b, "ranks": r, "seconds": 0.0,
                          "mult": n - theirs.get((k, b, r), 0.0)}
                         for (k, b, r), n in mine.items() if n > theirs.get((k, b, r), 0.0)],
            peak_bytes=max(self.peak_bytes - other.peak_bytes, 0),
            host_reads=self.host_reads - other.host_reads,
        )


class OpCounter(TorchDispatchMode):
    """Count the local operations and collectives run inside the block.

    ``timed``: synchronize the device around each collective and wait for
    it, adding its host seconds to its record (a card's step; this
    serializes the collectives with the compute, which gloo does anyway).
    ``track_memory``: follow the bytes of the tensors the block allocates
    and keep their peak (``Counts.peak_bytes``, an estimate: views and
    in-place results are not counted, and the caching allocator's rounding
    is not modelled).  ``ops=False``: count the collectives alone (a
    training step's stats: each op counted costs host time, and a step
    over DTensors is bound by the host)."""

    def __init__(self, *, timed: bool = False, track_memory: bool = False, ops: bool = True):
        super().__init__()
        self.counts = Counts()
        self.timed = timed
        self.track_memory = track_memory
        self.ops = ops
        self._live = 0
        self._registry = _flop_registry()
        self._stand_ins: set[int] = set()  # ids of live stand-ins

    # DTensor (and any other subclass) runs first and hands back its local ops
    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if any(issubclass(t, _dtensor()) for t in types):
            return NotImplemented
        if any(t is not torch.Tensor for t in types):
            # another subclass: DTensor's shape propagation on fake tensors,
            # no work of this rank's
            return func(*args, **kwargs)
        packet = func._overloadpacket
        name = packet.__name__
        if name == "empty_strided" or any(id(t) in self._stand_ins for t in _tensors(args)):
            # DTensor's sharding propagation builds global-shape stand-ins
            # with empty_strided and runs the op on them: no rank's work (the
            # model's code allocates otherwise)
            out = func(*args, **kwargs)
            for t in _tensors(out):
                self._stand_ins.add(id(t))
                weakref.finalize(t, self._stand_ins.discard, id(t))
            return out
        kind = COLLECTIVE_KINDS.get(func.namespace, {}).get(name)
        if kind is not None:
            return self._collective(func, kind, args, kwargs)
        if not self.ops:
            return func(*args, **kwargs)
        out = func(*args, **kwargs)
        if name == "_local_scalar_dense":
            self.counts.host_reads += 1
        self._count(func, packet, name, args, kwargs, out)
        return out

    def _collective(self, func, kind, args, kwargs):
        dev = next((t.device for t in _tensors(args)), None)
        sync = self.timed and dev is not None and dev.type == "cuda"
        if sync:
            torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        out = func(*args, **kwargs)
        functional = func.namespace == "_c10d_functional"
        if self.timed:
            if functional:
                out = torch.ops._c10d_functional.wait_tensor(out)
            if sync:
                torch.cuda.synchronize(dev)
        self.counts.collectives.append({
            "kind": kind,
            "bytes": sum(t.numel() * t.element_size() for t in _tensors(out)),
            "ranks": _group_ranks(args, kwargs, functional),
            "seconds": time.perf_counter() - t0,
        })
        return out

    def _count(self, func, packet, name, args, kwargs, out):
        c = self.counts
        outs = _tensors(out)
        if packet in self._registry:
            c.matmul_flops += self._registry[packet](*args, **kwargs, out_val=out)
        elif torch.Tag.pointwise in func.tags:
            c.other_flops += sum(t.numel() for t in outs)
        elif torch.Tag.reduction in func.tags and args and isinstance(args[0], torch.Tensor):
            c.other_flops += args[0].numel()
        if func.is_view:
            return
        nbytes = sum(t.numel() * t.element_size() for t in outs)
        if packet in self._registry or name in _READS_OPERANDS:
            nbytes += sum(t.numel() * t.element_size() for t in _tensors(args))
        c.bytes += nbytes
        if self.track_memory:
            for t in outs:
                if t._base is None and not any(t is a for a in _tensors(args)):
                    self._alloc(t)

    def _alloc(self, t) -> None:
        n = t.numel() * t.element_size()
        self._live += n
        self.counts.peak_bytes = max(self.counts.peak_bytes, self._live)
        weakref.finalize(t, self._free, n)

    def _free(self, n: int) -> None:
        self._live -= n


def by_kind(collectives, key: str = "bytes") -> dict:
    """``key`` (``"bytes"`` or ``"seconds"``) and calls summed by kind."""
    out: dict = {}
    for c in collectives:
        e = out.setdefault(c["kind"], {"calls": 0, key: 0.0})
        e["calls"] += c.get("mult", 1.0)
        e[key] += c[key] * c.get("mult", 1.0)
    return out


def cross_pod(ranks, pod_boundary: int) -> bool:
    """Whether a group's ranks fall on both sides of a pod boundary."""
    return bool(ranks) and min(ranks) // pod_boundary != max(ranks) // pod_boundary


def analyze(counts: Counts, *, unknown_whiles: int = 0, pod_boundary: int = 256) -> dict:
    """The reference's analysis keys from one rank's :class:`Counts` (all
    numbers per rank): FLOPs, the bytes proxy, collective result bytes,
    wire bytes (:data:`WIRE_FACTOR`), the cross-pod share of the wire
    bytes, wire bytes by kind, the number of collective sites, and the
    counts the reference reports beside them."""
    colls = [dict(c, wire_bytes=c["bytes"] * WIRE_FACTOR.get(c["kind"], 1.0),
                  cross_pod=cross_pod(c.get("ranks", ()), pod_boundary))
             for c in counts.collectives]

    def wsum(pred):
        return float(sum(c["wire_bytes"] * c.get("mult", 1.0) for c in colls if pred(c)))

    kinds: dict = {}
    for c in colls:
        kinds[c["kind"]] = kinds.get(c["kind"], 0.0) + c["wire_bytes"] * c.get("mult", 1.0)
    return {
        "flops": float(counts.flops),
        "bytes": float(counts.bytes),
        "collective_bytes": float(sum(c["bytes"] * c.get("mult", 1.0) for c in colls)),
        "collective_wire_bytes": wsum(lambda c: True),
        "collective_cross_pod_bytes": wsum(lambda c: c["cross_pod"]),
        "collectives_by_kind": kinds,
        "n_collective_sites": len(colls),
        "unknown_whiles": int(unknown_whiles),
        "bf16_upcast_bytes": 0.0,
    }
