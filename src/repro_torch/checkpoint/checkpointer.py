"""Fault-tolerant checkpointing: atomic manifests, keep-K GC, async save,
restore onto a device.

Layout per step::

    <dir>/step_000042.tmp/        # written first
        arrays.npz                # flattened state leaves
        manifest.json             # step, keys, meta
    <dir>/step_000042/            # atomic rename when complete

Restart-safety comes from the write-tmp-then-rename protocol: a
half-written checkpoint never shadows a complete one, and
``latest_step`` only considers renamed directories.  Arrays are saved
device-agnostic (host numpy, whichever device held them) and placed on
the caller's ``device`` at restore, so a checkpoint written on the card
restores on the CPU and the other way round.

State trees are nested dicts, lists and tuples with tensor or array
leaves (``None`` is an empty subtree).  A leaf's key is its path joined
by ``/`` — dict keys in sorted order, sequence indices — the key strings
of the JAX reference's pytree flattening, so the two packages name the
same leaves alike.  A restored tree can be re-placed onto a mesh of
ranks (:class:`repro_torch.launch.mesh.EMMesh`) under DTensor placements:
``Replicate()`` puts the whole array on the rank's device, ``Shard(d)``
this rank's slice along dimension ``d`` — the counterparts of the
reference's ``NamedSharding``.
"""

from __future__ import annotations

import json
import os
import shutil
import threading
import time

import numpy as np
import torch

from repro_torch import faults
from repro_torch.kernels.common import put_replicated, put_sharded, resolve_device


def _leaves_with_path(tree, path=()):
    """(path, leaf) pairs in flattening order: dict keys sorted, sequence
    elements in order, ``None`` contributing nothing."""
    if tree is None:
        return
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves_with_path(tree[k], path + (k,))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaves_with_path(v, path + (i,))
    else:
        yield path, tree


def _key(path) -> str:
    return "/".join(str(p) for p in path)


def _to_numpy(leaf) -> np.ndarray:
    """A host copy of ``leaf``: never a view of the caller's memory, so an
    async save writes the state as it was when ``save`` was called, even
    when the caller then updates a CPU tensor in place."""
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().to("cpu", copy=True).numpy()
    return np.array(leaf)


def _flatten(tree) -> dict[str, np.ndarray]:
    return {_key(path): _to_numpy(leaf) for path, leaf in _leaves_with_path(tree)}


def _unflatten_into(template, flat: dict[str, np.ndarray], place, path=()):
    """A tree shaped as ``template`` whose leaves are ``place(flat[key])``,
    each checked against the template leaf's shape."""
    if template is None:
        return None
    if isinstance(template, dict):
        return {k: _unflatten_into(template[k], flat, place, path + (k,))
                for k in template}
    if isinstance(template, (list, tuple)):
        out = [_unflatten_into(v, flat, place, path + (i,))
               for i, v in enumerate(template)]
        return out if isinstance(template, list) else type(template)(out)
    key = _key(path)
    arr = flat[key]
    expect = tuple(template.shape) if hasattr(template, "shape") else ()
    if tuple(arr.shape) != expect:
        raise ValueError(f"checkpoint shape mismatch at {key}: "
                         f"{arr.shape} vs {expect}")
    return place(arr)


def _place(tree, placements, mesh):
    """``tree``'s host arrays placed over ``mesh`` under ``placements``: a
    tree of the same shape, or one placement for every leaf below."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: _place(v, placements[k] if isinstance(placements, dict) else placements,
                          mesh) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        seq = isinstance(placements, (list, tuple))
        out = [_place(v, placements[i] if seq else placements, mesh)
               for i, v in enumerate(tree)]
        return out if isinstance(tree, list) else type(tree)(out)
    from torch.distributed.tensor import Replicate, Shard

    if isinstance(placements, Replicate):
        return put_replicated(tree, mesh)
    if isinstance(placements, Shard):
        return put_sharded(tree, mesh, placements.dim)
    raise ValueError(f"unsupported placement {placements!r}: Replicate() or Shard(dim)")


class Checkpointer:
    def __init__(self, directory: str, keep: int = 3, async_save: bool = False):
        self.dir = directory
        self.keep = keep
        self.async_save = async_save
        self._thread: threading.Thread | None = None
        os.makedirs(directory, exist_ok=True)

    # -- save ---------------------------------------------------------------
    def save(self, step: int, state: dict, meta: dict | None = None) -> None:
        flat = {}
        for name, tree in state.items():
            for k, v in _flatten(tree).items():
                flat[f"{name}|{k}"] = v
        if self.async_save:
            self.wait()
            self._thread = threading.Thread(
                target=self._write, args=(step, flat, meta or {})
            )
            self._thread.start()
        else:
            self._write(step, flat, meta or {})

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None

    def _write(self, step: int, flat: dict, meta: dict) -> None:
        name = f"step_{step:09d}"
        tmp = os.path.join(self.dir, name + ".tmp")
        final = os.path.join(self.dir, name)
        if os.path.exists(tmp):
            shutil.rmtree(tmp)
        os.makedirs(tmp)
        np.savez(os.path.join(tmp, "arrays.npz"), **flat)
        manifest = {
            "step": step,
            "time": time.time(),
            "keys": sorted(flat.keys()),
            "meta": meta,
        }
        with open(os.path.join(tmp, "manifest.json"), "w") as f:
            json.dump(manifest, f)
            f.flush()
            os.fsync(f.fileno())
        if os.path.exists(final):
            shutil.rmtree(final)
        # a crash here leaves a complete .tmp that never shadows the
        # previous checkpoint: latest_step only sees renamed dirs
        faults.maybe_fail("ckpt.rename")
        os.rename(tmp, final)
        self._gc()

    def _gc(self) -> None:
        steps = self.all_steps()
        for s in steps[: -self.keep] if self.keep > 0 else []:
            shutil.rmtree(os.path.join(self.dir, f"step_{s:09d}"), ignore_errors=True)

    # -- restore --------------------------------------------------------------
    def all_steps(self) -> list[int]:
        out = []
        for d in os.listdir(self.dir):
            if d.startswith("step_") and not d.endswith(".tmp"):
                if os.path.exists(os.path.join(self.dir, d, "manifest.json")):
                    out.append(int(d.split("_")[1]))
        return sorted(out)

    def latest_step(self) -> int | None:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def restore_raw(self, step: int) -> tuple[dict[str, np.ndarray], dict]:
        """Flat ``"name|key" -> array`` map of one checkpoint plus its
        manifest ``meta``, with no template shape validation — for
        callers whose state is a variable-length blob (e.g. the resolve
        service's pickled logical state, whose byte length changes every
        checkpoint)."""
        path = os.path.join(self.dir, f"step_{step:09d}")
        with np.load(os.path.join(path, "arrays.npz")) as z:
            flat = {k: z[k] for k in z.files}
        with open(os.path.join(path, "manifest.json")) as f:
            meta = json.load(f).get("meta", {})
        return flat, meta

    def restore(self, step: int, templates: dict, mesh=None, shardings=None,
                device=None) -> dict:
        """Restore state trees as tensors on ``device`` (``None``: CUDA,
        which raises without a GPU; pass ``device="cpu"`` for the CPU).

        ``templates`` maps name -> tree of tensors/arrays (anything with
        a ``shape``) to validate against.  ``shardings`` (optional) maps
        name -> a tree of DTensor placements (or one placement for the
        whole tree) for elastic re-placement over ``mesh`` (an
        :class:`~repro_torch.launch.mesh.EMMesh`; ``None``: the one-rank
        mesh on ``device``): ``Replicate()`` gives each rank the whole
        array, ``Shard(d)`` its slice of dimension ``d``.
        """
        from repro_torch.launch.mesh import EMMesh

        if mesh is None:
            mesh = EMMesh.local(device)
        elif device is not None:
            d = resolve_device(device)
            if d.type != mesh.device.type or d.index not in (None, mesh.device.index):
                raise ValueError(f"restore on {d}, but the mesh's rank is on {mesh.device}")
        dev = mesh.device
        path = os.path.join(self.dir, f"step_{step:09d}")
        with np.load(os.path.join(path, "arrays.npz")) as z:
            flat_all = {k: z[k] for k in z.files}
        out = {}
        for name, template in templates.items():
            flat = {
                k.split("|", 1)[1]: v
                for k, v in flat_all.items()
                if k.startswith(name + "|")
            }
            if shardings is not None and name in shardings:
                tree = _unflatten_into(template, flat, lambda a: a)
                out[name] = _place(tree, shardings[name], mesh)
            else:
                out[name] = _unflatten_into(
                    template, flat, lambda a: torch.as_tensor(a, device=dev)
                )
        return out
