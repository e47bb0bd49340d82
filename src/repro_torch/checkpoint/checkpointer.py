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
same leaves alike.  Re-placing a restored tree onto a device mesh waits
for sharded serving (``ROADMAP.md`` Queue 1 item 9).
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
from repro_torch.kernels.common import resolve_device

SHARDINGS_NOT_PORTED = (
    "restoring onto a device mesh waits for sharded serving: see "
    "ROADMAP.md, Queue 1, item 9 (Sharded serving)"
)


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
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().cpu().numpy()
    return np.asarray(leaf)


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
        a ``shape``) to validate against.  ``mesh`` / ``shardings``
        (re-placement onto a device mesh) wait for sharded serving and
        raise ``NotImplementedError``.
        """
        if mesh is not None or shardings is not None:
            raise NotImplementedError(SHARDINGS_NOT_PORTED)
        dev = resolve_device(device)
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
            out[name] = _unflatten_into(
                template, flat, lambda a: torch.as_tensor(a, device=dev)
            )
        return out
