"""The activation pins (``models/layers.py`` ``shard_spec`` / ``shard_batch``)
against the reference's, on (data, model) and (pod, data, model) meshes, with
and without ``DP_OVER_MODEL`` and ``SEQ_SHARD_BOUNDARY``.

The reference runs in a subprocess with 8 XLA host devices: each pin is a
jitted function under ``jax.set_mesh``, and its output's
``.sharding.spec`` is what the reference chose.  The port runs in process
on rank 0 of a ``fake`` process group of 8 ranks: each pin redistributes a
``meta`` DTensor, and its placements, read back as a spec, must be the
reference's (trailing ``None`` entries dropped on both sides).  Without a
mesh, or on a plain tensor, the port's pins return their input.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

ROOT = Path(__file__).resolve().parent.parent

MESHES = {"2x4": (("data", "model"), (2, 4)), "2x2x2": (("pod", "data", "model"), (2, 2, 2))}
SWITCHES = [(False, False), (True, False), (False, True)]  # (DP_OVER_MODEL, SEQ_SHARD_BOUNDARY)
# (kind, shape, argument): shard_spec's entries, or shard_batch's (batch_dim, model_dim)
CASES = [
    ("spec", (8, 16, 8), ("dp", None, "model")),       # the SSM's u and dt
    ("spec", (8, 16, 6), ("dp", None, "model")),       # model does not divide 6
    ("spec", (4, 8, 3, 16), ("model", "dp", None, None)),  # MoE expert buffers
    ("spec", (8, 2, 4, 5), ("dp", None, "model", None)),   # MoE combine
    ("spec", (3, 16), ("dp", "model")),                # dp does not divide 3
    ("batch", (8, 16, 32), (0, None)),                 # the residual stream
    ("batch", (8, 16, 64), (0, -1)),                   # logits: vocabulary on model
    ("batch", (8, 16, 6), (0, -1)),                    # a vocabulary model does not divide
    ("batch", (2, 16, 32), (0, None)),                 # a batch the dp ranks may not divide
    ("batch", (16, 8), (1, None)),                     # batch on dim 1 (M-RoPE positions)
]

REFERENCE = textwrap.dedent(
    """
    import os, sys, json
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    import jax, jax.numpy as jnp
    from repro.models import layers as L
    meshes, switches, cases = json.loads(sys.argv[1])
    out = {}
    for name, (axes, shape) in meshes.items():
        mesh = jax.make_mesh(tuple(shape), tuple(axes),
                             axis_types=(jax.sharding.AxisType.Auto,) * len(axes))
        for dpm, seq in switches:
            L.DP_OVER_MODEL, L.SEQ_SHARD_BOUNDARY = dpm, seq
            for i, (kind, shp, arg) in enumerate(cases):
                if kind == "spec":
                    entries = tuple(tuple(e) if isinstance(e, list) else e for e in arg)
                    fn = lambda x, e=entries: L.shard_spec(x, e)
                else:
                    fn = lambda x, a=arg: L.shard_batch(x, batch_dim=a[0], model_dim=a[1])
                try:
                    with jax.set_mesh(mesh):
                        y = jax.jit(fn)(jnp.zeros(tuple(shp)))
                except Exception as e:  # an axis named twice in one spec
                    if "duplicate" not in str(e).lower():
                        raise
                    out[f"{name}|{dpm}|{seq}|{i}"] = "error: " + type(e).__name__
                    continue
                spec = [list(e) if isinstance(e, tuple) else e for e in y.sharding.spec]
                out[f"{name}|{dpm}|{seq}|{i}"] = spec
    print("REFERENCE " + json.dumps(out))
    """
)


def _strip(spec) -> list:
    spec = [list(e) if isinstance(e, (tuple, list)) else e for e in spec]
    spec = [e[0] if isinstance(e, list) and len(e) == 1 else e for e in spec]
    while spec and spec[-1] is None:
        spec.pop()
    return spec


@pytest.fixture(scope="module")
def reference():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu")
    arg = json.dumps([{k: [list(a), list(s)] for k, (a, s) in MESHES.items()},
                      SWITCHES, [[k, list(s), list(a) if a else a] for k, s, a in CASES]])
    out = subprocess.run([sys.executable, "-c", REFERENCE, arg], capture_output=True,
                         text=True, env=env, timeout=240)
    assert out.returncode == 0, out.stderr[-3000:]
    line = [ln for ln in out.stdout.splitlines() if ln.startswith("REFERENCE ")][-1]
    return json.loads(line[len("REFERENCE "):])


@pytest.fixture(scope="module")
def world():
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore

    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=8)
    yield
    dist.destroy_process_group()


def _placements_spec(t, mesh) -> list:
    """The spec tuple of a DTensor's placements (each tensor dim's mesh axes,
    mesh order)."""
    spec: list = [None] * t.ndim
    for name, p in zip(mesh.mesh_dim_names, t.placements):
        if p.is_shard():
            d = p.dim % t.ndim
            spec[d] = [name] if spec[d] is None else spec[d] + [name]
    return _strip(spec)


@pytest.mark.parametrize("mesh_name", list(MESHES))
@pytest.mark.parametrize("switches", SWITCHES, ids=["plain", "dp_over_model", "seq_shard"])
def test_pins_choose_the_reference_specs(reference, world, mesh_name, switches):
    from torch.distributed.device_mesh import DeviceMesh
    from torch.distributed.tensor import DTensor, Replicate

    from repro_torch.models import layers

    axes, shape = MESHES[mesh_name]
    mesh = DeviceMesh("cpu", torch.arange(8).reshape(shape), mesh_dim_names=axes)
    saved = layers.DP_OVER_MODEL, layers.SEQ_SHARD_BOUNDARY
    layers.DP_OVER_MODEL, layers.SEQ_SHARD_BOUNDARY = switches
    try:
        for i, (kind, shp, arg) in enumerate(CASES):
            x = DTensor.from_local(torch.empty(shp, device="meta"), mesh,
                                   [Replicate()] * len(axes), run_check=False)

            def pin():
                with layers.use_mesh(mesh):
                    return (layers.shard_spec(x, arg) if kind == "spec"
                            else layers.shard_batch(x, batch_dim=arg[0], model_dim=arg[1]))

            want = reference[f"{mesh_name}|{switches[0]}|{switches[1]}|{i}"]
            if isinstance(want, str):  # the reference's spec names an axis twice
                with pytest.raises(ValueError, match="shards two dims"):
                    pin()
                continue
            assert _placements_spec(pin(), mesh) == _strip(want), (kind, shp, arg)
    finally:
        layers.DP_OVER_MODEL, layers.SEQ_SHARD_BOUNDARY = saved


def test_pins_are_no_ops_without_a_mesh_or_on_plain_tensors(world):
    from torch.distributed.device_mesh import DeviceMesh
    from torch.distributed.tensor import DTensor, Replicate

    from repro_torch.models import layers

    x = torch.zeros(8, 16, 32)
    assert layers.ambient_mesh() is None
    assert layers.shard_batch(x) is x and layers.shard_spec(x, ("dp", None, "model")) is x
    mesh = DeviceMesh("cpu", torch.arange(8).reshape(2, 4), mesh_dim_names=("data", "model"))
    d = DTensor.from_local(torch.empty(8, 16, 32, device="meta"), mesh, [Replicate()] * 2,
                           run_check=False)
    assert layers.shard_batch(d) is d  # a DTensor, but no ambient mesh
    with layers.use_mesh(mesh):
        assert layers.ambient_mesh() is mesh
        assert layers.shard_batch(x) is x  # a plain tensor under a mesh
        assert layers.pin_spec((8, 16, 32), ("dp", None, "model")) == ("data", None, "model")
    assert layers.ambient_mesh() is None
