"""The LM spec layer against the reference on the production meshes.

The reference runs once in a subprocess with 512 host devices
(``XLA_FLAGS=--xla_force_host_platform_device_count=512``, as
``tests/test_parallel_rounds.py`` starts its multi-device runs) and
writes every layout as JSON: for the 10 architectures and the embedding
matcher's ``em_encoder`` config at full width, on ``(data=16,
model=16)`` and ``(pod=2, data=16, model=16)``, ``fsdp_params``,
``strip_model``, ``cast_params``, ``param_shardings`` (of the declared
specs and of their FSDP layout), ``input_shardings`` for every
applicable ``SHAPES`` entry and ``state_shardings`` of each decode
shape's cache, ``input_pspecs``, ``abstract_params`` and
``microbatched_specs``; and on a ``(2, 2, 2)`` mesh of 8 devices each
device's block (``NamedSharding.devices_indices_map``) of every leaf of
one smoke config.

The port's side lays out the same meshes as ``DeviceMesh`` objects over a
``fake`` process group of 512 (or 8) ranks in this process, which runs no
collective.  Every spec must equal the reference's as a tuple; every
rank's block the reference's device's, and DTensor's own
``compute_local_shape_and_global_offset`` for the placements.  The pure
spec functions are also held to the reference on hypothesis-drawn specs.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import textwrap
from pathlib import Path
from types import SimpleNamespace

import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.launch import mesh as ref_mesh  # noqa: E402
from repro.launch import sharding as ref_sharding  # noqa: E402
from repro.models import param as ref_param  # noqa: E402
from repro_torch.configs.base import SHAPES, ModelConfig, get_config, shape_applicable  # noqa: E402
from repro_torch.configs.base import ARCH_IDS, smoke_config  # noqa: E402
from repro_torch.core.matchers.embedding import EM_ENCODER  # noqa: E402
from repro_torch.launch import mesh as meshlib  # noqa: E402
from repro_torch.launch import sharding  # noqa: E402
from repro_torch.models import param  # noqa: E402
from repro_torch.models.registry import get_model  # noqa: E402
from repro_torch.train.train_step import microbatched_specs  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
CONFIGS = [*ARCH_IDS, "em_encoder"]
MESHES = ["16x16", "2x16x16"]
BLOCK_ARCH = "moonshot_v1_16b_a3b"  # data- and model-sharded leaves
BLOCK_SHAPE = ("t", 16, 8, "train")
MICROBATCHES = 4

REFERENCE = textwrap.dedent(
    """
    import os, sys, json
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=512"
    import jax, jax.numpy as jnp, numpy as np
    from jax.sharding import NamedSharding
    from repro.configs.base import (ARCH_IDS, SHAPES, ModelConfig, ShapeConfig, get_config,
                                    shape_applicable, smoke_config)
    from repro.launch import sharding as sh
    from repro.launch.mesh import make_production_mesh
    from repro.models.param import PSpec, abstract_params
    from repro.models.registry import get_model
    from repro.train.train_step import microbatched_specs

    def cfg_of(name):
        if name == "em_encoder":
            return ModelConfig(name="em_encoder", family="dense", n_layers=2, d_model=32,
                               n_heads=4, n_kv_heads=4, d_ff=64, vocab_size=256)
        return get_config(name)

    def spec(p):
        return [list(e) if isinstance(e, tuple) else e for e in tuple(p)]

    def flat(tree, fn, prefix=""):
        if isinstance(tree, dict):
            out = {}
            for k in sorted(tree):
                out.update(flat(tree[k], fn, f"{prefix}/{k}"))
            return out
        return {prefix: fn(tree)}

    out = {"layouts": {}, "inputs": {}, "pspecs": {}, "abstract": {}, "micro": {}}
    meshes = {"16x16": make_production_mesh(), "2x16x16": make_production_mesh(multi_pod=True)}
    for name in sys.argv[2].split(","):
        api = get_model(cfg_of(name))
        specs = api.param_specs()
        out["abstract"][name] = flat(abstract_params(specs),
                                     lambda s: [list(s.shape), str(s.dtype)])
        pspecs = {}
        for sname, shape in SHAPES.items():
            if shape_applicable(api.cfg, shape)[0]:
                pspecs[sname] = {k: spec(v) for k, v in api.input_pspecs(shape).items()}
        out["pspecs"][name] = pspecs
        shape = SHAPES["train_4k"]
        sds = {k: jax.ShapeDtypeStruct(v.shape, v.dtype) for k, v in api.input_specs(shape).items()}
        ms, mp = microbatched_specs(sds, api.input_pspecs(shape), int(sys.argv[3]))
        out["micro"][name] = {k: [list(ms[k].shape), str(ms[k].dtype), spec(mp[k])] for k in ms}
        for mname, mesh in meshes.items():
            fsdp = sh.fsdp_params(specs, mesh)
            out["layouts"][f"{name}|{mname}"] = {
                "fsdp_params": flat(fsdp, lambda ps: spec(ps.spec)),
                "strip_model": flat(sh.strip_model(specs), lambda ps: spec(ps.spec)),
                "cast_params": flat(sh.cast_params(specs, jnp.bfloat16),
                                   lambda ps: np.dtype(ps.dtype).name),
                "param_shardings": flat(sh.param_shardings(specs, mesh),
                                        lambda s: spec(s.spec)),
                "param_shardings_fsdp": flat(sh.param_shardings(fsdp, mesh),
                                             lambda s: spec(s.spec)),
            }
            inputs = {}
            for sname, shape in SHAPES.items():
                if not shape_applicable(api.cfg, shape)[0]:
                    continue
                inputs[sname] = {k: spec(v.spec)
                                 for k, v in sh.input_shardings(api, shape, mesh).items()}
                if shape.kind == "decode":
                    cache = api.cache_specs(shape.global_batch, shape.seq_len)
                    for pod_batch in (True, False):
                        inputs[f"{sname}|cache|{pod_batch}"] = flat(
                            sh.state_shardings(cache, mesh, pod_batch=pod_batch),
                            lambda s: spec(s.spec))
            out["inputs"][f"{name}|{mname}"] = inputs

    # each device's block on a (2, 2, 2) mesh
    mesh = jax.make_mesh((2, 2, 2), ("pod", "data", "model"), devices=jax.devices()[:8])
    api = get_model(smoke_config(sys.argv[4]))
    shape = ShapeConfig(*json.loads(sys.argv[5]))
    leaves = flat(sh.param_shardings(api.param_specs(), mesh), lambda s: s)
    shapes = flat(api.param_specs(), lambda ps: ps.shape)
    for k, s in sh.input_shardings(api, shape, mesh).items():
        leaves[f"input/{k}"] = s
        shapes[f"input/{k}"] = api.input_specs(shape)[k].shape
    blocks = {}
    for k, s in leaves.items():
        for dev, idx in s.devices_indices_map(shapes[k]).items():
            coord = "".join(str(int(c[0])) for c in np.nonzero(mesh.devices == dev))
            blocks[f"{k}|{coord}"] = [[sl.start or 0, shapes[k][d] if sl.stop is None else sl.stop]
                                      for d, sl in enumerate(idx)]
    out["blocks"] = {"shapes": {k: list(v) for k, v in shapes.items()}, "blocks": blocks}
    with open(sys.argv[1], "w") as f:
        json.dump(out, f)
    """
)


def _cfg(name: str) -> ModelConfig:
    return ModelConfig(**EM_ENCODER) if name == "em_encoder" else get_config(name)


def _spec(p) -> list:
    return [list(e) if isinstance(e, tuple) else e for e in tuple(p)]


def _flat(tree, fn, prefix="") -> dict:
    if isinstance(tree, dict):
        out = {}
        for k in sorted(tree):
            out.update(_flat(tree[k], fn, f"{prefix}/{k}"))
        return out
    return {prefix: fn(tree)}


def _dtype(dt) -> str:
    return str(dt).removeprefix("torch.")


class _FakeWorld:
    """Rank ``rank`` of a ``fake`` process group of ``n`` ranks in this
    process: meshes lay out without devices, and no collective runs."""

    def __init__(self, rank: int, n: int):
        self.rank, self.n = rank, n

    def __enter__(self):
        import torch.distributed as dist
        from torch.testing._internal.distributed.fake_pg import FakeStore

        assert not dist.is_initialized()
        dist.init_process_group("fake", store=FakeStore(), rank=self.rank, world_size=self.n)
        return self

    def __exit__(self, *exc):
        import torch.distributed as dist

        dist.destroy_process_group()


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    path = tmp_path_factory.mktemp("specs") / "reference.json"
    proc = subprocess.run(
        [sys.executable, "-c", REFERENCE, str(path), ",".join(CONFIGS), str(MICROBATCHES),
         BLOCK_ARCH, json.dumps(BLOCK_SHAPE)],
        capture_output=True, text=True, timeout=240,
        env={**os.environ, "PYTHONPATH": str(ROOT / "src")})
    assert proc.returncode == 0, proc.stderr[-3000:]
    return json.loads(path.read_text())


@pytest.fixture(scope="module")
def port():
    """The port's layouts on the production meshes over a 512-rank fake group."""
    out = {"layouts": {}, "inputs": {}, "meshes": {}}
    with _FakeWorld(0, 512):
        meshes = {"16x16": meshlib.make_production_mesh(device_type="cpu"),
                  "2x16x16": meshlib.make_production_mesh(multi_pod=True, device_type="cpu")}
        for mname, mesh in meshes.items():
            out["meshes"][mname] = (tuple(mesh.mesh_dim_names), tuple(mesh.shape),
                                    mesh.get_coordinate())
        for name in CONFIGS:
            api = get_model(_cfg(name))
            specs = api.param_specs()
            for mname, mesh in meshes.items():
                fsdp = sharding.fsdp_params(specs, mesh)
                out["layouts"][f"{name}|{mname}"] = {
                    "fsdp_params": _flat(fsdp, lambda ps: _spec(ps.spec)),
                    "strip_model": _flat(sharding.strip_model(specs), lambda ps: _spec(ps.spec)),
                    "cast_params": _flat(sharding.cast_params(specs, torch.bfloat16),
                                         lambda ps: _dtype(ps.dtype)),
                    "param_shardings": _flat(sharding.param_shardings(specs, mesh),
                                             lambda s: _spec(s.spec)),
                    "param_shardings_fsdp": _flat(sharding.param_shardings(fsdp, mesh),
                                                  lambda s: _spec(s.spec)),
                }
                inputs = {}
                for sname, shape in SHAPES.items():
                    if not shape_applicable(api.cfg, shape)[0]:
                        continue
                    got = sharding.input_shardings(api, shape, mesh)
                    for s in got.values():
                        s.placements  # every layout converts to DTensor placements
                    inputs[sname] = {k: _spec(v.spec) for k, v in got.items()}
                    if shape.kind == "decode":
                        cache = api.cache_specs(shape.global_batch, shape.seq_len)
                        for pod_batch in (True, False):
                            inputs[f"{sname}|cache|{pod_batch}"] = _flat(
                                sharding.state_shardings(cache, mesh, pod_batch=pod_batch),
                                lambda s: _spec(s.spec))
                out["inputs"][f"{name}|{mname}"] = inputs
    return out


@pytest.mark.parametrize("mesh", MESHES)
def test_make_production_mesh(port, mesh):
    """The production meshes' axes and shapes, rank 0 at the origin."""
    names, shape, coord = port["meshes"][mesh]
    if mesh == "16x16":
        assert (names, shape) == (("data", "model"), (16, 16))
    else:
        assert (names, shape) == (("pod", "data", "model"), (2, 16, 16))
    assert list(coord) == [0] * len(shape)


@pytest.mark.parametrize("mesh", MESHES)
@pytest.mark.parametrize("name", CONFIGS)
def test_parameter_layouts_match_reference(reference, port, name, mesh):
    """``fsdp_params``, ``strip_model``, ``cast_params`` and ``param_shardings``
    (of the declared specs and of their FSDP layout) at full width."""
    want = reference["layouts"][f"{name}|{mesh}"]
    got = port["layouts"][f"{name}|{mesh}"]
    assert got.keys() == want.keys()
    for fn in want:
        assert got[fn] == want[fn], fn


@pytest.mark.parametrize("mesh", MESHES)
@pytest.mark.parametrize("name", CONFIGS)
def test_input_and_state_shardings_match_reference(reference, port, name, mesh):
    """``input_shardings`` for every applicable shape, ``state_shardings`` of
    each decode shape's cache (batch over pod or not)."""
    want = reference["inputs"][f"{name}|{mesh}"]
    got = port["inputs"][f"{name}|{mesh}"]
    assert got == want


@pytest.mark.parametrize("name", CONFIGS)
def test_input_pspecs_abstract_params_and_microbatched_specs(reference, name):
    """``input_pspecs`` for every applicable shape; ``abstract_params`` as
    ``meta`` tensors of the reference's shapes and, for the training draw's
    declaration (``in_f32``), its dtypes (the served declaration holds the
    projections in bf16, every other leaf as the reference); and
    ``microbatched_specs`` of the ``train_4k`` batch."""
    api = get_model(_cfg(name))
    pspecs = {s: {k: _spec(v) for k, v in api.input_pspecs(shape).items()}
              for s, shape in SHAPES.items() if shape_applicable(api.cfg, shape)[0]}
    assert pspecs == reference["pspecs"][name]
    want = reference["abstract"][name]
    served = _flat(param.abstract_params(api.param_specs()), lambda t: t)
    trained = _flat(param.abstract_params(param.in_f32(api.param_specs())), lambda t: t)
    assert served.keys() == trained.keys() == want.keys()
    for k, (shape, dtype) in want.items():
        assert served[k].device.type == "meta" and list(served[k].shape) == shape, k
        assert _dtype(trained[k].dtype) == dtype, k
        assert _dtype(served[k].dtype) in (dtype, "bfloat16"), k
    shape = SHAPES["train_4k"]
    ms, mp = microbatched_specs(api.input_specs(shape), api.input_pspecs(shape), MICROBATCHES)
    got = {k: [list(ms[k].shape), _dtype(ms[k].dtype), _spec(mp[k])] for k in ms}
    assert got == reference["micro"][name]
    assert all(t.device.type == "meta" for t in ms.values())


def test_each_rank_holds_the_reference_devices_block(reference):
    """On a (pod=2, data=2, model=2) mesh every rank's block of every
    parameter and input leaf of a smoke config is the block that
    ``devices_indices_map`` gives the device at its coordinate, and DTensor's
    own offset for the placements."""
    from torch.distributed.tensor._utils import compute_local_shape_and_global_offset

    want = reference["blocks"]["blocks"]
    shapes = reference["blocks"]["shapes"]
    api = get_model(smoke_config(BLOCK_ARCH))
    from repro_torch.configs.base import ShapeConfig

    shape = ShapeConfig(*BLOCK_SHAPE)
    seen = 0
    for rank in range(8):
        with _FakeWorld(rank, 8):
            from torch.distributed.device_mesh import DeviceMesh

            mesh = DeviceMesh("cpu", torch.arange(8).reshape(2, 2, 2),
                              mesh_dim_names=("pod", "data", "model"))
            leaves = _flat(sharding.param_shardings(api.param_specs(), mesh), lambda s: s)
            for k, s in sharding.input_shardings(api, shape, mesh).items():
                leaves[f"input/{k}"] = s
            coord = "".join(str(c) for c in mesh.get_coordinate())
            for k, s in leaves.items():
                block = s.block(shapes[k])
                got = [[b.start, b.stop] for b in block]
                assert got == want[f"{k}|{coord}"], (k, coord)
                size, offset = compute_local_shape_and_global_offset(
                    tuple(shapes[k]), mesh, s.placements)
                assert [b.start for b in block] == list(offset), (k, coord)
                assert [b.stop - b.start for b in block] == list(size), (k, coord)
                seen += 1
    assert seen == 8 * len(shapes) and len(want) == seen


# -- the pure spec functions on drawn specs ---------------------------------

try:
    import hypothesis
    from hypothesis import strategies as st
except ImportError:  # optional, as in the repo's other hypothesis tests
    hypothesis = None

if hypothesis is not None:
    AXES = ("pod", "data", "model")


    @st.composite
    def _mesh(draw):
        names = tuple(a for a in AXES if draw(st.booleans())) or ("data",)
        shape = tuple(draw(st.sampled_from([1, 2, 4, 16])) for _ in names)
        return names, shape


    def _entry():
        return st.one_of(st.none(), st.sampled_from(AXES),
                         st.lists(st.sampled_from(AXES), min_size=1, max_size=3,
                                  unique=True).map(tuple))


    def _ref_mesh(names, shape):
        return SimpleNamespace(axis_names=names, devices=np.empty(shape))


    def _port_mesh(names, shape):
        return SimpleNamespace(mesh_dim_names=names, shape=shape)


    def _norm(spec) -> list:
        """A spec as a list, a one-axis tuple read as that axis (JAX's
        PartitionSpec treats ``("x",)`` and ``"x"`` alike)."""
        out = []
        for e in tuple(spec):
            if isinstance(e, (tuple, list)):
                e = e[0] if len(e) == 1 else list(e)
            out.append(e)
        return out


    @hypothesis.settings(max_examples=150, deadline=None)
    @hypothesis.given(_mesh(), st.lists(_entry(), max_size=4))
    def test_pod_spec_matches_reference(mesh, entries):
        from jax.sharding import PartitionSpec as P

        want = ref_mesh.pod_spec(P(*entries), _ref_mesh(*mesh))
        assert _norm(meshlib.pod_spec(tuple(entries), _port_mesh(*mesh))) == _norm(want)


    @hypothesis.settings(max_examples=150, deadline=None)
    @hypothesis.given(st.lists(_entry(), max_size=4))
    def test_dp_over_model_spec_matches_reference(entries):
        from jax.sharding import PartitionSpec as P

        want = ref_sharding.dp_over_model_spec(P(*entries))
        assert _norm(sharding.dp_over_model_spec(tuple(entries))) == _norm(want)


    @hypothesis.settings(max_examples=150, deadline=None)
    @hypothesis.given(_mesh(), st.lists(_entry(), max_size=4))
    def test_filter_spec_matches_reference(mesh, entries):
        from jax.sharding import PartitionSpec as P

        want = ref_param.filter_spec(P(*entries), _ref_mesh(*mesh))
        assert _norm(param.filter_spec(tuple(entries), _port_mesh(*mesh))) == _norm(want)


    @hypothesis.settings(max_examples=150, deadline=None)
    @hypothesis.given(_mesh(), st.lists(_entry(), max_size=4),
                      st.lists(st.sampled_from([1, 2, 3, 8, 16, 48, 64]), min_size=4, max_size=5))
    def test_drop_indivisible_matches_reference(mesh, entries, shape):
        from jax.sharding import PartitionSpec as P

        want = ref_sharding.drop_indivisible(P(*entries), shape, _ref_mesh(*mesh))
        got = sharding.drop_indivisible(tuple(entries), shape, _port_mesh(*mesh))
        assert _norm(got) == _norm(want)


def test_cast_params_keeps_non_f32_leaves():
    """Only f32 leaves take the serve dtype, in both packages."""
    port_tree = {"a": param.PSpec((2,)), "b": param.PSpec((2,), dtype=torch.int32)}
    ref_tree = {"a": ref_param.PSpec((2,)), "b": ref_param.PSpec((2,), dtype=jnp.int32)}
    got = sharding.cast_params(port_tree, torch.bfloat16)
    want = ref_sharding.cast_params(ref_tree, jnp.bfloat16)
    assert [_dtype(got[k].dtype) for k in "ab"] == [np.dtype(want[k].dtype).name for k in "ab"]


def test_sharding_placements_reject_unordered_and_unknown_axes():
    """A dim sharded over mesh axes out of mesh order, an axis the mesh lacks,
    or one axis on two dims have no DTensor placement: each raises."""
    mesh = _port_mesh(("pod", "data", "model"), (2, 2, 2))
    from torch.distributed.tensor import Replicate, Shard

    assert meshlib.NamedSharding(mesh, (("pod", "data"), "model")).placements == (
        Shard(0), Shard(0), Shard(1))
    assert meshlib.NamedSharding(mesh, (None,)).placements == (Replicate(),) * 3
    for bad in [(("data", "pod"),), ("x",), ("data", "data")]:
        with pytest.raises(ValueError):
            meshlib.NamedSharding(mesh, bad).placements
