"""The PyTorch port stands alone: no JAX, no ``repro``, and no silent CPU fallback."""

from __future__ import annotations

import re
import subprocess
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

ROOT = Path(__file__).resolve().parent.parent
PORT = ROOT / "src" / "repro_torch"

_IMPORT_ALL = r"""
import importlib, pkgutil, sys
sys.modules["jax"] = None  # any import of jax now raises ImportError
sys.path.insert(0, {src!r})
sys.path.insert(0, {root!r})
import repro_torch
names = [m.name for m in pkgutil.walk_packages(repro_torch.__path__, "repro_torch.")]
assert {{
    "repro_torch.core.parallel", "repro_torch.obs.export", "repro_torch.obs.quality",
    "repro_torch.core.matchers", "repro_torch.core.matchers.assignment",
    "repro_torch.core.matchers.embedding", "repro_torch.stream.serving",
    "repro_torch.stream.wal", "repro_torch.checkpoint.checkpointer",
    "repro_torch.launch.mesh", "repro_torch.launch.sharding", "repro_torch.stream.shard",
    "repro_torch.models.moe", "repro_torch.models.ssm", "repro_torch.models.ssm_lm",
    "repro_torch.models.hybrid", "repro_torch.models.encdec", "repro_torch.data.corpus",
    "repro_torch.data.dedup", "repro_torch.models.scan_utils", "repro_torch.train.optimizer",
    "repro_torch.train.train_step", "repro_torch.train.trainer", "repro_torch.train.compress",
    "repro_torch.launch.train", "repro_torch.launch.dryrun",
}} <= set(names), names
for name in names:
    importlib.import_module(name)
import chip_smoke  # noqa: F401
leaked = sorted(
    m for m, mod in sys.modules.items()
    if mod is not None and (m.split(".")[0] in ("repro", "jax", "jaxlib"))
)
assert not leaked, leaked
print(len(names))
"""


def test_port_imports_without_jax_or_reference():
    code = _IMPORT_ALL.format(src=str(ROOT / "src"), root=str(ROOT))
    out = subprocess.run(
        [sys.executable, "-c", code], capture_output=True, text=True, timeout=120,
        cwd=str(ROOT / "tests"),
    )
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.strip().splitlines()[-1]) >= 60  # every module was imported


@pytest.mark.parametrize("path", sorted(
    str(p.relative_to(ROOT)) for p in [*PORT.rglob("*.py"), ROOT / "chip_smoke.py"]
))
def test_no_jax_or_reference_import_in_source(path):
    src = (ROOT / path).read_text()
    bad = re.findall(r"^\s*(?:import|from)\s+(jax|repro)\b", src, flags=re.M)
    assert not bad, f"{path} imports {bad}"


# the modules of the matcher registry, of serving and durability, of the
# MoE, SSM, hybrid and encoder-decoder model families, of corpus dedup, and
# of training
NEW_MODULES = [
    "src/repro_torch/core/matchers/__init__.py",
    "src/repro_torch/core/matchers/assignment.py",
    "src/repro_torch/core/matchers/embedding.py",
    "src/repro_torch/stream/serving.py",
    "src/repro_torch/stream/wal.py",
    "src/repro_torch/checkpoint/__init__.py",
    "src/repro_torch/checkpoint/checkpointer.py",
    "src/repro_torch/obs/quality.py",
    "src/repro_torch/models/moe.py",
    "src/repro_torch/models/ssm.py",
    "src/repro_torch/models/ssm_lm.py",
    "src/repro_torch/models/hybrid.py",
    "src/repro_torch/models/encdec.py",
    "src/repro_torch/data/corpus.py",
    "src/repro_torch/data/dedup.py",
    "src/repro_torch/models/scan_utils.py",
    "src/repro_torch/train/__init__.py",
    "src/repro_torch/train/optimizer.py",
    "src/repro_torch/train/train_step.py",
    "src/repro_torch/train/trainer.py",
    "src/repro_torch/train/compress.py",
    "src/repro_torch/launch/train.py",
    "src/repro_torch/launch/dryrun.py",
]


@pytest.mark.parametrize("path", NEW_MODULES)
def test_new_modules_never_name_the_reference(path):
    """Not even in a docstring: these modules name no ``repro.`` module."""
    src = (ROOT / path).read_text()
    assert not re.findall(r"\brepro\.", src), path


def test_entry_points_need_a_gpu_unless_asked_for_cpu(monkeypatch):
    """device=None means CUDA: without a GPU the entry points raise, never fall back."""
    from repro_torch.core import pipeline
    from repro_torch.core.cover import build_cover
    from repro_torch.core.mln import MLNMatcher
    from repro_torch.core.rules import RulesMatcher
    from repro_torch.data.synthetic import SynthConfig, make_dataset

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    ds = make_dataset(SynthConfig.hepth(scale=0.035, seed=7))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        pipeline.resolve(ds.entities, ds.relations)
    with pytest.raises(RuntimeError):
        pipeline.prepare(ds.entities, ds.relations)
    with pytest.raises(RuntimeError):
        MLNMatcher()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        RulesMatcher()
    with pytest.raises(RuntimeError):
        build_cover(ds.entities, ds.relations)
    assert MLNMatcher(device="cpu").device.type == "cpu"
    assert RulesMatcher(device="cpu").device.type == "cpu"

    from repro_torch.core.matchers import get_matcher, list_matchers
    from repro_torch.core.matchers.assignment import AssignmentMatcher
    from repro_torch.core.matchers.embedding import EmbeddingMatcher

    for name in list_matchers():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            get_matcher(name)
        assert get_matcher(name, device="cpu").device.type == "cpu"
    with pytest.raises(RuntimeError, match="device='cpu'"):
        AssignmentMatcher()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        EmbeddingMatcher(encoder="lm")

    from repro_torch.configs.base import smoke_config
    from repro_torch.launch import serve
    from repro_torch.models.registry import get_model
    from repro_torch.serve.engine import Engine, demo_engine

    api = get_model(smoke_config("yi_6b"))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        demo_engine(api)
    cpu_engine = demo_engine(api, device="cpu")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Engine(api, cpu_engine.params, batch=2, s_max=16)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        serve.main(["--arch", "yi_6b", "--smoke"])
    assert cpu_engine.device.type == "cpu"


KERNELS = ["icm_sweep", "ngram_sim", "mln_score", "minhash", "flash_attn"]


@pytest.mark.parametrize("name", KERNELS)
def test_wrappers_use_plain_version_only_for_cpu_tensors(name):
    """A CPU tensor runs the plain version and launches nothing."""
    import numpy as np

    from repro_torch.kernels.flash_attn import ops as flash
    from repro_torch.kernels.icm_sweep import ops as icm
    from repro_torch.kernels.minhash import ops as mh
    from repro_torch.kernels.mln_score import ops as score
    from repro_torch.kernels.ngram_sim import ops as sim

    rng = np.random.default_rng(0)
    t = lambda *s: torch.as_tensor(rng.random(s).astype(np.float32))  # noqa: E731
    table = torch.as_tensor(mh.hash_table(8, 16))
    wrapper, args, dtype = {
        "icm_sweep": (icm.sweep_batched, (t(2, 8), t(2, 8, 8), t(2, 3, 8)), torch.float32),
        "ngram_sim": (sim.sim_above, (t(1, 16), t(5, 16), 0.5), torch.float32),
        "mln_score": (score.score_sets, (t(2, 8), t(2, 8, 8), t(2, 3, 8)), torch.float32),
        "minhash": (mh.minhash, (t(5, 16), table), torch.int32),
        "flash_attn": (flash.attention, (t(2, 8, 4, 16), t(2, 8, 2, 16), t(2, 8, 2, 16), 0.25),
                       torch.float32),
    }[name]
    before = wrapper.launches
    out = wrapper(*args)
    assert out.device.type == "cpu" and out.dtype == dtype
    assert wrapper.launches == before


@pytest.mark.parametrize("name", KERNELS)
def test_wrappers_raise_on_non_cuda_devices(name):
    """Off the CPU a wrapper launches its CUDA kernel or raises: a tensor on
    another device never reaches the kernel and never takes the plain path."""
    from repro_torch.kernels.flash_attn import ops as flash
    from repro_torch.kernels.icm_sweep import ops as icm
    from repro_torch.kernels.minhash import ops as mh
    from repro_torch.kernels.mln_score import ops as score
    from repro_torch.kernels.ngram_sim import ops as sim

    t = lambda *s, dtype=torch.float32: torch.empty(s, device="meta", dtype=dtype)  # noqa: E731
    wrapper, args = {
        "icm_sweep": (icm.sweep_batched, (t(2, 8), t(2, 8, 8), t(2, 3, 8))),
        "ngram_sim": (sim.sim_above, (t(1, 16), t(5, 16), 0.5)),
        "mln_score": (score.score_sets, (t(2, 8), t(2, 8, 8), t(2, 3, 8))),
        "minhash": (mh.minhash, (t(5, 16), t(8, 16, dtype=torch.int32))),
        "flash_attn": (flash.attention, (t(2, 8, 4, 16), t(2, 8, 2, 16), t(2, 8, 2, 16), 0.25)),
    }[name]
    before = wrapper.launches
    with pytest.raises(ValueError, match="CUDA"):
        wrapper(*args)
    assert wrapper.launches == before


def test_resolve_service_needs_a_gpu_unless_asked_for_cpu(monkeypatch):
    """ResolveService() runs on CUDA: without a GPU it raises, never falls back."""
    from repro_torch.stream import ResolveService, ServiceConfig

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ResolveService()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ResolveService(ServiceConfig(scheme="mmp"))
    assert ResolveService(device="cpu").device.type == "cpu"


@pytest.mark.parametrize("what", ["shard", "recover_shard", "checkpoint_shardings"])
def test_unported_service_options_raise(what, tmp_path):
    """Each sharded-serving option, which used to raise, now runs on the CPU
    (on a one-rank shard context here; many ranks in test_torch_shard_mesh.py)."""
    import numpy as np
    from torch.distributed.tensor import Replicate

    from repro_torch.checkpoint.checkpointer import Checkpointer
    from repro_torch.stream import ResolveService, ServiceConfig
    from repro_torch.stream.digest import state_digest
    from repro_torch.stream.shard import ShardContext

    ctx = ShardContext.create(device="cpu")
    names = ["ada lovelace", "a. lovelace", "charles babbage"]
    if what == "shard":
        svc = ResolveService(shard=ctx, device="cpu")
        svc.ingest(names)
        assert svc.shard is ctx and svc.delta.index.shard == ctx.spec
        assert svc.delta.index.merge == ctx.merger.union
    elif what == "recover_shard":
        cfg = ServiceConfig(durability_dir=str(tmp_path), checkpoint_every=1)
        svc = ResolveService(cfg, shard=ctx, device="cpu")
        svc.ingest(names)
        svc.close()
        rec = ResolveService.recover(str(tmp_path), cfg, shard=ctx, device="cpu")
        assert state_digest(rec) == state_digest(svc)
        # the checkpoint dropped the merge hook: recovery binds this process's
        assert rec.delta.index.merge == ctx.merger.union
        rec.close()
    else:
        ck = Checkpointer(str(tmp_path))
        ck.save(0, {"s": {"w": np.ones(3, np.float32)}})
        got = ck.restore(0, {"s": {"w": np.zeros(3, np.float32)}}, mesh=ctx.mesh,
                         shardings={"s": Replicate()})
        assert torch.equal(got["s"]["w"], torch.ones(3))


def test_durable_service_and_recovery_need_a_gpu_unless_asked_for_cpu(monkeypatch, tmp_path):
    """Durability, recovery and serving follow the same device rule."""
    import numpy as np

    from repro_torch.checkpoint.checkpointer import Checkpointer
    from repro_torch.stream import ResolveService, ServiceConfig, ServingFrontend

    cfg = ServiceConfig(durability_dir=str(tmp_path / "d"), checkpoint_every=1)
    svc = ResolveService(cfg, device="cpu")
    with ServingFrontend(svc) as fe:
        fe.submit(["ada lovelace", "a. lovelace"]).wait(60)
    svc.close()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ResolveService(cfg)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ResolveService.recover(str(tmp_path / "d"), cfg)
    rec = ResolveService.recover(str(tmp_path / "d"), cfg, device="cpu")
    assert rec.delta.n_entities == 2 and rec._seq == 1
    rec.close()
    ck = Checkpointer(str(tmp_path / "c"))
    ck.save(1, {"s": {"w": np.zeros(2)}})
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ck.restore(1, {"s": {"w": np.zeros(2)}})
    assert ck.restore(1, {"s": {"w": np.zeros(2)}}, device="cpu")["s"]["w"].device.type == "cpu"


def test_training_needs_a_gpu_unless_asked_for_cpu(monkeypatch, tmp_path):
    """The Trainer and the train launcher run on CUDA by default: without a
    GPU they raise, never fall back."""
    from repro_torch.configs.base import smoke_config
    from repro_torch.data.corpus import CorpusConfig
    from repro_torch.launch import train
    from repro_torch.models.registry import get_model
    from repro_torch.train.optimizer import OptConfig
    from repro_torch.train.trainer import Trainer, TrainerConfig

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    api = get_model(smoke_config("qwen1_5_0_5b"))
    data = CorpusConfig(vocab_size=512, seq_len=8, global_batch=2)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Trainer(api, data, OptConfig(), TrainerConfig(steps=1))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        train.main(["--arch", "qwen1_5_0_5b", "--smoke", "--steps", "1"])
    t = Trainer(api, data, OptConfig(), TrainerConfig(steps=1), device="cpu")
    assert t.device.type == "cpu" and t.run()["steps_done"] == 1


def _fake_world(n: int):
    """Rank 0 of a ``fake`` process group of ``n`` ranks (no collective runs):
    a mesh with a ``model`` axis lays out without devices."""
    import contextlib

    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore

    @contextlib.contextmanager
    def world():
        dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=n)
        try:
            yield
        finally:
            dist.destroy_process_group()

    return world()


def _item17_calls():
    from torch.distributed.device_mesh import DeviceMesh

    from repro_torch.configs.base import smoke_config
    from repro_torch.core import parallel
    from repro_torch.data import corpus
    from repro_torch.launch import dryrun
    from repro_torch.models import layers
    from repro_torch.models.registry import get_model
    from repro_torch.train import optimizer, train_step, trainer

    api = get_model(smoke_config("qwen1_5_0_5b"))

    def tp_mesh():
        return DeviceMesh("cpu", torch.arange(2).reshape(1, 2), mesh_dim_names=("data", "model"))

    calls = {
        "Trainer(mesh with model > 1)": lambda: trainer.Trainer(
            api, corpus.CorpusConfig(), optimizer.OptConfig(), trainer.TrainerConfig(),
            mesh=tp_mesh(), device="cpu"),
        "make_train_step(mesh with model > 1)": lambda: train_step.make_train_step(
            api, optimizer.OptConfig(), mesh=tp_mesh()),
    }
    for name in ("ambient_mesh", "shard_spec", "shard_batch"):
        calls[f"layers.{name}"] = getattr(layers, name)
    for name in ("build_round_fn", "build_bin_round_fn"):
        calls[f"parallel.{name}"] = getattr(parallel, name)
    for name in ("lower_cell", "lower_em_cell", "analyze", "roofline_terms"):
        calls[f"dryrun.{name}"] = getattr(dryrun, name)
    return calls


ITEM17 = [
    "Trainer(mesh with model > 1)", "make_train_step(mesh with model > 1)",
    "layers.ambient_mesh", "layers.shard_spec", "layers.shard_batch",
    "parallel.build_round_fn", "parallel.build_bin_round_fn",
    "dryrun.lower_cell", "dryrun.lower_em_cell", "dryrun.analyze", "dryrun.roofline_terms",
]


@pytest.mark.parametrize("name", ITEM17)
def test_tensor_parallel_and_dry_run_pieces_raise(name):
    """Tensor parallelism over the ``model`` axis, the activation pins, the
    round functions of the multi-pod dry run, and the dry-run tooling wait for
    ROADMAP.md Queue 1 item 17: each raises, naming the item."""
    calls = _item17_calls()
    assert sorted(calls) == sorted(ITEM17)
    with _fake_world(2), pytest.raises(NotImplementedError, match="item 17"):
        calls[name]()
