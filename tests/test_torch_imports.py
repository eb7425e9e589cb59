"""Import hygiene of the port: nothing under ``src/repro_torch/``, and not
``chip_smoke.py``, imports JAX or the JAX package; importing the port's
core, ops, models, serving and training launchers loads neither; and the
entry points refuse to run without CUDA unless the caller asks for the
CPU."""
import ast
import subprocess
import sys
from pathlib import Path

import pytest
import torch

REPO = Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "repro")


def _imported_roots(path: Path) -> set[str]:
    roots = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            roots.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            roots.add(node.module.split(".")[0])
    return roots


def test_port_sources_import_neither_jax_nor_the_jax_package():
    files = sorted((REPO / "src" / "repro_torch").rglob("*.py"))
    files.append(REPO / "chip_smoke.py")
    files.append(REPO / "examples" / "torch_serve_shared_experts.py")
    files.append(REPO / "examples" / "torch_train_isolated_tenants.py")
    assert len(files) > 15
    for f in files:
        bad = _imported_roots(f) & set(FORBIDDEN)
        assert not bad, f"{f.relative_to(REPO)} imports {sorted(bad)}"


def test_importing_the_port_loads_no_jax():
    code = ("import sys, repro_torch.core, repro_torch.kernels.ops, "
            "repro_torch.convert, repro_torch.configs, "
            "repro_torch.models.registry, repro_torch.launch.serve, "
            "repro_torch.launch.train\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            f"{FORBIDDEN!r}]\n"
            "assert not bad, bad\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          env={"PYTHONPATH": str(REPO / "src"),
                               "PATH": "/usr/bin:/bin"},
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_fault_and_timing_modules_import_with_jax_blocked():
    """The fault-tolerance, memsim and workload modules import while any
    import of JAX or the JAX package raises."""
    mods = ["repro_torch.core.faults", "repro_torch.core.cache",
            "repro_torch.runtime", "repro_torch.runtime.fault_tolerance",
            "repro_torch.checkpointing", "repro_torch.checkpointing.store",
            "repro_torch.memsim", "repro_torch.memsim.clock",
            "repro_torch.memsim.lru", "repro_torch.memsim.model",
            "repro_torch.memsim.replay", "repro_torch.workloads",
            "repro_torch.workloads.graphs", "repro_torch.workloads.gapbs"]
    code = ("import importlib, sys\n"
            f"for name in {FORBIDDEN!r}:\n"
            "    sys.modules[name] = None\n"
            f"for m in {mods!r}:\n"
            "    importlib.import_module(m)\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          env={"PYTHONPATH": str(REPO / "src"),
                               "PATH": "/usr/bin:/bin"},
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_model_family_modules_import_with_jax_blocked():
    """The MoE, Mamba and encoder-decoder modules and every model family
    import while any import of JAX or the JAX package raises."""
    mods = ["repro_torch.layers.moe", "repro_torch.layers.moe_ep",
            "repro_torch.layers.mamba", "repro_torch.models.ssm",
            "repro_torch.models.hybrid", "repro_torch.models.encdec",
            "repro_torch.models.registry", "repro_torch.convert"]
    code = ("import importlib, sys\n"
            f"for name in {FORBIDDEN!r}:\n"
            "    sys.modules[name] = None\n"
            f"for m in {mods!r}:\n"
            "    importlib.import_module(m)\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          env={"PYTHONPATH": str(REPO / "src"),
                               "PATH": "/usr/bin:/bin"},
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_training_modules_import_with_jax_blocked():
    """The data pipeline, the optimizer, the step functions and the
    launcher import while any import of JAX or the JAX package raises."""
    mods = ["repro_torch.data", "repro_torch.data.pipeline",
            "repro_torch.optim", "repro_torch.optim.adamw",
            "repro_torch.launch.steps", "repro_torch.launch.train",
            "repro_torch.layers.common", "repro_torch.convert"]
    code = ("import importlib, sys\n"
            f"for name in {FORBIDDEN!r}:\n"
            "    sys.modules[name] = None\n"
            f"for m in {mods!r}:\n"
            "    importlib.import_module(m)\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          env={"PYTHONPATH": str(REPO / "src"),
                               "PATH": "/usr/bin:/bin"},
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_training_entry_points_need_cuda_unless_asked_for_the_cpu(
        monkeypatch):
    from repro_torch.configs import ARCHS, smoke_config
    from repro_torch.launch import train
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        train.main(["--steps", "1", "--batch", "2", "--seq", "8"])
    model, opt = train.init_model(smoke_config(ARCHS["qwen1.5-0.5b"]),
                                  "cpu")
    assert opt.step.device.type == "cpu"
    assert all(p.requires_grad for p in model.parameters())


def test_entry_points_need_cuda_unless_asked_for_the_cpu(monkeypatch):
    from repro_torch.core import (FabricManager, ShardedFabric, make_table,
                                  make_perm_cache)
    from repro_torch.kernels import ops
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        ShardedFabric(1 << 10, 64, 2)
    with pytest.raises(RuntimeError, match="CUDA"):
        make_table(8)
    with pytest.raises(RuntimeError, match="CUDA"):
        make_perm_cache()
    with pytest.raises(RuntimeError, match="CUDA"):
        ops.memory_encrypt([1, 2, 3], key0=1, key1=2)
    with pytest.raises(RuntimeError, match="CUDA"):
        FabricManager(1 << 10, 8).table.to_device()
    assert ShardedFabric(1 << 10, 64, 2, device="cpu").device.type == "cpu"
    from repro_torch.workloads import gapbs, graphs
    g = graphs.make_graph(scale=6, avg_degree=4)
    for fn in (gapbs.pagerank, gapbs.connected_components):
        with pytest.raises(RuntimeError, match="CUDA"):
            fn(g)
        assert fn(g, device="cpu").device.type == "cpu"


def test_serving_entry_points_need_cuda_unless_asked_for_the_cpu(
        monkeypatch):
    from repro_torch.configs import ARCHS, smoke_config
    from repro_torch.launch import serve
    from repro_torch.models import registry
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = smoke_config(ARCHS["qwen3-4b"])
    with pytest.raises(RuntimeError, match="CUDA"):
        registry.init_params(cfg, torch.Generator())
    params = registry.init_params(cfg, torch.Generator(), "cpu")
    with pytest.raises(RuntimeError, match="CUDA"):
        registry.model_module(cfg).init_cache(cfg, 1, 8)
    with pytest.raises(RuntimeError, match="CUDA"):
        serve.ServeEngine(cfg, params, batch=1, cap=8)
    with pytest.raises(RuntimeError, match="CUDA"):
        serve.main(["--requests", "2", "--prompt-len", "4", "--gen", "2"])
    assert serve.ServeEngine(cfg, params, batch=1, cap=8,
                             device="cpu").device.type == "cpu"
    for arch in ("olmoe-1b-7b", "falcon-mamba-7b", "zamba2-1.2b",
                 "seamless-m4t-medium"):
        cfg = smoke_config(ARCHS[arch])
        with pytest.raises(RuntimeError, match="CUDA"):
            registry.init_params(cfg, torch.Generator())
        args = (cfg, 1, 8, 2) if cfg.family == "encdec" else (cfg, 1, 8)
        with pytest.raises(RuntimeError, match="CUDA"):
            registry.model_module(cfg).init_cache(*args)
        assert registry.init_params(cfg, torch.Generator(), "cpu") \
            is not None


def test_mesh_and_sharding_modules_import_with_jax_blocked():
    """The meshes, the rule engine, the activation constraints and the
    modules that call them import while any import of JAX or the JAX
    package raises, and importing them starts no process group."""
    mods = ["repro_torch.launch.mesh", "repro_torch.launch.sharding",
            "repro_torch.launch.activations", "repro_torch.layers.moe_ep",
            "repro_torch.layers.attention", "repro_torch.layers.mamba",
            "repro_torch.checkpointing.store", "repro_torch.launch.train"]
    code = ("import importlib, sys\n"
            f"for name in {FORBIDDEN!r}:\n"
            "    sys.modules[name] = None\n"
            f"for m in {mods!r}:\n"
            "    importlib.import_module(m)\n"
            "import torch.distributed as dist\n"
            "assert not dist.is_initialized()\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          env={"PYTHONPATH": str(REPO / "src"),
                               "PATH": "/usr/bin:/bin"},
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_dry_run_modules_import_with_jax_blocked():
    """The dry run and its cost analyzer import while any import of JAX or
    the JAX package raises, and importing them starts no process group
    and sets no ``XLA_FLAGS``."""
    mods = ["repro_torch.launch.hlo_analysis", "repro_torch.launch.dryrun"]
    code = ("import importlib, os, sys\n"
            f"for name in {FORBIDDEN!r}:\n"
            "    sys.modules[name] = None\n"
            f"for m in {mods!r}:\n"
            "    importlib.import_module(m)\n"
            "import torch.distributed as dist\n"
            "assert not dist.is_initialized()\n"
            "assert 'XLA_FLAGS' not in os.environ\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          env={"PYTHONPATH": str(REPO / "src"),
                               "PATH": "/usr/bin:/bin"},
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
