"""The port stands alone: it imports neither JAX nor the reference package,
its copies of the scheduler brain do not drift from the reference, and its
entry points refuse to carry on quietly on a host without CUDA."""
import ast
import os
import re
import shutil
import subprocess
import sys
from pathlib import Path

import pytest
import torch

# one intra-op thread: the suite runs several test workers on a few cores,
# and oversubscribed threads slow these many small CPU ops a hundredfold
torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parent.parent
PORT = ROOT / "src" / "repro_torch"
REF = ROOT / "src" / "repro"

#: modules the port keeps as copies of the reference: equal to the original
#: after the import-prefix rewrite `repro.` -> `repro_torch.`
COPIED = ["core/request.py", "core/simulator.py", "core/backend.py",
          "core/cluster.py", "core/coordinator.py", "core/costmodel.py",
          "core/predictor.py", "core/metrics.py", "core/schedulers.py",
          "sp/planner.py", "configs/base.py", "configs/mistral_7b.py",
          "configs/qwen2_7b.py", "configs/llama3_8b.py",
          "configs/mamba2_130m.py", "configs/zamba2_2_7b.py",
          "configs/olmoe_1b_7b.py", "configs/llama4_maverick_400b_a17b.py",
          "configs/seamless_m4t_large_v2.py", "configs/internvl2_76b.py",
          "configs/phi3_14b.py", "configs/yi_34b.py", "configs/llama31_70b.py",
          "configs/minitron_8b.py", "configs/phi4_mini_3_8b.py",
          "core/__init__.py", "core/arrivals.py", "core/trace.py",
          "core/scenarios.py", "core/workload.py", "core/fleet.py",
          "experiments/__init__.py", "experiments/spec.py",
          "experiments/claims.py", "experiments/report.py",
          "experiments/robustness.py"]


def _port_files():
    return sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]


def _imported_modules(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


@pytest.mark.parametrize("path", _port_files(),
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_reference_import(path):
    for mod in _imported_modules(path):
        top = mod.split(".")[0]
        assert top not in ("jax", "jaxlib", "repro"), f"{path}: imports {mod}"


def test_package_imports_without_jax():
    """Every module of the port imports with `jax` and `repro` blocked."""
    code = ("import sys, pkgutil, importlib\n"
            "sys.modules['jax'] = None\nsys.modules['repro'] = None\n"
            "import repro_torch\n"
            "for m in pkgutil.walk_packages(repro_torch.__path__, 'repro_torch.'):\n"
            "    importlib.import_module(m.name)\n"
            "print('ok')\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


@pytest.mark.parametrize("rel", COPIED)
def test_copied_module_matches_reference(rel):
    want = re.sub(r"\brepro\.", "repro_torch.", (REF / rel).read_text())
    assert (PORT / rel).read_text() == want, \
        f"src/repro_torch/{rel} drifted from src/repro/{rel}"


@pytest.fixture
def no_cuda():
    if torch.cuda.is_available():
        pytest.skip("this host has CUDA: entry points legitimately run there")


def _tiny():
    import dataclasses

    from repro_torch.configs import get_config, reduced_config
    from repro_torch.models import init_params
    cfg = dataclasses.replace(reduced_config(get_config("mistral_7b")),
                              dtype="float32")
    return cfg, init_params(cfg, device="cpu")


@pytest.mark.parametrize("entry", ["engine", "backend", "cluster", "init",
                                   "serve_cli", "quickstart_cli",
                                   "serve_cluster_cli", "engine_overhead_cli",
                                   "engine_stack", "run_spec"])
def test_entry_points_raise_without_cuda(no_cuda, entry, monkeypatch):
    from repro_torch.experiments import runner
    from repro_torch.experiments.spec import ExperimentSpec
    from repro_torch.launch import engine_overhead, quickstart, serve, serve_cluster
    from repro_torch.models import init_params
    from repro_torch.serving import EngineBackend, MiniCluster, ReplicaEngine
    cfg, params = _tiny()
    calls = {
        "engine": lambda: ReplicaEngine(cfg, params),
        "backend": lambda: EngineBackend(cfg, params),
        "cluster": lambda: MiniCluster(cfg, params),
        "init": lambda: init_params(cfg),
        "serve_cli": serve.main,
        "quickstart_cli": lambda: quickstart.main(["--arch", "zamba2_2_7b",
                                                   "--layers", "2"]),
        "serve_cluster_cli": lambda: serve_cluster.main(["--layers", "2"]),
        "engine_overhead_cli": lambda: engine_overhead.main(["--layers", "2"]),
        "engine_stack": lambda: runner.engine_stack("mistral_7b", "analytic"),
        "run_spec": lambda: runner.run_spec(ExperimentSpec(
            policy="fifo", scenario="smoke_mini", backend="engine")),
    }
    monkeypatch.setattr(sys, "argv", ["serve", "--layers", "2"])
    with pytest.raises(RuntimeError):
        calls[entry]()


def test_chip_smoke_refuses_without_cuda(no_cuda, tmp_path):
    """chip_smoke.py exits non-zero and prints no result line without a
    card, and so does a lone copy of it outside the repository."""
    lone = tmp_path / "chip_smoke.py"
    shutil.copy(ROOT / "chip_smoke.py", lone)
    for script in (ROOT / "chip_smoke.py", lone):
        out = subprocess.run([sys.executable, str(script)], capture_output=True,
                             text=True, cwd=script.parent, timeout=120)
        assert out.returncode != 0
        assert '"ok"' not in out.stdout
