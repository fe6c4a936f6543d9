"""The PyTorch port, its chip smoke test, its bench_torch_* harnesses and
its learning tests (which run where only PyTorch is installed) import
nothing of JAX (jax, flax, optax) and nothing of the JAX package
(rlpyt_tpu)."""
import ast
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "rlpyt_tpu")
PORT_FILES = (sorted((ROOT / "rlpyt_tpu_torch").rglob("*.py"))
              + [ROOT / "chip_smoke.py"]
              + sorted(ROOT.glob("bench_torch_*.py"))
              + [ROOT / "tests" / "test_torch_minatar_learning.py",
                 ROOT / "tests" / "test_torch_pg_learning.py",
                 ROOT / "tests" / "test_torch_qpg_learning.py",
                 ROOT / "tests" / "test_torch_dqn_learning.py",
                 ROOT / "tests" / "test_torch_atari_learning.py",
                 ROOT / "tests" / "test_torch_checkpoint.py",
                 ROOT / "tests" / "test_torch_learning_coverage.py",
                 ROOT / "tests" / "test_torch_host_learning.py",
                 ROOT / "tests" / "test_torch_surface.py",
                 ROOT / "tests" / "test_torch_resnet_r2d1.py",
                 ROOT / "tests" / "_torch_multihost_worker.py",
                 ROOT / "tests" / "_torch_graph_standin.py",
                 ROOT / "tests" / "test_torch_collector_graph.py",
                 ROOT / "tests" / "test_torch_r2d1_graph.py"])


def imported_modules(path: Path):
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_port_file_imports_no_jax(path):
    bad = [m for m in imported_modules(path)
           if m.split(".")[0] in FORBIDDEN]
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


def test_scan_covers_the_port():
    names = {p.relative_to(ROOT).as_posix() for p in PORT_FILES}
    for name in ("ops/frame_gather.py", "ops/union_gather.py",
                 "replay/prioritized.py", "algos/cat_dqn.py",
                 "envs/minatar.py", "ops/returns.py",
                 "distributions/categorical.py", "algos/base.py",
                 "spaces.py", "envs/classic.py", "models/pg.py",
                 "params.py", "agents/pg.py", "algos/pg.py",
                 "samplers/rollout.py", "runners/train.py",
                 "utils/logging.py", "utils/variant.py",
                 "experiments/configs/minatar_pg.py",
                 "experiments/scripts/minatar_pg.py",
                 "distributions/gaussian.py", "envs/reacher.py",
                 "envs/locomotion.py", "models/qpg.py", "agents/qpg.py",
                 "algos/qpg.py", "models/running_norm.py",
                 "struct.py", "models/dqn.py", "agents/dqn.py",
                 "algos/dqn.py", "utils/launching.py", "utils/seed.py",
                 "experiments/configs/minatar_dqn.py",
                 "experiments/scripts/minatar_dqn.py",
                 "envs/fake_ale.py", "envs/atari.py", "envs/gym_space.py",
                 "envs/hostfarm_c.py", "envs/host.py", "runners/host.py",
                 "experiments/configs/atari_dqn.py",
                 "experiments/scripts/atari_dqn.py",
                 "utils/checkpoint.py", "utils/profiling.py",
                 "runners/async_rl.py", "examples/example_1.py",
                 "examples/example_2.py", "examples/example_3.py",
                 "examples/example_5.py", "examples/example_6.py",
                 "examples/example_8.py", "parallel/mesh.py",
                 "runners/sync.py", "experiments/configs/mujoco_pg.py",
                 "experiments/configs/mujoco_qpg.py",
                 "experiments/scripts/mujoco_pg.py",
                 "experiments/scripts/mujoco_qpg.py",
                 "examples/example_4.py", "examples/example_7.py",
                 "examples/example_9.py"):
        assert f"rlpyt_tpu_torch/{name}" in names
    assert "bench_torch_gather_formulations.py" in names
    assert "bench_torch_minatar.py" in names
    assert "tests/test_torch_qpg_learning.py" in names
    assert "tests/test_torch_dqn_learning.py" in names
    assert "tests/test_torch_atari_learning.py" in names
    assert "tests/test_torch_checkpoint.py" in names
    assert "tests/_torch_multihost_worker.py" in names
    assert "tests/test_torch_learning_coverage.py" in names
    assert "tests/test_torch_host_learning.py" in names
    assert "chip_smoke.py" in names and len(names) > 20


def test_package_imports_build_and_load_nothing():
    """Importing the re-exporting packages (models, distributions, ops)
    and every kernel wrapper neither runs nvcc nor loads a library: in a
    fresh interpreter whose ``ctypes.CDLL`` and ``subprocess`` raise once
    torch is imported, the imports succeed, no wrapper holds a library,
    and no JAX module was imported."""
    code = """
import ctypes, subprocess, sys
import torch
def refuse(*args, **kwargs):
    raise AssertionError(f"called at import: {args[:1]}")
ctypes.CDLL = subprocess.run = subprocess.Popen = refuse
import rlpyt_tpu_torch.models as models
import rlpyt_tpu_torch.distributions as distributions
import rlpyt_tpu_torch.ops as ops
from rlpyt_tpu_torch.ops import frame_gather, lstm, union_gather
assert models.Conv2dHeadModel and distributions.Categorical
assert ops.polyak_update
assert frame_gather._lib is lstm._lib is union_gather._lib is None
bad = [m for m in sys.modules
       if m.split(".")[0] in ("jax", "jaxlib", "flax", "optax", "rlpyt_tpu")]
assert not bad, bad
print("ok")
"""
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr
