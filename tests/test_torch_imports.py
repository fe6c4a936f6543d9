"""The PyTorch port, its chip smoke test and its bench_torch_* harnesses
import nothing of JAX (jax, flax, optax) and nothing of the JAX package
(rlpyt_tpu)."""
import ast
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "rlpyt_tpu")
PORT_FILES = (sorted((ROOT / "rlpyt_tpu_torch").rglob("*.py"))
              + [ROOT / "chip_smoke.py"]
              + sorted(ROOT.glob("bench_torch_*.py")))


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
                 "replay/prioritized.py", "algos/cat_dqn.py"):
        assert f"rlpyt_tpu_torch/{name}" in names
    assert "bench_torch_gather_formulations.py" in names
    assert "chip_smoke.py" in names and len(names) > 20
