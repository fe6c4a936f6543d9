"""Nothing the benchmark runs imports JAX or the JAX package (top-level
names compared whole: ``rlpyt_tpu_torch`` begins with ``rlpyt_tpu``),
and the reference imports nothing of the program."""
import ast
import subprocess
import sys

from registry import BENCH_DIR, ROOT

DRY_RUN = """
import sys, time
sys.path[:0] = [{bench!r}, {root!r}]
import run
run.prepare_environment()
import calibrate, harness
from conftest import TINY_MINATAR
harness.run_cell("minatar_r2d1.lanes256", 1, 0.2, True, time.perf_counter(),
                 "cpu", overrides=TINY_MINATAR)
print(run.forbidden_modules())
print(sorted({{m.split('.')[0] for m in sys.modules}}))
"""


def test_dry_run_imports_no_jax():
    code = DRY_RUN.format(bench=str(BENCH_DIR), root=str(ROOT))
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, cwd=BENCH_DIR / "tests", timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    forbidden, loaded = proc.stdout.strip().splitlines()[-2:]
    assert forbidden == "[]"
    assert "'rlpyt_tpu_torch'" in loaded


def _imports(path):
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_reference_imports_nothing_of_the_program():
    files = sorted((BENCH_DIR / "reference").rglob("*.py"))
    assert files
    for f in files:
        tops = {m.split(".")[0] for m in _imports(f)}
        assert not tops & {"rlpyt_tpu_torch", "rlpyt_tpu", "jax", "jaxlib",
                           "flax", "optax"}, (f, tops)
    code = (f"import sys; sys.path.insert(0, {str(BENCH_DIR)!r}); "
            "import reference.r2d1; "
            "print(sorted({m.split('.')[0] for m in sys.modules}))")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300).stdout
    assert "rlpyt_tpu" not in out


def test_harness_files_import_no_jax():
    for f in sorted(BENCH_DIR.rglob("*.py")):
        tops = {m.split(".")[0] for m in _imports(f)}
        assert not tops & {"rlpyt_tpu", "jax", "jaxlib", "flax", "optax"}, f
