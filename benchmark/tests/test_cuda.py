"""Each cell for a few seconds on the card (``-m cuda``; skipped without
one): the result line says correct."""
import json
import subprocess
import sys

import pytest
import torch

from registry import ROOT, Registry


@pytest.mark.cuda
@pytest.mark.parametrize("cell", [w["name"] for w in
                                  Registry().spec["workloads"]])
def test_cell_runs_correct(cell):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    proc = subprocess.run(
        [sys.executable, str(ROOT / "benchmark" / "run.py"), "--workload",
         cell, "--seed", "99", "--seconds", "3", "--trace", "0"],
        capture_output=True, text=True, cwd=ROOT, timeout=900)
    assert proc.returncode == 0, proc.stderr[-3000:]
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    assert out["correct"], out["checks"]
