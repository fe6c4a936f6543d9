"""Two OS processes joined by the port's ``init_distributed`` (gloo over
localhost), each a host of a two-host group: the twins of
tests/test_multihost.py:55 and :74.  The worker,
tests/_torch_multihost_worker.py, imports the port only."""
import os
import socket
import subprocess
import sys
from pathlib import Path

import pytest

WORKER = Path(__file__).with_name("_torch_multihost_worker.py")
REPO = WORKER.parent.parent


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _run_workers(*extra, n: int = 2, timeout: int = 300):
    coord = f"127.0.0.1:{_free_port()}"
    procs = [
        subprocess.Popen(
            [sys.executable, str(WORKER), coord, str(n), str(i), *extra],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
            cwd=str(REPO),
            env={**os.environ,
                 "PYTHONPATH": str(REPO) + os.pathsep
                 + os.environ.get("PYTHONPATH", "")})
        for i in range(n)
    ]
    outs = []
    for p in procs:
        try:
            out, _ = p.communicate(timeout=timeout)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            raise
        outs.append(out)
    for i, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"rank {i} failed:\n{out}"
    return outs


def _ok_lines(outs, tag: str) -> dict:
    lines = {}
    for out in outs:
        ok = [line for line in out.splitlines() if line.startswith(tag)]
        assert ok, f"no {tag} line in:\n{out}"
        parts = dict(kv.split("=") for kv in ok[0].split()[1:])
        lines[int(parts["rank"])] = parts
    assert set(lines) == {0, 1}
    return lines


def test_two_process_syncrl_identical_params():
    """SyncRl over a group that each process joined itself: equal final
    parameters, disjoint covering lane slices, every lane counted."""
    lines = _ok_lines(_run_workers(), "MULTIHOST_OK")
    assert lines[0]["digest"] == lines[1]["digest"]
    assert lines[0]["slice"] == "0:8" and lines[1]["slice"] == "8:16"
    assert int(lines[0]["cum"]) >= 1_024


def test_host_farm_feeds_global_update():
    """Each process steps a SharedMemVecEnv of its lanes of the global
    batch and feeds them to one data-parallel DQN: equal final
    parameters, disjoint covering slices, updates made."""
    pytest.importorskip("gymnasium")
    lines = _ok_lines(_run_workers("farm"), "FARMHOST_OK")
    assert lines[0]["digest"] == lines[1]["digest"]
    assert lines[0]["slice"] == "0:4" and lines[1]["slice"] == "4:8"
    assert int(lines[0]["updates"]) > 0
