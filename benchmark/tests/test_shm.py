"""The host farm the harness builds keeps its shared-memory arenas under
TMPDIR, not in /dev/shm, and leaves no file behind."""
import json
import os
import subprocess
import sys

from registry import BENCH_DIR, ROOT

BUILD_FARM = """
import json, multiprocessing.heap as heap, os, sys
sys.path[:0] = [{bench!r}, {root!r}]
import run
run.prepare_environment()
from conftest import TINY_ATARI
from registry import Registry
from trainer import Trainer
reg = Registry()
t = Trainer(reg.config("atari_r2d1"), reg.traffic("farm32"), 3, "cpu",
            TINY_ATARI)
t.startup()
t.iteration()
fds = [os.readlink(f"/proc/self/fd/{{a.fd}}")
       for a in heap.BufferWrapper._heap._arenas]
t.close()
run.stop_resource_tracker()
print(json.dumps({{"pid": os.getpid(), "arenas": fds,
                   "sync": t.runner.vec.sync_impl}}))
"""


def _shm():
    try:
        return set(os.listdir("/dev/shm"))
    except FileNotFoundError:
        return set()


def test_farm_arenas_under_tmpdir(tmp_path):
    before = _shm()
    env = dict(os.environ, TMPDIR=str(tmp_path))
    code = BUILD_FARM.format(bench=str(BENCH_DIR), root=str(ROOT))
    proc = subprocess.run([sys.executable, "-c", code], env=env,
                          capture_output=True, text=True, timeout=600,
                          cwd=BENCH_DIR / "tests")
    assert proc.returncode == 0, proc.stderr[-3000:]
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    assert out["arenas"]
    for target in out["arenas"]:
        assert target.startswith(str(tmp_path)), target
        assert not target.startswith("/dev/shm")
    new = _shm() - before
    assert not [n for n in new if str(out["pid"]) in n], new
    # multiprocessing's directory of arenas is removed at exit.
    assert not [p for p in tmp_path.iterdir() if p.name.startswith("pymp")]
