"""ctypes loader and sync objects for the C host-farm barrier (port of
rlpyt_tpu/envs/hostfarm_c.py; the C source is the port's own copy,
``rlpyt_tpu_torch/csrc/hostfarm.c``, which documents the protocol).

The library is built on first use with ``cc -O2 -shared -fPIC`` into
``rlpyt_tpu_torch/csrc/build/`` (git-ignored), named by the hash of its
source, and loaded.  The master and worker halves of the barrier pickle
across ``spawn``: each process re-opens the library and re-views the
shared control block.  ``get_lib()`` returns None when the library does
not build (no compiler, not Linux); ``SharedMemVecEnv(sync="auto")`` then
keeps its multiprocessing.Event path and ``sync="c"`` raises.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import sys
import threading
from pathlib import Path

_lock = threading.Lock()
_lib = None
_lib_failed = False

CSRC = Path(__file__).resolve().parent.parent / "csrc"
SOURCE = CSRC / "hostfarm.c"
BUILD_DIR = CSRC / "build"
CTRL_SLOTS_BASE = 32
CTRL_SLOTS_PER_WORKER = 16
# Spin-before-sleep pays only when every worker (and the master) has a
# core of its own: set RLPYT_TPU_FARM_SPIN to about 20000 on such hosts.
# The default 0 (straight futex sleep) is robust under oversubscription.
DEFAULT_SPIN = int(os.environ.get("RLPYT_TPU_FARM_SPIN", "0"))


def build() -> Path:
    """Compile the source unless a build of it exists; return the path.
    Raises if the compiler fails."""
    tag = hashlib.sha256(SOURCE.read_bytes()).hexdigest()[:16]
    out = BUILD_DIR / f"hostfarm_{tag}.so"
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cc = os.environ.get("CC", "cc")
    proc = subprocess.run([cc, "-O2", "-shared", "-fPIC", "-o", str(tmp),
                           str(SOURCE)], capture_output=True, text=True,
                          timeout=60)
    if proc.returncode != 0:
        raise RuntimeError(f"{cc} failed on {SOURCE}:\n{proc.stderr}")
    os.replace(tmp, out)
    return out


def get_lib():
    """Build (once) and load the library; None if it is unavailable."""
    global _lib, _lib_failed
    if _lib is not None or _lib_failed:
        return _lib
    with _lock:
        if _lib is not None or _lib_failed:
            return _lib
        try:
            if not sys.platform.startswith("linux"):
                raise OSError("the futex barrier needs Linux")
            lib = ctypes.CDLL(str(build()))
        except (OSError, RuntimeError, subprocess.SubprocessError):
            _lib_failed = True
            return None
        u32p = ctypes.c_void_p
        lib.hf_master_signal.argtypes = [u32p, ctypes.c_uint32]
        lib.hf_master_wait.argtypes = [u32p, ctypes.c_int, ctypes.c_uint32,
                                       ctypes.c_int]
        lib.hf_worker_wait.argtypes = [u32p, ctypes.c_uint32, ctypes.c_int]
        lib.hf_worker_wait.restype = ctypes.c_uint32
        lib.hf_worker_post.argtypes = [u32p, ctypes.c_int, ctypes.c_uint32]
        lib.hf_read_cmd.argtypes = [u32p]
        lib.hf_read_cmd.restype = ctypes.c_uint32
        _lib = lib
        return _lib


class _CFarmHalf:
    """One side of the barrier over a ``_ShmSpec`` of uint32 slots; the
    library and the view are (re)opened at first use in each process."""

    def __init__(self, ctrl_spec, spin: int = DEFAULT_SPIN):
        self._spec = ctrl_spec
        self.spin = spin
        self._seq = 0
        self._ptr = None

    def __getstate__(self):
        d = dict(self.__dict__)
        d["_ptr"] = None
        d.pop("_view", None)
        d.pop("_lib", None)
        return d

    def _ensure(self):
        if self._ptr is None:
            view = self._spec.view()
            self._ptr = view.ctypes.data_as(ctypes.c_void_p)
            self._view = view               # keeps the buffer alive
            self._lib = get_lib()
        return self._lib


class CFarmMaster(_CFarmHalf):
    """Master half: one signal and one wait per env step (a C call each)."""

    def __init__(self, ctrl_spec, n_workers: int, spin: int = DEFAULT_SPIN):
        super().__init__(ctrl_spec, spin)
        self.n_workers = n_workers

    def signal(self, cmd: int):
        lib = self._ensure()
        self._seq += 1
        lib.hf_master_signal(self._ptr, cmd)

    def wait(self):
        lib = self._ensure()
        lib.hf_master_wait(self._ptr, self.n_workers, self._seq, self.spin)


class CFarmWorker(_CFarmHalf):
    """Worker half of worker ``w``."""

    def __init__(self, ctrl_spec, w: int, spin: int = DEFAULT_SPIN):
        super().__init__(ctrl_spec, spin)
        self.w = w

    def wait(self) -> int:
        """Block for the next master signal; returns the command word."""
        lib = self._ensure()
        self._seq = int(lib.hf_worker_wait(self._ptr, self._seq, self.spin))
        return int(lib.hf_read_cmd(self._ptr))

    def post(self):
        lib = self._ensure()
        lib.hf_worker_post(self._ptr, self.w, self._seq)
