"""Build a CUDA source of ``rlpyt_tpu_torch/csrc`` into a shared library
with a plain C interface (nvcc, ``sm_90a``), for loading with ctypes.

The library goes into ``rlpyt_tpu_torch/csrc/build/`` (git-ignored),
named by the hash of its source and flags, so a changed source is built
anew and an unchanged one is reused.  The compiler's messages (with
``-Xptxas=-v``: registers, shared memory and spills of each kernel) are
kept beside it in a ``.log`` file.
"""
from __future__ import annotations

import hashlib
import os
import subprocess
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = CSRC / "build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC")


def nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME
    if CUDA_HOME is None:
        raise RuntimeError("no CUDA toolkit found to build the kernels "
                           "(set CUDA_HOME)")
    return os.path.join(CUDA_HOME, "bin", "nvcc")


def build_library(src: Path, extra_flags=()) -> Path:
    """Compile ``src`` unless a build of this source and these flags
    exists; return the library's path."""
    flags = NVCC_FLAGS + tuple(extra_flags)
    tag = hashlib.sha256(src.read_bytes()
                         + " ".join(flags).encode()).hexdigest()[:16]
    out = BUILD_DIR / f"{src.stem}_{tag}.so"
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    proc = subprocess.run([nvcc(), *flags, "-o", str(tmp), str(src)],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on {src}:\n{proc.stderr}")
    out.with_suffix(".log").write_text(proc.stdout + proc.stderr)
    os.replace(tmp, out)
    return out
