"""Masked frame-stack window gather: wrapper, plain version and loader
for the CUDA kernel ``rlpyt_tpu_torch/csrc/frame_gather.cu``.

The kernel ports the TPU Pallas kernels
``rlpyt_tpu/ops/pallas/frame_gather.py:111 gather_frame_stacks`` (K1) and
``rlpyt_tpu/ops/pallas/window_gather.py:79 gather_stacks_window`` (K2),
which compute one function on two ring layouts.  It is bound by HBM
bytes: ``batch * (U + 2K) * F`` (each union row read once, each output
row written once).  The kernel moves each union row once into shared
memory and from there to both stacks it belongs to, with the copy
engine's bulk copies, and wraps rows mod ``size_T`` itself, so the ring
carries no ghost rows.  A trainer calls it once per update, on about
8 us of device work, so the wrapper is kept short: one output buffer
for both stacks, indices taken in the caller's integer type, every check
a plain comparison, the current stream's handle read without building a
``torch.cuda.Stream``.

Dispatch follows the tensor: CPU tensors take ``gather_frame_stacks_plain``;
CUDA tensors launch the kernel or raise.  The arguments are checked the
same way on both.  While the recorder of ``utils/profiling.py`` is on,
each launch counts in ``ops.gather_frame_stacks`` by (batch, K, F).

Build: ``nvcc -gencode arch=compute_90a,code=sm_90a -shared`` at first
use into ``rlpyt_tpu_torch/csrc/build/`` (git-ignored), loaded with ctypes.
"""
from __future__ import annotations

import ctypes
from pathlib import Path

import torch

from rlpyt_tpu_torch.ops.cuda_build import CSRC, build_library
from rlpyt_tpu_torch.utils.profiling import count

_SRC = CSRC / "frame_gather.cu"
_lib = None
MAX_U = 16    # the kernel's limit on K + n_step (kMaxU in the source)
_INDEX_DTYPES = (torch.int32, torch.int64)
_MASK_DTYPES = (torch.uint8, torch.bool)


def build() -> Path:
    """Compile the kernel (once per source); return the library's path."""
    return build_library(_SRC)


def load():
    """Build (if needed) and load the kernel library once per process."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        vp, ci = ctypes.c_void_p, ctypes.c_int
        lib.frame_gather_launch.argtypes = [vp] * 7 + [ci] * 7 + [vp]
        lib.frame_gather_launch.restype = ci
        lib.frame_gather_error_string.argtypes = [ci]
        lib.frame_gather_error_string.restype = ctypes.c_char_p
        lib.frame_gather_max_u.argtypes = []
        lib.frame_gather_max_u.restype = ci
        if lib.frame_gather_max_u() != MAX_U:
            raise RuntimeError("frame_gather.cu and ops/frame_gather.py "
                               "disagree on the largest K + n_step")
        _lib = lib
    return _lib


def gather_frame_stacks_plain(ring, start_rows, b_idx, mask_a, mask_t,
                              K: int, n_step: int):
    """Plain PyTorch version (the CPU path and the kernel's reference).

    Same contract as ``gather_frame_stacks``."""
    size_T = ring.shape[0]
    U = K + n_step
    rows = (start_rows.long()[:, None]
            + torch.arange(U, device=ring.device)) % size_T
    fr = ring[rows, b_idx.long()[:, None]]                  # [batch, U, F]
    rows_a = fr[:, :K] * mask_a.to(torch.uint8)[:, :, None]
    rows_t = fr[:, n_step:n_step + K] * mask_t.to(torch.uint8)[:, :, None]
    return rows_a, rows_t


def gather_frame_stacks(ring, start_rows, b_idx, mask_a, mask_t,
                        K: int, n_step: int):
    """Build the masked agent and target frame stacks of sampled
    transitions.

    ring:        [size_T, B, F] uint8, contiguous (newest-frame rows).
    start_rows:  [batch] int32 or int64: ring row of each sample's oldest
                 frame; rows wrap mod size_T.
    b_idx:       [batch], same type: lane of each sample, in [0, B).
    mask_a/t:    [batch, K] uint8 or bool: frame k of the agent / target
                 stack is kept where nonzero, zeroed elsewhere.
    Returns (rows_a, rows_t), each [batch, K, F] uint8: union rows
    0..K-1 and n_step..n_step+K-1.  On the card they are the two halves
    of one [2, batch, K, F] buffer.
    """
    dev = ring.device
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"frame gather: unsupported device {dev}")
    if ring.dim() != 3 or ring.dtype != torch.uint8 \
            or not ring.is_contiguous():
        raise ValueError("frame gather: ring must be a contiguous "
                         f"[size_T, B, F] uint8 tensor, got {ring.dtype} "
                         f"{tuple(ring.shape)}")
    size_T, B, F = ring.shape
    batch = start_rows.shape[0]
    idt = start_rows.dtype
    if idt not in _INDEX_DTYPES or b_idx.dtype != idt \
            or start_rows.shape != (batch,) or b_idx.shape != (batch,) \
            or start_rows.device != dev or b_idx.device != dev \
            or not start_rows.is_contiguous() or not b_idx.is_contiguous():
        raise ValueError(
            f"frame gather: start_rows and b_idx must be contiguous "
            f"[{batch}] tensors on {dev}, both int32 or both int64; got "
            f"{start_rows.dtype} {tuple(start_rows.shape)} on "
            f"{start_rows.device}, {b_idx.dtype} {tuple(b_idx.shape)} on "
            f"{b_idx.device}")
    if mask_a.shape != (batch, K) or mask_t.shape != (batch, K) \
            or mask_a.dtype not in _MASK_DTYPES \
            or mask_t.dtype not in _MASK_DTYPES \
            or mask_a.device != dev or mask_t.device != dev \
            or not mask_a.is_contiguous() or not mask_t.is_contiguous():
        raise ValueError(
            f"frame gather: mask_a and mask_t must be contiguous "
            f"[{batch}, {K}] uint8/bool tensors on {dev}; got "
            f"{mask_a.dtype} {tuple(mask_a.shape)} on {mask_a.device}, "
            f"{mask_t.dtype} {tuple(mask_t.shape)} on {mask_t.device}")
    if not (1 <= K and 0 <= n_step and K + n_step <= MAX_U):
        raise ValueError(f"frame gather: need 1 <= K and K + n_step <= "
                         f"{MAX_U} (K={K}, n={n_step})")
    if dev.type == "cpu":
        return gather_frame_stacks_plain(ring, start_rows, b_idx, mask_a,
                                         mask_t, K, n_step)
    rows_a, rows_t = torch.empty((2, batch, K, F), dtype=torch.uint8,
                                 device=dev).unbind(0)
    if batch == 0:   # a data-parallel rank that holds no drawn row
        return rows_a, rows_t
    lib = _lib or load()
    err = lib.frame_gather_launch(
        ring.data_ptr(), start_rows.data_ptr(), b_idx.data_ptr(),
        mask_a.data_ptr(), mask_t.data_ptr(), rows_a.data_ptr(),
        rows_t.data_ptr(), size_T, B, F, K, n_step, batch,
        idt == torch.int64, torch._C._cuda_getCurrentRawStream(dev.index))
    if err != 0:
        raise RuntimeError("frame gather launch failed: "
                           + lib.frame_gather_error_string(err).decode())
    count("ops.gather_frame_stacks", (batch, K, F))
    return rows_a, rows_t
