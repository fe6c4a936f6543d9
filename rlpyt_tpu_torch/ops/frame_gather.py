"""Masked frame-stack window gather: wrapper, plain version and loader
for the CUDA kernel ``rlpyt_tpu_torch/csrc/frame_gather.cu``.

The kernel ports the TPU Pallas kernels
``rlpyt_tpu/ops/pallas/frame_gather.py:111 gather_frame_stacks`` (K1) and
``rlpyt_tpu/ops/pallas/window_gather.py:79 gather_stacks_window`` (K2),
which compute one function on two ring layouts.  It is bound by HBM
bytes: ``batch * (U + 2K) * F`` (each union row read once, each output
row written once).  The kernel reads each union row once and writes it
to both stacks it belongs to, and wraps rows mod ``size_T`` itself, so
the ring carries no ghost rows.

Dispatch follows the tensor: CPU tensors take ``gather_frame_stacks_plain``;
CUDA tensors launch the kernel or raise.

Build: ``nvcc -gencode arch=compute_90a,code=sm_90a -shared`` at first
use into ``rlpyt_tpu_torch/csrc/build/`` (git-ignored), loaded with ctypes.
"""
from __future__ import annotations

import ctypes
from pathlib import Path

import torch

from rlpyt_tpu_torch.ops.cuda_build import CSRC, build_library

_SRC = CSRC / "frame_gather.cu"
_lib = None


def build() -> Path:
    """Compile the kernel (once per source); return the library's path."""
    return build_library(_SRC)


def load():
    """Build (if needed) and load the kernel library once per process."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        vp, ci = ctypes.c_void_p, ctypes.c_int
        lib.frame_gather_launch.argtypes = [vp] * 7 + [ci] * 6 + [vp]
        lib.frame_gather_launch.restype = ci
        lib.frame_gather_error_string.argtypes = [ci]
        lib.frame_gather_error_string.restype = ctypes.c_char_p
        lib.frame_gather_max_u.argtypes = []
        lib.frame_gather_max_u.restype = ci
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
    start_rows:  [batch] int32: ring row of each sample's oldest frame;
                 rows wrap mod size_T.
    b_idx:       [batch] int32 lane of each sample, in [0, B).
    mask_a/t:    [batch, K] uint8 or bool: frame k of the agent / target
                 stack is kept where nonzero, zeroed elsewhere.
    Returns (rows_a, rows_t), each [batch, K, F] uint8: union rows
    0..K-1 and n_step..n_step+K-1.
    """
    if ring.device.type == "cpu":
        return gather_frame_stacks_plain(ring, start_rows, b_idx, mask_a,
                                         mask_t, K, n_step)
    if ring.device.type != "cuda":
        raise ValueError(f"frame gather: unsupported device {ring.device}")
    batch = start_rows.shape[0]
    if ring.dim() != 3 or ring.dtype != torch.uint8 \
            or not ring.is_contiguous():
        raise ValueError("frame gather: ring must be a contiguous "
                         f"[size_T, B, F] uint8 tensor, got {ring.dtype} "
                         f"{tuple(ring.shape)}")
    for name, x in (("start_rows", start_rows), ("b_idx", b_idx)):
        if x.shape != (batch,) or x.dtype != torch.int32 \
                or x.device != ring.device or not x.is_contiguous():
            raise ValueError(f"frame gather: {name} must be a contiguous "
                             f"[{batch}] int32 tensor on {ring.device}")
    for name, x in (("mask_a", mask_a), ("mask_t", mask_t)):
        if x.shape != (batch, K) or x.dtype not in (torch.uint8, torch.bool) \
                or x.device != ring.device or not x.is_contiguous():
            raise ValueError(f"frame gather: {name} must be a contiguous "
                             f"[{batch}, {K}] uint8/bool tensor on "
                             f"{ring.device}")
    lib = load()
    if not (1 <= K and 0 <= n_step and K + n_step <= lib.frame_gather_max_u()):
        raise ValueError(f"frame gather: need 1 <= K and K + n_step <= "
                         f"{lib.frame_gather_max_u()} (K={K}, n={n_step})")
    size_T, B, F = ring.shape
    rows_a = torch.empty((batch, K, F), dtype=torch.uint8, device=ring.device)
    rows_t = torch.empty_like(rows_a)
    stream = torch.cuda.current_stream(ring.device).cuda_stream
    err = lib.frame_gather_launch(
        ring.data_ptr(), start_rows.data_ptr(), b_idx.data_ptr(),
        mask_a.data_ptr(), mask_t.data_ptr(), rows_a.data_ptr(),
        rows_t.data_ptr(), size_T, B, F, K, n_step, batch, stream)
    if err != 0:
        raise RuntimeError("frame gather launch failed: "
                           + lib.frame_gather_error_string(err).decode())
    gather_frame_stacks.launches += 1
    return rows_a, rows_t


gather_frame_stacks.launches = 0   # kernel launches, for chip_smoke.py
