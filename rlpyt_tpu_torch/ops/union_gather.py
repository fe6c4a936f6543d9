"""Unmasked union-window gathers: wrappers, plain versions and loader for
the CUDA kernels of ``rlpyt_tpu_torch/csrc/union_gather.cu``.

They port the two TPU Pallas kernels of the gather-formulations harness,
``bench_gather_formulations.py:106 pallas_row`` (K5) and ``:138
pallas_window`` (K6).  Both return the [batch, U, F] uint8 union of U
consecutive ring rows per sample, unmasked:

- ``gather_union_rows`` (K5) reads a time-major ring [size_T, B, F]; row
  p of sample i is ring row ``(start[i] + p) % size_T`` of lane
  ``b_idx[i]``, each row addressed on its own;
- ``gather_union_window`` (K6) reads a lane-major ring
  [B, size_T + U - 1, F] built by ``lane_major_ring``, whose last U - 1
  rows mirror rows [0, U - 1): sample i is the U*F contiguous bytes at
  ``ring_lm[b_idx[i], start[i]]``.

Both are bound by HBM bytes, ``2 * batch * U * F``.  The replay buffers
do not call them (sampling goes through the masked kernel of
ops/frame_gather.py); ``bench_torch_gather_formulations.py`` times the
three side by side.

Dispatch follows the tensor: CPU tensors take the plain versions; CUDA
tensors launch the kernel or raise.  While the recorder of
``utils/profiling.py`` is on, each launch counts in
``ops.gather_union_rows`` or ``ops.gather_union_window`` by (batch, U,
F).
"""
from __future__ import annotations

import ctypes
from pathlib import Path

import torch

from rlpyt_tpu_torch.ops.cuda_build import CSRC, build_library
from rlpyt_tpu_torch.utils.profiling import count

_SRC = CSRC / "union_gather.cu"
_lib = None


def build() -> Path:
    """Compile the kernels (once per source); return the library's path."""
    return build_library(_SRC)


def load():
    """Build (if needed) and load the kernel library once per process."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        vp, ci = ctypes.c_void_p, ctypes.c_int
        lib.union_rows_launch.argtypes = [vp] * 4 + [ci] * 5 + [vp]
        lib.union_rows_launch.restype = ci
        lib.union_window_launch.argtypes = [vp] * 4 + [ci] * 4 + [vp]
        lib.union_window_launch.restype = ci
        lib.union_gather_error_string.argtypes = [ci]
        lib.union_gather_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def lane_major_ring(ring: torch.Tensor, U: int) -> torch.Tensor:
    """[size_T, B, F] time-major ring -> [B, size_T + U - 1, F] lane-major
    ring with U - 1 ghost rows (copies of rows [0, U - 1)), so that every
    union window of U rows is contiguous.  A layout change, not a kernel."""
    if not 1 <= U <= ring.shape[0] + 1:
        raise ValueError(f"lane_major_ring: need 1 <= U <= size_T + 1 "
                         f"(U={U}, size_T={ring.shape[0]})")
    x = ring.transpose(0, 1)
    return torch.cat([x, x[:, :U - 1]], dim=1).contiguous()


def gather_union_rows_plain(ring, start, b_idx, U: int):
    """Plain PyTorch version of ``gather_union_rows`` (the CPU path and
    the kernel's reference)."""
    rows = (start.long()[:, None]
            + torch.arange(U, device=ring.device)) % ring.shape[0]
    return ring[rows, b_idx.long()[:, None]]


def gather_union_window_plain(ring_lm, start, b_idx, U: int):
    """Plain PyTorch version of ``gather_union_window``."""
    size_T = ring_lm.shape[1] - (U - 1)
    rows = (start.long() % size_T)[:, None] \
        + torch.arange(U, device=ring_lm.device)
    return ring_lm[b_idx.long()[:, None], rows]


def _check(name, ring, start, b_idx, U):
    if ring.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {ring.device}")
    if ring.dim() != 3 or ring.dtype != torch.uint8 \
            or not ring.is_contiguous():
        raise ValueError(f"{name}: ring must be a contiguous 3-D uint8 "
                         f"tensor, got {ring.dtype} {tuple(ring.shape)}")
    batch = start.shape[0]
    for what, x in (("start", start), ("b_idx", b_idx)):
        if x.shape != (batch,) or x.dtype != torch.int32 \
                or x.device != ring.device or not x.is_contiguous():
            raise ValueError(f"{name}: {what} must be a contiguous "
                             f"[{batch}] int32 tensor on {ring.device}")
    if U < 1:
        raise ValueError(f"{name}: need U >= 1 (U={U})")
    return batch


def _launched(name, err):
    if err != 0:
        raise RuntimeError(f"{name} launch failed: "
                           + load().union_gather_error_string(err).decode())


def gather_union_rows(ring, start, b_idx, U: int):
    """K5: the union of U consecutive ring rows per sample.

    ring:   [size_T, B, F] uint8, contiguous (time-major).
    start:  [batch] int32 ring row of each sample's first row; rows wrap
            mod size_T.
    b_idx:  [batch] int32 lane of each sample, in [0, B).
    Returns [batch, U, F] uint8.
    """
    if ring.device.type == "cpu":
        return gather_union_rows_plain(ring, start, b_idx, U)
    name = "union row gather"
    batch = _check(name, ring, start, b_idx, U)
    size_T, B, F = ring.shape
    out = torch.empty((batch, U, F), dtype=torch.uint8, device=ring.device)
    stream = torch.cuda.current_stream(ring.device).cuda_stream
    _launched(name, load().union_rows_launch(
        ring.data_ptr(), start.data_ptr(), b_idx.data_ptr(), out.data_ptr(),
        size_T, B, F, U, batch, stream))
    count("ops.gather_union_rows", (batch, U, F))
    return out


def gather_union_window(ring_lm, start, b_idx, U: int):
    """K6: the same union, read as one contiguous window per sample.

    ring_lm: [B, size_T + U - 1, F] uint8, contiguous: ``lane_major_ring``
             of the time-major ring, built for this ``U``.
    start:   [batch] int32 first row of each window, taken mod size_T.
    b_idx:   [batch] int32 lane of each sample, in [0, B).
    Returns [batch, U, F] uint8.
    """
    if ring_lm.device.type == "cpu":
        return gather_union_window_plain(ring_lm, start, b_idx, U)
    name = "union window gather"
    batch = _check(name, ring_lm, start, b_idx, U)
    B, NT, F = ring_lm.shape
    if NT < U:
        raise ValueError(f"{name}: the ring has {NT} rows per lane, fewer "
                         f"than U={U}")
    out = torch.empty((batch, U, F), dtype=torch.uint8,
                      device=ring_lm.device)
    stream = torch.cuda.current_stream(ring_lm.device).cuda_stream
    _launched(name, load().union_window_launch(
        ring_lm.data_ptr(), start.data_ptr(), b_idx.data_ptr(),
        out.data_ptr(), NT - (U - 1), F, U, batch, stream))
    count("ops.gather_union_window", (batch, U, F))
    return out
