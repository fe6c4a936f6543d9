"""Fused LSTM over [T, B, F] with per-step done reset: wrappers, plain
versions and loader for the CUDA kernels of
``rlpyt_tpu_torch/csrc/lstm.cu``, and the ``torch.autograd.Function``
that takes the place of the JAX package's ``jax.custom_vjp``
(``rlpyt_tpu/ops/pallas/lstm.py:275-309 lstm_pallas``).

The TPU kernels K3 (``_lstm_fwd_pallas``) and K4 (``_lstm_bwd_pallas``)
become four kernels here:

- ``lstm_step``: the whole forward at T = 1 (every collection and
  evaluation step) in one launch: the reset, x @ W_x + h @ W_h + b over
  the depth F + H split across a thread-block cluster, and the cell
  update (``step_plan`` sizes it);
- ``input_proj`` (K3a): ``xg = x @ W_x + b`` over all T*B rows at once,
  float32 results from the TF32 tensor cores (wgmma) by a hi/lo split of
  both operands (three products for each tile);
- ``lstm_fwd`` (K3): the T-step recurrence over ``xg`` with ``W_h``,
  emitting ``y``, the post-activation gates and ``c`` for the backward,
  and ``hT``, ``cT``;
- ``lstm_bwd`` (K4): the reverse-time recurrence emitting ``dgates``,
  ``dh0`` and ``dc0``.  ``dx``, ``dW_x``, ``dW_h`` and ``db`` are plain
  matrix products over ``dgates`` after it, as in the JAX package.

``LstmFunction`` takes ``lstm_step`` at T = 1 and K3a then K3 at T > 1;
its backward (K4) is the same for both.  ``input_proj`` and ``lstm_fwd``
keep their T = 1 and few-row shapes for direct callers.

``recurrence_plan`` sizes K3 and K4; the kernels check it.  Where W_h
fits one thread-block cluster's shared memory (H = 128 and 256), K3 at
T > 1 and K4 take the cluster path (``ClusterPlan``): each cluster runs
the whole recurrence of a slice of batch rows, h (K3) or the partial
carries (K4) going to the peers' shared memory by st.async, counted on
each receiver's mbarrier.  Otherwise (H = 512), and for K3 at T = 1, the
step-barrier kernels: CTAs of ``UNITS`` hidden units in clusters of
``CLUSTER``, a step barrier in device memory.

Gate order is i, f, g, o.  ``done[t]`` zeroes h and c before step t
(``lstm_scan``, lstm.py:43-64); the kernels take ``mask = 1 - done``.
The TPU padding (H to 128, B to 8, F to 128) is not carried over: the
kernels mask ragged edges themselves.

Dispatch follows the tensor: CPU tensors take the plain versions; CUDA
tensors launch the kernels or raise.  While the recorder of
``utils/profiling.py`` is on, each wrapper counts its launches in the
counter ``ops.<wrapper>``, keyed by path and shape: ``ops.input_proj``
by ("split" where K is split over a cluster, else "whole", M, N, K);
``ops.lstm_fwd`` and ``ops.lstm_bwd`` by ("cluster" or "barrier", T, B,
H); ``ops.lstm_step`` by (the plan's path, B, H, F).  ``LstmFunction``
opens the spans ``ops.lstm_step``, ``ops.input_proj`` and ``ops.lstm_fwd``
around its forward's calls and ``ops.lstm_bwd`` around its backward.
"""
from __future__ import annotations

import ctypes
import functools
from dataclasses import dataclass
from pathlib import Path
from typing import NamedTuple

import torch

from rlpyt_tpu_torch.ops.cuda_build import CSRC, build_library
from rlpyt_tpu_torch.utils.profiling import count, span, spanned

_SRC = CSRC / "lstm.cu"
_lib = None


def build() -> Path:
    """Compile the kernels (once per source); return the library's path.
    ``-Xptxas=-v`` puts each kernel's registers and spills in the log."""
    return build_library(_SRC, ("-Xptxas=-v",))


def load():
    """Build (if needed) and load the kernel library once per process."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        vp, ci = ctypes.c_void_p, ctypes.c_int
        lib.lstm_proj_launch.argtypes = [vp] * 4 + [ci] * 7 + [vp]
        lib.lstm_fwd_launch.argtypes = [vp] * 11 + [ci] * 5 + [vp]
        lib.lstm_bwd_launch.argtypes = [vp] * 12 + [ci] * 4 + [vp]
        lib.lstm_fwd_cluster_launch.argtypes = [vp] * 10 + [ci] * 6 + [vp]
        lib.lstm_bwd_cluster_launch.argtypes = [vp] * 10 + [ci] * 6 + [vp]
        lib.lstm_cluster_capacity.argtypes = [ci, ci, ctypes.c_longlong]
        for fn in (lib.lstm_proj_launch, lib.lstm_fwd_launch,
                   lib.lstm_bwd_launch, lib.lstm_fwd_cluster_launch,
                   lib.lstm_bwd_cluster_launch, lib.lstm_cluster_capacity):
            fn.restype = ci
        lib.lstm_error_string.argtypes = [ci]
        lib.lstm_error_string.restype = ctypes.c_char_p
        for fn in (lib.lstm_proj_k_step, lib.lstm_proj_shape_count,
                   lib.lstm_rec_units, lib.lstm_rec_cluster):
            fn.argtypes, fn.restype = [], ci
        lib.lstm_tile_lanes.argtypes, lib.lstm_tile_lanes.restype = [ci], ci
        lib.lstm_proj_shape.argtypes = [ci] + [ctypes.POINTER(ci)] * 3
        lib.lstm_proj_shape.restype = None
        shapes = set()
        for i in range(lib.lstm_proj_shape_count()):
            tm, tn, sp = ci(), ci(), ci()
            lib.lstm_proj_shape(i, tm, tn, sp)
            shapes.add((tm.value, tn.value, sp.value))
        if (lib.lstm_proj_k_step(), lib.lstm_rec_units(),
                lib.lstm_rec_cluster()) != (PROJ_K_STEP, UNITS, CLUSTER) \
                or shapes != PROJ_SHAPES \
                or any(lib.lstm_tile_lanes(n) != tile_lanes(n)
                       for n in range(1, 130)):
            raise RuntimeError("lstm.cu and ops/lstm.py disagree on the "
                               "projection's shapes or K step or the "
                               "recurrences' CTA shape or tile lanes")
        lib.lstm_fwd_smem.argtypes = [ci] * 3
        lib.lstm_bwd_smem.argtypes = [ci] * 2
        lib.lstm_fwd_cluster_smem.argtypes = [ci] * 3
        lib.lstm_bwd_cluster_smem.argtypes = [ci] * 4
        for fn in (lib.lstm_fwd_smem, lib.lstm_bwd_smem,
                   lib.lstm_fwd_cluster_smem, lib.lstm_bwd_cluster_smem):
            fn.restype = ctypes.c_longlong
        for B, H in ((32, 512), (37, 102), (128, 512), (5, 100)):
            plan = recurrence_plan(B, H, 132)
            if (lib.lstm_fwd_smem(B, H, plan.stage_rows),
                    lib.lstm_bwd_smem(B, H)) \
                    != (plan.fwd_smem, plan.bwd_smem):
                raise RuntimeError("lstm.cu and ops/lstm.py disagree on "
                                   "the recurrences' shared memory")
        for B, H, C, rows in ((128, 128, 8, 8), (4, 256, 16, 4),
                              (37, 102, 8, 12), (3, 100, 2, 3)):
            cp = cluster_plan(B, H, C, rows)
            if (lib.lstm_fwd_cluster_smem(H, rows, cp.units),
                    lib.lstm_bwd_cluster_smem(H, C, rows, cp.units)) \
                    != (cp.fwd_smem, cp.bwd_smem):
                raise RuntimeError("lstm.cu and ops/lstm.py disagree on "
                                   "the cluster path's shared memory")
        lib.lstm_step_launch.argtypes = [vp] * 12 + [ci] * 7 + [vp]
        lib.lstm_step_launch.restype = ci
        for fn in (lib.lstm_step_units, lib.lstm_step_depth,
                   lib.lstm_step_shape_count):
            fn.argtypes, fn.restype = [], ci
        lib.lstm_step_smem.argtypes = [ci, ci]
        lib.lstm_step_smem.restype = ctypes.c_longlong
        plans = [step_plan(B, H, F, 132) for B, H, F in (
            (4, 512, 6917), (64, 512, 6919), (8, 256, 260), (128, 128, 135),
            (3, 100, 130), (37, 102, 33))]
        if (lib.lstm_step_units(), lib.lstm_step_depth(),
                lib.lstm_step_shape_count()) \
                != (STEP_UNITS, STEP_K, len(STEP_SHAPES)) \
                or any(lib.lstm_step_smem(rows, tf32) != step_smem(rows, tf32)
                       for rows, tf32 in STEP_SHAPES) \
                or any(lib.lstm_step_smem(p.rows, p.path == "tf32")
                       != p.smem for p in plans):
            raise RuntimeError("lstm.cu and ops/lstm.py disagree on the "
                               "one-step kernel's CTA shape, built shapes "
                               "or shared memory")
        _lib = lib
    return _lib


# ---------------------------------------------------------------------
# Plain versions: the CPU path and the kernels' references on the card.
# ---------------------------------------------------------------------

def input_proj_plain(x, wx, b):
    """x [N, F] @ wx [F, 4H] + b [4H] -> [N, 4H]."""
    return x @ wx + b


def lstm_fwd_plain(xg, wh, mask, h0, c0):
    """Recurrence over xg [T, B, 4H] (input projection with bias).
    Returns (y [T, B, H], gates [T, B, 4H] post-activation, c [T, B, H],
    hT, cT)."""
    H = wh.shape[0]
    h, c = h0, c0
    ys, gs, cs = [], [], []
    for t in range(xg.shape[0]):
        m = mask[t][:, None]
        h, c = h * m, c * m
        pre = xg[t] + h @ wh
        i = torch.sigmoid(pre[:, :H])
        f = torch.sigmoid(pre[:, H:2 * H])
        g = torch.tanh(pre[:, 2 * H:3 * H])
        o = torch.sigmoid(pre[:, 3 * H:])
        c = f * c + i * g
        h = o * torch.tanh(c)
        ys.append(h)
        gs.append(torch.cat([i, f, g, o], dim=1))
        cs.append(c)
    return torch.stack(ys), torch.stack(gs), torch.stack(cs), h, c


def lstm_step_plain(x, wx, wh, b, mask, h0, c0):
    """One step of the forward at T = 1 from x [B, F] and mask [B]: the
    reset h0 * m, c0 * m, then pre = x @ wx + h @ wh + b and the cell
    update.  Returns what ``lstm_fwd_plain`` returns at T = 1: (y [1, B,
    H], gates [1, B, 4H] post-activation, c [1, B, H], hT, cT)."""
    H = wh.shape[0]
    m = mask[:, None]
    h, c = h0 * m, c0 * m
    pre = x @ wx + h @ wh + b
    i = torch.sigmoid(pre[:, :H])
    f = torch.sigmoid(pre[:, H:2 * H])
    g = torch.tanh(pre[:, 2 * H:3 * H])
    o = torch.sigmoid(pre[:, 3 * H:])
    c = f * c + i * g
    h = o * torch.tanh(c)
    return (torch.stack([h]), torch.cat([i, f, g, o], dim=1)[None],
            torch.stack([c]), h, c)


def lstm_bwd_plain(gates, cs, c0, mask, wh, dy, dcT):
    """Reverse-time recurrence (``_bwd_kernel``, lstm.py:168-211).
    ``dy`` already holds hT's cotangent in dy[T-1]; ``dcT`` seeds the dc
    carry.  Returns (dgates [T, B, 4H], dh0, dc0)."""
    T, _, H = cs.shape
    dh_c = torch.zeros_like(c0)
    dc_c = dcT
    dgates = []
    for s in range(T - 1, -1, -1):
        m = mask[s][:, None]
        cp = (c0 if s == 0 else cs[s - 1]) * m
        i, f, g, o = gates[s].split(H, dim=1)
        tc = torch.tanh(cs[s])
        dh = dy[s] + dh_c
        dct = dh * o * (1.0 - tc * tc) + dc_c
        dg = torch.cat([dct * g * i * (1.0 - i), dct * cp * f * (1.0 - f),
                        dct * i * (1.0 - g * g), dh * tc * o * (1.0 - o)],
                       dim=1)
        dgates.append(dg)
        dh_c = (dg @ wh.T) * m
        dc_c = dct * f * m
    return torch.stack(dgates[::-1]), dh_c, dc_c


# ---------------------------------------------------------------------
# Wrappers
# ---------------------------------------------------------------------

def _check(name: str, x, shape, device):
    if tuple(x.shape) != tuple(shape) or x.dtype != torch.float32 \
            or x.device != device or not x.is_contiguous():
        raise ValueError(f"lstm: {name} must be a contiguous float32 "
                         f"{list(shape)} tensor on {device}, got {x.dtype} "
                         f"{list(x.shape)} on {x.device}")


def _device(x) -> str:
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"lstm: unsupported device {x.device}")
    return x.device.type


def _raise_on(err: int, what: str):
    if err != 0:
        raise RuntimeError(f"{what} launch failed: "
                           + load().lstm_error_string(err).decode())


def _stream(device):
    return torch.cuda.current_stream(device).cuda_stream


@functools.lru_cache(maxsize=None)
def _n_sm(device) -> int:
    """The device's count of SMs, asked once for each device."""
    return torch.cuda.get_device_properties(device).multi_processor_count


PROJ_K_STEP = 32    # depth of one shared-memory stage of K3a
# Up to this depth the plan comes from PROJ_COST, fitted at K = 135-1031;
# deeper K (R2D1's 6917 and 6919) keeps the plan tuned there, but at
# M <= 64 rows, where the cost model's choice is the faster.
PROJ_MODEL_K = 2048
# K3a's shapes below PROJ_MODEL_K, (tile_m, tile_n) -> the cost in us on
# an H100 of a CTA's fixed part, of each 32-deep stage it carries and of
# a split's reduction, fitted to `bench_torch_proj_shapes.py --sweep`
# where every CTA runs at once, and the split counts built for it.
PROJ_COST = {(64, 64): (3.45, 0.75, 0.43), (128, 64): (3.45, 1.09, 0.83),
             (128, 128): (5.46, 1.48, 0.0)}
PROJ_SPLITS = {(64, 64): range(1, 9), (128, 64): (1, 2, 4),
               (128, 128): (1, 2)}
# K3a's tensor-core shapes, (tile_m, tile_n, splits): tiles of tile_m rows
# (64 for each consumer warpgroup) by tile_n columns, K over a cluster of
# ``splits`` CTAs.  lstm.cu builds exactly these.
PROJ_SHAPES = frozenset(
    {(192, 128, 1), (128, 128, 1), (64, 128, 8)}
    | {tile + (s,) for tile, splits in PROJ_SPLITS.items() for s in splits})


class ProjPlan(NamedTuple):
    """How K3a runs x [M, K] @ wx [K, N]: tiles of ``tile_m`` rows by
    ``tile_n`` columns (``tile_m`` 0: the generic kernel), K split over
    ``splits`` CTAs of a cluster, split z taking rows [z * k_chunk,
    (z + 1) * k_chunk) of W_x."""
    tile_m: int
    tile_n: int
    k_chunk: int
    splits: int


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


@functools.lru_cache(maxsize=None)
def proj_plan(M: int, N: int, K: int, n_sm: int) -> ProjPlan:
    """Which of K3a's shapes takes x [M, K] @ wx [K, N] on a card of
    ``n_sm`` SMs.

    - N not a multiple of 4: the generic kernel, (0, 128, K, 1).
    - K up to PROJ_MODEL_K (the MinAtar and MuJoCo LSTMs, K = 135-1031):
      the shape of PROJ_COST and split count of PROJ_SPLITS that the cost
      model gives the least time: waves x (fixed + stages x a stage's
      cost) + a split's reduction.  A split takes ceil(stages / splits)
      stages, and a count that would leave a split empty is not taken.
      Clusters of three CTAs or more may not all fit in the GPCs at once,
      so their wave is three quarters of the SMs.  One split at M = 2048
      and N = 512; the most splits at M <= 64, where few tiles must share
      the depth.
    - Deeper K (R2D1's K = 6919) at M <= 64 (collection and evaluation
      steps): the cost model too.
    - Deeper K at more rows: 128-column tiles.  128-row tiles that would
      leave more than half of the SMs without one: 64-row tiles, K over a
      cluster of 8.  Otherwise no split: tiles of 192 or 128 rows,
      whichever takes fewer rows of tiles per SM (the 132 SMs take 1440
      rows as one wave of 192-row tiles, 640 as one of 128-row tiles).
    """
    if N % 4 != 0:
        return ProjPlan(0, 128, K, 1)
    stages = _cdiv(K, PROJ_K_STEP)
    if K > PROJ_MODEL_K and M > 64:
        cols = _cdiv(N, 128)
        if 2 * _cdiv(M, 128) * cols <= n_sm:
            return ProjPlan(64, 128, _cdiv(stages, 8) * PROJ_K_STEP, 8)
        tile_m = min((192, 128),
                     key=lambda bm: _cdiv(_cdiv(M, bm) * cols, n_sm) * bm)
        return ProjPlan(tile_m, 128, stages * PROJ_K_STEP, 1)

    def cost(plan):
        fixed, stage, split = PROJ_COST[plan.tile_m, plan.tile_n]
        ctas = _cdiv(M, plan.tile_m) * _cdiv(N, plan.tile_n) * plan.splits
        wave = n_sm if plan.splits <= 2 else n_sm * 3 // 4
        chunk = plan.k_chunk // PROJ_K_STEP
        return (_cdiv(ctas, wave) * (fixed + chunk * stage)
                + (plan.splits > 1) * split)

    plans = [ProjPlan(bm, bn, _cdiv(stages, s) * PROJ_K_STEP, s)
             for (bm, bn), splits in PROJ_SPLITS.items() for s in splits
             if _cdiv(stages, _cdiv(stages, s)) == s]
    return min(plans, key=cost)


def input_proj(x, wx, b):
    """K3a: x [N, F] @ wx [F, 4H] + b [4H] -> [N, 4H], float32."""
    if _device(x) == "cpu":
        return input_proj_plain(x, wx, b)
    M, K = x.shape
    N = wx.shape[1]
    for name, t, shape in (("x", x, (M, K)), ("wx", wx, (K, N)),
                           ("b", b, (N,))):
        _check(name, t, shape, x.device)
    if M == 0:   # a data-parallel rank that holds no drawn row
        return torch.empty((0, N), dtype=torch.float32, device=x.device)
    lib = load()
    plan = proj_plan(M, N, K, _n_sm(x.device))
    if wx.data_ptr() % 16 != 0 or b.data_ptr() % 16 != 0:
        plan = ProjPlan(0, 128, K, 1)    # a view into another tensor
    out = torch.empty((M, N), dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):
        err = lib.lstm_proj_launch(
            x.data_ptr(), wx.data_ptr(), b.data_ptr(), out.data_ptr(), M, N,
            K, *plan, _stream(x.device))
    _raise_on(err, "lstm input projection")
    count("ops.input_proj", ("split" if plan.splits > 1 else "whole", M, N,
                             K))
    return out


SMEM_MAX = 232448 - 1024   # dynamic shared memory of a recurrence CTA
ROW_BLOCK = 32      # batch rows of one warp's tile in K3 / K4
REC_WARPS = 8       # warps of a recurrence CTA
REC_THREADS = 32 * REC_WARPS
UNITS = 4           # hidden units of a recurrence CTA
# CTAs of a recurrence's thread-block cluster: 64 clusters of 2 one-SM
# CTAs are all resident on an H100, 32 clusters of 4 are not.
CLUSTER = 2
# The cluster path (W_h in one cluster's shared memory): its cluster
# sizes.
CLUSTER_SIZES = (2, 4, 8, 16)
MAX_SPLITS = 16     # lanes that split one tile's depth on the cluster path
STAGES = 3          # steps of inputs a cluster-path cell lane stages


def _stride(n: int) -> int:
    """Row stride in floats of a shared-memory tile n wide: n rounded up
    to 4, and an odd number of 16-byte units (``lstm.cu:h_stride``)."""
    hp = -(-n // 4) * 4
    return hp if (hp // 4) % 2 else hp + 4


def tile_lanes(tiles: int) -> int:
    """Lanes that split the depth of one cluster-path tile of 4 rows x 4
    outputs (``lstm.cu:tile_lanes``), for ``tiles`` tiles: the most, a
    power of two from 4 up to MAX_SPLITS, with which a CTA's threads hold
    every tile at once (4 where they cannot: the tiles go in passes)."""
    ks = 4
    while 2 * ks * tiles <= REC_THREADS and 2 * ks <= MAX_SPLITS:
        ks *= 2
    return ks


@dataclass(frozen=True)
class ClusterPlan:
    """K3 (T > 1) and K4 for a W_h that fits one thread-block cluster:
    ``clusters`` clusters of ``cluster`` CTAs; cluster c takes batch rows
    [c * rows, c * rows + rows) and all H units of them, CTA r of it units
    [r * units, r * units + units) (a multiple of 4) with their W_h
    columns, one (row, unit) cell a thread.  K3's tiles (4 rows x a
    unit's 4 gates) and K4's (4 rows x 4 units) split their depth over
    ``fwd_splits`` and ``bwd_splits`` lanes.  Dynamic shared memory in
    bytes."""
    cluster: int
    rows: int
    units: int
    clusters: int
    fwd_splits: int
    bwd_splits: int
    fwd_smem: int
    bwd_smem: int


def cluster_plan(B: int, H: int, C: int, rows: int):
    """The cluster path with C CTAs a cluster and ``rows`` rows a cluster,
    or None where it does not fit.  Shared memory (floats, U = units, Q =
    4U, hk = H rounded up to 4, rows4 = rows rounded up to 4, stride(n)
    = n rounded up to an odd number of 4-float units, 256 threads): K3
    the W_h slice [hk][stride(Q)], h twice [rows4][stride(H)] and each
    thread's xg and mask of 3 steps [3][256][5]; K4 the W_h slice
    transposed [Q][stride(hk)], its dgates [rows4][stride(Q)], the C
    peers' partial carries twice [rows][U] and each thread's inputs of 3
    steps [3][256][12] (gates, c, c before, dy, the masks)."""
    units = -(-(-(-H // C)) // 4) * 4
    rows4 = -(-rows // 4) * 4
    hk = -(-H // 4) * 4
    q = 4 * units
    if not 1 <= rows or rows4 * units > REC_THREADS:
        return None
    fwd = 4 * (hk * _stride(q) + 2 * rows4 * _stride(H)
               + STAGES * REC_THREADS * 5)
    bwd = 4 * (q * _stride(hk) + rows4 * _stride(q) + 2 * C * rows * units
               + STAGES * REC_THREADS * 12)
    if max(fwd, bwd) > SMEM_MAX:
        return None
    return ClusterPlan(cluster=C, rows=rows, units=units,
                       clusters=-(-B // rows),
                       fwd_splits=tile_lanes(rows4 // 4 * units),
                       bwd_splits=tile_lanes(rows4 // 4 * (hk // 4)),
                       fwd_smem=fwd, bwd_smem=bwd)


@dataclass(frozen=True)
class RecurrencePlan:
    """How K3 and K4 run for one (B, H).  ``clustered``: the cluster path
    (K3 at T > 1 and K4), where W_h fits one cluster; None at H = 512.
    Otherwise, and for K3 at T = 1, the step-barrier kernels: ``ctas`` CTAs of
    ``UNITS`` hidden units each (CTA j owns units [UNITS * j, UNITS * j +
    UNITS) and their four gates; CTAs past H only take part in the
    barriers), in thread-block clusters of ``CLUSTER`` CTAs, which share
    K3's staged h and K4's dgates; K3 stages ``stage_rows`` rows of h at a
    time.  Dynamic shared memory in bytes."""
    ctas: int
    stage_rows: int
    fwd_smem: int
    bwd_smem: int
    clustered: ClusterPlan | None = None


def _cluster_choice(B: int, H: int, n_sm: int):
    """The cluster path's shape for (B, H) on ``n_sm`` SMs, or None where
    W_h fits no cluster, as bench_torch_lstm_steps.py --sweep timed it
    fastest on an H100: CTAs of about 16 units (the smallest cluster of
    CLUSTER_SIZES with C * 16 >= H: 8 at H = 128, 16 at H = 256); rows a
    cluster the fewest from 4 (2 in clusters of 16, whose CTAs each send
    to 15 peers) that keep every cluster on SMs of its own, n_sm // C - 1
    clusters (the card holds 15 clusters of 8 and 7 of 16 at one CTA an
    SM), and at most B."""
    C = next((c for c in CLUSTER_SIZES if 16 * c >= H), CLUSTER_SIZES[-1])
    fit = n_sm // C - 1
    rows = 2 if C == 16 else 4
    while -(-B // rows) > fit:
        rows = rows + 4 if rows >= 4 else 4
    return cluster_plan(B, H, C, min(rows, B))


@functools.lru_cache(maxsize=None)
def recurrence_plan(B: int, H: int, n_sm: int) -> RecurrencePlan:
    """The recurrences' plan on a card of ``n_sm`` SMs.  The step-barrier
    kernels' part:
    ceil(H / UNITS) CTAs rounded up to whole clusters (128 at H = 512),
    one per SM, so at most ``n_sm``.  Shared memory (floats, U = UNITS, C
    = CLUSTER, H4 = H rounded up to 4): K3 the W_h slice [H4][4U], staged
    h [stage_rows][H4 (+ 4)], the warps' partial tiles [8][32][4U + 4] and
    c [B][U]; K4 the cluster's W_h block [~H4 / C][4UC], the cluster's
    dgates [B][4UC], its own [B][4U], dc [B][U] and the warps' partial
    carries [8][32][U].  ``stage_rows``: all of B rounded up to 32 where
    it fits, else the most multiples of 32 that do.  The cluster path
    where W_h fits one cluster (``_cluster_choice``)."""
    q = 4 * UNITS
    hp = -(-H // 4) * 4
    hs = _stride(H)
    fixed = 4 * (hp * q + REC_WARPS * ROW_BLOCK * (q + 4) + B * UNITS)
    rows = -(-B // ROW_BLOCK) * ROW_BLOCK
    stage_rows = min(rows, (SMEM_MAX - fixed) // (4 * hs)
                     // ROW_BLOCK * ROW_BLOCK)
    kw = 64 // (q * CLUSTER)          # k rows of a K4 thread's partial
    k_rows = -(-(hp // kw) // CLUSTER) * kw
    bwd_smem = 4 * ((k_rows + B) * q * CLUSTER + B * q + B * UNITS
                    + REC_WARPS * ROW_BLOCK * UNITS)
    if stage_rows < ROW_BLOCK or bwd_smem > SMEM_MAX:
        raise ValueError(f"lstm: B={B}, H={H} exceed the recurrences' "
                         f"shared memory ({SMEM_MAX} bytes)")
    ctas = -(-H // (UNITS * CLUSTER)) * CLUSTER
    if ctas > n_sm:
        raise ValueError(f"lstm: H={H} needs {ctas} CTAs of {UNITS} units, "
                         f"more than the {n_sm} SMs that can hold them at "
                         "once")
    return RecurrencePlan(ctas=ctas, stage_rows=stage_rows,
                          fwd_smem=fixed + 4 * stage_rows * hs,
                          bwd_smem=bwd_smem,
                          clustered=_cluster_choice(B, H, n_sm))


def lstm_fwd(xg, wh, mask, h0, c0):
    """K3: the recurrence; same contract as ``lstm_fwd_plain``."""
    if _device(xg) == "cpu":
        return lstm_fwd_plain(xg, wh, mask, h0, c0)
    T, B, H4 = xg.shape
    H = H4 // 4
    dev = xg.device
    for name, t, shape in (("xg", xg, (T, B, 4 * H)), ("wh", wh, (H, 4 * H)),
                           ("mask", mask, (T, B)), ("h0", h0, (B, H)),
                           ("c0", c0, (B, H))):
        _check(name, t, shape, dev)
    if B == 0:   # a data-parallel rank that holds no drawn row
        y = torch.empty((T, 0, H), dtype=torch.float32, device=dev)
        return (y, torch.empty((T, 0, 4 * H), dtype=torch.float32,
                               device=dev), y.clone(), h0.clone(),
                c0.clone())
    plan = recurrence_plan(B, H, _n_sm(dev))
    cp = plan.clustered if T > 1 else None
    y = torch.empty((T, B, H), dtype=torch.float32, device=dev)
    cs = torch.empty_like(y)
    gates = torch.empty((T, B, 4 * H), dtype=torch.float32, device=dev)
    hT = torch.empty((B, H), dtype=torch.float32, device=dev)
    cT = torch.empty_like(hT)
    ptrs = (xg.data_ptr(), wh.data_ptr(), mask.data_ptr(), h0.data_ptr(),
            c0.data_ptr(), y.data_ptr(), gates.data_ptr(), cs.data_ptr(),
            hT.data_ptr(), cT.data_ptr())
    with torch.cuda.device(dev):
        if cp is not None:
            err = load().lstm_fwd_cluster_launch(
                *ptrs, T, B, H, cp.cluster, cp.rows, cp.units, _stream(dev))
        else:
            # The step barrier's counter, zeroed on the stream (none at
            # T = 1).
            counter = torch.zeros(1, dtype=torch.int32, device=dev) \
                if T > 1 else None
            err = load().lstm_fwd_launch(
                *ptrs, None if counter is None else counter.data_ptr(), T,
                B, H, plan.ctas, plan.stage_rows, _stream(dev))
    _raise_on(err, "lstm forward")
    count("ops.lstm_fwd", ("barrier" if cp is None else "cluster", T, B, H))
    return y, gates, cs, hT, cT


def lstm_bwd(gates, cs, c0, mask, wh, dy, dcT):
    """K4: the reverse recurrence; same contract as ``lstm_bwd_plain``."""
    if _device(gates) == "cpu":
        return lstm_bwd_plain(gates, cs, c0, mask, wh, dy, dcT)
    T, B, H = cs.shape
    dev = gates.device
    for name, t, shape in (("gates", gates, (T, B, 4 * H)),
                           ("cs", cs, (T, B, H)), ("c0", c0, (B, H)),
                           ("mask", mask, (T, B)), ("wh", wh, (H, 4 * H)),
                           ("dy", dy, (T, B, H)), ("dcT", dcT, (B, H))):
        _check(name, t, shape, dev)
    if B == 0:   # a data-parallel rank that holds no drawn row
        return torch.empty_like(gates), dcT.clone(), dcT.clone()
    plan = recurrence_plan(B, H, _n_sm(dev))
    cp = plan.clustered
    dgates = torch.empty((T, B, 4 * H), dtype=torch.float32, device=dev)
    dh0 = torch.empty((B, H), dtype=torch.float32, device=dev)
    dc0 = torch.empty_like(dh0)
    ptrs = (gates.data_ptr(), cs.data_ptr(), c0.data_ptr(), mask.data_ptr(),
            wh.data_ptr(), dy.data_ptr(), dcT.data_ptr(), dgates.data_ptr(),
            dh0.data_ptr(), dc0.data_ptr())
    with torch.cuda.device(dev):
        if cp is not None:
            err = load().lstm_bwd_cluster_launch(
                *ptrs, T, B, H, cp.cluster, cp.rows, cp.units, _stream(dev))
        else:
            # Each cluster's partial carry [B, H rounded up to 4], two
            # steps', and the step barrier's counter.
            part = torch.empty((2, plan.ctas // CLUSTER, B, -(-H // 4) * 4),
                               dtype=torch.float32, device=dev)
            counter = torch.zeros(1, dtype=torch.int32, device=dev)
            err = load().lstm_bwd_launch(
                *ptrs, part.data_ptr(), counter.data_ptr(), T, B, H,
                plan.ctas, _stream(dev))
    _raise_on(err, "lstm backward")
    count("ops.lstm_bwd", ("barrier" if cp is None else "cluster", T, B, H))
    return dgates, dh0, dc0


STEP_UNITS = 8       # hidden units of a one-step CTA (its 32 gate columns)
STEP_K = 128         # depth of one of its ring stages
STEP_X_STRIDE = STEP_K + 4      # floats of a staged x / h0 row
STEP_BUDGET = 210 * 1024        # ring bytes
STEP_MAX_SPLITS = 8             # CTAs of a cluster that split the depth
# The one-step kernel's shapes, (rows a CTA, TF32 path): lstm.cu builds
# exactly these.
STEP_SHAPES = frozenset({(8, False), (16, False), (32, False), (32, True),
                         (64, True)})
FP32_OPS_PER_S = 67e12    # an H100 SXM's fp32 pipes (data sheet)
HBM_BYTES_PER_S = 3.35e12   # its device memory
# The share of FP32_OPS_PER_S that the FFMA path reaches, by which the
# plan weighs its operations against the bytes.
STEP_FFMA_SHARE = 0.5
STEP_SHALLOW = 3     # stages up to which the plan splits no depth


def step_smem(rows: int, tf32: bool) -> int:
    """Dynamic shared memory in bytes of the one-step shape (``lstm.cu:
    step_smem``): a ring of stages, each four gate tiles [STEP_K]
    [STEP_UNITS] of W and [rows][STEP_X_STRIDE] of x, as many as
    STEP_BUDGET holds (at most 8), or the warp groups' partials and their
    sum where they take more; and 128 bytes to align the ring."""
    stage = 4 * STEP_K * STEP_UNITS + rows * STEP_X_STRIDE
    stages = min(8, STEP_BUDGET // (4 * stage))
    groups = 256 // rows if tf32 else REC_WARPS
    tail = (groups + (groups > 1)) * rows * 4 * STEP_UNITS
    return 4 * max(stages * stage, tail) + 128


def step_stage_count(H: int, F: int) -> int:
    """Stages of the one-step kernel's depth: ceil(F / STEP_K) of x @ W_x
    (the last zero past F), then ceil(H / STEP_K) of h @ W_h."""
    return _cdiv(F, STEP_K) + _cdiv(H, STEP_K)


class StepPlan(NamedTuple):
    """How the one-step kernel runs (B, H, F): CTAs of ``units`` hidden
    units (their 4 x ``units`` gate columns) by ``rows`` batch rows,
    ``row_tiles`` of them; the ``step_stage_count`` stages of the depth
    split over a cluster of ``splits`` CTAs, split z taking stages
    [z * split_stages, (z + 1) * split_stages); ``path`` "ffma" (the fp32
    pipes) or "tf32" (three TF32 products on mma.sync); ``ctas`` in all;
    dynamic shared memory in bytes."""
    units: int
    rows: int
    row_tiles: int
    splits: int
    split_stages: int
    path: str
    ctas: int
    smem: int


def step_costs(B: int, H: int, F: int) -> tuple:
    """(operations, bytes) of one one-step call: 2 B (F + H) 4H for the
    contraction and ~10 a cell; x, [W_x; W_h], b, mask, h0, c0 read once,
    y, gates, c, hT, cT written once."""
    K = F + H
    ops = 2 * B * K * 4 * H + 10 * B * H
    nbytes = 4 * (B * F + K * 4 * H + 4 * H + B + 2 * B * H
                  + B * (H + 4 * H + H) + 2 * B * H)
    return ops, nbytes


@functools.lru_cache(maxsize=None)
def step_plan(B: int, H: int, F: int, n_sm: int) -> StepPlan:
    """The one-step kernel's plan for x [B, F] and H units on ``n_sm``
    SMs, as bench_torch_lstm_step.py --sweep timed fastest on an H100.

    - A shallow depth (at most STEP_SHALLOW stages: the MinAtar PG LSTM's
      F = 135): FFMA, no split, in the fewest rows of 8, 16, 32 whose row
      tiles keep the grid within the SMs (a split's cluster barrier and
      reduction cost more than its stage).
    - Else the path: three TF32 products where B > 16 and the
      contraction's fp32 operations, at STEP_FFMA_SHARE of the fp32
      pipes' rate, take longer than the call's bytes at HBM's; FFMA
      otherwise.  Rows a CTA: FFMA the fewest of 8, 16, 32 that hold B (32
      above); TF32 64 above 32 rows, else 32.  Splits: the most, up to
      STEP_MAX_SPLITS, with every split holding a stage, that keep the
      grid (ceil(H / units) x row tiles x splits) to one wave: the SMs for
      clusters of 1-2, three quarters of them for larger clusters, which
      may not all fit the GPCs at once; the stages shared out evenly.
    Covers every B >= 1, H >= 1 and F >= 0 of up to 65535 row tiles;
    raises ValueError otherwise."""
    if B < 1 or H < 1 or F < 0:
        raise ValueError(f"lstm step: B={B}, H={H}, F={F} (B and H must "
                         "be at least 1, F at least 0)")
    groups = _cdiv(H, STEP_UNITS)
    n = step_stage_count(H, F)
    ops, nbytes = step_costs(B, H, F)
    shallow = n <= STEP_SHALLOW
    tf32 = not shallow and B > 16 and \
        ops / (STEP_FFMA_SHARE * FP32_OPS_PER_S) > nbytes / HBM_BYTES_PER_S
    if shallow:
        rows = next((r for r in (8, 16, 32)
                     if groups * _cdiv(B, r) <= n_sm), 32)
    elif tf32:
        rows = 64 if B > 32 else 32
    else:
        rows = next((r for r in (8, 16, 32) if r >= B), 32)
    tiles = _cdiv(B, rows)
    if tiles > 65535:
        raise ValueError(f"lstm step: B={B} needs {tiles} row tiles of "
                         f"{rows}, more than a grid's 65535")
    splits = 1
    for s in range(2, STEP_MAX_SPLITS + 1):
        wave = n_sm if s <= 2 else n_sm * 3 // 4
        if not shallow and groups * tiles * s <= wave \
                and (s - 1) * _cdiv(n, s) < n:
            splits = s
    return StepPlan(units=STEP_UNITS, rows=rows, row_tiles=tiles,
                    splits=splits, split_stages=_cdiv(n, splits),
                    path="tf32" if tf32 else "ffma",
                    ctas=groups * tiles * splits, smem=step_smem(rows, tf32))


def lstm_step(x, wx, wh, b, mask, h0, c0):
    """The one-step forward in one launch: x [B, F], wx [F, 4H], wh [H,
    4H], b [4H], mask [B] (1 - done), h0, c0 [B, H]; same contract as
    ``lstm_step_plain``."""
    if _device(x) == "cpu":
        return lstm_step_plain(x, wx, wh, b, mask, h0, c0)
    B, F = x.shape
    H = wh.shape[0]
    dev = x.device
    for name, t, shape in (("x", x, (B, F)), ("wx", wx, (F, 4 * H)),
                           ("wh", wh, (H, 4 * H)), ("b", b, (4 * H,)),
                           ("mask", mask, (B,)), ("h0", h0, (B, H)),
                           ("c0", c0, (B, H))):
        _check(name, t, shape, dev)
    if B == 0:   # a data-parallel rank that holds no drawn row
        y = torch.empty((1, 0, H), dtype=torch.float32, device=dev)
        return (y, torch.empty((1, 0, 4 * H), dtype=torch.float32,
                               device=dev), y.clone(), h0.clone(),
                c0.clone())
    plan = step_plan(B, H, F, _n_sm(dev))
    y = torch.empty((1, B, H), dtype=torch.float32, device=dev)
    cs = torch.empty_like(y)
    gates = torch.empty((1, B, 4 * H), dtype=torch.float32, device=dev)
    hT = torch.empty((B, H), dtype=torch.float32, device=dev)
    cT = torch.empty_like(hT)
    with torch.cuda.device(dev):
        err = load().lstm_step_launch(
            x.data_ptr(), wx.data_ptr(), wh.data_ptr(), b.data_ptr(),
            mask.data_ptr(), h0.data_ptr(), c0.data_ptr(), y.data_ptr(),
            gates.data_ptr(), cs.data_ptr(), hT.data_ptr(), cT.data_ptr(),
            B, H, F, plan.rows, int(plan.path == "tf32"), plan.splits,
            plan.split_stages, _stream(dev))
    _raise_on(err, "lstm one-step forward")
    count("ops.lstm_step", (plan.path, B, H, F))
    return y, gates, cs, hT, cT


class LstmFunction(torch.autograd.Function):
    """Forward: at T = 1 the one-step kernel, else K3a then K3.
    Backward: K4, then the window contractions over dgates
    (lstm.py:257-262).  Saves what ``_vjp_fwd`` saves (lstm.py:284-301):
    weights, inputs, mask, initial state, y, gates, c."""

    @staticmethod
    def forward(ctx, wx, wh, b, x, done, h0, c0):
        T, B, F = x.shape
        x = x.contiguous()
        mask = (~done.to(torch.bool)).to(torch.float32).contiguous()
        h0, c0 = h0.contiguous(), c0.contiguous()
        wx, wh, b = wx.contiguous(), wh.contiguous(), b.contiguous()
        if T == 1:
            with span("ops.lstm_step"):
                y, gates, cs, hT, cT = lstm_step(x[0], wx, wh, b, mask[0],
                                                 h0, c0)
        else:
            with span("ops.input_proj"):
                xg = input_proj(x.view(T * B, F), wx, b)
            with span("ops.lstm_fwd"):
                y, gates, cs, hT, cT = lstm_fwd(xg.view(T, B, wx.shape[1]),
                                                wh, mask, h0, c0)
        ctx.save_for_backward(wx, wh, x, mask, h0, c0, y, gates, cs)
        return y, hT, cT

    @staticmethod
    @spanned("ops.lstm_bwd")
    def backward(ctx, dy, dhT, dcT):
        wx, wh, x, mask, h0, c0, y, gates, cs = ctx.saved_tensors
        T, B, F = x.shape
        H = h0.shape[1]
        # hT's cotangent enters like dy at the last step; cT's seeds the
        # dc carry (lstm.py:220-225).
        dy = torch.cat([dy[:-1], (dy[-1] + dhT)[None]]).contiguous()
        dgates, dh0, dc0 = lstm_bwd(gates, cs, c0, mask, wh, dy,
                                    dcT.contiguous())
        dg = dgates.view(T * B, 4 * H)
        hprev = torch.cat([h0[None], y[:-1]]) * mask[:, :, None]
        dwx = x.view(T * B, F).T @ dg
        dwh = hprev.view(T * B, H).T @ dg
        db = dg.sum(0)
        dx = (dg @ wx.T).view(T, B, F) if ctx.needs_input_grad[3] else None
        return dwx, dwh, db, dx, None, dh0, dc0


def lstm(wx, wh, b, x, done, h0, c0):
    """LSTM over x [T, B, F] with done [T, B] bool resetting the state
    before each step; gate order i, f, g, o.  wx [F, 4H], wh [H, 4H],
    b [4H], h0, c0 [B, H], all float32.  Returns (y [T, B, H], (hT, cT))."""
    y, hT, cT = LstmFunction.apply(wx, wh, b, x, done, h0, c0)
    return y, (hT, cT)
