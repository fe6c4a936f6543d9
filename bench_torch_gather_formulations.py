#!/usr/bin/env python3
"""Replay frame-row gather formulations on one NVIDIA GPU: the PyTorch
port's twin of bench_gather_formulations.py.

    python3 bench_torch_gather_formulations.py

At that harness's shapes (ring of 390 rows x 512 lanes of F = 8320 uint8,
union window U = 7 = K + n of the Atari "ernbw" configuration, batch 1024)
it holds the port's two unmasked union gathers against plain indexing,

    row    match: the CUDA row gather (ops/union_gather.py
                  gather_union_rows, K5) == ring[rows, b]
    window match: the CUDA window gather on the lane-major ghost ring
                  (gather_union_window, K6) == ring[rows, b]

on starts that wrap past the ring's end as well as ones that do not, and
then times, with CUDA events around back-to-back Python calls (and, for
the three kernels, around replays of one CUDA graph that holds 32
launches: the device time of a launch with the host taken out):

    calib   a streaming copy of the same number of bytes (59.6 MB read,
            59.6 MB written);
    plain   gather_union_rows_plain / gather_union_window_plain: index
            arithmetic plus one advanced-indexing call;
    indexed the one call ``ring[rows, b]`` (``ring_lm[b, rows]``) on
            indices made beforehand;
    K5, K6  the two kernels;
    masked  the shipped masked dual-stack kernel (ops/frame_gather.py,
            K1/K2) at K = 4, n = 3 on the same samples.

Each timed call takes the next of 16 index sets (the calib copy the next
of 16 slabs), so that a call finds none of its rows in L2 from the call
before.  Beside each time: GB/s of union bytes read and the bound, the
bytes the function must move (each input byte read once, each output byte
written once) over the H100's 3.35 TB/s.  Needs a CUDA device; without
one it exits 1.
"""
from __future__ import annotations

import itertools
import json
import subprocess
import sys
from pathlib import Path

import torch

from rlpyt_tpu_torch.utils.cuda_timing import graph_ms, time_ms

SIZE_T, B_LANES, F, U, BATCH = 390, 512, 8320, 7, 1024
K, N_STEP = 4, 3                 # the masked kernel's split of U
N_SETS = 16
HBM_BYTES_PER_S = 3.35e12        # H100 SXM device memory rate (data sheet)

# The rows of the table, in the order they are timed.
CALIB = "calib streaming copy"
ROW_PLAIN = "plain row gather"
ROW_INDEXED = "indexed ring[rows, b]"
ROW_KERNEL = "K5 row gather"
WINDOW_PLAIN = "plain window gather"
WINDOW_INDEXED = "indexed ring_lm[b, rows]"
WINDOW_KERNEL = "K6 window gather"
MASKED = f"masked K1/K2, K={K} n={N_STEP}"


def make_case(g: torch.Generator, dev, size_T=SIZE_T, B=B_LANES, F=F, U=U,
              batch=BATCH, n_sets=N_SETS):
    """Time-major ring, its lane-major ghost ring, and ``n_sets`` index
    sets (start, b_idx), int32.  The first min(8, batch) starts of every
    set lie in the ring's last rows, so their windows wrap."""
    from rlpyt_tpu_torch.ops import union_gather as ug

    ring = torch.randint(0, 256, (size_T, B, F), generator=g, device=dev,
                         dtype=torch.uint8)
    sets = []
    n_wrap = min(8, batch, size_T)
    for _ in range(n_sets):
        start = torch.randint(0, size_T, (batch,), generator=g, device=dev,
                              dtype=torch.int32)
        start[:n_wrap] = torch.arange(size_T - n_wrap, size_T, device=dev,
                                      dtype=torch.int32)
        b_idx = torch.randint(0, B, (batch,), generator=g, device=dev,
                              dtype=torch.int32)
        sets.append((start, b_idx))
    return ring, ug.lane_major_ring(ring, U), sets


def matches(ring, ring_lm, sets, U=U):
    """(row match, window match) of the kernels against ``ring[rows, b]``
    over every index set, wrap-around starts included."""
    from rlpyt_tpu_torch.ops import union_gather as ug

    row = window = True
    for start, b_idx in sets:
        rows = (start.long()[:, None]
                + torch.arange(U, device=ring.device)) % ring.shape[0]
        ref = ring[rows, b_idx.long()[:, None]]
        row &= torch.equal(ug.gather_union_rows(ring, start, b_idx, U), ref)
        window &= torch.equal(
            ug.gather_union_window(ring_lm, start, b_idx, U), ref)
    return row, window


def measure(ring, ring_lm, sets, g: torch.Generator):
    """Times of every formulation, in ms, with the bytes each must move
    and its bound."""
    from rlpyt_tpu_torch.ops import frame_gather as fg
    from rlpyt_tpu_torch.ops import union_gather as ug

    dev = ring.device
    size_T, _, F = ring.shape
    batch = sets[0][0].shape[0]
    U = ring_lm.shape[1] - size_T + 1
    n = len(sets)
    pre = []   # indices for the indexed calls, masks for the masked kernel
    for start, b_idx in sets:
        rows = (start.long()[:, None]
                + torch.arange(U, device=dev)) % size_T
        rows_lm = start.long()[:, None] + torch.arange(U, device=dev)
        masks = torch.randint(0, 2, (2, batch, K), generator=g, device=dev,
                              dtype=torch.uint8)
        pre.append((rows, rows_lm, b_idx.long()[:, None], masks[0], masks[1]))

    # Slabs of exactly the union's bytes, cut from the ring.
    slab_rows = max(1, batch * U // ring.shape[1])
    out = torch.empty_like(ring[:slab_rows])

    def calib(k):
        s = (k % n) * slab_rows % (size_T - slab_rows + 1)
        out.copy_(ring[s:s + slab_rows])

    def masked(k):
        (start, b_idx), (_, _, _, ma, mt) = sets[k % n], pre[k % n]
        fg.gather_frame_stacks(ring, start, b_idx, ma, mt, K, N_STEP)

    union_bytes = batch * U * F
    fns = {
        CALIB: (calib, 2 * slab_rows * ring.shape[1] * F),
        ROW_PLAIN: (lambda k: ug.gather_union_rows_plain(
            ring, *sets[k % n], U), 2 * union_bytes),
        ROW_INDEXED: (lambda k: ring[pre[k % n][0], pre[k % n][2]],
                      2 * union_bytes),
        ROW_KERNEL: (lambda k: ug.gather_union_rows(
            ring, *sets[k % n], U), 2 * union_bytes),
        WINDOW_PLAIN: (lambda k: ug.gather_union_window_plain(
            ring_lm, *sets[k % n], U), 2 * union_bytes),
        WINDOW_INDEXED: (lambda k: ring_lm[pre[k % n][2], pre[k % n][1]],
                         2 * union_bytes),
        WINDOW_KERNEL: (lambda k: ug.gather_union_window(
            ring_lm, *sets[k % n], U), 2 * union_bytes),
        MASKED: (masked, batch * (K + N_STEP + 2 * K) * F),
    }
    res = {}
    for name, (fn, n_bytes) in fns.items():
        k = itertools.count()
        ms = time_ms(lambda: fn(next(k)), iters=48)
        res[name] = {"ms": ms, "bytes": n_bytes,
                     "bound_ms": n_bytes / HBM_BYTES_PER_S * 1e3,
                     "read_gb_per_s": union_bytes / ms / 1e6}
        if name in (ROW_KERNEL, WINDOW_KERNEL, MASKED):
            # Two passes over the index sets, replayed from one graph.
            res[name]["device_ms"] = graph_ms(
                [lambda k=k, fn=fn: fn(k) for k in range(2 * n)])
    return res


def run(dev, seed: int = 0):
    """The whole harness: build the rings, hold the kernels against plain
    indexing, time every formulation, free the rings.  Returns
    (row match, window match, times)."""
    g = torch.Generator(device=dev).manual_seed(seed)
    ring, ring_lm, sets = make_case(g, dev)
    row, window = matches(ring, ring_lm, sets)
    print("row    match:", row)
    print("window match:", window)
    res = measure(ring, ring_lm, sets, g)
    for name, r in res.items():
        device = (f"  device {r['device_ms']:.4f} ms" if "device_ms" in r
                  else "")
        print(f"{name:28s} {r['ms']:8.4f} ms/gather  "
              f"{r['read_gb_per_s']:7.1f} GB/s (read)  bound "
              f"{r['bound_ms']:.4f} ms ({r['bytes'] / 1e6:.1f} MB){device}")
    del ring, ring_lm, sets
    torch.cuda.empty_cache()
    return row, window, res


def main():
    if not torch.cuda.is_available():
        print("bench_torch_gather_formulations: needs a CUDA device",
              file=sys.stderr)
        return 1
    sys.path.insert(0, str(Path(__file__).resolve().parent))
    row, window, res = run(torch.device("cuda"))
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    print(smi.splitlines()[0])
    print(json.dumps({"device": torch.cuda.get_device_name(0),
                      "row_match": row, "window_match": window,
                      "shape": {"size_T": SIZE_T, "B": B_LANES, "F": F,
                                "U": U, "batch": BATCH},
                      "formulations": res}))
    return 0 if row and window else 1


if __name__ == "__main__":
    sys.exit(main())
