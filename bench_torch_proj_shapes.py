#!/usr/bin/env python3
"""The LSTM input projection (K3a) by rows and by depth, on the GPU.

    python3 bench_torch_proj_shapes.py

Times ``rlpyt_tpu_torch.ops.lstm.input_proj`` and ``torch.addmm`` (fp32,
TF32 off) at R2D1's shapes (F = 6919, 4H = 2048): 64 rows for a
collection step, 640 (burn-in) and 1440 (training window) for an update.
A second table times the kernel at 64 and 1440 rows against the depth K,
which separates a launch's fixed cost from the cost of one 32-deep
shared-memory stage.  Every time is a device time: 20 launches captured
in one CUDA graph and replayed five times between two events, after the
card's clocks have been brought up (a card left idle reads 20 % slow).

Beside each shape's times stands its bound, as chip_smoke.py reckons
K3a's: the larger of its bytes (x, W_x, b and y, each moved once) at the
HBM rate and its operations (2 M F 4H) done as three TF32 tensor-core
products; the fp32 pipes' time for the operations is printed beside it.

It prints one line for each shape, the card's name and power limit, and
one JSON line with every number.  Needs one CUDA device.
"""
from __future__ import annotations

import json
import subprocess
import sys
import time

import torch

from chip_smoke import FP32_OPS_PER_S, HBM_BYTES_PER_S, TF32_OPS_PER_S
from rlpyt_tpu_torch.ops import lstm as L
from rlpyt_tpu_torch.utils.cuda_timing import graph_ms

F, N4H = 6919, 2048
ROWS = (64, 640, 1440)
DEPTHS = (256, 1024, 2048, 4096, 6919, 13838)


def bound(M: int, K: int = F) -> dict:
    """K3a's bound at M rows and depth K, in ms."""
    ops = 2 * M * K * N4H
    t_bytes = 4 * (M * K + K * N4H + N4H + M * N4H) / HBM_BYTES_PER_S * 1e3
    t_ops = 3 * ops / TF32_OPS_PER_S * 1e3
    return {"bound_ms": max(t_ops, t_bytes),
            "bound_by": "operations" if t_ops >= t_bytes else "bytes",
            "bound_ffma_ms": max(ops / FP32_OPS_PER_S * 1e3, t_bytes)}


def main():
    if not torch.cuda.is_available():
        print("bench_torch_proj_shapes: needs a CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(0)
    b = torch.randn((N4H,), generator=g, device=dev)
    wx = torch.randn((max(DEPTHS), N4H), generator=g, device=dev) * F ** -0.5
    xs = {M: torch.randn((M, max(DEPTHS)), generator=g, device=dev)
          for M in ROWS}
    L.load()
    n_sm = torch.cuda.get_device_properties(dev).multi_processor_count
    warm = torch.randn((4096, 4096), generator=g, device=dev)
    t0 = time.time()
    while time.time() - t0 < 2.0:
        for _ in range(20):
            warm @ warm
        torch.cuda.synchronize()

    def device_ms(M, K):
        x, w = xs[M][:, :K].contiguous(), wx[:K]
        plan = L.proj_plan(M, N4H, K, n_sm)
        return {"plan": plan,
                "ms": graph_ms([lambda: L.input_proj(x, w, b)] * 20),
                "addmm_ms": graph_ms([lambda: torch.addmm(b, x, w)] * 20),
                **bound(M, K)}

    by_rows = {M: device_ms(M, F) for M in ROWS}
    for M, r in by_rows.items():
        print(f"M={M}: kernel {r['ms']:.4f} ms, addmm {r['addmm_ms']:.4f} ms "
              f"(tile rows, K chunk, splits: {r['plan']}); bound "
              f"{r['bound_ms']:.4f} ms by {r['bound_by']} (fp32 pipes: "
              f"{r['bound_ffma_ms']:.4f} ms), kernel "
              f"{r['ms'] / r['bound_ms']:.2f} x the bound")
    by_depth = {M: {K: device_ms(M, K) for K in DEPTHS} for M in (64, 1440)}
    for M, row in by_depth.items():
        print(f"M={M}, kernel by K: " + "  ".join(
            f"{K}: {r['ms']:.4f}" for K, r in row.items()))

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    print(smi.splitlines()[0])
    print(json.dumps({"by_rows": by_rows, "by_depth": by_depth}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
