#!/usr/bin/env python3
"""The LSTM recurrences (K3 forward, K4 backward) by sequence length, on
the GPU.

    python3 bench_torch_lstm_steps.py [--tree DIR]

Times ``rlpyt_tpu_torch.ops.lstm.lstm_fwd`` and ``lstm_bwd`` at H = 512
(R2D1's LSTM) for T = 1, 2, 5, 10, 20, 45, 80 and B = 32 (an update's
windows) and 64 (the collector's lanes), and fits each kernel's device
time at each B to ``intercept + slope * T`` by least squares: the slope
is the cost of one step of the recurrence, the intercept the cost of a
launch (set-up, the W_h preload, the first step's latency).  Every time
is a device time: launches captured in one CUDA graph and replayed
between two events, after the card's clocks have been brought up (a
card left idle reads 20 % slow).  Beside each fit: the bound of one step
(2 * B * H * 4H operations on the fp32 pipes).

``--tree`` times the wrappers of another checkout of the repo (one unpacked with
``git archive`` into the git-ignored ``_archive/``), to compare two trees
on one card in one call.

It prints one line for each kernel and B, the card's name and power
limit, and one JSON line with every number.  Needs one CUDA device.
"""
from __future__ import annotations

import argparse
import importlib
import json
import subprocess
import sys
import time
from pathlib import Path

import torch

H = 512
TS = (1, 2, 5, 10, 20, 45, 80)
BS = (32, 64)
FP32_OPS_PER_S = 67e12       # H100 SXM fp32 rate outside the tensor cores


def fit(ts, ms):
    """Least-squares (intercept, slope) of ``ms`` against ``ts``."""
    n = len(ts)
    mt, mm = sum(ts) / n, sum(ms) / n
    slope = sum((t - mt) * (m - mm) for t, m in zip(ts, ms)) \
        / sum((t - mt) ** 2 for t in ts)
    return mm - slope * mt, slope


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--tree", type=Path, default=None,
                    help="time the kernels of the checkout in this directory")
    args = ap.parse_args()
    if args.tree is not None:
        sys.path.insert(0, str(args.tree.resolve()))
    L = importlib.import_module("rlpyt_tpu_torch.ops.lstm")
    graph_ms = importlib.import_module(
        "rlpyt_tpu_torch.utils.cuda_timing").graph_ms
    print(f"kernels of {Path(L.__file__).resolve().parents[2]}")
    fwd, bwd = L.lstm_fwd, L.lstm_bwd
    if not torch.cuda.is_available():
        print("bench_torch_lstm_steps: needs a CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(0)
    L.load()
    wh = torch.randn((H, 4 * H), generator=g, device=dev) * H ** -0.5
    warm = torch.randn((4096, 4096), generator=g, device=dev)
    t0 = time.time()
    while time.time() - t0 < 2.0:
        for _ in range(20):
            warm @ warm
        torch.cuda.synchronize()

    res = {}
    for B in BS:
        h0 = torch.randn((B, H), generator=g, device=dev) * 0.5
        c0 = torch.randn((B, H), generator=g, device=dev) * 0.5
        dcT = torch.randn((B, H), generator=g, device=dev)
        fwd_ms, bwd_ms = [], []
        for T in TS:
            xg = torch.randn((T, B, 4 * H), generator=g, device=dev)
            mask = (torch.rand((T, B), generator=g, device=dev) > 0.1).float()
            dy = torch.randn((T, B, H), generator=g, device=dev)
            _, gates, cs, _, _ = fwd(xg, wh, mask, h0, c0)
            n = max(4, min(40, 400 // T))
            fwd_ms.append(graph_ms([lambda: fwd(xg, wh, mask, h0, c0)] * n))
            bwd_ms.append(graph_ms(
                [lambda: bwd(gates, cs, c0, mask, wh, dy, dcT)] * n))
        step_bound = 2 * B * H * 4 * H / FP32_OPS_PER_S * 1e3
        for name, ms in (("lstm_fwd", fwd_ms), ("lstm_bwd", bwd_ms)):
            icpt, slope = fit(TS, ms)
            res[f"{name} B={B}"] = {
                "T": list(TS), "device_ms": ms, "intercept_ms": icpt,
                "slope_ms": slope, "step_bound_ms": step_bound}
            print(f"{name} B={B}: " + "  ".join(
                f"T={t}: {m:.4f}" for t, m in zip(TS, ms))
                + f"  -> per step {slope * 1e3:.2f} us, per launch "
                f"{icpt * 1e3:.2f} us (bound of a step {step_bound * 1e3:.2f}"
                " us)")

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    print(smi.splitlines()[0])
    print(json.dumps({"tree": str(Path(L.__file__).resolve().parents[2]),
                      "by_shape": res}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
