#!/usr/bin/env python3
"""The LSTM recurrences (K3 forward, K4 backward) by sequence length, on
the GPU.

    python3 bench_torch_lstm_steps.py [--tree DIR] [--h H ...] [--b B ...]
                                      [--t T ...] [--shapes H,T,B ...]
                                      [--sweep]

Times ``rlpyt_tpu_torch.ops.lstm.lstm_fwd`` and ``lstm_bwd`` at each
hidden size of ``--h`` (default 512, R2D1's LSTM), each batch of ``--b``
(default 32, an update's windows, and 64, the collector's lanes) and each
sequence length of ``--t`` (default 1, 2, 5, 10, 20, 45, 80), and fits
each kernel's device time at each (H, B) to ``intercept + slope * T`` by
least squares: the slope is the cost of one step of the recurrence, the
intercept the cost of a launch (set-up, the W_h preload, the first
step's latency).  Every time is a device time: launches captured in one
CUDA graph and replayed between two events, after the card's clocks have
been brought up (a card left idle reads 20 % slow).  Beside each fit:
the bound of one step (2 * B * H * 4H operations on the fp32 pipes), and
the plan the wrappers took.

``--shapes H,T,B ...`` instead times K3 and K4 (K3 alone at T = 1) at
exactly those shapes, with the plan each took.

``--tree`` times the wrappers of another checkout of the repo (one
unpacked with ``git archive`` into the git-ignored ``_archive/``), to
compare two trees on one card in one call.

``--sweep`` instead times the cluster path (``ops/lstm.py:
ClusterPlan``) at every cluster size and rows a cluster that fit, at the
narrow LSTMs' shapes (``SWEEP_SHAPES``), each checked against the plain
versions (K3 to 1e-4, K4 to 1e-3 of the largest value, TF32 off) and
for the same bits over two launches; it prints how many clusters of each
size the card holds at once (``cudaOccupancyMaxActiveClusters``) and
writes every number to ``chiprun_out/lstm_sweep.json``: the data behind
``ops/lstm.py:_cluster_choice``.

It prints one line for each kernel and shape, the card's name and power
limit, and one JSON line with every number.  Needs one CUDA device.
"""
from __future__ import annotations

import argparse
import dataclasses
import importlib
import json
import subprocess
import sys
import time
from pathlib import Path

import torch

TS = (1, 2, 5, 10, 20, 45, 80)
BS = (32, 64)
FP32_OPS_PER_S = 67e12       # H100 SXM fp32 rate outside the tensor cores
# (H, T, B) of the narrow LSTMs' recurrences at T > 1: the lstm_a2c
# window, a lstm_ppo minibatch, a recurrent Gaussian PPO minibatch and
# its whole batch, the MinAtar r2d1 window and burn-in, the R2D1 twin's
# window.
SWEEP_SHAPES = ((128, 16, 128), (128, 16, 32), (256, 256, 4),
                (256, 256, 8), (128, 45, 32), (128, 20, 32), (128, 23, 32))
SWEEP_ROWS = (1, 2, 4, 8, 12, 16, 24, 32, 48, 64)


def fit(ts, ms):
    """Least-squares (intercept, slope) of ``ms`` against ``ts``."""
    n = len(ts)
    mt, mm = sum(ts) / n, sum(ms) / n
    slope = sum((t - mt) * (m - mm) for t, m in zip(ts, ms)) \
        / sum((t - mt) ** 2 for t in ts)
    return mm - slope * mt, slope


def warm_up(g, dev):
    """Bring the card's clocks up: 2 s of large products."""
    warm = torch.randn((4096, 4096), generator=g, device=dev)
    t0 = time.time()
    while time.time() - t0 < 2.0:
        for _ in range(20):
            warm @ warm
        torch.cuda.synchronize()


def case(g, dev, H, T, B):
    """Inputs of one shape: W_h, xg, a mask with dones, h0, c0, dy, dcT."""
    def randn(*shape, scale=1.0):
        return torch.randn(shape, generator=g, device=dev) * scale

    return dict(wh=randn(H, 4 * H, scale=H ** -0.5), xg=randn(T, B, 4 * H),
                mask=(torch.rand((T, B), generator=g, device=dev) > 0.1)
                .float(), h0=randn(B, H, scale=0.5), c0=randn(B, H, scale=0.5),
                dy=randn(T, B, H), dcT=randn(B, H))


def by_length(L, graph_ms, g, dev, hs, bs, ts):
    """Device times of K3 and K4 at every (H, B, T), and their fits."""
    res = {}
    n_sm = torch.cuda.get_device_properties(dev).multi_processor_count
    for H in hs:
        for B in bs:
            fwd_ms, bwd_ms = [], []
            for T in ts:
                c = case(g, dev, H, T, B)
                fa = (c["xg"], c["wh"], c["mask"], c["h0"], c["c0"])
                _, gates, cs, _, _ = L.lstm_fwd(*fa)
                ba = (gates, cs, c["c0"], c["mask"], c["wh"], c["dy"],
                      c["dcT"])
                n = max(4, min(40, 400 // T))
                fwd_ms.append(graph_ms([lambda: L.lstm_fwd(*fa)] * n))
                bwd_ms.append(graph_ms([lambda: L.lstm_bwd(*ba)] * n))
            step_bound = 2 * B * H * 4 * H / FP32_OPS_PER_S * 1e3
            plan = L.recurrence_plan(B, H, n_sm)
            for name, ms in (("lstm_fwd", fwd_ms), ("lstm_bwd", bwd_ms)):
                icpt, slope = fit(ts, ms) if len(ts) > 1 else (ms[0], 0.0)
                res[f"{name} H={H} B={B}"] = {
                    "T": list(ts), "device_ms": ms, "intercept_ms": icpt,
                    "slope_ms": slope, "step_bound_ms": step_bound,
                    "plan": str(plan)}
                print(f"{name} H={H} B={B}: " + "  ".join(
                    f"T={t}: {m:.4f}" for t, m in zip(ts, ms))
                    + f"  -> per step {slope * 1e3:.2f} us, per launch "
                    f"{icpt * 1e3:.2f} us (bound of a step "
                    f"{step_bound * 1e3:.2f} us)", flush=True)
            print(f"  plan: {plan}")
    return res


def at_shapes(L, graph_ms, g, dev, shapes):
    """Device times of K3 and K4 (K3 alone at T = 1) at each (H, T, B)."""
    res = {}
    n_sm = torch.cuda.get_device_properties(dev).multi_processor_count
    for H, T, B in shapes:
        c = case(g, dev, H, T, B)
        fa = (c["xg"], c["wh"], c["mask"], c["h0"], c["c0"])
        n = max(4, min(40, 400 // T))
        r = {"fwd_ms": graph_ms([lambda: L.lstm_fwd(*fa)] * n),
             "plan": str(L.recurrence_plan(B, H, n_sm))}
        if T > 1:
            _, gates, cs, _, _ = L.lstm_fwd(*fa)
            ba = (gates, cs, c["c0"], c["mask"], c["wh"], c["dy"], c["dcT"])
            r["bwd_ms"] = graph_ms([lambda: L.lstm_bwd(*ba)] * n)
        res[f"H={H} T={T} B={B}"] = r
        print(f"H={H} T={T} B={B}: K3 {r['fwd_ms']:.4f} ms"
              + (f", K4 {r['bwd_ms']:.4f} ms" if T > 1 else "")
              + f"; plan {r['plan']}", flush=True)
    return res


def rel(out, ref) -> float:
    return float((out - ref).abs().max()) / max(float(ref.abs().max()),
                                                1e-30)


def sweep(L, graph_ms, g, dev):
    """Every cluster size and rows a cluster that fit, at SWEEP_SHAPES."""
    lib = L.load()
    n_sm = torch.cuda.get_device_properties(dev).multi_processor_count
    base_plan = L.recurrence_plan
    res, capacity, failed = {}, {}, []
    for H, T, B in SWEEP_SHAPES:
        c = case(g, dev, H, T, B)
        fa = (c["xg"], c["wh"], c["mask"], c["h0"], c["c0"])
        ref = L.lstm_fwd_plain(*fa)
        ba = (ref[1], ref[2], c["c0"], c["mask"], c["wh"], c["dy"], c["dcT"])
        bref = L.lstm_bwd_plain(*ba)
        n = max(4, min(40, 400 // T))
        for C in L.CLUSTER_SIZES:
            for rows in SWEEP_ROWS:
                if rows > B:
                    continue
                cp = L.cluster_plan(B, H, C, rows)
                if cp is None:
                    continue
                for which, smem in ((0, cp.fwd_smem), (1, cp.bwd_smem)):
                    key = (which, C, smem)
                    if key not in capacity:
                        capacity[key] = lib.lstm_cluster_capacity(*key)
                plan = dataclasses.replace(base_plan(B, H, n_sm),
                                           clustered=cp)
                L.recurrence_plan = lambda *_, plan=plan: plan
                try:
                    out = L.lstm_fwd(*fa)
                    again = L.lstm_fwd(*fa)
                    bout = L.lstm_bwd(*ba)
                    bagain = L.lstm_bwd(*ba)
                    f_err = max(rel(o, r) for o, r in zip(out, ref))
                    b_err = max(rel(o, r) for o, r in zip(bout, bref))
                    same = all(torch.equal(o, p) for o, p in
                               zip(out + bout, again + bagain))
                    ok = f_err <= 1e-4 and b_err <= 1e-3 and same
                    if ok:
                        f_ms = graph_ms([lambda: L.lstm_fwd(*fa)] * n)
                        b_ms = graph_ms([lambda: L.lstm_bwd(*ba)] * n)
                finally:
                    L.recurrence_plan = base_plan
                if not ok:
                    failed.append(f"H={H} T={T} B={B} C={C} rows={rows}")
                    print(f"FAIL: cluster plan {cp} at H={H} T={T} B={B}: "
                          f"K3 err {f_err:.3g}, K4 err {b_err:.3g}, same "
                          f"bits {same}", flush=True)
                    continue
                res[f"H={H} T={T} B={B} C={C} rows={rows}"] = dict(
                    H=H, T=T, B=B, C=C, rows=rows, clusters=cp.clusters,
                    fwd_ms=f_ms, bwd_ms=b_ms, fwd_err=f_err, bwd_err=b_err,
                    fwd_capacity=capacity[0, C, cp.fwd_smem],
                    bwd_capacity=capacity[1, C, cp.bwd_smem])
                print(f"H={H} T={T} B={B} C={C} rows={rows} "
                      f"({cp.clusters} clusters; hold at once: K3 "
                      f"{capacity[0, C, cp.fwd_smem]}, K4 "
                      f"{capacity[1, C, cp.bwd_smem]}): K3 {f_ms:.4f} ms "
                      f"(err {f_err:.2g}), K4 {b_ms:.4f} ms (err "
                      f"{b_err:.2g})", flush=True)
        chosen = base_plan(B, H, n_sm).clustered
        print(f"H={H} T={T} B={B}: the plan takes C={chosen.cluster} "
              f"rows={chosen.rows}")
    return res, failed


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--tree", type=Path, default=None,
                    help="time the kernels of the checkout in this directory")
    ap.add_argument("--h", type=int, nargs="+", default=[512],
                    help="hidden sizes")
    ap.add_argument("--b", type=int, nargs="+", default=list(BS),
                    help="batch sizes")
    ap.add_argument("--t", type=int, nargs="+", default=list(TS),
                    help="sequence lengths")
    ap.add_argument("--shapes", nargs="+", default=None,
                    help="H,T,B shapes to time (instead of the fits)")
    ap.add_argument("--sweep", action="store_true",
                    help="time every cluster-path shape at SWEEP_SHAPES")
    args = ap.parse_args()
    if args.tree is not None:
        sys.path.insert(0, str(args.tree.resolve()))
    L = importlib.import_module("rlpyt_tpu_torch.ops.lstm")
    graph_ms = importlib.import_module(
        "rlpyt_tpu_torch.utils.cuda_timing").graph_ms
    tree = str(Path(L.__file__).resolve().parents[2])
    print(f"kernels of {tree}")
    if not torch.cuda.is_available():
        print("bench_torch_lstm_steps: needs a CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(0)
    L.load()
    warm_up(g, dev)
    if args.sweep:
        res, failed = sweep(L, graph_ms, g, dev)
        out = Path("chiprun_out")
        out.mkdir(exist_ok=True)
        (out / "lstm_sweep.json").write_text(json.dumps(res, indent=1))
        res = str(out / "lstm_sweep.json")
        if failed:
            print(f"bench_torch_lstm_steps: {len(failed)} cluster plans "
                  f"differ from the plain versions: {failed}",
                  file=sys.stderr)
            return 1
    elif args.shapes:
        res = at_shapes(L, graph_ms, g, dev, [
            tuple(int(v) for v in shape.split(",")) for shape in args.shapes])
    else:
        res = by_length(L, graph_ms, g, dev, args.h, args.b, args.t)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    print(smi.splitlines()[0])
    print(json.dumps({"tree": tree, "by_shape": res}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
