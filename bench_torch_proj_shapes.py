#!/usr/bin/env python3
"""The LSTM input projection (K3a) by rows and by depth, on the GPU.

    python3 bench_torch_proj_shapes.py [--tree DIR] [--sweep]

Times ``rlpyt_tpu_torch.ops.lstm.input_proj`` and ``torch.addmm`` (fp32,
TF32 off) at R2D1's shapes (F = 6919, 4H = 2048): 64 rows for a
collection step, 640 (burn-in) and 1440 (training window) for an update.
A second table times the kernel at 64 and 1440 rows against the depth K,
which separates a launch's fixed cost from the cost of one 32-deep
shared-memory stage.  A third times it at the shapes of every LSTM
config that ``chip_smoke.py`` drives (its ``P19_SHAPES``: the MinAtar PG,
MuJoCo, MinAtar R2D1, R2D1 twin and Atari R2D1 LSTMs, K = 135-6919),
beside ``addmm`` and the bound.  Every time is a device time: 20 launches
captured in one CUDA graph and replayed five times between two events,
after the card's clocks have been brought up (a card left idle reads
20 % slow).

Beside each shape's times stands its bound, as chip_smoke.py reckons
K3a's: the larger of its bytes (x, W_x, b and y, each moved once) at the
HBM rate and its operations (2 M K N) done as three TF32 tensor-core
products; the fp32 pipes' time for the operations is printed beside it.

``--tree`` times the wrappers of another checkout of the repo (one
unpacked with ``git archive`` into the git-ignored ``_archive/``), to
compare two trees on one card in one call.  ``--sweep`` (this tree only)
times, at each config shape, every tensor-core shape the library builds
and the generic FFMA kernel, each checked against the plain version and
launched twice for the same bits; the plan's choice is marked.  Its
numbers also go to ``chiprun_out/proj_sweep.json``.

It prints one line for each shape, the card's name and power limit, and
one JSON line with every number.  Needs one CUDA device.
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

from chip_smoke import (FP32_OPS_PER_S, HBM_BYTES_PER_S, P19_SHAPES,
                        TF32_OPS_PER_S)

F, N4H = 6919, 2048
ROWS = (64, 640, 1440)
DEPTHS = (256, 1024, 2048, 4096, 6919, 13838)


def bound(M: int, K: int = F, N: int = N4H) -> dict:
    """K3a's bound at M rows, depth K and N columns, in ms."""
    ops = 2 * M * K * N
    t_bytes = 4 * (M * K + K * N + N + M * N) / HBM_BYTES_PER_S * 1e3
    t_ops = 3 * ops / TF32_OPS_PER_S * 1e3
    return {"bound_ms": max(t_ops, t_bytes),
            "bound_by": "operations" if t_ops >= t_bytes else "bytes",
            "bound_ffma_ms": max(ops / FP32_OPS_PER_S * 1e3, t_bytes)}


def candidates(L, K: int):
    """Every plan the library can run at depth K: each tensor-core shape
    with its K range cut into ``splits`` chunks of whole stages, none
    empty, and the generic kernel."""
    stages = -(-K // L.PROJ_K_STEP)
    out = []
    for tile_m, tile_n, splits in sorted(L.PROJ_SHAPES):
        chunk = -(-stages // splits)
        if -(-stages // chunk) == splits:
            out.append(L.ProjPlan(tile_m, tile_n, chunk * L.PROJ_K_STEP,
                                  splits))
    return out + [L.ProjPlan(0, 128, K, 1)]


def launch(L, x, w, b, plan):
    """One K3a launch with the given plan, past ``proj_plan``."""
    (M, K), N = x.shape, w.shape[1]
    out = torch.empty((M, N), dtype=torch.float32, device=x.device)
    err = L.load().lstm_proj_launch(
        x.data_ptr(), w.data_ptr(), b.data_ptr(), out.data_ptr(), M, N, K,
        *plan, torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"K3a {tuple(plan)}: "
                           + L.load().lstm_error_string(err).decode())
    return out


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--tree", type=Path, default=None,
                    help="time the kernels of the checkout in this directory")
    ap.add_argument("--sweep", action="store_true",
                    help="time every shape of the kernel at the config shapes")
    args = ap.parse_args()
    if args.tree is not None:
        if args.sweep:
            ap.error("--sweep times this tree's library only")
        sys.path.insert(0, str(args.tree.resolve()))
        # chip_smoke, imported for its constants, loaded this tree's port.
        for name in [m for m in sys.modules
                     if m.split(".")[0] == "rlpyt_tpu_torch"]:
            del sys.modules[name]
    L = importlib.import_module("rlpyt_tpu_torch.ops.lstm")
    graph_ms = importlib.import_module(
        "rlpyt_tpu_torch.utils.cuda_timing").graph_ms
    tree = str(Path(L.__file__).resolve().parents[2])
    print(f"kernels of {tree}")
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

    def device_ms(x, w, bias):
        (M, K), N = x.shape, w.shape[1]
        return {"plan": list(L.proj_plan(M, N, K, n_sm)),
                "ms": graph_ms([lambda: L.input_proj(x, w, bias)] * 20),
                "addmm_ms": graph_ms([lambda: torch.addmm(bias, x, w)] * 20),
                **bound(M, K, N)}

    by_rows = {M: device_ms(xs[M][:, :F].contiguous(), wx[:F], b)
               for M in ROWS}
    for M, r in by_rows.items():
        print(f"M={M}: kernel {r['ms']:.4f} ms, addmm {r['addmm_ms']:.4f} ms "
              f"(plan: {r['plan']}); bound "
              f"{r['bound_ms']:.4f} ms by {r['bound_by']} (fp32 pipes: "
              f"{r['bound_ffma_ms']:.4f} ms), kernel "
              f"{r['ms'] / r['bound_ms']:.2f} x the bound")
    by_depth = {M: {K: device_ms(xs[M][:, :K].contiguous(), wx[:K], b)
                    for K in DEPTHS} for M in (64, 1440)}
    for M, row in by_depth.items():
        print(f"M={M}, kernel by K: " + "  ".join(
            f"{K}: {r['ms']:.4f}" for K, r in row.items()))

    # The config shapes, each with its own weights (W_x scaled as an
    # initialiser would, so that every product is of order one).
    weights = {}
    by_config, sweep = [], []
    for cfg, call, M, N, K in P19_SHAPES:
        if (N, K) not in weights:
            weights[N, K] = (
                torch.randn((K, N), generator=g, device=dev) * K ** -0.5,
                torch.randn((N,), generator=g, device=dev) * 0.1)
        w, bias = weights[N, K]
        x = torch.randn((M, K), generator=g, device=dev)
        r = dict(config=cfg, call=call, M=M, N=N, K=K, **device_ms(x, w, bias))
        by_config.append(r)
        print(f"{cfg} {call} M={M} N={N} K={K}: kernel {r['ms']:.4f} ms, "
              f"addmm {r['addmm_ms']:.4f} ms ({r['ms'] / r['addmm_ms']:.2f} "
              f"x), bound {r['bound_ms']:.5f} ms by {r['bound_by']}; plan "
              f"{r['plan']}")
        if not args.sweep:
            continue
        ref = x @ w + bias
        scale = ref.abs().max().item()
        for plan in candidates(L, K):
            out = launch(L, x, w, bias, plan)
            again = launch(L, x, w, bias, plan)
            torch.cuda.synchronize()
            s = dict(config=cfg, call=call, M=M, N=N, K=K, plan=list(plan),
                     chosen=list(plan) == r["plan"],
                     max_abs_err=(out - ref).abs().max().item(),
                     same_bits=torch.equal(out, again),
                     ms=graph_ms([lambda: launch(L, x, w, bias, plan)] * 20),
                     addmm_ms=r["addmm_ms"])
            if not (s["max_abs_err"] <= 1e-4 * scale and s["same_bits"]):
                raise RuntimeError(f"K3a {plan} at M={M} N={N} K={K}: max "
                                   f"abs err {s['max_abs_err']:.3g} (scale "
                                   f"{scale:.3g}), same bits "
                                   f"{s['same_bits']}")
            sweep.append(s)
            print(f"  sweep {tuple(plan)}{' *' if s['chosen'] else ''}: "
                  f"{s['ms']:.4f} ms ({s['ms'] / s['addmm_ms']:.2f} x addmm)"
                  f", err {s['max_abs_err']:.2e}")

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    print(smi.splitlines()[0])
    if args.sweep:
        out_dir = Path(__file__).resolve().parent / "chiprun_out"
        out_dir.mkdir(exist_ok=True)
        (out_dir / "proj_sweep.json").write_text(json.dumps(
            {"card": smi.splitlines()[0], "sweep": sweep}, indent=1))
    print(json.dumps({"tree": tree, "by_rows": by_rows,
                      "by_depth": by_depth, "by_config": by_config}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
