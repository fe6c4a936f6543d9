#!/usr/bin/env python3
"""The LSTM's one-step forward (T = 1) on the GPU: the fused kernel
``rlpyt_tpu_torch.ops.lstm.lstm_step`` beside the two-launch sequence it
replaced (K3a ``input_proj`` then K3 ``lstm_fwd`` at T = 1) and cuDNN's
one-step ``nn.LSTM`` forward.

    python3 bench_torch_lstm_step.py [--tree DIR] [--shapes H,F,B ...]
                                     [--sweep]

At each one-step shape of the LSTM configs (``SHAPES``: (H, F, B)), or
at ``--shapes``: the plan ``step_plan`` takes, the largest error of the
five outputs against ``lstm_step_plain`` relative to the largest value
(TF32 off), whether two launches give the same bits, and the device time
(launches captured in one CUDA graph and replayed between two events,
after 2 s of products that bring the card's clocks up) and call time
(one Python call in a back-to-back loop, by events) of the fused step, of
the K3a + K3 sequence and of cuDNN, beside the bound: the larger of the
call's bytes at 3.35 TB/s and its operations at the rate of the unit the
plan uses (67 TFLOP/s on the fp32 pipes; three TF32 products at 495
TFLOP/s for the TF32 path).

``--tree`` takes the kernels of another checkout of the repo (one
unpacked with ``git archive`` into the git-ignored ``_archive/``); a tree
without ``lstm_step`` times the sequence and cuDNN alone.  Run parent,
PR, PR, parent in one call to compare two trees on one card.

``--sweep`` instead times every plan the library builds at each shape
(each (rows, path) of ``STEP_SHAPES`` and each split count from 1 to 8
that leaves no split empty), each checked against the plain version and
for the same bits twice (a plan that fails is timed, marked and makes
the exit code 1), and writes every number to
``chiprun_out/step_sweep.json``: the data behind ``step_plan``.

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

FP32_OPS_PER_S = 67e12       # H100 SXM fp32 rate outside the tensor cores
TF32_OPS_PER_S = 495e12      # its dense TF32 tensor-core rate
HBM_BYTES_PER_S = 3.35e12    # its device memory
# (config call, H, F, B) of every one-step call of the LSTM configs.
SHAPES = (
    ("mujoco_lstm collection", 256, 260, 8),
    ("atari_dqn r2d1 evaluation", 512, 6917, 4),
    ("atari_dqn r2d1 collection", 512, 6917, 32),
    ("bench_r2d1 collection", 512, 6919, 64),
    ("minatar_dqn r2d1 collection", 128, 1031, 64),
    ("lstm_ppo collection", 128, 135, 128),
    ("r2d1 twin collection, minatar_dqn r2d1 evaluation", 128, 1031, 32),
    ("r2d1 twin evaluation", 128, 1031, 8),
    ("lstm_ppo evaluation", 128, 135, 32),
)


def warm_up(g, dev):
    """Bring the card's clocks up: 2 s of large products."""
    warm = torch.randn((4096, 4096), generator=g, device=dev)
    t0 = time.time()
    while time.time() - t0 < 2.0:
        for _ in range(20):
            warm @ warm
        torch.cuda.synchronize()


def step_case(g, dev, H, F, B):
    """Random one-step inputs with dones on about a tenth of the rows;
    weights scaled so the gate pre-activations are O(1)."""
    def randn(*shape, scale=1.0):
        return torch.randn(shape, generator=g, device=dev) * scale

    return dict(x=randn(B, F), wx=randn(F, 4 * H, scale=(F + H) ** -0.5),
                wh=randn(H, 4 * H, scale=(F + H) ** -0.5),
                b=randn(4 * H, scale=0.1),
                mask=(torch.rand((B,), generator=g, device=dev) > 0.1)
                .float(), h0=randn(B, H, scale=0.5), c0=randn(B, H, scale=0.5))


def step_args(c):
    return tuple(c[k] for k in ("x", "wx", "wh", "b", "mask", "h0", "c0"))


def rel(out, ref) -> float:
    return float((out - ref).abs().max()) / max(float(ref.abs().max()),
                                                1e-30)


def hold_step(L, c) -> tuple:
    """The fused step on case ``c`` against ``lstm_step_plain``: (the
    largest error of the five outputs relative to each one's largest
    value, the largest absolute error, the same bits over two
    launches)."""
    args = step_args(c)
    out = L.lstm_step(*args)
    again = L.lstm_step(*args)
    ref = L.lstm_step_plain(*args)
    worst = max(rel(o, r) for o, r in zip(out, ref))
    abs_err = max(float((o - r).abs().max()) for o, r in zip(out, ref))
    same = all(torch.equal(o, a) for o, a in zip(out, again))
    ok = all(o.shape == r.shape for o, r in zip(out, ref))
    return (worst if ok else float("inf")), abs_err, same


def bound(L, H, F, B, path: str) -> dict:
    """The least time of one one-step call on the unit the path uses."""
    ops, nbytes = L.step_costs(B, H, F) if hasattr(L, "step_costs") else (
        2 * B * (F + H) * 4 * H + 10 * B * H,
        4 * (B * F + (F + H) * 4 * H + 4 * H + B + 2 * B * H + 8 * B * H))
    t_ops = (3 * ops / TF32_OPS_PER_S if path == "tf32"
             else ops / FP32_OPS_PER_S) * 1e3
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    return dict(ops=ops, bytes=nbytes, bound_ms=max(t_ops, t_bytes),
                bound_by="operations" if t_ops >= t_bytes else "bytes",
                bound_ffma_ms=max(ops / FP32_OPS_PER_S * 1e3, t_bytes))


def cudnn_step(c, dev):
    """cuDNN's one-step LSTM with case ``c``'s weights, on the state
    already reset (h0 * m, c0 * m): the same function."""
    F, H = c["wx"].shape[0], c["wh"].shape[0]
    cudnn = torch.nn.LSTM(F, H).to(dev)
    with torch.no_grad():
        cudnn.weight_ih_l0.copy_(c["wx"].T)
        cudnn.weight_hh_l0.copy_(c["wh"].T)
        cudnn.bias_ih_l0.copy_(c["b"])
        cudnn.bias_hh_l0.zero_()
    m = c["mask"][:, None]
    state = ((c["h0"] * m)[None], (c["c0"] * m)[None])
    x = c["x"][None]

    def call():
        with torch.no_grad():
            cudnn(x, state)
    return call


def measure(L, timing, g, dev, H, F, B, graph_len=20, iters=50) -> dict:
    """One shape: the plan, the fused step's check, and the device and
    call times of the fused step, the K3a + K3 sequence and cuDNN."""
    n_sm = torch.cuda.get_device_properties(dev).multi_processor_count
    c = step_case(g, dev, H, F, B)
    args = step_args(c)
    xg_shape = (1, B, 4 * H)

    def seq():
        xg = L.input_proj(c["x"], c["wx"], c["b"])
        L.lstm_fwd(xg.view(xg_shape), c["wh"], c["mask"][None], c["h0"],
                   c["c0"])

    lib = cudnn_step(c, dev)
    r = dict(H=H, F=F, B=B)
    fused = hasattr(L, "lstm_step")
    if fused:
        plan = L.step_plan(B, H, F, n_sm)
        r["plan"] = plan._asdict()
        r["max_rel_err"], r["max_abs_err"], r["same_bits"] = hold_step(L, c)

        def step():
            L.lstm_step(*args)
        r["step_ms"] = timing.time_ms(step, iters)
        r["step_device_ms"] = timing.graph_ms([step] * graph_len)
    r["seq_ms"] = timing.time_ms(seq, iters)
    r["seq_device_ms"] = timing.graph_ms([seq] * graph_len)
    r["cudnn_ms"] = timing.time_ms(lib, iters)
    r["cudnn_device_ms"] = timing.graph_ms([lib] * graph_len)
    if fused:
        r["plain_ms"] = timing.time_ms(lambda: L.lstm_step_plain(*args), 10)
    r.update(bound(L, H, F, B, r["plan"]["path"] if fused else "ffma"))
    return r


def sweep(L, timing, g, dev, shapes):
    """Every built plan at each shape, checked and timed."""
    n_sm = torch.cuda.get_device_properties(dev).multi_processor_count
    base_plan = L.step_plan
    res, failed = {}, []
    for call, H, F, B in shapes:
        c = step_case(g, dev, H, F, B)
        args = step_args(c)
        n = L.step_stage_count(H, F)
        chosen = L.step_plan(B, H, F, n_sm)
        groups = -(-H // L.STEP_UNITS)
        for rows, tf32 in sorted(L.STEP_SHAPES):
            tiles = -(-B // rows)
            for s in range(1, L.STEP_MAX_SPLITS + 1):
                kc = -(-n // s)
                if (s - 1) * kc >= n:
                    continue
                plan = L.StepPlan(
                    units=L.STEP_UNITS, rows=rows, row_tiles=tiles, splits=s,
                    split_stages=kc, path="tf32" if tf32 else "ffma",
                    ctas=groups * tiles * s, smem=L.step_smem(rows, tf32))
                L.step_plan = lambda *_, plan=plan: plan
                try:
                    err, _, same = hold_step(L, c)
                    ms = timing.graph_ms([lambda: L.lstm_step(*args)] * 20)
                finally:
                    L.step_plan = base_plan
                key = f"H={H} F={F} B={B} rows={rows} {plan.path} splits={s}"
                ok = err <= 1e-4 and same
                if not ok:
                    failed.append(key)
                res[key] = dict(H=H, F=F, B=B, rows=rows, path=plan.path,
                                splits=s, ctas=plan.ctas, device_ms=ms,
                                err=err, chosen=plan == chosen, ok=ok)
                print(f"{'' if ok else 'FAIL: '}{key} ({plan.ctas} CTAs)"
                      f"{' [plan]' * (plan == chosen)}: {ms:.4f} ms (err "
                      f"{err:.2g}, same bits {same})", flush=True)
        best = min((v for v in res.values()
                    if (v["H"], v["F"], v["B"]) == (H, F, B) and v["ok"]),
                   key=lambda v: v["device_ms"], default=None)
        if best:
            print(f"{call} H={H} F={F} B={B}: fastest rows={best['rows']} "
                  f"{best['path']} splits={best['splits']} "
                  f"{best['device_ms']:.4f} ms; the plan takes rows="
                  f"{chosen.rows} {chosen.path} splits={chosen.splits}",
                  flush=True)
    return res, failed


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--tree", type=Path, default=None,
                    help="time the kernels of the checkout in this directory")
    ap.add_argument("--shapes", nargs="+", default=None,
                    help="H,F,B shapes to time (instead of SHAPES)")
    ap.add_argument("--sweep", action="store_true",
                    help="time every built plan at each shape")
    args = ap.parse_args()
    if args.tree is not None:
        sys.path.insert(0, str(args.tree.resolve()))
    L = importlib.import_module("rlpyt_tpu_torch.ops.lstm")
    timing = importlib.import_module("rlpyt_tpu_torch.utils.cuda_timing")
    tree = str(Path(L.__file__).resolve().parents[2])
    print(f"kernels of {tree}")
    if not torch.cuda.is_available():
        print("bench_torch_lstm_step: needs a CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(0)
    shapes = SHAPES if not args.shapes else [
        ("given",) + tuple(int(v) for v in s.split(",")) for s in args.shapes]
    L.load()
    warm_up(g, dev)
    failed = []
    if args.sweep:
        res, failed = sweep(L, timing, g, dev, shapes)
        out = Path("chiprun_out")
        out.mkdir(exist_ok=True)
        (out / "step_sweep.json").write_text(json.dumps(res, indent=1))
        res = str(out / "step_sweep.json")
    else:
        res = {}
        for call, H, F, B in shapes:
            r = res[f"{call} H={H} F={F} B={B}"] = measure(
                L, timing, g, dev, H, F, B)
            fused = "step_device_ms" in r
            if fused and not (r["max_rel_err"] <= 1e-4 and r["same_bits"]):
                failed.append(f"H={H} F={F} B={B}")
            print(f"{call} H={H} F={F} B={B}: "
                  + (f"plan rows={r['plan']['rows']} {r['plan']['path']} "
                     f"splits={r['plan']['splits']} ({r['plan']['ctas']} "
                     f"CTAs), err {r['max_rel_err']:.2g} of max, same bits "
                     f"{r['same_bits']}; fused device "
                     f"{r['step_device_ms']:.4f} ms call {r['step_ms']:.4f}; "
                     if fused else "")
                  + f"K3a + K3 device {r['seq_device_ms']:.4f} ms call "
                  f"{r['seq_ms']:.4f}; cuDNN device {r['cudnn_device_ms']:.4f}"
                  f" ms call {r['cudnn_ms']:.4f}; bound {r['bound_ms']:.5f} "
                  f"ms by {r['bound_by']}", flush=True)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    print(smi.splitlines()[0])
    print(json.dumps({"tree": tree, "by_shape": res}))
    if failed:
        print(f"bench_torch_lstm_step: {len(failed)} shapes differ from the "
              f"plain version or between launches: {failed}",
              file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
