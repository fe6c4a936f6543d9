#!/usr/bin/env python3
"""Where the PyTorch port's trainers spend their time on one NVIDIA GPU
(the port's counterpart of bench_profile.py).

    python3 bench_torch_profile.py           # flagship Nature-CNN DQN
    python3 bench_torch_profile.py --r2d1    # Atari-geometry R2D1
    python3 bench_torch_profile.py --ernbw   # Atari "ernbw" (C51, dueling,
                                             # prioritized replay, n-step 3)

Builds the trainer of chip_smoke.py (full width, bf16), warms it up
(DQN and ernbw: two iterations; R2D1: three, the third being the first
with updates), then measures:
  - host wall time of one iteration split into collect and optimize,
    each ended by a device sync (median of 3);
  - host wall time per replay sample (DQN and ernbw: sample_idxs +
    extract_batch, including the frame-gather kernel, for ernbw also
    the prioritized draw; R2D1: sample_idxs + extract_window) and per
    gradient update (R2D1 and ernbw: including the priority write-back);
  - a torch.profiler trace of one iteration: device busy time (sum of
    kernel, copy and set times), the idle share of the iteration's wall
    time under the profiler, the number of device operations, and the
    top device operations by time.
Prints one JSON line; the profiler table goes to
chiprun_out/profile_table[_r2d1|_ernbw].txt.  Needs a CUDA device.
"""
from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

import torch


def wall(fn, sync=True):
    t0 = time.perf_counter()
    out = fn()
    if sync:
        torch.cuda.synchronize()
    return time.perf_counter() - t0, out


def main():
    if not torch.cuda.is_available():
        print("bench_torch_profile: needs a CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(Path(__file__).resolve().parent))
    import chip_smoke as cs
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    dev = torch.device("cuda")
    r2d1 = "--r2d1" in sys.argv[1:]
    ernbw = "--ernbw" in sys.argv[1:]
    if r2d1:
        runner = cs.build_r2d1_runner(dev, n_itr=20)
        steps, warmup, suffix = cs.R2D1_T * cs.R2D1_B, 3, "_r2d1"
    elif ernbw:
        runner = cs.build_ernbw_runner(dev, n_itr=10)
        steps, warmup, suffix = cs.T * cs.B, 2, "_ernbw"
    else:
        runner = cs.build_flagship_runner(dev, n_itr=10)
        steps, warmup, suffix = cs.T * cs.B, 2, ""
    runner.startup()
    algo, coll = runner.algo, runner.collector
    batch_size = algo.batch_b if r2d1 else algo.batch_size
    for _ in range(warmup):
        runner.run_interval()
    torch.cuda.synchronize()

    collect_s, optimize_s = [], []
    for _ in range(3):
        dt, (state, samples) = wall(lambda: coll.collect(
            runner.rollout_state, runner.env_generator))
        runner.rollout_state = state
        collect_s.append(dt)
        dt, _ = wall(lambda: algo.optimize(samples, state.cum_steps))
        optimize_s.append(dt)

    n = 64
    dt_sample, batches = wall(lambda: [
        algo.replay.sample(batch_size, algo.generator)
        for _ in range(n)])
    dt_update, _ = wall(lambda: [algo.update(b) for b in batches])

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        dt_itr, _ = wall(runner.run_interval)
    # Device operations only: kernels, copies and sets.  User
    # annotations (e.g. Optimizer.step) also carry device time and
    # would count it twice.
    events = [e for e in prof.key_averages()
              if e.device_type == DeviceType.CUDA
              and not e.is_user_annotation]
    busy_us = sum(e.self_device_time_total for e in events)
    top = sorted(events, key=lambda e: e.self_device_time_total,
                 reverse=True)[:12]
    out_dir = Path("chiprun_out")
    out_dir.mkdir(exist_ok=True)
    (out_dir / f"profile_table{suffix}.txt").write_text(
        prof.key_averages().table(sort_by="self_device_time_total",
                                  row_limit=60))

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    print(smi.splitlines()[0])
    print(json.dumps({
        "device": torch.cuda.get_device_name(0),
        "trainer": suffix[1:] or "dqn",
        "env_steps_per_iteration": steps,
        "updates_per_iteration": algo.updates_per_optimize,
        "collect_ms": 1e3 * statistics.median(collect_s),
        "optimize_ms": 1e3 * statistics.median(optimize_s),
        "sample_ms_per_batch": 1e3 * dt_sample / n,
        "update_ms": 1e3 * dt_update / n,
        "profiled_iteration_ms": 1e3 * dt_itr,
        "device_busy_ms": busy_us / 1e3,
        "device_idle_share": 1.0 - busy_us / 1e6 / dt_itr,
        "device_ops": sum(e.count for e in events),
        "top_device_ops_ms": {e.key[:80]: e.self_device_time_total / 1e3
                              for e in top},
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
