#!/usr/bin/env python3
"""Env-steps/s of the MinAtar-Breakout DQN flagship on one NVIDIA GPU:
the PyTorch port's twin of bench.py:44-78.

    python3 bench_torch_minatar.py

The trainer is chip_smoke.py's ``build_minatar_runner``, with bench.py's
settings: one 3x3 conv of 16 and fc 128 (fp32), B=8192 lanes, T=32,
update batch 8192, flat uniform replay of 4M, replay ratio 1 (32 updates
an iteration), n-step 3, double DQN, 100 decorrelation steps.  A log
interval is one iteration (T*B = 262,144 env steps).

Each run builds a fresh runner, decorrelates, runs one warm-up interval
and then 10 timed ones; each timed interval ends with a device sync and
is timed on its own.  Three runs are made in one process because runs of
the same work have measured up to 2.4x apart (PERF.md, section 7).
Prints the card's name and power limit and one JSON line: the median
env-steps/s over every timed interval, and each run's median, min and
max.  Needs one CUDA device.
"""
from __future__ import annotations

import json
import statistics
import sys
import time
from pathlib import Path

import torch

RUNS, INTERVALS = 3, 10


def one_run(cs, dev, n_intervals: int):
    runner = cs.build_minatar_runner(dev, n_itr=n_intervals + 1)
    runner.startup()
    runner.run_interval()
    torch.cuda.synchronize()
    steps = runner.itrs_per_interval * runner.batch_spec.size
    sps = []
    for _ in range(n_intervals):
        t0 = time.perf_counter()
        runner.run_interval()
        torch.cuda.synchronize()
        sps.append(steps / (time.perf_counter() - t0))
    return sps


def main():
    if not torch.cuda.is_available():
        print("bench_torch_minatar: needs a CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(Path(__file__).resolve().parent))
    import chip_smoke as cs

    dev = torch.device("cuda")
    runs = []
    for _ in range(RUNS):
        runs.append(one_run(cs, dev, INTERVALS))
        torch.cuda.empty_cache()
    every = [s for run in runs for s in run]
    print(cs.nvidia_smi_line())
    print(json.dumps({
        "metric": "env-steps/s, MinAtar-Breakout DQN (bench.py:44-58 "
                  f"settings: B={cs.MINATAR_B}, T={cs.MINATAR_T}, update "
                  "batch 8192, replay 4M, replay ratio 1)",
        "value": statistics.median(every),
        "unit": "env-steps/s",
        "intervals_per_run": INTERVALS,
        "runs": [{"median": statistics.median(r), "min": min(r),
                  "max": max(r)} for r in runs],
        "min": min(every), "max": max(every),
        "device": torch.cuda.get_device_name(0),
        "gpu": cs.nvidia_smi_line(),
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
