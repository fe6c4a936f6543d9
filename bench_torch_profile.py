#!/usr/bin/env python3
"""Where the PyTorch port's trainers spend their time on one NVIDIA GPU
(the port's counterpart of bench_profile.py).

    python3 bench_torch_profile.py           # flagship Nature-CNN DQN
    python3 bench_torch_profile.py --r2d1    # Atari-geometry R2D1
    python3 bench_torch_profile.py --ernbw   # Atari "ernbw" (C51, dueling,
                                             # prioritized replay, n-step 3)
    python3 bench_torch_profile.py --minatar # MinAtar-Breakout DQN of
                                             # bench.py (B=8192, flat replay)
    python3 bench_torch_profile.py --minatar-pg lstm_ppo
                     # a config of experiments/configs/minatar_pg.py
                     # (a2c, ppo, lstm_a2c, lstm_ppo) at its widths
    python3 bench_torch_profile.py --sac-hopper
                     # SAC on Hopper2D at full width (B=32, T=32, 256
                     # updates an iteration)
    python3 bench_torch_profile.py --minatar-dqn r2d1
                     # a config of experiments/configs/minatar_dqn.py
                     # (dqn, dqn_pub, ernbw, ernbw_vec, r2d1) at its widths
    python3 bench_torch_profile.py --atari-host dqn
                     # a config of experiments/configs/atari_dqn.py
                     # (dqn, ernbw, r2d1) on the host path at its widths

Builds the trainer of chip_smoke.py (full width; the Atari trainers in
bf16, MinAtar in fp32), warms it up (DQN, ernbw and MinAtar: two
iterations, MinAtar after its 100 decorrelation steps; R2D1: three, the
third being the first with updates), then measures:
  - host wall time of one iteration split into collect and optimize,
    each ended by a device sync (median of 3);
  - host wall time per replay sample (DQN and ernbw: sample_idxs +
    extract_batch, including the frame-gather kernel, for ernbw also
    the prioritized draw; MinAtar: the same on flat rows, no kernel;
    R2D1: sample_idxs + extract_window) and per
    gradient update (R2D1 and ernbw: including the priority write-back);
  - a torch.profiler trace of one iteration: device busy time (sum of
    kernel, copy and set times), the idle share of the iteration's wall
    time under the profiler, the number of device operations, and the
    top device operations by time.
Prints one JSON line; the profiler table goes to
chiprun_out/profile_table[_r2d1|_ernbw].txt.  Needs a CUDA device.
With --minatar the table is profile_table_minatar.txt, beside them.
With --minatar-pg CONFIG (after its 100 decorrelation steps and two
iterations) there is no replay: collect and optimize are timed as above,
``update_ms`` is the optimize time over its updates (16 for PPO), one
evaluation (32 lanes, at most 100 episodes) is timed as ``eval_ms`` with
the episodes it completed, and the table is profile_table_minatar_pg_CONFIG.txt.
With --sac-hopper (after its 100 decorrelation steps and two iterations,
the second the first with updates) the replay sample and the update are
timed as for DQN, ``env_step_ms`` is one Hopper2D step of the 32 lanes
(16 physics substeps) with a device sync, and the table is
profile_table_sac_hopper.txt.
With --minatar-dqn CONFIG (after its 100 decorrelation steps and the
iterations up to the first with updates, at the config's min_steps_learn
of 5000) the replay sample and the update are timed as for DQN (R2D1:
as for --r2d1), one evaluation as for --minatar-pg, and the table is
profile_table_minatar_dqn_CONFIG.txt.
With --atari-host CONFIG the trainer is experiments/scripts/atari_dqn.py's
on FakeALE, its 32 envs in a spawned farm with the C barrier, with
chip_smoke.py phase 15's cuts of min_steps_learn and the evaluation caps;
after the iterations up to the first with updates, three iterations are
timed as above, with each farm step timed inside the collection
(``farm_step_ms``; ``collect_step_rest_ms`` is the rest of a collection
step: inputs to the card, the agent step, the actions back), one step's
observations copied from pinned memory to the card alone (``h2d_obs_ms``,
median of 20, synced), ``update_ms`` the optimize time over its updates,
one evaluation as ``eval_ms``, and the table is
profile_table_atari_host_CONFIG.txt.
"""
from __future__ import annotations

import json
import math
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


def profile_iteration(run, suffix: str) -> dict:
    """One call of ``run`` under torch.profiler: its wall time, the device
    busy time, idle share and operations, the top operations; the table
    goes to chiprun_out/profile_table{suffix}.txt."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        dt_itr, _ = wall(run)
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
    return {
        "profiled_iteration_ms": 1e3 * dt_itr,
        "device_busy_ms": busy_us / 1e3,
        "device_idle_share": 1.0 - busy_us / 1e6 / dt_itr,
        "device_ops": sum(e.count for e in events),
        "top_device_ops_ms": {e.key[:80]: e.self_device_time_total / 1e3
                              for e in top},
    }


def smi_line() -> str:
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    return smi.splitlines()[0]


def profile_atari_host(key: str, dev) -> dict:
    """--atari-host CONFIG: the host-path trainer of atari_dqn.py."""
    import chip_smoke as cs
    from rlpyt_tpu_torch.experiments.configs.atari_dqn import configs
    from rlpyt_tpu_torch.experiments.scripts.atari_dqn import build_runner

    T = configs[key]["sampler"]["batch_T"]
    steps = T * cs.AT_B
    runner, _ = build_runner(key, config_overrides={
        "env": {"fake": True}, "eval_env": {"fake": True},
        "runner": {"log_interval_steps": steps},
        "algo": {"min_steps_learn": cs.AT_LEARN[key]},
        "sampler": dict(cs.AT_EVAL_CUT)})
    try:
        runner.startup()
        algo = runner.algo

        def iteration():
            samples, rollout_state = runner._collect_batch()
            return algo.optimize(samples, rollout_state)

        for _ in range(math.ceil(cs.AT_LEARN[key] / steps)):
            iteration()
        torch.cuda.synchronize()
        farm_step = runner.vec.step
        farm_s = [0.0]

        def timed_step(actions):
            t0 = time.perf_counter()
            out = farm_step(actions)
            farm_s[0] += time.perf_counter() - t0
            return out

        runner.vec.step = timed_step
        collect_s, optimize_s = [], []
        for _ in range(3):
            dt, (samples, state) = wall(runner._collect_batch)
            collect_s.append(dt)
            dt, _ = wall(lambda: algo.optimize(samples, state))
            optimize_s.append(dt)
        farm_ms = 1e3 * farm_s[0] / (3 * T)
        obs = torch.from_numpy(runner.vec.obs.copy()).pin_memory()
        h2d = [wall(lambda: obs.to(dev, non_blocking=True))[0]
               for _ in range(20)]
        dt_eval, eps = wall(runner._evaluate)
        out = {
            "trainer": f"atari_host_{key}",
            "farm": f"{runner.vec.start_method}, {runner.vec.sync_impl}",
            "env_steps_per_iteration": steps,
            "updates_per_iteration": algo.updates_per_optimize,
            "collect_ms": 1e3 * statistics.median(collect_s),
            "optimize_ms": 1e3 * statistics.median(optimize_s),
            "farm_step_ms": farm_ms,
            "collect_step_rest_ms": (1e3 * statistics.median(collect_s) / T
                                     - farm_ms),
            "h2d_obs_ms": 1e3 * statistics.median(h2d),
            "h2d_obs_bytes": obs.numel(),
            "update_ms": (1e3 * statistics.median(optimize_s)
                          / algo.updates_per_optimize),
            "eval_ms": 1e3 * dt_eval, "eval_trajectories": len(eps),
        }
        out.update(profile_iteration(iteration, f"_atari_host_{key}"))
        return out
    finally:
        runner.vec.close()
        runner.eval_vec.close()


def main():
    if not torch.cuda.is_available():
        print("bench_torch_profile: needs a CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(Path(__file__).resolve().parent))
    import chip_smoke as cs

    dev = torch.device("cuda")
    if "--atari-host" in sys.argv[1:]:
        out = profile_atari_host(
            sys.argv[sys.argv.index("--atari-host") + 1], dev)
        print(smi_line())
        print(json.dumps({"device": torch.cuda.get_device_name(0), **out}))
        return 0
    r2d1 = "--r2d1" in sys.argv[1:]
    ernbw = "--ernbw" in sys.argv[1:]
    pg = sys.argv[sys.argv.index("--minatar-pg") + 1] \
        if "--minatar-pg" in sys.argv[1:] else None
    dqn_cfg = sys.argv[sys.argv.index("--minatar-dqn") + 1] \
        if "--minatar-dqn" in sys.argv[1:] else None
    if dqn_cfg is not None:
        from rlpyt_tpu_torch.experiments.configs.minatar_dqn import configs
        from rlpyt_tpu_torch.experiments.scripts.minatar_dqn import \
            build_runner

        cfg = configs[dqn_cfg]
        steps = cfg["sampler"]["batch_T"] * cfg["sampler"]["batch_B"]
        runner, _ = build_runner(dqn_cfg, device=dev, config_overrides={
            "runner": {"log_interval_steps": steps}})
        warmup = math.ceil(cfg["algo"]["min_steps_learn"] / steps)
        suffix = f"_minatar_dqn_{dqn_cfg}"
    elif pg is not None:
        from rlpyt_tpu_torch.experiments.configs.minatar_pg import configs
        from rlpyt_tpu_torch.experiments.scripts.minatar_pg import \
            build_runner

        sampler = configs[pg]["sampler"]
        steps = sampler["batch_T"] * sampler["batch_B"]
        runner, _ = build_runner(pg, device=dev, config_overrides={
            "runner": {"log_interval_steps": steps}})
        warmup, suffix = 2, f"_minatar_pg_{pg}"
    elif "--sac-hopper" in sys.argv[1:]:
        runner = cs.build_sac_hopper_runner(dev, n_itr=10)
        steps, warmup, suffix = cs.SAC_T * cs.SAC_B, 2, "_sac_hopper"
    elif "--minatar" in sys.argv[1:]:
        runner = cs.build_minatar_runner(dev, n_itr=10)
        steps, warmup, suffix = cs.MINATAR_T * cs.MINATAR_B, 2, "_minatar"
    elif r2d1:
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
    for _ in range(warmup):
        runner.run_interval()
    torch.cuda.synchronize()

    collect_s, optimize_s = [], []
    for _ in range(3):
        dt, (state, samples) = wall(lambda: coll.collect(
            runner.rollout_state, runner.env_generator))
        runner.rollout_state = state
        collect_s.append(dt)
        dt, _ = wall(lambda: algo.optimize(samples, state))
        optimize_s.append(dt)

    extra = {}
    if pg is None:
        n = 64
        batch_size = getattr(algo, "batch_b", None) or algo.batch_size
        dt_sample, batches = wall(lambda: [
            algo.replay.sample(batch_size, algo.generator)
            for _ in range(n)])
        dt_update, _ = wall(lambda: [algo.update(b) for b in batches])
        extra.update(sample_ms_per_batch=1e3 * dt_sample / n,
                     update_ms=1e3 * dt_update / n)
        if suffix == "_sac_hopper":
            env = runner.env
            state = runner.rollout_state.env_state
            action = torch.zeros((cs.SAC_B, env.na), device=dev)
            dt_env, _ = wall(lambda: [env.step_batch(state, action)
                                      for _ in range(20)])
            extra["env_step_ms"] = 1e3 * dt_env / 20
    else:
        extra["update_ms"] = (1e3 * statistics.median(optimize_s)
                              / algo.updates_per_optimize)
    if runner.eval_env is not None:
        dt_eval, stats = wall(lambda: runner.eval_collector.evaluate(
            runner.eval_generator, runner.eval_T,
            runner.eval_max_trajectories))
        extra.update(eval_ms=1e3 * dt_eval,
                     eval_trajectories=int(stats.completed))

    prof = profile_iteration(runner.run_interval, suffix)
    print(smi_line())
    print(json.dumps({
        "device": torch.cuda.get_device_name(0),
        "trainer": suffix[1:] or "dqn",
        "env_steps_per_iteration": steps,
        "updates_per_iteration": algo.updates_per_optimize,
        "collect_ms": 1e3 * statistics.median(collect_s),
        "optimize_ms": 1e3 * statistics.median(optimize_s),
        **extra, **prof,
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
