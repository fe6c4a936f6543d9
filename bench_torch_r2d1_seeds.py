#!/usr/bin/env python3
"""The R2D1 learning twin on MinAtar Breakout
(tests/test_torch_learning_coverage.py:test_r2d1_learns_minatar_breakout)
at several seeds, on the card (the LSTM kernels K3a, K3, K4) or on the
CPU (their plain PyTorch versions).

    python3 bench_torch_r2d1_seeds.py [--seeds 0 1 2 3 4 5 6] \
        [--device cuda] [--threads 1]

Each seed trains in a process of its own, all started together, with the
twin's settings: R2d1Agent(AtariR2d1Model, conv 16 3x3, LSTM 128, eps
100k steps to 0.1), R2D1(batch 32 windows of 10 + 20 + 3 rows, learning
from 2000 steps, replay 100k, replay ratio 1, target every 500 updates,
n-step 3, lr 3e-4, double, prioritized alpha 0.6 beta 0.9),
MinibatchRl(BatchSpec(40, 32), 300k steps, intervals of 100k, ``seed``),
then a greedy evaluation over T=800, B=8 from a generator seeded 123.
Prints one JSON line per run (the evaluation's return an episode, which
the test holds above 1.5, the action the evaluation took most often and
its share of the 6400 steps, each interval's ReturnAverage, the LSTM
launches, the seconds) and one summary line.  ``--device cuda`` needs a
card.

    python3 bench_torch_r2d1_seeds.py --constant [--device cuda]

evaluates, by the same protocol, the twin's agent with its Q values made
constant (the dueling head's last layers zeroed, the advantage's bias one
at action a), for each of the 6 actions: what a policy that always takes
action a scores under the same evaluation draws (the agent's evaluation
epsilon included).
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

THRESHOLD = 1.5   # the test's bar on the greedy return an episode


def make_agent(device: str):
    from rlpyt_tpu_torch.agents.dqn import R2d1Agent
    from rlpyt_tpu_torch.models.dqn import AtariR2d1Model

    return R2d1Agent(
        ModelCls=AtariR2d1Model,
        model_kwargs=dict(channels=(16,), kernel_sizes=(3,), strides=(1,),
                          paddings=(0,), lstm_size=128),
        lstm_size=128, eps_steps=100_000, eps_final=0.1, device=device)


def evaluate(env, agent) -> dict:
    """The twin's greedy evaluation: T=800, B=8, generator seeded 123."""
    import torch

    from rlpyt_tpu_torch.samplers.rollout import BatchSpec, Collector

    col = Collector(env, agent, BatchSpec(T=800, B=8))
    g = torch.Generator(device=env.device).manual_seed(123)
    state, samples = col.collect(col.init_state(g), g, is_eval=True)
    ts = state.traj_stats
    counts = torch.bincount(samples.action.reshape(-1).cpu(), minlength=6)
    return {"eval_return": float(ts.sum_return) / max(int(ts.completed), 1),
            "episodes": int(ts.completed),
            "modal_action": int(counts.argmax()),
            "modal_share": float(counts.max()) / float(counts.sum())}


def constant_policies(device: str) -> list:
    """The twin's agent with Q made constant, preferring action a, for
    each a, evaluated as the trained agents are."""
    import torch

    from rlpyt_tpu_torch.envs.minatar import Breakout

    out = []
    for a in range(6):
        env = Breakout(device=device)
        agent = make_agent(device)
        agent.initialize(env.spaces)
        head = agent.model.head
        with torch.no_grad():
            for mlp in (head.adv, head.val):
                mlp.layers[-1].weight.zero_()
                mlp.layers[-1].bias.zero_()
            head.adv.layers[-1].bias[a] = 1.0
        out.append({"constant_action": a, **evaluate(env, agent)})
    return out


def run_one(seed: int, device: str, threads: int) -> dict:
    import torch

    from rlpyt_tpu_torch.algos.r2d1 import R2D1
    from rlpyt_tpu_torch.envs.minatar import Breakout
    from rlpyt_tpu_torch.runners.train import MinibatchRl
    from rlpyt_tpu_torch.samplers.rollout import BatchSpec
    from rlpyt_tpu_torch.utils import profiling

    torch.set_num_threads(threads)
    t0 = time.time()
    env = Breakout(device=device)
    agent = make_agent(device)
    algo = R2D1(discount=0.99, batch_b=32, batch_T=20, warmup_T=10,
                min_steps_learn=2_000, replay_size=100_000,
                replay_ratio=1.0, target_update_interval=500,
                n_step_return=3, learning_rate=3e-4, double_dqn=True,
                prioritized_replay=True, pri_alpha=0.6, pri_beta=0.9)
    runner = MinibatchRl(algo, agent, env, BatchSpec(T=40, B=32),
                         n_steps=300_000, seed=seed,
                         log_interval_steps=100_000, device=device)
    averages = []
    record = runner.logger.record_tabular

    def spy(key, value):
        if key == "ReturnAverage":
            averages.append(float(value))
        record(key, value)

    runner.logger.record_tabular = spy
    runner.logger.dump_tabular = lambda *a, **k: None
    with profiling.recording() as rec:
        runner.train()
        ev = evaluate(env, agent)
    return {"device": device, "seed": seed, **ev,
            "passes": ev["eval_return"] > THRESHOLD,
            "ReturnAverage": averages,
            "launches": {"K3a": rec.total("ops.input_proj"),
                         "K3": rec.total("ops.lstm_fwd"),
                         "step": rec.total("ops.lstm_step"),
                         "K4": rec.total("ops.lstm_bwd")},
            "seconds": round(time.time() - t0, 1)}


def main():
    p = argparse.ArgumentParser()
    p.add_argument("--seeds", type=int, nargs="+",
                   default=[0, 1, 2, 3, 4, 5, 6])
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    p.add_argument("--threads", type=int, default=1,
                   help="torch threads of each run")
    p.add_argument("--constant", action="store_true",
                   help="evaluate the six constant-action policies")
    p.add_argument("--one", type=int, metavar="SEED")
    args = p.parse_args()
    if args.one is not None:
        print(json.dumps(run_one(args.one, args.device, args.threads)))
        return 0
    import torch
    if args.device == "cuda" and not torch.cuda.is_available():
        print("bench_torch_r2d1_seeds: needs a CUDA device", file=sys.stderr)
        return 1
    if args.constant:
        for line in constant_policies(args.device):
            print(json.dumps({"device": args.device, **line}))
        return 0
    here = str(Path(__file__).resolve())
    procs = [(seed, subprocess.Popen(
        [sys.executable, here, "--one", str(seed), "--device", args.device,
         "--threads", str(args.threads)], stdout=subprocess.PIPE, text=True))
        for seed in args.seeds]
    results = []
    for seed, proc in procs:
        out, _ = proc.communicate()
        if proc.returncode != 0:
            print(f"bench_torch_r2d1_seeds: seed {seed} failed",
                  file=sys.stderr)
            return 1
        line = out.strip().splitlines()[-1]
        print(line)
        results.append(json.loads(line))
    returns = [r["eval_return"] for r in results]
    device = (torch.cuda.get_device_name(0) if args.device == "cuda"
              else "cpu")
    print(json.dumps({"device": device, "seeds": args.seeds,
                      "eval_returns": returns,
                      "mean": sum(returns) / len(returns),
                      "below_threshold": sum(not r["passes"]
                                             for r in results)}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
