#!/usr/bin/env python3
"""The dict-observation DQN learning twin
(tests/test_torch_dqn_learning.py:test_dict_obs_dqn_learns) at several
seeds, beside the same settings on the vector CartPole, on one card.

    python3 bench_torch_dqn_seeds.py [--seeds 0 1 2] [--kinds dict vector]

Kinds: ``dict`` (DictObsCartPole), ``vector`` (CartPole, features x,
x_dot, theta, theta_dot) and ``leaf_order`` (CartPole with its features
in the dict's sorted leaf order, x, theta, x_dot, theta_dot: the same
network input as ``dict``, through the vector path).  Each (kind, seed)
trains in a process of its own, all started together:
DqnAgent(DqnMlpModel, hidden (256, 256), eps 50k steps to 0.02),
DQN(batch 128, learning from 1000 steps, replay 50k, replay ratio 8,
target every 300 updates, lr 1e-3), MinibatchRl(BatchSpec(32, 16), 80k
steps, intervals of 20k, ``seed``).  Prints one JSON line per run
with ``ReturnAverage`` by interval (the test's verdict reads the last
one against 120) and one summary line.  Needs a CUDA device.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

THRESHOLD = 120.0   # the test's bar on the last interval's ReturnAverage


def leaf_order_cartpole():
    """CartPole whose observation is [x, theta, x_dot, theta_dot]."""
    import torch

    from rlpyt_tpu_torch.envs.classic import CartPole
    from rlpyt_tpu_torch.spaces import FloatBox

    class LeafOrderCartPole(CartPole):
        @property
        def observation_space(self):
            high = [self.x_threshold * 2, self.theta_threshold * 2, 3.0e2,
                    3.0e2]
            return FloatBox(low=[-h for h in high], high=high, shape=(4,))

        @staticmethod
        def _obs(s):
            return torch.stack([s.x, s.theta, s.x_dot, s.theta_dot], dim=-1)

    return LeafOrderCartPole()


def run_one(kind: str, seed: int) -> dict:
    import torch

    from rlpyt_tpu_torch.agents.dqn import DqnAgent
    from rlpyt_tpu_torch.algos.dqn import DQN
    from rlpyt_tpu_torch.envs.classic import CartPole, DictObsCartPole
    from rlpyt_tpu_torch.models.dqn import DqnMlpModel
    from rlpyt_tpu_torch.runners.train import MinibatchRl
    from rlpyt_tpu_torch.samplers.rollout import BatchSpec

    torch.set_num_threads(1)
    t0 = time.time()
    agent = DqnAgent(ModelCls=DqnMlpModel,
                     model_kwargs={"hidden_sizes": (256, 256)},
                     eps_steps=50_000, eps_final=0.02)
    algo = DQN(batch_size=128, min_steps_learn=1_000, replay_size=50_000,
               replay_ratio=8.0, target_update_interval=300,
               learning_rate=1e-3)
    env = {"dict": DictObsCartPole, "vector": CartPole,
           "leaf_order": leaf_order_cartpole}[kind]()
    runner = MinibatchRl(algo=algo, agent=agent, env=env,
                         batch_spec=BatchSpec(32, 16), n_steps=80_000,
                         seed=seed, log_interval_steps=20_000)
    averages = []
    record = runner.logger.record_tabular

    def spy(key, value):
        if key == "ReturnAverage":
            averages.append(float(value))
        record(key, value)

    runner.logger.record_tabular = spy
    runner.logger.dump_tabular = lambda *a, **k: None
    runner.train()
    return {"obs": kind, "seed": seed, "ReturnAverage": averages,
            "passes": averages[-1] > THRESHOLD,
            "seconds": round(time.time() - t0, 1)}


def main():
    p = argparse.ArgumentParser()
    p.add_argument("--seeds", type=int, nargs="+", default=[0, 1, 2])
    p.add_argument("--kinds", nargs="+", default=["dict", "vector"],
                   choices=["dict", "vector", "leaf_order"])
    p.add_argument("--one", nargs=2, metavar=("KIND", "SEED"))
    args = p.parse_args()
    if args.one:
        print(json.dumps(run_one(args.one[0], int(args.one[1]))))
        return 0
    import torch
    if not torch.cuda.is_available():
        print("bench_torch_dqn_seeds: needs a CUDA device", file=sys.stderr)
        return 1
    here = str(Path(__file__).resolve())
    procs = [(kind, seed, subprocess.Popen(
        [sys.executable, here, "--one", kind, str(seed)],
        stdout=subprocess.PIPE, text=True))
        for kind in args.kinds for seed in args.seeds]
    results = []
    for kind, seed, proc in procs:
        out, _ = proc.communicate()
        if proc.returncode != 0:
            print(f"bench_torch_dqn_seeds: {kind} seed {seed} failed",
                  file=sys.stderr)
            return 1
        line = out.strip().splitlines()[-1]
        print(line)
        results.append(json.loads(line))
    last = {(r["obs"], r["seed"]): r["ReturnAverage"][-1] for r in results}
    summary = {"last_ReturnAverage": {f"{k}_{s}": v for (k, s), v
                                      in sorted(last.items())}}
    runs = {(r["obs"], r["seed"]): r["ReturnAverage"] for r in results}
    if {"dict", "vector"} <= set(args.kinds):
        summary["dict_below_vector_at_every_seed"] = all(
            last[("dict", s)] < last[("vector", s)] for s in args.seeds)
    if {"dict", "leaf_order"} <= set(args.kinds):
        summary["dict_equals_leaf_order_at_every_seed"] = all(
            runs[("dict", s)] == runs[("leaf_order", s)]
            for s in args.seeds)
    print(json.dumps(summary))
    return 0


if __name__ == "__main__":
    sys.exit(main())
