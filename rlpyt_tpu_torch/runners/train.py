"""Training runners (port of rlpyt_tpu/runners/train.py: MinibatchRl,
with start-state decorrelation, a parameter snapshot and evaluation at
each log interval, and MinibatchRlEval).

The JAX runner compiles a whole log interval into one device program.
Here the loop runs on the host and launches work on the device; values
cross to the host only at the end of each log interval, when the
diagnostics are read.
"""
from __future__ import annotations

import math
import time
from typing import Optional

import torch

from rlpyt_tpu_torch.params import agent_params_to_jax
from rlpyt_tpu_torch.samplers.rollout import BatchSpec, Collector, TrajStats
from rlpyt_tpu_torch.utils.logging import TabularLogger

_TRAJ_KEYS = ("ReturnAverage", "ReturnStd", "ReturnMax", "ReturnMin",
              "LengthAverage", "NonzeroRewardsAverage",
              "DiscountedReturnAverage")


class MinibatchRl:
    """Collect a [T, B] batch, optimize, repeat.  With ``eval_env``, the
    agent is evaluated after every log interval on ``eval_n_envs`` fresh
    lanes for at most ``eval_max_steps`` env steps in all (and, if given,
    ``eval_max_trajectories`` completed episodes), and the "Eval" stats
    are logged with the interval's."""

    def __init__(self, algo, agent, env, batch_spec: BatchSpec,
                 n_steps: int, seed: int = 0,
                 log_interval_steps: int = int(1e5),
                 max_decorrelation_steps: int = 100, eval_env=None,
                 eval_n_envs: int = 8, eval_max_steps: int = 2500,
                 eval_max_trajectories: Optional[int] = None,
                 logger: Optional[TabularLogger] = None, device="cuda"):
        self.algo = algo
        self.agent = agent
        self.env = env
        self.batch_spec = batch_spec
        self.n_steps = int(n_steps)
        self.seed = seed
        self.log_interval_steps = int(log_interval_steps)
        self.max_decorrelation_steps = int(max_decorrelation_steps)
        self.eval_env = eval_env
        self.eval_n_envs = eval_n_envs
        self.eval_max_steps = eval_max_steps
        self.eval_max_trajectories = eval_max_trajectories
        self.logger = logger or TabularLogger(None)
        self.device = torch.device(device)
        self._last_traj_vals = {}   # stats prefix -> last values

    def startup(self):
        """Seed, build the model, collector and algorithm state, then
        decorrelate the lanes' start states."""
        torch.manual_seed(self.seed)   # model weights, drawn on the CPU
        gens = [torch.Generator(device=self.device).manual_seed(self.seed + i)
                for i in range(2)]
        self.env_generator, algo_generator = gens
        self.agent.initialize(self.env.spaces)
        self.collector = Collector(self.env, self.agent, self.batch_spec,
                                   discount=float(self.algo.discount))
        self.rollout_state = self.collector.init_state(self.env_generator)
        self.n_itr = max(1, math.ceil(self.n_steps / self.batch_spec.size))
        self.itrs_per_interval = max(
            1, self.log_interval_steps // self.batch_spec.size)
        self.algo.initialize(self.agent, self.batch_spec,
                             self.rollout_state.observation, algo_generator,
                             n_itr=self.n_itr)
        self.rollout_state = self.collector.decorrelate(
            self.rollout_state, self.max_decorrelation_steps,
            self.env_generator)
        if self.eval_env is not None:
            self.eval_T = max(1, self.eval_max_steps // self.eval_n_envs)
            self.eval_collector = Collector(
                self.eval_env, self.agent,
                BatchSpec(self.eval_T, self.eval_n_envs),
                discount=float(self.algo.discount))
            self.eval_generator = torch.Generator(
                device=self.device).manual_seed(self.seed + 1)

    def run_interval(self):
        """``itrs_per_interval`` iterations; returns (list of OptInfo,
        TrajStats of the interval)."""
        opt_infos = []
        for _ in range(self.itrs_per_interval):
            self.rollout_state, samples = self.collector.collect(
                self.rollout_state, self.env_generator)
            opt_infos.append(self.algo.optimize(samples,
                                                self.rollout_state))
        traj_stats = self.rollout_state.traj_stats
        self.rollout_state = self.collector.reset_traj_stats(
            self.rollout_state)
        return opt_infos, traj_stats

    def train(self):
        self.startup()
        steps_per_interval = self.itrs_per_interval * self.batch_spec.size
        n_intervals = max(1, math.ceil(self.n_itr / self.itrs_per_interval))
        self.logger.log(
            f"Training: {self.n_itr} itrs ({self.n_steps} steps), "
            f"{n_intervals} intervals x {self.itrs_per_interval} itrs")
        t_start = time.time()
        cum_steps = 0
        for interval in range(n_intervals):
            t0 = time.time()
            opt_infos, traj_stats = self.run_interval()
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
            t1 = time.time()
            cum_steps += steps_per_interval
            itr = (interval + 1) * self.itrs_per_interval
            self._log_diagnostics(itr, cum_steps, opt_infos, traj_stats,
                                  t1 - t0, t1 - t_start)
            if self.logger.snapshot_path(itr) is not None:
                self.logger.save_itr_params(itr, {
                    "params": agent_params_to_jax(self.agent), "itr": itr,
                    "cum_steps": cum_steps})
            if self.eval_env is not None:
                self._log_traj_stats("Eval", self.eval_collector.evaluate(
                    self.eval_generator, self.eval_T,
                    self.eval_max_trajectories))
            self.logger.dump_tabular()

    def _log_traj_stats(self, prefix: str, ts: TrajStats):
        n = int(ts.completed)
        rec = self.logger.record_tabular
        rec(prefix + "Trajs", n)
        if n > 0:
            mean = float(ts.sum_return) / n
            var = max(0.0, float(ts.sum_sq_return) / n - mean * mean)
            vals = (mean, var ** 0.5, float(ts.max_return),
                    float(ts.min_return), float(ts.sum_length) / n,
                    float(ts.sum_nonzero_rewards) / n,
                    float(ts.sum_discounted_return) / n)
            self._last_traj_vals[prefix] = vals
        else:
            # No episode ended in this window: repeat the last window's
            # stats (Trajs=0 marks it) rather than writing NaN rows.
            vals = self._last_traj_vals.get(
                prefix, (float("nan"),) * len(_TRAJ_KEYS))
        for k, v in zip(_TRAJ_KEYS, vals):
            rec(prefix + k, v)

    def _log_diagnostics(self, itr, cum_steps, opt_infos, traj_stats,
                         dt_interval, dt_total):
        rec = self.logger.record_tabular
        rec("Iteration", itr)
        rec("CumSteps", cum_steps)
        rec("CumTime (s)", dt_total)
        steps = self.itrs_per_interval * self.batch_spec.size
        rec("StepsPerSecond", steps / dt_interval)
        updates = self.itrs_per_interval * self.algo.updates_per_optimize
        rec("UpdatesPerSecond", updates / dt_interval)
        batch_size = getattr(self.algo, "batch_size", None)
        if batch_size:
            rec("ReplayRatio", updates * batch_size / steps)
        self._log_traj_stats("", traj_stats)
        for field, vals in zip(opt_infos[0]._fields, zip(*opt_infos)):
            rec(field, torch.stack(vals).mean().item())


class MinibatchRlEval(MinibatchRl):
    """MinibatchRl with evaluation, under the reference's class name;
    ``eval_env`` is required."""

    def __init__(self, *args, eval_env=None, **kwargs):
        if eval_env is None:
            raise ValueError("MinibatchRlEval requires eval_env")
        super().__init__(*args, eval_env=eval_env, **kwargs)
