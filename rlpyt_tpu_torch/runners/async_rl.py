"""Pipelined runner (port of rlpyt_tpu/runners/async_rl.py: AsyncRl and
AsyncRlEval).

The reference decouples acting from learning with sampler, memory-copier
and optimizer processes.  On one device the JAX package keeps two of its
effects, and so does this port:

1. **The throttle.**  ``updates_per_interval`` sets the learner's update
   count per log interval outright, in place of the replay-ratio
   arithmetic: ``updates_per_optimize = max(1, updates_per_interval //
   itrs_per_interval)``.
2. **The pipeline.**  The host enqueues interval k+1 before it reads
   interval k's diagnostics.  Each interval's ``OptInfo`` tensors and
   trajectory stats are kept with a CUDA event recorded after its work
   (and its evaluation); at drain time the host waits on that event, not
   on the whole device, and only then reads the values.  At most
   ``pipeline_depth`` intervals are undrained at once.  The overlap is
   real only where nothing in collect or optimize reads a value back to
   the host; every such read stalls the host until the device catches
   up.

Evaluation runs against interval k's own parameters: it is enqueued
right after interval k, on the same stream, so it executes before
interval k+1 updates the parameters in place.  ``Collector.evaluate``
with ``eval_max_trajectories`` reads the completed count every
``EVAL_CHECK_STEPS`` steps, so an evaluation with a cap syncs the host.

A checkpoint drains the pipeline (so the logged-stats state it holds is
that of its interval) and syncs; it is taken every ``checkpoint_every``
intervals (default ``4 * pipeline_depth``) and once at the end.  No
parameter snapshot is written, as in the JAX package.
"""
from __future__ import annotations

import math
import time
from collections import deque
from typing import Any, NamedTuple, Optional

import torch

from rlpyt_tpu_torch.runners.train import MinibatchRl


class _Pending(NamedTuple):
    interval: int
    opt_infos: list
    traj_stats: Any
    eval_stats: Any
    t0: float
    event: Optional[torch.cuda.Event]


class AsyncRl(MinibatchRl):
    """MinibatchRl with an explicit update throttle and a pipeline of
    ``pipeline_depth`` intervals between enqueue and drain."""

    def __init__(self, *args, updates_per_interval: Optional[int] = None,
                 pipeline_depth: int = 2,
                 checkpoint_every: Optional[int] = None, **kwargs):
        super().__init__(*args, **kwargs)
        self.updates_per_interval = updates_per_interval
        self.pipeline_depth = max(1, pipeline_depth)
        self.checkpoint_every = (checkpoint_every if checkpoint_every
                                 is not None else 4 * self.pipeline_depth)

    def startup(self):
        super().startup()
        if self.updates_per_interval is not None:
            self.algo.updates_per_optimize = max(
                1, self.updates_per_interval // self.itrs_per_interval)

    def _record_event(self) -> Optional[torch.cuda.Event]:
        if self.device.type != "cuda":
            return None
        event = torch.cuda.Event()
        event.record()
        return event

    def _drain(self, p: _Pending, t_start: float, steps_per_interval: int):
        """Wait for interval ``p``'s work, then log it."""
        if p.event is not None:
            p.event.synchronize()
        t1 = time.time()
        self._log_diagnostics((p.interval + 1) * self.itrs_per_interval,
                              (p.interval + 1) * steps_per_interval,
                              p.opt_infos, p.traj_stats, t1 - p.t0,
                              t1 - t_start)
        if p.eval_stats is not None:
            self._log_traj_stats("Eval", p.eval_stats)
        self.logger.dump_tabular()

    def train(self, resume_from: Optional[str] = None) -> dict:
        """Run to ``n_steps`` (from the checkpoint ``resume_from`` if
        given); returns ``state_dict()``."""
        self.startup()
        steps_per_interval = self.itrs_per_interval * self.batch_spec.size
        n_intervals = max(1, math.ceil(self.n_itr / self.itrs_per_interval))
        start_interval = (0 if resume_from is None
                          else self._resume(resume_from))
        self.logger.log(
            f"Async training: {n_intervals} intervals x "
            f"{self.itrs_per_interval} itrs, pipeline depth "
            f"{self.pipeline_depth}")
        t_start = time.time()
        in_flight: deque = deque()
        for interval in range(start_interval, n_intervals):
            t0 = time.time()
            opt_infos, traj_stats = self.run_interval()
            eval_stats = (self.run_eval() if self.eval_env is not None
                          else None)
            in_flight.append(_Pending(interval, opt_infos, traj_stats,
                                      eval_stats, t0, self._record_event()))
            last = interval == n_intervals - 1
            checkpoint = (self.checkpoint_dir is not None
                          and self.checkpoint_every and not last
                          and (interval + 1) % self.checkpoint_every == 0)
            while in_flight and (len(in_flight) >= self.pipeline_depth
                                 or last or checkpoint):
                self._drain(in_flight.popleft(), t_start,
                            steps_per_interval)
            if checkpoint:
                self.save_checkpoint(interval + 1,
                                     (interval + 1) * steps_per_interval,
                                     (interval + 1) * self.itrs_per_interval)
        if self.checkpoint_dir is not None:
            self.save_checkpoint(n_intervals,
                                 n_intervals * steps_per_interval,
                                 n_intervals * self.itrs_per_interval)
        return self.state_dict()


class AsyncRlEval(AsyncRl):
    """AsyncRl with evaluation, under the reference's class name;
    ``eval_env`` is required."""

    def __init__(self, *args, eval_env=None, **kwargs):
        if eval_env is None:
            raise ValueError("AsyncRlEval requires eval_env")
        super().__init__(*args, eval_env=eval_env, **kwargs)
