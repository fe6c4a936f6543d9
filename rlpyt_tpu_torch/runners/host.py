"""Host-env training runners (port of rlpyt_tpu/runners/host.py;
reference: rlpyt/samplers/parallel/gpu/sampler.py:GpuSampler with
action_server.py:ActionServer.serve_actions, rlpyt/runners/
minibatch_rl.py for the loop, rlpyt/runners/async_rl.py:AsyncRl).

Envs that live on the host (ALE, gymnasium) are stepped by a farm of
``envs/host.py`` while the card runs one batched ``agent.step`` a
timestep: rlpyt's GPU action-server topology.  A step moves two things:
the observations to the card (copied out of the farm's shared block
into pinned memory first, since the next farm step overwrites the
block) and the actions back, which is the one sync a step the design
needs.  The rest of the batch (actions, rewards, dones, infos) is
recorded on the host and moved once a batch, when ``Samples`` is built
on the card; ``algo.optimize`` then consumes it as on the tensor-env
path, so every algorithm of the port runs on host envs unchanged.

- ``HostMinibatchRl``: collect [T, B], optimize, repeat.  Over a
  ``PairedVecEnv`` it collects alternating halves: one half's inference
  is launched, its actions copied to pinned memory behind an event, the
  other half's envs step meanwhile, then the event is waited on
  (rlpyt's AlternatingSampler); a recurrent agent keeps a carry bank
  per half.
- ``AsyncHostRl``: a learner thread optimizes on its own CUDA stream
  while the main thread collects with its own copy of the model on
  another stream (rlpyt's AsyncRl); the actor's parameters lag the
  learner's by at most two batches.
"""
from __future__ import annotations

import collections
import contextlib
import copy
import itertools
import math
import queue
import threading
import time
from typing import Any, Dict, NamedTuple, Optional

import numpy as np
import torch

from rlpyt_tpu_torch.envs.host import PairedVecEnv, null_numpy, tmap
from rlpyt_tpu_torch.samplers.rollout import BatchSpec, Samples
from rlpyt_tpu_torch.struct import tree_map
from rlpyt_tpu_torch.utils.logging import TabularLogger
from rlpyt_tpu_torch.utils.profiling import span, spanned


class _TrajAccum:
    """Per-lane trajectory sums on the host (rlpyt samplers/
    collections.py:TrajInfo ~L40: Length, Return, NonzeroRewards,
    DiscountedReturn; AtariTrajInfo's GameScore).

    A trajectory completes on ``traj_done`` (game over), not on ``done``:
    under episodic lives a life-loss done cuts bootstrapping and resets
    the rnn state, but the trajectory goes on across lives, as rlpyt's
    collectors end a TrajInfo only on ``env_info.traj_done``."""

    KEYS = ("Return", "Length", "NonzeroRewards", "DiscountedReturn",
            "GameScore")

    def __init__(self, B: int, discount: float = 1.0):
        self.discount = float(discount)
        self.ret = np.zeros((B,), np.float64)
        self.length = np.zeros((B,), np.int64)
        self.nonzero = np.zeros((B,), np.int64)
        self.disc_ret = np.zeros((B,), np.float64)
        self.cur_disc = np.ones((B,), np.float64)
        self.score = np.zeros((B,), np.float64)
        self.window: list = []

    def step(self, sl: slice, rew, done, info: Dict[str, np.ndarray]):
        """Accumulate one timestep of lanes [sl]; ``rew``, ``done`` and
        the info arrays are those lanes'."""
        rew = np.asarray(rew)
        done = np.asarray(done)
        self.ret[sl] += rew
        self.disc_ret[sl] += self.cur_disc[sl] * rew
        self.cur_disc[sl] *= self.discount
        self.length[sl] += 1
        self.nonzero[sl] += rew != 0
        score = (np.asarray(info["game_score"], np.float64)
                 if "game_score" in info else rew)
        self.score[sl] += score
        traj_done = (np.asarray(info["traj_done"])
                     if "traj_done" in info else done)
        base = sl.start or 0
        for b in np.nonzero(traj_done)[0]:
            g = base + b
            self.window.append((self.ret[g], self.length[g],
                                self.nonzero[g], self.disc_ret[g],
                                self.score[g]))
            self.ret[g] = self.length[g] = self.nonzero[g] = 0
            self.disc_ret[g] = self.score[g] = 0.0
            self.cur_disc[g] = 1.0

    def pop(self) -> list:
        w = self.window
        self.window = []
        return w


def _log_window(rec, prefix: str, window: list, has_score: bool,
                last: dict = None):
    """rlpyt's TrajInfo columns (runners/minibatch_rl.py:log_diagnostics
    ~L250).  ``last``: the caller's cache; an empty window (no episode
    ended in the interval) repeats the last window's values, with
    Trajs = 0 marking it, instead of NaN."""
    rec(prefix + "Trajs", len(window))
    keys = [("ReturnAverage", 0, np.mean), ("ReturnStd", 0, np.std),
            ("ReturnMax", 0, np.max),
            ("ReturnMin", 0, np.min), ("LengthAverage", 1, np.mean),
            ("NonzeroRewardsAverage", 2, np.mean),
            ("DiscountedReturnAverage", 3, np.mean)]
    if has_score:
        keys += [("GameScoreAverage", 4, np.mean),
                 ("GameScoreMax", 4, np.max)]
    if window:
        vals = {name: float(fn([x[i] for x in window]))
                for name, i, fn in keys}
        if last is not None:
            last[prefix] = vals
    else:
        vals = (last or {}).get(
            prefix, {name: float("nan") for name, _, _ in keys})
    for name, _, _ in keys:
        rec(prefix + name, vals[name])


class HostRolloutState(NamedTuple):
    """The collection frontier as the algorithms read it: the bootstrap
    observation and carry on the card, and ``cum_steps`` (a host
    integer, as in samplers/rollout.py:RolloutState)."""

    observation: Any
    prev_action: torch.Tensor
    prev_reward: torch.Tensor
    agent_carry: Any
    cum_steps: int


def _stack(trees, dim: int = 0):
    """Stack a list of device trees leafwise."""
    return tree_map(lambda *xs: torch.stack(xs, dim), *trees)


def _cat(trees, dim: int = 0):
    """Concatenate a list of trees leafwise; a list of one is its tree,
    uncopied."""
    if len(trees) == 1:
        return trees[0]
    return tree_map(lambda *xs: torch.cat(xs, dim), *trees)


class _Half:
    """The host records of one farm (or half of a paired farm) over a
    batch: [T, B_h] buffers, pinned when the runner's device is CUDA,
    with their numpy views for the writes.  Made once and rewritten every
    batch."""

    def __init__(self, runner, vec, T: int):
        B = vec.B
        self.vec = vec

        def buf(example):
            x = np.asarray(example)
            t = torch.empty((T, B) + x.shape,
                            dtype=torch.from_numpy(x.copy()).dtype,
                            pin_memory=runner._pin)
            return t, t.numpy()

        obs_null = null_numpy(vec.spaces.observation)
        self.obs = tmap(buf, obs_null)
        self.act = buf(runner._act_null)
        self.pa = buf(runner._act_null)
        self.rew = buf(np.float32(0))
        self.pr = buf(np.float32(0))
        self.done = buf(np.bool_(False))
        self.to = buf(np.bool_(False))
        self.info = {k: buf(v[0]) for k, v in getattr(vec, "info",
                                                      {}).items()}

    def record(self, t, obs, prev_a, prev_r):
        """Snapshot of the step's inputs (before the farm overwrites
        them)."""
        tmap(lambda dst, src: np.copyto(dst[1][t], src), self.obs, obs)
        self.pa[1][t] = prev_a
        self.pr[1][t] = prev_r

    def record_env(self, t, rew, done, timeout):
        self.rew[1][t] = rew
        self.done[1][t] = done
        self.to[1][t] = timeout
        for k, v in getattr(self.vec, "info", {}).items():
            self.info[k][1][t] = v


class HostMinibatchRl:
    """Collect [T, B] batches from a host vec env; optimize on the card
    (``device``: "cuda" by default, "cpu" for tests)."""

    def __init__(self, algo, agent, vec_env, batch_T: int, n_steps: int,
                 seed: int = 0, log_interval_steps: int = int(1e5),
                 logger: Optional[TabularLogger] = None,
                 eval_vec_env=None, eval_max_steps: int = 2_500,
                 eval_max_trajectories: Optional[int] = None,
                 device="cuda"):
        self.algo = algo
        self.agent = agent
        self.vec = vec_env
        self.batch_spec = BatchSpec(batch_T, vec_env.B)
        self.n_steps = int(n_steps)
        self.seed = seed
        self.log_interval_steps = int(log_interval_steps)
        self.logger = logger or TabularLogger(None)
        self.eval_vec = eval_vec_env
        self.eval_max_steps = eval_max_steps
        self.eval_max_trajectories = eval_max_trajectories
        self.device = torch.device(device)
        # Where the actor's inputs and outputs live (AsyncHostRl may put
        # the actor elsewhere); host buffers are pinned when on CUDA.
        self._actor_device = self.device

    # ------------------------------------------------------------------

    def startup(self):
        """Seed, build the model, reset the farm, initialize the
        algorithm.  Weights are drawn on the CPU from ``seed``, so one
        seed gives one set of weights on any device."""
        torch.manual_seed(self.seed)
        gen = [torch.Generator(device=self.device).manual_seed(self.seed + i)
               for i in range(3)]
        # Evaluation draws from a generator of its own, so it never moves
        # the training stream.
        self.actor_generator, algo_generator, self.eval_generator = gen
        self.agent.initialize(self.vec.spaces)
        self._pin = self._actor_device.type == "cuda"
        self._act_null = null_numpy(self.vec.spaces.action)
        B = self.batch_spec.B
        obs0 = tmap(lambda x: x.to(self.device),
                    self._to_device(self.vec.reset()))
        # The farm's halves: a paired farm's two, stepped out of phase, or
        # the farm itself; each has its lanes, its records and its carry
        # bank.  A batch rewrites the records only once the copies of the
        # batch before out of them have landed (``_recs_free``).
        self._halves = (self.vec.halves if isinstance(self.vec, PairedVecEnv)
                        else (self.vec,))
        edges = list(itertools.accumulate((h.B for h in self._halves),
                                          initial=0))
        self._slices = [slice(a, b) for a, b in zip(edges, edges[1:])]
        self._recs = [_Half(self, h, self.batch_spec.T) for h in self._halves]
        self._recs_free = None
        self.n_itr = max(1, math.ceil(self.n_steps / self.batch_spec.size))
        self.itrs_per_interval = max(
            1, self.log_interval_steps // self.batch_spec.size)
        self.algo.initialize(self.agent, self.batch_spec, obs0,
                             algo_generator, n_itr=self.n_itr)
        self._prev_action = np.broadcast_to(
            self._act_null, (B,) + self._act_null.shape).copy()
        self._prev_reward = np.zeros((B,), np.float32)
        self._carries = [self.agent.init_carry(h.B) for h in self._halves]
        self._actor = self.agent
        self._cum_steps = 0
        self._n_evals = 0
        self._last_window_vals = {}
        # Trajectory accounting, discounted by the algorithm's discount
        # (rlpyt's traj_info_kwargs, minibatch_rl.py startup ~L90).
        self._traj = _TrajAccum(
            B, discount=float(getattr(self.algo, "discount", 1.0)))
        self._has_score = "game_score" in getattr(self.vec, "info", {})

    # ------------------------------------------------------------------

    def _to_device(self, tree):
        """A host tree onto the actor's device, through pinned memory
        (the source may be a shared block that the farm overwrites)."""
        def put(x):
            t = torch.from_numpy(np.array(x))
            if self._pin:
                t = t.pin_memory()
            return t.to(self._actor_device, non_blocking=True)
        return tmap(put, tree)

    def _h2d(self, host: torch.Tensor) -> torch.Tensor:
        """A record onto the actor's device; a copy on the CPU too, since
        the next batch rewrites the record."""
        return host.to(self._actor_device, non_blocking=True, copy=True)

    def _empty(self, shape, dtype=torch.float32) -> torch.Tensor:
        return torch.empty(shape, dtype=dtype, device=self._actor_device)

    def _fetch(self, dst: torch.Tensor, src: torch.Tensor):
        """Start the copy of ``src`` (on the card) into ``dst`` (pinned);
        returns what ``_land`` waits on."""
        dst.copy_(src, non_blocking=True)
        return self._mark()

    def _mark(self):
        """An event after the work queued so far (None off the card)."""
        if not self._pin:
            return None
        event = torch.cuda.Event()
        event.record()
        return event

    @staticmethod
    def _land(event):
        if event is not None:
            event.synchronize()

    def _agent_step(self, obs, prev_a, prev_r, carry, cum_steps,
                    is_eval=False, generator=None):
        return self._actor.step(obs, prev_a, prev_r, carry, cum_steps,
                                generator or self.actor_generator,
                                is_eval=is_eval)

    def _after_step(self, sl, actions, rew, done, info, carry, done_dev):
        """Episode stats and the prev action / reward of lanes [sl] after
        their farm stepped (zeroed where done); the carry reset on
        ``done`` (not on ``traj_done``)."""
        self._traj.step(sl, rew, done, info)
        self._prev_action[sl] = np.where(
            done.reshape(done.shape + (1,) * (actions.ndim - 1)),
            np.zeros_like(actions), actions)
        self._prev_reward[sl] = np.where(done, 0.0, rew)
        if carry is not None:
            carry = self.agent.reset_carry_where(done_dev, carry)
        return carry

    @spanned("collect")
    def _collect_batch(self):
        """One [T, B] batch: the action-server loop (rlpyt
        ActionServer.serve_actions ~L15) over the farm's halves.  A half's
        step is launched (``dispatch``: its inputs recorded and copied to
        the card, the agent step, the actions copied to pinned memory
        behind an event), then landed (``land``: the event waited on, the
        half's envs stepped, their outputs recorded).  One half lands each
        step before the next is launched; two halves alternate (rlpyt
        samplers/parallel/gpu/alternating_sampler.py:AlternatingSampler
        ~L100), one half's envs stepping while the card runs the other's
        inference, each half with a carry bank of its own (rlpyt
        agents/base.py:AlternatingRecurrentAgentMixin ~L250).  Returns
        (Samples on the card, HostRolloutState).  Spans: ``collect``, and
        each half's step's ``collect.record`` (the record and the copies
        to the card it enqueues), ``collect.agent``,
        ``collect.action_wait`` (the wait for the action's copy to the
        host), the farm's ``farm.step`` and ``collect.after_step``."""
        T, B = self.batch_spec
        halves, recs, sl = self._halves, self._recs, self._slices
        carries = self._carries
        self._land(self._recs_free)

        def on_card(b):
            """A record's [T, B] twin on the card."""
            return self._empty((T, B) + tuple(b[0].shape[2:]), b[0].dtype)

        obs_dev = tmap(on_card, recs[0].obs)
        pa_dev, pr_dev, done_dev = (on_card(b) for b in (
            recs[0].pa, recs[0].pr, recs[0].done))
        infos = [[] for _ in halves]

        def dispatch(h, t):
            rec, s = recs[h], sl[h]
            with span("collect.record"):
                rec.record(t, halves[h].obs, self._prev_action[s],
                           self._prev_reward[s])
                tmap(lambda d, b: d[t, s].copy_(b[0][t],
                                                non_blocking=True),
                     obs_dev, rec.obs)
                pa_dev[t, s].copy_(rec.pa[0][t], non_blocking=True)
                pr_dev[t, s].copy_(rec.pr[0][t], non_blocking=True)
            with span("collect.agent"):
                astep, carries[h] = self._agent_step(
                    tmap(lambda d: d[t, s], obs_dev), pa_dev[t, s],
                    pr_dev[t, s], carries[h], self._cum_steps + t * B)
            infos[h].append(astep.agent_info)
            return h, t, self._fetch(rec.act[0][t], astep.action)

        def land(h, t, event):
            with span("collect.action_wait"):
                self._land(event)
            rec, s = recs[h], sl[h]
            actions = rec.act[1][t]
            _, rew, done, timeout = halves[h].step(actions)
            with span("collect.after_step"):
                rec.record_env(t, rew, done, timeout)
                if carries[h] is not None:
                    done_dev[t, s].copy_(rec.done[0][t], non_blocking=True)
                carries[h] = self._after_step(
                    s, actions, rec.rew[1][t], rec.done[1][t],
                    getattr(halves[h], "info", {}), carries[h],
                    done_dev[t, s])

        # A half's step t is launched once its step t - 1 has landed; the
        # other half's step lands in between.
        pending = collections.deque()
        for t in range(T):
            for h in range(len(halves)):
                pending.append(dispatch(h, t))
                if len(pending) == len(halves):
                    land(*pending.popleft())
        while pending:
            land(*pending.popleft())
        self._cum_steps += T * B

        def joined(get):
            """A record of every half, onto the card."""
            return self._h2d(_cat([get(r)[0] for r in recs], 1))

        # Every farm info key (game_score, traj_done, ...), from every half.
        keys = [set(r.info) for r in recs]
        if any(k != keys[0] for k in keys):
            raise ValueError(
                "alternating halves produced different env_info schemas: "
                + " vs ".join(str(sorted(k)) for k in keys))
        samples = Samples(
            observation=obs_dev, action=joined(lambda r: r.act),
            reward=joined(lambda r: r.rew), done=joined(lambda r: r.done),
            prev_action=pa_dev, prev_reward=pr_dev,
            agent_info=(_cat([_stack(i) for i in infos], 1) if infos[0][0]
                        else {}),
            env_info={"timeout": joined(lambda r: r.to),
                      **{k: joined(lambda r: r.info[k])
                         for k in recs[0].info}})
        self._recs_free = self._mark()
        return samples, self._rollout_state(_cat(carries))

    def _rollout_state(self, carry) -> HostRolloutState:
        return HostRolloutState(
            observation=self._to_device(self.vec.obs),
            prev_action=self._to_device(self._prev_action),
            prev_reward=self._to_device(self._prev_reward),
            agent_carry=carry, cum_steps=self._cum_steps)

    # ------------------------------------------------------------------

    def _evaluate(self):
        """Evaluation on ``eval_vec_env`` (rlpyt samplers/parallel/cpu/
        collectors.py:CpuEvalCollector, with BaseSampler's
        eval_max_steps / eval_max_trajectories caps): eval-mode actions
        from the evaluation generator; episodes still running at the cap
        are dropped.  Returns the completed trajectories."""
        vec = self.eval_vec
        B = vec.B
        obs = vec.reset()
        act_null = null_numpy(vec.spaces.action)
        prev_action = np.broadcast_to(
            act_null, (B,) + act_null.shape).copy()
        prev_reward = np.zeros((B,), np.float32)
        carry = self._actor.init_carry(B)
        accum = _TrajAccum(B, discount=self._traj.discount)
        max_T = max(1, self.eval_max_steps // B)
        for _ in range(max_T):
            astep, carry = self._agent_step(
                self._to_device(obs), self._to_device(prev_action),
                self._to_device(prev_reward), carry, self._cum_steps,
                is_eval=True, generator=self.eval_generator)
            actions = astep.action.cpu().numpy()
            obs, rew, done, _ = vec.step(actions)
            accum.step(slice(0, B), rew, done, getattr(vec, "info", {}))
            prev_action = np.where(
                done.reshape((B,) + (1,) * (actions.ndim - 1)),
                np.zeros_like(actions), actions)
            prev_reward = np.where(done, 0.0, rew).astype(np.float32)
            if carry is not None:
                carry = self.agent.reset_carry_where(
                    self._to_device(done), carry)
            if (self.eval_max_trajectories is not None
                    and len(accum.window) >= self.eval_max_trajectories):
                break
        self._n_evals += 1
        return accum.pop()

    # ------------------------------------------------------------------

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def state_dict(self) -> dict:
        """The agent's model and the algorithm's state, replay included
        (live tensors): the counterpart of the JAX runner's
        ``(train_state, replay_state)``."""
        return {"model": self.agent.model.state_dict(),
                "algo": self.algo.state_dict()}

    def train(self) -> dict:
        """Run to ``n_steps``; returns ``state_dict()``."""
        self.startup()
        t_start = time.time()
        interval_itrs = 0
        t0 = time.time()
        for itr in range(self.n_itr):
            samples, rollout_state = self._collect_batch()
            opt_info = self.algo.optimize(samples, rollout_state)
            interval_itrs += 1
            if interval_itrs >= self.itrs_per_interval \
                    or itr == self.n_itr - 1:
                self._sync()
                t1 = time.time()
                eval_eps = (self._evaluate() if self.eval_vec is not None
                            else None)
                self._log(itr + 1, t1 - t0, t1 - t_start, opt_info,
                          eval_eps)
                interval_itrs = 0
                t0 = time.time()
        return self.state_dict()

    def _log(self, itr, dt, total, opt_info, eval_eps=None):
        rec = self.logger.record_tabular
        rec("Iteration", itr)
        rec("CumSteps", self._cum_steps)
        rec("CumTime (s)", total)
        steps = self.itrs_per_interval * self.batch_spec.size
        rec("StepsPerSecond", steps / dt)
        updates = (self.itrs_per_interval
                   * getattr(self.algo, "updates_per_optimize", 1))
        rec("UpdatesPerSecond", updates / dt)
        batch_size = getattr(self.algo, "batch_size", None)
        if batch_size:
            rec("ReplayRatio", updates * batch_size / steps)
        _log_window(rec, "", self._traj.pop(), self._has_score,
                    last=self._last_window_vals)
        for field, val in zip(opt_info._fields, opt_info):
            rec(field, float(torch.as_tensor(val).float().mean()))
        if eval_eps is not None:
            _log_window(rec, "Eval", eval_eps, self._has_score,
                        last=self._last_window_vals)
        self.logger.dump_tabular()


class AsyncHostRl(HostMinibatchRl):
    """Asynchronous actor and learner on the host-env path (reference:
    rlpyt/runners/async_rl.py:AsyncRl ~L20-400 with samplers/async_/
    cpu_sampler.py:AsyncCpuSampler).

    - The **learner thread** takes collected batches from a queue of
      depth 1 and runs ``algo.optimize`` on a CUDA stream of its own;
      the queue is rlpyt's two-way throttle (the actor blocks when the
      learner lags, the learner waits when the actor does).
    - The **actor** (the main thread) steps the envs and runs inference
      with its own copy of the model, on another stream, so its steps
      never queue behind an optimize.  After each optimize the learner
      copies the parameters into a fresh publish buffer, records an
      event and publishes both under a lock; at a batch's start the
      actor's stream waits on the newest event (the host does not) and
      copies the buffer into the actor's model.  The actor's parameters
      are the learner's after optimize j for some j in [k-2, k] when it
      collects batch k; ``actor_lags`` keeps k - j of every batch.
    - ``actor_device="cpu"`` runs the actor on the CPU instead; it is
      used only when asked for.
    - An error in the learner thread is raised in the main thread.

    ``updates_per_optimize`` overrides the algorithm's replay-ratio
    arithmetic, as the reference's ``updates_per_sync`` bound does.
    """

    def __init__(self, *args, actor_device=None,
                 updates_per_optimize: Optional[int] = None, **kwargs):
        super().__init__(*args, **kwargs)
        if actor_device is not None:
            self._actor_device = torch.device(actor_device)
        self._updates_override = updates_per_optimize
        self._lock = threading.Lock()

    def startup(self):
        super().startup()
        if self._updates_override is not None:
            self.algo.updates_per_optimize = int(self._updates_override)
        actor = copy.copy(self.agent)
        actor.device = self._actor_device
        actor.model = copy.deepcopy(self.agent.model).to(self._actor_device)
        actor.model.requires_grad_(False)
        if hasattr(actor, "_eps_finals"):
            actor._eps_finals = {}
        self._actor = actor
        if self._actor_device != self.device:
            self.actor_generator = torch.Generator(
                device=self._actor_device).manual_seed(self.seed)
            self.eval_generator = torch.Generator(
                device=self._actor_device).manual_seed(self.seed + 2)
            self._carries = [actor.init_carry(h.B) for h in self._halves]
        self._learner_stream = (torch.cuda.Stream(self.device)
                                if self.device.type == "cuda" else None)
        self._actor_stream = (torch.cuda.Stream(self._actor_device)
                              if self._pin else None)
        self.actor_lags = []
        self._publish(0)
        # The streams do not wait on the default stream's set-up work.
        self._sync()

    def _publish(self, done_itrs: int):
        """Copy the learner's parameters into a fresh buffer on the
        current stream and publish it with an event recorded after the
        copy."""
        model = self.agent.model
        with torch.no_grad():
            tensors = [t.detach().to(self._actor_device, copy=True)
                       for t in list(model.parameters())
                       + list(model.buffers())]
        event = None
        if self.device.type == "cuda":
            event = torch.cuda.Event()
            event.record()
        with self._lock:
            self._published = (tensors, event, done_itrs)

    def _adopt(self) -> int:
        """At a batch's start: the newest published parameters into the
        actor's model, on the actor's stream after their event.  Returns
        the optimizes they include."""
        with self._lock:
            tensors, event, done_itrs = self._published
        if event is not None:
            if self._actor_stream is not None:
                self._actor_stream.wait_event(event)
            else:
                event.synchronize()
        model = self._actor.model
        with torch.no_grad():
            for dst, src in zip(list(model.parameters())
                                + list(model.buffers()), tensors):
                if self._actor_stream is not None:
                    # Not reused by the learner's allocator before the
                    # actor's stream has read it.
                    src.record_stream(self._actor_stream)
                dst.copy_(src, non_blocking=True)
        return done_itrs

    def _handoff(self, tree):
        """A batch from the actor to the learner: onto the learner's
        device, or (one card) kept from reuse by the actor's allocator
        until the learner's stream has used it."""
        if self._actor_device != self.device:
            return tree_map(lambda x: x.to(self.device)
                            if isinstance(x, torch.Tensor) else x, tree)
        if self._learner_stream is not None:
            tree_map(lambda x: x.record_stream(self._learner_stream)
                     if isinstance(x, torch.Tensor) else None, tree)
        return tree

    def train(self) -> dict:
        """Run to ``n_steps``; returns ``state_dict()`` after the
        learner's last optimize."""
        self.startup()
        batch_q: queue.Queue = queue.Queue(maxsize=1)
        err: list = []
        latest = {"opt_info": None}

        def on(stream):
            return (torch.cuda.stream(stream) if stream is not None
                    else contextlib.nullcontext())

        def learner():
            try:
                with on(self._learner_stream):
                    for itr in range(self.n_itr):
                        item = batch_q.get()
                        if item is None:
                            return
                        batch, event = item
                        if event is not None:
                            self._learner_stream.wait_event(event)
                        samples, rollout_state = self._handoff(batch)
                        opt_info = self.algo.optimize(samples,
                                                      rollout_state)
                        self._publish(itr + 1)
                        with self._lock:
                            latest["opt_info"] = opt_info
            except BaseException as e:   # raised in the main thread
                err.append(e)

        thread = threading.Thread(target=learner, daemon=True)
        thread.start()
        t_start = time.time()
        interval_itrs = 0
        t0 = time.time()
        try:
            with on(self._actor_stream):
                for itr in range(self.n_itr):
                    self.actor_lags.append(itr - self._adopt())
                    batch = self._collect_batch()
                    event = None
                    if self._actor_stream is not None \
                            and self._learner_stream is not None:
                        event = torch.cuda.Event()
                        event.record()
                    self._put(batch_q, (batch, event), thread, err)
                    interval_itrs += 1
                    if interval_itrs >= self.itrs_per_interval \
                            or itr == self.n_itr - 1:
                        # The interval's time is the actor's (as the
                        # reference's): the wait for the learner's last
                        # optimizes is not in it.
                        t1 = time.time()
                        if itr == self.n_itr - 1:
                            thread.join()
                            self._raise(err)
                            self._adopt()
                        with self._lock:
                            opt_info = latest["opt_info"]
                        eval_eps = (self._evaluate()
                                    if self.eval_vec is not None else None)
                        if opt_info is not None:
                            self._log(itr + 1, t1 - t0, t1 - t_start,
                                      opt_info, eval_eps)
                        interval_itrs = 0
                        t0 = time.time()
        finally:
            if thread.is_alive():
                try:
                    batch_q.put_nowait(None)
                except queue.Full:
                    pass
                thread.join(timeout=60)
        self._raise(err)
        self._sync()
        return self.state_dict()

    @staticmethod
    def _raise(err):
        if err:
            raise err[0]

    def _put(self, batch_q, item, thread, err):
        """Hand a batch to the learner; raises the learner's error
        instead of blocking on a dead thread."""
        while True:
            self._raise(err)
            try:
                batch_q.put(item, timeout=0.1)
                return
            except queue.Full:
                if not thread.is_alive():
                    self._raise(err)
                    raise RuntimeError("the learner thread ended early")
