"""Lockstep collector (port of rlpyt_tpu/samplers/rollout.py: BatchSpec,
Samples, TrajStats, RolloutState, Collector.collect, decorrelate and
evaluate, and the module-level evaluate).

B envs step together on the device; the JAX ``lax.scan`` over T is a
Python loop here, writing each step into preallocated [T, B] buffers.
Auto-reset follows rlpyt's CpuResetCollector (``mid_batch_reset=True``):
when lane b is done at step t, the observation recorded at t+1 is the
reset observation, prev_action / prev_reward are zeroed and the agent's
recurrent carry (None for a feedforward agent) is zeroed.  With
``mid_batch_reset=False`` (rlpyt's WaitResetCollector) a lane that is
done freezes until the end of the batch: its env state stays, it records
reward 0 and done each step, it adds nothing to the episode sums, and it
is reset, carry and all, after the batch's last step.

On a card (``graph_capturable``) ``collect`` runs each step in two
parts: the agent's step, eagerly, then one replay of a CUDA graph
(``_StepGraph``) of everything after it, which takes the place of some
200 launches from the host.  The graph gives the eager step's numbers
bit for bit.
"""
from __future__ import annotations

from typing import Any, Dict, NamedTuple, Optional, Tuple

import torch

from rlpyt_tpu_torch.struct import buffer_from_example, tree_map, \
    tree_select
from rlpyt_tpu_torch.utils import cuda_graphs
from rlpyt_tpu_torch.utils.profiling import count, span, spanned

EVAL_CHECK_STEPS = 16   # evaluate() reads its trajectory count this often


class BatchSpec(NamedTuple):
    T: int
    B: int

    @property
    def size(self) -> int:
        return self.T * self.B


class Samples(NamedTuple):
    """A [T, B, ...] sample batch."""

    observation: Any
    action: Any
    reward: torch.Tensor
    done: torch.Tensor
    prev_action: Any
    prev_reward: torch.Tensor
    agent_info: Dict[str, Any]
    env_info: Dict[str, Any]


class TrajStats(NamedTuple):
    """Completed-trajectory sums, as device scalars."""

    completed: torch.Tensor
    sum_return: torch.Tensor
    sum_sq_return: torch.Tensor
    sum_length: torch.Tensor
    sum_nonzero_rewards: torch.Tensor
    sum_discounted_return: torch.Tensor
    max_return: torch.Tensor
    min_return: torch.Tensor

    @staticmethod
    def zeros(device) -> "TrajStats":
        z = torch.zeros((), device=device)
        return TrajStats(
            torch.zeros((), dtype=torch.int64, device=device), z, z, z, z, z,
            torch.full((), -float("inf"), device=device),
            torch.full((), float("inf"), device=device))


class RolloutState(NamedTuple):
    env_state: Any
    observation: Any          # [B, ...]
    prev_action: Any          # [B, ...]
    prev_reward: torch.Tensor
    agent_carry: Any          # recurrent state [B, ...] or None
    cum_steps: int            # env steps so far (host integer)
    ep_return: torch.Tensor   # [B] running per-lane episode sums
    ep_length: torch.Tensor
    ep_nonzero: torch.Tensor
    ep_discounted: torch.Tensor
    ep_gamma: torch.Tensor
    needs_reset: torch.Tensor   # [B] done and waiting (wait-reset only)
    traj_stats: TrajStats


class Collector:
    """Steps ``batch_spec.B`` lanes.  ``lanes_total``: the lanes of all
    ranks when these are one rank's of a data-parallel run (``cum_steps``
    counts them all, as the epsilon schedule and ``min_steps_learn``
    read it); ``batch_spec.B`` by default."""

    def __init__(self, env, agent, batch_spec: BatchSpec,
                 discount: float = 1.0, mid_batch_reset: bool = True,
                 lanes_total: Optional[int] = None):
        self.env = env
        self.agent = agent
        self.batch_spec = batch_spec
        self.lanes_total = lanes_total or batch_spec.B
        self.mid_batch_reset = mid_batch_reset
        # Discount of the DiscountedReturn trajectory stat.
        self.discount = float(discount)
        self.device = env.device
        self._graph: Optional[_StepGraph] = None

    def init_state(self, generator: torch.Generator) -> RolloutState:
        B = self.batch_spec.B
        env_state, obs = self.env.reset_batch(B, generator)
        null = self.env.spaces.action.null_value(self.device)
        zeros = torch.zeros((B,), device=self.device)
        return RolloutState(
            env_state=env_state, observation=obs,
            prev_action=null.expand((B,) + tuple(null.shape)).clone(),
            prev_reward=zeros, agent_carry=self.agent.init_carry(B),
            cum_steps=0, ep_return=zeros,
            ep_length=zeros, ep_nonzero=zeros, ep_discounted=zeros,
            ep_gamma=torch.ones((B,), device=self.device),
            needs_reset=torch.zeros((B,), dtype=torch.bool,
                                    device=self.device),
            traj_stats=TrajStats.zeros(self.device))

    def reset_traj_stats(self, state: RolloutState) -> RolloutState:
        return state._replace(traj_stats=TrajStats.zeros(self.device))

    def decorrelate(self, state: RolloutState, max_steps: int,
                    generator: torch.Generator,
                    draws: Optional[Tuple[torch.Tensor, torch.Tensor]] = None
                    ) -> RolloutState:
        """Random-action start-state decorrelation (rlpyt's
        DecorrelatingStartCollector): lane b takes ``n_steps[b]`` uniform
        random steps, ``n_steps`` uniform in [0, max_steps), resetting
        when done (under either reset rule, as in the JAX package).  Every
        lane runs all ``max_steps`` iterations and keeps the result only
        while active, so the loop costs no device sync.
        ``draws`` = (n_steps [B], actions [max_steps, B]) replaces the
        draws of the step counts and actions."""
        if max_steps <= 0:
            return state
        B = self.batch_spec.B
        space = self.env.spaces.action
        if draws is None:
            n_steps = torch.randint(0, max_steps, (B,), generator=generator,
                                    device=generator.device)
        else:
            n_steps, actions = draws
        n_steps = n_steps.to(self.device)
        env_state, obs = state.env_state, state.observation
        prev_a, prev_r = state.prev_action, state.prev_reward
        for i in range(max_steps):
            action = (space.sample(generator, (B,)) if draws is None
                      else actions[i]).to(self.device)
            new_state, env_step = self.env.step_batch(env_state, action,
                                                      generator)
            reset_state, reset_obs = self.env.reset_batch(B, generator)
            done = env_step.done
            new_state = tree_select(done, reset_state, new_state)
            new_obs = tree_select(done, reset_obs, env_step.observation)
            active = i < n_steps
            env_state = tree_select(active, new_state, env_state)
            obs = tree_select(active, new_obs, obs)
            new_a = tree_select(done, torch.zeros_like(action), action)
            prev_a = tree_select(active, new_a, prev_a)
            prev_r = torch.where(
                active, torch.where(done, 0.0, env_step.reward), prev_r)
        return state._replace(env_state=env_state, observation=obs,
                              prev_action=prev_a, prev_reward=prev_r)

    @spanned("collect")
    def collect(self, state: RolloutState, generator: torch.Generator,
                is_eval: bool = False) -> Tuple[RolloutState, Samples]:
        """Collect one [T, B] batch; ``is_eval``: the agent acts with its
        evaluation epsilon.  Under wait-reset the lanes that wait are
        reset after the last step.  Where ``graph_capturable`` holds, each
        step is the agent's step, then one replay of a ``_StepGraph``,
        captured in the first such batch (and again for another
        generator); the state and samples returned are copies that no
        later batch overwrites.  Elsewhere each step runs eagerly.
        Spans: ``collect``, each step's ``collect.agent``, and either
        ``collect.graph`` (``collect.capture`` once) or ``collect.env``.
        Counters: ``collect.graph_replays``, ``collect.eager_steps``."""
        T = self.batch_spec.T
        if graph_capturable(self.env, generator):
            state, buf = self._collect_graphed(state, generator, is_eval)
        else:
            buf = None
            for t in range(T):
                state, out = self._step(state, generator, is_eval)
                if buf is None:
                    buf = buffer_from_example(out, (T,), self.device)
                tree_map(lambda b, x: b[t].copy_(x), buf, out)
            count("collect.eager_steps", n=T)
        if not self.mid_batch_reset:
            state = self._reset_waiting(state, generator)
        return state, buf

    def _collect_graphed(self, state: RolloutState,
                         generator: torch.Generator, is_eval: bool
                         ) -> Tuple[RolloutState, Samples]:
        graph = self._graph
        if graph is not None and graph.generator is generator:
            graph.load(state)
        else:
            graph = None
        carry = state if graph is None else graph.carry
        cum_steps = state.cum_steps
        for _ in range(self.batch_spec.T):
            with span("collect.agent"):
                agent_out = self.agent.step(
                    carry.observation, carry.prev_action, carry.prev_reward,
                    carry.agent_carry, cum_steps, generator, is_eval=is_eval)
            if graph is None:
                # The first step's agent outputs give the inputs' shapes.
                with span("collect.capture"):
                    graph = self._graph = _StepGraph(self, state, agent_out,
                                                     generator)
                graph.load(state)
                carry = graph.carry
            with span("collect.graph"):
                graph.step(agent_out)
            cum_steps += self.lanes_total
        count("collect.graph_replays", n=self.batch_spec.T)
        return graph.result(cum_steps)

    def evaluate(self, generator: torch.Generator, max_T: int,
                 max_trajectories: Optional[int] = None) -> TrajStats:
        """Offline evaluation (rlpyt's SerialEvalCollector): fresh env
        states from ``generator``, eval-mode actions, stats over
        completed trajectories only.  Once ``max_trajectories`` have
        completed, no later episode counts (lanes that finish on the step
        that reaches the cap all count, as in the JAX package).  JAX stops
        its ``while_loop`` on the step that reaches the cap; here the cap
        is read on the host every ``EVAL_CHECK_STEPS`` steps, which costs
        one sync per check instead of one per step.  The steps run past
        the cap add nothing to the stats, so they come out the same.
        Under wait-reset a lane that finishes waits to the end, as in the
        JAX package."""
        state = self.init_state(generator)
        for t in range(max_T):
            if (max_trajectories is not None and t % EVAL_CHECK_STEPS == 0
                    and int(state.traj_stats.completed) >= max_trajectories):
                break
            state, _ = self._step(state, generator, True, max_trajectories)
        return state.traj_stats

    def _step(self, carry: RolloutState, generator: torch.Generator,
              is_eval: bool = False, max_trajectories: Optional[int] = None
              ) -> Tuple[RolloutState, Samples]:
        with span("collect.agent"):
            agent_step, agent_carry = self.agent.step(
                carry.observation, carry.prev_action, carry.prev_reward,
                carry.agent_carry, carry.cum_steps, generator,
                is_eval=is_eval)
        return self._after_agent(carry, agent_step, agent_carry, generator,
                                 max_trajectories)

    def _after_agent(self, carry: RolloutState, agent_step, agent_carry,
                     generator: torch.Generator,
                     max_trajectories: Optional[int] = None
                     ) -> Tuple[RolloutState, Samples]:
        """A step after the agent's: the env step, the wait-reset freeze,
        the record, the trajectory accounting and the auto-reset; returns
        (next carry, record).  It only reads ``carry`` and the agent's
        outputs, so ``_StepGraph`` captures it as it is."""
        B = self.batch_spec.B
        action = agent_step.action
        with span("collect.env"):
            env_state, env_step = self.env.step_batch(carry.env_state,
                                                      action, generator)
        reward = env_step.reward.to(torch.float32)
        done = env_step.done
        waiting = carry.needs_reset
        if not self.mid_batch_reset:
            # Frozen lanes: no state advance, reward 0, done stays.
            env_state = tree_select(waiting, carry.env_state, env_state)
            reward = torch.where(waiting, 0.0, reward)
            done = done | waiting
        fresh_done = done & ~waiting   # episodes that end at this step
        out = Samples(carry.observation, action, reward, done,
                      carry.prev_action, carry.prev_reward,
                      agent_step.agent_info, env_step.info)

        # Trajectory accounting (a waiting lane adds nothing).
        live = (~waiting).to(torch.float32)
        ep_return = carry.ep_return + reward * live
        ep_length = carry.ep_length + live
        ep_nonzero = carry.ep_nonzero + (reward != 0.0).to(torch.float32) \
            * live
        ep_discounted = carry.ep_discounted + reward * carry.ep_gamma * live
        ep_gamma = torch.where(waiting, carry.ep_gamma,
                               carry.ep_gamma * self.discount)
        ts = carry.traj_stats
        d = fresh_done   # the episodes that count in the stats
        if max_trajectories is not None:
            d = d & (ts.completed < max_trajectories)
        df = d.to(torch.float32)
        inf = float("inf")
        traj_stats = TrajStats(
            completed=ts.completed + d.sum(),
            sum_return=ts.sum_return + (ep_return * df).sum(),
            sum_sq_return=ts.sum_sq_return + (ep_return ** 2 * df).sum(),
            sum_length=ts.sum_length + (ep_length * df).sum(),
            sum_nonzero_rewards=ts.sum_nonzero_rewards
            + (ep_nonzero * df).sum(),
            sum_discounted_return=ts.sum_discounted_return
            + (ep_discounted * df).sum(),
            max_return=torch.maximum(
                ts.max_return, torch.where(d, ep_return, -inf).max()),
            min_return=torch.minimum(
                ts.min_return, torch.where(d, ep_return, inf).min()))
        finished = 1.0 - fresh_done.to(torch.float32)
        ep_gamma = torch.where(fresh_done, 1.0, ep_gamma)

        if self.mid_batch_reset:
            # Auto-reset (CpuResetCollector parity).
            reset_state, reset_obs = self.env.reset_batch(B, generator)
            env_state = tree_select(done, reset_state, env_state)
            observation = tree_select(done, reset_obs, env_step.observation)
            agent_carry = self.agent.reset_carry_where(done, agent_carry)
        else:
            # Wait-reset: the lane keeps its observation until batch end.
            observation = tree_select(done, carry.observation,
                                      env_step.observation)
        new_carry = RolloutState(
            env_state=env_state, observation=observation,
            prev_action=tree_select(done, torch.zeros_like(action), action),
            prev_reward=torch.where(done, 0.0, reward),
            agent_carry=agent_carry,
            cum_steps=carry.cum_steps + self.lanes_total,
            ep_return=ep_return * finished, ep_length=ep_length * finished,
            ep_nonzero=ep_nonzero * finished,
            ep_discounted=ep_discounted * finished, ep_gamma=ep_gamma,
            needs_reset=(carry.needs_reset if self.mid_batch_reset
                         else done),
            traj_stats=traj_stats)
        return new_carry, out

    def _reset_waiting(self, state: RolloutState,
                       generator: torch.Generator) -> RolloutState:
        """Batch-end reset of the lanes that wait (rlpyt's
        WaitResetCollector.reset_if_needed)."""
        reset_state, reset_obs = self.env.reset_batch(self.batch_spec.B,
                                                      generator)
        w = state.needs_reset
        return state._replace(
            env_state=tree_select(w, reset_state, state.env_state),
            observation=tree_select(w, reset_obs, state.observation),
            prev_action=tree_select(w, torch.zeros_like(state.prev_action),
                                    state.prev_action),
            prev_reward=torch.where(w, 0.0, state.prev_reward),
            agent_carry=self.agent.reset_carry_where(w, state.agent_carry),
            needs_reset=torch.zeros_like(w))


def graph_capturable(env, generator: torch.Generator) -> bool:
    """Whether ``Collector.collect`` replays the step after the agent
    from a CUDA graph: the env is on a card and the generator on that
    same card (a generator elsewhere would have its draws frozen into the
    graph)."""
    dev, gen = env.device, generator.device
    if dev.type != "cuda" or gen.type != "cuda":
        return False
    return _card_index(dev) == _card_index(gen)


def _card_index(device: torch.device) -> int:
    return torch.cuda.current_device() if device.index is None \
        else device.index


def _tensors(state: RolloutState) -> RolloutState:
    """``state`` without its host integer: a tree of tensors alone."""
    return state._replace(cum_steps=None)


class _StepGraph:
    """A collection step after the agent's (``Collector._after_agent``),
    then the write of its record into the [T, B] buffer at a step index
    that lives on the card, captured as one CUDA graph for one collector
    and one generator.

    The graph reads and writes static tensors: ``carry`` (the rollout
    state but ``cum_steps``), ``inputs`` (the agent's step and next
    carry, copied in before each replay), the step index ``t`` and the
    buffer ``buf``; one graph serves every step of a batch.  The
    generator is registered with the graph, so that each replay draws at
    the offsets the eager ops would have drawn at, after the agent's
    eager draws.  The warm-up and the capture (``cuda_graphs.Capturer``)
    run on a copy of the state they are given, and the generator's state
    is restored after them: they advance nothing of the run."""

    def __init__(self, collector: Collector, state: RolloutState,
                 agent_out, generator: torch.Generator):
        self.collector, self.generator = collector, generator
        # ``cum_steps`` stays on the host: the carry's 0 is a placeholder.
        self.carry = tree_map(torch.clone, _tensors(state))._replace(
            cum_steps=0)
        self.inputs = tree_map(torch.clone, agent_out)
        self.t = torch.zeros((1,), dtype=torch.int64,
                             device=collector.device)
        saved = generator.get_state()
        # One eager step gives the record's shapes.
        _, out = collector._after_agent(self.carry, *self.inputs, generator)
        self.buf = buffer_from_example(out, (collector.batch_spec.T,),
                                       collector.device)
        cap = cuda_graphs.Capturer(collector.device)
        cap.warm(self._body)
        self.replay = cap.capture(self._body, generators=(generator,))
        cap.close()
        generator.set_state(saved)

    def _body(self):
        """What the graph holds: the step, the record written at ``t``,
        ``t`` advanced, the next carry written over ``carry``.  Each leaf
        of the next carry is a new tensor or the carry's own leaf, so no
        copy reads what another wrote."""
        new, out = self.collector._after_agent(self.carry, *self.inputs,
                                               self.generator)
        tree_map(lambda b, x: b.index_copy_(0, self.t, x.unsqueeze(0)),
                 self.buf, out)
        self.t.add_(1)
        tree_map(lambda d, x: d.copy_(x), _tensors(self.carry),
                 _tensors(new))

    def load(self, state: RolloutState):
        """Start a batch from ``state``: its tensors into ``carry``, the
        step index to 0."""
        tree_map(lambda d, x: d.copy_(x), _tensors(self.carry),
                 _tensors(state))
        self.t.zero_()

    def step(self, agent_out):
        """One step after the agent's, from its outputs."""
        tree_map(lambda d, x: d.copy_(x), self.inputs, agent_out)
        self.replay()

    def result(self, cum_steps: int) -> Tuple[RolloutState, Samples]:
        """Copies of the carry (with ``cum_steps``) and of the buffer, which
        no later replay overwrites."""
        return (tree_map(torch.clone, _tensors(self.carry))._replace(
            cum_steps=cum_steps), tree_map(torch.clone, self.buf))


def evaluate(collector: Collector, generator: torch.Generator, max_T: int,
             max_trajectories: Optional[int] = None) -> TrajStats:
    """``collector.evaluate``, as a function."""
    return collector.evaluate(generator, max_T, max_trajectories)
