"""Lockstep collector (port of rlpyt_tpu/samplers/rollout.py: BatchSpec,
Samples, TrajStats, RolloutState, Collector.collect, decorrelate and
evaluate, and the module-level evaluate).

B envs step together on the device; the JAX ``lax.scan`` over T is a
Python loop here, writing each step into preallocated [T, B] buffers.
Auto-reset follows rlpyt's CpuResetCollector (``mid_batch_reset=True``):
when lane b is done at step t, the observation recorded at t+1 is the
reset observation, prev_action / prev_reward are zeroed and the agent's
recurrent carry (None for a feedforward agent) is zeroed.
"""
from __future__ import annotations

from typing import Any, Dict, NamedTuple, Optional, Tuple

import torch

from rlpyt_tpu_torch.struct import buffer_from_example, tree_map, \
    tree_select

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
    traj_stats: TrajStats


class Collector:
    def __init__(self, env, agent, batch_spec: BatchSpec,
                 discount: float = 1.0):
        self.env = env
        self.agent = agent
        self.batch_spec = batch_spec
        # Discount of the DiscountedReturn trajectory stat.
        self.discount = float(discount)
        self.device = env.device

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
        when done.  Every lane runs all ``max_steps`` iterations and keeps
        the result only while active, so the loop costs no device sync.
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

    def collect(self, state: RolloutState, generator: torch.Generator,
                is_eval: bool = False) -> Tuple[RolloutState, Samples]:
        """Collect one [T, B] batch; ``is_eval``: the agent acts with its
        evaluation epsilon."""
        T = self.batch_spec.T
        buf = None
        for t in range(T):
            state, out = self._step(state, generator, is_eval)
            if buf is None:
                buf = buffer_from_example(out, (T,), self.device)
            tree_map(lambda b, x: b[t].copy_(x), buf, out)
        return state, buf

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
        the cap add nothing to the stats, so they come out the same."""
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
        B = self.batch_spec.B
        agent_step, agent_carry = self.agent.step(
            carry.observation, carry.prev_action, carry.prev_reward,
            carry.agent_carry, carry.cum_steps, generator, is_eval=is_eval)
        action = agent_step.action
        env_state, env_step = self.env.step_batch(carry.env_state, action,
                                                  generator)
        reward = env_step.reward.to(torch.float32)
        done = env_step.done
        out = Samples(carry.observation, action, reward, done,
                      carry.prev_action, carry.prev_reward,
                      agent_step.agent_info, env_step.info)

        # Trajectory accounting.
        ep_return = carry.ep_return + reward
        ep_length = carry.ep_length + 1.0
        ep_nonzero = carry.ep_nonzero + (reward != 0.0).to(torch.float32)
        ep_discounted = carry.ep_discounted + reward * carry.ep_gamma
        ep_gamma = carry.ep_gamma * self.discount
        ts = carry.traj_stats
        d = done   # the episodes that count in the stats
        if max_trajectories is not None:
            d = done & (ts.completed < max_trajectories)
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
        live = 1.0 - done.to(torch.float32)
        ep_gamma = torch.where(done, 1.0, ep_gamma)

        # Auto-reset (CpuResetCollector parity).
        reset_state, reset_obs = self.env.reset_batch(B, generator)
        new_carry = RolloutState(
            env_state=tree_select(done, reset_state, env_state),
            observation=tree_select(done, reset_obs, env_step.observation),
            prev_action=tree_select(done, torch.zeros_like(action), action),
            prev_reward=torch.where(done, 0.0, reward),
            agent_carry=self.agent.reset_carry_where(done, agent_carry),
            cum_steps=carry.cum_steps + B,
            ep_return=ep_return * live, ep_length=ep_length * live,
            ep_nonzero=ep_nonzero * live,
            ep_discounted=ep_discounted * live, ep_gamma=ep_gamma,
            traj_stats=traj_stats)
        return new_carry, out


def evaluate(collector: Collector, generator: torch.Generator, max_T: int,
             max_trajectories: Optional[int] = None) -> TrajStats:
    """``collector.evaluate``, as a function."""
    return collector.evaluate(generator, max_T, max_trajectories)
