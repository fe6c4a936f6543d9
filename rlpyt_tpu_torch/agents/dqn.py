"""DQN-family agents (port of rlpyt_tpu/agents/dqn.py: EpsilonGreedyMixin,
DqnAgent, CatDqnAgent, R2d1Agent).  The step count that drives the epsilon schedule
is a Python integer kept by the collector, so the schedule costs no
device sync.  The vector-epsilon option (R2D1's per-lane exploration)
gives lane b of B the final epsilon
exp(log eps_final + b/(B-1) (log eps_final_min - log eps_final))."""
from __future__ import annotations

import math

import numpy as np
import torch

from rlpyt_tpu_torch.agents.base import AgentStep, BaseAgent
from rlpyt_tpu_torch.distributions.epsilon_greedy import (
    CategoricalEpsilonGreedy,
    EpsilonGreedy,
)
from rlpyt_tpu_torch.envs.base import EnvSpaces
from rlpyt_tpu_torch.models.dqn import (
    AtariCatDqnModel,
    AtariDqnModel,
    AtariR2d1Model,
)
from rlpyt_tpu_torch.models.rnn import zero_rnn_state
from rlpyt_tpu_torch.spaces import Composite


class EpsilonGreedyMixin:
    def _init_epsilon(self, eps_init=1.0, eps_final=0.01, eps_steps=int(50e3),
                      eval_eps=0.001, eps_final_min=None):
        self.eps_init = eps_init
        self.eps_final = eps_final
        self.eps_steps = eps_steps
        self.eval_eps = eval_eps
        self.eps_final_min = eps_final_min
        self._eps_finals = {}   # batch_B -> [B] per-lane finals on device

    def _finals(self, batch_B: int) -> torch.Tensor:
        if batch_B not in self._eps_finals:
            b = np.arange(batch_B) / max(batch_B - 1, 1)
            finals = np.exp(np.log(self.eps_final) + b * (
                np.log(self.eps_final_min) - np.log(self.eps_final)))
            self._eps_finals[batch_B] = torch.as_tensor(
                finals, dtype=torch.float32, device=self.device)
        return self._eps_finals[batch_B]

    def bind_lanes(self, B: int, lanes: slice):
        """Act on ``lanes`` of a B-lane batch (one rank's, under
        ``SyncRl``): their per-lane finals are those lanes' of B."""
        if self.eps_final_min is not None:
            self._eps_finals[lanes.stop - lanes.start] = \
                self._finals(B)[lanes]

    def epsilon(self, cum_steps: int, is_eval: bool = False,
                batch_B: int = 1):
        """Linear decay from eps_init over eps_steps: to eps_final (a
        float), or, with ``eps_final_min``, to per-lane finals (a [B]
        float32 tensor on the agent's device)."""
        if is_eval:
            return self.eval_eps
        frac = min(max(cum_steps / self.eps_steps, 0.0), 1.0)
        if self.eps_final_min is None:
            return self.eps_init + frac * (self.eps_final - self.eps_init)
        return self.eps_init + frac * (self._finals(batch_B) - self.eps_init)


class DqnAgent(EpsilonGreedyMixin, BaseAgent):
    def __init__(self, ModelCls=AtariDqnModel, model_kwargs=None,
                 eps_init=1.0, eps_final=0.01, eps_steps=int(50e3),
                 eval_eps=0.001, eps_final_min=None, device="cuda"):
        super().__init__(ModelCls=ModelCls, model_kwargs=model_kwargs,
                         device=device)
        self._init_epsilon(eps_init, eps_final, eps_steps, eval_eps,
                           eps_final_min)
        self.distribution = None

    def make_env_to_model_kwargs(self, env_spaces: EnvSpaces) -> dict:
        """``n_actions``, and ``image_shape`` for an image observation or
        ``input_size`` for a vector one (for a Composite, the sum of its
        leaves' sizes)."""
        space = env_spaces.observation
        kwargs = {"n_actions": env_spaces.action.n}
        if isinstance(space, Composite):
            kwargs["input_size"] = sum(math.prod(s.shape)
                                       for s in space.spaces.values())
        elif len(space.shape) == 1:
            kwargs["input_size"] = space.shape[0]
        else:
            kwargs["image_shape"] = space.shape
        return kwargs

    def initialize(self, env_spaces: EnvSpaces):
        super().initialize(env_spaces)
        self.distribution = EpsilonGreedy()

    def q(self, observation, prev_action=None, prev_reward=None):
        return self.model(observation, prev_action, prev_reward)

    @torch.no_grad()
    def step(self, observation, prev_action, prev_reward, carry, cum_steps,
             generator, is_eval=False):
        q = self.q(observation, prev_action, prev_reward)
        eps = self.epsilon(cum_steps, is_eval, q.shape[0])
        action = self.distribution.sample(q, eps, generator)
        return AgentStep(action, {"q": q}), carry


class CatDqnAgent(DqnAgent):
    """Categorical (C51) agent: the model gives atom probabilities
    [B, A, n_atoms], and actions are greedy over their expected value on
    the support ``z``."""

    def __init__(self, ModelCls=AtariCatDqnModel, n_atoms=51, v_min=-10.0,
                 v_max=10.0, **kwargs):
        super().__init__(ModelCls=ModelCls, **kwargs)
        self.n_atoms = n_atoms
        self.v_min = v_min
        self.v_max = v_max
        self.model_kwargs.setdefault("n_atoms", n_atoms)

    @property
    def z(self) -> torch.Tensor:
        """The atom support [n_atoms] on the agent's device."""
        return torch.linspace(self.v_min, self.v_max, self.n_atoms,
                              device=self.device)

    def initialize(self, env_spaces: EnvSpaces):
        BaseAgent.initialize(self, env_spaces)
        self.distribution = CategoricalEpsilonGreedy(self.z)

    @torch.no_grad()
    def step(self, observation, prev_action, prev_reward, carry, cum_steps,
             generator, is_eval=False):
        p = self.model(observation, prev_action, prev_reward)
        eps = self.epsilon(cum_steps, is_eval, p.shape[0])
        action = self.distribution.sample(p, eps, generator)
        return AgentStep(action, {"p": p}), carry


class R2d1Agent(DqnAgent):
    """Recurrent Q agent.  Puts ``prev_rnn_state`` (the state before the
    step) and ``q`` into agent_info, so sequence replay can store the
    state at each window start."""

    def __init__(self, ModelCls=AtariR2d1Model, lstm_size=512,
                 eps_final_min=0.0005, **kwargs):
        super().__init__(ModelCls=ModelCls, eps_final_min=eps_final_min,
                         **kwargs)
        # model_kwargs wins if it names a size.
        self.lstm_size = self.model_kwargs.get("lstm_size", lstm_size)
        self.model_kwargs.setdefault("lstm_size", self.lstm_size)

    def init_carry(self, batch_B: int):
        return zero_rnn_state((batch_B,), self.lstm_size, self.device)

    @torch.no_grad()
    def step(self, observation, prev_action, prev_reward, carry, cum_steps,
             generator, is_eval=False):
        q, next_carry = self.model(observation, prev_action, prev_reward,
                                   carry)
        eps = self.epsilon(cum_steps, is_eval, q.shape[0])
        action = self.distribution.sample(q, eps, generator)
        return AgentStep(action, {"q": q, "prev_rnn_state": carry}), \
            next_carry
