"""DQN agent (port of rlpyt_tpu/agents/dqn.py: EpsilonGreedyMixin,
DqnAgent).  The step count that drives the epsilon schedule is a Python
integer kept by the collector, so the schedule costs no device sync."""
from __future__ import annotations

import torch

from rlpyt_tpu_torch.agents.base import AgentStep, BaseAgent
from rlpyt_tpu_torch.distributions.epsilon_greedy import EpsilonGreedy
from rlpyt_tpu_torch.envs.base import EnvSpaces
from rlpyt_tpu_torch.models.dqn import AtariDqnModel


class EpsilonGreedyMixin:
    def _init_epsilon(self, eps_init=1.0, eps_final=0.01, eps_steps=int(50e3),
                      eval_eps=0.001):
        self.eps_init = eps_init
        self.eps_final = eps_final
        self.eps_steps = eps_steps
        self.eval_eps = eval_eps

    def epsilon(self, cum_steps: int, is_eval: bool = False) -> float:
        """Linear decay from eps_init to eps_final over eps_steps."""
        if is_eval:
            return self.eval_eps
        frac = min(max(cum_steps / self.eps_steps, 0.0), 1.0)
        return self.eps_init + frac * (self.eps_final - self.eps_init)


class DqnAgent(EpsilonGreedyMixin, BaseAgent):
    def __init__(self, ModelCls=AtariDqnModel, model_kwargs=None,
                 eps_init=1.0, eps_final=0.01, eps_steps=int(50e3),
                 eval_eps=0.001, device="cuda"):
        super().__init__(ModelCls=ModelCls, model_kwargs=model_kwargs,
                         device=device)
        self._init_epsilon(eps_init, eps_final, eps_steps, eval_eps)
        self.distribution = None

    def make_env_to_model_kwargs(self, env_spaces: EnvSpaces) -> dict:
        return {"image_shape": env_spaces.observation.shape,
                "n_actions": env_spaces.action.n}

    def initialize(self, env_spaces: EnvSpaces):
        super().initialize(env_spaces)
        self.distribution = EpsilonGreedy()

    def q(self, observation, prev_action=None, prev_reward=None):
        return self.model(observation, prev_action, prev_reward)

    @torch.no_grad()
    def step(self, observation, prev_action, prev_reward, cum_steps,
             generator, is_eval=False):
        q = self.q(observation, prev_action, prev_reward)
        eps = self.epsilon(cum_steps, is_eval)
        action = self.distribution.sample(q, eps, generator)
        return AgentStep(action, {"q": q})
