"""Agent interface (port of rlpyt_tpu/agents/base.py).

The JAX agent is a configuration object whose pure functions take a
parameter tree.  Here the agent owns its ``nn.Module`` (``agent.model``)
on ``device``; the algorithm keeps the target network beside it.  The
per-lane recurrent carry (None for a feedforward agent) is threaded by
the collector, as in the JAX package:
``step(obs, prev_action, prev_reward, carry, cum_steps, generator)
-> (AgentStep, next_carry)``.
"""
from __future__ import annotations

from typing import Any, Dict, NamedTuple

import torch

from rlpyt_tpu_torch.envs.base import EnvSpaces
from rlpyt_tpu_torch.struct import tree_map


class AgentStep(NamedTuple):
    action: torch.Tensor
    agent_info: Dict[str, Any]


class BaseAgent:
    def __init__(self, ModelCls=None, model_kwargs=None, device="cuda"):
        self.ModelCls = ModelCls
        self.model_kwargs = dict(model_kwargs or {})
        self.device = torch.device(device)
        self.model = None
        self.env_spaces: EnvSpaces | None = None

    def make_env_to_model_kwargs(self, env_spaces: EnvSpaces) -> dict:
        return {}

    def initialize(self, env_spaces: EnvSpaces):
        """Bind env spaces and build the model on ``device``.  Weights are
        drawn on the CPU from torch's global generator (seeded by the
        runner), so one seed gives one set of weights on any device."""
        self.env_spaces = env_spaces
        kwargs = {**self.make_env_to_model_kwargs(env_spaces),
                  **self.model_kwargs}
        self.model = self.ModelCls(**kwargs).to(self.device)

    def init_carry(self, batch_B: int):
        """Per-lane recurrent carry; None for feedforward agents."""
        return None

    @staticmethod
    def reset_carry_where(done: torch.Tensor, carry):
        """Zero the carry of lanes that are done (rlpyt's
        RecurrentAgentMixin.reset_one)."""
        if carry is None:
            return None
        mask = (~done).to(torch.float32)
        return tree_map(lambda c: c * mask.reshape(
            mask.shape + (1,) * (c.dim() - mask.dim())), carry)

    def step(self, observation, prev_action, prev_reward, carry,
             cum_steps: int, generator: torch.Generator,
             is_eval: bool = False):
        """Returns (AgentStep, next_carry)."""
        raise NotImplementedError
