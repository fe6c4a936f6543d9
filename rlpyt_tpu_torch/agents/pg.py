"""Policy-gradient agents (port of rlpyt_tpu/agents/pg.py:
CategoricalPgAgent, RecurrentCategoricalPgAgent, GaussianPgAgent,
RecurrentGaussianPgAgent).

``agent_info`` carries ``dist_info`` (the collection-time probabilities
PPO's likelihood ratio needs) and ``value`` through the sample buffer;
the recurrent agent also stores ``prev_rnn_state``, the carry before the
step, so a training window can be replayed from its first step.  Actions
are drawn as argmax(log p + Gumbel noise), with noise from the
collector's generator or passed in (``gumbel=``); evaluation acts by
argmax of the logits.  The Gaussian agents draw mu + std * noise (std
from log_std, at least 1e-6), with standard normals from the collector's
generator or passed in (``noise=``); evaluation acts with mu.
"""
from __future__ import annotations

from typing import Optional

import torch

from rlpyt_tpu_torch.agents.base import AgentStep, BaseAgent
from rlpyt_tpu_torch.distributions.categorical import Categorical, DistInfo
from rlpyt_tpu_torch.distributions.gaussian import DistInfoStd, Gaussian
from rlpyt_tpu_torch.envs.base import EnvSpaces
from rlpyt_tpu_torch.models.pg import (
    AtariFfModel,
    AtariLstmModel,
    MujocoFfModel,
    MujocoLstmModel,
)
from rlpyt_tpu_torch.models.rnn import zero_rnn_state


class CategoricalPgAgent(BaseAgent):
    def __init__(self, ModelCls=AtariFfModel, model_kwargs=None,
                 device="cuda"):
        super().__init__(ModelCls=ModelCls, model_kwargs=model_kwargs,
                         device=device)
        self.distribution = None

    def make_env_to_model_kwargs(self, env_spaces: EnvSpaces) -> dict:
        return {"image_shape": env_spaces.observation.shape,
                "n_actions": env_spaces.action.n}

    def initialize(self, env_spaces: EnvSpaces):
        super().initialize(env_spaces)
        self.distribution = Categorical(env_spaces.action.n)

    def __call__(self, observation, prev_action=None, prev_reward=None):
        """Train-time forward over [T, B]: (DistInfo, value)."""
        pi_logits, v = self.model(observation, prev_action, prev_reward)
        return DistInfo(prob=torch.softmax(pi_logits, dim=-1)), v

    def _act(self, pi_logits, generator, is_eval, gumbel):
        prob = torch.softmax(pi_logits, dim=-1)
        if is_eval:
            action = torch.argmax(pi_logits, dim=-1)
        else:
            action = self.distribution.sample(DistInfo(prob), generator,
                                              gumbel)
        return action, DistInfo(prob=prob)

    @torch.no_grad()
    def step(self, observation, prev_action, prev_reward, carry, cum_steps,
             generator, is_eval=False, gumbel: Optional[torch.Tensor] = None):
        pi_logits, v = self.model(observation, prev_action, prev_reward)
        action, dist_info = self._act(pi_logits, generator, is_eval, gumbel)
        return AgentStep(action, {"dist_info": dist_info, "value": v}), carry

    @torch.no_grad()
    def value(self, observation, prev_action=None, prev_reward=None):
        """V of the state after a batch (the bootstrap value)."""
        return self.model(observation, prev_action, prev_reward)[1]


class RecurrentCategoricalPgAgent(CategoricalPgAgent):
    recurrent = True

    def __init__(self, ModelCls=AtariLstmModel, lstm_size=512, **kwargs):
        super().__init__(ModelCls=ModelCls, **kwargs)
        # model_kwargs wins if it names a size.
        self.lstm_size = self.model_kwargs.get("lstm_size", lstm_size)
        self.model_kwargs.setdefault("lstm_size", self.lstm_size)

    def init_carry(self, batch_B: int):
        return zero_rnn_state((batch_B,), self.lstm_size, self.device)

    def __call__(self, observation, prev_action, prev_reward, init_rnn_state,
                 done=None):
        """Train-time forward over a [T, B] window from
        ``init_rnn_state``: (DistInfo, value, final rnn state)."""
        pi_logits, v, next_state = self.model(
            observation, prev_action, prev_reward, init_rnn_state, done)
        return (DistInfo(prob=torch.softmax(pi_logits, dim=-1)), v,
                next_state)

    @torch.no_grad()
    def step(self, observation, prev_action, prev_reward, carry, cum_steps,
             generator, is_eval=False, gumbel: Optional[torch.Tensor] = None):
        pi_logits, v, next_carry = self.model(observation, prev_action,
                                              prev_reward, carry)
        action, dist_info = self._act(pi_logits, generator, is_eval, gumbel)
        return AgentStep(action, {"dist_info": dist_info, "value": v,
                                  "prev_rnn_state": carry}), next_carry

    @torch.no_grad()
    def value(self, observation, prev_action, prev_reward, carry):
        return self.model(observation, prev_action, prev_reward, carry)[1]


class GaussianPgAgent(BaseAgent):
    def __init__(self, ModelCls=MujocoFfModel, model_kwargs=None,
                 device="cuda"):
        super().__init__(ModelCls=ModelCls, model_kwargs=model_kwargs,
                         device=device)
        self.distribution = None

    def make_env_to_model_kwargs(self, env_spaces: EnvSpaces) -> dict:
        return {"observation_shape": env_spaces.observation.shape,
                "action_size": env_spaces.action.shape[0]}

    def initialize(self, env_spaces: EnvSpaces):
        super().initialize(env_spaces)
        self.distribution = Gaussian(dim=env_spaces.action.shape[0],
                                     min_std=1e-6)

    def __call__(self, observation, prev_action=None, prev_reward=None):
        """Train-time forward over [T, B]: (DistInfoStd, value)."""
        mu, log_std, v = self.model(observation, prev_action, prev_reward)
        return DistInfoStd(mu, log_std), v

    def _act(self, dist_info, generator, is_eval, noise):
        if is_eval:
            return dist_info.mean
        return self.distribution.sample(dist_info, generator, noise)

    @torch.no_grad()
    def step(self, observation, prev_action, prev_reward, carry, cum_steps,
             generator, is_eval=False, noise: Optional[torch.Tensor] = None):
        dist_info, v = self(observation, prev_action, prev_reward)
        action = self._act(dist_info, generator, is_eval, noise)
        return AgentStep(action, {"dist_info": dist_info, "value": v}), carry

    @torch.no_grad()
    def value(self, observation, prev_action=None, prev_reward=None):
        return self.model(observation, prev_action, prev_reward)[2]


class RecurrentGaussianPgAgent(GaussianPgAgent):
    recurrent = True

    def __init__(self, ModelCls=MujocoLstmModel, lstm_size=256, **kwargs):
        super().__init__(ModelCls=ModelCls, **kwargs)
        # model_kwargs wins if it names a size.
        self.lstm_size = self.model_kwargs.get("lstm_size", lstm_size)
        self.model_kwargs.setdefault("lstm_size", self.lstm_size)

    def init_carry(self, batch_B: int):
        return zero_rnn_state((batch_B,), self.lstm_size, self.device)

    def __call__(self, observation, prev_action, prev_reward, init_rnn_state,
                 done=None):
        """Train-time forward over a [T, B] window from
        ``init_rnn_state``: (DistInfoStd, value, final rnn state)."""
        mu, log_std, v, next_state = self.model(
            observation, prev_action, prev_reward, init_rnn_state, done)
        return DistInfoStd(mu, log_std), v, next_state

    @torch.no_grad()
    def step(self, observation, prev_action, prev_reward, carry, cum_steps,
             generator, is_eval=False, noise: Optional[torch.Tensor] = None):
        dist_info, v, next_carry = self(observation, prev_action,
                                        prev_reward, carry)
        action = self._act(dist_info, generator, is_eval, noise)
        return AgentStep(action, {"dist_info": dist_info, "value": v,
                                  "prev_rnn_state": carry}), next_carry

    @torch.no_grad()
    def value(self, observation, prev_action, prev_reward, carry):
        return self.model(observation, prev_action, prev_reward, carry)[2]
