"""Q-value policy-gradient agents (port of rlpyt_tpu/agents/qpg.py:
DdpgAgent, Td3Agent, SacAgent).

The JAX agent's parameter dict becomes ``agent.nets``, an
``nn.ModuleDict`` on ``device`` with the same keys ("mu" or "pi", "q" or
"q1"/"q2", and their "target_*" copies); ``agent.model`` is the same
dict.  Targets start as copies of the online networks and take no
gradients.  Exploration noise comes from the collector's generator or is
passed in (``noise=``).
"""
from __future__ import annotations

import copy
from typing import Optional

import numpy as np
import torch
from torch import nn

from rlpyt_tpu_torch.agents.base import AgentStep, BaseAgent
from rlpyt_tpu_torch.distributions.gaussian import DistInfoStd, Gaussian
from rlpyt_tpu_torch.envs.base import EnvSpaces
from rlpyt_tpu_torch.models.qpg import MuMlpModel, PiMlpModel, QofMuMlpModel


class _QpgAgent(BaseAgent):
    q_names = ("q",)

    def __init__(self, model_kwargs=None, q_model_kwargs=None,
                 device="cuda"):
        super().__init__(model_kwargs=model_kwargs, device=device)
        self.q_model_kwargs = dict(q_model_kwargs or {})
        self.nets: Optional[nn.ModuleDict] = None

    def _build(self, env_spaces: EnvSpaces, policy_name: str, policy,
               target_policy: bool):
        """Bind the spaces and build the policy, the critics and the
        targets; weights are drawn in JAX's order (policy, then each
        critic) from torch's global generator, on the CPU."""
        self.env_spaces = env_spaces
        obs_shape = env_spaces.observation.shape
        nets = {policy_name: policy}
        for name in self.q_names:
            nets[name] = QofMuMlpModel(obs_shape, self.action_size,
                                       **self.q_model_kwargs)
        targets = (policy_name,) * target_policy + self.q_names
        for name in targets:
            nets["target_" + name] = copy.deepcopy(
                nets[name]).requires_grad_(False)
        self.nets = nn.ModuleDict(nets).to(self.device)
        self.model = self.nets

    def _action_bounds(self, env_spaces: EnvSpaces):
        self.action_size = env_spaces.action.shape[0]
        self.action_max = float(np.max(np.abs(env_spaces.action.high)))


class DdpgAgent(_QpgAgent):
    """mu, Q and their targets; acts with mu(s) plus Gaussian noise of
    ``initial_std``, clipped to the action bounds."""

    def __init__(self, model_kwargs=None, q_model_kwargs=None,
                 initial_std: float = 0.1, device="cuda"):
        super().__init__(model_kwargs, q_model_kwargs, device)
        self.initial_std = initial_std

    def initialize(self, env_spaces: EnvSpaces):
        self._action_bounds(env_spaces)
        mu = MuMlpModel(env_spaces.observation.shape, self.action_size,
                        output_max=self.action_max, **self.model_kwargs)
        self._build(env_spaces, "mu", mu, target_policy=True)
        self.distribution = Gaussian(dim=self.action_size,
                                     std=self.initial_std,
                                     clip=self.action_max)

    @torch.no_grad()
    def step(self, observation, prev_action, prev_reward, carry, cum_steps,
             generator, is_eval=False, noise: Optional[torch.Tensor] = None):
        mu = self.nets["mu"](observation)
        if is_eval:
            return AgentStep(mu, {}), carry
        action = self.distribution.sample(
            DistInfoStd(mu, torch.zeros_like(mu)), generator, noise)
        return AgentStep(action, {}), carry


class Td3Agent(DdpgAgent):
    """Twin critics, and target-policy smoothing: the target action is
    target_mu(s') plus noise of std ``target_noise_std`` clipped at
    ``target_noise_clip``, then clipped to the action bounds."""

    q_names = ("q1", "q2")

    def __init__(self, target_noise_std: float = 0.2,
                 target_noise_clip: float = 0.5, **kwargs):
        super().__init__(**kwargs)
        self.target_noise_std = target_noise_std
        self.target_noise_clip = target_noise_clip

    def initialize(self, env_spaces: EnvSpaces):
        super().initialize(env_spaces)
        self.target_distribution = Gaussian(
            dim=self.action_size, std=self.target_noise_std,
            noise_clip=self.target_noise_clip, clip=self.action_max)


class SacAgent(_QpgAgent):
    """A tanh-squashed Gaussian policy (log_std clamped to [-20, 2]),
    twin critics and their targets; evaluation acts with
    action_max * tanh(mu)."""

    q_names = ("q1", "q2")

    def initialize(self, env_spaces: EnvSpaces):
        self._action_bounds(env_spaces)
        pi = PiMlpModel(env_spaces.observation.shape, self.action_size,
                        **self.model_kwargs)
        self._build(env_spaces, "pi", pi, target_policy=False)
        self.distribution = Gaussian(
            dim=self.action_size, squash=self.action_max,
            min_std=float(np.exp(-20.0)), max_std=float(np.exp(2.0)))

    def pi(self, observation, generator: Optional[torch.Generator] = None,
           noise: Optional[torch.Tensor] = None):
        """Reparameterized action and its log-likelihood (the SAC
        losses)."""
        mu, log_std = self.nets["pi"](observation)
        return self.distribution.sample_with_log_prob(
            DistInfoStd(mu, log_std), generator, noise)

    @torch.no_grad()
    def step(self, observation, prev_action, prev_reward, carry, cum_steps,
             generator, is_eval=False, noise: Optional[torch.Tensor] = None):
        mu, log_std = self.nets["pi"](observation)
        if is_eval:
            return AgentStep(self.action_max * torch.tanh(mu), {}), carry
        action = self.distribution.sample(DistInfoStd(mu, log_std),
                                          generator, noise)
        return AgentStep(action, {}), carry
