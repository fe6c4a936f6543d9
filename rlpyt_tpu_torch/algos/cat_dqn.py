"""Categorical DQN / C51 (port of rlpyt_tpu/algos/cat_dqn.py).

DQN with the scalar TD loss replaced by the distributional Bellman
backup: the shifted support r + discount^n z is projected onto the fixed
support (ops/value.py:categorical_projection) and the loss is the
cross-entropy against it; |KL| is the priority under prioritized replay.
With double_dqn, a dueling model, prioritized replay and n-step returns
this is the "ernbw" configuration (Rainbow without noisy nets).
"""
from __future__ import annotations

import torch

from rlpyt_tpu_torch.algos.dqn import DQN
from rlpyt_tpu_torch.ops.value import categorical_projection
from rlpyt_tpu_torch.replay.base import SamplesFromReplay


class CategoricalDQN(DQN):
    def __init__(self, *args, v_min: float = -10.0, v_max: float = 10.0,
                 n_atoms: int = 51, **kwargs):
        super().__init__(*args, **kwargs)
        self.v_min = v_min
        self.v_max = v_max
        self.n_atoms = n_atoms

    def initialize(self, agent, batch_spec, example_obs, generator,
                   n_itr: int = 1):
        # The agent's atom support is authoritative if it defines one.
        if hasattr(agent, "v_min"):
            self.v_min, self.v_max = agent.v_min, agent.v_max
            self.n_atoms = agent.n_atoms
        super().initialize(agent, batch_spec, example_obs, generator,
                           n_itr)
        self.z = torch.linspace(self.v_min, self.v_max, self.n_atoms,
                                device=agent.device)

    def loss(self, batch: SamplesFromReplay):
        """Distributional backup; returns (scalar loss, |KL| per sample)."""
        z = self.z
        n = batch.action.shape[0]
        rows = torch.arange(n, device=z.device)
        ps = self.model(*batch.agent_inputs)            # [batch, A, n_atoms]
        p = ps[rows, batch.action.long()]
        with torch.no_grad():
            target_ps = self.target_model(*batch.target_inputs)
            next_ps = self.model(*batch.target_inputs) if self.double_dqn \
                else target_ps
            next_a = torch.argmax((next_ps * z).sum(-1), dim=-1)
            proj = categorical_projection(
                target_ps[rows, next_a], batch.return_,
                1.0 - batch.done_n.to(torch.float32), z,
                discount_n=self.discount ** self.n_step)
        ce = -(proj * torch.log(torch.clamp(p, min=1e-8))).sum(-1)
        kl = ce.detach() + torch.where(
            proj > 0, proj * torch.log(torch.clamp(proj, min=1e-8)),
            0.0).sum(-1)
        # Time-limit truncations have no valid bootstrap obs: mask them.
        valid = 1.0 - batch.timeout_n.to(torch.float32)
        losses = ce * batch.is_weights * valid
        return self._mean(losses, valid), kl.abs() * valid
