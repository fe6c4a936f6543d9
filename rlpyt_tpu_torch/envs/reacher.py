"""Reacher on batched tensors (port of rlpyt_tpu/envs/reacher.py): a
two-link planar arm in the horizontal plane, torque control, reach a
target drawn in a disk.

Closed-form manipulator dynamics M(q) q'' + C(q, q') = tau - b q', two
semi-implicit Euler substeps a step, joint speeds clipped at 20.  The
observation is gymnasium Reacher-v5's layout:
[cos q (2), sin q (2), target (2), q' (2), fingertip - target (2)];
the reward is -|fingertip - target| - 0.1 |a|^2; episodes end only at the
time limit.  The reset's uniform values (joint angles, the target's
radius draw and angle) come from ``draw_reset`` or are injected through
``reset_batch(draws=...)``.
"""
from __future__ import annotations

import math
from typing import NamedTuple, Optional

import torch

from rlpyt_tpu_torch.envs.base import Env, EnvStep
from rlpyt_tpu_torch.spaces import FloatBox


class ReacherState(NamedTuple):
    q: torch.Tensor        # [B, 2] joint angles
    qd: torch.Tensor       # [B, 2] joint speeds
    target: torch.Tensor   # [B, 2] goal in the plane
    t: torch.Tensor


class ReacherResetDraws(NamedTuple):
    q: torch.Tensor       # [B, 2] uniform in [-0.1, 0.1)
    r: torch.Tensor       # [B] uniform in [0.0025, 1): radius^2 fraction
    angle: torch.Tensor   # [B] uniform in [-pi, pi)


class Reacher(Env):
    l1 = 0.1
    l2 = 0.11
    m1 = 0.05
    m2 = 0.05
    damping = 0.001
    gear = 0.01
    dt = 0.01
    substeps = 2
    target_radius = 0.2
    ctrl_cost = 0.1
    max_vel = 20.0

    def __init__(self, max_steps: int = 50, device="cuda"):
        self.max_steps = max_steps
        self.device = torch.device(device)

    @property
    def observation_space(self):
        return FloatBox(low=-math.inf, high=math.inf, shape=(10,))

    @property
    def action_space(self):
        return FloatBox(low=-1.0, high=1.0, shape=(2,))

    @property
    def horizon(self):
        return self.max_steps

    def _fingertip(self, q: torch.Tensor) -> torch.Tensor:
        q0, q01 = q[..., 0], q[..., 0] + q[..., 1]
        x = self.l1 * torch.cos(q0) + self.l2 * torch.cos(q01)
        y = self.l1 * torch.sin(q0) + self.l2 * torch.sin(q01)
        return torch.stack([x, y], dim=-1)

    def _obs(self, s: ReacherState) -> torch.Tensor:
        delta = self._fingertip(s.q) - s.target
        return torch.cat([torch.cos(s.q), torch.sin(s.q), s.target, s.qd,
                          delta], dim=-1)

    def _qdd(self, q, qd, tau):
        lc1, lc2 = self.l1 / 2, self.l2 / 2
        i1 = self.m1 * self.l1 ** 2 / 12.0
        i2 = self.m2 * self.l2 ** 2 / 12.0
        c2, s2 = torch.cos(q[..., 1]), torch.sin(q[..., 1])
        a1 = i1 + i2 + self.m1 * lc1 ** 2 + self.m2 * (self.l1 ** 2
                                                        + lc2 ** 2)
        a2 = self.m2 * self.l1 * lc2
        a3 = i2 + self.m2 * lc2 ** 2
        m11 = a1 + 2 * a2 * c2
        m12 = a3 + a2 * c2
        m22 = a3
        c1 = -a2 * s2 * qd[..., 1] * (2 * qd[..., 0] + qd[..., 1])
        cc2 = a2 * s2 * qd[..., 0] ** 2
        rhs = tau - self.damping * qd - torch.stack([c1, cc2], dim=-1)
        det = m11 * m22 - m12 * m12
        qdd0 = (m22 * rhs[..., 0] - m12 * rhs[..., 1]) / det
        qdd1 = (m11 * rhs[..., 1] - m12 * rhs[..., 0]) / det
        return torch.stack([qdd0, qdd1], dim=-1)

    def draw_reset(self, n: int, generator: torch.Generator
                   ) -> ReacherResetDraws:
        u = torch.rand((n, 4), generator=generator, device=generator.device)
        return ReacherResetDraws(u[:, :2] * 0.2 - 0.1,
                                 0.0025 + u[:, 2] * 0.9975,
                                 u[:, 3] * (2 * math.pi) - math.pi)

    def reset_batch(self, n: int, generator: Optional[torch.Generator] = None,
                    draws: Optional[ReacherResetDraws] = None):
        if draws is None:
            draws = self.draw_reset(n, generator)
        d = ReacherResetDraws(*(x.to(self.device, torch.float32)
                                for x in draws))
        r = self.target_radius * torch.sqrt(d.r)
        target = torch.stack([r * torch.cos(d.angle),
                              r * torch.sin(d.angle)], dim=-1)
        s = ReacherState(d.q, torch.zeros_like(d.q), target,
                         torch.zeros((n,), dtype=torch.int32,
                                     device=self.device))
        return s, self._obs(s)

    def step_batch(self, state: ReacherState, action: torch.Tensor,
                   generator: Optional[torch.Generator] = None):
        """``action`` [B, 2]; ``generator`` is not used."""
        tau = self.gear * torch.clamp(action, -1.0, 1.0)
        q, qd = state.q, state.qd
        for _ in range(self.substeps):
            qdd = self._qdd(q, qd, tau)
            qd = torch.clamp(qd + self.dt * qdd, -self.max_vel, self.max_vel)
            q = q + self.dt * qd
        new = ReacherState(q, qd, state.target, state.t + 1)
        dist = torch.linalg.vector_norm(self._fingertip(q) - state.target,
                                        dim=-1)
        reward = -dist - self.ctrl_cost * torch.sum(action ** 2, dim=-1)
        truncated = new.t >= self.max_steps
        return new, EnvStep(self._obs(new), reward, truncated,
                            {"timeout": truncated})
