"""Classic-control environments on batched tensors (port of
rlpyt_tpu/envs/classic.py: CartPoleState, CartPole).

CartPole-v1 dynamics with gym's constants, Euler integration and an
internal time limit, for B lanes at once on [B] tensors.  The only
randomness is the reset's four uniform values in [-0.05, 0.05);
``draw_reset`` draws them and ``reset_batch(draws=...)`` accepts them, so
a test can inject the values JAX's per-lane keys give.  The step is
deterministic and follows the JAX package's float32 arithmetic operation
for operation; the sine and cosine are torch's, which may round the last
bit otherwise than XLA's.
"""
from __future__ import annotations

import math
from typing import NamedTuple, Optional

import torch

from rlpyt_tpu_torch.envs.base import Env, EnvStep
from rlpyt_tpu_torch.spaces import FloatBox, IntBox


class CartPoleState(NamedTuple):
    x: torch.Tensor
    x_dot: torch.Tensor
    theta: torch.Tensor
    theta_dot: torch.Tensor
    t: torch.Tensor   # int32 step counter for the time limit


class CartPoleResetDraws(NamedTuple):
    vals: torch.Tensor   # [B, 4] float32 in [-0.05, 0.05)


class CartPole(Env):
    gravity = 9.8
    masscart = 1.0
    masspole = 0.1
    total_mass = masspole + masscart
    length = 0.5
    polemass_length = masspole * length
    force_mag = 10.0
    tau = 0.02
    theta_threshold = 12 * 2 * math.pi / 360
    x_threshold = 2.4

    def __init__(self, max_steps: int = 500, device="cuda"):
        self.max_steps = max_steps
        self.device = torch.device(device)

    @property
    def observation_space(self):
        high = [self.x_threshold * 2, 3.0e2, self.theta_threshold * 2, 3.0e2]
        return FloatBox(low=[-h for h in high], high=high, shape=(4,))

    @property
    def action_space(self):
        return IntBox(0, 2)

    @property
    def horizon(self):
        return self.max_steps

    @staticmethod
    def _obs(s: CartPoleState) -> torch.Tensor:
        return torch.stack([s.x, s.x_dot, s.theta, s.theta_dot], dim=-1)

    def draw_reset(self, n: int, generator: torch.Generator
                   ) -> CartPoleResetDraws:
        u = torch.rand((n, 4), generator=generator, device=generator.device)
        return CartPoleResetDraws(u * 0.1 - 0.05)

    def reset_batch(self, n: int, generator: Optional[torch.Generator] = None,
                    draws: Optional[CartPoleResetDraws] = None):
        if draws is None:
            draws = self.draw_reset(n, generator)
        v = draws.vals.to(self.device, torch.float32)
        s = CartPoleState(v[:, 0], v[:, 1], v[:, 2], v[:, 3],
                          torch.zeros((n,), dtype=torch.int32,
                                      device=self.device))
        return s, self._obs(s)

    def step_batch(self, state: CartPoleState, action: torch.Tensor,
                   generator: Optional[torch.Generator] = None):
        """One step of every lane; ``generator`` is not used (the step is
        deterministic)."""
        s = state
        force = torch.where(action == 1, self.force_mag, -self.force_mag)
        costheta = torch.cos(s.theta)
        sintheta = torch.sin(s.theta)
        temp = (force + self.polemass_length * s.theta_dot ** 2 * sintheta
                ) / self.total_mass
        thetaacc = (self.gravity * sintheta - costheta * temp) / (
            self.length * (4.0 / 3.0 - self.masspole * costheta ** 2
                           / self.total_mass))
        xacc = temp - self.polemass_length * thetaacc * costheta \
            / self.total_mass
        new = CartPoleState(s.x + self.tau * s.x_dot,
                            s.x_dot + self.tau * xacc,
                            s.theta + self.tau * s.theta_dot,
                            s.theta_dot + self.tau * thetaacc, s.t + 1)
        terminated = ((new.x.abs() > self.x_threshold)
                      | (new.theta.abs() > self.theta_threshold))
        truncated = new.t >= self.max_steps
        reward = torch.ones_like(new.x)
        return new, EnvStep(self._obs(new), reward, terminated | truncated,
                            {"timeout": truncated & ~terminated})
