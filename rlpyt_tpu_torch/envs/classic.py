"""Classic-control environments on batched tensors (port of
rlpyt_tpu/envs/classic.py: CartPole, DictObsCartPole, Pendulum, Acrobot,
MountainCar, ContinuousMountainCar).

Gym's dynamics and constants, with an internal time limit, for B lanes at
once on [B] tensors.  The only randomness is the reset's uniform values;
``draw_reset`` draws them and ``reset_batch(draws=...)`` accepts them, so
a test can inject the values JAX's per-lane keys give.  A step is
deterministic and follows the JAX package's float32 arithmetic operation
for operation; the sine and cosine are torch's, which may round the last
bit otherwise than XLA's.  ``done`` includes the time limit, and
``info["timeout"]`` flags a truncation that is not also a termination.
"""
from __future__ import annotations

import math
from typing import NamedTuple, Optional

import torch

from rlpyt_tpu_torch.envs.base import Env, EnvStep
from rlpyt_tpu_torch.spaces import Composite, FloatBox, IntBox


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


class DictObsCartPole(CartPole):
    """CartPole with a Composite observation: {"position": [x, theta],
    "velocity": [x_dot, theta_dot]}, the exerciser of dict observations
    through collection, replay and the model."""

    @property
    def observation_space(self):
        hi_pos = [self.x_threshold * 2, self.theta_threshold * 2]
        hi_vel = [3.0e2, 3.0e2]
        return Composite({
            "position": FloatBox(low=[-h for h in hi_pos], high=hi_pos,
                                 shape=(2,)),
            "velocity": FloatBox(low=[-h for h in hi_vel], high=hi_vel,
                                 shape=(2,)),
        })

    @staticmethod
    def _obs(s: CartPoleState) -> dict:
        return {"position": torch.stack([s.x, s.theta], dim=-1),
                "velocity": torch.stack([s.x_dot, s.theta_dot], dim=-1)}


class PendulumState(NamedTuple):
    theta: torch.Tensor
    theta_dot: torch.Tensor
    t: torch.Tensor


class PendulumResetDraws(NamedTuple):
    theta: torch.Tensor       # [B] uniform in [-pi, pi)
    theta_dot: torch.Tensor   # [B] uniform in [-1, 1)


class Pendulum(Env):
    """Pendulum-v1: a torque-limited swing-up, reward -(angle^2 + 0.1
    speed^2 + 0.001 torque^2), truncation only."""

    max_speed = 8.0
    max_torque = 2.0
    dt = 0.05
    g = 10.0
    m = 1.0
    length = 1.0

    def __init__(self, max_steps: int = 200, device="cuda"):
        self.max_steps = max_steps
        self.device = torch.device(device)

    @property
    def observation_space(self):
        return FloatBox(low=[-1.0, -1.0, -self.max_speed],
                        high=[1.0, 1.0, self.max_speed], shape=(3,))

    @property
    def action_space(self):
        return FloatBox(low=-self.max_torque, high=self.max_torque,
                        shape=(1,))

    @property
    def horizon(self):
        return self.max_steps

    @staticmethod
    def _obs(s: PendulumState) -> torch.Tensor:
        return torch.stack([torch.cos(s.theta), torch.sin(s.theta),
                            s.theta_dot], dim=-1)

    def draw_reset(self, n: int, generator: torch.Generator
                   ) -> PendulumResetDraws:
        u = torch.rand((2, n), generator=generator, device=generator.device)
        return PendulumResetDraws(u[0] * (2 * math.pi) - math.pi,
                                  u[1] * 2.0 - 1.0)

    def reset_batch(self, n: int, generator: Optional[torch.Generator] = None,
                    draws: Optional[PendulumResetDraws] = None):
        if draws is None:
            draws = self.draw_reset(n, generator)
        s = PendulumState(
            draws.theta.to(self.device, torch.float32),
            draws.theta_dot.to(self.device, torch.float32),
            torch.zeros((n,), dtype=torch.int32, device=self.device))
        return s, self._obs(s)

    def step_batch(self, state: PendulumState, action: torch.Tensor,
                   generator: Optional[torch.Generator] = None):
        """``action`` [B, 1]; ``generator`` is not used."""
        u = torch.clamp(action[..., 0], -self.max_torque, self.max_torque)
        th, thdot = state.theta, state.theta_dot
        norm_th = torch.remainder(th + math.pi, 2 * math.pi) - math.pi
        cost = norm_th ** 2 + 0.1 * thdot ** 2 + 0.001 * u ** 2
        newthdot = thdot + (
            3 * self.g / (2 * self.length) * torch.sin(th)
            + 3.0 / (self.m * self.length ** 2) * u) * self.dt
        newthdot = torch.clamp(newthdot, -self.max_speed, self.max_speed)
        new = PendulumState(th + newthdot * self.dt, newthdot, state.t + 1)
        truncated = new.t >= self.max_steps
        return new, EnvStep(self._obs(new), -cost, truncated,
                            {"timeout": truncated})


class AcrobotState(NamedTuple):
    theta1: torch.Tensor
    theta2: torch.Tensor
    dtheta1: torch.Tensor
    dtheta2: torch.Tensor
    t: torch.Tensor


class AcrobotResetDraws(NamedTuple):
    vals: torch.Tensor   # [B, 4] float32 in [-0.1, 0.1)


class Acrobot(Env):
    """Acrobot-v1 ("book" dynamics, one RK4 step of dt 0.2): a two-link
    swing-up with torque -1, 0 or +1 on the elbow; reward -1 a step until
    the tip rises one link length above the pivot."""

    link_length_1 = 1.0
    link_length_2 = 1.0
    link_mass_1 = 1.0
    link_mass_2 = 1.0
    link_com_1 = 0.5
    link_com_2 = 0.5
    link_moi = 1.0
    max_vel_1 = 4 * math.pi
    max_vel_2 = 9 * math.pi
    dt = 0.2
    gravity = 9.8

    def __init__(self, max_steps: int = 500, device="cuda"):
        self.max_steps = max_steps
        self.device = torch.device(device)

    @property
    def observation_space(self):
        high = [1.0, 1.0, 1.0, 1.0, float(self.max_vel_1),
                float(self.max_vel_2)]
        return FloatBox(low=[-h for h in high], high=high, shape=(6,))

    @property
    def action_space(self):
        return IntBox(0, 3)

    @property
    def horizon(self):
        return self.max_steps

    @staticmethod
    def _obs(s: AcrobotState) -> torch.Tensor:
        return torch.stack([torch.cos(s.theta1), torch.sin(s.theta1),
                            torch.cos(s.theta2), torch.sin(s.theta2),
                            s.dtheta1, s.dtheta2], dim=-1)

    def _dsdt(self, y: torch.Tensor, torque: torch.Tensor) -> torch.Tensor:
        """d/dt of y = [theta1, theta2, dtheta1, dtheta2] ([4, B])."""
        m1, m2 = self.link_mass_1, self.link_mass_2
        l1 = self.link_length_1
        lc1, lc2 = self.link_com_1, self.link_com_2
        i1 = i2 = self.link_moi
        g = self.gravity
        theta1, theta2, dtheta1, dtheta2 = y
        d1 = (m1 * lc1 ** 2 + m2 * (l1 ** 2 + lc2 ** 2
                                    + 2 * l1 * lc2 * torch.cos(theta2))
              + i1 + i2)
        d2 = m2 * (lc2 ** 2 + l1 * lc2 * torch.cos(theta2)) + i2
        phi2 = m2 * lc2 * g * torch.cos(theta1 + theta2 - math.pi / 2.0)
        phi1 = (-m2 * l1 * lc2 * dtheta2 ** 2 * torch.sin(theta2)
                - 2 * m2 * l1 * lc2 * dtheta2 * dtheta1 * torch.sin(theta2)
                + (m1 * lc1 + m2 * l1) * g * torch.cos(theta1 - math.pi / 2.0)
                + phi2)
        ddtheta2 = ((torque + d2 / d1 * phi1
                     - m2 * l1 * lc2 * dtheta1 ** 2 * torch.sin(theta2)
                     - phi2)
                    / (m2 * lc2 ** 2 + i2 - d2 ** 2 / d1))
        ddtheta1 = -(d2 * ddtheta2 + phi1) / d1
        return torch.stack([dtheta1, dtheta2, ddtheta1, ddtheta2])

    def draw_reset(self, n: int, generator: torch.Generator
                   ) -> AcrobotResetDraws:
        u = torch.rand((n, 4), generator=generator, device=generator.device)
        return AcrobotResetDraws(u * 0.2 - 0.1)

    def reset_batch(self, n: int, generator: Optional[torch.Generator] = None,
                    draws: Optional[AcrobotResetDraws] = None):
        if draws is None:
            draws = self.draw_reset(n, generator)
        v = draws.vals.to(self.device, torch.float32)
        s = AcrobotState(v[:, 0], v[:, 1], v[:, 2], v[:, 3],
                         torch.zeros((n,), dtype=torch.int32,
                                     device=self.device))
        return s, self._obs(s)

    def step_batch(self, state: AcrobotState, action: torch.Tensor,
                   generator: Optional[torch.Generator] = None):
        """``action`` [B] in {0, 1, 2}; ``generator`` is not used."""
        torque = (action - 1).to(torch.float32)
        y0 = torch.stack([state.theta1, state.theta2, state.dtheta1,
                          state.dtheta2])
        h = self.dt
        k1 = self._dsdt(y0, torque)
        k2 = self._dsdt(y0 + h / 2.0 * k1, torque)
        k3 = self._dsdt(y0 + h / 2.0 * k2, torque)
        k4 = self._dsdt(y0 + h * k3, torque)
        y = y0 + h / 6.0 * (k1 + 2 * k2 + 2 * k3 + k4)

        def wrap(x):
            return torch.remainder(x + math.pi, 2 * math.pi) - math.pi

        theta1, theta2 = wrap(y[0]), wrap(y[1])
        new = AcrobotState(
            theta1, theta2,
            torch.clamp(y[2], -self.max_vel_1, self.max_vel_1),
            torch.clamp(y[3], -self.max_vel_2, self.max_vel_2), state.t + 1)
        terminated = -torch.cos(theta1) - torch.cos(theta2 + theta1) > 1.0
        truncated = new.t >= self.max_steps
        reward = torch.where(terminated, 0.0, -1.0)
        return new, EnvStep(self._obs(new), reward, terminated | truncated,
                            {"timeout": truncated & ~terminated})


class MountainCarState(NamedTuple):
    position: torch.Tensor
    velocity: torch.Tensor
    t: torch.Tensor


class MountainCarResetDraws(NamedTuple):
    position: torch.Tensor   # [B] uniform in [-0.6, -0.4)


class MountainCar(Env):
    """MountainCar-v0: push left, none or right (actions 0, 1, 2); reward
    -1 a step until the car reaches the goal."""

    min_position = -1.2
    max_position = 0.6
    max_speed = 0.07
    goal_position = 0.5
    force = 0.001
    gravity = 0.0025

    def __init__(self, max_steps: int = 200, device="cuda"):
        self.max_steps = max_steps
        self.device = torch.device(device)

    @property
    def observation_space(self):
        return FloatBox(low=[self.min_position, -self.max_speed],
                        high=[self.max_position, self.max_speed], shape=(2,))

    @property
    def action_space(self):
        return IntBox(0, 3)

    @property
    def horizon(self):
        return self.max_steps

    @staticmethod
    def _obs(s: MountainCarState) -> torch.Tensor:
        return torch.stack([s.position, s.velocity], dim=-1)

    def draw_reset(self, n: int, generator: torch.Generator
                   ) -> MountainCarResetDraws:
        u = torch.rand((n,), generator=generator, device=generator.device)
        return MountainCarResetDraws(u * 0.2 - 0.6)

    def reset_batch(self, n: int, generator: Optional[torch.Generator] = None,
                    draws: Optional[MountainCarResetDraws] = None):
        if draws is None:
            draws = self.draw_reset(n, generator)
        position = draws.position.to(self.device, torch.float32)
        s = MountainCarState(position, torch.zeros_like(position),
                             torch.zeros((n,), dtype=torch.int32,
                                         device=self.device))
        return s, self._obs(s)

    def step_batch(self, state: MountainCarState, action: torch.Tensor,
                   generator: Optional[torch.Generator] = None):
        """``action`` [B] in {0, 1, 2}; ``generator`` is not used."""
        velocity = state.velocity + (action - 1) * self.force + torch.cos(
            3 * state.position) * (-self.gravity)
        velocity = torch.clamp(velocity, -self.max_speed, self.max_speed)
        position = torch.clamp(state.position + velocity,
                               self.min_position, self.max_position)
        velocity = torch.where(
            (position <= self.min_position) & (velocity < 0), 0.0, velocity)
        new = MountainCarState(position, velocity, state.t + 1)
        terminated = position >= self.goal_position
        truncated = new.t >= self.max_steps
        return new, EnvStep(self._obs(new), torch.full_like(position, -1.0),
                            terminated | truncated,
                            {"timeout": truncated & ~terminated})


class ContinuousMountainCar(MountainCar):
    """MountainCarContinuous-v0: a force in [-1, 1]; +100 at the goal,
    -0.1 force^2 a step.  Positions, resets and observations are
    MountainCar's."""

    goal_position = 0.45
    power = 0.0015

    def __init__(self, max_steps: int = 999, device="cuda"):
        super().__init__(max_steps, device)

    @property
    def action_space(self):
        return FloatBox(low=-1.0, high=1.0, shape=(1,))

    def step_batch(self, state: MountainCarState, action: torch.Tensor,
                   generator: Optional[torch.Generator] = None):
        """``action`` [B, 1]; ``generator`` is not used."""
        force = torch.clamp(action[..., 0], -1.0, 1.0)
        velocity = state.velocity + force * self.power - 0.0025 * torch.cos(
            3 * state.position)
        velocity = torch.clamp(velocity, -self.max_speed, self.max_speed)
        position = torch.clamp(state.position + velocity,
                               self.min_position, self.max_position)
        velocity = torch.where(
            (position <= self.min_position) & (velocity < 0), 0.0, velocity)
        new = MountainCarState(position, velocity, state.t + 1)
        terminated = position >= self.goal_position
        truncated = new.t >= self.max_steps
        reward = torch.where(terminated, 100.0, 0.0) - 0.1 * force ** 2
        return new, EnvStep(self._obs(new), reward, terminated | truncated,
                            {"timeout": truncated & ~terminated})
