"""Planar locomotion on batched tensors (port of
rlpyt_tpu/envs/locomotion.py: ChainSpec, _link_frames, _contact_points,
PlanarChainEnv, Hopper2D, Cheetah2D).

Each robot is a planar chain in generalized coordinates
q = [x, z, theta_0 .. theta_{n-1}] (absolute link angles); link i starts
on its parent link (or at the base point (x, z)) and extends
``length[i]`` along (sin theta_i, -cos theta_i).  Ground contact is a
spring-damper normal force with Coulomb-capped viscous friction at fixed
points.  16 semi-implicit Euler substeps of 2 ms make one step.

The JAX package derives the equations of motion by autodiff of the
Lagrangian (a Hessian for M, a gradient and a Jacobian of a gradient for
the rest).  The port writes the same equations in closed form, batched
over lanes.  Every point the dynamics use (link centres of mass, contact
points) is p = (x, z) + sum_a W[p, a] dir_a with a constant matrix W,
so its Jacobian has columns (1, 0), (0, 1) and W[p, a] perp_a with
perp_a = (cos theta_a, sin theta_a), and J' q' = -sum_a W[p, a]
theta'_a^2 dir_a.  L is quadratic in q', so

    M(q)  = sum_i m_i J_i^T J_i + diag(0, 0, I)
    M q'' = sum_i J_i^T (m_i sum_a W[i, a] theta'_a^2 dir_a - m_i g e_z)
            + J_c^T F_contact + Q_action - damping

which is the JAX package's M q'' = dL/dq - (d^2L/dq' dq) q' + Q term for
term; the two agree to float32 rounding, not bit for bit.
"""
from __future__ import annotations

import math
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from rlpyt_tpu_torch.envs.base import Env, EnvStep
from rlpyt_tpu_torch.spaces import FloatBox


class ChainSpec(NamedTuple):
    """A planar articulated tree: link i starts ``attach_frac[i]`` along
    its parent link ``parents[i]`` (-1: the base point (x, z)) and extends
    ``lengths[i]`` along (sin theta_i, -cos theta_i).  ``joints``:
    (link_a, link_b, torque_scale), the torque acting + on b and - on a;
    ``contacts``: (link, fraction along it)."""

    lengths: Tuple[float, ...]
    masses: Tuple[float, ...]
    parents: Tuple[int, ...]
    attach_frac: Tuple[float, ...]
    joints: Tuple[Tuple[int, int, float], ...]
    contacts: Tuple[Tuple[int, float], ...]


def _start_weights(spec: ChainSpec) -> np.ndarray:
    """S [n, n]: link i starts at base + sum_a S[i, a] dir_a."""
    n = len(spec.lengths)
    S = np.zeros((n, n))
    for i, p in enumerate(spec.parents):
        if p >= 0:
            S[i] = S[p]
            S[i, p] += spec.attach_frac[i] * spec.lengths[p]
    return S


def _point_weights(spec: ChainSpec) -> Tuple[np.ndarray, np.ndarray]:
    """(W_com [n, n], W_contact [c, n]): the centres of mass and the
    contact points as base + W @ dirs."""
    S = _start_weights(spec)
    n = len(spec.lengths)
    com = S + np.diag(0.5 * np.asarray(spec.lengths))
    contact = np.stack([S[l] + np.eye(n)[l] * f * spec.lengths[l]
                        for l, f in spec.contacts])
    return com, contact


def _directions(q: torch.Tensor):
    """(dirs, perps) [..., n, 2]: (sin, -cos) and (cos, sin) of each
    link angle."""
    s, c = torch.sin(q[..., 2:]), torch.cos(q[..., 2:])
    return torch.stack([s, -c], dim=-1), torch.stack([c, s], dim=-1)


def _points(W: torch.Tensor, q: torch.Tensor, dirs: torch.Tensor
            ) -> torch.Tensor:
    """base + W @ dirs: [..., P, 2]."""
    return q[..., None, :2] + torch.einsum("pa,...ak->...pk", W, dirs)


def _link_frames(spec: ChainSpec, q: torch.Tensor):
    """Start points, directions and centres of mass of every link,
    [..., n, 2] each."""
    S = torch.as_tensor(_start_weights(spec), dtype=q.dtype,
                        device=q.device)
    dirs, _ = _directions(q)
    starts = _points(S, q, dirs)
    lengths = torch.as_tensor(spec.lengths, dtype=q.dtype, device=q.device)
    return starts, dirs, starts + dirs * lengths[:, None] * 0.5


def _contact_points(spec: ChainSpec, q: torch.Tensor) -> torch.Tensor:
    """The contact points, [..., c, 2]."""
    _, W = _point_weights(spec)
    dirs, _ = _directions(q)
    return _points(torch.as_tensor(W, dtype=q.dtype, device=q.device), q,
                   dirs)


class PlanarChainState(NamedTuple):
    q: torch.Tensor    # [B, nq]
    qd: torch.Tensor   # [B, nq]
    t: torch.Tensor


class PlanarChainResetDraws(NamedTuple):
    dq: torch.Tensor   # [B, n] uniform in [-5e-3, 5e-3): link angle noise
    qd: torch.Tensor   # [B, nq] uniform in [-5e-3, 5e-3)


class PlanarChainEnv(Env):
    """Base planar-locomotion env; subclasses set the chain, the initial
    pose, the health test and the reward."""

    gravity = 9.81
    dt = 0.002
    n_frames = 16         # physics substeps per env step
    contact_kp = 6_000.0
    contact_kd = 300.0
    friction_visc = 30.0
    friction_mu = 1.0
    joint_damping = 0.5

    spec: ChainSpec = None
    init_height = 1.3
    init_angles: Tuple[float, ...] = ()

    def __init__(self, max_steps: int = 1000, device="cuda"):
        self.max_steps = max_steps
        self.device = torch.device(device)
        spec = self.spec
        n = len(spec.lengths)
        self.nq = 2 + n
        self.na = len(spec.joints)
        f32 = dict(dtype=torch.float32, device=self.device)
        W_com, W_contact = _point_weights(spec)
        self._n_links = n
        # Centres of mass first, then the contact points.
        self._W = torch.as_tensor(np.concatenate([W_com, W_contact]), **f32)
        self._masses = torch.as_tensor(spec.masses, **f32)
        # The links' rotational inertia (uniform rods about their
        # centres) and the JAX package's 1e-9 I regularizer.
        inertia = [0.0, 0.0] + [m * l * l / 12.0 for m, l in
                                zip(spec.masses, spec.lengths)]
        self._M0 = torch.as_tensor(np.diag(inertia) + 1e-9 * np.eye(
            self.nq), **f32)
        act = np.zeros((self.na, self.nq))
        for k, (a, b, scale) in enumerate(spec.joints):
            act[k, 2 + b] += scale
            act[k, 2 + a] -= scale
        self._act = torch.as_tensor(act, **f32)
        self._damp = torch.as_tensor(
            [0.0, 0.0] + [-self.joint_damping] * n, **f32)
        self._gravity = torch.as_tensor([0.0, -self.gravity], **f32)
        self._eye2 = torch.eye(2, **f32)
        self._init_q = torch.as_tensor(
            [0.0, self.init_height] + list(self.init_angles), **f32)

    @property
    def observation_space(self):
        d = 2 * self.nq - 1   # [z, theta.., x', z', theta'..]
        return FloatBox(low=[-1e3] * d, high=[1e3] * d, shape=(d,))

    @property
    def action_space(self):
        return FloatBox(low=[-1.0] * self.na, high=[1.0] * self.na,
                        shape=(self.na,))

    @property
    def horizon(self):
        return self.max_steps

    def _qdd(self, q: torch.Tensor, qd: torch.Tensor,
             action: torch.Tensor) -> torch.Tensor:
        """q'' [B, nq] at (q, q') under ``action`` [B, na]."""
        n = self._n_links
        dirs, perps = _directions(q)
        W = self._W
        # Jacobians of all points, [B, P, nq, 2].
        J_theta = W[:, :, None] * perps[:, None]
        J_base = self._eye2.expand(
            J_theta.shape[:2] + (2, 2))
        J = torch.cat([J_base, J_theta], dim=2)
        pts = _points(W, q, dirs)
        vel = torch.einsum("bpqk,bq->bpk", J, qd)
        # Centres of mass: the mass matrix, -m J' q' and gravity.
        J_com, m = J[:, :n], self._masses
        M = torch.einsum("bpqk,p,bprk->bqr", J_com, m, J_com) + self._M0
        centripetal = torch.einsum("pa,bak->bpk", W[:n],
                                   qd[:, 2:, None] ** 2 * dirs)
        F_com = m[:, None] * (centripetal + self._gravity)
        # Contact points: spring-damper normal force, capped friction.
        depth = -pts[:, n:, 1]
        v_c = vel[:, n:]
        in_contact = depth > 0.0
        fn = torch.where(
            in_contact,
            self.contact_kp * depth
            - self.contact_kd * torch.clamp(v_c[..., 1], max=0.0), 0.0)
        fn = torch.clamp(fn, min=0.0)
        ft = -self.friction_visc * v_c[..., 0] * in_contact
        ft = torch.minimum(torch.maximum(ft, -self.friction_mu * fn),
                           self.friction_mu * fn)
        F = torch.cat([F_com, torch.stack([ft, fn], dim=-1)], dim=1)
        rhs = (torch.einsum("bpqk,bpk->bq", J, F)
               + torch.clamp(action, -1.0, 1.0) @ self._act
               + self._damp * qd)
        return torch.linalg.solve_ex(M, rhs[..., None])[0][..., 0]

    def draw_reset(self, n: int, generator: torch.Generator
                   ) -> PlanarChainResetDraws:
        u = torch.rand((n, self._n_links + self.nq), generator=generator,
                       device=generator.device)
        u = u * 1e-2 - 5e-3
        return PlanarChainResetDraws(u[:, :self._n_links],
                                     u[:, self._n_links:])

    def reset_batch(self, n: int, generator: Optional[torch.Generator] = None,
                    draws: Optional[PlanarChainResetDraws] = None):
        if draws is None:
            draws = self.draw_reset(n, generator)
        dq = draws.dq.to(self.device, torch.float32)
        q = self._init_q.expand(n, self.nq).clone()
        q[:, 2:] = q[:, 2:] + dq
        s = PlanarChainState(q, draws.qd.to(self.device, torch.float32),
                             torch.zeros((n,), dtype=torch.int32,
                                         device=self.device))
        return s, self._obs(s)

    @staticmethod
    def _obs(s: PlanarChainState) -> torch.Tensor:
        return torch.cat([s.q[:, 1:], s.qd], dim=-1)

    def _healthy(self, q, qd) -> torch.Tensor:
        raise NotImplementedError

    def _reward(self, q, qd, q_new, qd_new, action) -> torch.Tensor:
        raise NotImplementedError

    @torch.no_grad()
    def step_batch(self, state: PlanarChainState, action: torch.Tensor,
                   generator: Optional[torch.Generator] = None):
        """``action`` [B, na]; ``generator`` is not used."""
        action = action.to(torch.float32)
        q, qd = state.q, state.qd
        for _ in range(self.n_frames):
            qd = torch.clamp(qd + self.dt * self._qdd(q, qd, action),
                             -100.0, 100.0)
            q = q + self.dt * qd
        new = PlanarChainState(q, qd, state.t + 1)
        terminated = ~self._healthy(q, qd)
        truncated = new.t >= self.max_steps
        reward = self._reward(state.q, state.qd, q, qd, action)
        return new, EnvStep(self._obs(new), reward, terminated | truncated,
                            {"timeout": truncated & ~terminated})

    def _forward_speed(self, q, q_new) -> torch.Tensor:
        return (q_new[:, 0] - q[:, 0]) / (self.dt * self.n_frames)


class Hopper2D(PlanarChainEnv):
    """One-legged hopper: torso, thigh, shin and foot, 3 joint torques,
    heel, toe and torso-top contacts; reward forward speed + 1 - 1e-3
    |a|^2; ends when the torso drops below 0.8 or pitches past 0.6."""

    spec = ChainSpec(
        lengths=(0.40, 0.45, 0.50, 0.39),
        masses=(3.53, 3.93, 2.71, 5.09),
        parents=(-1, 0, 1, 2),
        attach_frac=(0.0, 1.0, 1.0, 1.0),
        joints=((0, 1, 75.0), (1, 2, 75.0), (2, 3, 45.0)),
        contacts=((3, 0.0), (3, 1.0), (0, 0.0)),
    )
    init_height = 1.40
    init_angles = (0.0, 0.0, 0.0, math.pi / 2)

    def _healthy(self, q, qd):
        return ((q[:, 1] > 0.80) & (q[:, 2].abs() < 0.6)
                & torch.isfinite(q).all(-1) & (qd.abs() < 100.0).all(-1))

    def _reward(self, q, qd, q_new, qd_new, action):
        return (self._forward_speed(q, q_new) + 1.0
                - 1e-3 * torch.sum(action ** 2, dim=-1))


class Cheetah2D(PlanarChainEnv):
    """Planar runner: a near-horizontal torso with a two-link leg at each
    end, 4 joint torques, a contact at each foot and torso end; reward
    forward speed - 0.05 |a|^2; no termination but a non-finite state."""

    spec = ChainSpec(
        lengths=(1.0, 0.29, 0.30, 0.27, 0.29),
        masses=(6.36, 1.54, 1.59, 1.44, 1.20),
        parents=(-1, 0, 1, 0, 3),
        attach_frac=(0.0, 0.0, 1.0, 1.0, 1.0),
        joints=((0, 1, 90.0), (1, 2, 60.0), (0, 3, 90.0), (3, 4, 60.0)),
        contacts=((2, 1.0), (4, 1.0), (0, 0.0), (0, 1.0)),
    )
    init_height = 0.7
    init_angles = (math.pi / 2, 0.0, 0.0, 0.0, 0.0)

    def _healthy(self, q, qd):
        return torch.isfinite(q).all(-1) & (qd.abs() < 100.0).all(-1)

    def _reward(self, q, qd, q_new, qd_new, action):
        return (self._forward_speed(q, q_new)
                - 0.05 * torch.sum(action ** 2, dim=-1))
