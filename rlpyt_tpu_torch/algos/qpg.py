"""Q-value policy-gradient algorithms (port of rlpyt_tpu/algos/qpg.py:
QpgBase, DDPG, TD3, SAC).

Per iteration: append the [T, B] batch to uniform replay, then, once
``min_steps_learn`` env steps have been taken (a host count, no device
read), ``updates_per_optimize = max(1, int(replay_ratio * T * B /
batch_size))`` updates, each on its own replay batch.  An update follows
the JAX package step for step:

1. the critics take a step on 0.5 (y - Q)^2, with the target
   y = R + gamma^n (1 - done_n) Q_target(s', a') computed without a graph;
2. the policy's loss is taken with the critics just stepped, and the
   policy steps (TD3: only every ``policy_update_interval``-th update,
   though its loss and grad norm are reported on every one);
3. SAC steps log alpha on -mean(log alpha (log pi + target entropy)),
   with the log pi of that same policy sample, over the whole batch;
4. the targets move by Polyak averaging (TD3's target mu only when mu
   stepped).

As ``jax.value_and_grad`` differentiates one parameter group at a time,
each loss is differentiated by ``torch.autograd.grad`` with respect to
its own group only: the policy loss leaves no gradient on the critics.
Losses are means over valid samples, 1 - timeout_n.  The infos stay on
the device and are averaged over the iteration's updates.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from rlpyt_tpu_torch.algos.base import RlAlgorithm, global_norm, \
    make_optimizer
from rlpyt_tpu_torch.distributions.gaussian import DistInfoStd
from rlpyt_tpu_torch.ops.value import polyak_update
from rlpyt_tpu_torch.replay.base import SamplesFromReplay, SamplesToBuffer
from rlpyt_tpu_torch.replay.uniform import UniformReplayBuffer
from rlpyt_tpu_torch.utils.profiling import spanned


class QpgOptInfo(NamedTuple):
    q_loss: torch.Tensor
    pi_loss: torch.Tensor
    q_grad_norm: torch.Tensor
    pi_grad_norm: torch.Tensor
    alpha: torch.Tensor


def _step(loss: torch.Tensor, groups) -> list:
    """Gradients of ``loss`` for the parameters of ``groups`` only
    ((optimizer, params) pairs), then one step of each optimizer; returns
    each group's global grad norm before clipping."""
    params = [p for _, group in groups for p in group]
    grads = iter(torch.autograd.grad(loss, params))
    norms = []
    for optimizer, group in groups:
        for p in group:
            p.grad = next(grads)
        norms.append(optimizer.step())
    return norms


class QpgBase(RlAlgorithm):
    """Replay and the append-then-update loop shared by DDPG, TD3 and
    SAC."""

    policy_name = "mu"
    # The target networks are in the agent's model (agent.nets).
    state_attrs = ("optimizers", "update_counter", "replay")

    def __init__(self, discount: float = 0.99, batch_size: int = 256,
                 min_steps_learn: int = int(1e4),
                 replay_size: int = int(1e6), replay_ratio: float = 256.0,
                 target_update_tau: float = 0.005, n_step_return: int = 1,
                 learning_rate: float = 3e-4,
                 q_learning_rate: Optional[float] = None,
                 clip_grad_norm: Optional[float] = None):
        self.discount = discount
        self.batch_size = batch_size
        self.min_steps_learn = min_steps_learn
        self.replay_size = replay_size
        self.replay_ratio = replay_ratio
        self.target_update_tau = target_update_tau
        self.n_step = n_step_return
        self.learning_rate = learning_rate
        self.q_learning_rate = q_learning_rate or learning_rate
        self.clip_grad_norm = clip_grad_norm

    def initialize(self, agent, batch_spec, example_obs, generator,
                   n_itr: int = 1):
        """Optimizers (Adam; the policy at ``learning_rate``, each critic
        at ``q_learning_rate``) and the replay; ``generator`` draws the
        replay batches and the updates' noise."""
        self.agent = agent
        self.batch_spec = batch_spec
        self.generator = generator
        self.updates_per_optimize = max(
            1, int(self.replay_ratio * batch_spec.size / self.batch_size))
        nets = agent.nets
        self.optimizers = {self.policy_name: make_optimizer(
            nets[self.policy_name].parameters(), self.learning_rate,
            self.clip_grad_norm, shard=self.shard)}
        for name in agent.q_names:
            self.optimizers[name] = make_optimizer(
                nets[name].parameters(), self.q_learning_rate,
                self.clip_grad_norm, shard=self.shard)
        self.update_counter = 0
        dev = agent.device
        self.replay = UniformReplayBuffer(
            size=self.replay_size, B=batch_spec.B, sample_T=batch_spec.T,
            discount=self.discount, n_step_return=self.n_step, device=dev,
            shard=self.shard)
        self.replay.init(SamplesToBuffer(
            observation=example_obs[0],
            action=agent.env_spaces.action.null_value(dev),
            reward=torch.zeros((), device=dev),
            done=torch.zeros((), dtype=torch.bool, device=dev),
            timeout=torch.zeros((), dtype=torch.bool, device=dev)))

    def samples_to_buffer(self, samples) -> SamplesToBuffer:
        timeout = samples.env_info.get("timeout",
                                       torch.zeros_like(samples.done))
        return SamplesToBuffer(samples.observation, samples.action,
                               samples.reward, samples.done, timeout)

    def _alpha(self) -> torch.Tensor:
        return torch.zeros((), device=self.agent.device)

    @spanned("optimize")
    def optimize(self, samples, rollout_state) -> QpgOptInfo:
        """Append, then maybe ``updates_per_optimize`` updates.  Returns
        the mean QpgOptInfo as device scalars (zeros, and the current
        alpha, before learning starts)."""
        self.replay.append(self.samples_to_buffer(samples))
        if rollout_state.cum_steps < self.min_steps_learn:
            zero = torch.zeros((), device=self.agent.device)
            return QpgOptInfo(zero, zero, zero, zero, self._alpha())
        infos = [self.update(self.replay.sample(self.batch_size,
                                                self.generator))
                 for _ in range(self.updates_per_optimize)]
        return QpgOptInfo(*(torch.stack(x).mean() for x in zip(*infos)))

    def update(self, batch: SamplesFromReplay, noise=None) -> QpgOptInfo:
        raise NotImplementedError

    def _targets(self, batch: SamplesFromReplay, next_q: torch.Tensor
                 ) -> torch.Tensor:
        nonterminal = 1.0 - batch.done_n.to(torch.float32)
        return batch.return_ + self.discount ** self.n_step * nonterminal \
            * next_q

    @staticmethod
    def _valid(batch: SamplesFromReplay) -> torch.Tensor:
        return 1.0 - batch.timeout_n.to(torch.float32)

    def _normals(self, batch: SamplesFromReplay) -> torch.Tensor:
        """Under a shard: the [batch, A] standard normals that the
        single-process update draws from the generator, at this rank's
        rows of the draw (every rank draws them all, so the generators
        stay in step)."""
        draw = batch.indices
        z = torch.randn((draw.t_idx.shape[0], self.agent.action_size),
                        generator=self.generator,
                        device=self.generator.device)
        return z[draw.rows.to(z.device)]

    def _group(self, name: str):
        return self.optimizers[name], list(self.agent.nets[name].parameters())

    def q_loss(self, batch: SamplesFromReplay, y: torch.Tensor
               ) -> torch.Tensor:
        """sum_i valid_mean(0.5 (y - Q_i(s, a))^2) over the critics, for
        targets ``y`` (``_targets``)."""
        nets = self.agent.nets
        obs, valid = batch.agent_inputs.observation, self._valid(batch)
        return sum(self._mean(0.5 * (y - nets[name](obs, batch.action))
                              ** 2, valid) for name in self.agent.q_names)

    def _critic_step(self, batch: SamplesFromReplay, y: torch.Tensor):
        """One step of every critic on ``q_loss``; returns (loss, global
        norm over all critics' grads)."""
        loss = self.q_loss(batch, y)
        norms = _step(loss, [self._group(name)
                             for name in self.agent.q_names])
        return loss.detach(), torch.linalg.vector_norm(torch.stack(norms))

    def _polyak(self, names):
        for name in names:
            polyak_update(self.agent.nets["target_" + name],
                          self.agent.nets[name], self.target_update_tau)


class DDPG(QpgBase):
    def __init__(self, learning_rate=1e-4, q_learning_rate=1e-3,
                 target_update_tau=0.01, batch_size=64, replay_ratio=64.0,
                 **kwargs):
        super().__init__(learning_rate=learning_rate,
                         q_learning_rate=q_learning_rate,
                         target_update_tau=target_update_tau,
                         batch_size=batch_size, replay_ratio=replay_ratio,
                         **kwargs)

    def _next_q(self, batch, noise):
        nets = self.agent.nets
        next_obs = batch.target_inputs.observation
        return nets["target_q"](next_obs, nets["target_mu"](next_obs))

    def mu_loss(self, batch: SamplesFromReplay) -> torch.Tensor:
        """-Q_1(s, mu(s)) over valid samples (Q_1: "q" or "q1")."""
        nets = self.agent.nets
        obs = batch.agent_inputs.observation
        q = nets[self.agent.q_names[0]](obs, nets["mu"](obs))
        return -self._mean(q, self._valid(batch))

    def _policy_step(self) -> bool:
        return True

    def update(self, batch: SamplesFromReplay, noise=None) -> QpgOptInfo:
        """One update on ``batch``; ``noise``: TD3's target-smoothing
        normals [batch, A] (drawn from the generator if None)."""
        agent = self.agent
        with torch.no_grad():
            y = self._targets(batch, self._next_q(batch, noise))
        q_loss, q_norm = self._critic_step(batch, y)
        self.update_counter += 1
        mu_loss = self.mu_loss(batch)
        if self._policy_step():
            mu_norm, = _step(mu_loss, [self._group("mu")])
            self._polyak(("mu",) + agent.q_names)
        else:
            grads = list(torch.autograd.grad(mu_loss, self._group("mu")[1]))
            self.optimizers["mu"].reduce_grads(grads)
            mu_norm = global_norm(grads)
            self._polyak(agent.q_names)
        q_loss, mu_loss = self._whole(q_loss, mu_loss.detach())
        return QpgOptInfo(q_loss, mu_loss, q_norm, mu_norm, self._alpha())


class TD3(DDPG):
    def __init__(self, learning_rate=1e-3, q_learning_rate=1e-3,
                 target_update_tau=0.005, batch_size=100,
                 replay_ratio=100.0, policy_update_interval=2, **kwargs):
        super().__init__(learning_rate=learning_rate,
                         q_learning_rate=q_learning_rate,
                         target_update_tau=target_update_tau,
                         batch_size=batch_size, replay_ratio=replay_ratio,
                         **kwargs)
        self.policy_update_interval = policy_update_interval

    def _next_q(self, batch, noise):
        nets = self.agent.nets
        next_obs = batch.target_inputs.observation
        if noise is None and self.shard is not None:
            noise = self._normals(batch)
        mu = nets["target_mu"](next_obs)
        action = self.agent.target_distribution.sample(
            DistInfoStd(mu, torch.zeros_like(mu)), self.generator, noise)
        return torch.minimum(nets["target_q1"](next_obs, action),
                             nets["target_q2"](next_obs, action))

    def _policy_step(self) -> bool:
        """Counted after the critics' step, as the JAX counter."""
        return self.update_counter % self.policy_update_interval == 0


class SAC(QpgBase):
    policy_name = "pi"
    state_attrs = QpgBase.state_attrs + ("log_alpha", "alpha_optimizer")

    def __init__(self, learning_rate=3e-4, target_update_tau=0.005,
                 batch_size=256, replay_ratio=256.0,
                 fixed_alpha: Optional[float] = None,
                 target_entropy="auto", **kwargs):
        super().__init__(learning_rate=learning_rate,
                         target_update_tau=target_update_tau,
                         batch_size=batch_size, replay_ratio=replay_ratio,
                         **kwargs)
        self.fixed_alpha = fixed_alpha
        self.target_entropy = target_entropy

    def initialize(self, agent, batch_spec, example_obs, generator,
                   n_itr: int = 1):
        """As QpgBase, plus log alpha (0) and its Adam at
        ``learning_rate``, unclipped; the target entropy is -dim(A) when
        "auto"."""
        super().initialize(agent, batch_spec, example_obs, generator, n_itr)
        self._target_entropy = (-float(agent.action_size)
                                if self.target_entropy == "auto"
                                else float(self.target_entropy))
        self.log_alpha = torch.zeros((), device=agent.device,
                                     requires_grad=True)
        self.alpha_optimizer = make_optimizer([self.log_alpha],
                                              self.learning_rate,
                                              shard=self.shard)

    def _alpha(self) -> torch.Tensor:
        """exp(log alpha), as reported (also under ``fixed_alpha``, where
        it stays 1, as in the JAX package)."""
        return self.log_alpha.detach().exp()

    def pi_loss(self, batch: SamplesFromReplay, alpha: torch.Tensor,
                noise: Optional[torch.Tensor] = None):
        """valid_mean(alpha log pi - min(Q1, Q2)) at a fresh sample of pi;
        returns (loss, log pi)."""
        agent = self.agent
        obs = batch.agent_inputs.observation
        a, logp = agent.pi(obs, self.generator, noise)
        q = torch.minimum(agent.nets["q1"](obs, a), agent.nets["q2"](obs, a))
        return self._mean(alpha * logp - q, self._valid(batch)), logp

    def update(self, batch: SamplesFromReplay, noise=None) -> QpgOptInfo:
        """One update on ``batch``; ``noise`` = (normals of the target's
        next action, normals of the policy loss's sample), each
        [batch, A], drawn from the generator if None."""
        agent = self.agent
        if noise is None and self.shard is not None:
            noise = (self._normals(batch), self._normals(batch))
        next_noise, pi_noise = (None, None) if noise is None else noise
        alpha = (self._alpha() if self.fixed_alpha is None else
                 torch.full((), self.fixed_alpha, device=agent.device))
        with torch.no_grad():
            next_obs = batch.target_inputs.observation
            next_a, next_logp = agent.pi(next_obs, self.generator,
                                         next_noise)
            next_q = torch.minimum(
                agent.nets["target_q1"](next_obs, next_a),
                agent.nets["target_q2"](next_obs, next_a))
            y = self._targets(batch, next_q - alpha * next_logp)
        q_loss, q_norm = self._critic_step(batch, y)
        pi_loss, logp = self.pi_loss(batch, alpha, pi_noise)
        pi_norm, = _step(pi_loss, [self._group("pi")])
        if self.fixed_alpha is None:
            self.log_alpha.grad = -self._mean(
                logp.detach() + self._target_entropy, n=self.batch_size)
            self.alpha_optimizer.step()
        self._polyak(agent.q_names)
        self.update_counter += 1
        q_loss, pi_loss = self._whole(q_loss, pi_loss.detach())
        return QpgOptInfo(q_loss, pi_loss, q_norm, pi_norm, self._alpha())
