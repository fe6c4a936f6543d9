"""Policy-gradient algorithms (port of rlpyt_tpu/algos/pg.py:
PolicyGradientAlgo, A2C, PPO).

A2C takes one step per batch on
  -log pi(a) adv + value_coeff * 0.5 (V - R)^2 - entropy_coeff * H,
by default with RMSprop.  PPO takes ``epochs`` x ``minibatches`` steps of
the clipped surrogate per batch, with Adam and (by default) the learning
rate annealed linearly to 0 over the run.  Feedforward PPO permutes the
T*B samples; recurrent PPO minibatches over the B lanes only and replays
the LSTM over each lane's whole window from the stored
``prev_rnn_state`` at its first step, resetting after dones.  Each
epoch's permutation comes from the algorithm's generator
(``torch.randperm``); ``optimize(permutations=...)`` takes them from the
caller instead.

The collector always resets lanes mid-batch, so every sample is valid
and the means are plain means (the JAX package's ``valid`` mask is
None there too).
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from rlpyt_tpu_torch.algos.base import RlAlgorithm, make_optimizer
from rlpyt_tpu_torch.ops.returns import (
    discount_return,
    generalized_advantage_estimation,
)
from rlpyt_tpu_torch.struct import tree_map


class PgOptInfo(NamedTuple):
    loss: torch.Tensor
    grad_norm: torch.Tensor   # global norm before clipping
    entropy: torch.Tensor
    perplexity: torch.Tensor


class PolicyGradientAlgo(RlAlgorithm):
    updates_per_optimize = 1

    def __init__(self, discount: float = 0.99, learning_rate: float = 1e-3,
                 value_loss_coeff: float = 0.5,
                 entropy_loss_coeff: float = 0.01,
                 clip_grad_norm: float = 1.0, gae_lambda: float = 1.0,
                 normalize_advantage: bool = False):
        self.discount = discount
        self.learning_rate = learning_rate
        self.value_loss_coeff = value_loss_coeff
        self.entropy_loss_coeff = entropy_loss_coeff
        self.clip_grad_norm = clip_grad_norm
        self.gae_lambda = gae_lambda
        self.normalize_advantage = normalize_advantage

    def _make_optimizer(self, n_itr: int):
        return make_optimizer(self.agent.model.parameters(),
                              self.learning_rate, self.clip_grad_norm)

    def initialize(self, agent, batch_spec, example_obs, generator,
                   n_itr: int = 1):
        """The optimizer over the agent's model; ``generator`` draws PPO's
        permutations.  No replay."""
        self.agent = agent
        self.batch_spec = batch_spec
        self.generator = generator
        self.optimizer = self._make_optimizer(n_itr)
        self.update_counter = 0

    def bootstrap(self, rollout_state) -> torch.Tensor:
        """V of the observation after the batch, [B]."""
        s = rollout_state
        if self.agent.recurrent:
            return self.agent.value(s.observation, s.prev_action,
                                    s.prev_reward, s.agent_carry)
        return self.agent.value(s.observation, s.prev_action, s.prev_reward)

    def process_returns(self, samples, bootstrap_value):
        """(return_, advantage), [T, B]: discounted returns when
        ``gae_lambda`` is 1, else GAE(lambda); the advantage normalized
        by its mean and population variance if asked."""
        reward, done = samples.reward, samples.done
        value = samples.agent_info["value"]
        if self.gae_lambda == 1.0:
            return_ = discount_return(reward, done, bootstrap_value,
                                      self.discount)
            advantage = return_ - value
        else:
            advantage, return_ = generalized_advantage_estimation(
                reward, value, done, bootstrap_value, self.discount,
                self.gae_lambda)
        if self.normalize_advantage:
            m = advantage.mean()
            v = ((advantage - m) ** 2).mean()
            advantage = (advantage - m) * torch.rsqrt(v + 1e-8)
        return return_, advantage

    @staticmethod
    def shifted_done(done: torch.Tensor) -> torch.Tensor:
        """done[t - 1]: resets the rnn state used for step t when a
        training window is replayed."""
        return torch.cat([torch.zeros_like(done[:1]), done[:-1]], dim=0)

    def _total_loss(self, pi_loss, dist_info, value, return_):
        """pi_loss plus the value and entropy terms; returns (loss,
        entropy, mean perplexity)."""
        dist = self.agent.distribution
        value_loss = self.value_loss_coeff * (
            0.5 * (value - return_) ** 2).mean()
        entropy = dist.mean_entropy(dist_info)
        loss = pi_loss + value_loss - self.entropy_loss_coeff * entropy
        return loss, entropy, dist.perplexity(dist_info).mean()

    def _step(self, loss) -> torch.Tensor:
        self.optimizer.zero_grad()
        loss.backward()
        grad_norm = self.optimizer.step()
        self.update_counter += 1
        return grad_norm


class A2C(PolicyGradientAlgo):
    def __init__(self, learning_rate: float = 1e-3, optim: str = "rmsprop",
                 **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.optim = optim

    def _make_optimizer(self, n_itr: int):
        return make_optimizer(self.agent.model.parameters(),
                              self.learning_rate, self.clip_grad_norm,
                              optim=self.optim)

    def loss(self, samples, bootstrap_value, init_rnn_state=None):
        """(loss, entropy, perplexity) over the whole [T, B] batch."""
        if self.agent.recurrent:
            dist_info, value, _ = self.agent(
                samples.observation, samples.prev_action,
                samples.prev_reward, init_rnn_state,
                done=self.shifted_done(samples.done))
        else:
            dist_info, value = self.agent(samples.observation,
                                          samples.prev_action,
                                          samples.prev_reward)
        return_, advantage = self.process_returns(samples, bootstrap_value)
        logli = self.agent.distribution.log_likelihood(samples.action,
                                                        dist_info)
        pi_loss = -(logli * advantage.detach()).mean()
        return self._total_loss(pi_loss, dist_info, value, return_)

    def optimize(self, samples, rollout_state) -> PgOptInfo:
        bootstrap_value = self.bootstrap(rollout_state)
        init_rnn_state = (tuple(x[0] for x in
                                samples.agent_info["prev_rnn_state"])
                          if self.agent.recurrent else None)
        loss, entropy, perplexity = self.loss(samples, bootstrap_value,
                                              init_rnn_state)
        grad_norm = self._step(loss)
        return PgOptInfo(loss.detach(), grad_norm, entropy.detach(),
                         perplexity.detach())


class PPO(PolicyGradientAlgo):
    def __init__(self, learning_rate: float = 3e-4, epochs: int = 4,
                 minibatches: int = 4, ratio_clip: float = 0.1,
                 linear_lr_schedule: bool = True, gae_lambda: float = 0.98,
                 normalize_advantage: bool = False, **kwargs):
        super().__init__(learning_rate=learning_rate, gae_lambda=gae_lambda,
                         normalize_advantage=normalize_advantage, **kwargs)
        self.epochs = epochs
        self.minibatches = minibatches
        self.ratio_clip = ratio_clip
        self.linear_lr_schedule = linear_lr_schedule
        self.updates_per_optimize = epochs * minibatches

    def _make_optimizer(self, n_itr: int):
        steps = (max(n_itr * self.epochs * self.minibatches, 1)
                 if self.linear_lr_schedule else None)
        return make_optimizer(self.agent.model.parameters(),
                              self.learning_rate, self.clip_grad_norm,
                              schedule_steps=steps)

    def surrogate_loss(self, mb: dict):
        """Clipped surrogate + value + entropy on one minibatch; ``mb``
        leaves are [T, b, ...] (recurrent) or [n, ...] (feedforward)."""
        if self.agent.recurrent:
            dist_info, value, _ = self.agent(
                mb["observation"], mb["prev_action"], mb["prev_reward"],
                mb["init_rnn_state"], done=mb["done_shifted"])
        else:
            dist_info, value = self.agent(mb["observation"],
                                          mb["prev_action"],
                                          mb["prev_reward"])
        ratio = self.agent.distribution.likelihood_ratio(
            mb["action"], mb["old_dist_info"], dist_info)
        clipped = torch.clamp(ratio, 1.0 - self.ratio_clip,
                              1.0 + self.ratio_clip)
        adv = mb["advantage"]
        pi_loss = -torch.minimum(ratio * adv, clipped * adv).mean()
        return self._total_loss(pi_loss, dist_info, value, mb["return_"])

    def optimize(self, samples, rollout_state,
                 permutations: Optional[torch.Tensor] = None) -> PgOptInfo:
        """``permutations`` [epochs, n_items] (lanes if recurrent, else
        T*B samples) replace the generator's draws."""
        T, B = self.batch_spec
        return_, advantage = self.process_returns(
            samples, self.bootstrap(rollout_state))
        data = {"observation": samples.observation,
                "prev_action": samples.prev_action,
                "prev_reward": samples.prev_reward,
                "action": samples.action,
                "old_dist_info": samples.agent_info["dist_info"],
                "return_": return_, "advantage": advantage}
        recurrent = self.agent.recurrent
        if recurrent:
            data["done_shifted"] = self.shifted_done(samples.done)
            init_rnn_state = tuple(x[0] for x in
                                   samples.agent_info["prev_rnn_state"])
            n_items = B
        else:
            data = tree_map(lambda x: x.reshape((T * B,) + x.shape[2:]),
                            data)
            n_items = T * B
        mb_size = n_items // self.minibatches
        dev = samples.reward.device
        infos = []
        for epoch in range(self.epochs):
            perm = (torch.randperm(n_items, generator=self.generator,
                                   device=self.generator.device)
                    if permutations is None else permutations[epoch])
            perm = perm.to(dev)
            for m in range(self.minibatches):
                idxs = perm[m * mb_size:(m + 1) * mb_size]
                if recurrent:
                    mb = tree_map(lambda x: x[:, idxs], data)
                    mb["init_rnn_state"] = tuple(x[idxs]
                                                 for x in init_rnn_state)
                else:
                    mb = tree_map(lambda x: x[idxs], data)
                loss, entropy, perplexity = self.surrogate_loss(mb)
                grad_norm = self._step(loss)
                infos.append((loss.detach(), grad_norm, entropy.detach(),
                              perplexity.detach()))
        return PgOptInfo(*(torch.stack(x).mean() for x in zip(*infos)))
