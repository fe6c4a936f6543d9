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

``process_returns`` also gives the ``valid`` mask: None under the
collector's mid-batch reset, where every sample is valid and the means
are plain means, and ``valid_from_done(done)`` for a wait-reset batch.
A2C and PPO call it with the default, as the JAX package's do, so their
``valid`` is None.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from rlpyt_tpu_torch.algos.base import RlAlgorithm, make_optimizer
from rlpyt_tpu_torch.ops.returns import (
    discount_return,
    generalized_advantage_estimation,
    valid_from_done,
)
from rlpyt_tpu_torch.struct import tree_map
from rlpyt_tpu_torch.utils.profiling import spanned


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
                              self.learning_rate, self.clip_grad_norm,
                              shard=self.shard)

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

    def process_returns(self, samples, bootstrap_value,
                        mid_batch_reset: bool = True):
        """(return_, advantage, valid), [T, B]: discounted returns when
        ``gae_lambda`` is 1, else GAE(lambda); ``valid`` None after a
        mid-batch-reset collection, else 1 up to each lane's first done;
        the advantage normalized by its (valid) mean and population
        variance if asked."""
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
        valid = None if mid_batch_reset else valid_from_done(done)
        if self.normalize_advantage:
            n = self._batch_entries(advantage)
            m = self._global_mean(advantage, valid, n)
            v = self._global_mean((advantage - m) ** 2, valid, n)
            advantage = (advantage - m) * torch.rsqrt(v + 1e-8)
        return return_, advantage, valid

    def _batch_entries(self, x: torch.Tensor) -> int:
        """The entries of a [T, lanes] ``x`` of the batch on every rank
        together (each rank holds as many lanes)."""
        return x.numel() * (1 if self.shard is None else self.shard.size)

    @staticmethod
    def shifted_done(done: torch.Tensor) -> torch.Tensor:
        """done[t - 1]: resets the rnn state used for step t when a
        training window is replayed."""
        return torch.cat([torch.zeros_like(done[:1]), done[:-1]], dim=0)

    def _total_loss(self, pi_loss, dist_info, value, return_, valid=None,
                    n=None):
        """pi_loss plus the value and entropy terms, means over ``valid``
        (under a shard, over ``n`` entries of all ranks without it);
        returns (loss, entropy, mean perplexity), this rank's shares."""
        dist = self.agent.distribution
        value_loss = self.value_loss_coeff * self._mean(
            0.5 * (value - return_) ** 2, valid, n)
        entropy = self._mean(dist.entropy(dist_info), valid, n)
        loss = pi_loss + value_loss - self.entropy_loss_coeff * entropy
        return loss, entropy, self._mean(dist.perplexity(dist_info), n=n)

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
                              optim=self.optim, shard=self.shard)

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
        return_, advantage, valid = self.process_returns(samples,
                                                         bootstrap_value)
        logli = self.agent.distribution.log_likelihood(samples.action,
                                                        dist_info)
        n = self._batch_entries(advantage)
        pi_loss = -self._mean(logli * advantage.detach(), valid, n)
        return self._total_loss(pi_loss, dist_info, value, return_, valid,
                                n)

    @spanned("optimize")
    def optimize(self, samples, rollout_state) -> PgOptInfo:
        bootstrap_value = self.bootstrap(rollout_state)
        init_rnn_state = (tuple(x[0] for x in
                                samples.agent_info["prev_rnn_state"])
                          if self.agent.recurrent else None)
        loss, entropy, perplexity = self.loss(samples, bootstrap_value,
                                              init_rnn_state)
        grad_norm = self._step(loss)
        loss, entropy, perplexity = self._whole(
            loss.detach(), entropy.detach(), perplexity.detach())
        return PgOptInfo(loss, grad_norm, entropy, perplexity)


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
                              schedule_steps=steps, shard=self.shard)

    def surrogate_loss(self, mb: dict, n: Optional[int] = None):
        """Clipped surrogate + value + entropy on one minibatch; ``mb``
        leaves are [T, b, ...] (recurrent) or [n, ...] (feedforward), and
        its optional "valid" weights the means (under a shard, ``n``: the
        entries of every rank's minibatch without it)."""
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
        valid = mb.get("valid")
        pi_loss = -self._mean(torch.minimum(ratio * adv, clipped * adv),
                              valid, n)
        return self._total_loss(pi_loss, dist_info, value, mb["return_"],
                                valid, n)

    @spanned("optimize")
    def optimize(self, samples, rollout_state,
                 permutations: Optional[torch.Tensor] = None) -> PgOptInfo:
        """``permutations`` [epochs, n_items] (lanes if recurrent, else
        T*B samples) replace the generator's draws."""
        T, B = self.batch_spec
        return_, advantage, valid = self.process_returns(
            samples, self.bootstrap(rollout_state))
        data = {"observation": samples.observation,
                "prev_action": samples.prev_action,
                "prev_reward": samples.prev_reward,
                "action": samples.action,
                "old_dist_info": samples.agent_info["dist_info"],
                "return_": return_, "advantage": advantage}
        if valid is not None:
            data["valid"] = valid
        recurrent = self.agent.recurrent
        if recurrent:
            data["done_shifted"] = self.shifted_done(samples.done)
            init_rnn_state = tuple(x[0] for x in
                                   samples.agent_info["prev_rnn_state"])
            n_items = B
        else:
            data = tree_map(lambda x: x.reshape((-1,) + x.shape[2:]), data)
            n_items = T * B
        mb_size = n_items // self.minibatches
        mb_entries = mb_size * T if recurrent else mb_size
        dev = samples.reward.device
        infos = []
        for epoch in range(self.epochs):
            perm = (torch.randperm(n_items, generator=self.generator,
                                   device=self.generator.device)
                    if permutations is None else permutations[epoch])
            perm = perm.to(dev)
            for m in range(self.minibatches):
                idxs = perm[m * mb_size:(m + 1) * mb_size]
                if self.shard is not None:
                    idxs = self._local_items(idxs, recurrent)
                if recurrent:
                    mb = tree_map(lambda x: x[:, idxs], data)
                    mb["init_rnn_state"] = tuple(x[idxs]
                                                 for x in init_rnn_state)
                else:
                    mb = tree_map(lambda x: x[idxs], data)
                loss, entropy, perplexity = self.surrogate_loss(mb,
                                                                mb_entries)
                grad_norm = self._step(loss)
                infos.append((loss.detach(), grad_norm, entropy.detach(),
                              perplexity.detach()))
        loss, grad_norm, entropy, perplexity = (torch.stack(x).mean()
                                                for x in zip(*infos))
        loss, entropy, perplexity = self._whole(loss, entropy, perplexity)
        return PgOptInfo(loss, grad_norm, entropy, perplexity)

    def _local_items(self, idxs: torch.Tensor, recurrent: bool
                     ) -> torch.Tensor:
        """A minibatch of the permutation over every rank's items (lanes
        if recurrent, else T*B samples, t-major) as indices into this
        rank's."""
        T, B = self.batch_spec
        lanes = self.shard.lanes(B)
        if recurrent:
            return self.shard.local_rows(idxs, lanes)[1]
        pos, b_local = self.shard.local_rows(idxs % B, lanes)
        return (idxs[pos] // B) * (lanes.stop - lanes.start) + b_local
