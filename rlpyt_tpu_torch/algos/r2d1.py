"""R2D1, recurrent replay DQN (port of rlpyt_tpu/algos/r2d1.py).

- prioritized (or uniform) sequence replay of warmup_T burn-in + batch_T
  training + n_step rows, with the collection-time rnn state stored at
  window starts (replay/sequence.py);
- burn-in: the LSTM re-runs over the warmup slice from the stored state,
  with no gradient, for the online and the target network;
- value rescaling h / h^-1 around the n-step targets;
- sequence priorities eta * max|delta| + (1 - eta) * mean|delta|;
- optional input priorities at insert from collection-time TD errors;
- double DQN; Adam (eps 1e-3) after clip-by-global-norm, through
  ``algos/base.py:make_optimizer``; hard target copy every
  ``target_update_interval`` updates.

Per iteration: append the [T, B] batch, then, once ``min_steps_learn``
env steps have been taken, ``updates_per_optimize`` updates.
"""
from __future__ import annotations

import copy

import torch

from rlpyt_tpu_torch.algos.base import RlAlgorithm, make_optimizer
from rlpyt_tpu_torch.algos.dqn import OptInfo
from rlpyt_tpu_torch.ops.returns import discount_return_n_step, \
    valid_from_done
from rlpyt_tpu_torch.ops.value import huber_loss, polyak_update, \
    value_rescale, value_rescale_inv
from rlpyt_tpu_torch.replay.base import SamplesToBuffer
from rlpyt_tpu_torch.replay.sequence import (
    PrioritizedSequenceFrameReplayBuffer,
    PrioritizedSequenceReplayBuffer,
    SequenceSamples,
    UniformSequenceFrameReplayBuffer,
    UniformSequenceReplayBuffer,
)
from rlpyt_tpu_torch.struct import select_at_indexes, tree_map, valid_mean


class R2D1(RlAlgorithm):
    def __init__(
        self,
        discount: float = 0.997,
        batch_b: int = 64,
        batch_T: int = 80,
        warmup_T: int = 40,
        min_steps_learn: int = int(1e5),
        delta_clip: float | None = None,
        replay_size: int = int(1e6),
        replay_ratio: float = 1.0,
        target_update_interval: int = 2500,
        n_step_return: int = 5,
        learning_rate: float = 1e-4,
        clip_grad_norm: float = 80.0,
        double_dqn: bool = True,
        prioritized_replay: bool = True,
        pri_alpha: float = 0.6,
        pri_beta: float = 0.9,
        pri_eta: float = 0.9,
        input_priorities: bool = True,
        value_scale_eps: float = 1e-3,
        use_value_rescale: bool = True,
        frame_compress: bool = False,
        frames_per_obs: int = 4,
        mask_after_done: bool = False,
        zero_state_init: bool = False,
    ):
        self.discount = discount
        self.batch_b = batch_b
        self.batch_T = batch_T
        self.warmup_T = warmup_T
        self.min_steps_learn = min_steps_learn
        self.delta_clip = delta_clip
        self.replay_size = replay_size
        self.replay_ratio = replay_ratio
        self.target_update_interval = target_update_interval
        self.n_step = n_step_return
        self.learning_rate = learning_rate
        self.clip_grad_norm = clip_grad_norm
        self.double_dqn = double_dqn
        self.prioritized_replay = prioritized_replay
        self.pri_alpha = pri_alpha
        self.pri_beta = pri_beta
        self.pri_eta = pri_eta
        self.input_priorities = input_priorities
        self.value_scale_eps = value_scale_eps
        self.use_value_rescale = use_value_rescale
        self.frame_compress = frame_compress
        self.frames_per_obs = frames_per_obs
        # True masks every step after the first done in the training
        # slice (rlpyt's behaviour); the default trains all steps, since
        # the model resets the LSTM at in-window episode starts.
        self.mask_after_done = mask_after_done
        # True burns in from zeros instead of the stored state.
        self.zero_state_init = zero_state_init

    def _h(self, x):
        return (value_rescale(x, self.value_scale_eps)
                if self.use_value_rescale else x)

    def _h_inv(self, x):
        return (value_rescale_inv(x, self.value_scale_eps)
                if self.use_value_rescale else x)

    def initialize(self, agent, batch_spec, example_obs, generator,
                   n_itr: int = 1):
        """Target network, optimizer and replay.  ``example_obs``: one
        [B, ...] batch of observations."""
        self.agent = agent
        self.model = agent.model
        self.target_model = copy.deepcopy(agent.model)
        self.target_model.requires_grad_(False)
        self.generator = generator
        self.updates_per_optimize = max(1, int(
            self.replay_ratio * batch_spec.size
            / (self.batch_b * self.batch_T)))
        self.optimizer = make_optimizer(
            self.model.parameters(), self.learning_rate,
            self.clip_grad_norm, "adam", eps=1e-3)
        self.update_counter = 0
        if self.frame_compress:
            Cls = (PrioritizedSequenceFrameReplayBuffer
                   if self.prioritized_replay
                   else UniformSequenceFrameReplayBuffer)
        else:
            Cls = (PrioritizedSequenceReplayBuffer
                   if self.prioritized_replay
                   else UniformSequenceReplayBuffer)
        kwargs = dict(size=self.replay_size, B=batch_spec.B,
                      sample_T=batch_spec.T, warmup_T=self.warmup_T,
                      batch_T=self.batch_T, n_step_return=self.n_step,
                      discount=self.discount, device=agent.device)
        if self.frame_compress:
            kwargs.update(frames_per_obs=self.frames_per_obs)
        if self.prioritized_replay:
            kwargs.update(alpha=self.pri_alpha, beta=self.pri_beta)
        self.replay = Cls(**kwargs)
        dev = agent.device
        h = torch.zeros((agent.lstm_size,), device=dev)
        self.replay.init(SamplesToBuffer(
            observation=tree_map(lambda x: x[0], example_obs),
            action=agent.env_spaces.action.null_value(dev),
            reward=torch.zeros((), device=dev),
            done=torch.zeros((), dtype=torch.bool, device=dev),
            timeout=torch.zeros((), dtype=torch.bool, device=dev)), (h, h))

    def samples_to_buffer(self, samples):
        """(SamplesToBuffer, rnn states at the block's interval points)."""
        timeout = samples.env_info.get("timeout",
                                       torch.zeros_like(samples.done))
        to_buf = SamplesToBuffer(samples.observation, samples.action,
                                 samples.reward, samples.done, timeout)
        iv = self.replay.interval
        rnn = tree_map(lambda x: x[::iv], samples.agent_info["prev_rnn_state"])
        return to_buf, rnn

    def _input_priorities(self, samples) -> torch.Tensor:
        """Priorities of the new slots from collection-time 1-step TD
        errors: per interval block, eta * max|delta| + (1-eta) mean|delta|."""
        q = samples.agent_info["q"]                         # [T, B, A]
        qa = select_at_indexes(samples.action, q)
        max_next = q.max(dim=-1).values
        next_max = torch.cat([max_next[1:], max_next[-1:]], dim=0)
        nonterminal = 1.0 - samples.done.to(torch.float32)
        target = self._h(samples.reward + self.discount * nonterminal
                         * self._h_inv(next_max))
        delta = (target - qa).abs()                         # [T, B]
        iv = self.replay.interval
        blocks = delta.reshape(delta.shape[0] // iv, iv, -1)
        return (self.pri_eta * blocks.max(dim=1).values
                + (1 - self.pri_eta) * blocks.mean(dim=1))

    def loss(self, batch: SequenceSamples):
        """Sequence TD loss with burn-in and value rescaling.  Returns
        (scalar loss, priorities [b])."""
        model, target_model = self.model, self.target_model
        wT, T, n = self.warmup_T, self.batch_T, self.n_step
        # done[t] ends the episode at t: reset the LSTM before t+1.
        done_shifted = torch.cat([torch.zeros_like(batch.done[:1]),
                                  batch.done[:-1]], dim=0)

        def inputs(lo, hi):
            return (batch.observation[lo:hi], batch.prev_action[lo:hi],
                    batch.prev_reward[lo:hi])

        online_state = batch.init_rnn_state
        if self.zero_state_init:
            online_state = tree_map(torch.zeros_like, online_state)
        target_state = online_state
        if wT > 0:
            with torch.no_grad():
                _, online_state = model(*inputs(0, wT), online_state,
                                        done_shifted[:wT])
                _, target_state = target_model(*inputs(0, wT), target_state,
                                               done_shifted[:wT])
        W = wT + T + n
        q_full, _ = model(*inputs(wT, W), online_state, done_shifted[wT:W])
        with torch.no_grad():
            qt_full, _ = target_model(*inputs(wT, W), target_state,
                                      done_shifted[wT:W])
            if self.double_dqn:
                next_a = torch.argmax(q_full[n:n + T], dim=-1)
                next_q = select_at_indexes(next_a, qt_full[n:n + T])
            else:
                next_q = qt_full[n:n + T].max(dim=-1).values
            rew = batch.reward[wT:wT + T + n - 1]
            dn = batch.done[wT:wT + T + n - 1]
            return_, done_n = discount_return_n_step(rew, dn, n,
                                                     self.discount)
            nonterminal = 1.0 - done_n.to(torch.float32)
            y = self._h(return_ + self.discount ** n * nonterminal
                        * self._h_inv(next_q))
        q = select_at_indexes(batch.action[wT:wT + T], q_full[:T])
        delta = y - q
        if self.mask_after_done:
            valid = valid_from_done(batch.done[wT:wT + T])
        else:
            valid = torch.ones(delta.shape, device=delta.device)
        if self.delta_clip is not None:
            losses = huber_loss(delta, self.delta_clip)
        else:
            losses = 0.5 * delta ** 2
        loss = valid_mean(losses * batch.is_weights[None, :], valid)
        abs_delta = delta.detach().abs() * valid
        denom = torch.clamp(valid.sum(dim=0), min=1.0)
        priorities = (self.pri_eta * abs_delta.max(dim=0).values
                      + (1 - self.pri_eta) * abs_delta.sum(dim=0) / denom)
        return loss, priorities

    def update(self, batch: SequenceSamples) -> OptInfo:
        """One gradient step, the target rule and the priority write-back."""
        loss, priorities = self.loss(batch)
        self.optimizer.zero_grad()
        loss.backward()
        grad_norm = self.optimizer.step()
        self.update_counter += 1
        if self.update_counter % self.target_update_interval == 0:
            polyak_update(self.target_model, self.model, 1.0)
        self.replay.update_priorities(batch.slots, priorities)
        return OptInfo(loss.detach(), grad_norm, priorities.mean())

    def optimize(self, samples, rollout_state) -> OptInfo:
        """Append (with input priorities), then maybe
        ``updates_per_optimize`` updates.  Returns the mean OptInfo as
        device scalars (zeros before learning starts)."""
        to_buf, rnn = self.samples_to_buffer(samples)
        in_pri = (self._input_priorities(samples)
                  if self.input_priorities and self.prioritized_replay
                  else None)
        self.replay.append(to_buf, rnn, in_pri)
        if rollout_state.cum_steps < self.min_steps_learn:
            zero = torch.zeros((), device=self.agent.device)
            return OptInfo(zero, zero, zero)
        infos = []
        for _ in range(self.updates_per_optimize):
            batch = self.replay.sample(self.batch_b, self.generator)
            infos.append(self.update(batch))
        return OptInfo(*(torch.stack(x).mean() for x in zip(*infos)))
