"""Sequence replay for recurrent training (port of
rlpyt_tpu/replay/sequence.py).

R2D1's replay holds fixed-length windows, W = warmup_T + batch_T +
n_step rows (burn-in, training slice, n-step overhang), and the
recurrent state stored at the allowed window starts.  Window starts are
restricted to multiples of ``interval``, so the rnn-state side array is
[size_T / interval, B, H].  Priorities are kept per start slot as p^alpha;
new slots take the algorithm's input priorities or the largest priority
seen so far.

As in the port's other buffers, the object owns its ring and writes in
place; the cursor and fill level are Python integers.  Sampling is split
into ``sample_idxs`` (stratified inverse-CDF draws and importance
weights) and ``extract_window`` (plain indexing; the JAX package has no
Pallas kernel for it), so tests can inject the draws.  Observations are
single tensors ([size_T, B, prod(obs_shape)] rows).

Under a data-parallel ``shard`` (replay/base.py) the ring and the stored
rnn states hold the rank's lanes; the priorities stay whole on every
rank, and new input priorities are gathered from every rank at append.
"""
from __future__ import annotations

from typing import Any, NamedTuple, Optional, Tuple

import torch

from rlpyt_tpu_torch.replay.base import SamplesToBuffer, ShardRows, \
    local_draw
from rlpyt_tpu_torch.replay.prioritized import importance_weights, \
    stratified_idxs
from rlpyt_tpu_torch.struct import buffer_from_example, load_state, \
    state_of, tree_map


class SequenceSamples(NamedTuple):
    """A [W, b] window batch; leaves are time-major [W, b, ...]."""

    observation: Any
    action: Any
    reward: torch.Tensor
    done: torch.Tensor
    prev_action: Any
    prev_reward: torch.Tensor
    init_rnn_state: Any     # [b, H] leaves: the state at the window start
    is_weights: torch.Tensor   # [b]
    slots: Tuple[torch.Tensor, torch.Tensor]   # (slot_idx, b_idx)


class PrioritizedSequenceReplayBuffer:
    # What state_dict() holds: the cursors, the ring, the stored rnn
    # states and the priorities.
    state_attrs = ("t", "filled_t", "data", "rnn_state", "priorities",
                   "max_priority")

    def __init__(self, size: int, B: int, sample_T: int,
                 warmup_T: int = 40, batch_T: int = 80,
                 n_step_return: int = 1, discount: float = 0.99,
                 interval: Optional[int] = None, alpha: float = 0.6,
                 beta: float = 0.4, prioritized: bool = True,
                 device="cuda", shard=None):
        self.B = B
        self.shard = shard
        self.lanes = shard.lanes(B) if shard is not None else slice(0, B)
        self.sample_T = sample_T
        self.warmup_T = warmup_T
        self.batch_T = batch_T
        self.n_step = n_step_return
        self.discount = discount
        self.window_T = warmup_T + batch_T + n_step_return
        self.interval = interval or max(1, min(warmup_T or batch_T,
                                               sample_T))
        if sample_T % self.interval:
            raise ValueError("the sampler's T must be a multiple of the "
                             "rnn-state interval")
        size_T = -(-size // B)
        self.size_T = -(-size_T // sample_T) * sample_T
        self.n_slots = self.size_T // self.interval
        self.alpha = alpha
        self.beta = beta
        self.prioritized = prioritized
        # Least offset of a window start from the oldest valid row: >= 1
        # for the prev_action / prev_reward read, raised by the frame mixin.
        self.off_start = 1
        self.device = torch.device(device)
        self.t = 0          # next write row
        self.filled_t = 0   # rows holding data (<= size_T)

    def init(self, example: SamplesToBuffer, rnn_example):
        """Allocate from one single-step example (no lead dims);
        ``rnn_example``: the per-lane rnn state, leaves [H]."""
        self._obs_shape = tuple(example.observation.shape)
        example = example._replace(
            observation=example.observation.reshape(-1))
        B_local = self.lanes.stop - self.lanes.start
        self.data = buffer_from_example(example, (self.size_T, B_local),
                                        self.device)
        self.rnn_state = buffer_from_example(rnn_example,
                                             (self.n_slots, B_local),
                                             self.device)
        self.priorities = torch.zeros((self.n_slots, self.B),
                                      device=self.device)
        self.max_priority = torch.ones((), device=self.device)

    def state_dict(self) -> dict:
        return state_of(self, self.state_attrs)

    def load_state_dict(self, state: dict):
        """Copy a saved state into the allocated ring (after ``init``)."""
        load_state(self, state, self.state_attrs)

    def append(self, samples: SamplesToBuffer, rnn_states,
               input_priorities: Optional[torch.Tensor] = None):
        """Write a [sample_T, B] block at the cursor and the rnn states
        at its interval points (leaves [sample_T / interval, B, H]).
        ``input_priorities``: optional [sample_T / interval, B] priorities
        before the alpha power."""
        T, B = samples.done.shape[:2]
        samples = samples._replace(
            observation=samples.observation.reshape(T, B, -1))
        t0 = self.t
        tree_map(lambda ring, x: ring[t0:t0 + T].copy_(x), self.data,
                 samples)
        slot0, n_new = t0 // self.interval, T // self.interval
        tree_map(lambda ring, x: ring[slot0:slot0 + n_new].copy_(x),
                 self.rnn_state, rnn_states)
        if input_priorities is None:
            new_p = (self.max_priority ** self.alpha).expand(n_new, self.B)
        else:
            if self.shard is not None:
                input_priorities = self.shard.gather_lanes(input_priorities,
                                                           self.B)
            new_p = torch.clamp(input_priorities, min=1e-6) ** self.alpha
        self.priorities[slot0:slot0 + n_new].copy_(new_p)
        self.t = (t0 + T) % self.size_T
        self.filled_t = min(self.filled_t + T, self.size_T)

    def _slot_validity(self) -> torch.Tensor:
        """[n_slots] bool: the whole window fits in contiguous valid data."""
        full = self.filled_t >= self.size_T
        base = self.t if full else 0
        span = self.size_T if full else self.filled_t
        slot_rows = torch.arange(self.n_slots, device=self.device) \
            * self.interval
        offset = (slot_rows - base) % self.size_T
        return (offset >= self.off_start) & (offset + self.window_T <= span)

    def sample_idxs(self, batch_b: int, generator: torch.Generator):
        """Stratified draws of ``batch_b`` (slot, lane) pairs.  Returns
        (slot_idx, b_idx, is_weights) on the buffer's device."""
        u = torch.rand((batch_b,), generator=generator,
                       device=generator.device).to(self.device)
        return self.idxs_from_uniforms(u)

    def idxs_from_uniforms(self, u: torch.Tensor):
        """Inverse-CDF draws from uniforms ``u`` [b] in [0, 1): one per
        stratum of the priority mass over the valid slots, importance
        weights normalised by their max (replay/prioritized.py)."""
        valid = self._slot_validity()[:, None]
        p = self.priorities if self.prioritized \
            else torch.ones_like(self.priorities)
        flat = torch.where(valid, p, 0.0).reshape(-1)
        flat_idx, total = stratified_idxs(flat, u)
        slot_idx, b_idx = flat_idx // self.B, flat_idx % self.B
        if not self.prioritized:
            return slot_idx, b_idx, torch.ones_like(u)
        return slot_idx, b_idx, importance_weights(flat, flat_idx, total,
                                                   self.beta)

    def extract_window(self, slot_idx: torch.Tensor, b_idx: torch.Tensor,
                       is_weights: Optional[torch.Tensor] = None
                       ) -> SequenceSamples:
        """The [W, b] windows starting at the slots' rows, wrapping mod
        size_T; prev_action / prev_reward read one row earlier."""
        t0 = slot_idx * self.interval
        rows = (t0[None, :] + torch.arange(self.window_T,
                                           device=t0.device)[:, None]) \
            % self.size_T
        prev = (rows - 1) % self.size_T
        b = b_idx[None, :]
        d = self.data
        return SequenceSamples(
            observation=self._obs_window(rows, b),
            action=d.action[rows, b], reward=d.reward[rows, b],
            done=d.done[rows, b], prev_action=d.action[prev, b],
            prev_reward=d.reward[prev, b],
            init_rnn_state=tree_map(lambda x: x[slot_idx, b_idx],
                                    self.rnn_state),
            is_weights=(torch.ones(slot_idx.shape, device=slot_idx.device)
                        if is_weights is None else is_weights),
            slots=(slot_idx, b_idx))

    def sample(self, batch_b: int, generator: torch.Generator
               ) -> SequenceSamples:
        slot_idx, b_idx, w, slots = local_draw(
            self.shard, self.lanes, *self.sample_idxs(batch_b, generator))
        return self.extract_window(slot_idx, b_idx, w)._replace(slots=slots)

    def _obs_window(self, rows, b):
        """[W, b, *obs_shape] observations at ``rows`` of lanes ``b``."""
        return self.data.observation[rows, b].reshape(
            tuple(rows.shape) + self._obs_shape)

    def update_priorities(self, slots, priorities: torch.Tensor):
        """Write back at ``slots``; under a shard (``ShardRows``) every
        rank's priorities of its rows are gathered first."""
        if not self.prioritized:
            return
        if isinstance(slots, ShardRows):
            priorities = self.shard.gather_rows(priorities, slots.rows,
                                                slots.t_idx.shape[0])
        slot_idx, b_idx = slots[:2]
        p = torch.clamp(priorities, min=1e-6)
        self.priorities[slot_idx, b_idx] = p ** self.alpha
        self.max_priority = torch.maximum(self.max_priority, p.max())


class UniformSequenceReplayBuffer(PrioritizedSequenceReplayBuffer):
    """Same machinery with flat sampling probabilities and unit
    importance weights."""

    def __init__(self, *args, **kwargs):
        kwargs["prioritized"] = False
        super().__init__(*args, **kwargs)


class SequenceFrameReplayMixin:
    """Frame compression for sequence windows: only the newest [H, W]
    frame of each K-stacked observation is stored, and the stacks are
    rebuilt at sample time, each older frame zeroed once a done lies
    between it and the newest frame."""

    def __init__(self, *args, frames_per_obs: int = 4, **kwargs):
        super().__init__(*args, **kwargs)
        self.frames_per_obs = frames_per_obs
        self.off_start = max(self.off_start, frames_per_obs - 1)

    def init(self, example: SamplesToBuffer, rnn_example):
        """``example.observation``: one [K, H, W] stack."""
        super().init(example._replace(observation=example.observation[-1]),
                     rnn_example)

    def append(self, samples: SamplesToBuffer, rnn_states,
               input_priorities=None):
        super().append(samples._replace(
            observation=samples.observation[:, :, -1]), rnn_states,
            input_priorities)

    def _obs_window(self, rows, b):
        """[W, b, K, H, W] stacks, oldest frame first."""
        ring, dones = self.data.observation, self.data.done
        frames = [ring[rows, b]]                          # newest
        valid = torch.ones(rows.shape, dtype=torch.bool, device=rows.device)
        for j in range(1, self.frames_per_obs):
            back = (rows - j) % self.size_T
            valid = valid & ~dones[back, b]
            frames.append(ring[back, b] * valid[..., None].to(ring.dtype))
        stacks = torch.stack(frames[::-1], dim=2)
        return stacks.reshape(tuple(rows.shape) + (self.frames_per_obs,)
                              + self._obs_shape)


class PrioritizedSequenceFrameReplayBuffer(SequenceFrameReplayMixin,
                                           PrioritizedSequenceReplayBuffer):
    """Prioritized sequence replay over frame-compressed observations."""


class UniformSequenceFrameReplayBuffer(SequenceFrameReplayMixin,
                                       UniformSequenceReplayBuffer):
    """Uniform sequence replay over frame-compressed observations."""
