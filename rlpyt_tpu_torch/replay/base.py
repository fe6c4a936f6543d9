"""Replay buffer core (port of rlpyt_tpu/replay/base.py).

The ring is a tree of [size_T, B, ...] tensors on ``device``, with
``size_T`` rounded up to a multiple of the sampler's T so that every
insert is one aligned slice write.  Observation leaves are stored with
their feature dims flattened to rows, and restored to their stored
shape at sample.

The JAX buffer is a pure function of an immutable ``ReplayState``; here
the buffer object owns its ring and cursor and ``append`` writes in
place: nothing outside the buffer holds an older ring, so the functional
copy has nothing to protect.  The cursor and fill level are Python
integers, so deciding what is valid costs no device sync.

With ``shard`` (a ``parallel.mesh.DpShard``: one rank of a data-parallel
run) the ring holds only the rank's lanes of the B, and draws are made
over all B lanes, the same on every rank; ``sample`` gives the drawn rows
of the rank's lanes, and their ``indices`` are a ``ShardRows`` naming the
whole draw.
"""
from __future__ import annotations

from typing import Any, NamedTuple, Optional, Tuple

import torch

from rlpyt_tpu_torch.struct import buffer_from_example, load_state, \
    state_of, tree_map


class SamplesToBuffer(NamedTuple):
    observation: Any
    action: Any
    reward: torch.Tensor
    done: torch.Tensor
    timeout: torch.Tensor   # time-limit truncation flag


class AgentInputs(NamedTuple):
    observation: Any
    prev_action: Any
    prev_reward: torch.Tensor


class SamplesFromReplay(NamedTuple):
    agent_inputs: AgentInputs
    action: Any
    return_: torch.Tensor     # n-step discounted return
    done: torch.Tensor
    done_n: torch.Tensor      # done within the n-step window
    timeout_n: torch.Tensor   # timeout within the n-step window
    target_inputs: AgentInputs  # inputs at t + n_step
    is_weights: torch.Tensor  # PER importance weights (ones for uniform)
    indices: Tuple[torch.Tensor, torch.Tensor]   # (t_idx, b_idx)


class ShardRows(NamedTuple):
    """A draw over all lanes of a data-parallel run: (t or slot, lane) of
    every drawn row, and the positions in the draw of this rank's rows."""
    t_idx: torch.Tensor
    b_idx: torch.Tensor
    rows: torch.Tensor


def local_draw(shard, lanes: slice, t_idx, b_idx, *cols):
    """The rows of a whole draw that lie in ``lanes``: (t_idx, lanes' own
    b_idx, each of ``cols``, the ShardRows of the draw); the draw as it
    is, with (t_idx, b_idx) for its indices, without a shard."""
    if shard is None:
        return (t_idx, b_idx) + cols + ((t_idx, b_idx),)
    pos, b_local = shard.local_rows(b_idx, lanes)
    return ((t_idx[pos], b_local) + tuple(c[pos] for c in cols)
            + (ShardRows(t_idx, b_idx, pos),))


class BaseReplayBuffer:
    # What state_dict() holds: the cursors and the ring.
    state_attrs: tuple = ("t", "filled_t", "data")

    def __init__(self, size: int, B: int, sample_T: int,
                 discount: float = 0.99, n_step_return: int = 1,
                 device="cuda", shard=None):
        """``size``: total transitions, rounded up so that size_T is a
        multiple of ``sample_T`` (the sampler's T).  ``B``: all lanes
        (of every rank, with ``shard``)."""
        self.B = B
        self.shard = shard
        self.lanes = shard.lanes(B) if shard is not None else slice(0, B)
        self.sample_T = sample_T
        size_T = -(-size // B)
        self.size_T = -(-size_T // sample_T) * sample_T
        self.discount = discount
        self.n_step = n_step_return
        self.off_backward = n_step_return   # guard after the sampled row
        self.off_forward = 1                # guard before it (prev_*)
        self.device = torch.device(device)
        self.t = 0          # next write row
        self.filled_t = 0   # rows holding data (<= size_T)

    @property
    def size(self) -> int:
        """Capacity in transitions over all lanes (size_T * B)."""
        return self.size_T * self.B

    def init(self, example: SamplesToBuffer):
        """Allocate the ring from one single-step example (no lead dims)."""
        self._obs_shapes = tree_map(lambda o: tuple(o.shape),
                                    example.observation)
        example = example._replace(
            observation=self._flatten_obs(example.observation, lead=0))
        self.data = buffer_from_example(
            example, (self.size_T, self.lanes.stop - self.lanes.start),
            self.device)

    def state_dict(self) -> dict:
        return state_of(self, self.state_attrs)

    def load_state_dict(self, state: dict):
        """Copy a saved state into the allocated ring (after ``init``)."""
        load_state(self, state, self.state_attrs)

    @staticmethod
    def _flatten_obs(obs, lead: int):
        return tree_map(lambda o: o.reshape(tuple(o.shape[:lead]) + (-1,))
                        if o.dim() - lead > 1 else o, obs)

    def append(self, samples: SamplesToBuffer):
        """Write a [sample_T, B] block at the cursor, in place."""
        samples = samples._replace(
            observation=self._flatten_obs(samples.observation, lead=2))
        t0, t1 = self.t, self.t + self.sample_T

        def _write(ring, block):
            ring[t0:t1].copy_(block)

        tree_map(_write, self.data, samples)
        self.t = t1 % self.size_T
        self.filled_t = min(self.filled_t + self.sample_T, self.size_T)

    def valid_window(self) -> Tuple[int, int]:
        """(base, span): sampleable offsets are
        [off_forward, span - off_backward) from ``base``, the oldest row."""
        full = self.filled_t >= self.size_T
        return (self.t if full else 0), (self.size_T if full
                                         else self.filled_t)

    def sample_idxs(self, batch_size: int, generator: torch.Generator
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Uniform valid (t, b) draws, int64 on the buffer's device."""
        base, span = self.valid_window()
        n_valid = max(span - self.off_backward - self.off_forward, 1)
        dev = generator.device
        offset = self.off_forward + torch.randint(
            0, n_valid, (batch_size,), generator=generator, device=dev)
        t_idx = (base + offset) % self.size_T
        b_idx = torch.randint(0, self.B, (batch_size,), generator=generator,
                              device=dev)
        return t_idx.to(self.device), b_idx.to(self.device)

    def _obs_at(self, t_idx, b_idx, k: int):
        """Observation rows at t + k, in their stored shape."""
        rows = (t_idx + k) % self.size_T
        return tree_map(
            lambda leaf, shape: leaf[rows, b_idx].reshape(
                tuple(t_idx.shape) + shape),
            self.data.observation, self._obs_shapes)

    def _obs_pair_at(self, t_idx, b_idx):
        """(obs at t, obs at t + n_step) for the sampled rows; the frame
        buffers override it to serve both from one gather."""
        return (self._obs_at(t_idx, b_idx, 0),
                self._obs_at(t_idx, b_idx, self.n_step))

    def extract_batch(self, t_idx: torch.Tensor, b_idx: torch.Tensor,
                      is_weights: Optional[torch.Tensor] = None,
                      indices=None) -> SamplesFromReplay:
        """Gather transitions and n-step targets at (t_idx, b_idx), lanes
        of the ring; ``is_weights`` defaults to ones (uniform replay),
        ``indices`` to (t_idx, b_idx)."""
        d = self.data

        def at(leaf, k=0):
            return leaf[(t_idx + k) % self.size_T, b_idx]

        obs, target_obs = self._obs_pair_at(t_idx, b_idx)
        ret = at(d.reward).to(torch.float32)
        done_n = at(d.done)
        timeout_n = at(d.timeout)
        for k in range(1, self.n_step):
            live = 1.0 - done_n.to(torch.float32)
            ret = ret + (self.discount ** k) * at(d.reward, k) * live
            timeout_n = timeout_n | (at(d.timeout, k) & ~done_n)
            done_n = done_n | at(d.done, k)
        return SamplesFromReplay(
            agent_inputs=AgentInputs(obs, at(d.action, -1), at(d.reward, -1)),
            action=at(d.action),
            return_=ret,
            done=at(d.done),
            done_n=done_n,
            timeout_n=timeout_n,
            target_inputs=AgentInputs(target_obs,
                                      at(d.action, self.n_step - 1),
                                      at(d.reward, self.n_step - 1)),
            is_weights=(torch.ones(t_idx.shape, device=t_idx.device)
                        if is_weights is None else is_weights),
            indices=(t_idx, b_idx) if indices is None else indices,
        )
