"""Recurrent core (port of rlpyt_tpu/models/rnn.py: zero_rnn_state,
LstmCore).

One module serves collection (T = 1) and training ([T, B] windows).
``done[t]`` zeroes the carried state before step t, so episode
boundaries inside a training window cut the recurrence.  The sequence
runs through ``ops/lstm.py:lstm``: the CUDA kernels on the card, their
plain versions on the CPU.  The JAX ``impl`` switch (scan or Pallas)
exists for GSPMD sharding, which the port does not have, so it is not
carried over.
"""
from __future__ import annotations

from typing import Tuple

import torch
from torch import nn

from rlpyt_tpu_torch.models.mlp import lecun_normal_
from rlpyt_tpu_torch.ops.lstm import lstm

RnnState = Tuple[torch.Tensor, torch.Tensor]   # (h, c), each [B, H]


def zero_rnn_state(batch_shape: tuple, hidden_size: int,
                   device=None) -> RnnState:
    shape = tuple(batch_shape) + (hidden_size,)
    return (torch.zeros(shape, device=device),
            torch.zeros(shape, device=device))


class LstmCore(nn.Module):
    """LSTM over [T, B, F] with per-step done masking; parameters ``wx``
    [F, 4H], ``wh`` [H, 4H] and ``b`` [4H] in the JAX package's layout,
    gate order i, f, g, o."""

    def __init__(self, input_size: int, hidden_size: int):
        super().__init__()
        F, H = input_size, hidden_size
        self.hidden_size = H
        self.wx = nn.Parameter(torch.empty(F, 4 * H))
        self.wh = nn.Parameter(torch.empty(H, 4 * H))
        self.b = nn.Parameter(torch.zeros(4 * H))
        # Per gate, as the JAX core: lecun-normal input kernels,
        # orthogonal [H, H] recurrent kernels, zero bias.
        with torch.no_grad():
            for k in range(4):
                lecun_normal_(self.wx[:, k * H:(k + 1) * H], F)
                nn.init.orthogonal_(self.wh[:, k * H:(k + 1) * H])

    def forward(self, x: torch.Tensor, done: torch.Tensor,
                state: RnnState):
        """x [T, B, F] (cast to float32), done [T, B] bool, state (h, c)
        [B, H].  Returns (y [T, B, H], (hT, cT))."""
        h0, c0 = state
        return lstm(self.wx, self.wh, self.b, x.to(torch.float32), done,
                    h0, c0)
