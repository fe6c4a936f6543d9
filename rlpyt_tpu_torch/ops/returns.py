"""Return math (port of rlpyt_tpu/ops/returns.py: discount_return_n_step,
valid_from_done)."""
from __future__ import annotations

from typing import Tuple

import torch


def discount_return_n_step(reward: torch.Tensor, done: torch.Tensor,
                           n_step: int, discount: float
                           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """n-step truncated returns and done-within-n flags.

    reward, done: [T, B] with T >= n_step.  Output [T - n_step + 1, B]:
      return_[t] = sum_{k<n} discount^k r_{t+k}, stopping at the first done;
      done_n[t]  = any(done[t : t+n]).
    """
    out_T = reward.shape[0] - n_step + 1
    ret = reward[:out_T].to(torch.float32)
    done_n = done[:out_T].to(torch.bool)
    for k in range(1, n_step):
        not_done = 1.0 - done_n.to(torch.float32)
        ret = ret + (discount ** k) * reward[k:k + out_T] * not_done
        done_n = done_n | done[k:k + out_T]
    return ret, done_n


def valid_from_done(done: torch.Tensor) -> torch.Tensor:
    """1 until (and including) the first done, 0 after.  [T, B] float."""
    done = done.to(torch.float32)
    prior_done = torch.cat([torch.zeros_like(done[:1]),
                            torch.cumsum(done, dim=0)[:-1]], dim=0)
    return (prior_done < 1).to(torch.float32)
