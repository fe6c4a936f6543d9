"""Return math (port of rlpyt_tpu/ops/returns.py: discount_return,
generalized_advantage_estimation, discount_return_n_step, valid_from_done).

The JAX package solves the backward recurrences r_t = x_t + c_t r_{t+1}
with ``lax.associative_scan``; here they are a reverse loop over T, which
sums in another order (the results agree to float32 rounding, about
1e-6 relative).
"""
from __future__ import annotations

from typing import Tuple

import torch


def _discounted_reverse(x: torch.Tensor, coef: torch.Tensor) -> torch.Tensor:
    """Solve r_t = x_t + coef_t * r_{t+1}, r_T = 0, for all t.  [T, ...]"""
    out = torch.empty_like(x)
    r = torch.zeros_like(x[0])
    for t in range(x.shape[0] - 1, -1, -1):
        r = x[t] + coef[t] * r
        out[t] = r
    return out


def discount_return(reward: torch.Tensor, done: torch.Tensor,
                    bootstrap_value: torch.Tensor, discount: float
                    ) -> torch.Tensor:
    """Discounted returns with bootstrap.  reward, done [T, B];
    bootstrap_value [B], the value of the state after the last step.
    done[t] stops the sum from reaching past step t."""
    coef = discount * (1.0 - done.to(reward.dtype))
    x = reward.clone()
    x[-1] += coef[-1] * bootstrap_value
    return _discounted_reverse(x, coef)


def generalized_advantage_estimation(
        reward: torch.Tensor, value: torch.Tensor, done: torch.Tensor,
        bootstrap_value: torch.Tensor, discount: float, gae_lambda: float
) -> Tuple[torch.Tensor, torch.Tensor]:
    """GAE(lambda); all [T, B], bootstrap_value [B].  Returns (advantage,
    return_ = advantage + value)."""
    not_done = 1.0 - done.to(reward.dtype)
    next_value = torch.cat([value[1:], bootstrap_value[None]], dim=0)
    delta = reward + discount * next_value * not_done - value
    advantage = _discounted_reverse(delta, discount * gae_lambda * not_done)
    return advantage, advantage + value


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
