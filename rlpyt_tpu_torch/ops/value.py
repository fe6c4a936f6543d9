"""Value-function ops (port of rlpyt_tpu/ops/value.py: huber_loss,
categorical_projection, value_rescale, value_rescale_inv,
polyak_update)."""
from __future__ import annotations

import torch
from torch import nn


def huber_loss(delta: torch.Tensor, clip: float = 1.0) -> torch.Tensor:
    """Elementwise Huber on the TD error (``delta_clip``)."""
    abs_d = delta.abs()
    quad = torch.clamp(abs_d, max=clip)
    return 0.5 * quad ** 2 + clip * (abs_d - quad)


def categorical_projection(target_p: torch.Tensor, returns: torch.Tensor,
                           nonterminal: torch.Tensor, z: torch.Tensor,
                           discount_n: float) -> torch.Tensor:
    """C51's Bellman backup: project the shifted support
    ``returns + discount_n * nonterminal * z`` back onto the fixed support
    ``z`` [n_atoms].  ``target_p``: [..., n_atoms] next-state atom
    probabilities; ``returns``, ``nonterminal``: [...].

    The triangular-kernel form of the JAX package: the weight of shifted
    atom j on fixed atom i is max(0, 1 - |tz_j - z_i| / dz), an
    [..., n, n] overlap summed over j, with no scatter."""
    dz = z[1] - z[0]
    tz = returns[..., None] + discount_n * nonterminal[..., None] * z
    tz = torch.clamp(tz, z[0], z[-1])
    w = torch.clamp(1.0 - (tz[..., None, :] - z[:, None]).abs() / dz, min=0.0)
    return (w * target_p[..., None, :]).sum(-1)


def value_rescale(x: torch.Tensor, eps: float = 1e-3) -> torch.Tensor:
    """R2D1's h(x) = sign(x)(sqrt(|x| + 1) - 1) + eps x."""
    return torch.sign(x) * (torch.sqrt(x.abs() + 1.0) - 1.0) + eps * x


def value_rescale_inv(x: torch.Tensor, eps: float = 1e-3) -> torch.Tensor:
    """The closed-form inverse of ``value_rescale``."""
    return torch.sign(x) * (
        ((torch.sqrt(1.0 + 4.0 * eps * (x.abs() + 1.0 + eps)) - 1.0)
         / (2.0 * eps)) ** 2 - 1.0)


@torch.no_grad()
def polyak_update(target: nn.Module, online: nn.Module, tau: float):
    """target <- tau*online + (1-tau)*target, in place; tau=1 is a copy."""
    for t, o in zip(target.parameters(), online.parameters()):
        if tau == 1.0:
            t.copy_(o)
        else:
            t.add_(o - t, alpha=tau)
