"""Value-function ops (port of rlpyt_tpu/ops/value.py: huber_loss,
polyak_update)."""
from __future__ import annotations

import torch
from torch import nn


def huber_loss(delta: torch.Tensor, clip: float = 1.0) -> torch.Tensor:
    """Elementwise Huber on the TD error (``delta_clip``)."""
    abs_d = delta.abs()
    quad = torch.clamp(abs_d, max=clip)
    return 0.5 * quad ** 2 + clip * (abs_d - quad)


@torch.no_grad()
def polyak_update(target: nn.Module, online: nn.Module, tau: float):
    """target <- tau*online + (1-tau)*target, in place; tau=1 is a copy."""
    for t, o in zip(target.parameters(), online.parameters()):
        if tau == 1.0:
            t.copy_(o)
        else:
            t.add_(o - t, alpha=tau)
