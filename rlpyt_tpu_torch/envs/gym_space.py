"""Gymnasium space conversion (port of rlpyt_tpu/envs/gym_space.py;
reference: rlpyt/spaces/gym_wrapper.py:GymSpaceWrapper ~L10-120).

Maps gymnasium spaces onto the port's spaces, so host envs
(envs/host.py) expose the same ``EnvSpaces`` as the tensor envs:
Box -> FloatBox (IntBox for an integer Box), Discrete -> IntBox,
Dict / Tuple -> Composite, MultiDiscrete -> IntBox.  gymnasium is
imported only when a space is converted.
"""
from __future__ import annotations

import numpy as np
import torch

from rlpyt_tpu_torch.spaces import Composite, FloatBox, IntBox


def convert_gym_space(space):
    import gymnasium.spaces as gs

    if isinstance(space, gs.Discrete):
        return IntBox(int(space.start), int(space.start + space.n))
    if isinstance(space, gs.Box):
        low = np.asarray(space.low)
        high = np.asarray(space.high)
        if np.issubdtype(space.dtype, np.integer):
            return IntBox(int(low.min()), int(high.max()) + 1,
                          shape=space.shape,
                          dtype=getattr(torch, np.dtype(space.dtype).name))
        return FloatBox(low, high, shape=space.shape)
    if isinstance(space, gs.Dict):
        return Composite({k: convert_gym_space(v)
                          for k, v in space.spaces.items()})
    if isinstance(space, gs.Tuple):
        return Composite({str(i): convert_gym_space(v)
                          for i, v in enumerate(space.spaces)})
    if isinstance(space, gs.MultiDiscrete):
        return IntBox(0, int(np.max(space.nvec)),
                      shape=(len(space.nvec),))
    raise NotImplementedError(f"gym space {type(space).__name__}")
