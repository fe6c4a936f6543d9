"""Checkpoint and resume (port of rlpyt_tpu/utils/checkpoint.py).

A checkpoint is a run's whole state, the tree that the runner's
``state_dict()`` gives: the model, the algorithm's target networks,
optimizers and replay, the collector's state, the generators' states and
the last logged trajectory stats.  Resumed from it, a run goes on as the
uninterrupted one would have, bit for bit.

The file is ``torch.save`` of the tree with every tensor copied to the
CPU, so a checkpoint written on the card loads where there is none.  It
is written to a temporary file beside ``path`` and then moved over it,
so a run stopped while writing leaves the previous checkpoint whole.
"""
from __future__ import annotations

import os
import tempfile
from typing import Any, Optional, Tuple

import torch

from rlpyt_tpu_torch.struct import tree_map


def _to_cpu(leaf):
    return leaf.detach().cpu() if isinstance(leaf, torch.Tensor) else leaf


def save_checkpoint(path: str, state: Any,
                    metadata: Optional[dict] = None) -> None:
    """Atomically write ``state`` (a tree of tensors, containers and
    Python values) and ``metadata`` to ``path``."""
    payload = {"state": tree_map(_to_cpu, state),
               "metadata": dict(metadata or {})}
    d = os.path.dirname(os.path.abspath(path))
    os.makedirs(d, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=d, suffix=".tmp")
    try:
        with os.fdopen(fd, "wb") as f:
            torch.save(payload, f)
        os.replace(tmp, path)
    except BaseException:
        if os.path.exists(tmp):
            os.unlink(tmp)
        raise


def _place(x, ref):
    """``x`` with each tensor on the device of its counterpart in
    ``ref``; parts that ``ref`` lacks (an optimizer's moments, made at
    its first step) stay on the CPU."""
    if isinstance(x, torch.Tensor):
        return x.to(ref.device) if isinstance(ref, torch.Tensor) else x
    if isinstance(x, dict):
        ref = ref if isinstance(ref, dict) else {}
        return {k: _place(v, ref.get(k)) for k, v in x.items()}
    if isinstance(x, (tuple, list)):
        ref = ref if isinstance(ref, (tuple, list)) \
            and len(ref) == len(x) else (None,) * len(x)
        items = [_place(v, r) for v, r in zip(x, ref)]
        return type(x)(*items) if hasattr(x, "_fields") else type(x)(items)
    return x


def load_checkpoint(path: str, like: Any = None) -> Tuple[Any, dict]:
    """Read a checkpoint: (state, metadata).  With ``like`` (a state of
    the same structure, such as a fresh runner's ``state_dict()``), each
    tensor is placed on the device of its counterpart in ``like``;
    without, tensors stay on the CPU."""
    # The state holds NamedTuples of the port (the collector's state, the
    # replay rings), which the weights-only unpickler refuses.
    payload = torch.load(path, map_location="cpu", weights_only=False)
    state = payload["state"]
    if like is not None:
        state = _place(state, like)
    return state, payload["metadata"]
