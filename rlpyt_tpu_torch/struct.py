"""Tensor-tree plumbing (port of rlpyt_tpu/struct.py).

A "tree" is a nest of NamedTuples, tuples, lists and dicts with tensors
(or None) at the leaves — rlpyt's namedarraytuple idiom.
"""
from __future__ import annotations

from typing import Any, Callable

import torch


def tree_map(fn: Callable, tree, *rest):
    """Apply ``fn`` leafwise over trees of the same structure."""
    if tree is None:
        return None
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(tree_map(fn, *xs) for xs in zip(tree, *rest)))
    if isinstance(tree, (tuple, list)):
        return type(tree)(tree_map(fn, *xs) for xs in zip(tree, *rest))
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    return fn(tree, *rest)


def tree_select(pred: torch.Tensor, on_true, on_false):
    """Leafwise ``where``; ``pred`` ([B]) broadcasts over trailing dims."""

    def _sel(a, b):
        p = pred.reshape(pred.shape + (1,) * (a.dim() - pred.dim()))
        return torch.where(p, a, b)

    return tree_map(_sel, on_true, on_false)


def buffer_from_example(example, leading_dims, device) -> Any:
    """Zeroed tree with ``leading_dims`` prepended to every leaf."""
    lead = tuple(leading_dims)
    return tree_map(lambda x: torch.zeros(lead + tuple(x.shape),
                                          dtype=x.dtype, device=device),
                    example)


def infer_leading_dims(x: torch.Tensor, dim: int):
    """Classify input as [], [B] or [T,B] + ``dim`` feature dims.

    Returns (lead_dim, T, B, feature_shape)."""
    lead_dim = x.dim() - dim
    if lead_dim not in (0, 1, 2):
        raise ValueError(f"bad leading dims: {tuple(x.shape)} with dim={dim}")
    if lead_dim == 2:
        T, B = x.shape[:2]
    elif lead_dim == 1:
        T, B = 1, x.shape[0]
    else:
        T, B = 1, 1
    return lead_dim, T, B, tuple(x.shape[lead_dim:])


def tree_leaves(tree) -> list:
    """The tensors of a tree in ``jax.tree_util``'s leaf order: dict keys
    sorted, sequences in order, None dropped."""
    if tree is None:
        return []
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in tree_leaves(tree[k])]
    if isinstance(tree, (tuple, list)):
        return [x for t in tree for x in tree_leaves(t)]
    return [tree]


def infer_leading_dims_tree(observation, dim: int = 1):
    """``infer_leading_dims`` over a tree observation (a dict from a
    Composite space): each leaf, with ``dim`` feature dims, is flattened
    to [T*B, F_leaf] in float32, and the leaves are concatenated on the
    feature axis in ``tree_leaves`` order, as the JAX package does.
    Returns (lead_dim, T, B, x [T*B, F_total])."""
    leaves = tree_leaves(observation)
    lead_dim, T, B, _ = infer_leading_dims(leaves[0], dim)
    flat = [leaf.reshape(T * B, -1).to(torch.float32) for leaf in leaves]
    return lead_dim, T, B, torch.cat(flat, dim=-1)


def restore_leading_dims(x, lead_dim: int, T: int = 1, B: int = 1):
    """Undo the [T*B] flattening of ``infer_leading_dims``."""

    def _restore(y):
        if lead_dim == 2:
            return y.reshape((T, B) + tuple(y.shape[1:]))
        if lead_dim == 1:
            return y.reshape((B,) + tuple(y.shape[1:]))
        return y.reshape(tuple(y.shape[1:]))

    return tree_map(_restore, x)


def select_at_indexes(indexes: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """``x[..., indexes]`` along the last axis: Q(s, a) extraction."""
    return torch.gather(x, -1, indexes.long().unsqueeze(-1)).squeeze(-1)


def valid_mean(x: torch.Tensor, valid: torch.Tensor | None = None
               ) -> torch.Tensor:
    """Mean over valid entries."""
    if valid is None:
        return x.mean()
    valid = valid.to(x.dtype)
    return (x * valid).sum() / torch.clamp(valid.sum(), min=1e-8)
