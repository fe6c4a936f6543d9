"""Tensor-tree plumbing (port of rlpyt_tpu/struct.py).

A "tree" is a nest of NamedTuples, tuples, lists and dicts with tensors
(or None) at the leaves — rlpyt's namedarraytuple idiom.
"""
from __future__ import annotations

import math
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


def tree_index(tree, idx):
    """Index every leaf: ``tree_index(s, (t, b))`` is rlpyt's ``s[t, b]``."""
    return tree_map(lambda x: x[idx], tree)


def tree_take(tree, indices: torch.Tensor, axis: int = 0):
    """Gather ``indices`` (any shape) along ``axis`` of every leaf, as
    ``jnp.take`` does."""
    indices = torch.as_tensor(indices)

    def _take(x):
        idx = indices.to(x.device, torch.int64)
        out = torch.index_select(x, axis, idx.reshape(-1))
        return out.reshape(tuple(x.shape[:axis]) + tuple(idx.shape)
                           + tuple(x.shape[axis + 1:]))

    return tree_map(_take, tree)


def tree_concat(trees, axis: int = 0):
    return tree_map(lambda *xs: torch.cat(xs, dim=axis), *trees)


def tree_stack(trees, axis: int = 0):
    return tree_map(lambda *xs: torch.stack(xs, dim=axis), *trees)


def tree_zeros_like(tree):
    return tree_map(torch.zeros_like, tree)


def buffer_from_example(example, leading_dims, device) -> Any:
    """Zeroed tree with ``leading_dims`` prepended to every leaf."""
    lead = tuple(leading_dims)
    return tree_map(lambda x: torch.zeros(lead + tuple(x.shape),
                                          dtype=x.dtype, device=device),
                    example)


def get_leading_dims(tree, n_dims: int = 1) -> tuple:
    """The first ``n_dims`` dims, which every leaf must share."""
    leaves = tree_leaves(tree)
    if not leaves:
        return ()
    lead = tuple(leaves[0].shape[:n_dims])
    for leaf in leaves[1:]:
        if tuple(leaf.shape[:n_dims]) != lead:
            raise ValueError(f"mismatched leading dims: "
                             f"{tuple(leaf.shape[:n_dims])} vs {lead}")
    return lead


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
    flat = [leaf.reshape(T * B, math.prod(leaf.shape[lead_dim:]))
            .to(torch.float32) for leaf in leaves]
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


def to_onehot(indexes: torch.Tensor, num: int, dtype=torch.float32
              ) -> torch.Tensor:
    """[...] integer indexes -> [..., num]; an index outside [0, num)
    gives a row of zeros, as ``jax.nn.one_hot`` does."""
    arange = torch.arange(num, device=indexes.device)
    return (indexes.unsqueeze(-1) == arange).to(dtype)


def from_onehot(onehot: torch.Tensor, dtype=torch.int64) -> torch.Tensor:
    """The index of the largest entry (the first of equal ones)."""
    return torch.argmax(onehot, dim=-1).to(dtype)


def valid_mean(x: torch.Tensor, valid: torch.Tensor | None = None
               ) -> torch.Tensor:
    """Mean over valid entries."""
    if valid is None:
        return x.mean()
    valid = valid.to(x.dtype)
    return (x * valid).sum() / torch.clamp(valid.sum(), min=1e-8)


def tree_to_numpy(tree):
    return tree_map(lambda x: x.detach().cpu().numpy(), tree)


def tree_map_with_path_names(fn: Callable[[str, Any], Any], tree):
    """Map ``fn(name, leaf)``, the name the leaf's path joined by '/':
    a NamedTuple field by its name, a sequence item by its index, a dict
    entry as ``['key']``, as the JAX package names ``jax.tree_util`` key
    paths."""

    def walk(path, t):
        if t is None:
            return None
        if isinstance(t, tuple) and hasattr(t, "_fields"):
            return type(t)(*(walk(path + (f,), x)
                             for f, x in zip(t._fields, t)))
        if isinstance(t, (tuple, list)):
            return type(t)(walk(path + (str(i),), x)
                           for i, x in enumerate(t))
        if isinstance(t, dict):
            return {k: walk(path + (f"[{k!r}]",), v) for k, v in t.items()}
        return fn("/".join(path), t)

    return walk((), tree)


def tree_copy(tree):
    """A fresh tensor for every leaf."""
    return tree_map(torch.clone, tree)


def state_of(obj, names) -> dict:
    """The named attributes of ``obj`` as one state dict: an attribute
    with a ``state_dict()`` (a module, an optimizer, a replay buffer), or
    a dict of such, gives its state; any other (a tensor tree, a Python
    number) is taken as it is.  Tensors are the live ones, not copies."""

    def one(value):
        if hasattr(value, "state_dict"):
            return value.state_dict()
        if isinstance(value, dict) and value and all(
                hasattr(v, "state_dict") for v in value.values()):
            return {k: v.state_dict() for k, v in value.items()}
        return value

    return {name: one(getattr(obj, name)) for name in names}


@torch.no_grad()
def load_state(obj, state: dict, names):
    """Undo ``state_of``: stateful attributes load their part, tensor
    trees are copied into the live tensors (which keeps their device and
    every reference to them), Python numbers are set."""
    for name in names:
        value, saved = getattr(obj, name), state[name]
        if hasattr(value, "load_state_dict"):
            value.load_state_dict(saved)
        elif isinstance(value, dict) and value and all(
                hasattr(v, "load_state_dict") for v in value.values()):
            for k, v in value.items():
                v.load_state_dict(saved[k])
        elif isinstance(value, (bool, int, float)):
            setattr(obj, name, type(value)(saved))
        else:
            tree_map(lambda dst, src: dst.copy_(src), value, saved)
