"""The port's tree helpers and spaces (rlpyt_tpu_torch/struct.py,
spaces.py) against the JAX package's, on the same numpy inputs: every
result is held exactly (they only move and compare values)."""
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rlpyt_tpu import spaces as jax_spaces
from rlpyt_tpu import struct as jax_struct
from rlpyt_tpu_torch import spaces
from rlpyt_tpu_torch import struct


class Pair(NamedTuple):
    a: object
    b: object


def np_tree(seed=0):
    rng = np.random.default_rng(seed)
    return {"obs": Pair(rng.standard_normal((4, 3, 2)).astype(np.float32),
                        rng.integers(0, 9, (4, 3)).astype(np.int32)),
            "r": rng.standard_normal((4, 3)).astype(np.float32)}


def to_jax(tree):
    return jax.tree.map(jnp.asarray, tree)


def to_torch(tree):
    return struct.tree_map(torch.from_numpy, tree)


def assert_same(got, want):
    got_leaves = struct.tree_leaves(got)
    want_leaves = jax.tree.leaves(want)
    assert len(got_leaves) == len(want_leaves)
    for g, w in zip(got_leaves, want_leaves):
        g = g.numpy() if isinstance(g, torch.Tensor) else np.asarray(g)
        np.testing.assert_array_equal(g, np.asarray(w))
        assert g.shape == np.asarray(w).shape


@pytest.mark.parametrize("dtype", ["float32", "int32"])
def test_to_onehot_matches_jax(dtype):
    idx = np.array([[0, 3, 5], [2, 6, -1]], np.int64)   # 6, -1 out of range
    want = jax_struct.to_onehot(jnp.asarray(idx), 6, getattr(jnp, dtype))
    got = struct.to_onehot(torch.from_numpy(idx), 6, getattr(torch, dtype))
    assert got.dtype == getattr(torch, dtype)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_from_onehot_matches_jax():
    x = np.random.default_rng(1).standard_normal((5, 4, 7)).astype(np.float32)
    x[0, 0] = 1.0          # ties: the first of equal entries
    want = jax_struct.from_onehot(jnp.asarray(x))
    got = struct.from_onehot(torch.from_numpy(x))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    onehot = struct.to_onehot(torch.tensor([2, 0, 4]), 5)
    assert struct.from_onehot(onehot).tolist() == [2, 0, 4]


@pytest.mark.parametrize("n_dims", [0, 1, 2])
def test_get_leading_dims_matches_jax(n_dims):
    tree = np_tree()
    assert (struct.get_leading_dims(to_torch(tree), n_dims)
            == jax_struct.get_leading_dims(to_jax(tree), n_dims))
    assert struct.get_leading_dims({}, n_dims) == ()


def test_get_leading_dims_rejects_mismatch():
    tree = {"a": torch.zeros(4, 3), "b": torch.zeros(5, 3)}
    with pytest.raises(ValueError):
        struct.get_leading_dims(tree)
    with pytest.raises(ValueError):
        jax_struct.get_leading_dims(
            {"a": jnp.zeros((4, 3)), "b": jnp.zeros((5, 3))})


def test_tree_index_take_concat_stack_match_jax():
    tree, other = np_tree(0), np_tree(1)
    jt, tt = to_jax(tree), to_torch(tree)
    assert_same(struct.tree_index(tt, (1, 2)), jax_struct.tree_index(jt, (1, 2)))
    assert_same(struct.tree_index(tt, slice(1, 3)),
                jax_struct.tree_index(jt, slice(1, 3)))
    idx = np.array([[3, 0], [1, 1]])
    for axis in (0, 1):
        assert_same(struct.tree_take(tt, torch.from_numpy(idx) % 3, axis),
                    jax_struct.tree_take(jt, jnp.asarray(idx % 3), axis))
    for axis in (0, 1):
        assert_same(struct.tree_concat([tt, to_torch(other)], axis),
                    jax_struct.tree_concat([jt, to_jax(other)], axis))
        assert_same(struct.tree_stack([tt, to_torch(other)], axis),
                    jax_struct.tree_stack([jt, to_jax(other)], axis))


def test_tree_zeros_copy_numpy_match_jax():
    tree = np_tree(2)
    tt = to_torch(tree)
    assert_same(struct.tree_zeros_like(tt),
                jax_struct.tree_zeros_like(to_jax(tree)))
    copy = struct.tree_copy(tt)
    assert_same(copy, to_jax(tree))
    copy["r"].add_(1.0)
    assert not torch.equal(copy["r"], tt["r"])     # fresh storage
    as_np = struct.tree_to_numpy(tt)
    assert isinstance(as_np["obs"].a, np.ndarray)
    assert_same(as_np, jax_struct.tree_to_numpy(to_jax(tree)))


def test_tree_map_with_path_names_matches_jax():
    tree = {"obs": Pair(np.zeros(2), [np.ones(1), np.ones(3)]),
            "r": np.zeros(1)}
    want = jax_struct.tree_map_with_path_names(
        lambda name, x: name, to_jax(tree))
    got = struct.tree_map_with_path_names(lambda name, x: name,
                                          to_torch(tree))
    assert jax.tree.leaves(want) == _names(got)
    assert _names(got) == ["['obs']/a", "['obs']/b/0", "['obs']/b/1",
                           "['r']"]


def _names(tree):
    """The string leaves of a tree in jax.tree_util's order."""
    if isinstance(tree, dict):
        return [n for k in sorted(tree) for n in _names(tree[k])]
    if isinstance(tree, (tuple, list)):
        return [n for t in tree for n in _names(t)]
    return [tree]


def test_space_is_the_base_of_every_space():
    box = spaces.IntBox(0, 4)
    fbox = spaces.FloatBox(-1.0, 1.0, (3,))
    comp = spaces.Composite({"a": box, "b": fbox})
    for space in (box, fbox, comp):
        assert isinstance(space, spaces.Space)
    for name in ("IntBox", "FloatBox", "Composite"):
        assert issubclass(getattr(jax_spaces, name), jax_spaces.Space)
    with pytest.raises(NotImplementedError):
        spaces.Space().sample(torch.Generator())
    with pytest.raises(NotImplementedError):
        spaces.Space().null_value("cpu")
