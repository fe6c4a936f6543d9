"""The port's Conv2dHeadModel and the ``nonlinearity`` of MlpModel and
Conv2dModel against the JAX modules, with the same weights (the flax
tree carried over by rlpyt_tpu_torch/params.py, or mapped by hand for a
bare trunk) and inputs from a numpy seed.

Tolerance: float32 forward at rtol=1e-5, atol=1e-6 (small widths, so the
two frameworks' different summation orders stay within it).
"""
import flax.linen as flax_nn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rlpyt_tpu.models.conv import Conv2dHeadModel as JaxConv2dHeadModel
from rlpyt_tpu.models.conv import Conv2dModel as JaxConv2dModel
from rlpyt_tpu.models.mlp import MlpModel as JaxMlpModel
from rlpyt_tpu_torch.models import Conv2dHeadModel, Conv2dModel, MlpModel
from rlpyt_tpu_torch.params import from_jax_params, s2d_stride_of, \
    to_jax_params

torch.set_num_threads(2)

CLOSE = dict(rtol=1e-5, atol=1e-6)
C, H, W = 4, 10, 10
# Two layers, the first strided so that a space-to-depth trunk would
# block it: the head model's trunk must stay plain all the same.
CONV = dict(channels=(8, 6), kernel_sizes=(4, 3), strides=(2, 1),
            paddings=(0, 1))
NONLINEARITIES = {"relu": (flax_nn.relu, torch.relu),
                  "tanh": (flax_nn.tanh, torch.tanh)}


def numpy_tree(tree):
    return jax.tree.map(np.asarray, tree)


def inputs(seed, shape):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def head_pair(output_size, act, seed=0):
    jact, tact = NONLINEARITIES[act]
    jm = JaxConv2dHeadModel(hidden_sizes=(32, 16), output_size=output_size,
                            nonlinearity=jact, **CONV)
    params = numpy_tree(jm.init(jax.random.key(seed),
                                jnp.zeros((2, C, H, W), jnp.float32)))
    tm = Conv2dHeadModel(C, (H, W), hidden_sizes=(32, 16),
                         output_size=output_size, nonlinearity=tact, **CONV)
    tm.load_state_dict({k: torch.tensor(v) for k, v in
                        from_jax_params(params).items()})
    return jm, params, tm


@pytest.mark.parametrize("act", NONLINEARITIES)
@pytest.mark.parametrize("output_size", [None, 5])
def test_conv_head_matches_jax(output_size, act):
    jm, params, tm = head_pair(output_size, act)
    x = inputs(1, (7, C, H, W))
    want = np.asarray(jm.apply(params, jnp.asarray(x)))
    with torch.no_grad():
        got = tm(torch.from_numpy(x)).numpy()
    assert got.shape == want.shape == (7, output_size or 16)
    assert got.dtype == np.float32
    np.testing.assert_allclose(got, want, **CLOSE)


@pytest.mark.parametrize("output_size", [None, 5])
def test_conv_head_bridge_round_trip(output_size):
    """The JAX tree's names (Conv2dModel_0/Conv_i, MlpModel_0/Dense_j)
    map onto the state_dict and back, plain first conv included."""
    _, params, tm = head_pair(output_size, "relu")
    assert set(params["params"]) == {"Conv2dModel_0", "MlpModel_0"}
    assert s2d_stride_of(tm) is None
    back = to_jax_params(tm.state_dict(), s2d_stride_of(tm))
    assert jax.tree.structure(back) == jax.tree.structure(params)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(params)):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("act", NONLINEARITIES)
@pytest.mark.parametrize("output_size", [None, 3])
def test_mlp_nonlinearity_matches_jax(output_size, act):
    jact, tact = NONLINEARITIES[act]
    jm = JaxMlpModel((24, 12), output_size, nonlinearity=jact)
    params = numpy_tree(jm.init(jax.random.key(2), jnp.zeros((1, 9))))
    tm = MlpModel(9, (24, 12), output_size, nonlinearity=tact)
    with torch.no_grad():
        for j, layer in enumerate(tm.layers):
            leaf = params["params"][f"Dense_{j}"]
            layer.weight.copy_(torch.tensor(leaf["kernel"].T))
            layer.bias.copy_(torch.tensor(leaf["bias"]))
    x = inputs(3, (6, 9))
    want = np.asarray(jm.apply(params, jnp.asarray(x)))
    with torch.no_grad():
        got = tm(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, **CLOSE)


@pytest.mark.parametrize("act", NONLINEARITIES)
def test_conv_nonlinearity_matches_jax(act):
    jact, tact = NONLINEARITIES[act]
    jm = JaxConv2dModel(nonlinearity=jact, **CONV)
    params = numpy_tree(jm.init(jax.random.key(4),
                                jnp.zeros((1, C, H, W), jnp.float32)))
    tm = Conv2dModel(C, nonlinearity=tact, **CONV)
    with torch.no_grad():
        for i, conv in enumerate(tm.convs):
            leaf = params["params"][f"Conv_{i}"]
            conv.weight.copy_(torch.from_numpy(
                leaf["kernel"].transpose(3, 2, 0, 1).copy()))
            conv.bias.copy_(torch.tensor(leaf["bias"]))
    x = inputs(5, (3, C, H, W))
    want = np.asarray(jm.apply(params, jnp.asarray(x)))
    with torch.no_grad():
        got = tm(torch.from_numpy(x)).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, **CLOSE)


def test_default_nonlinearity_is_relu_bit_for_bit():
    """The default leaves a model's output as it was: F.relu after every
    conv and hidden layer."""
    torch.manual_seed(0)
    tm = Conv2dHeadModel(C, (H, W), hidden_sizes=(16,), output_size=4,
                         **CONV)
    x = torch.from_numpy(inputs(6, (2, C, H, W)))
    with torch.no_grad():
        got = tm(x)
        y = x
        for conv in tm.conv.convs:
            y = torch.nn.functional.relu(conv(y))
        y = y.reshape(2, -1)
        y = torch.nn.functional.relu(tm.head.layers[0](y))
        want = tm.head.layers[1](y)
    assert torch.equal(got, want)
