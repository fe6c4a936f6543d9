"""Port's AtariDqnModel (rlpyt_tpu_torch/models) against the JAX model,
with weights carried over by the bridge (rlpyt_tpu_torch/params.py).

Tolerances: float32 forward at rtol=1e-4, atol=1e-5 (the two frameworks
sum conv and dense products in different orders).  bfloat16 forward at
atol = 0.05 * max|q| + 1e-3: both round activations to bf16's 8-bit
mantissa after every layer, at different places, over 5 layers.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rlpyt_tpu.models.dqn import AtariDqnModel as JaxAtariDqnModel
from rlpyt_tpu_torch.models.dqn import AtariDqnModel
from rlpyt_tpu_torch.params import from_jax_params, to_jax_params

torch.set_num_threads(2)

K, H, W, N_ACTIONS = 4, 104, 80, 6
NARROW = dict(channels=(8, 8, 8), fc_sizes=(32,))


def numpy_tree(tree):
    return jax.tree.map(np.asarray, tree)


def bridged_pair(s2d: bool, jdtype=jnp.float32, tdtype=torch.float32,
                 seed=0):
    jm = JaxAtariDqnModel(n_actions=N_ACTIONS, space_to_depth=s2d,
                          compute_dtype=jdtype, **NARROW)
    params = jm.init(jax.random.key(seed),
                     jnp.zeros((2, K, H, W), jnp.uint8))
    tm = AtariDqnModel((K, H, W), N_ACTIONS, compute_dtype=tdtype, **NARROW)
    tm.load_state_dict({k: torch.tensor(v) for k, v in
                        from_jax_params(numpy_tree(params)).items()})
    return jm, params, tm


def frames(seed, shape):
    return np.random.default_rng(seed).integers(0, 256, shape, dtype=np.uint8)


@pytest.mark.parametrize("s2d", [True, False])
def test_forward_matches_jax_fp32(s2d):
    jm, params, tm = bridged_pair(s2d)
    obs = frames(1, (5, K, H, W))
    q_ref = np.asarray(jm.apply(params, jnp.asarray(obs)))
    with torch.no_grad():
        q = tm(torch.from_numpy(obs)).numpy()
    assert q.shape == (5, N_ACTIONS) and q.dtype == np.float32
    np.testing.assert_allclose(q, q_ref, rtol=1e-4, atol=1e-5)


def test_forward_leading_dims():
    """[T, B] and [] observations take the same weights."""
    jm, params, tm = bridged_pair(True)
    obs = frames(2, (2, 3, K, H, W))
    q_ref = np.asarray(jm.apply(params, jnp.asarray(obs)))
    with torch.no_grad():
        q = tm(torch.from_numpy(obs)).numpy()
        q1 = tm(torch.from_numpy(obs[0, 0])).numpy()
    assert q.shape == (2, 3, N_ACTIONS) and q1.shape == (N_ACTIONS,)
    np.testing.assert_allclose(q, q_ref, rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(q1, q_ref[0, 0], rtol=1e-4, atol=1e-5)


def test_forward_matches_jax_bf16():
    jm, params, tm = bridged_pair(True, jnp.bfloat16, torch.bfloat16)
    obs = frames(3, (6, K, H, W))
    q_ref = np.asarray(jm.apply(params, jnp.asarray(obs)))
    with torch.no_grad():
        q = tm(torch.from_numpy(obs)).numpy()
    assert q.dtype == np.float32
    np.testing.assert_allclose(q, q_ref, rtol=0,
                               atol=0.05 * np.abs(q_ref).max() + 1e-3)


@pytest.mark.parametrize("s2d", [True, False])
def test_bridge_round_trip(s2d):
    _, params, tm = bridged_pair(s2d, seed=4)
    back = to_jax_params(tm.state_dict(), 4 if s2d else None)
    ref = numpy_tree(params)
    jax.tree.map(np.testing.assert_array_equal, back, ref)
    assert jax.tree.structure(back) == jax.tree.structure(ref)


def test_s2d_reblocking_formula():
    """weight[o, c, hb*s+dy, wb*s+dx] == kernel[c, hb, wb, dy*s+dx, o]."""
    _, params, tm = bridged_pair(True, seed=5)
    kernel = np.asarray(params["params"]["Conv2dModel_0"]["Conv_0"]["kernel"])
    weight = tm.conv.convs[0].weight.detach().numpy()
    C, kb, _, ss, out = kernel.shape
    s = int(round(ss ** 0.5))
    rng = np.random.default_rng(0)
    for _ in range(50):
        o, c = rng.integers(out), rng.integers(C)
        hb, wb = rng.integers(kb, size=2)
        dy, dx = rng.integers(s, size=2)
        assert weight[o, c, hb * s + dy, wb * s + dx] == \
            kernel[c, hb, wb, dy * s + dx, o]
