"""The port's CartPole and FloatBox against the JAX package, on the CPU.

CartPole's only randomness is its reset; the port is fed the values that
JAX's per-lane keys draw.  Resets are equal bit for bit.  A step is held
within float32 rounding, not bit for bit: XLA evaluates sin and cos by its
own approximations, and under jit rewrites a division by a constant as a
product with its float32 reciprocal, so single results differ in the last
bits.  Each step therefore starts both sides from the JAX state, and the
observations must agree to rtol 1e-5, atol 1e-6; rewards, dones and
time-limit flags must be equal.
"""
import jax
import jax.numpy as jnp
import numpy as np
import torch

from rlpyt_tpu.envs.classic import CartPole as JaxCartPole
from rlpyt_tpu_torch.envs.classic import CartPole, CartPoleResetDraws, \
    CartPoleState
from rlpyt_tpu_torch.spaces import FloatBox

torch.set_num_threads(2)


def jax_reset_draws(key, n):
    """The four uniform values of each lane's reset, as JAX draws them."""
    return jax.vmap(lambda k: jax.random.uniform(
        k, (4,), minval=-0.05, maxval=0.05))(jax.random.split(key, n))


def test_reset_matches_jax_bit_for_bit():
    key, n = jax.random.key(3), 32
    jstate, jobs = JaxCartPole().reset_batch(key, n)
    state, obs = CartPole(device="cpu").reset_batch(
        n, draws=CartPoleResetDraws(torch.tensor(
            np.asarray(jax_reset_draws(key, n)))))
    np.testing.assert_array_equal(obs.numpy(), np.asarray(jobs))
    assert obs.dtype == torch.float32 and state.t.dtype == torch.int32
    assert not state.t.any()


def test_step_matches_jax_within_rounding():
    """300 steps of 64 lanes and a time limit of 120, from the JAX state
    at each step; half the lanes act at random (they fall), half push
    toward the pole's lean (they reach the time limit)."""
    B, max_steps = 64, 120
    jenv, env = JaxCartPole(max_steps), CartPole(max_steps, device="cpu")
    step = jax.jit(jenv.step_batch)
    reset = jax.jit(jenv.reset_batch, static_argnums=1)
    key = jax.random.key(0)
    jstate, _ = reset(key, B)
    rng = np.random.default_rng(0)
    n_done = n_timeout = 0
    for _ in range(300):
        lean = np.asarray(jstate.theta + 0.5 * jstate.theta_dot) > 0
        action = np.where(np.arange(B) < B // 2, lean,
                          rng.integers(0, 2, B)).astype(np.int32)
        key, k_step, k_reset = jax.random.split(key, 3)
        state = CartPoleState(*(torch.tensor(np.asarray(x)) for x in jstate))
        jnext, jst = step(k_step, jstate, jnp.asarray(action))
        nxt, st = env.step_batch(state, torch.tensor(action).long())
        np.testing.assert_allclose(st.observation.numpy(),
                                   np.asarray(jst.observation),
                                   rtol=1e-5, atol=1e-6)
        for got, want in ((st.reward, jst.reward), (st.done, jst.done),
                          (st.info["timeout"], jst.info["timeout"]),
                          (nxt.t, jnext.t)):
            np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        n_done += int(st.done.sum())
        n_timeout += int(st.info["timeout"].sum())
        # Auto-reset done lanes on the JAX side, as the collector does.
        jreset, _ = reset(k_reset, B)
        jstate = jax.tree.map(
            lambda r, s: jnp.where(jst.done, r, s), jreset, jnext)
    assert n_done > n_timeout > 0


def test_spaces_match_jax():
    jspace, space = JaxCartPole().observation_space, \
        CartPole(device="cpu").observation_space
    np.testing.assert_array_equal(space.low, jspace.low)
    np.testing.assert_array_equal(space.high, jspace.high)
    assert space.shape == jspace.shape == (4,)
    assert CartPole(device="cpu").action_space.n == 2


def test_float_box_sample_in_bounds():
    box = FloatBox(low=[-1.0, 0.0], high=[1.0, 5.0])
    x = box.sample(torch.Generator().manual_seed(0), (1000,))
    assert x.shape == (1000, 2) and x.dtype == torch.float32
    assert (x >= torch.tensor(box.low)).all()
    assert (x <= torch.tensor(box.high)).all()
    assert torch.equal(box.null_value("cpu"), torch.zeros(2))
