"""The port's CartPole and FloatBox against the JAX package, on the CPU;
at the end, Acrobot, MountainCar and DictObsCartPole.

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
import pytest
import torch

from rlpyt_tpu.envs.classic import Acrobot as JaxAcrobot
from rlpyt_tpu.envs.classic import CartPole as JaxCartPole
from rlpyt_tpu.envs.classic import DictObsCartPole as JaxDictObsCartPole
from rlpyt_tpu.envs.classic import MountainCar as JaxMountainCar
from rlpyt_tpu_torch.envs.classic import CartPole, CartPoleResetDraws, \
    CartPoleState
from rlpyt_tpu_torch.envs.classic import (
    Acrobot,
    AcrobotResetDraws,
    AcrobotState,
    DictObsCartPole,
    MountainCar,
    MountainCarResetDraws,
    MountainCarState,
)
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


# ------------------------------------------- Acrobot, MountainCar, dicts
#
# Resets are held bit for bit under JAX's per-lane draws (Acrobot's
# observation, cos and sin of its angles, to the last bit: XLA's sin and
# cos are not torch's).  A step is held once from the same state on both
# sides, never over a rollout (Acrobot is chaotic): observations to rtol
# 1e-6 with atol 1e-6, rewards, dones, time-limit flags and step counters
# equal.  MountainCar and DictObsCartPole step from random states over
# their ranges; Acrobot steps from the states it visits under random
# torques from its resets (each step from the JAX state).  At the edge of
# Acrobot's velocity range (|dtheta2| near 9 pi, 5.6 rad a step) one RK4
# step multiplies a last-bit difference of sin or cos by the squared
# velocities to 1e-3: no float32 implementation is held there.

STEP_CLOSE = dict(rtol=1e-6, atol=1e-6)


def lane_draws(key, n, shape, lo, hi):
    return np.asarray(jax.vmap(lambda k: jax.random.uniform(
        k, shape, minval=lo, maxval=hi))(jax.random.split(key, n)))


@pytest.mark.parametrize("kind", ["acrobot", "mountain_car", "dict_cartpole"])
def test_resets_match_jax_bit_for_bit(kind):
    key, n = jax.random.key(7), 64
    if kind == "acrobot":
        jenv, env = JaxAcrobot(), Acrobot(device="cpu")
        draws = AcrobotResetDraws(torch.tensor(
            lane_draws(key, n, (4,), -0.1, 0.1)))
    elif kind == "mountain_car":
        jenv, env = JaxMountainCar(), MountainCar(device="cpu")
        draws = MountainCarResetDraws(torch.tensor(
            lane_draws(key, n, (), -0.6, -0.4)))
    else:
        jenv, env = JaxDictObsCartPole(), DictObsCartPole(device="cpu")
        draws = CartPoleResetDraws(torch.tensor(
            np.asarray(jax_reset_draws(key, n))))
    jstate, jobs = jenv.reset_batch(key, n)
    state, obs = env.reset_batch(n, draws=draws)
    jax.tree.map(lambda got, want: np.testing.assert_array_equal(
        got.numpy(), np.asarray(want)), tuple(state), tuple(jstate))
    if kind == "acrobot":
        np.testing.assert_allclose(obs.numpy(), np.asarray(jobs),
                                   **STEP_CLOSE)
    else:
        jax.tree.map(lambda got, want: np.testing.assert_array_equal(
            got.numpy(), np.asarray(want)), obs, jobs)
    assert state.t.dtype == torch.int32 and not state.t.any()


def random_states(kind, rng, n, max_steps):
    """States spread over each env's range, some one step from the time
    limit."""
    t = rng.integers(max_steps - 3, max_steps, n).astype(np.int32)
    if kind == "mountain_car":
        return (rng.uniform(-1.2, 0.6, n).astype(np.float32),
                rng.uniform(-0.07, 0.07, n).astype(np.float32), t)
    return (rng.uniform(-2.4, 2.4, n).astype(np.float32),
            rng.uniform(-2, 2, n).astype(np.float32),
            rng.uniform(-0.2, 0.2, n).astype(np.float32),
            rng.uniform(-2, 2, n).astype(np.float32), t)


def assert_step_matches(st, jst, nxt, jnext):
    jax.tree.map(lambda got, want: np.testing.assert_allclose(
        got.numpy(), np.asarray(want), **STEP_CLOSE), st.observation,
        jst.observation)
    for got, want in ((st.reward, jst.reward), (st.done, jst.done),
                      (st.info["timeout"], jst.info["timeout"]),
                      (nxt.t, jnext.t)):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert st.reward.dtype == torch.float32


@pytest.mark.parametrize("kind", ["mountain_car", "dict_cartpole"])
def test_one_step_matches_jax(kind):
    n, max_steps = 512, 50
    jenv, env, State = {
        "mountain_car": (JaxMountainCar(max_steps),
                         MountainCar(max_steps, device="cpu"),
                         MountainCarState),
        "dict_cartpole": (JaxDictObsCartPole(max_steps),
                          DictObsCartPole(max_steps, device="cpu"),
                          CartPoleState)}[kind]
    rng = np.random.default_rng(11)
    fields = random_states(kind, rng, n, max_steps)
    action = rng.integers(0, env.action_space.n, n).astype(np.int32)
    jstate = type(jenv.reset(jax.random.key(0))[0])(
        *(jnp.asarray(x) for x in fields))
    jnext, jst = jax.jit(jenv.step_batch)(jax.random.key(1), jstate,
                                          jnp.asarray(action))
    nxt, st = env.step_batch(State(*(torch.tensor(x) for x in fields)),
                             torch.tensor(action).long())
    assert_step_matches(st, jst, nxt, jnext)
    assert st.info["timeout"].any() and (st.done & ~st.info["timeout"]).any()


def test_acrobot_step_matches_jax():
    """200 steps of 64 lanes under random torques and a time limit of 80,
    each from the JAX state; done lanes reset on the JAX side."""
    B, max_steps = 64, 80
    jenv, env = JaxAcrobot(max_steps), Acrobot(max_steps, device="cpu")
    step = jax.jit(jenv.step_batch)
    reset = jax.jit(jenv.reset_batch, static_argnums=1)
    key = jax.random.key(0)
    jstate, _ = reset(key, B)
    rng = np.random.default_rng(0)
    n_timeout = 0
    for _ in range(200):
        action = rng.integers(0, 3, B).astype(np.int32)
        key, k_step, k_reset = jax.random.split(key, 3)
        jnext, jst = step(k_step, jstate, jnp.asarray(action))
        nxt, st = env.step_batch(
            AcrobotState(*(torch.tensor(np.asarray(x)) for x in jstate)),
            torch.tensor(action).long())
        assert_step_matches(st, jst, nxt, jnext)
        n_timeout += int(st.info["timeout"].sum())
        jreset, _ = reset(k_reset, B)
        jstate = jax.tree.map(
            lambda r, s: jnp.where(jst.done, r, s), jreset, jnext)
    assert n_timeout > 0
