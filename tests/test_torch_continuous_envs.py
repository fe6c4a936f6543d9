"""The port's continuous-control envs against the JAX package's, on the
CPU: Pendulum, ContinuousMountainCar, Reacher, Hopper2D and Cheetah2D.

Each env's only randomness is its reset; the port is fed the uniform
values that JAX's per-lane keys draw, and its reset states are equal bit
for bit.  Observations that take a sine or cosine (Pendulum, Reacher)
are held within float32 rounding (rtol 1e-6, atol 1e-6): XLA and torch
round sin and cos each their own way.

Steps of Pendulum, ContinuousMountainCar and Reacher start both sides
from the JAX state at each step (auto-resetting done lanes from JAX
draws); observations and rewards must agree to rtol 1e-5, atol 1e-5
(Reacher's accelerations divide by a mass-matrix determinant near 1e-8,
and its fingertip offset is a difference of near values, so its rounding
reaches about 2e-6 there) and dones, time-limit flags and step counts
must be equal.

Hopper2D and Cheetah2D: the JAX env derives its dynamics by autodiff of
the Lagrangian, the port writes them in closed form, and the contact
springs are stiff, so no long free-running rollout is compared.  From the
same (q, q', action):
- q'' to rtol 1e-3 and an absolute 1e-5 of the batch's largest |q''|;
- one env step (16 substeps): q, q' and the observation to atol 1e-4,
  rtol 1e-4, the reward to atol 1e-4;
- dones and time-limit flags equal, except on a lane whose new state
  either side puts within 1e-3 of a health bound (torso height 0.8, pitch
  0.6, a speed just under the clip at 100, where rounding may flip the
  test); the test states are drawn so that such lanes are few, and the
  test counts them.
The contract of tests/test_envs.py:76 and tests/test_locomotion.py:26-57
is carried over to the port's batched envs.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rlpyt_tpu.envs import classic as jax_classic
from rlpyt_tpu.envs import locomotion as jax_loco
from rlpyt_tpu.envs.reacher import Reacher as JaxReacher
from rlpyt_tpu_torch.envs import classic, locomotion
from rlpyt_tpu_torch.envs.reacher import Reacher, ReacherResetDraws, \
    ReacherState

torch.set_num_threads(2)

STEP_CLOSE = dict(rtol=1e-5, atol=1e-5)
SIN_CLOSE = dict(rtol=1e-6, atol=1e-6)
LOCO = ("Hopper2D", "Cheetah2D")


def t(x):
    return torch.tensor(np.asarray(x))


# The uniform values each JAX reset draws from its lane key, as the port's
# reset draws.

def pendulum_draws(key):
    k1, k2 = jax.random.split(key)
    return (jax.random.uniform(k1, (), minval=-jnp.pi, maxval=jnp.pi),
            jax.random.uniform(k2, (), minval=-1.0, maxval=1.0))


def mountain_car_draws(key):
    return (jax.random.uniform(key, (), minval=-0.6, maxval=-0.4),)


def reacher_draws(key):
    kq, kr, ka = jax.random.split(key, 3)
    return (jax.random.uniform(kq, (2,), minval=-0.1, maxval=0.1),
            jax.random.uniform(kr, (), minval=0.0025, maxval=1.0),
            jax.random.uniform(ka, (), minval=-jnp.pi, maxval=jnp.pi))


def loco_draws(env):
    def draws(key):
        kq, kd = jax.random.split(key)
        return (jax.random.uniform(kq, (env.nq - 2,), minval=-5e-3,
                                   maxval=5e-3),
                jax.random.uniform(kd, (env.nq,), minval=-5e-3,
                                   maxval=5e-3))
    return draws


def make(name, max_steps=None):
    """(JAX env, port env, JAX draw function, port draws class)."""
    kw = {} if max_steps is None else {"max_steps": max_steps}
    if name == "Pendulum":
        return (jax_classic.Pendulum(**kw), classic.Pendulum(
            device="cpu", **kw), pendulum_draws, classic.PendulumResetDraws)
    if name == "ContinuousMountainCar":
        return (jax_classic.ContinuousMountainCar(**kw),
                classic.ContinuousMountainCar(device="cpu", **kw),
                mountain_car_draws, classic.MountainCarResetDraws)
    if name == "Reacher":
        return (JaxReacher(**kw), Reacher(device="cpu", **kw),
                reacher_draws, ReacherResetDraws)
    jenv = getattr(jax_loco, name)(**kw)
    return (jenv, getattr(locomotion, name)(device="cpu", **kw),
            loco_draws(jenv), locomotion.PlanarChainResetDraws)


def port_draws(draw_fn, Draws, key, n):
    vals = jax.vmap(draw_fn)(jax.random.split(key, n))
    return Draws(*(t(v) for v in vals))


def to_port_state(env, jstate):
    """The JAX state as the port's state type."""
    if isinstance(env, locomotion.PlanarChainEnv):
        return locomotion.PlanarChainState(*(t(x) for x in jstate))
    if isinstance(env, Reacher):
        return ReacherState(*(t(x) for x in jstate))
    Cls = {classic.Pendulum: classic.PendulumState,
           classic.ContinuousMountainCar: classic.MountainCarState}
    return Cls[type(env)](*(t(x) for x in jstate))


ALL = ("Pendulum", "ContinuousMountainCar", "Reacher") + LOCO


@pytest.mark.parametrize("name", ALL)
def test_reset_matches_jax(name):
    jenv, env, draw_fn, Draws = make(name)
    key, n = jax.random.key(4), 32
    jstate, jobs = jenv.reset_batch(key, n)
    state, obs = env.reset_batch(n, draws=port_draws(draw_fn, Draws, key,
                                                      n))
    for field, want, got in zip(state._fields, to_port_state(env, jstate),
                                state):
        if (name, field) == ("Reacher", "target"):
            # r cos(angle), r sin(angle)
            np.testing.assert_allclose(got.numpy(), want.numpy(),
                                       **SIN_CLOSE)
        else:
            np.testing.assert_array_equal(got.numpy(), want.numpy())
    if name in ("Pendulum", "Reacher"):
        np.testing.assert_allclose(obs.numpy(), np.asarray(jobs),
                                   **SIN_CLOSE)
    else:
        np.testing.assert_array_equal(obs.numpy(), np.asarray(jobs))
    assert obs.dtype == torch.float32 and state.t.dtype == torch.int32
    assert obs.shape == (n,) + env.observation_space.shape


@pytest.mark.parametrize("name", ("Pendulum", "ContinuousMountainCar",
                                  "Reacher"))
def test_step_matches_jax_within_rounding(name):
    """200 steps of 64 lanes under uniform actions 1.5 times the bounds
    (the envs clip), a time limit of 30, from the JAX state each step."""
    B = 64
    jenv, env, draw_fn, Draws = make(name, max_steps=30)
    step = jax.jit(jenv.step_batch)
    reset = jax.jit(jenv.reset_batch, static_argnums=1)
    key = jax.random.key(0)
    jstate, _ = reset(key, B)
    rng = np.random.default_rng(0)
    high = env.action_space.high
    n_timeout = 0
    for _ in range(200):
        action = (rng.uniform(-1.5, 1.5, (B,) + high.shape)
                  * high).astype(np.float32)
        key, k_step, k_reset = jax.random.split(key, 3)
        state = to_port_state(env, jstate)
        jnext, jst = step(k_step, jstate, jnp.asarray(action))
        nxt, st = env.step_batch(state, torch.tensor(action))
        np.testing.assert_allclose(st.observation.numpy(),
                                   np.asarray(jst.observation),
                                   **STEP_CLOSE)
        np.testing.assert_allclose(st.reward.numpy(),
                                   np.asarray(jst.reward), **STEP_CLOSE)
        for got, want in ((st.done, jst.done),
                          (st.info["timeout"], jst.info["timeout"]),
                          (nxt.t, jnext.t)):
            np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        assert st.reward.dtype == torch.float32
        n_timeout += int(st.info["timeout"].sum())
        jreset, _ = reset(k_reset, B)
        jstate = jax.tree.map(
            lambda r, s: jnp.where(
                jst.done.reshape(jst.done.shape + (1,) * (s.ndim - 1)),
                r, s), jreset, jnext)
    assert n_timeout > 0


def loco_states(jenv, B, seed):
    """States around the initial pose: the torso from 0.15 below to 0.05
    above its start (feet in and out of contact), angles +-0.3 off, speeds
    +-2, actions 1.2 times the bounds."""
    rng = np.random.default_rng(seed)
    q0, _ = jax.vmap(jenv._init_q)(jax.random.split(jax.random.key(seed),
                                                    B))
    q = np.asarray(q0).copy()
    q[:, 0] += rng.uniform(-1.0, 1.0, B)
    q[:, 1] += rng.uniform(-0.15, 0.05, B)
    q[:, 2:] += rng.uniform(-0.3, 0.3, (B, jenv.nq - 2))
    qd = rng.uniform(-2.0, 2.0, q.shape)
    a = rng.uniform(-1.2, 1.2, (B, jenv.na))
    return tuple(x.astype(np.float32) for x in (q, qd, a))


@pytest.mark.parametrize("name", LOCO)
def test_locomotion_accelerations_match_jax(name):
    jenv, env, _, _ = make(name)
    q, qd, a = loco_states(jenv, 256, 1)
    want = np.asarray(jax.jit(jax.vmap(jenv._qdd))(q, qd, a))
    got = env._qdd(t(q), t(qd), t(a)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-3,
                               atol=1e-5 * np.abs(want).max())
    # The contact springs were engaged in some lanes, free in others.
    depth = -np.asarray(jax.vmap(
        lambda qq: jax_loco._contact_points(jenv.spec, qq))(q))[..., 1]
    assert (depth > 0).any(axis=1).mean() > 0.2
    assert (depth <= 0).all(axis=1).mean() > 0.2


def near_health_bound(name, q, qd):
    """Lanes within 1e-3 of a health bound, where rounding may flip
    termination: a speed in (100 - 1e-3, 100) (one clipped to exactly 100
    ends the episode on either side), a torso height near 0.8 or a pitch
    near 0.6."""
    speed = np.abs(qd)
    near = ((speed > 100.0 - 1e-3) & (speed < 100.0)).any(-1)
    if name == "Hopper2D":
        near |= (np.abs(q[:, 1] - 0.8) < 1e-3) \
            | (np.abs(np.abs(q[:, 2]) - 0.6) < 1e-3)
    return near


@pytest.mark.parametrize("name", LOCO)
def test_locomotion_step_matches_jax(name):
    B = 256
    jenv, env, _, _ = make(name, max_steps=5)
    q, qd, a = loco_states(jenv, B, 2)
    t0 = np.random.default_rng(3).integers(0, 5, B).astype(np.int32)
    jstate = jenv.State(jnp.asarray(q), jnp.asarray(qd), jnp.asarray(t0))
    jnext, jst = jax.jit(jenv.step_batch)(jax.random.key(0), jstate,
                                          jnp.asarray(a))
    nxt, st = env.step_batch(locomotion.PlanarChainState(t(q), t(qd),
                                                         t(t0)), t(a))
    close = dict(rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(nxt.q.numpy(), np.asarray(jnext.q), **close)
    np.testing.assert_allclose(nxt.qd.numpy(), np.asarray(jnext.qd),
                               **close)
    np.testing.assert_allclose(st.observation.numpy(),
                               np.asarray(jst.observation), **close)
    np.testing.assert_allclose(st.reward.numpy(), np.asarray(jst.reward),
                               rtol=0, atol=1e-4)
    np.testing.assert_array_equal(nxt.t.numpy(), np.asarray(jnext.t))
    near = near_health_bound(name, np.asarray(jnext.q),
                             np.asarray(jnext.qd)) \
        | near_health_bound(name, nxt.q.numpy(), nxt.qd.numpy())
    assert near.sum() <= 2
    for got, want in ((st.done, jst.done),
                      (st.info["timeout"], jst.info["timeout"])):
        np.testing.assert_array_equal(got.numpy()[~near],
                                      np.asarray(want)[~near])
    done = st.done.numpy()
    assert 0 < done.sum() < B and st.info["timeout"].any()


@pytest.mark.parametrize("name", ALL)
def test_contract_and_determinism(name):
    """tests/test_envs.py:76 for the port: shapes, dtypes and the info
    schema of a reset and a step, and a 20-step rollout twice from one
    seed gives the same bits."""
    _, env, _, _ = make(name)
    B = 4

    def rollout(seed):
        g = torch.Generator().manual_seed(seed)
        state, obs = env.reset_batch(B, g)
        assert obs.shape == (B,) + env.observation_space.shape
        out = [obs]
        for _ in range(20):
            action = env.action_space.sample(g, (B,))
            state, step = env.step_batch(state, action)
            assert step.observation.shape == (B,) + \
                env.observation_space.shape
            assert step.reward.shape == (B,)
            assert step.reward.dtype == torch.float32
            assert step.done.dtype == torch.bool
            assert set(step.info) == {"timeout"}
            out.append(step.observation)
        return torch.stack(out)

    assert torch.equal(rollout(7), rollout(7))
    assert not torch.equal(rollout(7), rollout(8))


def random_rollout(env, B, n, seed):
    """n steps of uniform random torques from a seeded reset, without
    auto-reset; returns (rewards, dones, q) stacked over steps."""
    g = torch.Generator().manual_seed(seed)
    state, _ = env.reset_batch(B, g)
    rews, dones, qs = [], [], []
    for _ in range(n):
        state, step = env.step_batch(state, env.action_space.sample(g, (B,)))
        rews.append(step.reward)
        dones.append(step.done)
        qs.append(state.q)
    return torch.stack(rews), torch.stack(dones), torch.stack(qs)


@pytest.mark.parametrize("name", LOCO)
def test_physics_stable_and_finite(name):
    """tests/test_locomotion.py:26: random torques for 300 steps (4800
    substeps) keep the state finite and bounded."""
    _, env, _, _ = make(name)
    rews, _, qs = random_rollout(env, 4, 300, 1)
    assert torch.isfinite(qs).all() and float(qs.abs().max()) < 100.0
    assert torch.isfinite(rews).all()


def test_contact_holds_foot_above_ground():
    """tests/test_locomotion.py:41: while the hopper is healthy its heel
    and toe never sink more than 8 cm below the ground."""
    env = locomotion.Hopper2D(device="cpu")
    _, dones, qs = random_rollout(env, 8, 200, 2)
    alive = ~(torch.cumsum(dones.int(), 0).bool())
    foot_z = locomotion._contact_points(env.spec, qs)[..., :2, 1]
    assert float(torch.where(alive[..., None], foot_z, 0.0).min()) > -0.08


def test_contact_points_match_jax():
    jenv = jax_loco.Hopper2D()
    q, _, _ = loco_states(jenv, 16, 4)
    want = jax.vmap(lambda qq: jax_loco._contact_points(jenv.spec, qq))(q)
    np.testing.assert_allclose(
        locomotion._contact_points(jenv.spec, t(q)).numpy(),
        np.asarray(want), rtol=1e-6, atol=1e-6)
    jstarts, jdirs, jcoms = jax.vmap(
        lambda qq: jax_loco._link_frames(jenv.spec, qq))(q)
    for got, want in zip(locomotion._link_frames(jenv.spec, t(q)),
                         (jstarts, jdirs, jcoms)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=1e-6, atol=1e-6)


def test_lanes_deterministic():
    """tests/test_locomotion.py:50: 50 steps of 32 lanes twice from one
    seed give the same bits."""
    env = locomotion.Hopper2D(device="cpu")
    a = random_rollout(env, 32, 50, 3)[2][-1]
    b = random_rollout(env, 32, 50, 3)[2][-1]
    assert torch.equal(a, b)
