"""The MinAtar slice of the port against the JAX package, on the CPU: the
five games, flat replay, DQN's choice of buffer, start-state
decorrelation, the slice as a whole (decorrelate, collect, optimize) and
a MinibatchRl run.

The RNG streams differ, so the port's games are fed the raw values that
JAX's per-lane keys draw (``draws=``), replay indices and uniforms are
injected, and so are decorrelation's step counts and actions.  Games,
replay batches and collected samples must be equal bit for bit; the
update's loss within rtol=1e-5, atol=1e-6.
"""
import csv

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rlpyt_tpu.agents.dqn import DqnAgent as JaxDqnAgent
from rlpyt_tpu.algos.dqn import DQN as JaxDQN
from rlpyt_tpu.envs import minatar as jm
from rlpyt_tpu.models.dqn import AtariDqnModel as JaxAtariDqnModel
from rlpyt_tpu.replay.base import SamplesToBuffer as JaxSamplesToBuffer
from rlpyt_tpu.replay.prioritized import \
    PrioritizedReplayBuffer as JaxPrioritizedReplayBuffer
from rlpyt_tpu.replay.uniform import UniformReplayBuffer as \
    JaxUniformReplayBuffer
from rlpyt_tpu.samplers.rollout import BatchSpec as JaxBatchSpec
from rlpyt_tpu.samplers.rollout import Collector as JaxCollector
from rlpyt_tpu.struct import tree_select as jax_tree_select
from rlpyt_tpu_torch.agents.dqn import DqnAgent
from rlpyt_tpu_torch.algos.dqn import DQN
from rlpyt_tpu_torch.envs import minatar as tm
from rlpyt_tpu_torch.params import from_jax_params
from rlpyt_tpu_torch.replay.base import SamplesToBuffer
from rlpyt_tpu_torch.replay.frame import (
    PrioritizedFrameReplayBuffer,
    UniformFrameReplayBuffer,
)
from rlpyt_tpu_torch.replay.prioritized import PrioritizedReplayBuffer
from rlpyt_tpu_torch.replay.uniform import UniformReplayBuffer
from rlpyt_tpu_torch.runners.train import MinibatchRl
from rlpyt_tpu_torch.samplers.rollout import BatchSpec, Collector
from rlpyt_tpu_torch.struct import tree_select
from rlpyt_tpu_torch.utils.logging import TabularLogger

torch.set_num_threads(2)

GAMES = sorted(tm.MINATAR_ENVS)
MINATAR_MODEL = dict(channels=(16,), kernel_sizes=(3,), strides=(1,),
                     paddings=(0,), fc_sizes=(128,))


# ---------------------------------------------------------------------------
# The raw values that the JAX games draw from their per-lane keys
# ---------------------------------------------------------------------------

def _one_step_draws(name, k):
    """What ``step`` of game ``name`` draws from its key ``k``, in the
    order of the port's draw fields."""
    u, ri = jax.random.uniform, jax.random.randint
    if name in ("breakout", "space_invaders"):
        return (u(k),)
    if name == "asterix":
        ks, kslot, klr, kgold = jax.random.split(k, 4)
        return (u(ks), ri(kslot, (), 0, 1 << 30), ri(klr, (), 0, 2),
                u(kgold))
    if name == "freeway":
        ks, kc = jax.random.split(k)
        return (u(ks),) + _cars(kc)
    ks, kel, ket, ked, kdl, kdd = jax.random.split(k, 6)
    return (u(ks), ri(kel, (), 0, 1 << 30), u(ket), ri(ked, (), 0, 2),
            ri(kdl, (), 0, 1 << 30), ri(kdd, (), 0, 2))


def _cars(k):
    k1, k2 = jax.random.split(k, 2)
    return (jax.random.randint(k1, (8,), 1, 6),
            jax.random.randint(k2, (8,), 0, 2))


def _one_reset_draws(name, k):
    if name == "breakout":
        return (jax.random.randint(k, (), 0, 2),)
    if name == "freeway":
        return _cars(k)
    return ()


def _batch_draws(one, name, key, n):
    return jax.vmap(lambda k: one(name, k))(jax.random.split(key, n))


def jax_step_draws(name, key, n):
    """The port's draws for ``env.step_batch(key, ...)`` over n lanes."""
    return _batch_draws(_one_step_draws, name, key, n)


def jax_reset_draws(name, key, n):
    return _batch_draws(_one_reset_draws, name, key, n)


def to_draws(draw_fn, jdraws):
    """JAX draw arrays -> the NamedTuple that the port game's ``draw_fn``
    (its draw_step or draw_reset) returns; None for a deterministic
    reset."""
    example = draw_fn(1, torch.Generator())
    if example is None:
        return None
    return type(example)(*(torch.tensor(np.asarray(d)) for d in jdraws))


class DrawQueue:
    """Feeds a port game the JAX draws of each step and reset, in order,
    in place of its own: ``step_batch`` and ``reset_batch`` take them
    from ``draw_step`` / ``draw_reset``."""

    def __init__(self, tenv, name):
        self.name = name
        self.steps, self.resets = [], []
        self._step0, self._reset0 = tenv.draw_step, tenv.draw_reset
        tenv.draw_step = lambda n, g: self.steps.pop(0)
        tenv.draw_reset = lambda n, g: self.resets.pop(0)

    def push_step(self, key, n):
        self.steps.append(to_draws(self._step0, jax_step_draws(
            self.name, key, n)))

    def push_reset(self, key, n):
        self.resets.append(to_draws(self._reset0, jax_reset_draws(
            self.name, key, n)))


def assert_step_equal(tstep, jstep, what=""):
    np.testing.assert_array_equal(tstep.observation.numpy(),
                                  np.asarray(jstep.observation),
                                  err_msg=f"observation {what}")
    np.testing.assert_array_equal(tstep.reward.numpy(),
                                  np.asarray(jstep.reward),
                                  err_msg=f"reward {what}")
    np.testing.assert_array_equal(tstep.done.numpy(), np.asarray(jstep.done),
                                  err_msg=f"done {what}")
    np.testing.assert_array_equal(tstep.info["timeout"].numpy(),
                                  np.asarray(jstep.info["timeout"]),
                                  err_msg=f"timeout {what}")


# ---------------------------------------------------------------------------
# The games
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", GAMES)
def test_game_matches_jax(name):
    """300 steps of 16 lanes, random actions, sticky actions on, a time
    limit of 50 and auto-reset after every step, as the collector does."""
    B, n_steps, max_steps = 16, 300, 50
    jenv = jm.make_minatar(name, max_steps=max_steps)
    tenv = tm.make_minatar(name, max_steps=max_steps, device="cpu")
    assert tenv.sticky_action_prob == 0.1
    step_draws = jax.jit(lambda k: jax_step_draws(name, k, B))
    reset_draws = jax.jit(lambda k: jax_reset_draws(name, k, B))
    jstep = jax.jit(jenv.step_batch)
    jreset = jax.jit(jenv.reset_batch, static_argnums=1)

    key, k0 = jax.random.split(jax.random.key(7))
    jstate, jobs = jreset(k0, B)
    tstate, tobs = tenv.reset_batch(B, draws=to_draws(tenv.draw_reset,
                                                      reset_draws(k0)))
    np.testing.assert_array_equal(tobs.numpy(), np.asarray(jobs))
    rng = np.random.RandomState(0)
    totals = dict(reward=0.0, done=0, timeout=0)
    for i in range(n_steps):
        key, ks, kr = jax.random.split(key, 3)
        action = rng.randint(0, 6, B)
        jstate, js = jstep(ks, jstate, jnp.asarray(action, jnp.int32))
        tstate, ts = tenv.step_batch(
            tstate, torch.tensor(action),
            draws=to_draws(tenv.draw_step, step_draws(ks)))
        assert_step_equal(ts, js, f"at step {i}")
        jr_state, jr_obs = jreset(kr, B)
        tr_state, tr_obs = tenv.reset_batch(
            B, draws=to_draws(tenv.draw_reset, reset_draws(kr)))
        np.testing.assert_array_equal(tr_obs.numpy(), np.asarray(jr_obs))
        jstate = jax_tree_select(js.done, jr_state, jstate)
        tstate = tree_select(ts.done, tr_state, tstate)
        totals["reward"] += float(ts.reward.sum())
        totals["done"] += int(ts.done.sum())
        totals["timeout"] += int(ts.info["timeout"].sum())
    assert ts.observation.dtype == torch.uint8
    assert ts.observation.shape == (B,) + tenv.observation_space.shape
    # Time limits and episode ends both happened.
    assert totals["timeout"] > 0 and totals["done"] > totals["timeout"] \
        or name == "freeway"
    if name == "freeway":    # ends by the time limit alone
        assert totals["done"] == totals["timeout"] > 0
    else:
        assert totals["reward"] > 0


def test_make_minatar_names_every_game():
    assert set(tm.MINATAR_ENVS) == set(jm.MINATAR_ENVS)
    for name, cls in tm.MINATAR_ENVS.items():
        env = tm.make_minatar(name, device="cpu")
        assert isinstance(env, cls)
        assert env.observation_space.shape == \
            jm.make_minatar(name).observation_space.shape
        assert env.action_space.n == 6 and env.device.type == "cpu"
    assert tm.make_minatar("freeway", device="cpu").max_steps == 2500
    assert tm.make_minatar("breakout", device="cpu").max_steps == 5000
    with pytest.raises(ValueError):
        tm.make_minatar("pitfall", device="cpu")


def _breakout_pair(**fields):
    """The same Breakout state in both packages, from one lane's fields
    (the rest as after a reset with the ball on the left)."""
    jenv = jm.Breakout(sticky_action_prob=0.0)
    tenv = tm.Breakout(sticky_action_prob=0.0, device="cpu")
    jstate, _ = jenv.reset(jax.random.key(0))
    jstate = jstate._replace(**{k: jnp.asarray(v, jstate._asdict()[k].dtype)
                                for k, v in fields.items()})
    tstate = tm.BreakoutState(*(
        torch.tensor(np.asarray(x)[None]).to(
            torch.bool if np.asarray(x).dtype in (np.bool_, np.uint8)
            else torch.int32)
        for x in jstate))
    return jenv, tenv, jstate, tstate


@pytest.mark.parametrize("case", ["respawn", "corner_save", "flat_save",
                                  "death"])
def test_breakout_edge_cases_match_jax(case):
    """Injected states: the last brick broken and the bricks respawned
    when the ball reaches the bottom; the paddle saving the ball at its
    corner and from directly below; the ball missing the paddle."""
    one_brick = np.zeros((10, 10), np.uint8)
    one_brick[1, 5] = 1
    states = {
        # The ball breaks the last brick, then comes down to the paddle.
        "respawn": dict(ball_y=2, ball_x=4, ball_dir=3, pos=6,
                        brick_map=one_brick, last_y=3, last_x=3),
        # Moving down-right from (8, 4): lands at column 5 = the paddle.
        "corner_save": dict(ball_y=8, ball_x=4, ball_dir=2, pos=5,
                            brick_map=np.zeros((10, 10), np.uint8)),
        "flat_save": dict(ball_y=8, ball_x=4, ball_dir=2, pos=4),
        "death": dict(ball_y=8, ball_x=4, ball_dir=1, pos=7),
    }
    jenv, tenv, jstate, tstate = _breakout_pair(**states[case])
    draws = tm.StickyDraws(torch.ones(1))
    seen = dict(reward=0.0, done=False, bricks=[], ball_y=[])
    for i in range(12):
        jstate, js = jenv.step(jax.random.key(i), jstate, jnp.asarray(0))
        tstate, ts = tenv.step_batch(tstate, torch.zeros(1, dtype=torch.long),
                                     draws=draws)
        np.testing.assert_array_equal(ts.observation[0].numpy(),
                                      np.asarray(js.observation))
        assert float(ts.reward[0]) == float(js.reward)
        assert bool(ts.done[0]) == bool(js.done)
        seen["reward"] += float(ts.reward[0])
        seen["bricks"].append(int(ts.observation[0, 3].sum()))
        seen["ball_y"].append(int(tstate.ball_y[0]))
        if bool(ts.done[0]):
            seen["done"] = True
            break
    if case == "respawn":
        assert seen["reward"] == 1.0 and 0 in seen["bricks"] \
            and seen["bricks"][-1] == 30
    elif case == "death":
        assert seen["done"] and i == 0
    else:   # saved: the ball stays on row 8 and the episode goes on
        assert i > 0 and seen["ball_y"][0] == 8


# ---------------------------------------------------------------------------
# Flat replay and DQN's choice of buffer
# ---------------------------------------------------------------------------

def _flat_blocks(n_blocks, T, B, seed=0):
    """Random MinAtar-shaped [T, B] blocks (numpy), some dones and
    timeouts."""
    rng = np.random.RandomState(seed)
    return [dict(observation=rng.randint(0, 2, (T, B, 4, 10, 10)).astype(
                     np.uint8),
                 action=rng.randint(0, 6, (T, B)).astype(np.int32),
                 reward=rng.randn(T, B).astype(np.float32),
                 done=rng.rand(T, B) < 0.15,
                 timeout=rng.rand(T, B) < 0.05)
            for _ in range(n_blocks)]


def _append_both(tbuf, jbuf, blocks):
    jstate = jbuf.init(JaxSamplesToBuffer(
        observation=jnp.zeros((4, 10, 10), jnp.uint8),
        action=jnp.zeros((), jnp.int32), reward=jnp.zeros(()),
        done=jnp.zeros((), bool), timeout=jnp.zeros((), bool)))
    tbuf.init(SamplesToBuffer(
        observation=torch.zeros((4, 10, 10), dtype=torch.uint8),
        action=torch.zeros((), dtype=torch.int32), reward=torch.zeros(()),
        done=torch.zeros((), dtype=torch.bool),
        timeout=torch.zeros((), dtype=torch.bool)))
    for b in blocks:
        jstate = jbuf.append(jstate, JaxSamplesToBuffer(
            **{k: jnp.asarray(v) for k, v in b.items()}))
        tbuf.append(SamplesToBuffer(
            **{k: torch.tensor(v) for k, v in b.items()}))
    return jstate


def assert_batches_equal(tb, jb):
    for name in ("action", "return_", "done", "done_n", "timeout_n",
                 "is_weights"):
        np.testing.assert_array_equal(getattr(tb, name).numpy(),
                                      np.asarray(getattr(jb, name)),
                                      err_msg=name)
    for which in ("agent_inputs", "target_inputs"):
        for field in ("observation", "prev_action", "prev_reward"):
            np.testing.assert_array_equal(
                getattr(getattr(tb, which), field).numpy(),
                np.asarray(getattr(getattr(jb, which), field)),
                err_msg=f"{which}.{field}")


@pytest.mark.parametrize("prioritized", [False, True],
                         ids=["uniform", "prioritized"])
def test_flat_replay_matches_jax(prioritized):
    """Five blocks into a ring of four: the cursor has wrapped, and the
    sampled rows' n-step windows (n = 3) cross the ring's end."""
    T, B, n = 8, 3, 3
    kw = dict(size=4 * T * B, B=B, sample_T=T, discount=0.9,
              n_step_return=n)
    if prioritized:
        pkw = dict(alpha=0.6, beta=0.4)
        jbuf = JaxPrioritizedReplayBuffer(**kw, **pkw)
        tbuf = PrioritizedReplayBuffer(**kw, **pkw, device="cpu")
    else:
        jbuf = JaxUniformReplayBuffer(**kw)
        tbuf = UniformReplayBuffer(**kw, device="cpu")
    jstate = _append_both(tbuf, jbuf, _flat_blocks(5, T, B))
    assert tbuf.t == T and tbuf.filled_t == tbuf.size_T == 4 * T
    key = jax.random.key(3)
    if prioritized:
        jbatch = jbuf.sample(jstate, key, 64)
        u = torch.tensor(np.asarray(jax.random.uniform(key, (64,))))
        tbatch = tbuf.extract_batch(*tbuf.idxs_from_uniforms(u))
    else:
        t_idx, b_idx = jbuf.sample_idxs(jstate, key, 64)
        jbatch = jbuf.extract_batch(jstate, t_idx, b_idx)
        tbatch = tbuf.extract_batch(torch.tensor(np.asarray(t_idx)).long(),
                                    torch.tensor(np.asarray(b_idx)).long())
    t_np = tbatch.indices[0].numpy()
    assert ((t_np + n) % tbuf.size_T < t_np).any(), "no window wraps"
    np.testing.assert_array_equal(t_np, np.asarray(jbatch.indices[0]))
    assert tbatch.agent_inputs.observation.shape == (64, 4, 10, 10)
    assert_batches_equal(tbatch, jbatch)


def _algo_on(env, **kwargs):
    agent = DqnAgent(model_kwargs=MINATAR_MODEL, device="cpu")
    agent.initialize(env.spaces)
    algo = DQN(batch_size=8, replay_size=256, **kwargs)
    obs = env.reset_batch(4, torch.Generator().manual_seed(0))[1]
    algo.initialize(agent, BatchSpec(8, 4), obs,
                    torch.Generator().manual_seed(0))
    return algo


@pytest.mark.parametrize("frame_buffer", [False, True],
                         ids=["flat", "frame"])
@pytest.mark.parametrize("prioritized", [False, True],
                         ids=["uniform", "prioritized"])
def test_dqn_picks_the_references_buffer(frame_buffer, prioritized):
    want = {(False, False): UniformReplayBuffer,
            (False, True): PrioritizedReplayBuffer,
            (True, False): UniformFrameReplayBuffer,
            (True, True): PrioritizedFrameReplayBuffer}
    algo = _algo_on(tm.Breakout(device="cpu"), frame_buffer=frame_buffer,
                    prioritized_replay=prioritized)
    assert type(algo.replay) is want[frame_buffer, prioritized]
    assert hasattr(algo.replay, "priorities") == prioritized
    assert JaxDQN().frame_buffer is False and DQN().frame_buffer is False


def test_dqn_default_replays_minatar_planes_unchanged():
    """The default DQN stores MinAtar's four object planes whole and
    gives them back as they were collected (a frame buffer would keep
    only the last plane and rebuild the others from earlier steps)."""
    env = tm.Breakout(device="cpu")
    algo = _algo_on(env)
    agent = algo.agent
    coll = Collector(env, agent, BatchSpec(8, 4))
    g = torch.Generator().manual_seed(1)
    state = coll.init_state(g)
    state, samples = coll.collect(state, g)
    # cum_steps 0 is below min_steps_learn: append only
    algo.optimize(samples, state._replace(cum_steps=0))
    t_idx = torch.arange(1, 5).repeat_interleave(4)
    b_idx = torch.arange(4).repeat(4)
    batch = algo.replay.extract_batch(t_idx, b_idx)
    assert torch.equal(batch.agent_inputs.observation,
                       samples.observation[t_idx, b_idx])
    assert torch.equal(batch.target_inputs.observation,
                       samples.observation[t_idx + algo.n_step, b_idx])
    # The planes differ from one another, so a rebuilt stack would not.
    planes = samples.observation[t_idx, b_idx]
    assert not torch.equal(planes[:, 0], planes[:, 3])


# ---------------------------------------------------------------------------
# Decorrelation, the slice as a whole, the runner
# ---------------------------------------------------------------------------

def jax_breakout_setup(B, T, seed_key=3):
    env = jm.Breakout()
    agent = JaxDqnAgent(ModelCls=JaxAtariDqnModel, model_kwargs=MINATAR_MODEL,
                        eps_init=0.0, eps_final=0.0)
    agent.initialize(env.spaces)
    collector = JaxCollector(env, agent, JaxBatchSpec(T, B), discount=0.99)
    return env, agent, collector, collector.init_state(
        jax.random.key(seed_key))


def jax_decorrelate_draws(env, key, B, max_steps, queue):
    """Push the env draws of JAX's decorrelation loop onto ``queue``;
    return (the new key, n_steps, actions [max_steps, B])."""
    key, k_n = jax.random.split(key)
    n_steps = jax.random.randint(k_n, (B,), 0, max_steps)
    actions = []
    for _ in range(max_steps):
        key, k_act, k_env, k_reset = jax.random.split(key, 4)
        actions.append(np.asarray(jax.vmap(env.spaces.action.sample)(
            jax.random.split(k_act, B))))
        queue.push_step(k_env, B)
        queue.push_reset(k_reset, B)
    return key, np.asarray(n_steps), np.stack(actions)


def torch_collector(tenv, B, T):
    """A greedy MinAtar agent and its collector, on the CPU."""
    agent = DqnAgent(model_kwargs=MINATAR_MODEL, eps_init=0.0,
                     eps_final=0.0, device="cpu")
    agent.initialize(tenv.spaces)
    coll = Collector(tenv, agent, BatchSpec(T, B), discount=0.99)
    return agent, coll


def test_decorrelate_matches_jax():
    B, T, max_steps = 6, 4, 40
    env, _, jcoll, jstate = jax_breakout_setup(B, T)
    tenv = tm.Breakout(device="cpu")
    queue = DrawQueue(tenv, "breakout")
    k_env, _ = jax.random.split(jax.random.key(3))
    queue.push_reset(k_env, B)
    _, n_steps, actions = jax_decorrelate_draws(env, jstate.key, B,
                                                max_steps, queue)
    jout = jax.jit(jcoll.decorrelate, static_argnums=1)(jstate, max_steps)

    _, coll = torch_collector(tenv, B, T)
    state = coll.init_state(torch.Generator())
    np.testing.assert_array_equal(state.observation.numpy(),
                                  np.asarray(jstate.observation))
    out = coll.decorrelate(state, max_steps, torch.Generator(),
                           draws=(torch.tensor(n_steps),
                                  torch.tensor(actions).long()))
    assert not queue.steps and not queue.resets
    np.testing.assert_array_equal(out.observation.numpy(),
                                  np.asarray(jout.observation))
    np.testing.assert_array_equal(out.prev_action.numpy(),
                                  np.asarray(jout.prev_action))
    np.testing.assert_array_equal(out.prev_reward.numpy(),
                                  np.asarray(jout.prev_reward))
    for name in ("ball_y", "ball_x", "ball_dir", "pos", "t"):
        np.testing.assert_array_equal(
            getattr(out.env_state, name).numpy(),
            np.asarray(getattr(jout.env_state, name)), err_msg=name)
    # Lanes really took different numbers of steps, and some reset.
    assert len(set(out.env_state.t.tolist())) > 2
    assert (out.env_state.t.numpy() < n_steps).any()
    assert coll.decorrelate(state, 0, torch.Generator()) is state


def test_slice_matches_jax():
    """Breakout with the MinAtar model at full width, float32, greedy:
    decorrelate, collect T=8 x B=4, one DQN update with injected replay
    indices."""
    B, T, max_steps = 4, 8, 30
    algo_kw = dict(discount=0.99, batch_size=16, min_steps_learn=0,
                   replay_size=T * B * 4, replay_ratio=0.5,
                   target_update_interval=500, learning_rate=3e-4,
                   double_dqn=True, n_step_return=3)
    env, jagent, jcoll, jstate = jax_breakout_setup(B, T)
    jalgo = JaxDQN(**algo_kw)
    train_state, replay_state = jalgo.initialize(
        jagent, JaxBatchSpec(T, B), jstate.observation, jax.random.key(5))

    tenv = tm.Breakout(device="cpu")
    queue = DrawQueue(tenv, "breakout")
    queue.push_reset(jax.random.split(jax.random.key(3))[0], B)
    key, n_steps, actions = jax_decorrelate_draws(env, jstate.key, B,
                                                  max_steps, queue)
    for _ in range(T):
        key, _, k_env, k_reset = jax.random.split(key, 4)
        queue.push_step(k_env, B)
        queue.push_reset(k_reset, B)
    jstate = jax.jit(jcoll.decorrelate, static_argnums=1)(jstate, max_steps)
    jstate, jsamples = jax.jit(jcoll.collect)(train_state.params, jstate)
    replay_state = jalgo.replay.append(replay_state,
                                       jalgo.samples_to_buffer(jsamples))
    t_idx, b_idx = jalgo.replay.sample_idxs(replay_state,
                                            jax.random.key(6), 16)
    jbatch = jalgo.replay.extract_batch(replay_state, t_idx, b_idx)
    jloss, _ = jalgo.loss(train_state.params, train_state.target_params,
                          jbatch)

    agent, coll = torch_collector(tenv, B, T)
    agent.model.load_state_dict({
        k: torch.tensor(v) for k, v in from_jax_params(
            jax.tree.map(np.asarray, train_state.params)).items()})
    algo = DQN(**algo_kw)
    gen = torch.Generator().manual_seed(0)
    state = coll.init_state(gen)
    algo.initialize(agent, BatchSpec(T, B), state.observation, gen)
    assert algo.updates_per_optimize == 1
    assert type(algo.replay) is UniformReplayBuffer
    state = coll.decorrelate(state, max_steps, gen,
                             draws=(torch.tensor(n_steps),
                                    torch.tensor(actions).long()))
    state, samples = coll.collect(state, gen)
    assert not queue.steps and not queue.resets
    for name in ("observation", "action", "reward", "done", "prev_action",
                 "prev_reward"):
        np.testing.assert_array_equal(getattr(samples, name).numpy(),
                                      np.asarray(getattr(jsamples, name)),
                                      err_msg=name)
    np.testing.assert_array_equal(samples.env_info["timeout"].numpy(),
                                  np.asarray(jsamples.env_info["timeout"]))
    assert samples.done.any() and (samples.reward != 0).any()
    np.testing.assert_array_equal(
        samples.agent_info["q"].argmax(-1).numpy(),
        np.asarray(jsamples.action))
    algo.replay.sample_idxs = lambda n, g: (
        torch.tensor(np.asarray(t_idx)).long(),
        torch.tensor(np.asarray(b_idx)).long())
    info = algo.optimize(samples, state)
    assert algo.update_counter == 1
    np.testing.assert_allclose(float(info.loss), float(jloss), rtol=1e-5,
                               atol=1e-6)


def test_minibatch_rl_minatar_smoke(tmp_path):
    """A narrow MinAtar-Breakout DQN through the runner, decorrelation
    on: finite losses, replay ratio 1, flat replay."""
    T, B = 8, 4
    agent = DqnAgent(model_kwargs=dict(MINATAR_MODEL, channels=(4,),
                                       fc_sizes=(16,)),
                     eps_steps=1000, device="cpu")
    algo = DQN(batch_size=16, min_steps_learn=0, replay_size=T * B * 4,
               replay_ratio=1.0, target_update_interval=2, double_dqn=True,
               n_step_return=3)
    runner = MinibatchRl(algo, agent, tm.Breakout(device="cpu"),
                         BatchSpec(T, B), n_steps=3 * T * B, seed=0,
                         log_interval_steps=T * B,
                         max_decorrelation_steps=20,
                         logger=TabularLogger(str(tmp_path)), device="cpu")
    assert runner.max_decorrelation_steps == 20
    runner.train()
    runner.logger.close()
    with open(tmp_path / "progress.csv") as f:
        rows = list(csv.DictReader(f))
    assert len(rows) == 3 and type(algo.replay) is UniformReplayBuffer
    assert algo.update_counter == 3 * algo.updates_per_optimize == 6
    for row in rows:
        assert float(row["ReplayRatio"]) == 1.0
        for key in ("loss", "grad_norm", "td_abs_err"):
            assert np.isfinite(float(row[key])) and float(row[key]) > 0
    # The reference's default.
    assert MinibatchRl(algo, agent, tm.Breakout(device="cpu"),
                       BatchSpec(T, B), 1).max_decorrelation_steps == 100
