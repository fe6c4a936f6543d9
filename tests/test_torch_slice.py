"""The port's flagship and "ernbw" slices as wholes, on the CPU, against
the JAX package: synthetic Atari env, collector, DQN / CategoricalDQN
optimize, MinibatchRl.

Full 104x80x4 frames with a narrow model (convs 8/8/8, fc 32), float32
and greedy actions (epsilon 0).  The two RNG streams differ, so the
port's env resets are fed the values JAX's reset keys draw, and replay
sample indices (for prioritized replay: the uniforms JAX's key draws) are
injected.  Observations, actions, rewards and dones must be equal; the
update's loss within rtol=1e-5, atol=1e-6; the written-back priorities
within rtol=1e-5, atol=1e-5 (a stored priority is the square root of a KL
that is the difference of two O(1) sums: an error of 1e-6 in a KL of
0.008 becomes 5e-6 in its root).
"""
import csv

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bench_atari import make_env as jax_make_env
from rlpyt_tpu.agents.dqn import CatDqnAgent as JaxCatDqnAgent
from rlpyt_tpu.agents.dqn import DqnAgent as JaxDqnAgent
from rlpyt_tpu.algos.cat_dqn import CategoricalDQN as JaxCategoricalDQN
from rlpyt_tpu.algos.dqn import DQN as JaxDQN
from rlpyt_tpu.models.dqn import AtariCatDqnModel as JaxAtariCatDqnModel
from rlpyt_tpu.models.dqn import AtariDqnModel as JaxAtariDqnModel
from rlpyt_tpu.samplers.rollout import BatchSpec as JaxBatchSpec
from rlpyt_tpu.samplers.rollout import Collector as JaxCollector
from rlpyt_tpu_torch.agents.dqn import CatDqnAgent, DqnAgent
from rlpyt_tpu_torch.algos.cat_dqn import CategoricalDQN
from rlpyt_tpu_torch.algos.dqn import DQN
from rlpyt_tpu_torch.envs.synthetic_atari import EP_LEN, State, \
    SyntheticAtariEnv
from rlpyt_tpu_torch.params import from_jax_params
from rlpyt_tpu_torch.runners.train import MinibatchRl
from rlpyt_tpu_torch.samplers.rollout import BatchSpec, Collector
from rlpyt_tpu_torch.utils.logging import TabularLogger

torch.set_num_threads(2)

NARROW = dict(channels=(8, 8, 8), fc_sizes=(32,))
T, B = 8, 3
ALGO_KW = dict(batch_size=T * B, min_steps_learn=T * B + 1,
               replay_size=T * B * 6, replay_ratio=1.0, n_step_return=3,
               double_dqn=True, frame_buffer=True, frames_per_obs=4)
# The "ernbw" configuration, narrow: categorical, dueling, prioritized.
ERNBW_AGENT = dict(model_kwargs=dict(NARROW, dueling=True), n_atoms=11,
                   v_min=-2.0, v_max=2.0)
ERNBW_ALGO = dict(prioritized_replay=True, pri_alpha=0.5, pri_beta=0.4)


def test_env_matches_jax():
    jenv, tenv = jax_make_env(), SyntheticAtariEnv("cpu")
    t = np.array([0, 1, 2, 3, EP_LEN - 1, EP_LEN, EP_LEN + 2, 7 * EP_LEN - 1,
                  999 * EP_LEN + 1998], np.int64)
    action = (t + 1 + np.arange(len(t)) % 2) % 6   # every other one rewarded
    jstate = jenv.reset_batch(jax.random.key(0), len(t))[0]
    jstate, jstep = jenv.step_batch(
        jax.random.key(1), jstate._replace(t=jnp.asarray(t, jnp.int32)),
        jnp.asarray(action, jnp.int32))
    tstate, tstep = tenv.step_batch(State(torch.tensor(t)),
                                    torch.tensor(action))
    np.testing.assert_array_equal(tstate.t.numpy(), np.asarray(jstate.t))
    np.testing.assert_array_equal(tstep.observation.numpy(),
                                  np.asarray(jstep.observation))
    np.testing.assert_array_equal(tstep.reward.numpy(),
                                  np.asarray(jstep.reward))
    np.testing.assert_array_equal(tstep.done.numpy(), np.asarray(jstep.done))
    assert tstep.done.any() and (tstep.reward > 0).any()


def jax_setup(ernbw):
    env = jax_make_env()
    if ernbw:
        agent = JaxCatDqnAgent(ModelCls=JaxAtariCatDqnModel, eps_init=0.0,
                               eps_final=0.0, **ERNBW_AGENT)
        algo = JaxCategoricalDQN(**ALGO_KW, **ERNBW_ALGO)
    else:
        agent = JaxDqnAgent(ModelCls=JaxAtariDqnModel, model_kwargs=NARROW,
                            eps_init=0.0, eps_final=0.0)
        algo = JaxDQN(**ALGO_KW)
    agent.initialize(env.spaces)
    collector = JaxCollector(env, agent, JaxBatchSpec(T, B),
                             discount=algo.discount)
    state = collector.init_state(jax.random.key(3))
    # Lanes start a few steps before their episode ends, so the batches
    # hold mid-batch resets.
    t_init = jnp.asarray([(b + 1) * EP_LEN - 3 - 4 * b for b in range(B)],
                         jnp.int32)
    env_state, first = env.step_batch(
        jax.random.key(4), state.env_state._replace(t=t_init - 1),
        jnp.zeros((B,), jnp.int32))
    state = state._replace(env_state=env_state,
                           observation=first.observation)
    train_state, replay_state = algo.initialize(
        agent, JaxBatchSpec(T, B), state.observation, jax.random.key(5))
    return env, algo, collector, state, train_state, replay_state


def jax_reset_draws(env, key, n_steps):
    """The t0 values JAX's collector draws at each step's reset."""
    draws = []
    for _ in range(n_steps):
        key, _, _, k_reset = jax.random.split(key, 4)
        draws.append(np.asarray(env.reset_batch(k_reset, B)[0].t))
    return draws


@pytest.mark.parametrize("ernbw", [False, True], ids=["dqn", "ernbw"])
def test_collect_and_optimize_match_jax(ernbw):
    env, jalgo, jcoll, jstate, train_state, replay_state = jax_setup(ernbw)
    draws = jax_reset_draws(env, jstate.key, 2 * T)
    collect = jax.jit(jcoll.collect)
    jbatches = []
    for _ in range(2):
        jstate, samples = collect(train_state.params, jstate)
        jbatches.append(samples)

    tenv = SyntheticAtariEnv("cpu")
    if ernbw:
        agent = CatDqnAgent(eps_init=0.0, eps_final=0.0, device="cpu",
                            **ERNBW_AGENT)
        algo = CategoricalDQN(**ALGO_KW, **ERNBW_ALGO)
    else:
        agent = DqnAgent(model_kwargs=NARROW, eps_init=0.0, eps_final=0.0,
                         device="cpu")
        algo = DQN(**ALGO_KW)
    agent.initialize(tenv.spaces)
    agent.model.load_state_dict({
        k: torch.tensor(v) for k, v in from_jax_params(
            jax.tree.map(np.asarray, train_state.params)).items()})
    coll = Collector(tenv, agent, BatchSpec(T, B), discount=0.99)
    t0 = torch.tensor([(b + 1) * EP_LEN - 3 - 4 * b for b in range(B)])
    gen = torch.Generator().manual_seed(0)
    state = coll.init_state(gen)._replace(env_state=State(t0),
                                          observation=tenv.stack_at(t0))
    queue = iter(draws)

    def reset_batch(n, generator):
        t0 = torch.tensor(next(queue), dtype=torch.int64)
        return State(t0), tenv.stack_at(t0)

    tenv.reset_batch = reset_batch
    algo.initialize(agent, BatchSpec(T, B), state.observation, gen)
    assert algo.updates_per_optimize == 1

    key = jax.random.key(6)
    if ernbw:
        # The uniforms that the JAX buffer's sample(state, key, n) draws.
        # Every stored priority is still 1, so the prefix sums are exact
        # and the draws cannot depend on the order of summation.
        u = torch.tensor(np.asarray(jax.random.uniform(key, (T * B,))))
        algo.replay.sample_idxs = \
            lambda n, g: algo.replay.idxs_from_uniforms(u)
        algo.z = torch.tensor(np.asarray(jalgo.z))
    else:
        t_idx, b_idx = jalgo.replay.sample_idxs(
            jalgo.replay.append(jalgo.replay.append(
                replay_state, jalgo.samples_to_buffer(jbatches[0])),
                jalgo.samples_to_buffer(jbatches[1])),
            key, T * B)
        algo.replay.sample_idxs = lambda n, g: (
            torch.tensor(np.array(t_idx)).long(),
            torch.tensor(np.array(b_idx)).long())

    infos = []
    for jb in jbatches:
        state, tb = coll.collect(state, gen)
        for name in ("observation", "action", "reward", "done",
                     "prev_action", "prev_reward"):
            np.testing.assert_array_equal(getattr(tb, name).numpy(),
                                          np.asarray(getattr(jb, name)),
                                          err_msg=name)
        infos.append(algo.optimize(tb, state))
        replay_state = jalgo.replay.append(replay_state,
                                           jalgo.samples_to_buffer(jb))
    assert sum(int(np.asarray(jb.done).sum()) for jb in jbatches) == B
    assert int(state.traj_stats.completed) == \
        int(jstate.traj_stats.completed) == B
    np.testing.assert_allclose(float(state.traj_stats.sum_return),
                               float(jstate.traj_stats.sum_return))

    # First optimize only appended (min_steps_learn); the second updated.
    assert float(infos[0].loss) == 0.0 and algo.update_counter == 1
    if ernbw:
        jbatch = jalgo.replay.sample(replay_state, key, T * B)
    else:
        jbatch = jalgo.replay.extract_batch(replay_state, t_idx, b_idx)
    jloss, jpri = jalgo.loss(train_state.params, train_state.target_params,
                             jbatch)
    np.testing.assert_allclose(float(infos[1].loss), float(jloss),
                               rtol=1e-5, atol=1e-6)
    if ernbw:
        # An entry that two neighbouring strata both drew is written
        # twice, in an order neither library fixes: compare the others.
        assert len(set(np.asarray(jbatch.is_weights).tolist())) == 1
        replay_state = jalgo.replay.update_priorities(
            replay_state, jbatch.indices, jpri)
        t_j, b_j = (np.asarray(x) for x in jbatch.indices)
        drawn = np.zeros((algo.replay.size_T, B), int)
        np.add.at(drawn, (t_j, b_j), 1)
        once = drawn <= 1
        assert (drawn == 1).sum() >= T * B // 2
        np.testing.assert_allclose(
            algo.replay.priorities.numpy()[once],
            np.asarray(replay_state.priorities)[once], rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(float(algo.replay.max_priority),
                                   float(replay_state.max_priority),
                                   rtol=1e-5)
        assert (algo.replay.priorities != 1.0).sum() >= (drawn > 0).sum()


def test_minibatch_rl_smoke(tmp_path):
    agent = DqnAgent(model_kwargs=NARROW, eps_steps=1000, device="cpu")
    algo = DQN(batch_size=16, min_steps_learn=0, replay_size=T * B * 4,
               replay_ratio=2.0, target_update_interval=2, double_dqn=True,
               frame_buffer=True)
    runner = MinibatchRl(algo, agent, SyntheticAtariEnv("cpu"),
                         BatchSpec(T, B), n_steps=2 * T * B, seed=0,
                         log_interval_steps=T * B, max_decorrelation_steps=0,
                         logger=TabularLogger(str(tmp_path)), device="cpu")
    runner.train()
    runner.logger.close()
    with open(tmp_path / "progress.csv") as f:
        rows = list(csv.DictReader(f))
    assert len(rows) == 2
    assert algo.update_counter == 2 * algo.updates_per_optimize == 6
    for key in ("Iteration", "CumSteps", "CumTime (s)", "StepsPerSecond",
                "UpdatesPerSecond", "ReplayRatio", "Trajs", "ReturnAverage",
                "ReturnStd", "ReturnMax", "ReturnMin", "LengthAverage",
                "NonzeroRewardsAverage", "DiscountedReturnAverage", "loss",
                "grad_norm", "td_abs_err"):
        assert key in rows[0], key
    for row in rows:
        for key in ("loss", "grad_norm", "td_abs_err"):
            assert np.isfinite(float(row[key])) and float(row[key]) > 0
    assert [int(r["CumSteps"]) for r in rows] == [T * B, 2 * T * B]


def test_minibatch_rl_ernbw_smoke(tmp_path):
    """A narrow ernbw trainer through the runner: finite losses, the
    priorities move, importance weights stay in (0, 1]."""
    agent = CatDqnAgent(eps_steps=1000, device="cpu", **ERNBW_AGENT)
    algo = CategoricalDQN(batch_size=16, min_steps_learn=0,
                          replay_size=T * B * 4, replay_ratio=2.0,
                          target_update_interval=2, double_dqn=True,
                          n_step_return=3, learning_rate=6.25e-5,
                          frame_buffer=True, **ERNBW_ALGO)
    runner = MinibatchRl(algo, agent, SyntheticAtariEnv("cpu"),
                         BatchSpec(T, B), n_steps=3 * T * B, seed=0,
                         log_interval_steps=T * B, max_decorrelation_steps=0,
                         logger=TabularLogger(str(tmp_path)), device="cpu")
    weights = []
    runner.startup()
    draw = algo.replay.sample

    def recording_sample(n, g):
        batch = draw(n, g)
        weights.append(batch.is_weights)
        return batch

    algo.replay.sample = recording_sample
    for _ in range(3):
        runner.run_interval()
    assert algo.update_counter == 3 * algo.updates_per_optimize == 9
    w = torch.cat(weights)
    assert w.shape == (9 * 16,) and (w > 0).all() and (w <= 1).all()
    assert any(x.max() == 1.0 and x.min() < 1.0 for x in weights)
    pri = algo.replay.priorities
    written = pri[:algo.replay.filled_t]
    assert torch.isfinite(pri).all() and (written > 0).all()
    assert (written != 1.0).sum() > 16 and float(algo.replay.max_priority) >= 1
    assert algo.n_atoms == 11 and algo.z.shape == (11,)
