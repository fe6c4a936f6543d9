"""The port's host runners (rlpyt_tpu_torch/runners/host.py) and the
Atari script (experiments/scripts/atari_dqn.py) against the JAX package,
on the CPU, over serial farms of AtariEnv(FakeALE).

- One HostMinibatchRl batch after another, the port's and the JAX
  package's, from the same weights (through params.py) and env seeds,
  under greedy actions: observations, actions, rewards, dones, prev
  actions and rewards, timeouts, game scores and traj_done equal bit for
  bit; Q values (and R2D1's recurrent states) within rtol 1e-5, atol
  1e-5; the trajectory window (Return, Length, NonzeroRewards,
  DiscountedReturn, GameScore) equal.
- The recurrent carry is zeroed on done (a life loss too), not only on
  traj_done.
- Evaluation does not move the training stream (the twin of
  tests/test_host_env.py:128): parameters equal with and without it.
- AsyncHostRl's actor parameters lag the learner's by at most two
  batches (the twin of tests/test_host_async.py:103).
- build_and_train runs each of the dqn, ernbw and r2d1 configs for two
  learning iterations at small widths: finite losses, the update count.
"""
import csv
import functools

import jax
import numpy as np
import pytest
import torch

from rlpyt_tpu.agents.dqn import DqnAgent as JaxDqnAgent
from rlpyt_tpu.agents.dqn import R2d1Agent as JaxR2d1Agent
from rlpyt_tpu.algos.dqn import DQN as JaxDQN
from rlpyt_tpu.algos.r2d1 import R2D1 as JaxR2D1
from rlpyt_tpu.envs.atari import AtariEnv as JaxAtariEnv
from rlpyt_tpu.envs.fake_ale import FakeALE as JaxFakeALE
from rlpyt_tpu.envs.host import SerialVecEnv as JaxSerialVecEnv
from rlpyt_tpu.models.dqn import AtariDqnModel as JaxAtariDqnModel
from rlpyt_tpu.models.dqn import AtariR2d1Model as JaxAtariR2d1Model
from rlpyt_tpu.runners.host import HostMinibatchRl as JaxHostMinibatchRl
from rlpyt_tpu_torch.agents.dqn import DqnAgent, R2d1Agent
from rlpyt_tpu_torch.algos.dqn import DQN
from rlpyt_tpu_torch.algos.r2d1 import R2D1
from rlpyt_tpu_torch.envs.atari import make_atari_env
from rlpyt_tpu_torch.envs.host import SerialVecEnv
from rlpyt_tpu_torch.experiments.scripts.atari_dqn import (
    FAKE_ALE,
    build_and_train,
)
from rlpyt_tpu_torch.params import from_jax_params
from rlpyt_tpu_torch.runners.host import AsyncHostRl, HostMinibatchRl
from rlpyt_tpu_torch.struct import tree_leaves

torch.set_num_threads(2)

TINY = dict(channels=(8,), kernel_sizes=(8,), strides=(8,), paddings=(0,),
            fc_sizes=(32,))
CLOSE = dict(rtol=1e-5, atol=1e-5)
ENV = dict(max_start_noops=4, repeat_action_probability=0.25)
B, T = 4, 8


def port_fns(n=B, **kw):
    return [functools.partial(make_atari_env, ale_factory=FAKE_ALE, seed=b,
                              **dict(ENV, **kw)) for b in range(n)]


def jax_fns(n=B, **kw):
    return [functools.partial(JaxAtariEnv, ale_factory=JaxFakeALE, seed=b,
                              **dict(ENV, **kw)) for b in range(n)]


def twin_runners(recurrent: bool):
    """(port runner, JAX runner, JAX params) over serial farms of the same
    envs and seeds, greedy agents, the port's model loaded with the JAX
    model's initial weights.  Neither algorithm learns."""
    greedy = dict(eps_init=0.0, eps_final=0.0)
    if recurrent:
        model = dict(TINY, lstm_size=16)
        jagent = JaxR2d1Agent(ModelCls=JaxAtariR2d1Model, model_kwargs=model,
                              eps_final_min=None, **greedy)
        agent = R2d1Agent(model_kwargs=model, eps_final_min=None,
                          device="cpu", **greedy)
        algo_kw = dict(batch_T=8, warmup_T=4, batch_b=2,
                       min_steps_learn=10**6, replay_size=2048)
        jalgo, algo = JaxR2D1(**algo_kw), R2D1(**algo_kw)
    else:
        jagent = JaxDqnAgent(ModelCls=JaxAtariDqnModel, model_kwargs=TINY,
                             **greedy)
        agent = DqnAgent(model_kwargs=TINY, device="cpu", **greedy)
        algo_kw = dict(min_steps_learn=10**6, replay_size=2048,
                       frame_buffer=True)
        jalgo, algo = JaxDQN(**algo_kw), DQN(**algo_kw)
    jr = JaxHostMinibatchRl(algo=jalgo, agent=jagent,
                            vec_env=JaxSerialVecEnv(jax_fns(), seed=3),
                            batch_T=T, n_steps=10**4, seed=0)
    train_state, _ = jr.startup()
    params = jax.tree.map(np.asarray, train_state.params)
    r = HostMinibatchRl(algo=algo, agent=agent,
                        vec_env=SerialVecEnv(port_fns(), seed=3),
                        batch_T=T, n_steps=10**4, seed=0, device="cpu")
    r.startup()
    agent.model.load_state_dict({k: torch.tensor(v) for k, v in
                                 from_jax_params(params).items()})
    return r, jr, train_state.params


def assert_equal(port, ref, what):
    port = port.numpy()
    ref = np.asarray(ref)
    assert port.shape == ref.shape, what
    np.testing.assert_array_equal(port, ref.astype(port.dtype),
                                  err_msg=what)


@pytest.mark.parametrize("recurrent", [False, True],
                         ids=["dqn", "r2d1_carry"])
def test_host_batches_match_jax(recurrent):
    r, jr, jparams = twin_runners(recurrent)
    try:
        saw_life_loss = False
        for _ in range(4):
            s, rs = r._collect_batch()
            js, jrs = jr._collect_batch(jparams)
            for f in ("observation", "action", "reward", "done",
                      "prev_action", "prev_reward"):
                assert_equal(getattr(s, f), getattr(js, f), f)
            assert set(s.env_info) == set(js.env_info) == {
                "timeout", "game_score", "traj_done"}
            for k in s.env_info:
                assert_equal(s.env_info[k], js.env_info[k], k)
            np.testing.assert_allclose(s.agent_info["q"].numpy(),
                                       np.asarray(js.agent_info["q"]),
                                       **CLOSE)
            for f in ("observation", "prev_action", "prev_reward"):
                assert_equal(getattr(rs, f), getattr(jrs, f), f)
            assert rs.cum_steps == int(jrs.cum_steps)
            life_loss = s.done & ~s.env_info["traj_done"]
            saw_life_loss |= bool(life_loss.any())
            if recurrent:
                states = tree_leaves(s.agent_info["prev_rnn_state"])
                jstates = jax.tree_util.tree_leaves(
                    js.agent_info["prev_rnn_state"])
                assert len(states) == len(jstates) == 2
                for x, y in zip(states, jstates):
                    np.testing.assert_allclose(x.numpy(), np.asarray(y),
                                               **CLOSE)
                for x, y in zip(tree_leaves(rs.agent_carry),
                                jax.tree_util.tree_leaves(jrs.agent_carry)):
                    np.testing.assert_allclose(x.numpy(), np.asarray(y),
                                               **CLOSE)
                # Zeroed on every done (life losses included), so the
                # next step starts from zeros; live lanes carry state.
                h = states[0]
                after_done = s.done[:-1]
                assert (h[1:][after_done] == 0).all()
                assert (h[1:][~after_done].abs().sum(-1) > 0).all()
        assert saw_life_loss
        window, jwindow = r._traj.pop(), jr._traj.pop()
        assert len(window) == len(jwindow) >= 2
        for w, jw in zip(window, jwindow):
            assert [float(x) for x in w] == [float(x) for x in jw]
    finally:
        r.vec.close()
        jr.vec.close()


def small_dqn(eval_vec=None, n_steps=256):
    agent = DqnAgent(model_kwargs=TINY, eps_steps=1_000, device="cpu")
    algo = DQN(batch_size=16, min_steps_learn=64, replay_size=2_048,
               replay_ratio=1.0, learning_rate=1e-3, frame_buffer=True)
    return HostMinibatchRl, dict(
        algo=algo, agent=agent, vec_env=SerialVecEnv(port_fns(), seed=3),
        batch_T=T, n_steps=n_steps, seed=5, log_interval_steps=64,
        eval_vec_env=eval_vec, eval_max_steps=32, eval_max_trajectories=2,
        device="cpu")


def test_eval_does_not_perturb_training_stream():
    """A run with evaluation after every interval ends with the same
    parameters as the same run without it."""
    def run(with_eval):
        eval_vec = (SerialVecEnv(port_fns(2), seed=99) if with_eval
                    else None)
        cls, kwargs = small_dqn(eval_vec)
        runner = cls(**kwargs)
        try:
            runner.train()
        finally:
            runner.vec.close()
            if eval_vec is not None:
                eval_vec.close()
        assert runner._n_evals == (4 if with_eval else 0)
        return runner.agent.model.state_dict()

    p_no, p_yes = run(False), run(True)
    for k in p_no:
        assert torch.equal(p_no[k], p_yes[k]), k


def test_async_param_lag_is_bounded():
    """The actor's parameters used to collect batch k are the learner's
    after optimize j for some j in [k - 2, k]."""
    _, kwargs = small_dqn(n_steps=8 * B * T)
    runner = AsyncHostRl(**kwargs)
    collected_with, learner_params = [], []
    orig_collect = runner._collect_batch

    def probe(model):
        return next(model.parameters()).detach().clone()

    def spying_collect():
        collected_with.append(probe(runner._actor.model))
        return orig_collect()

    orig_startup, algo = runner.startup, runner.algo
    orig_optimize = algo.optimize

    def spying_startup():
        orig_startup()
        learner_params.append(probe(runner.agent.model))

    def spying_optimize(samples, rollout_state):
        info = orig_optimize(samples, rollout_state)
        learner_params.append(probe(runner.agent.model))
        return info

    runner._collect_batch = spying_collect
    runner.startup = spying_startup
    algo.optimize = spying_optimize
    try:
        runner.train()
    finally:
        runner.vec.close()
    assert len(collected_with) == 8 and algo.update_counter > 0
    assert all(0 <= lag <= 2 for lag in runner.actor_lags)
    for k, used in enumerate(collected_with):
        matches = [j for j, lp in enumerate(learner_params)
                   if torch.equal(lp, used)]
        assert any(max(0, k - 2) <= j <= k for j in matches), (
            f"batch {k} used params from {matches}, outside [{k-2},{k}]")


SMALL = dict(
    model=TINY,
    agent=dict(eps_steps=1_000),
    algo=dict(replay_size=4_096, batch_size=16, min_steps_learn=64),
    env=dict(fake=True), eval_env=dict(fake=True),
    runner=dict(n_steps=3 * B * T, log_interval_steps=B * T),
    sampler=dict(batch_T=T, batch_B=B, eval_n_envs=2, eval_max_steps=40,
                 eval_max_trajectories=2),
)
SMALL_R2D1 = dict(
    SMALL, model=dict(TINY, lstm_size=16), agent=dict(lstm_size=16),
    algo=dict(replay_size=4_096, batch_b=2, batch_T=8, warmup_T=4,
              min_steps_learn=3 * B * T),
    runner=dict(n_steps=4 * B * T, log_interval_steps=B * T))


@pytest.mark.parametrize("key", ["dqn", "ernbw", "r2d1"])
def test_build_and_train_small(tmp_path, key):
    """Two learning iterations of the config at small widths, serial
    farms on FakeALE: finite losses, the update count, the GameScore
    and Eval columns."""
    overrides = SMALL_R2D1 if key == "r2d1" else SMALL
    if key == "ernbw":
        overrides = dict(SMALL, model=dict(TINY, dueling=True))
    runner = build_and_train(key, log_dir=str(tmp_path), device="cpu",
                             serial=True, config_overrides=overrides)
    with open(tmp_path / "run_0" / "progress.csv") as f:
        rows = list(csv.DictReader(f))
    assert runner.algo.update_counter == 2 * runner.algo.updates_per_optimize
    assert len(rows) == runner.n_itr
    for row in rows[-2:]:
        for field in ("loss", "grad_norm", "td_abs_err"):
            assert np.isfinite(float(row[field])), (field, row)
        assert float(row["loss"]) > 0
    assert {"GameScoreAverage", "EvalGameScoreAverage",
            "EvalReturnAverage"} <= set(rows[0])
    assert runner.vec.envs[0].ale.__class__.__name__ == "FakeALE"
