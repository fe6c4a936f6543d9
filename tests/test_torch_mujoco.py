"""The port's MuJoCo configs and scripts (rlpyt_tpu_torch/experiments/
{configs,scripts}/mujoco_{pg,qpg}.py) on the CPU: the configs equal the
JAX dicts, the built models' parameters have the JAX shapes through
params.py, and small build_and_train runs are the twins of
tests/test_host_pg.py:24-64, tests/test_host_qpg.py:21 and
tests/test_alternating.py:144.  The host runners return their state:
the parameters they return are the agent's."""
import jax
import numpy as np
import pytest
import torch

from rlpyt_tpu_torch.params import agent_params_to_jax

torch.set_num_threads(2)


@pytest.fixture
def mujoco():
    pytest.importorskip("gymnasium")
    pytest.importorskip("mujoco")


@pytest.mark.parametrize("family", ["mujoco_pg", "mujoco_qpg"])
def test_configs_equal_jax(family):
    import importlib
    jax_cfg = importlib.import_module(
        f"rlpyt_tpu.experiments.configs.{family}").configs
    cfg = importlib.import_module(
        f"rlpyt_tpu_torch.experiments.configs.{family}").configs
    assert list(cfg) == list(jax_cfg)
    for key in jax_cfg:
        assert cfg[key] == jax_cfg[key], key
        for section in jax_cfg[key]:
            assert list(cfg[key][section]) == list(jax_cfg[key][section])


def _assert_state_is_agents(runner, result):
    """``train()``'s state holds the agent's parameters, finite, and the
    algorithm's state."""
    live = runner.agent.model.state_dict()
    assert sorted(result["model"]) == sorted(live)
    for k, v in live.items():
        assert torch.equal(result["model"][k], v), k
        assert torch.isfinite(v).all(), k
    assert result["algo"]["update_counter"] == runner.algo.update_counter


def _overrides(batch_T, batch_B, n_steps, **algo):
    return dict(runner=dict(n_steps=n_steps, log_interval_steps=n_steps),
                sampler=dict(batch_T=batch_T, batch_B=batch_B),
                algo=algo)


@pytest.mark.parametrize("key,jax_agent,port_agent", [
    ("ppo", "GaussianPgAgent", "GaussianPgAgent"),
    ("sac", "SacAgent", "SacAgent"),
    ("td3", "Td3Agent", "Td3Agent"),
    ("ddpg", "DdpgAgent", "DdpgAgent")])
def test_model_shapes_match_jax(mujoco, key, jax_agent, port_agent):
    """The config's models on HalfCheetah-v5's spaces: the port's weights
    through params.py have the JAX parameter tree, leaf for leaf."""
    import importlib
    pg = key == "ppo"
    family = "mujoco_pg" if pg else "mujoco_qpg"
    config = importlib.import_module(
        f"rlpyt_tpu_torch.experiments.configs.{family}").configs[key]
    jmod = importlib.import_module(
        f"rlpyt_tpu.agents.{'pg' if pg else 'qpg'}")
    tmod = importlib.import_module(
        f"rlpyt_tpu_torch.agents.{'pg' if pg else 'qpg'}")
    from rlpyt_tpu.envs.host import GymEnv as JaxGymEnv
    from rlpyt_tpu_torch.envs.host import GymEnv

    jenv, env = JaxGymEnv("HalfCheetah-v5"), GymEnv("HalfCheetah-v5")
    jagent = getattr(jmod, jax_agent)(model_kwargs=config["model"],
                                      **config["agent"])
    agent = getattr(tmod, port_agent)(model_kwargs=config["model"],
                                      device="cpu", **config["agent"])
    jagent.initialize(jenv.spaces)
    agent.initialize(env.spaces)
    jenv.close()
    env.close()
    params = jagent.init(jax.random.key(0), np.zeros((2, 17), np.float32))
    got = agent_params_to_jax(agent)
    assert jax.tree.structure(got) == jax.tree.structure(params)
    for g, w in zip(jax.tree.leaves(got), jax.tree.leaves(params)):
        assert np.shape(g) == np.shape(w)


def test_mujoco_env_available(mujoco):
    from rlpyt_tpu_torch.envs.host import GymEnv
    env = GymEnv("HalfCheetah-v5")
    obs = env.reset(seed=0)
    assert obs.shape == (17,)
    obs, rew, terminated, truncated = env.step(
        np.zeros(env.action_space.shape, np.float32))
    assert np.isfinite(rew)
    env.close()


def test_host_mujoco_ppo_runs(mujoco):
    from rlpyt_tpu_torch.experiments.scripts.mujoco_pg import \
        build_and_train
    runner, result = build_and_train(
        "ppo", serial=True, device="cpu",
        config_overrides=_overrides(64, 4, 1024, minibatches=4, epochs=2))
    assert runner._cum_steps >= 1024
    assert runner.algo.update_counter == 4 * 4 * 2
    _assert_state_is_agents(runner, result)


def test_host_mujoco_a2c_runs(mujoco):
    from rlpyt_tpu_torch.experiments.scripts.mujoco_pg import \
        build_and_train
    runner, result = build_and_train(
        "a2c", serial=True, device="cpu",
        config_overrides=_overrides(32, 4, 512))
    assert runner._cum_steps >= 512
    _assert_state_is_agents(runner, result)


def test_host_eval_collector_caps(mujoco):
    """Evaluation honours eval_max_steps and eval_max_trajectories."""
    from rlpyt_tpu_torch.experiments.scripts.mujoco_pg import \
        build_and_train
    runner, _ = build_and_train(
        "ppo", serial=True, device="cpu",
        config_overrides=dict(
            env=dict(id="InvertedPendulum-v5"),
            eval_env=dict(id="InvertedPendulum-v5"),
            runner=dict(n_steps=256, log_interval_steps=256),
            sampler=dict(batch_T=32, batch_B=4, eval_n_envs=2,
                         eval_max_steps=400, eval_max_trajectories=6),
            algo=dict(minibatches=2, epochs=1)))
    eps = runner._evaluate()
    assert len(eps) >= 1
    assert max(x[1] for x in eps) <= 200   # 400 steps over 2 envs
    assert all(x[0] > 0 for x in eps)   # +1 a step


def test_alternating_trains_e2e(mujoco):
    from rlpyt_tpu_torch.envs.host import PairedVecEnv
    from rlpyt_tpu_torch.experiments.scripts.mujoco_pg import \
        build_and_train
    runner, result = build_and_train(
        "ppo", serial=True, alternating=True, device="cpu",
        config_overrides=dict(
            env=dict(id="InvertedPendulum-v5"),
            eval_env=dict(id="InvertedPendulum-v5"),
            runner=dict(n_steps=1024, log_interval_steps=1024),
            sampler=dict(batch_T=32, batch_B=4),
            algo=dict(minibatches=2, epochs=2)))
    assert isinstance(runner.vec, PairedVecEnv)
    assert runner._cum_steps >= 1024
    _assert_state_is_agents(runner, result)


@pytest.mark.parametrize("key,runner_kind", [
    ("sac", "sync"), ("sac", "async"), ("td3", "sync"), ("ddpg", "sync")])
def test_host_mujoco_qpg_runs(mujoco, key, runner_kind):
    """The QPG configs at small widths (HalfCheetah, 4 lanes), through
    HostMinibatchRl or AsyncHostRl: the returned state is the agent's
    and holds the replay."""
    from rlpyt_tpu_torch.experiments.scripts.mujoco_qpg import \
        build_and_train
    from rlpyt_tpu_torch.runners.host import AsyncHostRl
    runner, result = build_and_train(
        key, serial=True, device="cpu", runner=runner_kind,
        config_overrides=dict(
            model=dict(hidden_sizes=(32, 32)),
            runner=dict(n_steps=512, log_interval_steps=256),
            sampler=dict(batch_T=32, batch_B=4, eval_n_envs=0),
            algo=dict(batch_size=64, min_steps_learn=256, replay_size=4096,
                      replay_ratio=8.0)))
    assert isinstance(runner, AsyncHostRl) == (runner_kind == "async")
    assert runner.algo.update_counter == 3 * 16   # from 256 steps on
    _assert_state_is_agents(runner, result)
    assert result["algo"]["replay"]["filled_t"] == 128
