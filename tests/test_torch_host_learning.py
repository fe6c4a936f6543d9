"""The port's host-env path learns, on the CPU, with gymnasium envs.

The twins of tests/test_host_env.py:test_host_dqn_learns_cartpole,
tests/test_host_async.py:test_async_overlap_speedup and
:test_async_host_learns_cartpole, tests/test_host_qpg.py:
test_host_sac_learns_pendulum and tests/test_dict_obs.py:
test_host_dict_obs_trains, with the same settings, seeds, sleeps and
thresholds.  They run on the CPU (``device="cpu"``) because gymnasium is
installed where the JAX tests run, not on the card's machine; they import
nothing of JAX:

    python -m pytest --noconftest -m slow -s tests/test_torch_host_learning.py
"""
import time

import numpy as np
import pytest
import torch

from rlpyt_tpu_torch.agents.dqn import DqnAgent
from rlpyt_tpu_torch.agents.qpg import SacAgent
from rlpyt_tpu_torch.algos.dqn import DQN
from rlpyt_tpu_torch.algos.qpg import SAC
from rlpyt_tpu_torch.envs.host import GymEnv, SerialVecEnv
from rlpyt_tpu_torch.models.dqn import DqnMlpModel
from rlpyt_tpu_torch.runners.host import AsyncHostRl, HostMinibatchRl

CPU = "cpu"


@pytest.fixture(autouse=True)
def gymnasium():
    """The host envs are gymnasium's; skip where it is not installed."""
    return pytest.importorskip("gymnasium")


def cartpole_fns(n):
    return [lambda: GymEnv("CartPole-v1") for _ in range(n)]


def make_dict_cartpole():
    """CartPole with a Dict observation (tests/test_dict_obs.py:59)."""
    import gymnasium as gym
    from gymnasium import spaces as gs

    class DictObsWrapper(gym.ObservationWrapper):
        def __init__(self, env):
            super().__init__(env)
            lo, hi = env.observation_space.low, env.observation_space.high
            self.observation_space = gs.Dict({
                "position": gs.Box(lo[[0, 2]], hi[[0, 2]],
                                   dtype=np.float32),
                "velocity": gs.Box(lo[[1, 3]], hi[[1, 3]],
                                   dtype=np.float32),
            })

        def observation(self, obs):
            return {"position": obs[[0, 2]].astype(np.float32),
                    "velocity": obs[[1, 3]].astype(np.float32)}

    return DictObsWrapper(gym.make("CartPole-v1"))


def record_of(runner, key):
    """The values the runner logs under ``key``, in order."""
    values = []
    record = runner.logger.record_tabular

    def spy(k, value):
        if k == key:
            values.append(float(value))
        record(k, value)

    runner.logger.record_tabular = spy
    return values


class SleepyVecEnv(SerialVecEnv):
    """CartPole farm with a fixed latency a step, standing in for a slow
    simulator."""

    def __init__(self, *args, sleep_s=0.0, **kwargs):
        super().__init__(*args, **kwargs)
        self._sleep_s = sleep_s

    def step(self, actions):
        time.sleep(self._sleep_s)
        return super().step(actions)


@pytest.mark.slow
def test_host_dqn_learns_cartpole():
    """A greedy probe of the trained DQN on fresh envs returns above 100
    (random play about 22)."""
    t0 = time.time()
    torch.set_num_threads(4)
    vec = SerialVecEnv(cartpole_fns(8), seed=3)
    agent = DqnAgent(ModelCls=DqnMlpModel,
                     model_kwargs=dict(hidden_sizes=(128, 128)),
                     eps_steps=20_000, eps_final=0.02, device=CPU)
    algo = DQN(batch_size=128, min_steps_learn=1_000, replay_size=50_000,
               replay_ratio=4.0, target_update_interval=300,
               learning_rate=1e-3, double_dqn=True)
    runner = HostMinibatchRl(algo=algo, agent=agent, vec_env=vec,
                             batch_T=32, n_steps=50_000, seed=3,
                             log_interval_steps=25_000, device=CPU)
    runner.train()
    vec.close()
    vec2 = SerialVecEnv(cartpole_fns(8), seed=103)
    obs = vec2.reset()
    rets = np.zeros(8)
    done_any = np.zeros(8, bool)
    prev_a = torch.zeros(8, dtype=torch.int64)
    prev_r = torch.zeros(8)
    with torch.no_grad():
        for _ in range(300):
            q = agent.q(torch.as_tensor(np.array(obs)), prev_a, prev_r)
            a = torch.argmax(q, dim=-1).numpy()
            obs, rew, done, _ = vec2.step(a)
            rets += rew * (~done_any)
            done_any |= done
            if done_any.all():
                break
    vec2.close()
    print(f"host DQN greedy probe {rets.mean():.4f}; "
          f"{time.time() - t0:.1f} s")
    assert rets.mean() > 100, f"host DQN failed: {rets.mean()}"


def make_async_dqn():
    agent = DqnAgent(ModelCls=DqnMlpModel,
                     model_kwargs={"hidden_sizes": (32,)}, eps_steps=2_000,
                     device=CPU)
    algo = DQN(batch_size=32, min_steps_learn=64, replay_size=10_000,
               replay_ratio=1.0, learning_rate=1e-3)
    return agent, algo


def slow_down_optimize(algo, seconds):
    """Charge ``seconds`` of wall time to every optimize (a heavy
    learner)."""
    real = algo.optimize

    def slow(*args, **kwargs):
        out = real(*args, **kwargs)
        time.sleep(seconds)
        return out

    algo.optimize = slow


@pytest.mark.slow
def test_async_overlap_speedup():
    """Env stepping for batch k+1 overlaps the learner's optimize of
    batch k: with env time about equal to optimize time, AsyncHostRl
    beats the serial collect-then-optimize loop by 1.3x or more in the
    last log interval's StepsPerSecond."""
    torch.set_num_threads(2)
    B, T = 4, 8
    n_steps = 24 * B * T          # 24 iterations: 3 log intervals of 8
    env_sleep = 0.02              # a vec step: ~160 ms a batch
    opt_sleep = 0.16              # a comparable learner time
    sps = {}
    for name, cls in (("serial", HostMinibatchRl), ("async", AsyncHostRl)):
        vec = SleepyVecEnv(cartpole_fns(B), seed=0, sleep_s=env_sleep)
        agent, algo = make_async_dqn()
        slow_down_optimize(algo, opt_sleep)
        runner = cls(algo=algo, agent=agent, vec_env=vec, batch_T=T,
                     n_steps=n_steps, seed=0, log_interval_steps=8 * B * T,
                     device=CPU)
        rates = record_of(runner, "StepsPerSecond")
        runner.train()
        sps[name] = rates[-1]
        vec.close()
    speedup = sps["async"] / sps["serial"]
    print(f"async overlap speedup {speedup:.4f}x, sps={sps}")
    assert speedup >= 1.3, f"overlap speedup {speedup:.2f}x, sps={sps}"


@pytest.mark.slow
def test_async_host_learns_cartpole():
    """AsyncHostRl's last logged ReturnAverage is above 120."""
    t0 = time.time()
    torch.set_num_threads(4)
    vec = SerialVecEnv(cartpole_fns(8), seed=3)
    agent = DqnAgent(ModelCls=DqnMlpModel,
                     model_kwargs={"hidden_sizes": (64, 64)},
                     eps_steps=10_000, eps_final=0.02, device=CPU)
    algo = DQN(batch_size=64, min_steps_learn=500, replay_size=50_000,
               replay_ratio=8.0, learning_rate=5e-4,
               target_update_interval=300)
    runner = AsyncHostRl(algo=algo, agent=agent, vec_env=vec, batch_T=16,
                         n_steps=40_000, seed=3, log_interval_steps=10_000,
                         device=CPU)
    averages = record_of(runner, "ReturnAverage")
    runner.train()
    vec.close()
    print(f"async host DQN ReturnAverage {averages}; "
          f"{time.time() - t0:.1f} s")
    assert averages and averages[-1] > 120.0, f"returns {averages}"


@pytest.mark.slow
def test_host_sac_learns_pendulum():
    """The mean action of the trained SAC policy returns above -400 on
    fresh Pendulum envs over 200 steps (random play about -1200)."""
    t0 = time.time()
    torch.set_num_threads(4)
    vec = SerialVecEnv(["Pendulum-v1"] * 8, seed=4)
    agent = SacAgent(device=CPU)
    algo = SAC(batch_size=128, min_steps_learn=1_000, replay_size=100_000,
               replay_ratio=32.0, learning_rate=3e-4,
               target_update_tau=0.005)
    runner = HostMinibatchRl(algo=algo, agent=agent, vec_env=vec,
                             batch_T=32, n_steps=40_000, seed=4,
                             log_interval_steps=20_000, device=CPU)
    runner.train()
    vec.close()
    vec2 = SerialVecEnv(["Pendulum-v1"] * 4, seed=104)
    obs = vec2.reset()
    rets = np.zeros(4)
    g = torch.Generator().manual_seed(0)
    with torch.no_grad():
        for i in range(200):
            step, _ = agent.step(torch.as_tensor(np.array(obs)), None, None,
                                 None, 0, g, is_eval=True)
            obs, rew, done, _ = vec2.step(step.action.numpy())
            rets += rew
    vec2.close()
    print(f"host SAC mean-action return {rets.mean():.4f}; "
          f"{time.time() - t0:.1f} s")
    assert rets.mean() > -400, f"host SAC failed on Pendulum: {rets.mean()}"


@pytest.mark.slow
def test_host_dict_obs_trains():
    """HostMinibatchRl runs DQN end to end on a gymnasium Dict
    observation; the last ReturnAverage is finite."""
    torch.set_num_threads(4)
    vec = SerialVecEnv([make_dict_cartpole for _ in range(8)], seed=2)
    agent = DqnAgent(ModelCls=DqnMlpModel,
                     model_kwargs={"hidden_sizes": (64, 64)},
                     eps_steps=8_000, eps_final=0.05, device=CPU)
    algo = DQN(batch_size=64, min_steps_learn=500, replay_size=20_000,
               replay_ratio=4.0, learning_rate=1e-3)
    runner = HostMinibatchRl(algo=algo, agent=agent, vec_env=vec,
                             batch_T=16, n_steps=10_000, seed=2,
                             log_interval_steps=5_000, device=CPU)
    averages = record_of(runner, "ReturnAverage")
    runner.train()
    vec.close()
    print(f"host dict-obs DQN ReturnAverage {averages}")
    assert averages and np.isfinite(averages[-1])
