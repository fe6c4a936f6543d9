"""Q-value policy-gradient learning tests of the port, on a card.

The twins of the four tests of tests/test_qpg_e2e.py (SAC, TD3, DDPG on
Pendulum; SAC on Reacher) and of tests/test_locomotion.py:
test_sac_learns_hopper_on_device, with the same settings, seeds and
thresholds.  They import nothing of JAX, so they run where only PyTorch
is installed:

    python -m pytest --noconftest -m slow -s tests/test_torch_qpg_learning.py
"""
import time

import pytest
import torch

from rlpyt_tpu_torch.agents.qpg import DdpgAgent, SacAgent, Td3Agent
from rlpyt_tpu_torch.algos.qpg import DDPG, SAC, TD3
from rlpyt_tpu_torch.envs.classic import Pendulum
from rlpyt_tpu_torch.envs.locomotion import Hopper2D
from rlpyt_tpu_torch.envs.reacher import Reacher
from rlpyt_tpu_torch.runners.train import MinibatchRl
from rlpyt_tpu_torch.samplers.rollout import BatchSpec, Collector

WIDE = dict(hidden_sizes=(128, 128))


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the runs are sized for the card")
    return torch.device("cuda")


def eval_return(env, agent, T, B, seed=99):
    """Greedy return per completed episode over a fresh [T, B] rollout
    (tests/test_qpg_e2e.py:eval_return)."""
    col = Collector(env, agent, BatchSpec(T, B))
    g = torch.Generator(device=env.device).manual_seed(seed)
    state, _ = col.collect(col.init_state(g), g, is_eval=True)
    ts = state.traj_stats
    return float(ts.sum_return) / max(int(ts.completed), 1), \
        int(ts.completed)


def report(name, avg, n, t0):
    print(f"{name}: greedy eval return {avg:.4f} over {n} episodes; "
          f"{time.time() - t0:.1f} s in all")


def run_pendulum(agent, algo, seed, n_steps=40_000):
    runner = MinibatchRl(algo=algo, agent=agent, env=Pendulum(),
                         batch_spec=BatchSpec(T=32, B=8), n_steps=n_steps,
                         seed=seed, log_interval_steps=20_000,
                         max_decorrelation_steps=50)
    runner.train()
    return eval_return(runner.env, agent, 220, 16)


@pytest.mark.slow
@pytest.mark.cuda
def test_sac_learns_pendulum(card):
    t0 = time.time()
    agent = SacAgent(model_kwargs=WIDE, q_model_kwargs=WIDE)
    algo = SAC(batch_size=128, replay_ratio=32.0, min_steps_learn=1_000,
               replay_size=100_000, learning_rate=1e-3)
    avg, n = run_pendulum(agent, algo, seed=0)
    report("pendulum sac", avg, n, t0)
    assert avg > -400, f"SAC failed on Pendulum: {avg}"


@pytest.mark.slow
@pytest.mark.cuda
def test_td3_learns_pendulum(card):
    t0 = time.time()
    agent = Td3Agent(model_kwargs=WIDE, q_model_kwargs=WIDE,
                     initial_std=0.2)
    algo = TD3(batch_size=128, replay_ratio=32.0, min_steps_learn=1_000,
               replay_size=100_000, learning_rate=1e-3,
               q_learning_rate=1e-3)
    avg, n = run_pendulum(agent, algo, seed=1)
    report("pendulum td3", avg, n, t0)
    assert avg > -500, f"TD3 failed on Pendulum: {avg}"


@pytest.mark.slow
@pytest.mark.cuda
def test_ddpg_learns_pendulum(card):
    t0 = time.time()
    agent = DdpgAgent(model_kwargs=WIDE, q_model_kwargs=WIDE,
                      initial_std=0.2)
    algo = DDPG(batch_size=128, replay_ratio=32.0, min_steps_learn=1_000,
                replay_size=100_000, learning_rate=1e-3,
                q_learning_rate=1e-3)
    avg, n = run_pendulum(agent, algo, seed=2)
    report("pendulum ddpg", avg, n, t0)
    assert avg > -600, f"DDPG failed on Pendulum: {avg}"


@pytest.mark.slow
@pytest.mark.cuda
def test_sac_learns_reacher(card):
    t0 = time.time()
    agent = SacAgent(model_kwargs=WIDE, q_model_kwargs=WIDE)
    algo = SAC(batch_size=128, replay_ratio=16.0, min_steps_learn=1_000,
               replay_size=100_000, learning_rate=1e-3)
    runner = MinibatchRl(algo=algo, agent=agent, env=Reacher(),
                         batch_spec=BatchSpec(T=32, B=8), n_steps=100_000,
                         seed=0, log_interval_steps=50_000,
                         max_decorrelation_steps=50)
    runner.train()
    avg, n = eval_return(runner.env, agent, 50, 32)
    report("reacher sac", avg, n, t0)
    assert avg > -7.5, f"SAC failed on Reacher: {avg}"


@pytest.mark.slow
@pytest.mark.cuda
def test_sac_learns_hopper_on_device(card):
    """Random-policy ReturnAverage is about 3.5 (about 3 steps an
    episode); the best of the last two intervals must exceed 35."""
    t0 = time.time()
    agent = SacAgent()
    algo = SAC(batch_size=256, min_steps_learn=2_000, replay_size=200_000,
               replay_ratio=64.0, learning_rate=3e-4,
               target_update_tau=0.005)
    runner = MinibatchRl(algo=algo, agent=agent, env=Hopper2D(),
                         batch_spec=BatchSpec(32, 32), n_steps=120_000,
                         log_interval_steps=20_000, seed=0)
    averages = []
    record = runner.logger.record_tabular

    def spy(key, value):
        if key == "ReturnAverage":
            averages.append(float(value))
        record(key, value)

    runner.logger.record_tabular = spy
    runner.train()
    print(f"hopper sac: ReturnAverage by interval {averages}; "
          f"{time.time() - t0:.1f} s in all")
    assert averages and max(averages[-2:]) > 35.0, f"returns {averages}"
