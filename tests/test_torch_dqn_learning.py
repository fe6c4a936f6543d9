"""DQN-family learning tests of the port, on a card.

The twins of tests/test_dqn_e2e.py:test_dqn_learns_cartpole,
tests/test_catdqn_r2d1.py:test_c51_learns_cartpole and
:test_r2d1_learns_cartpole, and tests/test_dict_obs.py:
test_dict_obs_dqn_learns, with the same settings, seeds and thresholds.
They import nothing of JAX, so they run where only PyTorch is installed:

    python -m pytest --noconftest -m slow -s tests/test_torch_dqn_learning.py
"""
import time

import pytest
import torch
import torch.nn.functional as F
from torch import nn

from rlpyt_tpu_torch.agents.dqn import CatDqnAgent, DqnAgent, R2d1Agent
from rlpyt_tpu_torch.algos.cat_dqn import CategoricalDQN
from rlpyt_tpu_torch.algos.dqn import DQN
from rlpyt_tpu_torch.algos.r2d1 import R2D1
from rlpyt_tpu_torch.envs.classic import CartPole, DictObsCartPole
from rlpyt_tpu_torch.models.dqn import DqnMlpModel, R2d1MlpModel
from rlpyt_tpu_torch.models.mlp import MlpModel
from rlpyt_tpu_torch.runners.train import MinibatchRl
from rlpyt_tpu_torch.samplers.rollout import BatchSpec, Collector
from rlpyt_tpu_torch.struct import infer_leading_dims, restore_leading_dims


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the runs are sized for the card")
    return torch.device("cuda")


class CartPoleCatModel(nn.Module):
    """MLP distributional Q for vector observations (the JAX test's own
    model, tests/test_catdqn_r2d1.py:18)."""

    def __init__(self, input_size, n_actions, n_atoms=51,
                 hidden_sizes=(128, 128)):
        super().__init__()
        self.n_actions, self.n_atoms = n_actions, n_atoms
        self.mlp = MlpModel(input_size, hidden_sizes, n_actions * n_atoms)

    def forward(self, observation, prev_action=None, prev_reward=None):
        lead_dim, T, B, obs_shape = infer_leading_dims(observation, 1)
        x = self.mlp(observation.reshape((T * B,) + obs_shape).float())
        p = F.softmax(x.reshape(T * B, self.n_actions, self.n_atoms), -1)
        return restore_leading_dims(p, lead_dim, T, B)


def eval_return(runner, T=600, B=8):
    """Greedy return per completed episode over a fresh [T, B] rollout
    (tests/test_catdqn_r2d1.py:eval_return)."""
    col = Collector(runner.env, runner.agent, BatchSpec(T, B))
    g = torch.Generator(device=runner.env.device).manual_seed(99)
    state, _ = col.collect(col.init_state(g), g, is_eval=True)
    ts = state.traj_stats
    return float(ts.sum_return) / max(int(ts.completed), 1), \
        int(ts.completed)


def report(name, avg, n, t0):
    print(f"{name}: greedy eval return {avg:.4f} over {n} episodes; "
          f"{time.time() - t0:.1f} s in all")


@pytest.mark.slow
@pytest.mark.cuda
def test_dqn_learns_cartpole(card):
    t0 = time.time()
    agent = DqnAgent(ModelCls=DqnMlpModel,
                     model_kwargs=dict(hidden_sizes=(256, 256)),
                     eps_steps=50_000, eps_final=0.02)
    algo = DQN(discount=0.99, batch_size=128, min_steps_learn=1_000,
               replay_size=50_000, replay_ratio=8.0,
               target_update_interval=300, learning_rate=1e-3,
               double_dqn=True, prioritized_replay=False)
    runner = MinibatchRl(algo=algo, agent=agent, env=CartPole(),
                         batch_spec=BatchSpec(T=32, B=16), n_steps=80_000,
                         seed=0, log_interval_steps=20_000)
    runner.train()
    avg, n = eval_return(runner)
    report("cartpole dqn", avg, n, t0)
    assert avg > 120, f"DQN failed to learn CartPole: avg return {avg}"


@pytest.mark.slow
@pytest.mark.cuda
def test_c51_learns_cartpole(card):
    t0 = time.time()
    agent = CatDqnAgent(ModelCls=CartPoleCatModel, n_atoms=51,
                        v_min=0.0, v_max=110.0, eps_steps=40_000,
                        eps_final=0.02)
    algo = CategoricalDQN(
        discount=0.99, batch_size=128, min_steps_learn=1_000,
        replay_size=50_000, replay_ratio=8.0, target_update_interval=300,
        learning_rate=5e-4, double_dqn=True, prioritized_replay=True)
    runner = MinibatchRl(algo=algo, agent=agent, env=CartPole(),
                         batch_spec=BatchSpec(T=32, B=16), n_steps=80_000,
                         seed=5, log_interval_steps=40_000)
    runner.train()
    avg, n = eval_return(runner)
    report("cartpole c51", avg, n, t0)
    assert avg > 100, f"C51 failed on CartPole: {avg}"


@pytest.mark.slow
@pytest.mark.cuda
def test_r2d1_learns_cartpole(card):
    t0 = time.time()
    agent = R2d1Agent(ModelCls=R2d1MlpModel, lstm_size=64,
                      model_kwargs=dict(hidden_sizes=(64,)),
                      eps_steps=30_000, eps_final=0.02, eps_final_min=None)
    algo = R2D1(
        discount=0.99, batch_b=32, batch_T=16, warmup_T=8,
        min_steps_learn=1_000, replay_size=50_000, replay_ratio=4.0,
        target_update_interval=150, n_step_return=3, learning_rate=1e-3,
        double_dqn=True, prioritized_replay=True)
    runner = MinibatchRl(algo=algo, agent=agent, env=CartPole(),
                         batch_spec=BatchSpec(T=32, B=16), n_steps=100_000,
                         seed=6, log_interval_steps=50_000)
    runner.train()
    avg, n = eval_return(runner)
    report("cartpole r2d1", avg, n, t0)
    assert avg > 100, f"R2D1 failed on CartPole: {avg}"


@pytest.mark.slow
@pytest.mark.cuda
def test_dict_obs_dqn_learns(card):
    """DQN learns CartPole through a Composite observation: the dict
    flows through collection, the flat replay ring and the model's
    sorted leaf concatenation; the last interval's ReturnAverage must
    exceed 120."""
    t0 = time.time()
    agent = DqnAgent(ModelCls=DqnMlpModel,
                     model_kwargs={"hidden_sizes": (256, 256)},
                     eps_steps=50_000, eps_final=0.02)
    algo = DQN(batch_size=128, min_steps_learn=1_000, replay_size=50_000,
               replay_ratio=8.0, target_update_interval=300,
               learning_rate=1e-3)
    runner = MinibatchRl(algo=algo, agent=agent, env=DictObsCartPole(),
                         batch_spec=BatchSpec(32, 16), n_steps=80_000,
                         log_interval_steps=20_000)
    averages = []
    record = runner.logger.record_tabular

    def spy(key, value):
        if key == "ReturnAverage":
            averages.append(float(value))
        record(key, value)

    runner.logger.record_tabular = spy
    runner.train()
    print(f"dict-obs cartpole dqn: ReturnAverage by interval {averages}; "
          f"{time.time() - t0:.1f} s in all")
    assert averages and averages[-1] > 120.0, f"returns {averages}"
