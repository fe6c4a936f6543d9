"""Policy-gradient learning tests of the port, on a card.

The twins of tests/test_minatar_learning.py:test_lstm_a2c_learns_minatar_
breakout and of the three tests of tests/test_pg_e2e.py, with the same
settings, seeds and thresholds.  They import nothing of JAX, so they run
where only PyTorch is installed:

    python -m pytest --noconftest -m slow -s tests/test_torch_pg_learning.py
"""
import time

import pytest
import torch
from torch import nn
import torch.nn.functional as F

from rlpyt_tpu_torch.agents.pg import (
    CategoricalPgAgent,
    RecurrentCategoricalPgAgent,
)
from rlpyt_tpu_torch.algos.pg import A2C, PPO
from rlpyt_tpu_torch.envs.classic import CartPole
from rlpyt_tpu_torch.experiments.scripts.minatar_pg import build_and_train
from rlpyt_tpu_torch.models.mlp import MlpModel
from rlpyt_tpu_torch.models.pg import dense
from rlpyt_tpu_torch.models.rnn import LstmCore
from rlpyt_tpu_torch.runners.train import MinibatchRl
from rlpyt_tpu_torch.samplers.rollout import BatchSpec, Collector
from rlpyt_tpu_torch.struct import infer_leading_dims, restore_leading_dims


class CartPoleFfModel(nn.Module):
    """MLP actor-critic for vector observations (the twin of
    tests/test_pg_e2e.py:CartPoleFfModel); ``image_shape`` is the
    observation's shape, as the PG agents pass it."""

    def __init__(self, image_shape, n_actions, hidden_sizes=(64, 64)):
        super().__init__()
        self.fc = MlpModel(image_shape[0], hidden_sizes)
        self.pi = dense(hidden_sizes[-1], n_actions)
        self.value = dense(hidden_sizes[-1], 1)

    def forward(self, observation, prev_action=None, prev_reward=None):
        lead_dim, T, B, shape = infer_leading_dims(observation, 1)
        x = self.fc(observation.reshape((T * B,) + shape))
        return restore_leading_dims((self.pi(x), self.value(x)[..., 0]),
                                    lead_dim, T, B)


class CartPoleLstmModel(nn.Module):
    """MLP 64 -> LSTM over [features, one-hot prev action, prev reward]
    -> pi, V (the twin of tests/test_pg_e2e.py:CartPoleLstmModel)."""

    def __init__(self, image_shape, n_actions, lstm_size=64):
        super().__init__()
        self.n_actions = n_actions
        self.fc = MlpModel(image_shape[0], (64,))
        self.lstm = LstmCore(64 + n_actions + 1, lstm_size)
        self.pi = dense(lstm_size, n_actions)
        self.value = dense(lstm_size, 1)

    def forward(self, observation, prev_action, prev_reward, rnn_state,
                done=None):
        lead_dim, T, B, shape = infer_leading_dims(observation, 1)
        x = self.fc(observation.reshape((T, B) + shape))
        pa = F.one_hot(prev_action.reshape(T, B).long(),
                       self.n_actions).to(x.dtype)
        pr = prev_reward.reshape(T, B, 1).to(x.dtype)
        done_tb = (torch.zeros((T, B), dtype=torch.bool, device=x.device)
                   if done is None else done.reshape(T, B))
        y, next_state = self.lstm(torch.cat([x, pa, pr], dim=-1), done_tb,
                                  rnn_state)
        y = y.reshape(T * B, -1)
        pi, v = restore_leading_dims((self.pi(y), self.value(y)[..., 0]),
                                     lead_dim, T, B)
        return pi, v, next_state


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the runs are sized for the card")
    return torch.device("cuda")


def eval_return(env, agent, T, B, seed, discount=1.0):
    """Greedy return per completed episode over a fresh [T, B] rollout."""
    col = Collector(env, agent, BatchSpec(T, B), discount=discount)
    g = torch.Generator(device=env.device).manual_seed(seed)
    state, _ = col.collect(col.init_state(g), g, is_eval=True)
    ts = state.traj_stats
    return float(ts.sum_return) / max(int(ts.completed), 1), \
        int(ts.completed)


def report(name, avg, n, t0):
    print(f"{name}: greedy eval return {avg:.4f} over {n} episodes; "
          f"{time.time() - t0:.1f} s in all")


@pytest.mark.slow
@pytest.mark.cuda
def test_lstm_a2c_learns_minatar_breakout(card):
    t0 = time.time()
    runner = build_and_train(
        "lstm_a2c", seed=3,
        config_overrides={
            "runner": {"n_steps": 400_000, "log_interval_steps": 200_000},
            "sampler": {"batch_T": 16, "batch_B": 64, "eval_n_envs": 0,
                        "max_decorrelation_steps": 50}})
    avg, n = eval_return(runner.env, runner.agent, 600, 16, 9, 0.99)
    report("minatar breakout lstm_a2c", avg, n, t0)
    assert avg > 1.5, f"lstm_a2c failed to learn breakout: {avg}"


def train_cartpole(agent, algo, batch_spec, n_steps, seed, log_steps):
    runner = MinibatchRl(algo, agent, CartPole(), batch_spec, n_steps=n_steps,
                         seed=seed, log_interval_steps=log_steps)
    runner.train()
    return runner


@pytest.mark.slow
@pytest.mark.cuda
def test_ppo_learns_cartpole(card):
    t0 = time.time()
    agent = CategoricalPgAgent(ModelCls=CartPoleFfModel)
    algo = PPO(discount=0.99, learning_rate=3e-4, epochs=4, minibatches=4,
               ratio_clip=0.2, gae_lambda=0.95, normalize_advantage=True,
               entropy_loss_coeff=0.0)
    runner = train_cartpole(agent, algo, BatchSpec(T=128, B=16), 150_000, 2,
                            50_000)
    avg, n = eval_return(runner.env, agent, 600, 8, 99)
    report("cartpole ppo", avg, n, t0)
    assert avg > 150, f"PPO failed to learn CartPole: {avg}"


@pytest.mark.slow
@pytest.mark.cuda
def test_a2c_learns_cartpole(card):
    t0 = time.time()
    agent = CategoricalPgAgent(ModelCls=CartPoleFfModel)
    algo = A2C(discount=0.99, learning_rate=1e-3, gae_lambda=0.95,
               entropy_loss_coeff=0.01)
    runner = train_cartpole(agent, algo, BatchSpec(T=32, B=32), 300_000, 3,
                            100_000)
    avg, n = eval_return(runner.env, agent, 600, 8, 99)
    report("cartpole a2c", avg, n, t0)
    assert avg > 120, f"A2C failed to learn CartPole: {avg}"


@pytest.mark.slow
@pytest.mark.cuda
def test_recurrent_ppo_runs_and_improves(card):
    t0 = time.time()
    agent = RecurrentCategoricalPgAgent(ModelCls=CartPoleLstmModel,
                                        lstm_size=64)
    algo = PPO(discount=0.99, learning_rate=5e-4, epochs=4, minibatches=4,
               ratio_clip=0.2, gae_lambda=0.95, normalize_advantage=True)
    runner = train_cartpole(agent, algo, BatchSpec(T=64, B=16), 120_000, 4,
                            60_000)
    avg, n = eval_return(runner.env, agent, 600, 8, 99)
    report("cartpole recurrent ppo", avg, n, t0)
    assert avg > 80, f"Recurrent PPO too weak on CartPole: {avg}"
