"""The Rainbow-combo (ernbw) and R2D1 paths of the port learn MinAtar
Breakout, on a card.

The twins of tests/test_learning_coverage.py:test_ernbw_learns_minatar_
breakout and :test_r2d1_learns_minatar_breakout, with the same settings,
seeds, budgets and thresholds.  The R2D1 twin runs the hand-written LSTM
kernels (K3a, K3, K4 in csrc/lstm.cu) at H = 128 on every collection
step and update.  They import nothing of JAX, so they run where only
PyTorch is installed:

    python -m pytest --noconftest -m slow -s \
        tests/test_torch_learning_coverage.py
"""
import time

import pytest
import torch

from rlpyt_tpu_torch.agents.dqn import CatDqnAgent, R2d1Agent
from rlpyt_tpu_torch.algos.cat_dqn import CategoricalDQN
from rlpyt_tpu_torch.algos.r2d1 import R2D1
from rlpyt_tpu_torch.envs.minatar import Breakout
from rlpyt_tpu_torch.models.dqn import AtariCatDqnModel, AtariR2d1Model
from rlpyt_tpu_torch.runners.train import MinibatchRl
from rlpyt_tpu_torch.samplers.rollout import BatchSpec, Collector
from rlpyt_tpu_torch.utils import profiling

# The published MinAtar baseline trunk: one 3x3 conv of 16.
MINATAR_CONV = dict(channels=(16,), kernel_sizes=(3,), strides=(1,),
                    paddings=(0,))


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the runs are sized for the card")
    return torch.device("cuda")


def eval_return(env, agent, T=800, B=8, seed=123):
    """Greedy return per completed episode over a fresh [T, B] rollout
    (tests/test_learning_coverage.py:_eval_return)."""
    col = Collector(env, agent, BatchSpec(T=T, B=B))
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
def test_ernbw_learns_minatar_breakout(card):
    """C51 + double + dueling + prioritized replay + n-step 3: greedy
    evaluation above 1.5 an episode (random play scores about 0.5)."""
    t0 = time.time()
    env = Breakout()
    agent = CatDqnAgent(
        ModelCls=AtariCatDqnModel, n_atoms=51, v_min=-10.0, v_max=10.0,
        model_kwargs=dict(fc_sizes=(128,), n_atoms=51, dueling=True,
                          **MINATAR_CONV),
        eps_steps=100_000, eps_final=0.1)
    algo = CategoricalDQN(
        discount=0.99, batch_size=128, min_steps_learn=2_000,
        replay_size=100_000, replay_ratio=4.0,
        target_update_interval=500, learning_rate=3e-4,
        double_dqn=True, prioritized_replay=True, pri_alpha=0.5,
        pri_beta=0.4, n_step_return=3)
    runner = MinibatchRl(algo, agent, env, BatchSpec(T=32, B=32),
                         n_steps=500_000, seed=5, log_interval_steps=100_000)
    runner.train()
    avg, n = eval_return(env, agent)
    report("minatar breakout ernbw", avg, n, t0)
    assert avg > 1.5, f"ernbw eval return {avg}"


@pytest.mark.slow
@pytest.mark.cuda
def test_r2d1_learns_minatar_breakout(card):
    """Recurrent sequence replay with burn-in and value rescaling, LSTM
    128: greedy evaluation above 1.5 an episode."""
    t0 = time.time()
    env = Breakout()
    agent = R2d1Agent(
        ModelCls=AtariR2d1Model,
        model_kwargs=dict(lstm_size=128, **MINATAR_CONV),
        lstm_size=128, eps_steps=100_000, eps_final=0.1)
    algo = R2D1(discount=0.99, batch_b=32, batch_T=20, warmup_T=10,
                min_steps_learn=2_000, replay_size=100_000,
                replay_ratio=1.0, target_update_interval=500,
                n_step_return=3, learning_rate=3e-4, double_dqn=True,
                prioritized_replay=True, pri_alpha=0.6, pri_beta=0.9)
    runner = MinibatchRl(algo, agent, env, BatchSpec(T=40, B=32),
                         n_steps=300_000, seed=6, log_interval_steps=100_000)
    with profiling.recording() as rec:
        runner.train()
    print(f"LSTM kernel launches in training: K3a "
          f"{rec.total('ops.input_proj')}, K3 {rec.total('ops.lstm_fwd')}, "
          f"one-step {rec.total('ops.lstm_step')}, K4 "
          f"{rec.total('ops.lstm_bwd')}")
    assert rec.total("ops.lstm_bwd") > 0
    avg, n = eval_return(env, agent)
    report("minatar breakout r2d1", avg, n, t0)
    assert avg > 1.5, f"r2d1 eval return {avg}"
