"""The port's first learning test: DQN on MinAtar Breakout, on a card.

The twin of tests/test_minatar_learning.py:test_dqn_learns_minatar_
breakout, with the same settings and seed.  It imports nothing of JAX, so
it runs where only PyTorch is installed:

    python -m pytest --noconftest -m slow -s \
        tests/test_torch_minatar_learning.py
"""
import time

import pytest
import torch

from rlpyt_tpu_torch.agents.dqn import DqnAgent
from rlpyt_tpu_torch.algos.dqn import DQN
from rlpyt_tpu_torch.envs.minatar import Breakout
from rlpyt_tpu_torch.runners.train import MinibatchRl
from rlpyt_tpu_torch.samplers.rollout import BatchSpec, Collector

# The published MinAtar baseline network: one 3x3 conv of 16, fc 128.
MINATAR_MODEL = dict(channels=(16,), kernel_sizes=(3,), strides=(1,),
                     paddings=(0,), fc_sizes=(128,))


@pytest.mark.slow
@pytest.mark.cuda
def test_dqn_learns_minatar_breakout():
    """Greedy evaluation over T=800, B=8 must return above 2.0 an
    episode (random play scores about 0.5)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the run is sized for the card")
    t0 = time.time()
    env = Breakout()   # sticky actions on, as published
    agent = DqnAgent(model_kwargs=MINATAR_MODEL, eps_steps=100_000,
                     eps_final=0.1)
    algo = DQN(discount=0.99, batch_size=128, min_steps_learn=2_000,
               replay_size=100_000, replay_ratio=4.0,
               target_update_interval=500, learning_rate=3e-4,
               double_dqn=True, prioritized_replay=False, n_step_return=3)
    runner = MinibatchRl(algo, agent, env, BatchSpec(T=32, B=32),
                         n_steps=300_000, seed=4, log_interval_steps=100_000)
    runner.train()
    col = Collector(env, agent, BatchSpec(T=800, B=8))
    g = torch.Generator(device="cuda").manual_seed(123)
    state, _ = col.collect(col.init_state(g), g, is_eval=True)
    ts = state.traj_stats
    avg = float(ts.sum_return) / max(int(ts.completed), 1)
    print(f"minatar breakout greedy eval return {avg:.4f} over "
          f"{int(ts.completed)} episodes; {time.time() - t0:.1f} s in all")
    assert avg > 2.0, f"DQN failed on MinAtar breakout: eval return {avg}"
