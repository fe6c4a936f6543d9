"""Atari-path learning test of the port, on a card: the twin of
tests/test_atari_train.py:test_atari_dqn_fake_ale_learns, with its TINY
overrides, seed 3, columns and thresholds.  The dqn config of
experiments/configs/atari_dqn.py runs through
experiments/scripts/atari_dqn.py:build_and_train over a serial farm of
AtariEnv(FakeALE), which pays +1 for holding action 1.  It imports
nothing of JAX, so it runs where only PyTorch is installed:

    python -m pytest --noconftest -m slow -s tests/test_torch_atari_learning.py
"""
import csv
import os
import time

import pytest
import torch

from rlpyt_tpu_torch.experiments.scripts.atari_dqn import build_and_train

TINY = dict(
    model=dict(channels=(8,), kernel_sizes=(8,), strides=(8,),
               paddings=(0,), fc_sizes=(64,)),
    agent=dict(eps_steps=2_500, eps_final=0.02),
    algo=dict(min_steps_learn=500, replay_size=20_000, batch_size=32,
              replay_ratio=8.0, learning_rate=1e-3,
              target_update_interval=100, frame_buffer=True),
    env=dict(fake=True, repeat_action_probability=0.0,
             max_start_noops=4),
    eval_env=dict(fake=True, repeat_action_probability=0.0,
                  max_start_noops=4, episodic_lives=False,
                  clip_reward=True),
    runner=dict(n_steps=7_000, log_interval_steps=1_750),
    sampler=dict(batch_T=16, batch_B=8, eval_n_envs=4,
                 eval_max_steps=400, eval_max_trajectories=20),
)


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the run is sized for the card")
    return torch.device("cuda")


@pytest.mark.slow
@pytest.mark.cuda
def test_atari_dqn_fake_ale_learns(card, tmp_path):
    t0 = time.time()
    build_and_train("dqn", log_dir=str(tmp_path), run_id=0, seed=3,
                    config_overrides=TINY, serial=True)
    with open(os.path.join(str(tmp_path), "run_0", "progress.csv")) as f:
        rows = list(csv.DictReader(f))
    assert rows, "no progress rows logged"
    cols = set(rows[0])
    for k in ("ReturnAverage", "LengthAverage", "NonzeroRewardsAverage",
              "DiscountedReturnAverage", "GameScoreAverage",
              "EvalReturnAverage", "EvalGameScoreAverage", "CumSteps",
              "StepsPerSecond"):
        assert k in cols, f"missing column {k}"
    last = rows[-1]
    print(f"atari dqn on FakeALE: ReturnAverage by interval "
          f"{[float(r['ReturnAverage']) for r in rows]}, GameScoreAverage "
          f"{[float(r['GameScoreAverage']) for r in rows]}, "
          f"DiscountedReturnAverage {float(last['DiscountedReturnAverage'])}"
          f", EvalReturnAverage {float(last['EvalReturnAverage'])}; "
          f"{time.time() - t0:.1f} s in all")
    assert float(last["ReturnAverage"]) > 5.0, last
    assert float(last["GameScoreAverage"]) > 6.0, last
    assert (float(last["DiscountedReturnAverage"])
            < float(last["ReturnAverage"]))
