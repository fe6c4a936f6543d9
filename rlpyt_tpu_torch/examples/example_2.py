"""Example 2: Atari-class DQN on MinAtar Breakout, envs and learner on
the card (torch form of examples/example_2.py).

    python -m rlpyt_tpu_torch.examples.example_2
"""
from rlpyt_tpu_torch.experiments.scripts.minatar_dqn import build_and_train

if __name__ == "__main__":
    build_and_train(
        "dqn",
        config_overrides=dict(
            runner=dict(n_steps=500_000, log_interval_steps=50_000)),
        device="cuda")
