"""Example 3: PPO on MinAtar Breakout with 128 envs stepping together on
the card (torch form of examples/example_3.py).

    python -m rlpyt_tpu_torch.examples.example_3
"""
from rlpyt_tpu_torch.experiments.scripts.minatar_pg import build_and_train

if __name__ == "__main__":
    build_and_train(
        "ppo",
        config_overrides=dict(
            runner=dict(n_steps=2_000_000, log_interval_steps=100_000)),
        device="cuda")
