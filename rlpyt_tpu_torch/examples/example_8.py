"""Example 8: R2D1, recurrent replay DQN, on MinAtar Breakout: LSTM
Q-network, prioritized sequence replay with burn-in and stored rnn
state, value rescaling, per-lane epsilon (torch form of
examples/example_8.py).

    python -m rlpyt_tpu_torch.examples.example_8
"""
from rlpyt_tpu_torch.experiments.scripts.minatar_dqn import build_and_train

if __name__ == "__main__":
    build_and_train(
        "r2d1",
        config_overrides=dict(
            runner=dict(n_steps=2_000_000, log_interval_steps=100_000)),
        device="cuda")
