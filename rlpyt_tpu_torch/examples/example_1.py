"""Example 1: DQN on CartPole, the smallest end-to-end wiring of env,
agent, algorithm and runner (torch form of examples/example_1.py).

    python -m rlpyt_tpu_torch.examples.example_1

A minute or two on the card; ``build_and_train(device="cpu")`` runs it on
the CPU.
"""
from rlpyt_tpu_torch.agents.dqn import DqnAgent
from rlpyt_tpu_torch.algos.dqn import DQN
from rlpyt_tpu_torch.envs.classic import CartPole
from rlpyt_tpu_torch.models.dqn import DqnMlpModel
from rlpyt_tpu_torch.runners.train import MinibatchRl
from rlpyt_tpu_torch.samplers.rollout import BatchSpec
from rlpyt_tpu_torch.utils.logging import logger_context


def build_and_train(n_steps=200_000, seed=0, log_dir=None, run_id=0,
                    device="cuda"):
    """Train; returns (runner, the run's final state_dict()).  With
    ``log_dir``, the rows also go to ``log_dir/run_<run_id>/``."""
    agent = DqnAgent(ModelCls=DqnMlpModel,
                     model_kwargs=dict(hidden_sizes=(256, 256)),
                     eps_steps=50_000, eps_final=0.02, device=device)
    algo = DQN(discount=0.99, batch_size=128, min_steps_learn=1_000,
               replay_size=50_000, replay_ratio=8.0,
               target_update_interval=300, learning_rate=1e-3,
               double_dqn=True, n_step_return=1)
    runner = MinibatchRl(algo=algo, agent=agent, env=CartPole(device=device),
                         batch_spec=BatchSpec(T=32, B=16), n_steps=n_steps,
                         seed=seed, log_interval_steps=20_000, device=device)
    if log_dir is None:
        return runner, runner.train()
    with logger_context(log_dir, run_id, "cartpole_dqn") as logger:
        runner.logger = logger
        return runner, runner.train()


if __name__ == "__main__":
    build_and_train()
