"""Example 4: synchronous data parallelism, DQN on MinAtar Breakout
under SyncRl (torch form of examples/example_4.py; reference: rlpyt
examples/example_4.py, multi-GPU sync with DDP).

    python -m rlpyt_tpu_torch.examples.example_4

``MeshSpec(dp=-1)`` puts one rank on each card (NCCL): a world of one on
a one-card machine.  ``build_and_train(mesh=MeshSpec(dp=2),
backend="gloo")`` runs two ranks that share one card, or, with
``device="cpu"``, two on the CPU.
"""
from rlpyt_tpu_torch.experiments.scripts.minatar_dqn import build_and_train \
    as train_minatar_dqn
from rlpyt_tpu_torch.parallel.mesh import MeshSpec
from rlpyt_tpu_torch.utils.variant import update_config


def build_and_train(n_steps=500_000, log_interval_steps=50_000, mesh=None,
                    backend=None, device="cuda", config_overrides=None):
    """Train the ``dqn`` config at 64 lanes over ``mesh`` (default
    ``MeshSpec(dp=-1)``); ``config_overrides`` are merged last.  Returns
    the runner (rank 0's)."""
    overrides = dict(
        sampler=dict(batch_B=64),
        runner=dict(n_steps=n_steps, log_interval_steps=log_interval_steps))
    if config_overrides:
        overrides = update_config(overrides, config_overrides)
    return train_minatar_dqn(
        "dqn", mesh=mesh if mesh is not None else MeshSpec(dp=-1),
        config_overrides=overrides, device=device, backend=backend)


if __name__ == "__main__":
    build_and_train()
