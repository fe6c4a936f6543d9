"""Example 7: SAC on MuJoCo HalfCheetah over the shared-memory host farm
(torch form of examples/example_7.py; reference: rlpyt
examples/example_7.py).  Gymnasium's envs step in spawned workers while
the card runs the batched policy: rlpyt's action-server topology.

    python -m rlpyt_tpu_torch.examples.example_7

Needs gymnasium and mujoco.
"""
from rlpyt_tpu_torch.agents.qpg import SacAgent
from rlpyt_tpu_torch.algos.qpg import SAC
from rlpyt_tpu_torch.envs.host import SharedMemVecEnv
from rlpyt_tpu_torch.runners.host import HostMinibatchRl


def build_and_train(n_steps=1_000_000, seed=0, n_envs=16, n_workers=8,
                    device="cuda"):
    """Train; returns the run's final state (``HostMinibatchRl.train()``)."""
    farm = SharedMemVecEnv(["HalfCheetah-v5"] * n_envs,
                           n_workers=n_workers, seed=seed)
    try:
        agent = SacAgent(device=device)
        algo = SAC(batch_size=256, min_steps_learn=10_000,
                   replay_size=1_000_000, replay_ratio=1.0,
                   learning_rate=3e-4, target_update_tau=0.005)
        runner = HostMinibatchRl(algo=algo, agent=agent, vec_env=farm,
                                 batch_T=32, n_steps=n_steps, seed=seed,
                                 log_interval_steps=10_000, device=device)
        return runner.train()
    finally:
        farm.close()


if __name__ == "__main__":
    build_and_train()
