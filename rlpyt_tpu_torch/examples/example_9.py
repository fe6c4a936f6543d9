"""Example 9: PPO on MuJoCo HalfCheetah over the host farm, with an
evaluation farm at each log interval (torch form of examples/example_9.py;
reference: rlpyt experiments/scripts/mujoco/pg/train/mujoco_ff_ppo.py).

    python -m rlpyt_tpu_torch.examples.example_9

Needs gymnasium and mujoco.
"""
from rlpyt_tpu_torch.experiments.scripts.mujoco_pg import build_and_train

OVERRIDES = dict(
    env=dict(id="HalfCheetah-v5"),
    eval_env=dict(id="HalfCheetah-v5"),
    sampler=dict(eval_n_envs=8, eval_max_steps=10_000,
                 eval_max_trajectories=10),
)


def main(device="cuda", **kwargs):
    """``mujoco_pg.build_and_train("ppo")`` with the example's overrides;
    returns (runner, result)."""
    return build_and_train("ppo", config_overrides=OVERRIDES, device=device,
                           **kwargs)


if __name__ == "__main__":
    main()
