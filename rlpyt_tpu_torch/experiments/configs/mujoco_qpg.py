"""MuJoCo continuous-control configs (port of
rlpyt_tpu/experiments/configs/mujoco_qpg.py, copied verbatim; reference schema:
rlpyt/experiments/configs/mujoco/qpg/mujoco_sac.py, mujoco_td3.py,
mujoco_ddpg.py)."""
import copy

configs = {}

config = dict(
    agent=dict(),
    model=dict(hidden_sizes=(256, 256)),
    algo=dict(
        batch_size=256,
        min_steps_learn=int(1e4),
        replay_size=int(1e6),
        # rlpyt mujoco_sac.py replay_ratio=256 -> one gradient step per
        # env step (updates_per_optimize = ratio * T*B / batch_size)
        replay_ratio=256.0,
        learning_rate=3e-4,
        target_update_tau=0.005,
    ),
    env=dict(id="HalfCheetah-v5"),
    eval_env=dict(id="HalfCheetah-v5"),
    runner=dict(n_steps=int(1e6), log_interval_steps=int(1e4)),
    # host-farm eval (runners/host.py:_evaluate): max_T =
    # eval_max_steps // eval_n_envs = 1250 >= the 1000-step TimeLimit,
    # so every eval env completes at least one episode.
    sampler=dict(batch_T=32, batch_B=16, n_workers=8,
                 eval_n_envs=4, eval_max_steps=5_000,
                 eval_max_trajectories=4),
)
configs["sac"] = config

config = copy.deepcopy(config)
config["algo"] = dict(
    batch_size=256, min_steps_learn=int(1e4), replay_size=int(1e6),
    replay_ratio=100.0,  # rlpyt mujoco_td3.py
    learning_rate=1e-3, q_learning_rate=1e-3,
    target_update_tau=0.005)
configs["td3"] = config

config = copy.deepcopy(configs["td3"])
config["algo"]["learning_rate"] = 1e-4
config["algo"]["replay_ratio"] = 64.0  # rlpyt mujoco_ddpg.py
configs["ddpg"] = config
