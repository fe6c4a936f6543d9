"""MuJoCo policy-gradient configs (port of
rlpyt_tpu/experiments/configs/mujoco_pg.py, copied verbatim; reference schema:
rlpyt/experiments/configs/mujoco/pg/mujoco_ppo.py, mujoco_a2c.py —
nested dict sections agent/model/algo/env/runner/sampler)."""
import copy

configs = {}

config = dict(
    agent=dict(),
    model=dict(hidden_sizes=(64, 64), normalize_observation=True),
    algo=dict(
        discount=0.99,
        learning_rate=3e-4,
        value_loss_coeff=1.0,
        entropy_loss_coeff=0.0,
        clip_grad_norm=1.0,
        gae_lambda=0.95,
        minibatches=32,
        epochs=10,
        ratio_clip=0.2,
        normalize_advantage=True,
        linear_lr_schedule=True,
    ),
    env=dict(id="HalfCheetah-v5"),
    eval_env=dict(id="HalfCheetah-v5"),
    runner=dict(n_steps=int(1e6), log_interval_steps=int(2e4)),
    sampler=dict(batch_T=256, batch_B=8, n_workers=8,
                 eval_n_envs=4, eval_max_steps=5_000,
                 eval_max_trajectories=4),
)
configs["ppo"] = config

config = copy.deepcopy(config)
config["algo"] = dict(
    discount=0.99,
    learning_rate=3e-4,
    value_loss_coeff=0.5,
    entropy_loss_coeff=0.0,
    clip_grad_norm=1.0,
    gae_lambda=1.0,
    normalize_advantage=False,
)
config["sampler"] = dict(batch_T=100, batch_B=8, n_workers=8,
                         eval_n_envs=4, eval_max_steps=5_000,
                         eval_max_trajectories=4)
configs["a2c"] = config
