"""MinAtar policy-gradient configs (port of
rlpyt_tpu/experiments/configs/minatar_pg.py, verbatim): A2C, PPO and
their LSTM forms on MinAtar Breakout."""
import copy

# The published MinAtar network (one 3x3 conv of 16, fc 128) on binary
# planes; a copy of rlpyt_tpu/experiments/configs/minatar_dqn.py:12.
MINATAR_MODEL = dict(channels=(16,), kernel_sizes=(3,), strides=(1,),
                     paddings=(0,), fc_sizes=(128,), obs_divisor=1.0)

configs = {}

config = dict(
    agent=dict(),
    model=dict(**MINATAR_MODEL),
    algo=dict(
        discount=0.99,
        learning_rate=3e-4,
        value_loss_coeff=0.5,
        entropy_loss_coeff=0.01,
        clip_grad_norm=1.0,
        gae_lambda=0.95,
        normalize_advantage=False,
    ),
    env=dict(game="breakout", sticky_action_prob=0.1, ramping=True),
    eval_env=dict(game="breakout", sticky_action_prob=0.1, ramping=True),
    runner=dict(n_steps=5_000_000, log_interval_steps=100_000),
    sampler=dict(batch_T=16, batch_B=128, max_decorrelation_steps=100,
                 eval_n_envs=32, eval_max_steps=96_000,
                 eval_max_trajectories=100),
)
configs["a2c"] = config

config = copy.deepcopy(config)
config["algo"].update(
    epochs=4, minibatches=4, ratio_clip=0.1, linear_lr_schedule=True,
    learning_rate=2.5e-4, gae_lambda=0.95, normalize_advantage=True)
configs["ppo"] = config

config = copy.deepcopy(configs["a2c"])
config["model"]["lstm_size"] = 128
configs["lstm_a2c"] = config

config = copy.deepcopy(configs["ppo"])
config["model"]["lstm_size"] = 128
# recurrent PPO minibatches over B only (init_rnn_state per lane)
configs["lstm_ppo"] = config
