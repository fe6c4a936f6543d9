"""MinAtar DQN-family configs (port of
rlpyt_tpu/experiments/configs/minatar_dqn.py, verbatim): "dqn", the
published MinAtar-DQN settings "dqn_pub", "ernbw" (categorical, double,
dueling, prioritized, n-step), "ernbw_vec" (ernbw with per-lane final
epsilons) and the recurrent "r2d1".  Sections: agent, model, algo, env,
eval_env, runner, sampler."""
import copy

MINATAR_MODEL = dict(channels=(16,), kernel_sizes=(3,), strides=(1,),
                     paddings=(0,), fc_sizes=(128,), obs_divisor=1.0)

configs = {}

config = dict(
    agent=dict(eps_steps=100_000, eps_final=0.1, eval_eps=0.001),
    model=dict(**MINATAR_MODEL, dueling=False),
    algo=dict(
        discount=0.99,
        batch_size=128,
        min_steps_learn=5_000,
        delta_clip=1.0,
        replay_size=500_000,
        replay_ratio=4.0,
        target_update_interval=500,
        n_step_return=3,
        learning_rate=3e-4,
        double_dqn=True,
        prioritized_replay=False,
    ),
    env=dict(game="breakout", sticky_action_prob=0.1, ramping=True),
    eval_env=dict(game="breakout", sticky_action_prob=0.1, ramping=True),
    runner=dict(n_steps=2_000_000, log_interval_steps=100_000),
    # evaluation: eval_max_steps // eval_n_envs = 3000 steps a lane, enough
    # for Freeway's 2500-step episodes; it stops early at the cap.
    sampler=dict(batch_T=32, batch_B=64, max_decorrelation_steps=100,
                 eval_n_envs=32, eval_max_steps=96_000,
                 eval_max_trajectories=100),
)
configs["dqn"] = config

# Published MinAtar-DQN settings (Young & Tian, arXiv:1903.03176 sec. 4):
# centered RMSprop lr 2.5e-4, decay 0.95, eps 0.01; batch 32; uniform
# replay of 100k; one update an env step; target refresh every 1k
# updates; n-step 1; learning from 5k steps.
config = copy.deepcopy(config)
config["algo"].update(
    batch_size=32, replay_size=100_000,
    # replay_ratio 32 is one batch-32 update an env step
    # (updates_per_optimize = ratio * T * B / batch_size).
    replay_ratio=32.0,
    target_update_interval=1_000, n_step_return=1, learning_rate=2.5e-4,
    double_dqn=False, prioritized_replay=False,
    optim="rmsprop", optim_kwargs=dict(decay=0.95, eps=0.01,
                                       centered=True))
configs["dqn_pub"] = config

config = copy.deepcopy(configs["dqn"])
config["model"]["dueling"] = True
config["algo"].update(prioritized_replay=True, pri_alpha=0.5,
                      pri_beta=0.4)
config["agent"].update(n_atoms=51, v_min=-10.0, v_max=10.0)
configs["ernbw"] = config

# ernbw with final epsilons log-spaced across the lanes down to
# eps_final_min (agents/dqn.py:EpsilonGreedyMixin).
config = copy.deepcopy(configs["ernbw"])
config["agent"].update(eps_final_min=0.0016, eps_final=0.4)
configs["ernbw_vec"] = config

config = copy.deepcopy(configs["dqn"])
config["model"] = dict(**MINATAR_MODEL)
config["model"]["lstm_size"] = 128
del config["model"]["fc_sizes"]
config["agent"] = dict(eps_steps=100_000, eps_final=0.1,
                       eps_final_min=0.0005, lstm_size=128)
config["algo"] = dict(
    discount=0.997, batch_b=32, batch_T=40, warmup_T=20,
    min_steps_learn=5_000, replay_size=500_000,
    replay_ratio=2.0,
    target_update_interval=1_000, n_step_return=5, learning_rate=3e-4,
    double_dqn=True, prioritized_replay=True, pri_alpha=0.6,
    pri_beta=0.9, pri_eta=0.9, input_priorities=True)
# The loss trains every step of the window (mask_after_done=False): the
# LSTM resets at dones and the n-step return stops at the first one.  The
# sampler's batch_T must be a multiple of the sequence replay's rnn-state
# interval (warmup_T, replay/sequence.py).
config["sampler"] = dict(batch_T=40, batch_B=64,
                         max_decorrelation_steps=100,
                         eval_n_envs=32, eval_max_steps=96_000,
                         eval_max_trajectories=100)
configs["r2d1"] = config
