"""ALE-Atari DQN-family configs (port of
rlpyt_tpu/experiments/configs/atari_dqn.py, verbatim; reference:
rlpyt/experiments/configs/atari/dqn/atari_dqn.py): "dqn", "ernbw"
(categorical, double, dueling, prioritized, n-step) and the recurrent
"r2d1".  Sections: agent, model, algo, env, eval_env, runner, sampler.

They run over the host farm (envs/host.py) of envs/atari.py envs, the
card running batched inference and the updates (rlpyt's GpuSampler
topology).  ``env.fake=True`` puts the scripted FakeALE
(envs/fake_ale.py) in place of the emulator, so a config runs without
ale_py; with ale_py and the ROMs installed, the same config runs the
real emulator.
"""
import copy

configs = {}

config = dict(
    agent=dict(eps_steps=1_000_000, eps_final=0.01, eval_eps=0.001),
    model=dict(dueling=False),  # Nature-CNN defaults in models/dqn.py
    algo=dict(
        discount=0.99,
        batch_size=32,
        min_steps_learn=50_000,
        delta_clip=1.0,
        replay_size=1_000_000,
        replay_ratio=8.0,
        target_update_interval=2_500,  # in updates (rlpyt: 1e4 steps / 4)
        n_step_return=1,
        learning_rate=2.5e-4,
        double_dqn=False,
        prioritized_replay=False,
        frame_buffer=True,  # store single uint8 frames, gather stacks
    ),
    env=dict(game="pong", episodic_lives=True, clip_reward=True,
             repeat_action_probability=0.25, max_start_noops=30,
             horizon=27_000, fake=False),
    eval_env=dict(game="pong", episodic_lives=False, clip_reward=False,
                  repeat_action_probability=0.25, max_start_noops=30,
                  horizon=27_000, fake=False),
    runner=dict(n_steps=50_000_000, log_interval_steps=1_000_000),
    sampler=dict(batch_T=4, batch_B=32, n_workers=0,
                 eval_n_envs=4, eval_max_steps=125_000,
                 eval_max_trajectories=100),
)
configs["dqn"] = config

# Rainbow-minus-noisy (Categorical + Double + Dueling + PER + n-step).
config = copy.deepcopy(config)
config["model"]["dueling"] = True
config["agent"].update(n_atoms=51, v_min=-10.0, v_max=10.0)
config["algo"].update(double_dqn=True, prioritized_replay=True,
                      pri_alpha=0.5, pri_beta=0.4, n_step_return=3,
                      learning_rate=6.25e-5, min_steps_learn=20_000)
configs["ernbw"] = config

# R2D1 (recurrent prioritized sequence replay, burn-in, value rescale).
config = copy.deepcopy(configs["dqn"])
config["model"] = dict(lstm_size=512)
config["agent"] = dict(eps_steps=1_000_000, eps_final=0.1,
                       eps_final_min=0.0005, lstm_size=512)
config["algo"] = dict(
    discount=0.997, batch_b=32, batch_T=80, warmup_T=40,
    min_steps_learn=50_000, replay_size=1_000_000, replay_ratio=1.0,
    target_update_interval=2_500, n_step_return=5, learning_rate=1e-4,
    double_dqn=True, prioritized_replay=True, pri_alpha=0.6,
    pri_beta=0.9, pri_eta=0.9, input_priorities=True)
config["sampler"].update(batch_T=40, batch_B=32)
configs["r2d1"] = config
