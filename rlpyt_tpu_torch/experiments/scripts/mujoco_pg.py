"""MuJoCo PPO / A2C training script over the host farm (port of
rlpyt_tpu/experiments/scripts/mujoco_pg.py; reference:
rlpyt/experiments/scripts/mujoco/pg/train/mujoco_ff_ppo.py).

    python -m rlpyt_tpu_torch.experiments.scripts.mujoco_pg \
        [LOG_DIR [RUN_ID [CONFIG]]]

CONFIG is ``ppo`` or ``a2c`` (default ``ppo``); a ``variant.json`` in
LOG_DIR is merged into it.  Gymnasium's MuJoCo envs step in a
``SharedMemVecEnv`` (``serial=True``: in this process), the Gaussian
actor-critic runs batched on the card (``device="cpu"`` for tests), and
an evaluation farm runs episodes at each log interval.  Needs gymnasium
and mujoco.
"""
from __future__ import annotations

import copy
import os
import sys

from rlpyt_tpu_torch.agents.pg import GaussianPgAgent
from rlpyt_tpu_torch.algos.pg import A2C, PPO
from rlpyt_tpu_torch.envs.host import (PairedVecEnv, SerialVecEnv,
                                       SharedMemVecEnv)
from rlpyt_tpu_torch.experiments.configs.mujoco_pg import configs
from rlpyt_tpu_torch.runners.host import HostMinibatchRl
from rlpyt_tpu_torch.utils.logging import logger_context
from rlpyt_tpu_torch.utils.variant import load_variant, update_config

ALGOS = {"ppo": PPO, "a2c": A2C}


def make_config(configs: dict, config_key: str, variant=None,
                config_overrides=None) -> dict:
    """``configs[config_key]`` with ``variant``, then
    ``config_overrides``, merged in."""
    config = copy.deepcopy(configs[config_key])
    if variant is not None:
        config = update_config(config, variant)
    if config_overrides:
        config = update_config(config, config_overrides)
    return config


def make_farms(config: dict, seed: int, serial: bool, alternating: bool):
    """(training farm, evaluation farm or None) of the config's env ids.
    ``alternating``: two half farms stepped out of phase
    (``PairedVecEnv``), the second seeded ``seed + 5000``; the evaluation
    farm is seeded ``seed + 10000``."""
    sampler = config["sampler"]
    VecCls = SerialVecEnv if serial else SharedMemVecEnv
    env_id, B = config["env"]["id"], sampler["batch_B"]
    if alternating:
        half = B // 2
        n_w = max(1, sampler.get("n_workers", 0) // 2)
        farm = PairedVecEnv(
            VecCls([env_id] * half, n_workers=n_w, seed=seed),
            VecCls([env_id] * (B - half), n_workers=n_w, seed=seed + 5_000))
    else:
        farm = VecCls([env_id] * B, n_workers=sampler.get("n_workers", 0),
                      seed=seed)
    eval_farm = None
    if sampler.get("eval_n_envs", 0) > 0:
        eval_farm = VecCls(
            [config["eval_env"]["id"]] * sampler["eval_n_envs"],
            n_workers=sampler.get("n_workers", 0), seed=seed + 10_000)
    return farm, eval_farm


def train_on_farms(RunnerCls, config: dict, name: str, agent, algo,
                   seed: int, log_dir, run_id: int, serial: bool,
                   alternating: bool, device):
    """Build the farms and ``RunnerCls`` on them, train, close the farms;
    returns (runner, the state ``train()`` returns)."""
    sampler = config["sampler"]
    farm, eval_farm = make_farms(config, seed, serial, alternating)
    runner_kwargs = dict(algo=algo, agent=agent, vec_env=farm,
                         batch_T=sampler["batch_T"], seed=seed,
                         eval_vec_env=eval_farm,
                         eval_max_steps=sampler.get("eval_max_steps", 2_500),
                         eval_max_trajectories=sampler.get(
                             "eval_max_trajectories"),
                         device=device, **config["runner"])
    try:
        if log_dir is not None:
            with logger_context(log_dir, run_id, name,
                                config=config) as logger:
                runner = RunnerCls(logger=logger, **runner_kwargs)
                result = runner.train()
        else:
            runner = RunnerCls(**runner_kwargs)
            result = runner.train()
    finally:
        farm.close()
        if eval_farm is not None:
            eval_farm.close()
    return runner, result


def build_and_train(config_key: str = "ppo", log_dir=None, run_id: int = 0,
                    seed: int = 0, variant=None, config_overrides=None,
                    serial: bool = False, alternating: bool = False,
                    device="cuda"):
    """Train the ``config_key`` config; returns (runner, result), result
    being ``HostMinibatchRl.train()``'s state (the JAX script's
    ``(train_state, replay_state)``)."""
    config = make_config(configs, config_key, variant, config_overrides)
    agent = GaussianPgAgent(model_kwargs=config["model"], device=device,
                            **config["agent"])
    algo = ALGOS[config_key](**config["algo"])
    return train_on_farms(
        HostMinibatchRl, config,
        f"mujoco_{config['env']['id']}_{config_key}", agent, algo, seed,
        log_dir, run_id, serial, alternating, device)


if __name__ == "__main__":
    args = sys.argv[1:]
    log_dir = args[0] if len(args) > 0 else None
    run_id = int(args[1]) if len(args) > 1 else 0
    config_key = args[2] if len(args) > 2 else "ppo"
    variant = (load_variant(log_dir)
               if log_dir and os.path.exists(
                   os.path.join(log_dir, "variant.json")) else None)
    build_and_train(config_key, log_dir, run_id, variant=variant)
