"""MinAtar A2C / PPO training script (port of
rlpyt_tpu/experiments/scripts/minatar_pg.py).

    python -m rlpyt_tpu_torch.experiments.scripts.minatar_pg \
        [LOG_DIR [RUN_ID [CONFIG]]]

CONFIG is one of ``a2c``, ``ppo``, ``lstm_a2c``, ``lstm_ppo`` (default
``ppo``); a ``variant.json`` in LOG_DIR is merged into it.  The run is on
the card unless ``build_and_train(device="cpu")`` is called.
"""
from __future__ import annotations

import copy
import os
import sys

from rlpyt_tpu_torch.agents.pg import (
    CategoricalPgAgent,
    RecurrentCategoricalPgAgent,
)
from rlpyt_tpu_torch.algos.pg import A2C, PPO
from rlpyt_tpu_torch.envs.minatar import make_minatar
from rlpyt_tpu_torch.experiments.configs.minatar_pg import configs
from rlpyt_tpu_torch.models.pg import AtariFfModel, AtariLstmModel
from rlpyt_tpu_torch.runners.train import MinibatchRl
from rlpyt_tpu_torch.samplers.rollout import BatchSpec
from rlpyt_tpu_torch.utils.logging import logger_context
from rlpyt_tpu_torch.utils.variant import load_variant, update_config


def _eval_kwargs(config, device):
    """The runner's evaluation settings, or none when ``eval_n_envs`` is
    0 or the config has no ``eval_env``."""
    sampler = config.get("sampler", {})
    if sampler.get("eval_n_envs", 0) <= 0 or "eval_env" not in config:
        return {}
    eval_cfg = dict(config["eval_env"])
    game = eval_cfg.pop("game")
    return dict(
        eval_env=make_minatar(game, device=device, **eval_cfg),
        eval_n_envs=sampler["eval_n_envs"],
        eval_max_steps=sampler.get("eval_max_steps", 2_500),
        eval_max_trajectories=sampler.get("eval_max_trajectories"))


def build_runner(config_key: str = "ppo", seed: int = 0, variant=None,
                 config_overrides=None, device="cuda"):
    """The ``config_key`` trainer, not yet started: (runner, config).
    ``variant`` and then ``config_overrides`` are merged into the
    config."""
    config = copy.deepcopy(configs[config_key])
    if variant is not None:
        config = update_config(config, variant)
    if config_overrides:
        config = update_config(config, config_overrides)

    env_cfg = dict(config["env"])
    game = env_cfg.pop("game")
    env = make_minatar(game, device=device, **env_cfg)
    if config_key.startswith("lstm"):
        agent = RecurrentCategoricalPgAgent(
            ModelCls=AtariLstmModel, model_kwargs=config["model"],
            device=device, **config["agent"])
    else:
        agent = CategoricalPgAgent(ModelCls=AtariFfModel,
                                   model_kwargs=config["model"],
                                   device=device, **config["agent"])
    AlgoCls = PPO if config_key.endswith("ppo") else A2C
    sampler = config["sampler"]
    runner = MinibatchRl(
        algo=AlgoCls(**config["algo"]), agent=agent, env=env,
        batch_spec=BatchSpec(sampler["batch_T"], sampler["batch_B"]),
        max_decorrelation_steps=sampler.get("max_decorrelation_steps", 100),
        seed=seed, device=device,
        **_eval_kwargs(config, device), **config["runner"])
    return runner, config


def build_and_train(config_key: str = "ppo", log_dir=None, run_id: int = 0,
                    mesh=None, seed: int = 0, variant=None,
                    config_overrides=None, device="cuda"):
    """Build the ``config_key`` trainer and train it; returns the runner.
    With ``log_dir``, the rows go to ``log_dir/run_<run_id>/progress.csv``
    as well as to the console."""
    if mesh is not None:
        raise NotImplementedError(
            "the port has no SyncRl yet: build_and_train runs on one device "
            "(pass mesh=None)")
    runner, config = build_runner(config_key, seed, variant,
                                  config_overrides, device)
    if log_dir is None:
        runner.train()
        return runner
    game = config["env"]["game"]
    with logger_context(log_dir, run_id, f"minatar_{game}_{config_key}",
                        config=config) as logger:
        runner.logger = logger
        runner.train()
    return runner


if __name__ == "__main__":
    args = sys.argv[1:]
    log_dir = args[0] if len(args) > 0 else None
    run_id = int(args[1]) if len(args) > 1 else 0
    config_key = args[2] if len(args) > 2 else "ppo"
    variant = (load_variant(log_dir)
               if log_dir and os.path.exists(
                   os.path.join(log_dir, "variant.json")) else None)
    build_and_train(config_key, log_dir, run_id, variant=variant)
