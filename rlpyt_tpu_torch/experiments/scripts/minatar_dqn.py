"""MinAtar DQN-family training script (port of
rlpyt_tpu/experiments/scripts/minatar_dqn.py).

    python -m rlpyt_tpu_torch.experiments.scripts.minatar_dqn \
        [LOG_DIR [RUN_ID [CONFIG]]]

CONFIG is one of ``dqn``, ``dqn_pub``, ``ernbw``, ``ernbw_vec``, ``r2d1``
(default ``dqn``); a ``variant.json`` in LOG_DIR is merged into it.  With
LOG_DIR the run writes ``LOG_DIR/run_<RUN_ID>/``: ``progress.csv``,
``debug.log``, ``params.json`` and the ``params.pkl`` snapshot.  The run
is on the card unless ``build_and_train(device="cpu")`` is called.
"""
from __future__ import annotations

import copy
import os
import sys

from rlpyt_tpu_torch.agents.dqn import CatDqnAgent, DqnAgent, R2d1Agent
from rlpyt_tpu_torch.algos.cat_dqn import CategoricalDQN
from rlpyt_tpu_torch.algos.dqn import DQN
from rlpyt_tpu_torch.algos.r2d1 import R2D1
from rlpyt_tpu_torch.envs.minatar import make_minatar
from rlpyt_tpu_torch.experiments.configs.minatar_dqn import configs
from rlpyt_tpu_torch.models.dqn import (
    AtariCatDqnModel,
    AtariDqnModel,
    AtariR2d1Model,
)
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


def build_runner(config_key: str = "dqn", seed: int = 0, variant=None,
                 config_overrides=None, device="cuda"):
    """The ``config_key`` trainer, not yet started: (runner, config).
    ``variant`` and then ``config_overrides`` are merged into the
    config.  The agent, algorithm and model follow the config: R2D1 for
    ``r2d1``, categorical DQN where the agent names ``n_atoms``, else
    DQN."""
    config = copy.deepcopy(configs[config_key])
    if variant is not None:
        config = update_config(config, variant)
    if config_overrides:
        config = update_config(config, config_overrides)

    env_cfg = dict(config["env"])
    game = env_cfg.pop("game")
    env = make_minatar(game, device=device, **env_cfg)
    if config_key == "r2d1":
        agent = R2d1Agent(ModelCls=AtariR2d1Model,
                          model_kwargs=config["model"], device=device,
                          **config["agent"])
        algo = R2D1(**config["algo"])
    elif "n_atoms" in config.get("agent", {}):
        agent_kwargs = dict(config["agent"])
        model_kwargs = dict(config["model"],
                            n_atoms=agent_kwargs.get("n_atoms", 51))
        agent = CatDqnAgent(ModelCls=AtariCatDqnModel,
                            model_kwargs=model_kwargs, device=device,
                            **agent_kwargs)
        algo = CategoricalDQN(**config["algo"])
    else:
        agent = DqnAgent(ModelCls=AtariDqnModel,
                         model_kwargs=config["model"], device=device,
                         **config["agent"])
        algo = DQN(**config["algo"])
    sampler = config["sampler"]
    runner = MinibatchRl(
        algo=algo, agent=agent, env=env,
        batch_spec=BatchSpec(sampler["batch_T"], sampler["batch_B"]),
        max_decorrelation_steps=sampler.get("max_decorrelation_steps", 100),
        seed=seed, device=device,
        **_eval_kwargs(config, device), **config["runner"])
    return runner, config


def build_and_train(config_key: str = "dqn", log_dir=None, run_id: int = 0,
                    mesh=None, seed: int = 0, variant=None,
                    config_overrides=None, device="cuda"):
    """Build the ``config_key`` trainer and train it; returns the runner.
    With ``log_dir``, the run's files go to ``log_dir/run_<run_id>/`` and
    its rows to the console as well."""
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
    config_key = args[2] if len(args) > 2 else "dqn"
    variant = (load_variant(log_dir)
               if log_dir and os.path.exists(
                   os.path.join(log_dir, "variant.json")) else None)
    build_and_train(config_key, log_dir, run_id, variant=variant)
