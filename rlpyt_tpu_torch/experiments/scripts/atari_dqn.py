"""ALE-Atari DQN-family training script over the host farm (port of
rlpyt_tpu/experiments/scripts/atari_dqn.py; reference:
rlpyt/experiments/scripts/atari/dqn/train/atari_dqn.py:build_and_train).

    python -m rlpyt_tpu_torch.experiments.scripts.atari_dqn \
        [LOG_DIR [RUN_ID [CONFIG]]]

CONFIG is one of ``dqn``, ``ernbw``, ``r2d1``, ``r2d1_resnet`` (default
``dqn``); a ``variant.json`` in LOG_DIR is merged into it.  ale_py is
imported when an env is built; with ``env.fake=True`` (and
``eval_env.fake=True``) the scripted FakeALE runs the same pipeline
without ROMs.  The envs step in a
``SharedMemVecEnv`` (spawned workers: the env factories pickle) or, with
``serial=True``, in this process; the model and the updates run on the
card unless ``build_and_train(device="cpu")`` is called.
"""
from __future__ import annotations

import copy
import functools
import os
import sys

from rlpyt_tpu_torch.agents.dqn import CatDqnAgent, DqnAgent, R2d1Agent
from rlpyt_tpu_torch.algos.cat_dqn import CategoricalDQN
from rlpyt_tpu_torch.algos.dqn import DQN
from rlpyt_tpu_torch.algos.r2d1 import R2D1
from rlpyt_tpu_torch.envs.atari import make_atari_env
from rlpyt_tpu_torch.envs.host import SerialVecEnv, SharedMemVecEnv
from rlpyt_tpu_torch.experiments.configs.atari_dqn import configs
from rlpyt_tpu_torch.models.dqn import (
    AtariCatDqnModel,
    AtariDqnModel,
    AtariR2d1Model,
)
from rlpyt_tpu_torch.runners.host import HostMinibatchRl
from rlpyt_tpu_torch.utils.logging import logger_context
from rlpyt_tpu_torch.utils.variant import load_variant, update_config

FAKE_ALE = "rlpyt_tpu_torch.envs.fake_ale:FakeALE"


def make_env_fn(env_config: dict, seed: int = 0):
    """One AtariEnv factory: a ``functools.partial`` of a module-level
    builder, which pickles, so a farm of them spawns its workers.
    ``fake=True`` names FakeALE as the emulator."""
    kw = dict(env_config)
    if kw.pop("fake", False):
        kw["ale_factory"] = FAKE_ALE
    kw.setdefault("seed", seed)
    return functools.partial(make_atari_env, **kw)


def build_agent_algo(config_key: str, config: dict, device="cuda"):
    """R2D1 for the ``r2d1`` keys (``r2d1``, ``r2d1_resnet``),
    categorical DQN where the agent names ``n_atoms``, else DQN; each on
    its Atari model."""
    if config_key.split("_")[0] == "r2d1":
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
    return agent, algo


def build_runner(config_key: str = "dqn", seed: int = 0, variant=None,
                 config_overrides=None, serial: bool = False, device="cuda"):
    """The ``config_key`` trainer and its farms, not yet started:
    (runner, config).  ``variant`` and then ``config_overrides`` are
    merged into the config.  The caller closes ``runner.vec`` and
    ``runner.eval_vec``."""
    config = copy.deepcopy(configs[config_key])
    if variant is not None:
        config = update_config(config, variant)
    if config_overrides:
        config = update_config(config, config_overrides)

    sampler = config["sampler"]
    VecCls = SerialVecEnv if serial else SharedMemVecEnv
    vec_kwargs = dict(n_workers=sampler.get("n_workers", 0))
    B = sampler["batch_B"]
    farm = VecCls([make_env_fn(config["env"], seed + b) for b in range(B)],
                  seed=seed, **vec_kwargs)
    eval_farm = None
    try:
        if sampler.get("eval_n_envs", 0) > 0:
            eval_farm = VecCls(
                [make_env_fn(config["eval_env"], seed + 10_000 + b)
                 for b in range(sampler["eval_n_envs"])],
                seed=seed + 10_000, **vec_kwargs)
        agent, algo = build_agent_algo(config_key, config, device)
        runner = HostMinibatchRl(
            algo=algo, agent=agent, vec_env=farm,
            batch_T=sampler["batch_T"], seed=seed, eval_vec_env=eval_farm,
            eval_max_steps=sampler.get("eval_max_steps", 2_500),
            eval_max_trajectories=sampler.get("eval_max_trajectories"),
            device=device, **config["runner"])
    except BaseException:
        farm.close()
        if eval_farm is not None:
            eval_farm.close()
        raise
    return runner, config


def build_and_train(config_key: str = "dqn", log_dir=None, run_id: int = 0,
                    seed: int = 0, variant=None, config_overrides=None,
                    serial: bool = False, device="cuda"):
    """Build the ``config_key`` trainer (``build_runner``) and train it;
    returns the runner.  With ``log_dir``, the run's files go to
    ``log_dir/run_<run_id>/``.  The farms are closed when training ends
    or fails."""
    runner, config = build_runner(config_key, seed, variant,
                                  config_overrides, serial, device)
    try:
        if log_dir is None:
            runner.train()
        else:
            name = f"atari_{config['env']['game']}_{config_key}"
            with logger_context(log_dir, run_id, name,
                                config=config) as logger:
                runner.logger = logger
                runner.train()
    finally:
        runner.vec.close()
        if runner.eval_vec is not None:
            runner.eval_vec.close()
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
