"""MuJoCo SAC / TD3 / DDPG training script over the host farm (port of
rlpyt_tpu/experiments/scripts/mujoco_qpg.py; reference:
rlpyt/experiments/scripts/mujoco/qpg/train/mujoco_sac.py).

    python -m rlpyt_tpu_torch.experiments.scripts.mujoco_qpg \
        [LOG_DIR [RUN_ID [CONFIG]]]

CONFIG is ``sac``, ``td3`` or ``ddpg`` (default ``sac``); a
``variant.json`` in LOG_DIR is merged into it.  The farms are those of
``mujoco_pg.py``; needs gymnasium and mujoco.
"""
from __future__ import annotations

import os
import sys

from rlpyt_tpu_torch.agents.qpg import DdpgAgent, SacAgent, Td3Agent
from rlpyt_tpu_torch.algos.qpg import DDPG, SAC, TD3
from rlpyt_tpu_torch.experiments.configs.mujoco_qpg import configs
from rlpyt_tpu_torch.experiments.scripts.mujoco_pg import (make_config,
                                                           train_on_farms)
from rlpyt_tpu_torch.runners.host import AsyncHostRl, HostMinibatchRl
from rlpyt_tpu_torch.utils.variant import load_variant

AGENTS = {"sac": SacAgent, "td3": Td3Agent, "ddpg": DdpgAgent}
ALGOS = {"sac": SAC, "td3": TD3, "ddpg": DDPG}


def build_and_train(config_key: str = "sac", log_dir=None, run_id: int = 0,
                    seed: int = 0, variant=None, config_overrides=None,
                    serial: bool = False, runner: str = "sync",
                    alternating: bool = False, device="cuda"):
    """Train the ``config_key`` config; returns (runner, result), result
    being the runner's ``train()`` state.  ``runner``: "sync"
    (HostMinibatchRl) or "async" (AsyncHostRl: a learner thread on its own
    stream while the main thread steps the envs, rlpyt's AsyncRl
    topology).  ``alternating``: paired farm halves stepped out of phase,
    each half's env steps overlapping the other's inference (rlpyt's
    AlternatingSampler)."""
    config = make_config(configs, config_key, variant, config_overrides)
    agent = AGENTS[config_key](model_kwargs=config["model"], device=device,
                               **config["agent"])
    algo = ALGOS[config_key](**config["algo"])
    RunnerCls = AsyncHostRl if runner == "async" else HostMinibatchRl
    return train_on_farms(
        RunnerCls, config, f"mujoco_{config['env']['id']}_{config_key}",
        agent, algo, seed, log_dir, run_id, serial, alternating, device)


if __name__ == "__main__":
    args = sys.argv[1:]
    log_dir = args[0] if len(args) > 0 else None
    run_id = int(args[1]) if len(args) > 1 else 0
    config_key = args[2] if len(args) > 2 else "sac"
    variant = (load_variant(log_dir)
               if log_dir and os.path.exists(
                   os.path.join(log_dir, "variant.json")) else None)
    build_and_train(config_key, log_dir, run_id, variant=variant)
