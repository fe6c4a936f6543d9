"""Local experiment launcher (port of rlpyt_tpu/utils/launching.py:
launch_experiment, run_experiments).

Runs ``python script <log_dir> <run_id> *args`` once for each (variant,
run), over ``n_slots`` concurrent subprocesses, each slot with an
optional environment of its own.  On a machine with several GPUs,
``slot_envs=[{"CUDA_VISIBLE_DEVICES": str(i)} for i in range(n)]`` pins
slot i to card i: the script then sees one card, ``cuda:0``.
"""
from __future__ import annotations

import os
import subprocess
import sys
import time
from typing import Dict, List, Optional, Sequence

from rlpyt_tpu_torch.utils.variant import save_variant


def launch_experiment(script: str, log_dir: str, run_id: int,
                      args: Sequence[str] = (),
                      env: Optional[Dict[str, str]] = None):
    """Start one run; its output goes to ``log_dir/stdout_<run_id>.log``.
    Returns the ``Popen``."""
    os.makedirs(log_dir, exist_ok=True)
    cmd = [sys.executable, script, log_dir, str(run_id), *map(str, args)]
    full_env = dict(os.environ)
    if env:
        full_env.update(env)
    with open(os.path.join(log_dir, f"stdout_{run_id}.log"), "w") as out:
        return subprocess.Popen(cmd, stdout=out, stderr=subprocess.STDOUT,
                                env=full_env)


def run_experiments(script: str, experiment_title: str,
                    variants: List[dict], log_dirs: List[str],
                    runs_per_setting: int = 1,
                    common_args: Sequence[str] = (),
                    n_slots: int = 1,
                    root_log_dir: str = "data",
                    slot_envs: Optional[List[Dict[str, str]]] = None,
                    poll_s: float = 2.0) -> List[int]:
    """Run every variant ``runs_per_setting`` times, at most ``n_slots``
    at once, under ``root_log_dir/experiment_title/<log_dir>`` (with the
    variant saved there as ``variant.json``); ``slot_envs[i]`` is added
    to the environment of the runs in slot i.  Returns the exit codes in
    the order the runs ended."""
    launches = []
    for variant, vdir in zip(variants, log_dirs):
        log_dir = os.path.join(root_log_dir, experiment_title, vdir)
        save_variant(variant, log_dir)
        launches += [(log_dir, run_id) for run_id in range(runs_per_setting)]

    procs: List[Optional[subprocess.Popen]] = [None] * n_slots
    results = []
    i = 0
    while i < len(launches) or any(p is not None for p in procs):
        for slot in range(n_slots):
            p = procs[slot]
            if p is not None and p.poll() is not None:
                results.append(p.returncode)
                procs[slot] = None
            if procs[slot] is None and i < len(launches):
                log_dir, run_id = launches[i]
                env = slot_envs[slot] if slot_envs else None
                procs[slot] = launch_experiment(
                    script, log_dir, run_id, common_args, env)
                i += 1
        time.sleep(poll_s)
    return results
