"""Tabular logger (port of rlpyt_tpu/utils/logging.py: TabularLogger and
logger_context): console table per dump, and ``progress.csv``,
``debug.log``, parameter snapshots and, with ``use_summary_writer``,
TensorBoard events (every numeric key at step ``CumSteps``) under
``log_dir`` when one is given.  ``torch.utils.tensorboard`` is imported
only when a writer is asked for.

A snapshot is the pickle the JAX package writes: a dict of numpy values,
``{"params": <the agent's flax parameter tree>, "itr", "cum_steps"}``
(``params.py:agent_params_to_jax``), so either package reads the other's.
``snapshot_mode`` "last" keeps one ``params.pkl``; "all" writes
``itr_<itr>.pkl`` every time, "gap" every ``snapshot_gap`` iterations;
"none" writes nothing."""
from __future__ import annotations

import csv
import json
import os
import pickle
import time
from contextlib import contextmanager
from typing import Any, Dict, Optional

import numpy as np

from rlpyt_tpu_torch.struct import tree_map


class TabularLogger:
    def __init__(self, log_dir: Optional[str] = None,
                 snapshot_mode: str = "last", snapshot_gap: int = 1,
                 use_summary_writer: bool = False):
        if snapshot_mode not in ("last", "all", "gap", "none"):
            raise ValueError(f"unknown snapshot_mode {snapshot_mode!r}")
        self.log_dir = log_dir
        self.snapshot_mode = snapshot_mode
        self.snapshot_gap = snapshot_gap
        self._tb = None
        self._tb_step = 0
        if use_summary_writer and log_dir is not None:
            from torch.utils.tensorboard import SummaryWriter
            self._tb = SummaryWriter(log_dir=log_dir)
        self._tabular: Dict[str, Any] = {}
        self._csv_file = None
        self._csv_writer = None
        self._debug_file = None
        if log_dir is not None:
            os.makedirs(log_dir, exist_ok=True)
            self._csv_path = os.path.join(log_dir, "progress.csv")
            self._debug_file = open(os.path.join(log_dir, "debug.log"), "a")

    def record_tabular(self, key: str, value):
        if hasattr(value, "item"):
            value = value.item()
        self._tabular[key] = value

    def record_tabular_misc_stat(self, key: str, values):
        """``key`` + Average, Std, Min and Max of ``values`` (NaN when
        there are none), in float64 as the JAX logger computes them."""
        values = np.asarray(values, dtype=np.float64)
        if values.size:
            stats = (np.mean(values), np.std(values), np.min(values),
                     np.max(values))
        else:
            stats = (float("nan"),) * 4
        for suffix, v in zip(("Average", "Std", "Min", "Max"), stats):
            self.record_tabular(key + suffix, float(v))

    def dump_tabular(self, print_fn=print):
        if not self._tabular:
            return
        if self._tb is not None:
            step = int(self._tabular.get("CumSteps", self._tb_step))
            for k, v in self._tabular.items():
                if isinstance(v, (int, float)):
                    self._tb.add_scalar(k, v, step)
            self._tb_step = step + 1
        width = max(len(k) for k in self._tabular)
        lines = ["-" * (width + 22)]
        for k, v in self._tabular.items():
            sval = f"{v:.6g}" if isinstance(v, float) else str(v)
            lines.append(f"| {k:<{width}} | {sval:>15} |")
        lines.append("-" * (width + 22))
        text = "\n".join(lines)
        if print_fn:
            print_fn(text)
        self.log(text, echo=False)
        if self.log_dir is not None:
            if self._csv_writer is None:
                self._csv_file = open(self._csv_path, "a", newline="")
                self._csv_writer = csv.DictWriter(
                    self._csv_file, fieldnames=list(self._tabular.keys()))
                if os.path.getsize(self._csv_path) == 0:
                    self._csv_writer.writeheader()
            self._csv_writer.writerow(self._tabular)
            self._csv_file.flush()
        self._tabular = {}

    def log(self, message: str, echo: bool = True):
        stamped = f"{time.strftime('%Y-%m-%d %H:%M:%S')} | {message}"
        if echo:
            print(stamped)
        if self._debug_file is not None:
            self._debug_file.write(stamped + "\n")
            self._debug_file.flush()

    def snapshot_path(self, itr: int) -> Optional[str]:
        """Where the snapshot of iteration ``itr`` goes, or None when
        this logger writes none for it."""
        if self.log_dir is None or self.snapshot_mode == "none" or (
                self.snapshot_mode == "gap" and itr % self.snapshot_gap):
            return None
        name = "params.pkl" if self.snapshot_mode == "last" \
            else f"itr_{itr}.pkl"
        return os.path.join(self.log_dir, name)

    def save_itr_params(self, itr: int, params: Dict[str, Any]):
        """Pickle ``params`` (a dict of numpy trees and numbers, leaves
        made numpy arrays) where ``snapshot_path`` says."""
        path = self.snapshot_path(itr)
        if path is None:
            return
        with open(path, "wb") as f:
            pickle.dump(tree_map(np.asarray, params), f)

    def close(self):
        if self._tb is not None:
            self._tb.close()
        if self._csv_file:
            self._csv_file.close()
        if self._debug_file:
            self._debug_file.close()


@contextmanager
def logger_context(log_dir: str, run_id: int, name: str,
                   config: Optional[dict] = None,
                   snapshot_mode: str = "last",
                   use_summary_writer: bool = False):
    """A TabularLogger writing under ``log_dir/run_<run_id>``, with the
    run's config saved there as ``params.json``; closed on exit."""
    run_dir = os.path.join(log_dir, f"run_{run_id}")
    os.makedirs(run_dir, exist_ok=True)
    if config is not None:
        with open(os.path.join(run_dir, "params.json"), "w") as f:
            json.dump(config, f, indent=2, default=str)
    logger = TabularLogger(run_dir, snapshot_mode=snapshot_mode,
                           use_summary_writer=use_summary_writer)
    logger.log(f"Starting run {name} (run_{run_id})")
    try:
        yield logger
    finally:
        logger.close()
