"""Tabular logger (port of the part of rlpyt_tpu/utils/logging.py:
TabularLogger that MinibatchRl uses, and logger_context): console table
per dump, and ``progress.csv`` plus ``debug.log`` under ``log_dir`` when
one is given.  Parameter snapshots are not ported yet."""
from __future__ import annotations

import csv
import json
import os
import time
from contextlib import contextmanager
from typing import Any, Dict, Optional


class TabularLogger:
    def __init__(self, log_dir: Optional[str] = None):
        self.log_dir = log_dir
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

    def dump_tabular(self, print_fn=print):
        if not self._tabular:
            return
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

    def close(self):
        if self._csv_file:
            self._csv_file.close()
        if self._debug_file:
            self._debug_file.close()


@contextmanager
def logger_context(log_dir: str, run_id: int, name: str,
                   config: Optional[dict] = None):
    """A TabularLogger writing under ``log_dir/run_<run_id>``, with the
    run's config saved there as ``params.json``; closed on exit."""
    run_dir = os.path.join(log_dir, f"run_{run_id}")
    os.makedirs(run_dir, exist_ok=True)
    if config is not None:
        with open(os.path.join(run_dir, "params.json"), "w") as f:
            json.dump(config, f, indent=2, default=str)
    logger = TabularLogger(run_dir)
    logger.log(f"Starting run {name} (run_{run_id})")
    try:
        yield logger
    finally:
        logger.close()
