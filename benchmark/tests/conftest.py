"""The benchmark's own tests: on the CPU at sizes a test run holds, and
one test marked ``cuda`` that runs each cell on the card."""
import sys
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parent.parent
for p in (str(BENCH), str(BENCH.parent)):
    if p not in sys.path:
        sys.path.insert(0, p)

import run  # noqa: E402

run.prepare_environment()

from registry import Registry  # noqa: E402

# The MinAtar cells' trainer at a size a test run holds: every width cut,
# the replay's first whole window after three iterations of 8 x 8.
TINY_MINATAR = {
    "model": {"channels": (4,), "lstm_size": 16, "fc_sizes": (32,)},
    "agent": {"lstm_size": 16},
    "algo": {"batch_b": 4, "batch_T": 8, "warmup_T": 4, "n_step_return": 2,
             "replay_size": 4000, "min_steps_learn": 192,
             "replay_ratio": 4.0},
    "sampler": {"batch_T": 8, "batch_B": 8, "max_decorrelation_steps": 10},
}

# The Atari cell's at a small size: two envs in a spawned farm, one
# update an iteration.
TINY_ATARI = {
    "model": {"channels": (4, 4, 4), "lstm_size": 16, "fc_sizes": (32,)},
    "agent": {"lstm_size": 16},
    "algo": {"batch_b": 2, "batch_T": 8, "warmup_T": 4, "n_step_return": 2,
             "replay_size": 2000, "min_steps_learn": 48,
             "replay_ratio": 1.0},
    "sampler": {"batch_T": 8, "batch_B": 2, "n_workers": 2},
}


@pytest.fixture
def tiny_minatar():
    return TINY_MINATAR


@pytest.fixture
def tiny_atari():
    return TINY_ATARI

# The check's limits at the tiny sizes, set as the configurations' are
# (benchmark/calibrate.py's readings, on the CPU, 16 seeds): the program
# reads at most 8.3e-5 (loss), 5.4e-5 (grad), 2.7e-5 (change), 5.9e-5
# (priority), 0 (collect) and 2.5e-7 (window_q), the update's numbers
# its closed-form h^-1's round-off, which no batch of 32 rows averages
# down; the TF32 control at least 2.4e-4 (collect) and 2.8e-4
# (window_q); the half batch at least 7.8e-2 on loss, grad and change.
TINY_LIMITS = {"loss": 3e-4, "grad": 3e-4, "change": 3e-4,
               "priority": 3e-4, "collect": 2e-5, "window_q": 2e-5}


class TinyRegistry(Registry):
    """The benchmark with the tiny sizes' limits in its configurations."""

    def config(self, name):
        return dict(super().config(name), limits=TINY_LIMITS)


@pytest.fixture
def tiny_registry():
    return TinyRegistry()
