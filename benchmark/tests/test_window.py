"""The end-to-end rate is every env step of the window over the whole
window's wall time, not a median of intervals: a stall counts."""
import time

import pytest
import torch

import harness


class _Info(tuple):
    pass


class FakeTrainer:
    """Iterations of fixed env steps that take the given host seconds."""

    device = torch.device("cpu")
    steps_per_iteration = 100
    optimize_s = 0.0

    def __init__(self, durations, bad_at=()):
        self.durations = list(durations)
        self.bad_at = set(bad_at)
        self.calls = 0

    def iteration(self, learner=None):
        time.sleep(self.durations[self.calls % len(self.durations)])
        if learner is not None:
            learner.start()
            time.sleep(self.optimize_s)
            learner.stop()
        loss = float("nan") if self.calls in self.bad_at else 1.0
        self.calls += 1
        return tuple(torch.tensor(v) for v in (loss, 2.0, 3.0))


def test_rate_counts_the_stall():
    # Nine iterations of 20 ms and one of 200 ms.
    t = FakeTrainer([0.02] * 9 + [0.2])
    w = harness.Window(t)
    n, wall = w.run(0.3)
    assert n == 10                      # the window ends after the stall
    rate = n * t.steps_per_iteration / wall
    assert rate == pytest.approx(1000 / 0.38, rel=0.15)
    median_rate = t.steps_per_iteration / 0.02
    assert rate < 0.6 * median_rate


def test_attempted_and_failed():
    t = FakeTrainer([0.001], bad_at={2, 4})
    w = harness.Window(t)
    n, _ = w.run(0.0, at_least=6)
    assert (n, w.attempted, int(w.bad)) == (6, 6, 2)


def test_learner_time_is_each_optimize():
    """The learner's seconds are those of the window's optimizes alone,
    not of the collections between them, nor of earlier stretches."""
    t = FakeTrainer([0.03])
    t.optimize_s = 0.01
    w = harness.Window(t)
    w.run(0.0, at_least=2)
    n, wall = w.run(0.0, at_least=5)
    assert n == 5 and len(w.learner.marks) == 14
    assert w.learner_s == pytest.approx(n * 0.01, rel=0.5)
    assert w.learner_s < 0.5 * wall
