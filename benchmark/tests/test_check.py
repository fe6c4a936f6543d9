"""What decides ``correct``, at a size a test run holds on the CPU: the
port against the plain reference passes; the control (the reference in
the program's place with TF32 products) fails; and a run whose timed
path is broken underneath comes out not correct, for each fault a
single-card training cell can have."""
import time

import pytest
import torch

import check
import harness
from rlpyt_tpu_torch.agents.dqn import R2d1Agent
from rlpyt_tpu_torch.algos import base
from rlpyt_tpu_torch.algos.r2d1 import R2D1

CELL = "minatar_r2d1.lanes256"


def _run(over, seed=3):
    from conftest import TinyRegistry
    return harness.run_cell(CELL, seed, 0.3, False, time.perf_counter(),
                            "cpu", TinyRegistry(), over)


def test_port_matches_reference(tiny_minatar):
    res = _run(tiny_minatar)
    assert res["correct"], res["checks"]
    # The forwards agree to float32's rounding.  The update's numbers
    # carry the program's closed-form h^-1, whose sqrt(...) - 1 keeps
    # about 6e-5 of relative precision in float32, against the
    # reference's form without the cancellation.
    for k in ("collect", "window_q"):
        assert res["checks"][k]["value"] < 1e-5
    for k in ("loss", "grad", "change", "priority"):
        assert res["checks"][k]["value"] < 1e-4


@pytest.fixture(scope="module")
def prepared():
    from conftest import TINY_MINATAR, TinyRegistry
    prep = harness.Prepared(TinyRegistry(), CELL, 4, "cpu", TINY_MINATAR)
    prep.release()
    return prep


@pytest.mark.parametrize("variant", ["control", "control_learner",
                                     "half_batch"])
def test_control_and_planted_fault_fail(prepared, variant):
    """The controls (TF32 products everywhere, or in the learner alone)
    and the half batch planted in the reference fail the limits; the
    float64 witness passes them."""
    dev = torch.device("cpu")
    c = prepared.check
    refr = c.reference(dev)
    assert check.judge(c.compare(c.program(), refr, dev), prepared.limits)
    numbers = c.compare(c.reference(dev, variant), refr, dev)
    assert not check.judge(numbers, prepared.limits), numbers
    if variant == "control_learner":
        numbers.pop("collect")
        assert not check.judge(numbers, prepared.limits), numbers
    witness = c.compare(c.reference(dev, "fp64"), refr, dev)
    assert check.judge(witness, prepared.limits), witness


def _state_unchanged(monkeypatch):
    monkeypatch.setattr(base.Optimizer, "step", lambda self: base.global_norm(
        [p.grad for p in self.params]))


def _half_batch(monkeypatch):
    mean = R2D1._mean

    def half(self, x, valid=None, n=None):
        if x.dim() == 2:
            b = x.shape[1] // 2
            return mean(self, x[:, :b],
                        None if valid is None else valid[:, :b], n)
        return mean(self, x, valid, n)

    monkeypatch.setattr(R2D1, "_mean", half)


def _answer_altered(monkeypatch):
    step = R2d1Agent.step

    def altered(self, *args, **kwargs):
        out, carry = step(self, *args, **kwargs)
        q = out.agent_info["q"].clone()
        q[0, 0] += 1e-2 * (1 + q.abs().max())
        out.agent_info["q"] = q
        return out, carry

    monkeypatch.setattr(R2d1Agent, "step", altered)


@pytest.mark.parametrize("fault", [_state_unchanged, _half_batch,
                                   _answer_altered],
                         ids=["state_unchanged", "half_batch",
                              "answer_altered"])
def test_broken_timed_path_is_not_correct(fault, monkeypatch, tiny_minatar):
    fault(monkeypatch)
    res = _run(tiny_minatar)
    assert not res["correct"], res["checks"]
