"""The result's last line: its keys and types, ``checks`` last; and the
harness's refusals without a card."""
import json
import subprocess
import sys
import time

import harness
import run
from registry import ROOT


def _check_line(out, trace):
    keys = list(out)
    assert keys[:5] == ["correct", "attempted", "failed", "metrics",
                        "device"]
    assert keys[-1] == "checks"
    assert isinstance(out["correct"], bool)
    assert isinstance(out["attempted"], int) and out["attempted"] > 0
    assert out["failed"] == 0
    for m in out["metrics"].values():
        assert set(m) == {"value", "unit"}
        assert isinstance(m["value"], float)
    d = out["device"]
    assert d["platform"] == "gpu" and d["count"] == 1
    assert isinstance(d["memory_peak_bytes"], int)
    if trace:
        assert {"busy_s", "window_s"} <= set(d)
        assert set(out["breakdown"]) == {"device_ops", "idle_gaps"}
    for c in out["checks"].values():
        assert set(c) == {"value", "limit"}
    json.dumps(out)


def test_result_line(tiny_minatar):
    for trace in (False, True):
        res = harness.run_cell("minatar_r2d1.lanes256", 7, 0.5, trace,
                               time.perf_counter(), "cpu",
                               overrides=tiny_minatar)
        out = run.result_line(res, "a card", 1, trace, "700 W")
        _check_line(out, trace)
        # On the CPU the readers of the device trace find nothing.
        expect = ({"samplers.collect_ms", "algos.update_ms",
                   "replay.sample_ms", "samplers.collect_self_ms"} if trace
                  else {"env_steps_per_s", "setup_s"})
        assert set(out["metrics"]) == expect


def test_learner_cell_result_line(tiny_registry, tiny_atari):
    """The cell whose end-to-end metric is the learner's time reports it
    beside setup_s, and its per-layer metrics move it."""
    for trace in (False, True):
        res = harness.run_cell("atari_r2d1.farm32", 8, 0.5, trace,
                               time.perf_counter(), "cpu", tiny_registry,
                               tiny_atari)
        out = run.result_line(res, "a card", 1, trace, "700 W")
        _check_line(out, trace)
        expect = ({"runner.env_steps_per_s", "algos.update_ms.learner",
                   "replay.sample_ms.learner"} if trace
                  else {"learner_update_ms", "setup_s"})
        assert set(out["metrics"]) == expect
        assert all(m["value"] > 0 for m in out["metrics"].values())
        assert out["correct"]


def test_no_card_no_result():
    proc = subprocess.run(
        [sys.executable, str(ROOT / "benchmark" / "run.py"), "--workload",
         "minatar_r2d1.lanes256", "--seed", "1", "--seconds", "1", "--trace",
         "0"], capture_output=True, text=True, cwd=ROOT, timeout=300)
    assert proc.returncode != 0
    assert proc.stdout.strip() == ""


def test_forbidden_names_compared_whole():
    assert run.forbidden_modules(["rlpyt_tpu_torch.ops.lstm", "torch"]) \
        == []
    assert run.forbidden_modules(["rlpyt_tpu.ops", "jax.numpy",
                                  "jaxlib"]) == ["jax", "jaxlib",
                                                 "rlpyt_tpu"]
