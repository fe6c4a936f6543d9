"""The trace reduction on a made-up Chrome trace: busy time as the union
of device operations, the top operations, and idle gaps by what the
host's main thread was doing, read from the program's spans."""
import json

import pytest

from devtrace import summarize


def _x(cat, name, ts, dur, tid, **args):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur,
            "tid": tid, "pid": 0, "args": args}


def test_summarize(tmp_path):
    ev = [
        _x("user_annotation", "collect", 0, 100, 1),
        _x("user_annotation", "ops.lstm_step", 10, 20, 1),
        _x("cuda_runtime", "cudaLaunchKernel", 12, 2, 1, correlation=1),
        _x("cuda_runtime", "cudaLaunchKernel", 40, 2, 1, correlation=2),
        _x("user_annotation", "ops.lstm_bwd", 200, 50, 7),
        _x("cuda_runtime", "cudaLaunchKernel", 210, 2, 7, correlation=3),
        _x("kernel", "k_step", 20, 10, 0, correlation=1),
        _x("kernel", "k_other", 25, 15, 0, correlation=2),   # overlaps
        _x("kernel", "k_bwd", 220, 30, 0, correlation=3),
        _x("kernel", "k_late", 300, 10, 0, correlation=4),
        _x("cpu_op", "aten::mm", 60, 30, 1),
        _x("user_annotation", "optimize", 255, 60, 1),
        _x("cpu_op", "aten::add", 260, 50, 1),
    ]
    path = tmp_path / "t.json"
    path.write_text(json.dumps({"traceEvents": ev}))
    s = summarize(path, ("collect", "ops.lstm_step", "ops.lstm_bwd",
                         "optimize"))
    assert s["busy_s"] == pytest.approx((40 - 20 + 30 + 10) * 1e-6)
    assert s["device_ops"][0] == ["k_bwd", pytest.approx(30e-6)]
    # The gap 40 -> 220 has its middle at 130: the main thread (tid 1,
    # which holds the program's collect) was past every event; the gap
    # 250 -> 300 at 275 is inside optimize's aten::add.
    assert s["idle_gaps"] == [
        ["host: no traced operation", pytest.approx(180e-6)],
        ["optimize > aten::add", pytest.approx(50e-6)]]
    assert s["n_device_ops"] == 4
