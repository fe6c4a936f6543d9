"""The trace reduction on a made-up Chrome trace: busy time as the union
of device operations, device time by the range that launched it, idle
gaps by what the host's main thread was doing."""
import json

import pytest

from devtrace import summarize


def _x(cat, name, ts, dur, tid, **args):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur,
            "tid": tid, "pid": 0, "args": args}


def test_summarize(tmp_path):
    ev = [
        _x("user_annotation", "bench.collect", 0, 100, 1),
        _x("user_annotation", "bench.lstm_step", 10, 20, 1),
        _x("cuda_runtime", "cudaLaunchKernel", 12, 2, 1, correlation=1),
        _x("cuda_runtime", "cudaLaunchKernel", 40, 2, 1, correlation=2),
        _x("user_annotation", "bench.lstm_bwd", 200, 50, 7),
        _x("cuda_runtime", "cudaLaunchKernel", 210, 2, 7, correlation=3),
        _x("kernel", "k_step", 20, 10, 0, correlation=1),
        _x("kernel", "k_other", 25, 15, 0, correlation=2),   # overlaps
        _x("kernel", "k_bwd", 220, 30, 0, correlation=3),
        _x("cpu_op", "aten::mm", 60, 30, 1),
    ]
    path = tmp_path / "t.json"
    path.write_text(json.dumps({"traceEvents": ev}))
    s = summarize(path, ("bench.lstm_step", "bench.lstm_bwd",
                         "bench.lstm_train"))
    assert s["busy_s"] == pytest.approx((40 - 20 + 30) * 1e-6)
    assert s["range_device_s"] == pytest.approx(
        {"bench.lstm_step": 10e-6, "bench.lstm_bwd": 30e-6,
         "bench.lstm_train": 0.0})
    assert s["device_ops"][0] == ["k_bwd", pytest.approx(30e-6)]
    # The one gap (40 -> 220) has its middle at 130: the main thread
    # (tid 1, which holds bench.collect) was past every event.
    assert s["idle_gaps"] == [["host: no traced operation",
                               pytest.approx(180e-6)]]
    assert s["n_device_ops"] == 3
