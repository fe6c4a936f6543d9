"""The port's profiling helpers on the CPU: ``trace`` writes a Chrome
trace naming the profiled ops, ``time_fn`` returns the JAX helper's keys,
``device_memory_stats`` has one entry a visible card (none here), and the kernels'
build directory moves where the cache is pointed."""
import json

import pytest
import torch

from rlpyt_tpu_torch.ops import cuda_build
from rlpyt_tpu_torch.utils.profiling import (
    device_memory_stats,
    enable_persistent_compilation_cache,
    time_fn,
    trace,
)


def test_trace_writes_a_chrome_trace(tmp_path):
    a = torch.ones(64, 64)
    with trace(str(tmp_path)):
        (a @ a).sum()
    files = list(tmp_path.glob("trace_*.json"))
    assert len(files) == 1
    names = {e.get("name") for e in json.loads(files[0].read_text())[
        "traceEvents"]}
    assert "aten::mm" in names


def test_time_fn_keys_and_consistency():
    calls = []

    def fn(x):
        calls.append(1)
        return x * 2

    out = time_fn(fn, torch.ones(8), iters=5, warmup=3)
    assert sorted(out) == ["iters_per_s", "mean_s"]
    assert len(calls) == 8
    assert out["mean_s"] > 0
    assert out["iters_per_s"] == pytest.approx(1.0 / out["mean_s"])


def test_device_memory_stats():
    """One entry a visible card; none without a card."""
    stats = device_memory_stats()
    assert sorted(stats) == [f"cuda:{d}"
                             for d in range(torch.cuda.device_count())]


def test_compilation_cache_points_the_build_dir(tmp_path, monkeypatch):
    monkeypatch.setattr(cuda_build, "BUILD_DIR", cuda_build.BUILD_DIR)
    default = cuda_build.BUILD_DIR
    assert default == cuda_build.CSRC / "build"
    enable_persistent_compilation_cache(str(tmp_path / "cache"))
    assert cuda_build.BUILD_DIR == tmp_path / "cache"
