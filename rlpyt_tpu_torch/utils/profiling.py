"""Profiling helpers (port of rlpyt_tpu/utils/profiling.py).

- ``trace(log_dir)``: ``torch.profiler`` over the host and the card,
  written as a Chrome trace (open in Perfetto or chrome://tracing);
- ``time_fn``: wall time of a callable after warm-up, synchronized with
  the card when one is in use;
- ``device_memory_stats``: the caching allocator's statistics of each
  visible card;
- ``enable_persistent_compilation_cache``: where the CUDA kernels'
  builds are kept, so later launches of the program reuse them.
"""
from __future__ import annotations

import os
import time
from contextlib import contextmanager
from pathlib import Path
from typing import Any, Callable, Dict

import torch


@contextmanager
def trace(log_dir: str):
    """Profile a region, ``with trace(d): run()``; the trace goes to
    ``d/trace_<pid>_<time>.json``.  Yields the profiler."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(
        log_dir, f"trace_{os.getpid()}_{time.time_ns()}.json"))


def time_fn(fn: Callable, *args, iters: int = 10, warmup: int = 2,
            **kwargs) -> Dict[str, float]:
    """Mean wall seconds of ``fn(*args, **kwargs)`` over ``iters`` calls
    after ``warmup`` ones.  Once the process uses a card, the card is
    synchronized before the clock starts and before it stops; otherwise
    ``perf_counter`` alone measures."""
    for _ in range(warmup):
        fn(*args, **kwargs)
    cuda = torch.cuda.is_initialized()
    if cuda:
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn(*args, **kwargs)
    if cuda:
        torch.cuda.synchronize()
    dt = (time.perf_counter() - t0) / iters
    return {"mean_s": dt, "iters_per_s": 1.0 / dt}


def device_memory_stats() -> Dict[str, Any]:
    """``torch.cuda.memory_stats`` of each visible card, by name
    ("cuda:0", ...); None for a card that reports none.  Empty without a
    card."""
    out = {}
    if not torch.cuda.is_available():
        return out
    for d in range(torch.cuda.device_count()):
        try:
            out[f"cuda:{d}"] = torch.cuda.memory_stats(d) or None
        except RuntimeError:
            out[f"cuda:{d}"] = None
    return out


def enable_persistent_compilation_cache(cache_dir: str) -> None:
    """Keep the kernels' builds in ``cache_dir`` instead of the package's
    ``csrc/build/``, so that repeated launches (sweeps, benches, resumed
    runs) reuse them.  Call it before the first kernel is built: a
    library already loaded stays where it was built."""
    from rlpyt_tpu_torch.ops import cuda_build

    cuda_build.BUILD_DIR = Path(cache_dir)
