"""Two ways to time a launch on a CUDA device, shared by ``chip_smoke.py``
and the ``bench_torch_*.py`` scripts.

``time_ms`` gives what a caller pays for one Python call in a back-to-back
loop, host work included; ``graph_ms`` gives the device time of one launch
with the host taken out.  Both read CUDA events.
"""
from __future__ import annotations

import torch


def time_ms(fn, iters: int = 50) -> float:
    """Mean time of one ``fn()`` in ms over ``iters`` back-to-back calls,
    by CUDA events, after a warm-up of three calls."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    e0.record()
    for _ in range(iters):
        fn()
    e1.record()
    e1.synchronize()
    return e0.elapsed_time(e1) / iters


def graph_ms(calls, replays: int = 5) -> float:
    """Device time of one launch in ms with the host taken out: ``calls``
    (functions of no argument, one launch each) are captured once into a
    CUDA graph, the graph is replayed ``replays`` times between two
    events, and the time is divided by the launches replayed."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):    # warm up off the capture
        for call in calls[:3]:
            call()
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for call in calls:
            call()
    graph.replay()
    torch.cuda.synchronize()
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    e0.record()
    for _ in range(replays):
        graph.replay()
    e1.record()
    e1.synchronize()
    return e0.elapsed_time(e1) / (replays * len(calls))
