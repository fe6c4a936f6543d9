"""CUDA graph capture that Python's garbage collector cannot break.

A ``CUDAGraph`` left in a reference cycle (an algorithm and the graphs
that hold it, a collector and its step graph) is freed by the cyclic
collector, whenever an allocation sets it off.  Freed inside another
graph's capture, it destroys its executable there, which CUDA forbids
while a stream captures: the capture fails with
``cudaErrorStreamCaptureInvalidated``.  ``capture`` keeps the collector
off for the capture; whatever it would have freed waits until after.
"""
from __future__ import annotations

import gc
from contextlib import contextmanager

import torch


@contextmanager
def capture(graph: "torch.cuda.CUDAGraph", **kwargs):
    """``torch.cuda.graph(graph, **kwargs)`` with the cyclic garbage
    collector off inside."""
    enabled = gc.isenabled()
    gc.disable()
    try:
        with torch.cuda.graph(graph, **kwargs):
            yield
    finally:
        if enabled:
            gc.enable()
