"""The port's one protocol for capturing CUDA graphs (``Capturer``), used
by the device collector's step (``samplers/rollout.py``) and R2D1's
update pieces (``algos/r2d1_graph.py``).

The cyclic garbage collector is off inside each capture.  A
``CUDAGraph`` left in a reference cycle (an algorithm and its graphs, a
collector and its step graph) is freed by the collector whenever an
allocation sets it off; freed inside another graph's capture, it
destroys its executable there, which CUDA forbids while a stream
captures (``cudaErrorStreamCaptureInvalidated``).
"""
from __future__ import annotations

import gc
from typing import Callable, Sequence

import torch


class Capturer:
    """Warm-ups and captures on a side stream of ``device`` that waits on
    the current stream's work, every graph in one memory pool, each
    capture thread-local (other threads may use the card meanwhile: an
    asynchronous runner's actor or learner, NCCL's); ``close`` joins the
    side stream to the current one."""

    def __init__(self, device):
        self.device = device
        self.main = torch.cuda.current_stream(device)
        self.side = torch.cuda.Stream(device)
        self.side.wait_stream(self.main)
        self.pool = torch.cuda.graph_pool_handle()

    def warm(self, fn: Callable[[], None]):
        """``fn`` on the side stream, after the current stream's work,
        then its cached blocks freed."""
        self.side.wait_stream(self.main)
        with torch.cuda.stream(self.side):
            fn()
        torch.cuda.synchronize(self.device)
        torch.cuda.empty_cache()

    def capture(self, body: Callable[[], None],
                generators: Sequence[torch.Generator] = ()
                ) -> Callable[[], None]:
        """``body`` as a CUDA graph that draws from ``generators`` (each
        replay at the offsets the eager ops would draw at), the cyclic
        garbage collector off meanwhile: the graph's replay."""
        graph = torch.cuda.CUDAGraph()
        for g in generators:
            graph.register_generator_state(g)
        enabled = gc.isenabled()
        gc.disable()
        try:
            with torch.cuda.graph(graph, pool=self.pool, stream=self.side,
                                  capture_error_mode="thread_local"):
                body()
        finally:
            if enabled:
                gc.enable()
        return graph.replay

    def close(self):
        self.main.wait_stream(self.side)
