"""An eager stand-in for the port's one capture protocol
(``rlpyt_tpu_torch/utils/cuda_graphs.py:Capturer``), for the CPU tests of
its CUDA graphs (``test_torch_collector_graph.py``,
``test_torch_r2d1_graph.py``): the warm-up runs, and each "graph" is its
body, run at each replay."""
from rlpyt_tpu_torch.utils import cuda_graphs


class EagerCapturer:
    """``cuda_graphs.Capturer`` without a card: no stream, no pool, no
    graph."""

    def __init__(self, device):
        pass

    def warm(self, fn):
        fn()

    def capture(self, body, generators=()):
        return body

    def close(self):
        pass


def eager_graphs(monkeypatch):
    """Every capture of the port through ``EagerCapturer``, for one
    test."""
    monkeypatch.setattr(cuda_graphs, "Capturer", EagerCapturer)
