"""R2D1's update as CUDA graph pieces around the eager LSTM core.

On a card (``update_graphable``) ``R2D1.update`` replays CUDA graphs for
all of its device work but:

- each call of the online and the target network's ``lstm`` (burn-in and
  window), through the module's ``__call__``, so that whatever wraps its
  ``forward`` sees every call and its backward;
- the priority write-back (``replay.update_priorities``), which
  reassigns the replay's ``max_priority``;
- the host counters and the target copy (an in-place copy into the
  target's parameters, whose addresses the graphs keep), the gradients'
  ``zero_grad`` and the batch's copy into the static inputs.

The pieces, in the order an update runs them:

1. ``burn_in``: the shifted dones and both networks' LSTM inputs over
   the burn-in (trunk, flattening, one-hot previous action, previous
   reward);
2. eager: both networks' burn-in LSTM, no gradient;
3. ``window``: the burn-in's Q-values (the eager forward computes them
   and the loss discards them), both networks' LSTM inputs over the
   window; a gradient for the online trunk;
4. eager: both networks' window LSTM, the online one with a gradient;
5. ``tail``: both heads over the window, then ``R2D1.td_loss``:
   double-DQN selection, n-step returns, h and h^-1, the loss and the
   sequence priorities; a gradient for the online head and the LSTM's
   output;
6. ``loss.backward()``: ``tail``'s backward graph, the LSTM's eager
   backward (K4), ``window``'s backward graph (each graphed piece is one
   autograd node, ``_Replay``);
7. ``step``: the clip and Adam (``Optimizer.apply``).

The graphs read and write static tensors: the batch, the inputs copied
in from the eager LSTM calls, the parameters, their ``.grad`` and Adam's
moments.  They are captured once an update has run eagerly (it creates
Adam's moments and loads every kernel), in the order they replay, into
one memory pool, on a side stream, after one warm-up run of the forward
and backward pieces whose cached blocks are freed before the capture.
Neither advances the run: both read the parameters and write only the
pieces' own tensors.  The graphed update gives the eager update's
numbers bit for bit.

The bodies' spans and counts are recorded at the capture alone, so the
trunk's (``AtariR2d1Model``: span ``model.trunk``, its backward
``model.trunk_bwd``, counter ``model.trunk`` by (gradient on, frames))
are recorded around the replays that run it: ``burn_in``'s and
``window``'s forward and ``window``'s backward, each span holding the
whole piece, the trunk and the LSTM input's assembly (``window``'s also
the burn-in's heads), and the counter counting the trunk calls inside.
"""
from __future__ import annotations

from contextlib import nullcontext
from typing import Callable, Optional, Tuple

import torch
from torch.autograd.function import once_differentiable

from rlpyt_tpu_torch.models.dqn import AtariR2d1Model
from rlpyt_tpu_torch.parallel.mesh import is_sharded
from rlpyt_tpu_torch.struct import restore_leading_dims, tree_map
from rlpyt_tpu_torch.utils import cuda_graphs
from rlpyt_tpu_torch.utils.profiling import count, paused, span


def update_graphable(device, shard, params) -> bool:
    """Whether ``R2D1.update`` replays CUDA graphs: the model is on a
    card, no data-parallel ``shard`` sums its gradients over ranks and no
    parameter is split over 'mp' (either puts collectives in the
    update)."""
    return (torch.device(device).type == "cuda" and shard is None
            and not any(is_sharded(p) for p in params))


class _Capturer:
    """Warm-up and capture on a side stream of ``device``, every graph in
    one memory pool; ``close`` joins the side stream to the current one.
    The captures are thread-local, as other threads may use the card
    meanwhile (an asynchronous runner's sampler)."""

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

    def capture(self, body: Callable[[], None]) -> Callable[[], None]:
        """``body`` as a CUDA graph: the graph's replay."""
        graph = torch.cuda.CUDAGraph()
        with cuda_graphs.capture(graph, pool=self.pool, stream=self.side,
                                 capture_error_mode="thread_local"):
            body()
        return graph.replay

    def close(self):
        self.main.wait_stream(self.side)


class _Piece:
    """``fn(*inputs)`` over static tensors, replayed from a CUDA graph.

    ``inputs`` take a live tensor's value before each replay (``load``);
    those that require a gradient, and ``params``, are the leaves of the
    piece's gradient.  A piece with leaves has a second graph, the
    gradient of its differentiable outputs (``differentiable`` says
    which; from ``grad_outs``) to its leaves (``grads``), which
    ``_Replay``'s backward replays.  ``outs`` and ``grads`` are the
    graphs' static outputs: the next replay overwrites them.  ``outs``
    hold no autograd graph: the forward's graph lives until the backward
    has run (or been captured), so no node of it outlives the capture.
    The bodies run with the recorder paused: their Python runs at the
    capture alone.  Each replay of the forward (``play``) runs in span
    ``spans[0]`` and counts ``counts`` ((name, key, n) each), each replay
    of the backward (``play_backward``) in span ``spans[1]``."""

    def __init__(self, fn, inputs=(), params=(),
                 spans: Tuple[Optional[str], Optional[str]] = (None, None),
                 counts=()):
        self.fn, self.inputs, self.params = fn, tuple(inputs), tuple(params)
        self.spans, self.counts = spans, tuple(counts)
        self.leaves = [x for x in self.inputs + self.params
                       if x.requires_grad]
        self.outs = self.grads = self._graph = None
        self.differentiable, self.grad_outs = [], []
        self.replay = self.replay_backward = None

    def forward(self):
        with paused(), torch.set_grad_enabled(bool(self.leaves)):
            outs = self.fn(*self.inputs)
        outs = outs if isinstance(outs, tuple) else (outs,)
        self.differentiable = [o.requires_grad for o in outs]
        self._graph = [o for o in outs if o.requires_grad]
        self.outs = tuple(o.detach() for o in outs)

    def backward(self):
        with paused():
            self.grads = torch.autograd.grad(self._graph, self.leaves,
                                             self.grad_outs,
                                             allow_unused=True)
        self._graph = None

    def load(self, live):
        for x, v in zip(self.inputs, live):
            if x.data_ptr() != v.data_ptr():
                x.copy_(v)

    def play(self):
        for name, key, n in self.counts:
            count(name, key, n)
        with span(self.spans[0]) if self.spans[0] else nullcontext():
            self.replay()

    def play_backward(self):
        with span(self.spans[1]) if self.spans[1] else nullcontext():
            self.replay_backward()


class _Replay(torch.autograd.Function):
    """One replay of a piece's forward as one autograd node, whose
    backward replays the piece's backward graph.  Arguments: the piece,
    the live values of its ``inputs``, its ``params``."""

    @staticmethod
    def forward(ctx, piece, *args):
        piece.load(args[:len(piece.inputs)])
        piece.play()
        ctx.piece = piece
        ctx.set_materialize_grads(False)
        outs = tuple(o.detach() for o in piece.outs)
        ctx.mark_non_differentiable(*(
            o for o, d in zip(outs, piece.differentiable) if not d))
        return outs

    @staticmethod
    @once_differentiable
    def backward(ctx, *grads):
        piece = ctx.piece
        diff = [g for g, d in zip(grads, piece.differentiable) if d]
        for s, g in zip(piece.grad_outs, diff):
            if g is None:
                s.zero_()
            elif g.data_ptr() != s.data_ptr():
                s.copy_(g)
        piece.play_backward()
        leaf_grads = iter(piece.grads)
        return (None,) + tuple(next(leaf_grads) if x.requires_grad else None
                               for x in piece.inputs + piece.params)


def _graphed(batch):
    """The leaves of a window batch that the graphs read."""
    return batch._replace(init_rnn_state=None, slots=None)


class UpdateGraphs:
    """The graph pieces of an R2D1 algorithm's update, captured at
    construction with ``batch`` (one of the replay's window batches)
    loaded.  ``loss(batch)`` stands for ``R2D1.loss``, ``apply`` for the
    optimizer's ``apply``."""

    def __init__(self, algo, batch):
        self.algo = algo
        wT, rows = algo.warmup_T, algo.batch_T + algo.n_step
        self.batch = tree_map(torch.clone, _graphed(batch))
        b = batch.reward.shape[1]
        H = algo.model.lstm.hidden_size
        dev = batch.reward.device

        def y(T: int, grad: bool = False):
            return torch.zeros((T, b, H), device=dev, requires_grad=grad)

        params = tuple(algo.model.parameters())
        # The trunk's spans and counts, which the bodies record at the
        # capture alone.
        trunk = isinstance(algo.model, AtariR2d1Model)
        spans = ("model.trunk", "model.trunk_bwd") if trunk else (None, None)
        self.burn_in = _Piece(
            self._burn_in, spans=spans if wT else (None, None),
            counts=[("model.trunk", (False, wT * b), 2)] if trunk and wT
            else ())
        self.window = _Piece(
            self._window, (y(wT), y(wT)) if wT else (), params, spans,
            [("model.trunk", (grad, rows * b), 1) for grad in (True, False)]
            if trunk else ())
        self.tail = _Piece(self._tail, (y(rows, True), y(rows)), params)
        self.step = _Piece(algo.optimizer.apply)
        self._capture(dev)

    def _capture(self, device):
        pieces = (self.burn_in, self.window, self.tail)
        differentiable = [p for p in reversed(pieces) if p.leaves]
        cap = _Capturer(device)

        def forward():
            for p in pieces:
                p.forward()

        cap.warm(forward)
        # On the current stream, where the backward replays read them.
        for p in differentiable:
            p.grad_outs = [torch.zeros_like(o) for o in p._graph]

        def backward():
            for p in differentiable:
                p.backward()
            for p in pieces:
                p.outs = p.grads = None

        cap.warm(backward)
        for p in pieces:
            p.replay = cap.capture(p.forward)
        for p in differentiable:
            p.replay_backward = cap.capture(p.backward)
        self.step.replay = cap.capture(self.step.forward)
        cap.close()

    def _frames(self, lo: int, hi: int):
        b = self.batch
        return (b.observation[lo:hi], b.prev_action[lo:hi],
                b.prev_reward[lo:hi])

    def _rows(self):
        """The burn-in's length and the whole window's."""
        a = self.algo
        return a.warmup_T, a.warmup_T + a.batch_T + a.n_step

    def _burn_in(self):
        algo, (wT, W) = self.algo, self._rows()
        shifted = algo.shifted_done(self.batch.done)
        outs = (shifted[:wT], shifted[wT:W])
        if wT > 0:
            outs += tuple(net.lstm_input(*self._frames(0, wT))
                          for net in (algo.model, algo.target_model))
        return outs

    def _window(self, *burn_in_y):
        algo, frames = self.algo, self._frames(*self._rows())
        with torch.no_grad():
            for net, y in zip((algo.model, algo.target_model), burn_in_y):
                net.head(y.flatten(0, 1))
            x_target = algo.target_model.lstm_input(*frames)
        return algo.model.lstm_input(*frames), x_target

    def _tail(self, y, y_target):
        algo = self.algo
        T, b = y.shape[:2]
        q = restore_leading_dims(algo.model.head(y.flatten(0, 1)), 2, T, b)
        with torch.no_grad():
            qt = restore_leading_dims(
                algo.target_model.head(y_target.flatten(0, 1)), 2, T, b)
        return algo.td_loss(self.batch, q, qt)

    def loss(self, batch):
        """``R2D1.loss(batch)``: (loss, priorities), the loss a node of
        the autograd graph."""
        algo = self.algo
        model, target_model = algo.model, algo.target_model
        tree_map(lambda d, x: d.copy_(x), self.batch, _graphed(batch))
        self.burn_in.play()
        done_burn_in, done_window, *burn_in_x = self.burn_in.outs
        online = target = algo.initial_state(batch)
        burn_in_y = ()
        if burn_in_x:
            with torch.no_grad():
                y, online = model.lstm(burn_in_x[0], done_burn_in, online)
                y_target, target = target_model.lstm(burn_in_x[1],
                                                     done_burn_in, target)
            burn_in_y = (y, y_target)
        x, x_target = _Replay.apply(self.window, *burn_in_y,
                                    *self.window.params)
        y, _ = model.lstm(x, done_window, online)
        with torch.no_grad():
            y_target, _ = target_model.lstm(x_target, done_window, target)
        return _Replay.apply(self.tail, y, y_target, *self.tail.params)

    def apply(self) -> torch.Tensor:
        """The optimizer's ``apply()``: the gradients' norm, a static
        tensor."""
        self.step.replay()
        return self.step.outs[0]
