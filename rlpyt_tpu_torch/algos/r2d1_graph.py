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
Adam's moments and loads every kernel), in the order they replay, by one
``utils/cuda_graphs.py:Capturer``, after one warm-up run of the forward
and backward pieces.  Neither advances the run: both read the parameters
and write only the pieces' own tensors.  The graphed update gives the
eager update's numbers bit for bit.

A piece's Python runs at the warm-up and the capture alone, so whatever
the model records of it (``utils/profiling.py``) is learned at the
warm-up and recorded again at each replay: the counts the body made, and
spans of the names of its root spans, around the whole replay (the
model's work and the rest of the piece).
"""
from __future__ import annotations

import threading
from contextlib import ExitStack, contextmanager, nullcontext

import torch
from torch.autograd.function import once_differentiable

from rlpyt_tpu_torch.parallel.mesh import is_sharded
from rlpyt_tpu_torch.struct import restore_leading_dims, tree_map
from rlpyt_tpu_torch.utils import cuda_graphs, profiling
from rlpyt_tpu_torch.utils.profiling import count, paused, span


def update_graphable(device, shard, params) -> bool:
    """Whether ``R2D1.update`` replays CUDA graphs: the model is on a
    card, no data-parallel ``shard`` sums its gradients over ranks and no
    parameter is split over 'mp' (either puts collectives in the
    update)."""
    return (torch.device(device).type == "cuda" and shard is None
            and not any(is_sharded(p) for p in params))


class _Listener(profiling.Recorder):
    """The recorder of a piece's warm-up: it hears the calling thread and
    the autograd engine's own threads (which run a card's backward), no
    other thread of the program (an asynchronous runner's actor), and
    opens no profiler range."""

    def __init__(self):
        super().__init__()
        self._owner = threading.get_ident()
        self._profiler_enabled = lambda: False

    def _hears(self) -> bool:
        # A thread that Python did not start (the engine's) is a dummy.
        return (threading.get_ident() == self._owner
                or isinstance(threading.current_thread(),
                              threading._DummyThread))

    def span(self, name: str):
        return super().span(name) if self._hears() else nullcontext()

    def count(self, name: str, key=None, n: int = 1):
        if self._hears():
            super().count(name, key, n)


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
    A body's first run (the warm-up) is under a ``_Listener``, which
    learns what it records (``heard``: its root spans' names, its
    counts); later runs (the capture) record nothing.  Each replay of the
    forward (``play``) or the backward (``play_backward``) adds that
    body's counts and runs in spans of those names."""

    def __init__(self, fn, inputs=(), params=()):
        self.fn, self.inputs, self.params = fn, tuple(inputs), tuple(params)
        self.leaves = [x for x in self.inputs + self.params
                       if x.requires_grad]
        self.outs = self.grads = self._graph = None
        self.differentiable, self.grad_outs = [], []
        self.replay = self.replay_backward = None
        self.heard = {}

    @contextmanager
    def _listening(self, phase: str):
        """A body's run of ``phase`` ("forward" or "backward"), paused;
        the first under a listener (yields whether it listens)."""
        with paused():
            if phase in self.heard:
                yield False
                return
            rec = profiling.start(_Listener())
            yield True
        self.heard[phase] = (
            list(dict.fromkeys(r.name for r in rec.spans()
                               if r.parent is None)), rec.counts)

    def _play(self, phase: str, replay):
        names, counts = self.heard[phase]
        for name, by_key in counts.items():
            for key, n in by_key.items():
                count(name, key, n)
        with ExitStack() as stack:
            for name in names:
                stack.enter_context(span(name))
            replay()

    def forward(self):
        with self._listening("forward"), \
                torch.set_grad_enabled(bool(self.leaves)):
            outs = self.fn(*self.inputs)
        outs = outs if isinstance(outs, tuple) else (outs,)
        self.differentiable = [o.requires_grad for o in outs]
        self._graph = [o for o in outs if o.requires_grad]
        self.outs = tuple(o.detach() for o in outs)

    def backward(self):
        with self._listening("backward") as warm_up:
            if not warm_up:
                self.grads = torch.autograd.grad(self._graph, self.leaves,
                                                 self.grad_outs,
                                                 allow_unused=True)
            else:
                # What the model records of a backward may close on hooks
                # of its leaves, which ``autograd.grad`` cannot run: the
                # warm-up accumulates into ``.grad``, set aside meanwhile.
                kept = [x.grad for x in self.leaves]
                for x in self.leaves:
                    x.grad = None
                torch.autograd.backward(self._graph, self.grad_outs,
                                        inputs=self.leaves)
                for x, g in zip(self.leaves, kept):
                    x.grad = g
        self._graph = None

    def load(self, live):
        for x, v in zip(self.inputs, live):
            if x.data_ptr() != v.data_ptr():
                x.copy_(v)

    def play(self):
        self._play("forward", self.replay)

    def play_backward(self):
        self._play("backward", self.replay_backward)


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
        self.burn_in = _Piece(self._burn_in)
        self.window = _Piece(self._window, (y(wT), y(wT)) if wT else (),
                             params)
        self.tail = _Piece(self._tail, (y(rows, True), y(rows)), params)
        self.step = _Piece(algo.optimizer.apply)
        self._capture(dev)

    def _capture(self, device):
        pieces = (self.burn_in, self.window, self.tail)
        differentiable = [p for p in reversed(pieces) if p.leaves]
        cap = cuda_graphs.Capturer(device)

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
