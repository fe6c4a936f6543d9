"""Operations and bytes of the R2D1 trainers' work, from shapes alone.

The yardstick of the rooflines and of the MFU.  Every count follows from
a configuration's sizes and the calls its traffic makes, never from the
program's launch counters, so a later change that swaps or fuses kernels
is measured against the same work.

A ``Work`` holds matrix-product operations, elementwise operations and
bytes.  Its least time on one H100 (``bound_s``) is the largest of the
products at the rate of fp32-exact products on the tensor cores (three
TF32 products for each fp32 one), the elementwise operations at the
fp32 rate outside the tensor cores, and the bytes at the HBM rate: each
input byte read once and each output byte written once.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple, Sequence, Tuple

# NVIDIA H100 SXM data sheet, dense rates at the 700 W power limit.
FP32_PEAK = 67e12            # fp32 outside the tensor cores, FLOP/s
TF32_PEAK = 495e12           # TF32 on the tensor cores, FLOP/s
FP32_PRODUCT_PEAK = TF32_PEAK / 3   # fp32-exact products by 3 x TF32
HBM_BYTES_PER_S = 3.35e12
F32 = 4                      # bytes of a float32


class Work(NamedTuple):
    products: float = 0.0
    elementwise: float = 0.0
    bytes: float = 0.0


def bound_s(w: Work) -> float:
    """The least time the chip could take for ``w``."""
    return max(w.products / FP32_PRODUCT_PEAK, w.elementwise / FP32_PEAK,
               w.bytes / HBM_BYTES_PER_S)


# ----------------------------------------------------------------------
# The LSTM (gate order i, f, g, o; about 10 elementwise operations a
# unit and step forward, 20 backward).
# ----------------------------------------------------------------------

def lstm_step(B: int, H: int, F: int) -> Work:
    """One step at T = 1: the reset, x @ W_x + h @ W_h + b, the cell.
    In: W_x, W_h, b, x, the done mask, h, c; out: y, h, c."""
    return Work(
        products=2 * B * (F + H) * 4 * H,
        elementwise=10 * B * H + B * 4 * H,
        bytes=F32 * (F * 4 * H + H * 4 * H + 4 * H + B * F + B
                     + 2 * B * H + 3 * B * H))


def lstm_forward(T: int, B: int, H: int, F: int) -> Work:
    """A [T, B] window: the input projection and the recurrence.  In:
    W_x, W_h, b, x, the masks, h0, c0; out: y, hT, cT."""
    return Work(
        products=2 * T * B * (F + H) * 4 * H,
        elementwise=10 * T * B * H + T * B * 4 * H,
        bytes=F32 * (F * 4 * H + H * 4 * H + 4 * H + T * B * F + T * B
                     + 2 * B * H + T * B * H + 2 * B * H))


def lstm_backward(T: int, B: int, H: int, F: int,
                  input_grad: bool = True) -> Work:
    """The backward of a [T, B] window from the forward's saved gates and
    cells (no recomputation): the reverse recurrence, dW_x, dW_h, db and
    (``input_grad``) dx.  In: x, W_x, W_h, the masks, h0, c0, y, the
    gates, the cells, dy, dhT, dcT; out: dW_x, dW_h, db, dx, dh0, dc0."""
    products = 2 * T * B * 4 * H * H + 2 * T * B * F * 4 * H \
        + 2 * T * B * H * 4 * H
    if input_grad:
        products += 2 * T * B * 4 * H * F
    read = (T * B * F + F * 4 * H + H * 4 * H + T * B + 2 * B * H
            + T * B * H + T * B * 4 * H + T * B * H + T * B * H + 2 * B * H)
    written = F * 4 * H + H * 4 * H + 4 * H + 2 * B * H
    if input_grad:
        written += T * B * F
    return Work(products=products,
                elementwise=20 * T * B * H + T * B * 4 * H,
                bytes=F32 * (read + written))


# ----------------------------------------------------------------------
# The whole model: conv trunk, LSTM, (dueling) head.
# ----------------------------------------------------------------------

@dataclass(frozen=True)
class Geometry:
    image_shape: Tuple[int, int, int]
    n_actions: int
    channels: Sequence[int]
    kernel_sizes: Sequence[int]
    strides: Sequence[int]
    paddings: Sequence[int]
    lstm_size: int
    fc_sizes: Sequence[int]
    dueling: bool

    @staticmethod
    def from_config(model: dict, image_shape, n_actions: int) -> "Geometry":
        """The AtariR2d1Model geometry a config's ``model`` section gives
        (the Nature CNN, fc (512,) and dueling by default)."""
        return Geometry(
            tuple(image_shape), int(n_actions),
            tuple(model.get("channels", (32, 64, 64))),
            tuple(model.get("kernel_sizes", (8, 4, 3))),
            tuple(model.get("strides", (4, 2, 1))),
            tuple(model.get("paddings", (0, 1, 1))),
            int(model["lstm_size"]), tuple(model.get("fc_sizes", (512,))),
            bool(model.get("dueling", True)))

    def conv_layers(self):
        """(c_in, c_out, k, h_out, w_out) of each conv layer."""
        c, h, w = self.image_shape
        out = []
        for c_out, k, s, p in zip(self.channels, self.kernel_sizes,
                                  self.strides, self.paddings):
            h = (h + 2 * p - k) // s + 1
            w = (w + 2 * p - k) // s + 1
            out.append((c, c_out, k, h, w))
            c = c_out
        return out

    @property
    def lstm_input(self) -> int:
        """F: the conv features, the one-hot previous action and the
        previous reward."""
        _, c, _, h, w = self.conv_layers()[-1]
        return c * h * w + self.n_actions + 1

    def head_layers(self):
        """(n_in, n_out) of each dense layer of the head's streams."""
        layers = []
        streams = [self.n_actions, 1] if self.dueling else [self.n_actions]
        for n_out in streams:
            sizes = [self.lstm_size, *self.fc_sizes, n_out]
            layers += list(zip(sizes[:-1], sizes[1:]))
        return layers


def conv_flops(g: Geometry, frames: int) -> float:
    return sum(2 * frames * c_out * h * w * c_in * k * k
               for c_in, c_out, k, h, w in g.conv_layers())


def head_flops(g: Geometry, rows: int) -> float:
    return sum(2 * rows * a * b for a, b in g.head_layers())


def model_forward_flops(g: Geometry, T: int, B: int) -> float:
    """Products of one forward over [T, B] frames (T = 1: one step)."""
    H, F = g.lstm_size, g.lstm_input
    return (conv_flops(g, T * B) + head_flops(g, T * B)
            + lstm_forward(T, B, H, F).products)


def model_backward_flops(g: Geometry, T: int, B: int) -> float:
    """Products of the backward over [T, B] frames: two products a layer
    (input and weight gradients), one for the first conv (no gradient
    to the observation)."""
    H, F = g.lstm_size, g.lstm_input
    first = g.conv_layers()[0]
    c_in, c_out, k, h, w = first
    first_flops = 2 * T * B * c_out * h * w * c_in * k * k
    return (2 * conv_flops(g, T * B) - first_flops
            + 2 * head_flops(g, T * B)
            + lstm_backward(T, B, H, F, input_grad=True).products)


@dataclass(frozen=True)
class Iteration:
    """One training iteration: a [T, B] collection, then ``updates``
    R2D1 updates of ``batch_b`` windows of warmup_T + batch_T + n_step
    rows."""
    T: int
    B: int
    batch_b: int
    warmup_T: int
    batch_T: int
    n_step: int
    updates: int

    @staticmethod
    def from_config(config: dict, updates: int) -> "Iteration":
        a, s = config["algo"], config["sampler"]
        return Iteration(s["batch_T"], s["batch_B"], a["batch_b"],
                         a["warmup_T"], a["batch_T"], a["n_step_return"],
                         updates)


def collect_lstm_calls(g: Geometry, it: Iteration) -> list:
    """The collection's one-step LSTM calls: one a collection step."""
    return [lstm_step(it.B, g.lstm_size, g.lstm_input)] * it.T


def update_lstm_calls(g: Geometry, it: Iteration) -> list:
    """An update's LSTM calls: the burn-in and the window of the online
    and the target network, and the online window's backward."""
    H, F, b = g.lstm_size, g.lstm_input, it.batch_b
    window = it.batch_T + it.n_step
    calls = [lstm_forward(window, b, H, F)] * 2 + [lstm_backward(window, b,
                                                                 H, F)]
    if it.warmup_T:
        calls += [lstm_forward(it.warmup_T, b, H, F)] * 2
    return calls


def map_layer(size: int, reads: int) -> Work:
    """An elementwise layer over ``size`` values reading ``reads`` of
    them and writing one."""
    return Work(elementwise=size, bytes=F32 * (reads + 1) * size)


def trunk_calls(forward, backward, g, it: Iteration) -> list:
    """The layers of each trunk call of one iteration, from the trunk's
    ``forward(g, frames)`` and ``backward(g, frames)`` layer lists: a
    forward a collection step; in each update the online and the target
    network's forwards over the window and the burn-in, and the online
    window's backward."""
    window = (it.batch_T + it.n_step) * it.batch_b
    burn_in = it.warmup_T * it.batch_b
    update = [forward(g, window)] * 2 + [backward(g, window)]
    if burn_in:
        update += [forward(g, burn_in)] * 2
    return [forward(g, it.B)] * it.T + update * it.updates


def calls_bound_s(calls) -> float:
    """The least time of calls that run one after another."""
    return sum(bound_s(w) for w in calls)


def iteration_flops(g: Geometry, it: Iteration) -> float:
    """Model products of one iteration as the algorithm requires them,
    no recomputation: the collection's forward steps, the online and
    target forwards over whole windows (burn-in included) and the online
    window's backward, for each update."""
    collect = it.T * model_forward_flops(g, 1, it.B)
    window = it.batch_T + it.n_step
    forward = model_forward_flops(g, window, it.batch_b)
    if it.warmup_T:
        forward += model_forward_flops(g, it.warmup_T, it.batch_b)
    update = 2 * forward + model_backward_flops(g, window, it.batch_b)
    return collect + it.updates * update
