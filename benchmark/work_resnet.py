"""Operations and bytes of the R2D1 model on IMPALA's deep residual trunk
(arXiv:1802.01561, Fig. 3 right), from shapes alone, as ``work.py``
counts the Nature CNN's.

``Geometry`` is what the metric readers count the model's work from:
its ``conv_layers()`` list the 15 convolutions, first conv first, and
the dense layer after them as a 1 x 1 layer, so that ``work.py``'s
``iteration_flops``, ``update_lstm_calls`` and ``collect_lstm_calls``
count this model unchanged.

``trunk_forward`` and ``trunk_backward`` give the trunk's work layer by
layer (each conv, pool, ReLU, residual add and the dense layer, its
input read once and its output written once), for a reader of the
trunk's share of its roofline: the least time of each layer's work
(``work.bound_s``), summed over the layers, which run one after another.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List, Sequence, Tuple

import work
from work import F32, Work, map_layer


def pooled(n: int) -> int:
    """A side after the 3x3, stride-2 max-pool at pad 1."""
    return (n + 2 - 3) // 2 + 1


@dataclass(frozen=True)
class Geometry:
    image_shape: Tuple[int, int, int]
    n_actions: int
    channels: Sequence[int]
    blocks: int
    feature_size: int
    lstm_size: int
    fc_sizes: Sequence[int]
    dueling: bool

    @staticmethod
    def from_config(model: dict, image_shape, n_actions: int) -> "Geometry":
        """The geometry of a config's ``model`` section (IMPALA's widths,
        fc (512,) and dueling by default)."""
        return Geometry(
            tuple(image_shape), int(n_actions),
            tuple(model.get("channels", (16, 32, 32))),
            int(model.get("blocks", 2)), int(model.get("feature_size", 256)),
            int(model["lstm_size"]), tuple(model.get("fc_sizes", (512,))),
            bool(model.get("dueling", True)))

    def sections(self):
        """(c_in, c_out, h, w, h_pooled, w_pooled) of each section: its
        conv's input channels, its channels, the conv's output size and
        the pool's."""
        c, h, w = self.image_shape
        out = []
        for c_out in self.channels:
            out.append((c, c_out, h, w, pooled(h), pooled(w)))
            c, h, w = c_out, pooled(h), pooled(w)
        return out

    @property
    def flat_size(self) -> int:
        """The features the dense layer takes."""
        _, c, _, _, h, w = self.sections()[-1]
        return c * h * w

    def conv_layers(self):
        """(c_in, c_out, k, h_out, w_out) of each conv in the order they
        run, then the dense layer as (flat_size, feature_size, 1, 1, 1)."""
        out = []
        for c_in, c, h, w, hp, wp in self.sections():
            out.append((c_in, c, 3, h, w))
            out += [(c, c, 3, hp, wp)] * (2 * self.blocks)
        out.append((self.flat_size, self.feature_size, 1, 1, 1))
        return out

    @property
    def lstm_input(self) -> int:
        """F: the features, the one-hot previous action and the previous
        reward."""
        return self.feature_size + self.n_actions + 1

    head_layers = work.Geometry.head_layers


def _conv(n, c_in, c_out, k, h, w) -> Work:
    out = n * c_out * h * w
    return Work(products=2 * out * c_in * k * k, elementwise=out,
                bytes=F32 * (n * c_in * h * w + c_out * c_in * k * k
                             + c_out + out))


def _conv_bwd(n, c_in, c_out, k, h, w, input_grad) -> Work:
    """dW and db (and dx where ``input_grad``) from dy and the input."""
    out = n * c_out * h * w
    products = 2 * out * c_in * k * k * (2 if input_grad else 1)
    written = c_out * c_in * k * k + c_out \
        + (n * c_in * h * w if input_grad else 0)
    return Work(products=products, elementwise=out,
                bytes=F32 * (out + n * c_in * h * w + c_out * c_in * k * k
                             + written))


def trunk_forward(g: Geometry, n: int) -> List[Tuple[str, Work]]:
    """The forward's layers over ``n`` frames: the uint8 frames scaled,
    then each section's conv and pool and its blocks' ReLU, conv, ReLU,
    conv and add, then ReLU, the dense layer and ReLU."""
    c, h, w = g.image_shape
    layers = [("scale", Work(elementwise=n * c * h * w,
                             bytes=(1 + F32) * n * c * h * w))]
    for i, (c_in, c, h, w, hp, wp) in enumerate(g.sections()):
        layers.append((f"s{i}.conv", _conv(n, c_in, c, 3, h, w)))
        layers.append((f"s{i}.pool", Work(
            elementwise=9 * n * c * hp * wp,
            bytes=F32 * n * c * (h * w + hp * wp))))
        size = n * c * hp * wp
        for j in range(g.blocks):
            for k in range(2):
                layers.append((f"s{i}.b{j}.relu{k}", map_layer(size, 1)))
                layers.append((f"s{i}.b{j}.conv{k}",
                               _conv(n, c, c, 3, hp, wp)))
            layers.append((f"s{i}.b{j}.add", map_layer(size, 2)))
    flat, f = g.flat_size, g.feature_size
    layers.append(("relu", map_layer(n * flat, 1)))
    layers.append(("fc", _conv(n, flat, f, 1, 1, 1)))
    layers.append(("fc.relu", map_layer(n * f, 1)))
    return layers


def trunk_backward(g: Geometry, n: int) -> List[Tuple[str, Work]]:
    """The backward's layers over ``n`` frames, in the order they run:
    each ReLU's gradient from its output and dy, each conv's dW, db and
    dx (no dx of the first: the frames take no gradient), each pool's dx
    from dy and its input, and at each block's input the skip's gradient
    added to the branch's; no recomputation."""
    flat, f = g.flat_size, g.feature_size
    layers = [("fc.relu", map_layer(n * f, 2)),
              ("fc", _conv_bwd(n, flat, f, 1, 1, 1, True)),
              ("relu", map_layer(n * flat, 2))]
    for i, (c_in, c, h, w, hp, wp) in reversed(list(enumerate(
            g.sections()))):
        size = n * c * hp * wp
        for j in reversed(range(g.blocks)):
            for k in (1, 0):
                layers.append((f"s{i}.b{j}.conv{k}",
                               _conv_bwd(n, c, c, 3, hp, wp, True)))
                layers.append((f"s{i}.b{j}.relu{k}", map_layer(size, 2)))
            layers.append((f"s{i}.b{j}.add", map_layer(size, 2)))
        layers.append((f"s{i}.pool", Work(
            elementwise=n * c * h * w,
            bytes=F32 * n * c * (hp * wp + 2 * h * w))))
        layers.append((f"s{i}.conv", _conv_bwd(n, c_in, c, 3, h, w, i > 0)))
    return layers


def layers_bound_s(layers) -> float:
    """The least time of layers that run one after another."""
    return sum(work.bound_s(w) for _, w in layers)


def trunk_calls(g: Geometry, it: work.Iteration) -> list:
    """The layers of each trunk call of one iteration
    (``work.trunk_calls``)."""
    return work.trunk_calls(trunk_forward, trunk_backward, g, it)
