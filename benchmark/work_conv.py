"""Operations and bytes of the Nature CNN trunk of the Atari R2D1 model
(``work.Geometry``'s conv layers), layer by layer, as ``work_resnet.py``
counts IMPALA's residual trunk: for a reader of the trunk's share of its
roofline, the least time of each layer's work (``work.bound_s``), summed
over the layers, which run one after another.  Each layer's input is
read once and its output written once.
"""
from __future__ import annotations

from typing import List, Tuple

import work
from work import F32, Work, map_layer


def conv_shapes(g: work.Geometry):
    """(c_in, h_in, w_in, c_out, k, h_out, w_out) of each conv layer."""
    _, h, w = g.image_shape
    out = []
    for c_in, c_out, k, h_out, w_out in g.conv_layers():
        out.append((c_in, h, w, c_out, k, h_out, w_out))
        h, w = h_out, w_out
    return out


def _conv(n, c_in, h_in, w_in, c_out, k, h, w) -> Work:
    out = n * c_out * h * w
    return Work(products=2 * out * c_in * k * k, elementwise=out,
                bytes=F32 * (n * c_in * h_in * w_in + c_out * c_in * k * k
                             + c_out + out))


def _conv_bwd(n, c_in, h_in, w_in, c_out, k, h, w, input_grad) -> Work:
    """dW and db (and dx where ``input_grad``) from dy and the input."""
    out = n * c_out * h * w
    x = n * c_in * h_in * w_in
    products = 2 * out * c_in * k * k * (2 if input_grad else 1)
    written = c_out * c_in * k * k + c_out + (x if input_grad else 0)
    return Work(products=products, elementwise=out,
                bytes=F32 * (out + x + c_out * c_in * k * k + written))


def trunk_forward(g: work.Geometry, n: int) -> List[Tuple[str, Work]]:
    """The forward's layers over ``n`` frames: the uint8 frames cast and
    scaled, then each conv and its ReLU."""
    c, h, w = g.image_shape
    layers = [("scale", Work(elementwise=n * c * h * w,
                             bytes=(1 + F32) * n * c * h * w))]
    for i, shape in enumerate(conv_shapes(g)):
        c_out, h_out, w_out = shape[3], shape[5], shape[6]
        layers.append((f"conv{i}", _conv(n, *shape)))
        layers.append((f"relu{i}", map_layer(n * c_out * h_out * w_out, 1)))
    return layers


def trunk_backward(g: work.Geometry, n: int) -> List[Tuple[str, Work]]:
    """The backward's layers over ``n`` frames, in the order they run:
    each ReLU's gradient from its output and dy, then its conv's dW, db
    and dx (no dx of the first: the frames take no gradient); no
    recomputation."""
    layers = []
    for i, shape in reversed(list(enumerate(conv_shapes(g)))):
        c_out, h_out, w_out = shape[3], shape[5], shape[6]
        layers.append((f"relu{i}", map_layer(n * c_out * h_out * w_out, 2)))
        layers.append((f"conv{i}", _conv_bwd(n, *shape, input_grad=i > 0)))
    return layers


def trunk_calls(g: work.Geometry, it: work.Iteration) -> list:
    """The layers of each trunk call of one iteration
    (``work.trunk_calls``)."""
    return work.trunk_calls(trunk_forward, trunk_backward, g, it)
