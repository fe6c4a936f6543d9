"""The cell of R2D1 on IMPALA's residual trunk (``atari_r2d1_resnet.
farm32``): found by name, correct in a small run on the CPU, its check
failing the controls, and its work counted over the model's own
layers."""
import time

import pytest
import torch
import torch.nn.functional as F
from torch.overrides import TorchFunctionMode

import check
import harness
import work
import work_conv
import work_resnet
from registry import Registry
from rlpyt_tpu_torch.models.dqn import AtariR2d1Model
from trainer import merge

CELL = "atari_r2d1_resnet.farm32"
REG = Registry()


# The Atari cell's small size with a narrow trunk: three sections of 4
# channels, two blocks each, 16 features.
NARROW = {"model": {"channels": (4, 4, 4), "blocks": 2, "feature_size": 16}}


def test_cell_found_by_name():
    cell = REG.cell(CELL)
    assert (cell["config"], cell["traffic"], cell["chips"]) == (
        "atari_r2d1_resnet", "farm32", 1)
    cfg = REG.config(cell["config"])
    assert cfg["port"]["config_key"] == "r2d1_resnet"
    family = REG.check(cfg["check"])
    assert {"Check", "Capture", "VARIANTS", "compare", "work_shapes"} <= set(
        vars(family))
    assert [m["name"] for m in REG.end_to_end(CELL)] == [
        "env_steps_per_s", "setup_s"]
    per_layer = [m["name"] for m in REG.per_layer(CELL)]
    assert {"device.mfu_pct", "ops.lstm_step_roofline",
            "ops.lstm_train_roofline", "models.trunk_roofline",
            "envs.farm_step_ms"} <= set(per_layer)


def test_small_run_is_correct(tiny_registry, tiny_atari):
    res = harness.run_cell(CELL, 5, 0.3, False, time.perf_counter(), "cpu",
                           tiny_registry, merge(tiny_atari, NARROW))
    assert res["correct"], res["checks"]
    assert res["failed"] == 0 and res["attempted"] > 0


@pytest.fixture(scope="module")
def prepared():
    from conftest import TINY_ATARI, TinyRegistry
    prep = harness.Prepared(TinyRegistry(), CELL, 4, "cpu",
                            merge(TINY_ATARI, NARROW))
    prep.release()
    return prep


@pytest.mark.parametrize("variant", ["control", "half_batch"])
def test_control_and_planted_fault_fail(prepared, variant):
    """The reference with TF32 products, or with half of the batch left
    out, in the program's place fails the limits; the program and the
    float64 witness pass them."""
    dev = torch.device("cpu")
    c = prepared.check
    refr = c.reference(dev)
    assert check.judge(c.compare(c.program(), refr, dev), prepared.limits)
    numbers = c.compare(c.reference(dev, variant), refr, dev)
    assert not check.judge(numbers, prepared.limits), numbers
    witness = c.compare(c.reference(dev, "fp64"), refr, dev)
    assert check.judge(witness, prepared.limits), witness


class _Layers(TorchFunctionMode):
    """Records (c_in, c_out, k, h_out, w_out) of each convolution and
    dense layer that runs under it, in order (the dense layer as 1 x 1),
    and (h_in, w_in) of each convolution's input."""

    def __init__(self):
        super().__init__()
        self.seen, self.inputs = [], []

    def __torch_function__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if func is F.conv2d:
            w = args[1]
            self.seen.append((w.shape[1], w.shape[0], w.shape[2],
                              out.shape[2], out.shape[3]))
            self.inputs.append(tuple(args[0].shape[2:]))
        elif func is F.linear:
            w = args[1]
            self.seen.append((w.shape[1], w.shape[0], 1, 1, 1))
        return out


def test_geometry_counts_the_models_layers():
    """At the published widths on 4 x 104 x 80 frames: the check's
    geometry lists the 15 convs and then the dense layer, each as the
    trunk's forward calls it, and ``work.conv_flops`` counts their
    products; F = 261."""
    cfg = REG.config("atari_r2d1_resnet")["config"]
    model = AtariR2d1Model((4, 104, 80), 4, **cfg["model"])
    with torch.no_grad(), _Layers() as layers:
        model.conv(torch.zeros((1, 4, 104, 80), dtype=torch.uint8))
    seen = layers.seen
    g = work_resnet.Geometry.from_config(cfg["model"], (4, 104, 80), 4)
    assert g.conv_layers() == seen
    assert len(seen) == 16
    products = sum(2 * c_out * h * w * c_in * k * k
                   for c_in, c_out, k, h, w in seen)
    assert work.conv_flops(g, 1) == products == 126_730_240
    assert g.lstm_input == 261 == model.lstm.wx.shape[0]


@pytest.mark.parametrize("g,trunk", [
    (work_resnet.Geometry((4, 104, 80), 4, (16, 32, 32), 2, 256, 256,
                          (512,), True), work_resnet),
    (work.Geometry((4, 104, 80), 4, (32, 64, 64), (8, 4, 3), (4, 2, 1),
                   (0, 1, 1), 512, (512,), True), work_conv)])
def test_trunk_layers_count_the_geometrys_products(g, trunk):
    """The trunk's layer-by-layer work (``work_resnet`` for the residual
    trunk, ``work_conv`` for the Nature CNN): the forward's products are
    ``work.conv_flops``; the backward's twice those less the first conv's
    input gradient; an iteration's calls are the collection's T forwards
    of B frames and, per update, two forwards over the burn-in and two
    over the window (online and target) and one backward over the
    window."""
    n = 3
    fwd = sum(w.products for _, w in trunk.trunk_forward(g, n))
    bwd = sum(w.products for _, w in trunk.trunk_backward(g, n))
    c_in, c_out, k, h, w = g.conv_layers()[0]
    assert fwd == work.conv_flops(g, n)
    assert bwd == 2 * fwd - 2 * n * c_out * h * w * c_in * k * k
    it = work.Iteration(T=40, B=32, batch_b=64, warmup_T=40, batch_T=80,
                        n_step=5, updates=1)
    calls = trunk.trunk_calls(g, it)
    products = sum(w.products for c in calls for _, w in c)
    window, burn_in = 85 * 64, 40 * 64
    backward = sum(w.products for _, w in trunk.trunk_backward(g, window))
    assert len(calls) == 40 + 5
    assert products == (40 * work.conv_flops(g, 32)
                        + 2 * work.conv_flops(g, window)
                        + 2 * work.conv_flops(g, burn_in) + backward)
    assert work_resnet.layers_bound_s(calls[-1]) == sum(
        work.bound_s(w) for _, w in calls[-1])


def test_nature_conv_shapes_follow_the_model():
    """``work_conv`` counts the Nature CNN of ``atari_r2d1`` over each
    conv's input and output as the model runs them on 4 x 104 x 80
    frames (its strided convs read more than they write)."""
    cfg = REG.config("atari_r2d1")["config"]
    model = AtariR2d1Model((4, 104, 80), 4, **cfg["model"])
    with torch.no_grad(), _Layers() as layers:
        model.conv(torch.zeros((1, 4, 104, 80), dtype=torch.uint8))
    g = work.Geometry.from_config(cfg["model"], (4, 104, 80), 4)
    assert work_conv.conv_shapes(g) == [
        (c_in, *hw_in, c_out, k, h, w)
        for (c_in, c_out, k, h, w), hw_in in zip(layers.seen, layers.inputs)]
    assert work_conv.conv_shapes(g)[0] == (4, 104, 80, 32, 8, 25, 19)
