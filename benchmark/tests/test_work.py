"""The work counts of ``work.py`` pinned at one shape, against the
arithmetic written out."""
import pytest

import work

# MinAtar R2D1: conv 16 3x3 on [4, 10, 10] -> 16 x 8 x 8 = 1024
# features; with 6 actions F = 1024 + 6 + 1 = 1031; H = 128, dueling
# heads of 128.
MINATAR = work.Geometry((4, 10, 10), 6, (16,), (3,), (1,), (0,), 128,
                        (128,), True)
# Atari R2D1: the Nature CNN on [4, 104, 80] -> 64 x 12 x 9 = 6912;
# FakeALE's 4 actions, F = 6917; H = 512.
ATARI = work.Geometry((4, 104, 80), 4, (32, 64, 64), (8, 4, 3), (4, 2, 1),
                      (0, 1, 1), 512, (512,), True)


def test_lstm_input_sizes():
    assert MINATAR.lstm_input == 1031
    assert ATARI.lstm_input == 6917


def test_one_step_lstm():
    B, H, F = 64, 128, 1031
    w = work.lstm_step(B, H, F)
    assert w.products == 2 * 64 * (1031 + 128) * 512 == 75_956_224
    assert w.bytes == 4 * (1031 * 512 + 128 * 512 + 512 + 64 * 1031 + 64
                           + 5 * 64 * 128)
    # Bytes bound it: W_x and W_h dominate.
    assert work.bound_s(w) == pytest.approx(w.bytes / 3.35e12)


def test_window_forward_and_backward():
    T, B, H, F = 85, 32, 512, 6917
    fwd = work.lstm_forward(T, B, H, F)
    assert fwd.products == 2 * 85 * 32 * (6917 + 512) * 2048
    bwd = work.lstm_backward(T, B, H, F)
    # dgates @ W_h^T, dW_x, dW_h, dx: 2 T B 4H (H + F + H + F)
    assert bwd.products == 2 * 85 * 32 * 2048 * (512 + 6917 + 512 + 6917)
    assert work.bound_s(bwd) == pytest.approx(bwd.products / (495e12 / 3))


def test_conv_trunk_and_head():
    # conv1 32x25x19 outputs of 4*8*8 MACs, conv2 64x12x9 of 32*4*4,
    # conv3 64x12x9 of 64*3*3: per frame
    per_frame = 2 * (32 * 25 * 19 * 256 + 64 * 12 * 9 * 512
                     + 64 * 12 * 9 * 576)
    assert work.conv_flops(ATARI, 1) == per_frame == 22_822_912
    # dueling: 512 -> 512 -> 4 and 512 -> 512 -> 1
    assert work.head_flops(ATARI, 1) == 2 * (512 * 512 * 2 + 512 * 5)
    assert work.conv_flops(MINATAR, 1) == 2 * 16 * 8 * 8 * 4 * 9
    # dueling: 128 -> 128 -> 6 and 128 -> 128 -> 1
    assert work.head_flops(MINATAR, 1) == 2 * (128 * 128 * 2 + 128 * 7)


def test_iteration_flops_minatar_lanes256():
    it = work.Iteration(T=40, B=256, batch_b=64, warmup_T=40, batch_T=80,
                        n_step=5, updates=8)
    g = MINATAR
    step = (work.conv_flops(g, 256) + work.head_flops(g, 256)
            + 2 * 256 * 1159 * 512)
    window = work.model_forward_flops(g, 85, 64)
    burn = work.model_forward_flops(g, 40, 64)
    first_conv = 2 * 85 * 64 * 16 * 8 * 8 * 4 * 9
    backward = (2 * work.conv_flops(g, 85 * 64) - first_conv
                + 2 * work.head_flops(g, 85 * 64)
                + 2 * 85 * 64 * 512 * (128 + 1031 + 128 + 1031))
    assert work.iteration_flops(g, it) == pytest.approx(
        40 * step + 8 * (2 * (window + burn) + backward))


def test_update_lstm_calls():
    it = work.Iteration(40, 32, 32, 40, 80, 5, 1)
    calls = work.update_lstm_calls(ATARI, it)
    assert sorted(c.products for c in calls) == sorted(
        [work.lstm_forward(85, 32, 512, 6917).products] * 2
        + [work.lstm_forward(40, 32, 512, 6917).products] * 2
        + [work.lstm_backward(85, 32, 512, 6917).products])
    assert len(work.collect_lstm_calls(ATARI, it)) == 40
