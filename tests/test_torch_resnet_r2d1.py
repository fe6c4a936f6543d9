"""R2D1 on IMPALA's deep residual trunk (``models/resnet.py``, the Atari
script's ``r2d1_resnet``): its published sizes, the model and one update
against the benchmark's plain reference (``benchmark/reference/
r2d1_resnet.py``, loaded by path) on seeded random weights at a small
size, the trainer through its script, the pool's -inf border, and the
Nature model left as it was."""
import importlib.util
import math
import sys
from pathlib import Path

import pytest
import torch
import torch.nn.functional as F

from rlpyt_tpu_torch.experiments.configs.atari_dqn import configs
from rlpyt_tpu_torch.experiments.scripts.atari_dqn import build_runner
from rlpyt_tpu_torch.models.dqn import AtariR2d1Model
from rlpyt_tpu_torch.models.resnet import ImpalaResNet, ResNetSection

ROOT = Path(__file__).resolve().parent.parent
BENCH = ROOT / "benchmark"
FRAMES = (4, 104, 80)


def _reference():
    """The reference module, by path; its sibling ``r2d1.py`` is imported
    as ``reference.r2d1``, as the benchmark imports it."""
    sys.path.insert(0, str(BENCH))
    try:
        spec = importlib.util.spec_from_file_location(
            "reference_r2d1_resnet", BENCH / "reference" / "r2d1_resnet.py")
        module = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(module)
    finally:
        sys.path.remove(str(BENCH))
    return module


ref = _reference()
CPU = ref.Precision(False, torch.device("cpu"))

# A small model: every part of the trunk (three sections, two blocks a
# section, the dense layer), narrow.
SMALL = dict(trunk="resnet", channels=(4, 8, 8), blocks=2, feature_size=16,
             lstm_size=16, fc_sizes=(32,))
SMALL_FRAMES = (4, 21, 17)     # odd sides: the pool's last window half out


def _seeded(model, seed):
    """Every parameter drawn anew (biases too, so that they are tested):
    normal, 1/sqrt(fan-in) for weights, 0.1 for biases."""
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for name, p in model.named_parameters():
            fan_in = p.shape[0] if name.startswith("lstm.w") else \
                math.prod(p.shape[1:])
            scale = 1 / math.sqrt(fan_in) if p.dim() > 1 else 0.1
            p.copy_(torch.randn(p.shape, generator=g) * scale)
    return {k: v.detach().clone() for k, v in model.named_parameters()}


def _spec(model_cfg, algo=None):
    algo = algo or dict(discount=0.997, n_step_return=5, warmup_T=0,
                        batch_T=1, pri_eta=0.9, learning_rate=1e-4)
    return ref.Spec.from_config({"model": model_cfg, "algo": algo})


def test_published_widths():
    """At IMPALA's widths on the port's 4 x 104 x 80 frames: 97,744
    parameters in the 15 convs, 1,065,216 in the dense layer (1,162,960
    in the trunk), 13 x 10 x 32 = 4,160 features into it, 256 out, and
    the LSTM's input F = 256 + 4 actions + 1 = 261; the config's model is
    this one."""
    kwargs = dict(configs["r2d1_resnet"]["model"])
    model = AtariR2d1Model(FRAMES, 4, **kwargs)
    trunk = model.conv
    assert isinstance(trunk, ImpalaResNet)
    convs = [m for m in trunk.modules() if isinstance(m, torch.nn.Conv2d)]
    assert len(convs) == 15
    assert sum(p.numel() for c in convs for p in c.parameters()) == 97_744
    assert sum(p.numel() for p in trunk.fc.parameters()) == 1_065_216
    assert sum(p.numel() for p in trunk.parameters()) == 1_162_960
    assert trunk.fc.in_features == 13 * 10 * 32 == 4160
    x = torch.zeros((2,) + FRAMES, dtype=torch.uint8)
    sizes = []
    for section in trunk.sections:
        section.register_forward_hook(
            lambda m, i, o: sizes.append(tuple(o.shape[1:])))
    assert trunk(x).shape == (2, 256)
    assert sizes == [(16, 52, 40), (32, 26, 20), (32, 13, 10)]
    assert model.lstm.wx.shape == (261, 4 * 256)
    assert configs["r2d1_resnet"]["agent"]["lstm_size"] == 256


def test_trunk_matches_reference():
    """The trunk's features against the reference's on seeded weights,
    both float32 on the CPU: the same convolutions in the same order, so
    only the pool's border (implicit here, -inf cells in the reference)
    and the summation inside the products differ; 1e-5 of the largest
    feature bounds float32's rounding over 15 convs and the dense
    layer."""
    model = AtariR2d1Model(SMALL_FRAMES, 3, **SMALL)
    P = _seeded(model, 11)
    obs = torch.randint(0, 256, (6,) + SMALL_FRAMES, dtype=torch.uint8)
    with torch.no_grad():
        got = model.conv(obs)
    want = ref.resnet_trunk(CPU, P, _spec(SMALL), obs)
    assert got.shape == want.shape == (6, 16)
    assert (got - want).abs().max() <= 1e-5 * want.abs().max()


def test_model_over_a_window_matches_reference():
    """Q-values and the next recurrent state over [T, B] with resets
    inside the window, against the reference's network: 1e-5 of the
    largest value (float32's rounding, as above)."""
    T, B, A = 5, 3, 3
    model = AtariR2d1Model(SMALL_FRAMES, A, **SMALL)
    P = _seeded(model, 12)
    g = torch.Generator().manual_seed(13)
    obs = torch.randint(0, 256, (T, B) + SMALL_FRAMES, dtype=torch.uint8,
                        generator=g)
    pa = torch.randint(0, A, (T, B), generator=g)
    pr = torch.randn((T, B), generator=g)
    h0, c0 = torch.randn((2, B, 16), generator=g)
    done = torch.zeros((T, B), dtype=torch.bool)
    done[2, 0] = done[3, 2] = True
    with torch.no_grad():
        q, (h, c) = model(obs, pa, pr, (h0, c0), done)
    q_ref, (h_ref, c_ref) = ref.q_values(CPU, P, _spec(SMALL), obs, pa, pr,
                                         (h0, c0), done)
    for got, want in ((q, q_ref), (h, h_ref), (c, c_ref)):
        assert (got - want).abs().max() <= 1e-5 * want.abs().max()


TINY_RUN = {
    "env": {"fake": True},
    "algo": {"batch_b": 2, "batch_T": 8, "warmup_T": 4, "n_step_return": 2,
             "replay_size": 2000, "min_steps_learn": 48,
             "replay_ratio": 1.0},
    "sampler": {"batch_T": 8, "batch_B": 2, "eval_n_envs": 0},
}


def _learning_runner(model=None, seed=3):
    over = dict(TINY_RUN, model=model) if model else TINY_RUN
    runner, _ = build_runner("r2d1_resnet", seed=seed, serial=True,
                             device="cpu", config_overrides=over)
    runner.startup()
    step = runner.batch_spec.size
    while runner._cum_steps + step < runner.algo.min_steps_learn:
        runner.algo.optimize(*runner._collect_batch())
    return runner


def test_one_update_matches_reference():
    """One R2D1 update's loss, written priorities and gradient (before
    the clip) against the reference's, from the same weights and the
    same drawn windows.  The program's h^-1 is the closed form whose
    sqrt(...) - 1 keeps about 6e-5 of relative precision in float32,
    against the reference's form without the cancellation, so the loss,
    the priorities and each element of each leaf's gradient agree to
    3e-4 of their largest (the benchmark's tiny-size limits, for the same
    reason)."""
    runner = _learning_runner(SMALL)
    algo = runner.algo
    try:
        model, target = algo.model, algo.target_model
        P = _seeded(model, 21)
        with torch.no_grad():
            for name, p in target.named_parameters():
                p.copy_(P[name])
        batch = algo.replay.sample(algo.batch_b, algo.generator)
        model.zero_grad()
        loss, priorities = algo.loss(batch)
        loss.backward()
        grads = {n: p.grad.clone() for n, p in model.named_parameters()}
    finally:
        runner.vec.close()
    h, c = batch.init_rnn_state
    rb = ref.Batch(batch.observation, batch.action, batch.reward,
                   batch.done, batch.prev_action, batch.prev_reward, h, c,
                   batch.is_weights)
    s = _spec(SMALL, dict(
        discount=algo.discount, n_step_return=algo.n_step,
        warmup_T=algo.warmup_T, batch_T=algo.batch_T, pri_eta=algo.pri_eta,
        learning_rate=algo.learning_rate))
    Pg = {k: v.clone().requires_grad_(True) for k, v in P.items()}
    r_loss, r_pri, _, _ = ref.r2d1_loss(CPU, Pg, P, s, rb)
    r_grads = dict(zip(Pg, torch.autograd.grad(r_loss, list(Pg.values()))))
    loss, r_loss = float(loss.detach()), float(r_loss.detach())
    assert abs(loss - r_loss) <= 3e-4 * abs(r_loss)
    assert (priorities - r_pri).abs().max() <= 3e-4 * r_pri.abs().max()
    for name, g in r_grads.items():
        assert ((grads[name] - g).abs().max()
                <= 3e-4 * g.abs().max()), name


def test_script_trains_two_iterations_at_published_widths():
    """``build_runner("r2d1_resnet", serial=True, device="cpu")`` on
    FakeALE at the published widths (a small batch): R2D1 on the residual
    trunk makes two learning iterations with finite losses."""
    runner = _learning_runner()
    try:
        infos = [runner.algo.optimize(*runner._collect_batch())
                 for _ in range(2)]
        model = runner.agent.model
    finally:
        runner.vec.close()
    assert type(runner.algo).__name__ == "R2D1"
    assert runner.algo.update_counter == 2
    assert isinstance(model.conv, ImpalaResNet)
    assert sum(p.numel() for p in model.conv.parameters()) == 1_162_960
    for info in infos:
        assert all(math.isfinite(float(v)) for v in info)


# AtariR2d1Model() under torch.manual_seed(0) before the trunk choice
# was added: each parameter's name, shape, sum and sum of magnitudes.
NATURE = [
    ("conv.convs.0.weight", (32, 4, 8, 8), -6.985005115870081,
     420.0991904344173),
    ("conv.convs.0.bias", (32,), 0.0, 0.0),
    ("conv.convs.1.weight", (64, 32, 4, 4), 3.1076851838441826,
     1196.354951437219),
    ("conv.convs.1.bias", (64,), 0.0, 0.0),
    ("conv.convs.2.weight", (64, 64, 3, 3), -5.655600662101023,
     1267.644873844275),
    ("conv.convs.2.bias", (64,), 0.0, 0.0),
    ("lstm.wx", (6917, 2048), -43.22983470510941, 139952.66581055624),
    ("lstm.wh", (512, 2048), -74.64958930591524, 37003.0467385028),
    ("lstm.b", (2048,), 0.0, 0.0),
    ("head.adv.layers.0.weight", (512, 512), -3.9643054332804137,
     9531.001108284667),
    ("head.adv.layers.0.bias", (512,), 0.0, 0.0),
    ("head.adv.layers.1.weight", (4, 512), 0.05214239945053123,
     74.66561665001063),
    ("head.adv.layers.1.bias", (4,), 0.0, 0.0),
    ("head.val.layers.0.weight", (512, 512), -54.82300434250014,
     9522.458430858656),
    ("head.val.layers.0.bias", (512,), 0.0, 0.0),
    ("head.val.layers.1.weight", (1, 512), 0.4261144492775202,
     18.518782670551445),
    ("head.val.layers.1.bias", (1,), 0.0, 0.0),
]


def test_nature_model_unchanged():
    """The default trunk keeps its parameter names, shapes and seeded
    values, so that the benchmark's weights (drawn by sorted name) and
    the ``atari_r2d1`` check stay the same.  The sums agree to 1e-6: the
    LSTM's orthogonal init runs a QR factorization whose rounding moves
    with the BLAS library's thread count (3e-8 of the sum seen), while
    another draw would move each sum by its whole size."""
    torch.manual_seed(0)
    model = AtariR2d1Model(FRAMES, 4)
    got = [(n, tuple(p.shape), float(p.detach().double().sum()),
            float(p.detach().double().abs().sum()))
           for n, p in model.named_parameters()]
    assert [g[:2] for g in got] == [n[:2] for n in NATURE]
    for g, n in zip(got, NATURE):
        assert g[2:] == pytest.approx(n[2:], rel=1e-6, abs=1e-9), g[0]


def test_pool_border_is_minus_infinity():
    """On an all-negative input each pooled cell is the largest of the
    cells of its 3 x 3 window that lie inside the frame: the border
    counts as -inf, never as 0."""
    section = ResNetSection(1, 1, blocks=0)
    with torch.no_grad():
        section.conv.weight.zero_()
        section.conv.weight[0, 0, 1, 1] = 1.0    # the conv passes x on
        section.conv.bias.zero_()
    x = -1.0 - torch.rand((2, 1, 7, 6), generator=torch.Generator()
                          .manual_seed(5))
    with torch.no_grad():
        got = section(x, torch.float32)
    assert got.shape == (2, 1, 4, 3)
    want = torch.empty_like(got)
    for i in range(4):
        for j in range(3):
            rows = slice(max(2 * i - 1, 0), 2 * i + 2)
            cols = slice(max(2 * j - 1, 0), 2 * j + 2)
            want[:, :, i, j] = x[:, :, rows, cols].amax(dim=(2, 3))
    assert torch.equal(got, want)
    assert (got < 0).all()
    assert torch.equal(got, ref.max_pool(x))
    assert not torch.equal(got, F.max_pool2d(F.pad(x, (1, 1, 1, 1)), 3, 2))
