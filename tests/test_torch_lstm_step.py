"""The port's one-step LSTM forward (``rlpyt_tpu_torch/ops/lstm.py``:
``lstm_step``, ``lstm_step_plain``, ``step_plan`` and the T = 1 branch of
``LstmFunction``) against the JAX package's ``lstm_scan`` and
``lstm_pallas`` (interpret mode) at T = 1, at the tolerances of
tests/test_pallas_lstm.py: forward rtol = atol = 1e-5, gradients rtol =
atol = 2e-4 (float32; the frameworks sum the products in different
orders).  Inputs come from numpy with a seed.  Also the plan's coverage of
units, rows and depth, and the kernel's summation orders emulated in
torch against a float64 reference.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rlpyt_tpu.ops.pallas.lstm import lstm_pallas, lstm_scan
from rlpyt_tpu_torch.ops import lstm as L
from rlpyt_tpu_torch.utils import profiling

torch.set_num_threads(2)

# (B, F, H): a small one, ragged H and F (H = 100: the last CTA's units
# past H; F = 130 not a multiple of a stage), B past one tile of 32 rows.
SHAPES = [(4, 8, 16), (3, 130, 100), (37, 33, 102)]
NAMES = ("wx", "wh", "b", "x", "h0", "c0")


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


def make_inputs(seed, B, F, H, with_dones=True):
    """One step's numpy inputs, scaled as tests/test_pallas_lstm.py
    scales them; x [1, B, F] and done [1, B] as the JAX functions take
    them."""
    rng = np.random.default_rng(seed)

    def normal(*shape, scale=1.0):
        return (rng.standard_normal(shape) * scale).astype(np.float32)

    done = (rng.random((1, B)) < 0.3) if with_dones else np.zeros((1, B), bool)
    return dict(wx=normal(F, 4 * H, scale=0.3),
                wh=normal(H, 4 * H, scale=0.3), b=normal(4 * H, scale=0.1),
                x=normal(1, B, F), done=done, h0=normal(B, H, scale=0.5),
                c0=normal(B, H, scale=0.5))


def ordered(a):
    return [a[k] for k in ("wx", "wh", "b", "x", "done", "h0", "c0")]


def jax_fn(impl):
    if impl == "scan":
        return lstm_scan
    return lambda *a: lstm_pallas(*a, True)


def step_args(a):
    """``lstm_step`` / ``lstm_step_plain`` arguments from numpy inputs."""
    t = {k: torch.from_numpy(v) for k, v in a.items()}
    mask = (~t["done"][0]).to(torch.float32)
    return (t["x"][0], t["wx"], t["wh"], t["b"], mask, t["h0"], t["c0"])


@pytest.mark.parametrize("with_dones", [True, False])
@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("impl", ["scan", "pallas"])
def test_one_step_matches_jax(impl, shape, with_dones):
    """``lstm`` at T = 1 (the one-step branch of LstmFunction) and
    ``lstm_step_plain`` against the JAX LSTM at T = 1."""
    a = make_inputs(0, *shape, with_dones=with_dones)
    y_ref, (h_ref, c_ref) = jax_fn(impl)(*map(jnp.asarray, ordered(a)))
    with torch.no_grad():
        y, (h, c) = L.lstm(*map(torch.from_numpy, ordered(a)))
    y1, _, c1, h1, cT1 = L.lstm_step_plain(*step_args(a))
    for got, want in ((y, y_ref), (h, h_ref), (c, c_ref), (y1, y_ref),
                      (h1, h_ref), (cT1, c_ref), (c1[0], c_ref)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("with_dones", [True, False])
@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("impl", ["scan", "pallas"])
def test_one_step_gradients_match_jax(impl, shape, with_dones):
    """Gradients through ``LstmFunction`` at T = 1 (forward by the
    one-step branch, backward by K4's plain version over its gates and c)
    of <y, gy> + <hT, ghT> + <cT, gcT> against jax.grad."""
    B, F, H = shape
    a = make_inputs(1, *shape, with_dones=with_dones)
    rng = np.random.default_rng(2)
    gy, ghT, gcT = (rng.standard_normal(s).astype(np.float32)
                    for s in ((1, B, H), (B, H), (B, H)))
    fn = jax_fn(impl)

    def objective(wx, wh, b, x, h0, c0):
        y, (hT, cT) = fn(wx, wh, b, x, jnp.asarray(a["done"]), h0, c0)
        return jnp.sum(y * gy) + jnp.sum(hT * ghT) + jnp.sum(cT * gcT)

    want = jax.grad(objective, argnums=range(6))(
        *(jnp.asarray(a[k]) for k in NAMES))
    leaves = {k: torch.from_numpy(a[k]).requires_grad_(True) for k in NAMES}
    y, (hT, cT) = L.lstm(leaves["wx"], leaves["wh"], leaves["b"],
                         leaves["x"], torch.from_numpy(a["done"]),
                         leaves["h0"], leaves["c0"])
    loss = ((y * torch.from_numpy(gy)).sum()
            + (hT * torch.from_numpy(ghT)).sum()
            + (cT * torch.from_numpy(gcT)).sum())
    loss.backward()
    for k, w in zip(NAMES, want):
        np.testing.assert_allclose(leaves[k].grad.numpy(), np.asarray(w),
                                   rtol=2e-4, atol=2e-4, err_msg=k)


@pytest.mark.parametrize("shape", SHAPES)
def test_step_plain_is_the_two_launch_contract(shape):
    """On the CPU ``lstm_step`` is ``lstm_step_plain``, and both give
    what K3a + K3 gave at T = 1 (``input_proj_plain`` then
    ``lstm_fwd_plain``): the same five outputs, shapes and all, so that
    LstmFunction's backward takes them unchanged."""
    a = make_inputs(3, *shape)
    args = step_args(a)
    x, wx, wh, b, mask, h0, c0 = args
    got = L.lstm_step(*args)
    plain = L.lstm_step_plain(*args)
    xg = L.input_proj_plain(x, wx, b)[None]
    want = L.lstm_fwd_plain(xg, wh, mask[None], h0, c0)
    for g, p, w in zip(got, plain, want):
        assert torch.equal(g, p)
        assert g.shape == w.shape
        torch.testing.assert_close(g, w, rtol=1e-5, atol=1e-5)


# The one-step shapes of the LSTM configs (B, H, F) and the plan each
# takes on 132 SMs, (rows, path, splits, split_stages): at each the plan
# that bench_torch_lstm_step.py --sweep timed fastest on an H100.
STEP_PLAN_CASES = [
    # MujocoLstmModel's collection step
    ((8, 256, 260), (8, "ffma", 3, 2)),
    # atari_dqn.py r2d1: evaluation and collection; bench_r2d1.py
    ((4, 512, 6917), (8, "ffma", 2, 30)),
    ((32, 512, 6917), (32, "tf32", 2, 30)),
    ((64, 512, 6919), (64, "tf32", 2, 30)),
    # minatar_dqn.py r2d1: collection; the twin's collection and the
    # MinAtar evaluation; the twin's evaluation
    ((64, 128, 1031), (64, "tf32", 5, 2)),
    ((32, 128, 1031), (32, "tf32", 5, 2)),
    ((8, 128, 1031), (8, "ffma", 5, 2)),
    # minatar_pg.py: collection and evaluation (3 stages: no split)
    ((128, 128, 135), (16, "ffma", 1, 3)),
    ((32, 128, 135), (8, "ffma", 1, 3)),
]
RAGGED = [(1, 1, 0), (1, 8, 3), (3, 100, 130), (37, 102, 33), (70, 102, 33),
          (129, 5, 7), (200, 512, 6917), (5000, 64, 64),
          # atari_dqn.py r2d1_resnet's collection and evaluation (not swept)
          (32, 256, 261), (4, 256, 261)]


def hold_step_plan(p, B, H, F, n_sm=132):
    """Every hidden unit in exactly one CTA's units, every row in exactly
    one row tile, every stage of the depth in exactly one split and no
    split empty; a shape the library builds; at most one wave of CTAs."""
    groups = -(-H // p.units)
    assert groups * p.units >= H > (groups - 1) * p.units
    assert p.row_tiles * p.rows >= B > (p.row_tiles - 1) * p.rows
    n = L.step_stage_count(H, F)
    owner = [z for z in range(p.splits)
             for _ in range(z * p.split_stages,
                            min(n, (z + 1) * p.split_stages))]
    assert owner == sorted(owner) and len(owner) == n
    assert set(owner) == set(range(p.splits))
    assert (p.rows, p.path == "tf32") in L.STEP_SHAPES
    assert p.smem == L.step_smem(p.rows, p.path == "tf32")
    assert 1 <= p.splits <= L.STEP_MAX_SPLITS
    assert p.ctas == groups * p.row_tiles * p.splits
    if p.splits > 1:
        assert p.ctas <= (n_sm if p.splits <= 2 else n_sm * 3 // 4)


@pytest.mark.parametrize("shape,want", STEP_PLAN_CASES)
def test_step_plan_at_config_shapes(shape, want):
    B, H, F = shape
    p = L.step_plan(B, H, F, 132)
    assert (p.rows, p.path, p.splits, p.split_stages) == want
    hold_step_plan(p, B, H, F)


@pytest.mark.parametrize("shape", RAGGED)
def test_step_plan_covers_ragged_shapes(shape):
    B, H, F = shape
    hold_step_plan(L.step_plan(B, H, F, 132), B, H, F)


@pytest.mark.parametrize("shape", [(0, 8, 3), (4, 0, 3), (4, 8, -1),
                                   (65536 * 32 + 1, 8, 3)])
def test_step_plan_refuses_what_it_cannot_cover(shape):
    with pytest.raises(ValueError, match="lstm step"):
        L.step_plan(*shape, 132)


def split_tf32(v):
    """float32 ``v`` as (hi, lo) as the kernels split it (``lstm.cu:
    split_tf32``): hi rounded to TF32 to nearest, lo = v - hi of which the
    tensor core reads the leading 11 bits."""
    bits = v.contiguous().view(torch.int32)
    hi = ((bits + 0x1000) & ~0x1FFF).view(torch.float32)
    lo = ((v - hi).view(torch.int32) & ~0x1FFF).view(torch.float32)
    return hi, lo


def stage_rows(s, nx, F, H):
    """Rows of [W_x; W_h] (as k of the concatenated depth) of stage s."""
    if s < nx:
        return range(L.STEP_K * s, min(F, L.STEP_K * s + L.STEP_K))
    k0 = L.STEP_K * (s - nx)
    return range(F + k0, F + min(H, k0 + L.STEP_K))


def step_order(xh, w, b, F, H, splits, split_stages, path, rows):
    """The one-step kernel's arithmetic in its order, in plain PyTorch,
    for the 32 columns of one CTA: split z runs its stages; FFMA: warp w
    takes stage-relative k 32j + 4w .. 32j + 4w + 3 (j < STEP_K / 32) in
    turn, a fused multiply-add each (float64 product and sum, rounded once
    to float32), and the 8 warps' sums are added in warp order; TF32: each group of
    warps takes every (256 / rows)-th 8-deep step of a stage, sums the
    stage's three split products from zero (float64, rounded once), adds
    that to its float32 sum, and the groups are added in order.  The
    splits' sums are added in rank order, the bias last."""
    nx = -(-F // L.STEP_K)
    n = L.step_stage_count(H, F)
    out = None
    for z in range(splits):
        stages = range(z * split_stages, min(n, (z + 1) * split_stages))
        if path == "ffma":
            parts = []
            for wp in range(8):
                acc = torch.zeros((xh.shape[0], w.shape[1]))
                for s in stages:
                    ks = stage_rows(s, nx, F, H)
                    for rel in [32 * j + 4 * wp + kk
                                for j in range(L.STEP_K // 32)
                                for kk in range(4)]:
                        if rel < len(ks):
                            k = ks[rel]
                            acc = (acc.double() + xh[:, k:k + 1].double()
                                   * w[k].double()).float()
                parts.append(acc)
        else:
            groups = 256 // rows
            xhh, xhl = split_tf32(xh)
            whh, whl = split_tf32(w)
            parts = []
            for grp in range(groups):
                acc = torch.zeros((xh.shape[0], w.shape[1]))
                for s in stages:
                    ks = stage_rows(s, nx, F, H)
                    sel = [ks[rel] for s8 in range(grp, L.STEP_K // 8, groups)
                           for rel in range(8 * s8, 8 * s8 + 8)
                           if rel < len(ks)]
                    if not sel:
                        continue
                    d = (xhl[:, sel].double() @ whh[sel].double()
                         + xhh[:, sel].double() @ whl[sel].double()
                         + xhh[:, sel].double() @ whh[sel].double())
                    acc = acc + d.float()
                parts.append(acc)
        cta = parts[0]
        for p in parts[1:]:
            cta = cta + p
        out = cta if out is None else out + cta
    return out + b


@pytest.mark.parametrize("path,rows", [("ffma", 8), ("tf32", 32),
                                       ("tf32", 64)])
def test_step_orders_reproduce_fp32(path, rows):
    """The one-step kernel's summation orders at the Atari R2D1 shape (F =
    6917, H = 512: K = 7429) under its plan's 2 splits of 59 stages, in
    plain PyTorch: within 1e-5 of the largest value of the float64
    pre-activations, as the float32 product is.  Three TF32 products keep
    float32's accuracy; one would not."""
    F, H, B = 6917, 512, 4
    p = L.step_plan(32 if path == "tf32" else B, H, F, 132)
    rng = np.random.default_rng(10)
    K = F + H
    xh = torch.from_numpy(rng.standard_normal((B, K)).astype(np.float32))
    w = torch.from_numpy((rng.standard_normal((K, 32)) * K ** -0.5)
                         .astype(np.float32))
    b = torch.from_numpy((rng.standard_normal(32) * 0.1).astype(np.float32))
    out = step_order(xh, w, b, F, H, p.splits, p.split_stages, path, rows)
    ref = xh.double() @ w.double() + b.double()
    scale = ref.abs().max()
    assert (out.double() - ref).abs().max() <= 1e-5 * scale
    assert ((xh @ w + b).double() - ref).abs().max() <= 1e-5 * scale
    one = (split_tf32(xh)[0] @ split_tf32(w)[0]).double() + b.double()
    assert (one - ref).abs().max() > 1e-5 * scale


@pytest.mark.cuda
def test_cuda_step_matches_plain(cuda_device):
    """The fused kernel against its plain version on the card (TF32 off;
    within 1e-4 of the largest value, the same bits twice) at config
    shapes and ragged ones, with dones; and LstmFunction at T = 1 takes
    it, not K3a or K3."""
    torch.backends.cuda.matmul.allow_tf32 = False
    for B, F, H in ((4, 6917, 512), (64, 6919, 512), (8, 260, 256),
                    (128, 135, 128), (32, 1031, 128), (3, 130, 100),
                    (37, 33, 102), (32, 261, 256), (4, 261, 256)):
        a = make_inputs(7, B, F, H)
        args = tuple(t.to(cuda_device) for t in step_args(a))
        out = L.lstm_step(*args)
        again = L.lstm_step(*args)
        ref = L.lstm_step_plain(*args)
        for o, o2, r in zip(out, again, ref):
            assert torch.equal(o, o2) and o.shape == r.shape
            assert (o - r).abs().max() <= 1e-4 * r.abs().max()
    t = {k: torch.from_numpy(v).to(cuda_device) for k, v in a.items()}
    with profiling.recording() as rec:
        L.lstm(*ordered(t))
    assert [rec.total("ops." + k) for k in ("lstm_step", "input_proj",
                                            "lstm_fwd")] == [1, 0, 0]
