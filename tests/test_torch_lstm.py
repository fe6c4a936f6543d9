"""Port's fused LSTM (rlpyt_tpu_torch/ops/lstm.py) against the JAX
package's ``lstm_scan`` and ``lstm_pallas`` (interpret mode), at the
shapes and tolerances of tests/test_pallas_lstm.py: forward rtol = atol =
1e-5, gradients rtol = atol = 2e-4 (float32; the frameworks sum the
products in different orders).  Inputs come from numpy with a seed.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rlpyt_tpu.ops.pallas.lstm import lstm_pallas, lstm_scan
from rlpyt_tpu_torch.ops import lstm as L

torch.set_num_threads(2)

SHAPES = [(5, 4, 8, 16), (7, 3, 130, 100)]
NAMES = ("wx", "wh", "b", "x", "h0", "c0")


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


def make_inputs(seed, T, B, F, H, with_dones=True):
    """Numpy inputs scaled as tests/test_pallas_lstm.py scales them."""
    rng = np.random.default_rng(seed)

    def normal(*shape, scale=1.0):
        return (rng.standard_normal(shape) * scale).astype(np.float32)

    done = (rng.random((T, B)) < 0.15) if with_dones \
        else np.zeros((T, B), bool)
    return dict(wx=normal(F, 4 * H, scale=0.3),
                wh=normal(H, 4 * H, scale=0.3), b=normal(4 * H, scale=0.1),
                x=normal(T, B, F), done=done, h0=normal(B, H, scale=0.5),
                c0=normal(B, H, scale=0.5))


def jax_fn(impl):
    if impl == "scan":
        return lstm_scan
    return lambda *a: lstm_pallas(*a, True)


def ordered(a):
    return [a[k] for k in ("wx", "wh", "b", "x", "done", "h0", "c0")]


@pytest.mark.parametrize("with_dones", [True, False])
@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("impl", ["scan", "pallas"])
def test_forward_matches_jax(impl, shape, with_dones):
    a = make_inputs(0, *shape, with_dones=with_dones)
    y_ref, (h_ref, c_ref) = jax_fn(impl)(*map(jnp.asarray, ordered(a)))
    with torch.no_grad():
        y, (h, c) = L.lstm(*map(torch.from_numpy, ordered(a)))
    for got, want in ((y, y_ref), (h, h_ref), (c, c_ref)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=1e-5, atol=1e-5)


def cotangents(seed, T, B, H):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s).astype(np.float32)
            for s in ((T, B, H), (B, H), (B, H))]


@pytest.mark.parametrize("with_dones", [True, False])
@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("impl", ["scan", "pallas"])
def test_gradients_match_jax(impl, shape, with_dones):
    """Gradients of <y, gy> + <hT, ghT> + <cT, gcT>, so the hT and cT
    cotangents reach the backward."""
    T, B, F, H = shape
    a = make_inputs(1, *shape, with_dones=with_dones)
    gy, ghT, gcT = cotangents(2, T, B, H)
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
    loss = ((y * torch.from_numpy(gy)).sum() + (hT * torch.from_numpy(ghT))
            .sum() + (cT * torch.from_numpy(gcT)).sum())
    loss.backward()
    for k, w in zip(NAMES, want):
        np.testing.assert_allclose(leaves[k].grad.numpy(), np.asarray(w),
                                   rtol=2e-4, atol=2e-4, err_msg=k)


def plain_autograd(a, done, cot):
    """Gradients by autograd through input_proj_plain + lstm_fwd_plain."""
    T, B, F = a["x"].shape
    xg = L.input_proj_plain(a["x"].reshape(T * B, F), a["wx"], a["b"])
    mask = (~done).to(torch.float32)
    y, _, _, hT, cT = L.lstm_fwd_plain(xg.reshape(T, B, -1), a["wh"], mask,
                                       a["h0"], a["c0"])
    obj = sum((o * c).sum() for o, c in zip((y, hT, cT), cot))
    return torch.autograd.grad(obj, [a[k] for k in NAMES])


@pytest.mark.parametrize("shape", SHAPES)
def test_function_backward_matches_autograd(shape):
    """The Function's backward (lstm_bwd_plain on the CPU, then the
    window contractions) against autograd through the plain forward;
    float32, same operations in another order: rtol = atol = 1e-5."""
    T, B, F, H = shape
    a = make_inputs(3, *shape)
    done = torch.from_numpy(a["done"])
    cot = [torch.from_numpy(c) for c in cotangents(4, T, B, H)]
    leaves = {k: torch.from_numpy(a[k]).requires_grad_(True) for k in NAMES}
    want = plain_autograd(leaves, done, cot)
    y, (hT, cT) = L.lstm(leaves["wx"], leaves["wh"], leaves["b"],
                         leaves["x"], done, leaves["h0"], leaves["c0"])
    got = torch.autograd.grad(
        sum((o * c).sum() for o, c in zip((y, hT, cT), cot)),
        [leaves[k] for k in NAMES])
    for k, g, w in zip(NAMES, got, want):
        np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=1e-5,
                                   atol=1e-5, err_msg=k)


def test_bwd_plain_residuals_match_forward():
    """lstm_fwd_plain's residuals feed lstm_bwd_plain: with dy = 0 and
    dcT = 0 every gradient is zero; with a done at every step dh0 and dc0
    are zero."""
    T, B, F, H = 4, 2, 3, 5
    a = {k: torch.from_numpy(v)
         for k, v in make_inputs(5, T, B, F, H).items()}
    xg = L.input_proj_plain(a["x"].reshape(T * B, F), a["wx"], a["b"])
    mask = torch.zeros((T, B))
    _, gates, cs, _, _ = L.lstm_fwd_plain(xg.reshape(T, B, -1), a["wh"],
                                          mask, a["h0"], a["c0"])
    zeros = torch.zeros((T, B, H))
    dg, dh0, dc0 = L.lstm_bwd_plain(gates, cs, a["c0"], mask, a["wh"],
                                    zeros, torch.zeros((B, H)))
    assert not dg.any() and not dh0.any() and not dc0.any()
    dg, dh0, dc0 = L.lstm_bwd_plain(gates, cs, a["c0"], mask, a["wh"],
                                    torch.ones((T, B, H)), torch.ones((B, H)))
    assert dg.abs().sum() > 0 and not dh0.any() and not dc0.any()


def test_wrappers_raise_on_other_devices():
    T, B, F, H = 2, 2, 3, 4
    meta = {k: torch.from_numpy(v).to("meta")
            for k, v in make_inputs(6, T, B, F, H).items()}
    with pytest.raises(ValueError, match="unsupported device"):
        L.lstm(*ordered(meta))
    with pytest.raises(ValueError, match="unsupported device"):
        L.lstm_fwd(torch.empty((T, B, 4 * H), device="meta"), meta["wh"],
                   torch.empty((T, B), device="meta"), meta["h0"],
                   meta["c0"])
    with pytest.raises(ValueError, match="unsupported device"):
        L.lstm_bwd(torch.empty((T, B, 4 * H), device="meta"),
                   torch.empty((T, B, H), device="meta"), meta["c0"],
                   torch.empty((T, B), device="meta"), meta["wh"],
                   torch.empty((T, B, H), device="meta"), meta["c0"])
    with pytest.raises(ValueError, match="unsupported device"):
        L.lstm_step(meta["x"][0], meta["wx"], meta["wh"], meta["b"],
                    torch.empty((B,), device="meta"), meta["h0"],
                    meta["c0"])


# K3a's plan on 132 SMs at every LSTM config's shapes (M = T * B, N = 4H,
# K = F), as chip_smoke.py's P19_SHAPES lists them, and at ragged ones:
# ((M, N, K), (tile_m, tile_n, k_chunk, splits)).  Below K = 2048 each is
# the shape of those built that bench_torch_proj_shapes.py --sweep timed
# fastest on an H100, but at M = 320 (64 x 64 tiles in 5 splits, 9 %
# faster: 200 CTAs, which the cost model counts as more than one wave).
PLAN_CASES = [
    # minatar_pg (H = 128, F = 135): the lstm_a2c window, a PPO minibatch,
    # a collection step, an evaluation step
    ((2048, 512, 135), (128, 64, 160, 1)), ((512, 512, 135), (64, 64, 96, 2)),
    ((128, 512, 135), (64, 64, 32, 5)), ((32, 512, 135), (64, 64, 32, 5)),
    # MujocoLstmModel (H = 256, F = 260): the batch, a PPO minibatch, a
    # collection step
    ((2048, 1024, 260), (128, 128, 288, 1)),
    ((1024, 1024, 260), (128, 128, 160, 2)),
    ((8, 1024, 260), (64, 64, 64, 5)),
    # minatar_dqn r2d1 (H = 128, F = 1031): training window, burn-in,
    # collection, evaluation; the R2D1 twin's training window, burn-in and
    # evaluation (its collection is the evaluation's 32 rows)
    ((1440, 512, 1031), (128, 128, 544, 2)),
    ((640, 512, 1031), (128, 64, 544, 2)), ((64, 512, 1031), (64, 64, 160, 7)),
    ((32, 512, 1031), (64, 64, 160, 7)), ((736, 512, 1031), (128, 64, 544, 2)),
    ((320, 512, 1031), (128, 64, 288, 4)), ((8, 512, 1031), (64, 64, 160, 7)),
    # atari_dqn r2d1 (H = 512, F = 6917) and bench_r2d1 (F = 6919): PR 4's
    # plan at more than 64 rows; at M <= 64 the cost model's (64 x 64
    # tiles in 3 splits: 0.062-0.064 ms against the split-K 64 x 128 x 8 at
    # 0.067-0.070 in that sweep)
    ((2720, 2048, 6917), (192, 128, 6944, 1)),
    ((1280, 2048, 6917), (192, 128, 6944, 1)),
    ((32, 2048, 6917), (64, 64, 2336, 3)),
    ((4, 2048, 6917), (64, 64, 2336, 3)),
    ((2720, 2048, 6919), (192, 128, 6944, 1)),
    ((1280, 2048, 6919), (192, 128, 6944, 1)),
    ((32, 2048, 6919), (64, 64, 2336, 3)),
    ((4, 2048, 6919), (64, 64, 2336, 3)),
    ((1440, 2048, 6919), (192, 128, 6944, 1)),
    ((640, 2048, 6919), (128, 128, 6944, 1)),
    ((64, 2048, 6919), (64, 64, 2336, 3)),
    ((1, 2048, 6919), (64, 64, 2336, 3)),
    ((63, 2048, 6919), (64, 64, 2336, 3)),
    ((65, 2048, 6919), (64, 128, 896, 8)),
    ((128, 2048, 6919), (64, 128, 896, 8)),
    # ragged: the generic kernel for N not a multiple of 4; shallow K
    ((1440, 2050, 6919), (0, 128, 6919, 1)), ((21, 400, 130), (64, 64, 32, 5)),
    ((1, 8, 3), (64, 64, 32, 1)),
]


@pytest.mark.parametrize("shape,plan", PLAN_CASES)
def test_proj_splits_cover_k(shape, plan):
    """The projection's plan on 132 SMs: every row of W_x in exactly one
    split, no split empty, each split a whole number of the kernel's K
    steps, a shape the library builds; at K = 6919 and 6917 and more than
    64 rows the deep-K plan (64-row tiles, K over a cluster of 8, wherever
    128-row tiles would leave more than half of the SMs idle; 192- or
    128-row tiles without a split otherwise); at smaller K, and at M <=
    64, the cost model's choice, and no plan of more CTAs than SMs; the
    generic kernel when N is not a multiple of 4."""
    M, N, K = shape
    got = L.proj_plan(M, N, K, 132)
    assert tuple(got) == plan
    ranges = [range(z * got.k_chunk, min(K, (z + 1) * got.k_chunk))
              for z in range(got.splits)]
    assert [k for r in ranges for k in r] == list(range(K))
    assert all(len(r) > 0 for r in ranges)
    if got.tile_m:
        assert (got.tile_m, got.tile_n, got.splits) in L.PROJ_SHAPES
        assert got.k_chunk % L.PROJ_K_STEP == 0
    else:
        assert (got.k_chunk, got.splits) == (K, 1)
    if got.tile_m and (K <= L.PROJ_MODEL_K or M <= 64):
        assert -(-M // got.tile_m) * -(-N // got.tile_n) * got.splits <= 132


def split_tf32(v):
    """float32 ``v`` as (hi, lo): hi is v rounded to TF32 (10 mantissa
    bits: the low 13 of float32's 23 cleared) to nearest, ties away from
    zero; lo = v - hi, of which the tensor core reads the leading 11 bits
    (the rest is cut off).  The split K3a makes on both operands."""
    bits = v.contiguous().view(torch.int32)
    hi = ((bits + 0x1000) & ~0x1FFF).view(torch.float32)
    lo = ((v - hi).view(torch.int32) & ~0x1FFF).view(torch.float32)
    return hi, lo


@pytest.mark.parametrize("F", [6919, 1031, 260, 135])
def test_three_tf32_products_reproduce_fp32(F):
    """The arithmetic K3a relies on, in plain PyTorch at the LSTMs' input
    widths (R2D1's F = 6919, MinAtar R2D1's 1031, MujocoLstmModel's 260,
    the MinAtar PG models' 135): x_lo @ w_hi + x_hi @ w_lo + x_hi @ w_hi
    is within 1e-5 of the largest value of the float32 product; x_hi @
    w_hi alone (plain TF32) is not.  A product of two TF32 values is
    exact in float32, so float32 matrix products of the split operands
    stand for the tensor core's."""
    rng = np.random.default_rng(8)
    N = 96
    x = torch.from_numpy(rng.standard_normal((32, F)).astype(np.float32))
    w = torch.from_numpy((rng.standard_normal((F, N)) * F ** -0.5)
                         .astype(np.float32))
    xh, xl = split_tf32(x)
    wh, wl = split_tf32(w)
    for part in (xh, xl, wh, wl):
        assert not (part.view(torch.int32) & 0x1FFF).any()
    assert (x - (xh + xl)).abs().max() <= 2.0 ** -21 * x.abs().max()
    ref = x.double() @ w.double()
    scale = ref.abs().max()
    fp32 = (x @ w).double()
    three = ((xl @ wh + xh @ wl) + xh @ wh).double()
    one = (xh @ wh).double()
    assert (fp32 - ref).abs().max() <= 1e-5 * scale
    assert (three - ref).abs().max() <= 1e-5 * scale
    assert (one - ref).abs().max() > 1e-5 * scale


# K3a's summation orders at the config shapes: (K, k_chunk, splits), and
# the split-K order the plan takes at K = 6917 for 65-512 rows.
ORDERS = sorted({(K, p[2], p[3]) for (_, _, K), p in PLAN_CASES
                 if p[0] and K > 3} | {(6917, 896, 8)})


@pytest.mark.parametrize("K,k_chunk,splits", ORDERS)
def test_proj_plan_order_reproduces_fp32(K, k_chunk, splits):
    """K3a's arithmetic in its order under each plan of the config shapes,
    in plain PyTorch: split z sums its 32-deep stages of rows [z * k_chunk,
    (z + 1) * k_chunk), each stage's three TF32 products summed from zero
    and added to the split's running float32 sum; the splits' sums are
    then added in split order, and the bias last.  Within 1e-5 of the
    largest value of the float64 product, as the unsplit product is."""
    rng = np.random.default_rng(9)
    M, N = 32, 64
    x = torch.from_numpy(rng.standard_normal((M, K)).astype(np.float32))
    w = torch.from_numpy((rng.standard_normal((K, N)) * K ** -0.5)
                         .astype(np.float32))
    b = torch.from_numpy((rng.standard_normal(N) * 0.1).astype(np.float32))
    xh, xl = split_tf32(x)
    wh, wl = split_tf32(w)
    out = torch.zeros((M, N))
    for z in range(splits):
        acc = torch.zeros((M, N))
        for k0 in range(z * k_chunk, min(K, (z + 1) * k_chunk),
                        L.PROJ_K_STEP):
            st = slice(k0, min(K, z * k_chunk + k_chunk, k0 + L.PROJ_K_STEP))
            acc = acc + ((xl[:, st] @ wh[st] + xh[:, st] @ wl[st])
                         + xh[:, st] @ wh[st])
        out = out + acc
    out = out + b
    ref = x.double() @ w.double() + b.double()
    assert (out.double() - ref).abs().max() <= 1e-5 * ref.abs().max()


@pytest.mark.cuda
def test_cuda_kernels_match_plain(cuda_device):
    """K3a, K3 and K4 against their plain versions on the card (TF32 off;
    forward within 1e-4 and backward within 1e-3 of the largest value),
    at slice shapes, more rows than one stage of staged h and ragged
    ones; the recurrences twice, with the same bits."""
    torch.backends.cuda.matmul.allow_tf32 = False
    for T, B, F, H in ((20, 32, 6919, 512), (1, 64, 6919, 512),
                       (5, 128, 33, 512), (7, 3, 130, 100),
                       (3, 37, 33, 102),
                       # atari_dqn.py r2d1_resnet: an update's burn-in and
                       # window (K3a at 2,560 and 5,440 rows, the cluster
                       # path in clusters of 16 x 12 rows)
                       (40, 64, 261, 256), (85, 64, 261, 256)):
        a = {k: torch.from_numpy(v).to(cuda_device)
             for k, v in make_inputs(7, T, B, F, H).items()}
        mask = (~a["done"]).to(torch.float32)
        x2 = a["x"].reshape(T * B, F)
        xg = L.input_proj_plain(x2, a["wx"], a["b"])
        out = L.input_proj(x2, a["wx"], a["b"])
        assert (out - xg).abs().max() <= 1e-4 * xg.abs().max()
        xg = xg.reshape(T, B, 4 * H)
        ref = L.lstm_fwd_plain(xg, a["wh"], mask, a["h0"], a["c0"])
        fargs = (xg, a["wh"], mask, a["h0"], a["c0"])
        out = L.lstm_fwd(*fargs)
        assert all(torch.equal(o, p) for o, p in zip(out, L.lstm_fwd(*fargs)))
        for o, r in zip(out, ref):
            assert (o - r).abs().max() <= 1e-4 * r.abs().max()
        dy = torch.randn((T, B, H), device=cuda_device)
        dcT = torch.randn((B, H), device=cuda_device)
        args = (ref[1], ref[2], a["c0"], mask, a["wh"], dy, dcT)
        want = L.lstm_bwd_plain(*args)
        out = L.lstm_bwd(*args)
        assert all(torch.equal(o, p) for o, p in zip(out, L.lstm_bwd(*args)))
        for o, r in zip(out, want):
            assert (o - r).abs().max() <= 1e-3 * r.abs().max()


def hold_cluster_plan(cp, B, H):
    """The cluster path's plan ``cp`` for (B, H) on 132 SMs: every batch
    row in exactly one cluster (cluster c takes [c * rows, c * rows +
    rows)) and no cluster empty; every hidden unit in exactly one CTA of
    a cluster (CTA r owns [r * units, r * units + units), a multiple of
    4); each CTA's (row, unit) cells, rows rounded up to 4, at most one a
    thread;
    shared memory within SMEM_MAX; all clusters on the SMs at once."""
    clusters = [range(c * cp.rows, min(B, (c + 1) * cp.rows))
                for c in range(cp.clusters)]
    assert [b for r in clusters for b in r] == list(range(B))
    assert all(len(r) > 0 for r in clusters)
    owners = [r for r in range(cp.cluster) for _ in range(cp.units)]
    assert len(owners) >= H and owners[:H] == sorted(owners[:H])
    assert cp.units % 4 == 0 and cp.cluster in L.CLUSTER_SIZES
    assert -(-cp.rows // 4) * 4 * cp.units <= L.REC_THREADS
    assert max(cp.fwd_smem, cp.bwd_smem) <= L.SMEM_MAX
    assert cp.clusters * cp.cluster <= 132


@pytest.mark.parametrize("B,H", [(32, 512), (64, 512), (128, 512), (3, 100),
                                 (37, 102), (5, 102), (1, 8), (64, 528),
                                 (1, 1), (128, 100), (32, 128), (128, 128),
                                 (64, 256)])
def test_recurrence_plan_covers_units(B, H):
    """The recurrences' plan on 132 SMs: every hidden unit owned by
    exactly one CTA (CTA j owns [UNITS * j, UNITS * j + UNITS)), no
    cluster without a live unit, whole clusters, at most 132 CTAs (one
    resident on each SM), shared memory within the 232,448 bytes a CTA
    can have on sm_90, h staged in whole 32-row blocks; at R2D1's shapes
    (H = 512, B = 32 or 64) 128 CTAs of 4 units stage all of h at once.
    K3's warps take k in blocks of 4 (warp w: 4w, 4w + 32, ...): each k
    below H, rounded up to 4, exactly once.  Where W_h fits one cluster
    (H up to 256 here) the cluster path covers every row and unit
    (``hold_cluster_plan``); at H = 512 and 528 there is none."""
    plan = L.recurrence_plan(B, H, 132)
    if H <= 256:
        hold_cluster_plan(plan.clustered, B, H)
    else:
        assert plan.clustered is None
    owners = [j for j in range(plan.ctas) for _ in range(L.UNITS)]
    assert len(owners[:H]) == H and owners[:H] == sorted(owners[:H])
    assert plan.ctas * L.UNITS >= H
    assert (plan.ctas - L.CLUSTER) * L.UNITS < H
    assert plan.ctas % L.CLUSTER == 0
    assert plan.ctas <= 132
    assert max(plan.fwd_smem, plan.bwd_smem) <= 232448
    assert plan.stage_rows % 32 == 0 and plan.stage_rows >= 32
    if H == 512 and B <= 64:
        assert (plan.ctas, L.UNITS, L.CLUSTER) == (128, 4, 2)
        assert plan.stage_rows >= B
    hp = -(-H // 4) * 4
    taken = sorted(k + kk for w in range(L.REC_WARPS)
                   for k in range(4 * w, hp, 4 * L.REC_WARPS)
                   for kk in range(4))
    assert taken == list(range(hp))


@pytest.mark.parametrize("B,H", [(32, 529), (64, 1024)])
def test_recurrence_plan_refuses_more_ctas_than_sms(B, H):
    """H above 4 units x 132 SMs would need CTAs that cannot all be
    resident at once: the plan raises instead of launching them.  Nor
    does W_h fit any cluster there: 16 CTAs of H / 16 units would each
    hold more than SMEM_MAX of it."""
    with pytest.raises(ValueError, match="SMs"):
        L.recurrence_plan(B, H, 132)
    assert all(L.cluster_plan(B, H, C, 1) is None for C in L.CLUSTER_SIZES)


# The recurrences' plan on 132 SMs at every LSTM config's (B, H):
# ((B, H), (cluster, rows, clusters)) on the cluster path, or ((B, H),
# (ctas, stage_rows, fwd_smem, bwd_smem)) of the step-barrier plan at
# H = 512, unchanged.
REC_PLAN_CASES = [
    # minatar_pg (H = 128): the lstm_a2c window and a collection step, a
    # lstm_ppo minibatch and an evaluation step
    ((128, 128), (8, 12, 11)), ((32, 128), (8, 4, 8)),
    # minatar_dqn r2d1 and the R2D1 twin (H = 128): a collection step, an
    # evaluation step of the twin
    ((64, 128), (8, 8, 8)), ((8, 128), (8, 4, 2)),
    # MujocoLstmModel (H = 256): a PPO minibatch, the whole batch
    ((4, 256), (16, 2, 2)), ((8, 256), (16, 2, 4)),
    # Atari R2D1 (H = 512): the step-barrier plan
    ((32, 512), (128, 32, 119808, 43520)),
    ((64, 512), (128, 64, 186368, 50176)),
    ((4, 512), (128, 32, 119360, 37696)),
]


@pytest.mark.parametrize("shape,want", REC_PLAN_CASES)
def test_recurrence_plan_at_config_shapes(shape, want):
    """At H <= 256 the cluster path, with the cluster size, rows a
    cluster and clusters that bench_torch_lstm_steps.py --sweep timed
    fastest on an H100, covering every row and unit
    (``hold_cluster_plan``); at H = 512 no cluster path and the
    step-barrier plan unchanged."""
    B, H = shape
    plan = L.recurrence_plan(B, H, 132)
    if H <= 256:
        cp = plan.clustered
        assert (cp.cluster, cp.rows, cp.clusters) == want
        hold_cluster_plan(cp, B, H)
    else:
        assert plan.clustered is None
        assert (plan.ctas, plan.stage_rows, plan.fwd_smem,
                plan.bwd_smem) == want


def bwd_reduce_scatter(gates, cs, c0, mask, wh, dy, dcT):
    """K4's arithmetic in its order: each cluster's partial carry over the
    gate columns of its CTAs, for every unit; warp w sums cluster
    partials w, w + 8, ... and the warps' sums are added in warp order;
    times mask[s+1]."""
    T, B, H = cs.shape
    plan = L.recurrence_plan(B, H, 132)
    per = L.UNITS * L.CLUSTER
    cols = [torch.tensor([g * H + u for g in range(4)
                          for u in range(j * per, min(H, (j + 1) * per))],
                         dtype=torch.long)
            for j in range(plan.ctas // L.CLUSTER)]
    dc = dcT
    dgs = [None] * T
    for s in range(T - 1, -2, -1):
        carry = torch.zeros_like(c0)
        if s + 1 < T:
            dg = dgs[s + 1]
            groups = [dg[:, q] @ wh[:, q].T if len(q)
                      else torch.zeros_like(c0) for q in cols]
            warps = []
            for w in range(8):
                acc = torch.zeros_like(c0)
                for grp in groups[w::8]:
                    acc = acc + grp
                warps.append(acc)
            for w in warps:
                carry = carry + w
            carry = carry * mask[s + 1][:, None]
        if s < 0:
            return torch.stack(dgs), carry, dc
        m = mask[s][:, None]
        cp = (c0 if s == 0 else cs[s - 1]) * m
        i, f, g, o = gates[s].split(H, dim=1)
        tc = torch.tanh(cs[s])
        dh = dy[s] + carry
        dct = dh * o * (1.0 - tc * tc) + dc
        dgs[s] = torch.cat([dct * g * i * (1.0 - i), dct * cp * f * (1.0 - f),
                            dct * i * (1.0 - g * g), dh * tc * o * (1.0 - o)],
                           dim=1)
        dc = dct * f * m


ORDER_SHAPES = [(5, 4, 16), (7, 3, 100), (3, 37, 102), (4, 6, 512)]


def recurrence_inputs(seed, T, B, H):
    a = {k: torch.from_numpy(v)
         for k, v in make_inputs(seed, T, B, 3, H).items()}
    mask = (~a["done"]).to(torch.float32)
    xg = torch.from_numpy(np.random.default_rng(seed + 1).standard_normal(
        (T, B, 4 * H)).astype(np.float32))
    return a, mask, xg


@pytest.mark.parametrize("T,B,H", ORDER_SHAPES)
def test_bwd_reduce_scatter_matches_plain(T, B, H):
    """K4's reduce-scatter (partials by the clusters' gate columns, summed
    over clusters by warps) equals lstm_bwd_plain, which
    forms dgates @ W_h^T in one product, to 1e-6 of the largest value
    (float32)."""
    a, mask, xg = recurrence_inputs(10, T, B, H)
    wh = a["wh"] / np.sqrt(H)
    _, gates, cs, _, _ = L.lstm_fwd_plain(xg, wh, mask, a["h0"], a["c0"])
    rng = np.random.default_rng(11)
    dy = torch.from_numpy(rng.standard_normal((T, B, H)).astype(np.float32))
    dcT = torch.from_numpy(rng.standard_normal((B, H)).astype(np.float32))
    got = bwd_reduce_scatter(gates, cs, a["c0"], mask, wh, dy, dcT)
    want = L.lstm_bwd_plain(gates, cs, a["c0"], mask, wh, dy, dcT)
    for g, w in zip(got, want):
        assert (g - w).abs().max() <= 1e-6 * w.abs().max()


def cluster_order(B, H):
    """(C, units, fwd_splits, bwd_splits) of the cluster path's arithmetic
    at (B, H): the plan's where it has one; at H = 512, where W_h fits no
    cluster, the order 16 CTAs a cluster and 4 rows would take."""
    cp = L.recurrence_plan(B, H, 132).clustered
    if cp is not None:
        return cp.cluster, cp.units, cp.fwd_splits, cp.bwd_splits
    units = -(-(-(-H // 16)) // 4) * 4
    return 16, units, L.tile_lanes(units), L.tile_lanes(-(-H // 4))


def lane_tree(parts):
    """The cluster path's sum of a tile's lane partials ``parts`` (lane ks
    at index ks): the shuffle tree of ``lstm.cu:reduce_rows``, which adds
    lanes ks and ks ^ d for d = KS / 2, KS / 4, ..., 1 in that order."""
    d = len(parts) // 2
    while d >= 1:
        parts = [parts[i] + parts[i ^ d] for i in range(len(parts))]
        d //= 2
    return parts[0]


def fwd_cluster_order(xg, wh, mask, h0, c0):
    """K3's arithmetic on the cluster path in its order: h @ W_h as the
    shuffle tree (``lane_tree``) of KS lanes' partial products, lane ks
    summing k = ks, ks + KS, ... (KS = the plan's fwd_splits), times the
    mask, plus xg."""
    T, B, H4 = xg.shape
    H = H4 // 4
    _, _, KS, _ = cluster_order(B, H)
    lanes = [list(range(ks, H, KS)) for ks in range(KS)]
    h, c = h0, c0
    ys, gs, cs = [], [], []
    for t in range(T):
        m = mask[t][:, None]
        acc = lane_tree([h[:, idx] @ wh[idx] if idx
                         else torch.zeros((B, H4)) for idx in lanes])
        pre = m * acc + xg[t]
        i, f = torch.sigmoid(pre[:, :H]), torch.sigmoid(pre[:, H:2 * H])
        g, o = torch.tanh(pre[:, 2 * H:3 * H]), torch.sigmoid(pre[:, 3 * H:])
        c = f * (c * m) + i * g
        h = o * torch.tanh(c)
        ys.append(h)
        gs.append(torch.cat([i, f, g, o], dim=1))
        cs.append(c)
    return torch.stack(ys), torch.stack(gs), torch.stack(cs), h, c


def bwd_cluster_order(gates, cs, c0, mask, wh, dy, dcT):
    """K4's arithmetic on the cluster path in its order: CTA r's partial
    carry over its own gate columns, q = 4u + g (column g * H + r * U +
    u), as the shuffle tree of KS lanes' partials, lane ks summing q = ks,
    ks + KS, ... (KS = the plan's bwd_splits); the carry the sum of the C
    partials in rank order, times mask[s+1]."""
    T, B, H = cs.shape
    C, U, _, KS = cluster_order(B, H)
    cols = [[[(q % 4) * H + r * U + q // 4 for q in range(ks, 4 * U, KS)
              if r * U + q // 4 < H] for ks in range(KS)] for r in range(C)]
    dc = dcT
    dgs = [None] * T
    for s in range(T - 1, -2, -1):
        carry = torch.zeros_like(c0)
        if s + 1 < T:
            for lanes in cols:
                carry = carry + lane_tree(
                    [dgs[s + 1][:, idx] @ wh[:, idx].T if idx
                     else torch.zeros_like(c0) for idx in lanes])
            carry = carry * mask[s + 1][:, None]
        if s < 0:
            return torch.stack(dgs), carry, dc
        m = mask[s][:, None]
        cp = (c0 if s == 0 else cs[s - 1]) * m
        i, f, g, o = gates[s].split(H, dim=1)
        tc = torch.tanh(cs[s])
        dh = dy[s] + carry
        dct = dh * o * (1.0 - tc * tc) + dc
        dgs[s] = torch.cat([dct * g * i * (1.0 - i), dct * cp * f * (1.0 - f),
                            dct * i * (1.0 - g * g), dh * tc * o * (1.0 - o)],
                           dim=1)
        dc = dct * f * m


# ORDER_SHAPES and cluster-path shapes of the configs: a lstm_ppo
# minibatch (H = 128, B = 32) and a Gaussian PPO one (H = 256, B = 4),
# with fewer steps.
CLUSTER_ORDER_SHAPES = ORDER_SHAPES + [(6, 32, 128), (5, 4, 256)]


@pytest.mark.parametrize("T,B,H", CLUSTER_ORDER_SHAPES)
def test_cluster_orders_match_plain(T, B, H):
    """The cluster path's K3 (lane partials added by a shuffle tree) and
    K4 (each CTA's partial carry over its own gate columns, by the same
    tree, the partials summed in rank order) equal lstm_fwd_plain and
    lstm_bwd_plain to 1e-6 of the largest value (float32)."""
    a, mask, xg = recurrence_inputs(12, T, B, H)
    wh = a["wh"] / np.sqrt(H)
    got = fwd_cluster_order(xg, wh, mask, a["h0"], a["c0"])
    want = L.lstm_fwd_plain(xg, wh, mask, a["h0"], a["c0"])
    for g, w in zip(got, want):
        assert (g - w).abs().max() <= 1e-6 * w.abs().max()
    _, gates, cs, _, _ = want
    rng = np.random.default_rng(13)
    dy = torch.from_numpy(rng.standard_normal((T, B, H)).astype(np.float32))
    dcT = torch.from_numpy(rng.standard_normal((B, H)).astype(np.float32))
    got = bwd_cluster_order(gates, cs, a["c0"], mask, wh, dy, dcT)
    want = L.lstm_bwd_plain(gates, cs, a["c0"], mask, wh, dy, dcT)
    for g, w in zip(got, want):
        assert (g - w).abs().max() <= 1e-6 * w.abs().max()
