"""Port's frame-stack gather (rlpyt_tpu_torch/ops/frame_gather.py) and
frame replay against the JAX package: the Pallas kernels K1
(gather_frame_stacks) and K2 (gather_stacks_window) in interpret mode,
and UniformFrameReplayBuffer.extract_batch.  All checks are bit-exact.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rlpyt_tpu.ops.pallas.frame_gather import gather_frame_stacks as jax_k1
from rlpyt_tpu.ops.pallas.window_gather import (
    gather_stacks_window as jax_k2,
    lane_major_append,
    lane_major_ring,
)
from rlpyt_tpu.replay.base import SamplesToBuffer as JaxSamplesToBuffer
from rlpyt_tpu.replay.frame import UniformFrameReplayBuffer as JaxFrameBuffer
from rlpyt_tpu_torch.ops import frame_gather as fg
from rlpyt_tpu_torch.replay.base import SamplesToBuffer
from rlpyt_tpu_torch.replay.frame import UniformFrameReplayBuffer

torch.set_num_threads(2)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the CUDA kernel has no CPU mode")
    return torch.device("cuda")


def gather_case(rng, size_T, B, F, batch, K, n):
    """Numpy inputs; the first samples start where the window wraps."""
    ring = rng.integers(0, 256, (size_T, B, F), dtype=np.uint8)
    start = rng.integers(0, size_T, batch).astype(np.int32)
    start[:K + n] = size_T - 1 - np.arange(K + n)
    b_idx = rng.integers(0, B, batch).astype(np.int32)
    mask_a = rng.integers(0, 2, (batch, K)).astype(np.int32)
    mask_t = rng.integers(0, 2, (batch, K)).astype(np.int32)
    return ring, start, b_idx, mask_a, mask_t


def port_plain(ring, start, b_idx, mask_a, mask_t, K, n):
    out = fg.gather_frame_stacks(
        torch.from_numpy(ring), torch.from_numpy(start),
        torch.from_numpy(b_idx), torch.from_numpy(mask_a).to(torch.uint8),
        torch.from_numpy(mask_t).to(torch.bool), K=K, n_step=n)
    return [o.numpy() for o in out]


@pytest.mark.parametrize("seed,n_step", [(0, 1), (1, 3)])
def test_plain_matches_k1_interpret(seed, n_step):
    K, H, W, size_T, B, batch = 4, 8, 8, 16, 3, 9
    rng = np.random.default_rng(seed)
    ring, start, b_idx, ma, mt = gather_case(rng, size_T, B, H * W, batch,
                                             K, n_step)
    ghost = np.concatenate([ring, ring[:K - 1 + n_step]], axis=0)
    ref_a, ref_t = jax_k1(jnp.asarray(ghost), jnp.asarray(start),
                          jnp.asarray(b_idx), jnp.asarray(ma),
                          jnp.asarray(mt), K=K, n_step=n_step, H=H, W=W,
                          s=1, out_dtype=jnp.uint8, interpret=True)
    out_a, out_t = port_plain(ring, start, b_idx, ma, mt, K, n_step)
    np.testing.assert_array_equal(out_a, np.asarray(ref_a).reshape(out_a.shape))
    np.testing.assert_array_equal(out_t, np.asarray(ref_t).reshape(out_t.shape))


@pytest.mark.parametrize("seed,n_step", [(0, 1), (1, 3)])
def test_plain_matches_k2_interpret(seed, n_step):
    K, F, size_T, B, batch = 4, 256, 32, 3, 9
    U = K + n_step
    rng = np.random.default_rng(seed)
    ring, start, b_idx, ma, mt = gather_case(rng, size_T, B, F, batch, K,
                                             n_step)
    ring_lm = lane_major_ring(size_T, B, F, U)
    for t0 in range(0, size_T, 8):
        ring_lm = lane_major_append(ring_lm, jnp.asarray(ring[t0:t0 + 8]),
                                    t0, size_T=size_T, U=U)
    ref_a, ref_t = jax_k2(ring_lm, jnp.asarray(start), jnp.asarray(b_idx),
                          jnp.asarray(ma), jnp.asarray(mt), K=K,
                          n_step=n_step, interpret=True)
    out_a, out_t = port_plain(ring, start, b_idx, ma, mt, K, n_step)
    np.testing.assert_array_equal(out_a, np.asarray(ref_a))
    np.testing.assert_array_equal(out_t, np.asarray(ref_t))


@pytest.mark.parametrize("dtype", [np.int32, np.int64])
@pytest.mark.parametrize("n_step", [1, 3])
def test_index_types_match_both_pallas_kernels(dtype, n_step):
    """The wrapper takes int32 or int64 indices as they are and gives the
    same stacks, equal to K1's and K2's in interpret mode."""
    K, H, W, size_T, B, batch = 4, 16, 16, 32, 3, 9
    U = K + n_step
    rng = np.random.default_rng(10 + n_step)
    ring, start, b_idx, ma, mt = gather_case(rng, size_T, B, H * W, batch,
                                             K, n_step)
    out_a, out_t = port_plain(ring, start.astype(dtype), b_idx.astype(dtype),
                              ma, mt, K, n_step)
    ghost = np.concatenate([ring, ring[:U - 1]], axis=0)
    k1 = jax_k1(jnp.asarray(ghost), jnp.asarray(start), jnp.asarray(b_idx),
                jnp.asarray(ma), jnp.asarray(mt), K=K, n_step=n_step, H=H,
                W=W, s=1, out_dtype=jnp.uint8, interpret=True)
    ring_lm = lane_major_ring(size_T, B, H * W, U)
    for t0 in range(0, size_T, 8):
        ring_lm = lane_major_append(ring_lm, jnp.asarray(ring[t0:t0 + 8]),
                                    t0, size_T=size_T, U=U)
    k2 = jax_k2(ring_lm, jnp.asarray(start), jnp.asarray(b_idx),
                jnp.asarray(ma), jnp.asarray(mt), K=K, n_step=n_step,
                interpret=True)
    for ref in (k1, k2):
        np.testing.assert_array_equal(
            out_a, np.asarray(ref[0]).reshape(out_a.shape))
        np.testing.assert_array_equal(
            out_t, np.asarray(ref[1]).reshape(out_t.shape))


def wrapper_args(**changes):
    """Valid CPU arguments of the wrapper (K = 2, n = 1), then ``changes``."""
    args = dict(ring=torch.zeros((4, 2, 16), dtype=torch.uint8),
                start_rows=torch.zeros((3,), dtype=torch.int64),
                b_idx=torch.zeros((3,), dtype=torch.int64),
                mask_a=torch.ones((3, 2), dtype=torch.bool),
                mask_t=torch.ones((3, 2), dtype=torch.uint8),
                K=2, n_step=1)
    args.update(changes)
    return args


@pytest.mark.parametrize("changes,match", [
    (dict(ring=torch.zeros((4, 2, 16), dtype=torch.int8)), "ring must be"),
    (dict(ring=torch.zeros((4, 32), dtype=torch.uint8)), "ring must be"),
    (dict(ring=torch.zeros((4, 2, 32), dtype=torch.uint8)[:, :, ::2]),
     "ring must be"),
    (dict(start_rows=torch.zeros((3,), dtype=torch.int16),
          b_idx=torch.zeros((3,), dtype=torch.int16)), "start_rows and b_idx"),
    (dict(b_idx=torch.zeros((3,), dtype=torch.int32)), "start_rows and b_idx"),
    (dict(b_idx=torch.zeros((4,), dtype=torch.int64)), "start_rows and b_idx"),
    (dict(start_rows=torch.zeros((3,), dtype=torch.int64, device="meta")),
     "start_rows and b_idx"),
    (dict(mask_a=torch.ones((3, 2))), "mask_a and mask_t"),
    (dict(mask_t=torch.ones((3, 3), dtype=torch.bool)), "mask_a and mask_t"),
    (dict(mask_t=torch.ones((3, 2), dtype=torch.bool, device="meta")),
     "mask_a and mask_t"),
    (dict(K=0, mask_a=torch.ones((3, 0), dtype=torch.bool),
          mask_t=torch.ones((3, 0), dtype=torch.bool)), "K \\+ n_step <= 16"),
    (dict(n_step=15), "K \\+ n_step <= 16"),
])
def test_wrapper_rejects_wrong_arguments(changes, match):
    """A wrong dtype, shape, layout or device, or a union of more than 16
    rows, raises before anything runs, on the CPU as on the card."""
    with pytest.raises(ValueError, match=match):
        fg.gather_frame_stacks(**wrapper_args(**changes))


def test_wrapper_accepts_its_valid_arguments():
    out_a, out_t = fg.gather_frame_stacks(**wrapper_args())
    assert out_a.shape == out_t.shape == (3, 2, 16)
    out_a, out_t = fg.gather_frame_stacks(**wrapper_args(
        n_step=14, ring=torch.zeros((20, 2, 16), dtype=torch.uint8)))
    assert out_a.shape == (3, 2, 16)


def test_wrapper_rejects_other_devices():
    ring = torch.zeros((4, 2, 16), dtype=torch.uint8, device="meta")
    idx = torch.zeros((3,), dtype=torch.int32, device="meta")
    mask = torch.ones((3, 2), dtype=torch.uint8, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        fg.gather_frame_stacks(ring, idx, idx, mask, mask, K=2, n_step=1)


K, H, W = 4, 8, 12
T_BLK, B_LANES = 8, 2


def replay_blocks(rng, n_blocks):
    """Numpy [T, B] blocks with dones, timeouts and distinct rewards."""
    blocks = []
    for i in range(n_blocks):
        frames = rng.integers(0, 256, (T_BLK, B_LANES, 1, H, W), dtype=np.uint8)
        obs = np.concatenate(
            [np.zeros((T_BLK, B_LANES, K - 1, H, W), np.uint8), frames], 2)
        blocks.append(dict(
            observation=obs,
            action=rng.integers(0, 6, (T_BLK, B_LANES)).astype(np.int32),
            reward=rng.normal(size=(T_BLK, B_LANES)).astype(np.float32),
            done=rng.random((T_BLK, B_LANES)) < 0.2,
            timeout=rng.random((T_BLK, B_LANES)) < 0.1))
    return blocks


@pytest.mark.parametrize("n_step", [1, 3])
def test_frame_replay_extract_batch_matches_jax(n_step):
    """7 appends into a ring of 5 blocks: wrap-around and overwrite."""
    rng = np.random.default_rng(n_step)
    blocks = replay_blocks(rng, 7)
    kw = dict(size=T_BLK * B_LANES * 5, B=B_LANES, sample_T=T_BLK,
              discount=0.99, n_step_return=n_step, frames_per_obs=K)
    jbuf = JaxFrameBuffer(**kw)
    jstate = jbuf.init(JaxSamplesToBuffer(
        observation=jnp.zeros((K, H, W), jnp.uint8),
        action=jnp.zeros((), jnp.int32), reward=jnp.zeros((), jnp.float32),
        done=jnp.zeros((), jnp.bool_), timeout=jnp.zeros((), jnp.bool_)))
    tbuf = UniformFrameReplayBuffer(**kw, device="cpu")
    tbuf.init(SamplesToBuffer(
        observation=torch.zeros((K, H, W), dtype=torch.uint8),
        action=torch.zeros((), dtype=torch.int64),
        reward=torch.zeros(()), done=torch.zeros((), dtype=torch.bool),
        timeout=torch.zeros((), dtype=torch.bool)))
    for blk in blocks:
        jstate = jbuf.append(jstate, JaxSamplesToBuffer(
            **{k: jnp.asarray(v) for k, v in blk.items()}))
        tbuf.append(SamplesToBuffer(
            **{k: torch.from_numpy(v) for k, v in blk.items()}))
    assert tbuf.t == int(jstate.t) and tbuf.filled_t == int(jstate.filled_t)
    t_idx, b_idx = jbuf.sample_idxs(jstate, jax.random.key(7), 64)
    js = jbuf.extract_batch(jstate, t_idx, b_idx)
    ts = tbuf.extract_batch(torch.tensor(np.array(t_idx)).long(),
                            torch.tensor(np.array(b_idx)).long())
    for name in ("action", "return_", "done", "done_n", "timeout_n"):
        np.testing.assert_array_equal(getattr(ts, name).numpy(),
                                      np.asarray(getattr(js, name)),
                                      err_msg=name)
    for which in ("agent_inputs", "target_inputs"):
        for field in ("observation", "prev_action", "prev_reward"):
            np.testing.assert_array_equal(
                getattr(getattr(ts, which), field).numpy(),
                np.asarray(getattr(getattr(js, which), field)),
                err_msg=f"{which}.{field}")
    # The samples really cross episode boundaries: some frames are masked.
    obs = ts.agent_inputs.observation.numpy()
    assert (obs.reshape(64, K, -1).max(-1)[:, :K - 1] == 0).any()


@pytest.mark.cuda
def test_cuda_kernel_matches_plain(cuda_device):
    """On the card: the kernel against its plain version, bit-exact."""
    rng = np.random.default_rng(0)
    for (size_T, B, F, batch, K_, n) in [(64, 8, 8320, 64, 4, 1),
                                         (40, 3, 8321, 17, 4, 3)]:
        ring, start, b_idx, ma, mt = gather_case(rng, size_T, B, F, batch,
                                                 K_, n)
        args = [torch.from_numpy(x).to(cuda_device) for x in
                (ring, start, b_idx, ma.astype(np.uint8),
                 mt.astype(np.uint8))]
        out = fg.gather_frame_stacks(*args, K=K_, n_step=n)
        ref = fg.gather_frame_stacks_plain(*args, K=K_, n_step=n)
        for o, r in zip(out, ref):
            assert torch.equal(o, r)
        # Both stacks are halves of one buffer, each contiguous, and
        # int64 indices give the same stacks as int32.
        assert out[1].data_ptr() - out[0].data_ptr() == out[0].numel()
        assert out[0].is_contiguous() and out[1].is_contiguous()
        args[1], args[2] = args[1].long(), args[2].long()
        for o, r in zip(fg.gather_frame_stacks(*args, K=K_, n_step=n), ref):
            assert torch.equal(o, r)
