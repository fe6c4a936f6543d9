"""Port's prioritized replay (rlpyt_tpu_torch/replay/prioritized.py and
PrioritizedFrameReplayBuffer) against the JAX package's.

Appends, the guard-zone mask and ``extract_batch`` are compared bit for
bit.  Sampled indices are compared bit for bit too, from the same
uniforms: the test draws ``jax.random.uniform(key, (batch,))``, which is
what the JAX ``sample`` draws from ``key``, and hands the values to the
port's ``idxs_from_uniforms``.  For that comparison the stored priorities
are multiples of 1/8, so every prefix sum is exact in float32 and does
not depend on the order in which ``cumsum`` adds (torch's and
``jnp.cumsum``'s orders differ).  Importance weights and written-back
priorities are held to rtol=1e-6, atol=1e-6 (``pow`` may differ in the
last bit between the two libraries).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rlpyt_tpu.replay.base import SamplesToBuffer as JaxSamplesToBuffer
from rlpyt_tpu.replay.frame import \
    PrioritizedFrameReplayBuffer as JaxPrioritizedFrameBuffer
from rlpyt_tpu.replay.prioritized import \
    PrioritizedReplayBuffer as JaxPrioritizedBuffer
from rlpyt_tpu_torch.replay.base import SamplesToBuffer
from rlpyt_tpu_torch.replay.frame import PrioritizedFrameReplayBuffer
from rlpyt_tpu_torch.replay.prioritized import PrioritizedReplayBuffer

torch.set_num_threads(2)

K, H, W = 4, 8, 12
T_BLK, B_LANES, N_BLOCKS = 8, 2, 5      # ring: 40 rows x 2 lanes
ALPHA, BETA = 0.5, 0.4
PAIRS = {"flat": (JaxPrioritizedBuffer, PrioritizedReplayBuffer, {}),
         "frame": (JaxPrioritizedFrameBuffer, PrioritizedFrameReplayBuffer,
                   dict(frames_per_obs=K))}


def replay_blocks(rng, n_blocks):
    """Numpy [T, B] blocks with dones, timeouts and distinct rewards."""
    blocks = []
    for _ in range(n_blocks):
        frames = rng.integers(0, 256, (T_BLK, B_LANES, 1, H, W),
                              dtype=np.uint8)
        obs = np.concatenate(
            [np.zeros((T_BLK, B_LANES, K - 1, H, W), np.uint8), frames], 2)
        blocks.append(dict(
            observation=obs,
            action=rng.integers(0, 6, (T_BLK, B_LANES)).astype(np.int32),
            reward=rng.normal(size=(T_BLK, B_LANES)).astype(np.float32),
            done=rng.random((T_BLK, B_LANES)) < 0.2,
            timeout=rng.random((T_BLK, B_LANES)) < 0.1))
    return blocks


def filled_pair(kind, n_step, n_appends, seed=0):
    """The JAX buffer with its state and the port's buffer after the same
    ``n_appends`` blocks (more than N_BLOCKS: wrap-around and overwrite)."""
    JaxCls, Cls, extra = PAIRS[kind]
    kw = dict(size=T_BLK * B_LANES * N_BLOCKS, B=B_LANES, sample_T=T_BLK,
              discount=0.99, n_step_return=n_step, alpha=ALPHA, beta=BETA,
              **extra)
    jbuf = JaxCls(**kw)
    jstate = jbuf.init(JaxSamplesToBuffer(
        observation=jnp.zeros((K, H, W), jnp.uint8),
        action=jnp.zeros((), jnp.int32), reward=jnp.zeros((), jnp.float32),
        done=jnp.zeros((), jnp.bool_), timeout=jnp.zeros((), jnp.bool_)))
    tbuf = Cls(**kw, device="cpu")
    tbuf.init(SamplesToBuffer(
        observation=torch.zeros((K, H, W), dtype=torch.uint8),
        action=torch.zeros((), dtype=torch.int64),
        reward=torch.zeros(()), done=torch.zeros((), dtype=torch.bool),
        timeout=torch.zeros((), dtype=torch.bool)))
    for blk in replay_blocks(np.random.default_rng(seed), n_appends):
        jstate = jbuf.append(jstate, JaxSamplesToBuffer(
            **{k: jnp.asarray(v) for k, v in blk.items()}))
        tbuf.append(SamplesToBuffer(
            **{k: torch.from_numpy(v) for k, v in blk.items()}))
    return jbuf, jstate, tbuf


def assert_same_priorities(tbuf, jstate, exact=True):
    got, want = tbuf.priorities.numpy(), np.asarray(jstate.priorities)
    if exact:
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(float(tbuf.max_priority),
                               float(jstate.max_priority), rtol=1e-6)


@pytest.mark.parametrize("n_appends", [3, 7])
@pytest.mark.parametrize("kind,n_step", [("flat", 1), ("frame", 3)])
def test_append_and_masked_priorities_match_jax(kind, n_step, n_appends):
    jbuf, jstate, tbuf = filled_pair(kind, n_step, n_appends)
    assert tbuf.t == int(jstate.t) and tbuf.filled_t == int(jstate.filled_t)
    assert (tbuf.off_forward, tbuf.off_backward) == \
        (jbuf.off_forward, jbuf.off_backward)
    assert_same_priorities(tbuf, jstate)
    masked = tbuf._masked_priorities().numpy()
    np.testing.assert_array_equal(
        masked, np.asarray(jbuf._masked_priorities(jstate)))
    # The guard zones are really there: some written rows are masked.
    assert (masked == 0).sum() > (tbuf.priorities.numpy() == 0).sum()


@pytest.mark.parametrize("kind,n_step", [("flat", 1), ("frame", 3)])
def test_update_priorities_and_next_append_match_jax(kind, n_step):
    jbuf, jstate, tbuf = filled_pair(kind, n_step, 6)
    rng = np.random.default_rng(5)
    flat = rng.choice(tbuf.size_T * B_LANES, 24, replace=False)
    t_idx, b_idx = flat // B_LANES, flat % B_LANES
    # Below the 1e-6 clip, below and above the running max of 1.
    pri = np.concatenate([[0.0, 1e-9], rng.random(20) * 0.9,
                          [3.5, 2.25]]).astype(np.float32)
    jstate = jbuf.update_priorities(
        jstate, (jnp.asarray(t_idx), jnp.asarray(b_idx)), jnp.asarray(pri))
    tbuf.update_priorities((torch.from_numpy(t_idx), torch.from_numpy(b_idx)),
                           torch.from_numpy(pri))
    assert_same_priorities(tbuf, jstate, exact=False)
    assert float(tbuf.max_priority) == 3.5
    assert tbuf.priorities[t_idx[0], b_idx[0]] == \
        pytest.approx(1e-6 ** ALPHA, rel=1e-5)
    # The next append stores max_priority ** alpha on the new rows.
    blk = replay_blocks(np.random.default_rng(9), 1)[0]
    t0 = tbuf.t
    jstate = jbuf.append(jstate, JaxSamplesToBuffer(
        **{k: jnp.asarray(v) for k, v in blk.items()}))
    tbuf.append(SamplesToBuffer(
        **{k: torch.from_numpy(v) for k, v in blk.items()}))
    assert_same_priorities(tbuf, jstate, exact=False)
    np.testing.assert_allclose(tbuf.priorities[t0:t0 + T_BLK].numpy(),
                               3.5 ** ALPHA, rtol=1e-6)


def dyadic_priorities(rng, shape):
    """Multiples of 1/8 in [1/8, 4]: sums of them are exact in float32."""
    return (rng.integers(1, 33, shape) / 8.0).astype(np.float32)


@pytest.mark.parametrize("n_appends,batch", [(3, 16), (7, 16), (7, 64)])
@pytest.mark.parametrize("kind,n_step", [("flat", 1), ("frame", 3)])
def test_sampled_indices_and_weights_match_jax(kind, n_step, n_appends,
                                               batch):
    jbuf, jstate, tbuf = filled_pair(kind, n_step, n_appends, seed=1)
    rng = np.random.default_rng(n_appends + batch)
    pri = dyadic_priorities(rng, (tbuf.size_T, B_LANES))
    pri[np.asarray(jstate.priorities) == 0] = 0      # unwritten rows
    jstate = jstate._replace(priorities=jnp.asarray(pri))
    tbuf.priorities = torch.from_numpy(pri.copy())
    key = jax.random.key(11)
    u = np.asarray(jax.random.uniform(key, (batch,)))
    t_idx, b_idx, w = tbuf.idxs_from_uniforms(torch.tensor(u))

    if kind == "frame":
        js = jbuf.sample(jstate, key, batch)
        j_t, j_b = js.indices
        j_w = js.is_weights
    else:
        # The JAX flat buffer's sample() goes on to gather observations,
        # which the port's flat buffer does not do yet: repeat its index
        # and weight lines (rlpyt_tpu/replay/prioritized.py:87-103).
        flat = jbuf._masked_priorities(jstate).reshape(-1)
        cdf = jnp.cumsum(flat)
        targets = (jnp.arange(batch) + jnp.asarray(u)) * (cdf[-1] / batch)
        idx = jnp.minimum(jnp.searchsorted(cdf, targets, side="right"),
                          flat.shape[0] - 1)
        j_t, j_b = idx // B_LANES, idx % B_LANES
        probs = flat[idx] / jnp.maximum(cdf[-1], 1e-12)
        j_w = (1.0 / (jnp.maximum(jnp.sum(flat > 0), 1).astype(jnp.float32)
                      * jnp.maximum(probs, 1e-12))) ** BETA
        j_w = j_w / jnp.maximum(jnp.max(j_w), 1e-12)
    np.testing.assert_array_equal(t_idx.numpy(), np.asarray(j_t))
    np.testing.assert_array_equal(b_idx.numpy(), np.asarray(j_b))
    np.testing.assert_allclose(w.numpy(), np.asarray(j_w), rtol=1e-6,
                               atol=1e-6)
    assert w.max() == 1.0 and w.min() > 0 and len(set(w.tolist())) > 3
    # Every draw is a valid row: inside the guard zones' complement.
    assert (tbuf._masked_priorities()[t_idx, b_idx] > 0).all()

    if kind == "frame":
        ts = tbuf.extract_batch(t_idx, b_idx, w)
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
        assert ts.is_weights is w


def test_sample_draws_from_the_generator():
    """``sample`` = ``idxs_from_uniforms`` of the generator's uniforms."""
    _, _, tbuf = filled_pair("frame", 3, 7)
    tbuf.priorities = torch.from_numpy(dyadic_priorities(
        np.random.default_rng(0), (tbuf.size_T, B_LANES)))
    u = torch.rand((16,), generator=torch.Generator().manual_seed(3))
    batch = tbuf.sample(16, torch.Generator().manual_seed(3))
    t_idx, b_idx, w = tbuf.idxs_from_uniforms(u)
    assert torch.equal(batch.indices[0], t_idx)
    assert torch.equal(batch.indices[1], b_idx)
    assert torch.equal(batch.is_weights, w)
    # High-priority rows are drawn more often than low-priority ones.
    tbuf.priorities[:] = 0.125
    tbuf.priorities[20] = 8.0
    t_idx, _, w = tbuf.idxs_from_uniforms(u)
    assert (t_idx == 20).sum() >= 8
    assert (w[t_idx == 20] < w[t_idx != 20].min()).all()
