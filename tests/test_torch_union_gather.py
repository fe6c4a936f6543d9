"""Port's unmasked union gathers (rlpyt_tpu_torch/ops/union_gather.py, K5
and K6) against bench_gather_formulations.py: its indexed form
``ring[rows_u, b]`` in numpy and, at a tiny ``F % 128 == 0`` shape, its two
Pallas kernels in interpret mode.  That harness allocates its full-size
ring when it is imported, so the two ``pallas_call``s are rebuilt here from
its lines 102-156 with the shapes as arguments.  All checks are bit-exact
and include starts whose windows wrap past the ring's end.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from rlpyt_tpu_torch.ops import union_gather as ug

torch.set_num_threads(2)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


def union_case(rng, size_T, B, F, U, batch):
    """Numpy ring and indices; the first samples start in the last rows."""
    ring = rng.integers(0, 256, (size_T, B, F), dtype=np.uint8)
    start = rng.integers(0, size_T, batch).astype(np.int32)
    n_wrap = min(batch, size_T, U + 1)
    start[:n_wrap] = size_T - 1 - np.arange(n_wrap)
    b_idx = rng.integers(0, B, batch).astype(np.int32)
    return ring, start, b_idx


def numpy_union(ring, start, b_idx, U):
    """bench_gather_formulations.py:97 xla_row."""
    rows = (start[:, None] + np.arange(U)[None, :]) % ring.shape[0]
    return ring[rows, b_idx[:, None]]


def make_lane_major(ring, U):
    """bench_gather_formulations.py:133, with [.., F] rows unsplit."""
    x = jnp.swapaxes(ring, 0, 1)
    return jnp.concatenate([x, x[:, :U - 1]], axis=1)


def _copy_kernel(st_ref, bi_ref, in_ref, out_ref):
    out_ref[...] = in_ref[...]


def pallas_row(ring, st, bi, U):
    """bench_gather_formulations.py:106, interpret mode."""
    size_T, B, F = ring.shape
    SB, batch = F // 128, st.shape[0]
    grid_spec = pltpu.PrefetchScalarGridSpec(
        num_scalar_prefetch=2, grid=(batch, U),
        in_specs=[pl.BlockSpec(
            (pl.Squeezed(), pl.Blocked(SB), pl.Blocked(128)),
            lambda i, j, stp, bip: (
                ((stp[i] + j) % size_T) * B + bip[i], 0, 0))],
        out_specs=pl.BlockSpec(
            (pl.Squeezed(), pl.Squeezed(), pl.Blocked(SB), pl.Blocked(128)),
            lambda i, j, stp, bip: (i, j, 0, 0)))
    out = pl.pallas_call(
        _copy_kernel,
        out_shape=jax.ShapeDtypeStruct((batch, U, SB, 128), jnp.uint8),
        grid_spec=grid_spec, interpret=True,
    )(st, bi, ring.reshape(size_T * B, SB, 128))
    return out.reshape(batch, U, F)


def _copy_kernel_sq(st_ref, bi_ref, in_ref, out_ref):
    out_ref[...] = in_ref[0]


def pallas_window(ring_lm, st, bi, U):
    """bench_gather_formulations.py:138, interpret mode."""
    B, NT, F = ring_lm.shape
    SB, batch = F // 128, st.shape[0]
    grid_spec = pltpu.PrefetchScalarGridSpec(
        num_scalar_prefetch=2, grid=(batch,),
        in_specs=[pl.BlockSpec(
            (pl.Element(1), pl.Element(U), pl.Element(SB), pl.Element(128)),
            lambda i, stp, bip: (bip[i], stp[i], 0, 0))],
        out_specs=pl.BlockSpec(
            (pl.Squeezed(), pl.Blocked(U), pl.Blocked(SB), pl.Blocked(128)),
            lambda i, stp, bip: (i, 0, 0, 0)))
    return pl.pallas_call(
        _copy_kernel_sq,
        out_shape=jax.ShapeDtypeStruct((batch, U, SB, 128), jnp.uint8),
        grid_spec=grid_spec, interpret=True,
    )(st, bi, ring_lm.reshape(B, NT, SB, 128)).reshape(batch, U, F)


def port_rows(ring, start, b_idx, U):
    return ug.gather_union_rows(torch.from_numpy(ring),
                                torch.from_numpy(start),
                                torch.from_numpy(b_idx), U).numpy()


def port_window(ring, start, b_idx, U):
    ring_lm = ug.lane_major_ring(torch.from_numpy(ring), U)
    return ug.gather_union_window(ring_lm, torch.from_numpy(start),
                                  torch.from_numpy(b_idx), U).numpy()


SHAPES = [(12, 3, 256, 7, 11), (9, 5, 130, 1, 3), (16, 2, 100, 5, 8),
          (8, 4, 33, 8, 6)]


@pytest.mark.parametrize("shape", SHAPES, ids=str)
@pytest.mark.parametrize("gather", [port_rows, port_window],
                         ids=["rows", "window"])
def test_plain_matches_indexed_numpy(gather, shape):
    size_T, B, F, U, batch = shape
    ring, start, b_idx = union_case(np.random.default_rng(F), *shape)
    assert (start + U > size_T).any() or U == 1     # windows that wrap
    out = gather(ring, start, b_idx, U)
    assert out.dtype == np.uint8 and out.shape == (batch, U, F)
    np.testing.assert_array_equal(out, numpy_union(ring, start, b_idx, U))


@pytest.mark.parametrize("U", [7, 2])
def test_plain_matches_pallas_row_interpret(U):
    shape = (12, 3, 256, U, 9)
    ring, start, b_idx = union_case(np.random.default_rng(U), *shape)
    ref = pallas_row(jnp.asarray(ring), jnp.asarray(start),
                     jnp.asarray(b_idx), U)
    np.testing.assert_array_equal(port_rows(ring, start, b_idx, U),
                                  np.asarray(ref))


@pytest.mark.parametrize("U", [7, 2])
def test_plain_matches_pallas_window_interpret(U):
    """Starts in the last U - 1 rows read the ghost rows in both."""
    shape = (12, 3, 256, U, 9)
    ring, start, b_idx = union_case(np.random.default_rng(10 + U), *shape)
    ref = pallas_window(make_lane_major(jnp.asarray(ring), U),
                        jnp.asarray(start), jnp.asarray(b_idx), U)
    np.testing.assert_array_equal(port_window(ring, start, b_idx, U),
                                  np.asarray(ref))


@pytest.mark.parametrize("U", [1, 4, 7])
def test_lane_major_ring_matches_make_lane_major(U):
    ring = np.random.default_rng(U).integers(0, 256, (10, 3, 256),
                                             dtype=np.uint8)
    out = ug.lane_major_ring(torch.from_numpy(ring), U)
    assert out.is_contiguous() and out.shape == (3, 10 + U - 1, 256)
    np.testing.assert_array_equal(
        out.numpy(), np.asarray(make_lane_major(jnp.asarray(ring), U)))
    with pytest.raises(ValueError, match="U"):
        ug.lane_major_ring(torch.from_numpy(ring), 12)


@pytest.mark.parametrize("gather", [ug.gather_union_rows,
                                    ug.gather_union_window],
                         ids=["rows", "window"])
def test_wrapper_rejects_other_devices(gather):
    ring = torch.zeros((4, 2, 16), dtype=torch.uint8, device="meta")
    idx = torch.zeros((3,), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        gather(ring, idx, idx, 2)


@pytest.mark.cuda
def test_cuda_kernels_match_plain(cuda_device):
    """On the card: both kernels against their plain versions, bit-exact."""
    rng = np.random.default_rng(0)
    for shape in [(64, 8, 8320, 7, 64), (33, 3, 8321, 5, 17)]:
        U = shape[3]
        ring, start, b_idx = (torch.from_numpy(x).to(cuda_device)
                              for x in union_case(rng, *shape))
        ring_lm = ug.lane_major_ring(ring, U)
        assert torch.equal(ug.gather_union_rows(ring, start, b_idx, U),
                           ug.gather_union_rows_plain(ring, start, b_idx, U))
        assert torch.equal(
            ug.gather_union_window(ring_lm, start, b_idx, U),
            ug.gather_union_window_plain(ring_lm, start, b_idx, U))
