// Masked frame-stack window gather for Hopper (sm_90a).
//
// Replaces the two TPU Pallas kernels that compute this function:
//   K1 rlpyt_tpu/ops/pallas/frame_gather.py:111 gather_frame_stacks
//      (time-major ring with ghost rows, kernel body :73)
//   K2 rlpyt_tpu/ops/pallas/window_gather.py:79 gather_stacks_window
//      (lane-major ring with ghost rows, kernel body :57)
// and the shipped XLA form rlpyt_tpu/replay/frame.py:200 _obs_pair_blocked.
//
// For sample i it reads the union window of U = K + n_step rows of lane
// b_idx[i], starting at ring row start_rows[i] and wrapping mod size_T,
// and writes the agent stack (union rows 0..K-1) and the target stack
// (union rows n..n+K-1); each output row is the ring row or zeros, as its
// episode-boundary mask says.
//
// Bound: HBM bytes.  The work is a pure indexed copy, batch*(U + 2K)*F
// bytes (each union row read once, each output row written once), with
// no arithmetic to speak of.  The design moves only those bytes: every
// union row is loaded once into registers and stored to both stacks it
// belongs to, with 16-byte vector loads and stores where the rows are
// 16-byte aligned.  The ring needs no ghost rows (the TPU kernels kept
// them so each window was one contiguous DMA); rows wrap by index math.
//
// Grid: x = sample, y = chunk of the row; one thread owns one 16-byte
// vector (or one byte on the unaligned path) of every union row.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kMaxU = 16;   // K + n_step; checked by the host wrapper

template <typename V>
__global__ void __launch_bounds__(kThreads)
gather_kernel(const V* __restrict__ ring, const int32_t* __restrict__ start_rows,
              const int32_t* __restrict__ b_idx,
              const uint8_t* __restrict__ mask_a,
              const uint8_t* __restrict__ mask_t,
              V* __restrict__ out_a, V* __restrict__ out_t,
              int size_T, int B, int FV, int K, int n_step) {
  const int i = blockIdx.x;
  const int j = blockIdx.y * kThreads + threadIdx.x;   // vector within row
  if (j >= FV) return;
  const int U = K + n_step;
  const int64_t b = b_idx[i];
  const int start = start_rows[i];
  const V zero = V{};

  V v[kMaxU];
#pragma unroll
  for (int u = 0; u < kMaxU; ++u) {
    if (u < U) {
      int r = (start + u) % size_T;
      if (r < 0) r += size_T;
      v[u] = ring[((int64_t)r * B + b) * FV + j];
    }
  }
#pragma unroll
  for (int u = 0; u < kMaxU; ++u) {
    if (u < K) {
      out_a[((int64_t)i * K + u) * FV + j] = mask_a[i * K + u] ? v[u] : zero;
    }
    const int k = u - n_step;
    if (u < U && k >= 0) {
      out_t[((int64_t)i * K + k) * FV + j] = mask_t[i * K + k] ? v[u] : zero;
    }
  }
}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15u) == 0;
}

}  // namespace

extern "C" {

int frame_gather_max_u() { return kMaxU; }

// Launch on ``stream``; returns the cudaError_t of the launch (0 = ok).
int frame_gather_launch(const void* ring, const void* start_rows,
                        const void* b_idx, const void* mask_a,
                        const void* mask_t, void* out_a, void* out_t,
                        int size_T, int B, int F, int K, int n_step,
                        int batch, void* stream) {
  if (batch == 0 || F == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool vec = (F % 16 == 0) && aligned16(ring) && aligned16(out_a) &&
                   aligned16(out_t);
  const auto* st = static_cast<const int32_t*>(start_rows);
  const auto* bi = static_cast<const int32_t*>(b_idx);
  const auto* ma = static_cast<const uint8_t*>(mask_a);
  const auto* mt = static_cast<const uint8_t*>(mask_t);
  if (vec) {
    const int FV = F / 16;
    dim3 grid(batch, (FV + kThreads - 1) / kThreads);
    gather_kernel<uint4><<<grid, kThreads, 0, s>>>(
        static_cast<const uint4*>(ring), st, bi, ma, mt,
        static_cast<uint4*>(out_a), static_cast<uint4*>(out_t),
        size_T, B, FV, K, n_step);
  } else {
    dim3 grid(batch, (F + kThreads - 1) / kThreads);
    gather_kernel<uint8_t><<<grid, kThreads, 0, s>>>(
        static_cast<const uint8_t*>(ring), st, bi, ma, mt,
        static_cast<uint8_t*>(out_a), static_cast<uint8_t*>(out_t),
        size_T, B, F, K, n_step);
  }
  return static_cast<int>(cudaGetLastError());
}

const char* frame_gather_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
