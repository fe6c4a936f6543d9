// Unmasked union-window gathers for Hopper (sm_90a): the two replay-gather
// formulations that bench_gather_formulations.py holds beside the shipped
// gather, as kernels of their own.
//
// Replaces the two TPU Pallas kernels of that harness:
//   K5 bench_gather_formulations.py:106 pallas_row (kernel body :102):
//      output row p of sample i is ring row (start[i] + p) mod size_T of
//      lane b_idx[i] of a time-major ring [size_T, B, F]; each row is
//      addressed on its own.
//   K6 bench_gather_formulations.py:138 pallas_window (kernel body :129):
//      the same union read as ONE contiguous span of U*F bytes from a
//      lane-major ring [B, size_T + U - 1, F] whose last U - 1 rows mirror
//      rows [0, U - 1) (ghost rows), so a window never wraps.
// Both write out[i] = the [U, F] union of sample i, uint8, unmasked.
//
// Bound: HBM bytes.  A pure indexed copy of 2 * batch * U * F bytes (each
// union byte read once and written once) with no arithmetic.  The design
// keeps loads in flight: a thread block copies a span with 16-byte vector
// loads and stores, four independent loads per thread issued before their
// stores.  K5 gives one block to each (sample, row) pair and computes that
// row's address (64-bit: row * B * F passes 2^31); K6 cuts each sample's
// window into fixed chunks that ignore row boundaries, which is what the
// lane-major layout buys.  Rows or windows that are not 16-byte aligned
// (ragged F, an offset base pointer) take the same kernels with one-byte
// elements.  No (8, 128) tiling and no F % 128 rule of the TPU kernels is
// carried over; any U >= 1 and any F work.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kInFlight = 4;                       // loads per thread
constexpr int kChunk = 2 * kInFlight * kThreads;   // K6: elements per block

// Copy n elements with the whole block; kInFlight loads before the stores.
template <typename V>
__device__ __forceinline__ void copy_span(const V* __restrict__ src,
                                          V* __restrict__ dst, int n) {
  int j = threadIdx.x;
  for (; j + (kInFlight - 1) * kThreads < n; j += kInFlight * kThreads) {
    V v[kInFlight];
#pragma unroll
    for (int q = 0; q < kInFlight; ++q) v[q] = src[j + q * kThreads];
#pragma unroll
    for (int q = 0; q < kInFlight; ++q) dst[j + q * kThreads] = v[q];
  }
  for (; j < n; j += kThreads) dst[j] = src[j];
}

__device__ __forceinline__ int wrap(int r, int size_T) {
  r %= size_T;
  return r < 0 ? r + size_T : r;
}

// K5.  Grid: x = sample * U + p.  FV = elements of V per row.
template <typename V>
__global__ void __launch_bounds__(kThreads)
union_rows_kernel(const V* __restrict__ ring,
                  const int32_t* __restrict__ start,
                  const int32_t* __restrict__ b_idx, V* __restrict__ out,
                  int size_T, int B, int FV, int U) {
  const int i = blockIdx.x / U;
  const int p = blockIdx.x - i * U;
  const int64_t r = wrap(start[i] + p, size_T);
  const V* src = ring + (r * B + b_idx[i]) * FV;
  copy_span(src, out + (int64_t)blockIdx.x * FV, FV);
}

// K6.  Grid: x = sample, y = chunk of the window.  NT = size_T + U - 1
// rows per lane; WV = U * F / sizeof(V) elements per window.
template <typename V>
__global__ void __launch_bounds__(kThreads)
union_window_kernel(const V* __restrict__ ring_lm,
                    const int32_t* __restrict__ start,
                    const int32_t* __restrict__ b_idx, V* __restrict__ out,
                    int NT, int size_T, int FV, int WV) {
  const int i = blockIdx.x;
  const int c0 = blockIdx.y * kChunk;
  const int64_t row = (int64_t)b_idx[i] * NT + wrap(start[i], size_T);
  const V* src = ring_lm + row * FV + c0;
  const int n = min(kChunk, WV - c0);
  copy_span(src, out + (int64_t)i * WV + c0, n);
}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15u) == 0;
}

}  // namespace

extern "C" {

// K5 launch on ``stream``; returns the cudaError_t of the launch (0 = ok).
int union_rows_launch(const void* ring, const void* start, const void* b_idx,
                      void* out, int size_T, int B, int F, int U, int batch,
                      void* stream) {
  if (batch == 0 || F == 0 || U == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto* st = static_cast<const int32_t*>(start);
  const auto* bi = static_cast<const int32_t*>(b_idx);
  const unsigned grid = static_cast<unsigned>(batch) * U;
  if (F % 16 == 0 && aligned16(ring) && aligned16(out)) {
    union_rows_kernel<uint4><<<grid, kThreads, 0, s>>>(
        static_cast<const uint4*>(ring), st, bi, static_cast<uint4*>(out),
        size_T, B, F / 16, U);
  } else {
    union_rows_kernel<uint8_t><<<grid, kThreads, 0, s>>>(
        static_cast<const uint8_t*>(ring), st, bi,
        static_cast<uint8_t*>(out), size_T, B, F, U);
  }
  return static_cast<int>(cudaGetLastError());
}

// K6 launch.  ``ring_lm`` is [B, size_T + U - 1, F].
int union_window_launch(const void* ring_lm, const void* start,
                        const void* b_idx, void* out, int size_T, int F,
                        int U, int batch, void* stream) {
  if (batch == 0 || F == 0 || U == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto* st = static_cast<const int32_t*>(start);
  const auto* bi = static_cast<const int32_t*>(b_idx);
  const int NT = size_T + U - 1;
  if (F % 16 == 0 && aligned16(ring_lm) && aligned16(out)) {
    const int WV = U * (F / 16);
    dim3 grid(batch, (WV + kChunk - 1) / kChunk);
    union_window_kernel<uint4><<<grid, kThreads, 0, s>>>(
        static_cast<const uint4*>(ring_lm), st, bi,
        static_cast<uint4*>(out), NT, size_T, F / 16, WV);
  } else {
    const int WV = U * F;
    dim3 grid(batch, (WV + kChunk - 1) / kChunk);
    union_window_kernel<uint8_t><<<grid, kThreads, 0, s>>>(
        static_cast<const uint8_t*>(ring_lm), st, bi,
        static_cast<uint8_t*>(out), NT, size_T, F, WV);
  }
  return static_cast<int>(cudaGetLastError());
}

const char* union_gather_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
