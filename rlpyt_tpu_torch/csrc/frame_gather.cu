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
// bytes (each union row read once, each output row written once), about
// 28 MB and 8 us at the trainers' batch of 256: so few bytes that what a
// launch pays before its first byte moves and after its last one shows.
// Design: the copy engine moves the rows, not the threads.  A CTA takes
// one part of one sample's rows (a whole row, or a 16-byte-aligned slice
// of it when the batch alone would not fill the SMs).  Warp u's first lane
// reads the sample's two indices and asks for union row u with one bulk
// copy global -> shared (cp.async.bulk) that completes on the row's own
// mbarrier; all U loads of a CTA are in flight at once and no thread
// spends registers on the data.  Meanwhile the CTA zeroes one spare row in
// shared memory.  When row u has landed, the same lane writes it to the
// one or two output rows it belongs to with bulk copies shared -> global,
// from the row or from the zero row as the mask byte says, so a row's
// stores overlap the other rows' loads.  Rows wrap by index math: the ring
// needs no ghost rows (the TPU kernels kept them so each window was one
// contiguous DMA).  Indices are int32 or int64 as the caller has them.
//
// Bulk copies need 16-byte aligned addresses and sizes: rows with
// F % 16 != 0, or a ring or output that is not 16-byte aligned, take a
// plain kernel that loads each union byte once into registers and stores
// it to both stacks.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxU = 16;   // K + n_step; checked by the host wrapper
constexpr int kByteThreads = 128;
constexpr int kMaxBulkSmem = 96 * 1024;   // two CTAs to an SM at the least

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Orders this thread's writes to shared memory (a zeroed row, an
// initialised mbarrier) before the copy engine's later reads of it.
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

template <typename I>
__device__ __forceinline__ int64_t ring_row(const I* start_rows, int i, int u,
                                            int size_T) {
  int64_t r = ((int64_t)start_rows[i] + u) % size_T;
  return r < 0 ? r + size_T : r;
}

// blockIdx.x = sample, blockIdx.y = part of the row; 32 * U threads.
template <typename I>
__global__ void gather_bulk_kernel(
    const uint8_t* __restrict__ ring, const I* __restrict__ start_rows,
    const I* __restrict__ b_idx, const uint8_t* __restrict__ mask_a,
    const uint8_t* __restrict__ mask_t, uint8_t* __restrict__ out_a,
    uint8_t* __restrict__ out_t, int size_T, int B, int F, int K, int n_step,
    int part) {
  extern __shared__ __align__(128) uint8_t rows[];   // [U + 1][part]
  __shared__ __align__(8) uint64_t bars[kMaxU];
  const int i = blockIdx.x;
  const int off = blockIdx.y * part;
  const uint32_t len = min(part, F - off);
  const int U = K + n_step;
  const int u = threadIdx.x / 32;
  const bool issuer = threadIdx.x % 32 == 0;
  const uint32_t bar = smem_u32(&bars[u]);
  const uint32_t row = smem_u32(rows + (size_t)u * part);

  if (issuer) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(bar)
                 : "memory");
    fence_proxy_async();
    const uint8_t* src =
        ring +
        (ring_row(start_rows, i, u, size_T) * B + (int64_t)b_idx[i]) * F + off;
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::
                     "r"(bar), "r"(len)
                 : "memory");
    asm volatile(
        "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
        "[%0], [%1], %2, [%3];\n" ::"r"(row), "l"(src), "r"(len), "r"(bar)
        : "memory");
  }
  uint4* zeros = reinterpret_cast<uint4*>(rows + (size_t)U * part);
  for (int j = threadIdx.x; j < len / 16; j += blockDim.x)
    zeros[j] = make_uint4(0u, 0u, 0u, 0u);
  fence_proxy_async();
  __syncthreads();

  if (issuer) {
    const uint32_t zero_row = smem_u32(zeros);
    const int k = u - n_step;
    const bool keep_a = u < K && mask_a[i * K + u];
    const bool keep_t = k >= 0 && mask_t[i * K + k];
    uint32_t landed = 0;
    while (!landed)
      asm volatile(
          "{\n.reg .pred p;\n"
          "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], 0;\n"
          "selp.u32 %0, 1, 0, p;\n}\n"
          : "=r"(landed)
          : "r"(bar)
          : "memory");
    if (u < K)
      asm volatile("cp.async.bulk.global.shared::cta.bulk_group "
                   "[%0], [%1], %2;\n" ::"l"(out_a + ((int64_t)i * K + u) * F +
                                             off),
                   "r"(keep_a ? row : zero_row), "r"(len)
                   : "memory");
    if (k >= 0)
      asm volatile("cp.async.bulk.global.shared::cta.bulk_group "
                   "[%0], [%1], %2;\n" ::"l"(out_t + ((int64_t)i * K + k) * F +
                                             off),
                   "r"(keep_t ? row : zero_row), "r"(len)
                   : "memory");
    asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
    // Shared memory must outlive the copy engine's reads of it.
    asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
  }
}

// Any F, any alignment.  blockIdx.x = sample, blockIdx.y = chunk of the
// row; one thread owns one byte of every union row.
template <typename I>
__global__ void __launch_bounds__(kByteThreads)
gather_bytes_kernel(const uint8_t* __restrict__ ring,
                    const I* __restrict__ start_rows,
                    const I* __restrict__ b_idx,
                    const uint8_t* __restrict__ mask_a,
                    const uint8_t* __restrict__ mask_t,
                    uint8_t* __restrict__ out_a, uint8_t* __restrict__ out_t,
                    int size_T, int B, int F, int K, int n_step) {
  const int i = blockIdx.x;
  const int j = blockIdx.y * kByteThreads + threadIdx.x;
  if (j >= F) return;
  const int U = K + n_step;
  const int64_t b = b_idx[i];

  uint8_t v[kMaxU];
#pragma unroll
  for (int u = 0; u < kMaxU; ++u)
    if (u < U) v[u] = ring[(ring_row(start_rows, i, u, size_T) * B + b) * F + j];
#pragma unroll
  for (int u = 0; u < kMaxU; ++u) {
    if (u < K)
      out_a[((int64_t)i * K + u) * F + j] = mask_a[i * K + u] ? v[u] : 0;
    const int k = u - n_step;
    if (u < U && k >= 0)
      out_t[((int64_t)i * K + k) * F + j] = mask_t[i * K + k] ? v[u] : 0;
  }
}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15u) == 0;
}

template <typename I>
cudaError_t launch(const uint8_t* ring, const void* start_rows,
                   const void* b_idx, const uint8_t* mask_a,
                   const uint8_t* mask_t, uint8_t* out_a, uint8_t* out_t,
                   int size_T, int B, int F, int K, int n_step, int batch,
                   cudaStream_t stream) {
  const auto* st = static_cast<const I*>(start_rows);
  const auto* bi = static_cast<const I*>(b_idx);
  const int U = K + n_step;
  if (F % 16 != 0 || !aligned16(ring) || !aligned16(out_a) ||
      !aligned16(out_t)) {
    dim3 grid(batch, (F + kByteThreads - 1) / kByteThreads);
    gather_bytes_kernel<I><<<grid, kByteThreads, 0, stream>>>(
        ring, st, bi, mask_a, mask_t, out_a, out_t, size_T, B, F, K, n_step);
    return cudaGetLastError();
  }
  static int n_sm = 0;
  static bool opted_in = false;
  cudaError_t err;
  if (n_sm == 0) {
    int dev = 0;
    if ((err = cudaGetDevice(&dev)) != cudaSuccess) return err;
    if ((err = cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount,
                                      dev)) != cudaSuccess)
      return err;
  }
  if (!opted_in) {
    if ((err = cudaFuncSetAttribute(
             gather_bulk_kernel<I>, cudaFuncAttributeMaxDynamicSharedMemorySize,
             kMaxBulkSmem)) != cudaSuccess)
      return err;
    opted_in = true;
  }
  // A part is a whole row when the batch alone gives every SM two CTAs;
  // else rows are cut, into parts of 1 KB at the least, and further until
  // the U + 1 rows of a CTA fit its shared memory.
  const int FV = F / 16;
  int parts = (2 * n_sm + batch - 1) / batch;
  if (parts > FV / 64) parts = FV / 64;
  if (parts < 1) parts = 1;
  int part_v = (FV + parts - 1) / parts;
  while ((U + 1) * part_v * 16 > kMaxBulkSmem && part_v > 1)
    part_v = (part_v + 1) / 2;
  dim3 grid(batch, (FV + part_v - 1) / part_v);
  gather_bulk_kernel<I><<<grid, 32 * U, (size_t)(U + 1) * part_v * 16, stream>>>(
      ring, st, bi, mask_a, mask_t, out_a, out_t, size_T, B, F, K, n_step,
      part_v * 16);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

int frame_gather_max_u() { return kMaxU; }

// Launch on ``stream``; returns the cudaError_t of the launch (0 = ok).
// start_rows and b_idx are both int64 (idx64 != 0) or both int32.
int frame_gather_launch(const void* ring, const void* start_rows,
                        const void* b_idx, const void* mask_a,
                        const void* mask_t, void* out_a, void* out_t,
                        int size_T, int B, int F, int K, int n_step,
                        int batch, int idx64, void* stream) {
  if (batch == 0 || F == 0) return 0;
  const auto launch_fn = idx64 ? launch<int64_t> : launch<int32_t>;
  return static_cast<int>(launch_fn(
      static_cast<const uint8_t*>(ring), start_rows, b_idx,
      static_cast<const uint8_t*>(mask_a), static_cast<const uint8_t*>(mask_t),
      static_cast<uint8_t*>(out_a), static_cast<uint8_t*>(out_t), size_T, B,
      F, K, n_step, batch, static_cast<cudaStream_t>(stream)));
}

const char* frame_gather_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
