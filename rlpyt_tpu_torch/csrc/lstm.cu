// Fused LSTM kernels for Hopper (sm_90a), float32 throughout.
//
// Replaces the TPU Pallas kernels of rlpyt_tpu/ops/pallas/lstm.py:
//   K3  _lstm_fwd_pallas (body _fwd_kernel :71), via lstm_pallas :276:
//       here split into
//       K3a lstm_proj:  xg[T*B, 4H] = x[T*B, F] @ W_x + b   (the x@W_x of
//           _fwd_kernel :88, hoisted out of the recurrence), and
//       K3  lstm_fwd:   the T-step recurrence over xg with W_h.
//   K4  _lstm_bwd_pallas (body _bwd_kernel :168): the reverse-time
//       recurrence that emits dgates, dh0 and dc0.  The contractions
//       after it (dx, dW_x, dW_h, db) are plain matrix products, outside
//       any kernel, as in the JAX package (lstm.py:257-262).
// Gate order is i, f, g, o; done[t] zeroes h and c before step t (the
// caller passes mask = 1 - done).
//
// What bounds them on an H100:
//   K3a is a GEMM of 2*T*B*F*4H operations (40.8 GFLOP at T*B = 1440,
//       F = 6919, H = 512): bound by the fp32 (non-tensor) rate.  W_x is
//       56.7 MB and cannot stay in shared memory, so the projection runs
//       once over all T*B rows, streaming W_x once per call, not once per
//       step.  Design: 128x128x8 shared-memory tiles, 256 threads, an 8x8
//       register block per thread; when the grid has too few tiles to
//       fill the SMs (T*B = 64 at collection), K is split over
//       blockIdx.z and a second pass adds the partial sums and the bias.
//   K3 / K4 do 2*T*B*H*4H operations in T dependent steps: on paper bound
//       by fp32 operations, in fact by the latency of each step.  Design:
//       one persistent cooperative launch per call.  CTA j owns hidden
//       units [4j, 4j+4) and all four of their gates.  It keeps its slice
//       of W_h in shared memory for the whole sequence (K3: the 16 columns
//       [H, 16]; K4: the 4 rows [4, 4H]; 32 KB each at H = 512), the
//       Hopper counterpart of the TPU keeping W_h in VMEM, and keeps its
//       units' cell state (K3) or dc carry (K4) in shared memory.  Each
//       step it reads the previous step's h (K3) or dgates (K4) of all
//       units from L2 (ld.global.cg: written by other CTAs, never cached
//       in L1), writes its own units' outputs, and the grid synchronises
//       (cooperative_groups grid.sync(), which orders the writes before
//       the next step's reads).  A warp takes 4 batch rows at a time; its
//       lanes split the contraction and reduce by shuffles; lanes
//       r*4 + u then do the pointwise cell updates of row r, unit u, all
//       16 side by side.
//       Ragged H and B are masked in the kernels; H needs no padding.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

// ---------------------------------------------------------------------
// K3a: xg = x @ W_x + b
// ---------------------------------------------------------------------

constexpr int kBM = 128, kBN = 128, kBK = 8;
constexpr int kGemmThreads = 256;

// C[z] = A[:, kz] @ B[kz, :] (+ bias) for the K range kz of blockIdx.z.
__global__ void __launch_bounds__(kGemmThreads)
proj_gemm_kernel(const float* __restrict__ A, const float* __restrict__ Bm,
                 const float* __restrict__ bias, float* __restrict__ C,
                 int M, int N, int K, int k_chunk) {
  __shared__ __align__(16) float As[kBK][kBM + 4];   // A tile, transposed
  __shared__ __align__(16) float Bs[kBK][kBN];
  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  const int m0 = blockIdx.y * kBM, n0 = blockIdx.x * kBN;
  const int kb = blockIdx.z * k_chunk;
  const int ke = min(K, kb + k_chunk);

  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

  for (int k0 = kb; k0 < ke; k0 += kBK) {
#pragma unroll
    for (int r = 0; r < (kBM * kBK) / kGemmThreads; ++r) {
      const int e = tid + r * kGemmThreads;
      const int m = e / kBK, k = e % kBK;
      const int gm = m0 + m, gk = k0 + k;
      As[k][m] = (gm < M && gk < ke) ? A[(int64_t)gm * K + gk] : 0.f;
      const int kk = e / kBN, n = e % kBN;
      const int gk2 = k0 + kk, gn = n0 + n;
      Bs[kk][n] = (gk2 < ke && gn < N) ? Bm[(int64_t)gk2 * N + gn] : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < kBK; ++k) {
      const float4 a0 = *reinterpret_cast<const float4*>(&As[k][ty * 4]);
      const float4 a1 = *reinterpret_cast<const float4*>(&As[k][64 + ty * 4]);
      const float4 b0 = *reinterpret_cast<const float4*>(&Bs[k][tx * 4]);
      const float4 b1 = *reinterpret_cast<const float4*>(&Bs[k][64 + tx * 4]);
      const float a[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const float b[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }

  float* out = C + (int64_t)blockIdx.z * M * N;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int m = m0 + (i < 4 ? ty * 4 + i : 64 + ty * 4 + i - 4);
    if (m >= M) continue;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int n = n0 + (j < 4 ? tx * 4 + j : 64 + tx * 4 + j - 4);
      if (n < N) out[(int64_t)m * N + n] = acc[i][j] + (bias ? bias[n] : 0.f);
    }
  }
}

// C = bias + sum_z part[z]
__global__ void splitk_reduce_kernel(const float* __restrict__ part,
                                     const float* __restrict__ bias,
                                     float* __restrict__ C, int M, int N,
                                     int splits) {
  const int64_t MN = (int64_t)M * N;
  const int64_t idx = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= MN) return;
  float s = 0.f;
  for (int z = 0; z < splits; ++z) s += part[z * MN + idx];
  C[idx] = s + bias[idx % N];
}

// ---------------------------------------------------------------------
// K3 / K4: persistent recurrences
// ---------------------------------------------------------------------

constexpr int kU = 4;                 // hidden units per CTA
constexpr int kQ = 4 * kU;            // gate columns per CTA
constexpr int kR = 4;                 // batch rows per warp pass
constexpr int kRecThreads = 256;
constexpr int kWarps = kRecThreads / 32;
static_assert(kR * kU <= 32, "one lane per (row, unit) pair");

__device__ __forceinline__ float sigmoid(float x) {
  return 1.f / (1.f + expf(-x));
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

__global__ void __launch_bounds__(kRecThreads)
lstm_fwd_kernel(const float* __restrict__ xg, const float* __restrict__ wh,
                const float* __restrict__ mask, const float* __restrict__ h0,
                const float* __restrict__ c0, float* y, float* gates,
                float* cs, float* hT, float* cT, int T, int B, int H) {
  extern __shared__ __align__(16) float smem[];
  float* ws = smem;              // [kQ][H]: ws[q*H + k] = W_h[k, gate col q]
  float* c_s = smem + kQ * H;    // [B][kU]: cell state of this CTA's units
  cg::grid_group grid = cg::this_grid();
  const int j0 = blockIdx.x * kU;
  const int H4 = 4 * H;
  for (int idx = threadIdx.x; idx < kQ * H; idx += blockDim.x) {
    const int k = idx / kQ, q = idx % kQ;
    const int col = j0 + q % kU;
    ws[q * H + k] = col < H ? wh[(int64_t)k * H4 + (q / kU) * H + col] : 0.f;
  }
  for (int idx = threadIdx.x; idx < B * kU; idx += blockDim.x) {
    const int col = j0 + idx % kU;
    c_s[idx] = col < H ? c0[(int64_t)(idx / kU) * H + col] : 0.f;
  }
  __syncthreads();

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  for (int t = 0; t < T; ++t) {
    const float* hprev = t == 0 ? h0 : y + (int64_t)(t - 1) * B * H;
    const float* mrow = mask + (int64_t)t * B;
    for (int rb = warp * kR; rb < B; rb += kWarps * kR) {
      float mk[kR];
      float acc[kR][kQ];
#pragma unroll
      for (int r = 0; r < kR; ++r) {
        mk[r] = rb + r < B ? mrow[rb + r] : 0.f;
#pragma unroll
        for (int q = 0; q < kQ; ++q) acc[r][q] = 0.f;
      }
      for (int k = lane; k < H; k += 32) {
        float hv[kR];
#pragma unroll
        for (int r = 0; r < kR; ++r)
          hv[r] = rb + r < B
                      ? __ldcg(hprev + (int64_t)(rb + r) * H + k) * mk[r]
                      : 0.f;
#pragma unroll
        for (int q = 0; q < kQ; ++q) {
          const float w = ws[q * H + k];
#pragma unroll
          for (int r = 0; r < kR; ++r) acc[r][q] = fmaf(hv[r], w, acc[r][q]);
        }
      }
#pragma unroll
      for (int r = 0; r < kR; ++r)
#pragma unroll
        for (int q = 0; q < kQ; ++q) acc[r][q] = warp_sum(acc[r][q]);
      // Every lane now holds every sum; lane r*kU + u takes those of its
      // (row, unit) pair, so the 16 cell updates run side by side.
      float p[4] = {0.f, 0.f, 0.f, 0.f}, m = 0.f;
#pragma unroll
      for (int r = 0; r < kR; ++r)
#pragma unroll
        for (int u = 0; u < kU; ++u)
          if (lane == r * kU + u) {
#pragma unroll
            for (int k = 0; k < 4; ++k) p[k] = acc[r][k * kU + u];
            m = mk[r];
          }
      const int b = rb + lane / kU, u = lane % kU, col = j0 + u;
      if (lane < kR * kU && b < B && col < H) {
        const int64_t row = (int64_t)t * B + b;
        const float* xrow = xg + row * H4;
        const float gi = sigmoid(p[0] + xrow[col]);
        const float gf = sigmoid(p[1] + xrow[H + col]);
        const float gg = tanhf(p[2] + xrow[2 * H + col]);
        const float go = sigmoid(p[3] + xrow[3 * H + col]);
        const float cn = gf * (c_s[b * kU + u] * m) + gi * gg;
        const float hn = go * tanhf(cn);
        c_s[b * kU + u] = cn;
        y[row * H + col] = hn;
        cs[row * H + col] = cn;
        float* grow = gates + row * H4;
        grow[col] = gi;
        grow[H + col] = gf;
        grow[2 * H + col] = gg;
        grow[3 * H + col] = go;
        if (t == T - 1) {
          hT[(int64_t)b * H + col] = hn;
          cT[(int64_t)b * H + col] = cn;
        }
      }
    }
    if (t + 1 < T) grid.sync();   // y[t] of every unit before step t+1
  }
}

__global__ void __launch_bounds__(kRecThreads)
lstm_bwd_kernel(const float* __restrict__ gates, const float* __restrict__ cs,
                const float* __restrict__ c0, const float* __restrict__ mask,
                const float* __restrict__ wh, const float* __restrict__ dy,
                const float* __restrict__ dcT, float* dgates, float* dh0,
                float* dc0, int T, int B, int H) {
  extern __shared__ __align__(16) float smem[];
  const int H4 = 4 * H;
  float* wr = smem;              // [kU][4H]: rows of W_h of this CTA's units
  float* dc_s = smem + kU * H4;  // [B][kU]: dc carry of this CTA's units
  cg::grid_group grid = cg::this_grid();
  const int j0 = blockIdx.x * kU;
  for (int idx = threadIdx.x; idx < kU * H4; idx += blockDim.x) {
    const int col = j0 + idx / H4;
    wr[idx] = col < H ? wh[(int64_t)col * H4 + idx % H4] : 0.f;
  }
  for (int idx = threadIdx.x; idx < B * kU; idx += blockDim.x) {
    const int col = j0 + idx % kU;
    dc_s[idx] = col < H ? dcT[(int64_t)(idx / kU) * H + col] : 0.f;
  }
  __syncthreads();

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  // Step s = T-1 .. 0 emits dgates[s]; the pass at s = -1 only forms
  // dh0 from dgates[0].
  for (int s = T - 1; s >= -1; --s) {
    for (int rb = warp * kR; rb < B; rb += kWarps * kR) {
      // dh carry into step s: (dgates[s+1] @ W_h^T) * mask[s+1].
      float dhc[kR][kU];
#pragma unroll
      for (int r = 0; r < kR; ++r)
#pragma unroll
        for (int u = 0; u < kU; ++u) dhc[r][u] = 0.f;
      if (s + 1 < T) {
        const float* dgn = dgates + (int64_t)(s + 1) * B * H4;
        for (int q = lane; q < H4; q += 32) {
          float dv[kR];
#pragma unroll
          for (int r = 0; r < kR; ++r)
            dv[r] = rb + r < B ? __ldcg(dgn + (int64_t)(rb + r) * H4 + q)
                               : 0.f;
#pragma unroll
          for (int u = 0; u < kU; ++u) {
            const float w = wr[u * H4 + q];
#pragma unroll
            for (int r = 0; r < kR; ++r) dhc[r][u] = fmaf(dv[r], w, dhc[r][u]);
          }
        }
        const float* mn = mask + (int64_t)(s + 1) * B;
#pragma unroll
        for (int r = 0; r < kR; ++r) {
          const float m = rb + r < B ? mn[rb + r] : 0.f;
#pragma unroll
          for (int u = 0; u < kU; ++u) dhc[r][u] = warp_sum(dhc[r][u]) * m;
        }
      }
      // Lane r*kU + u takes the carry of its (row, unit) pair; the 16
      // pairs' updates run side by side.
      float dhp = 0.f;
#pragma unroll
      for (int r = 0; r < kR; ++r)
#pragma unroll
        for (int u = 0; u < kU; ++u)
          if (lane == r * kU + u) dhp = dhc[r][u];
      const int b = rb + lane / kU, u = lane % kU, col = j0 + u;
      if (lane < kR * kU && b < B && col < H) {
        if (s < 0) {
          dh0[(int64_t)b * H + col] = dhp;
          dc0[(int64_t)b * H + col] = dc_s[b * kU + u];
        } else {
          const int64_t row = (int64_t)s * B + b;
          const float* grow = gates + row * H4;
          const float gi = grow[col], gf = grow[H + col];
          const float gg = grow[2 * H + col], go = grow[3 * H + col];
          const float m = mask[row];
          const float cp = (s == 0 ? c0[(int64_t)b * H + col]
                                   : cs[(row - B) * H + col]) * m;
          const float tc = tanhf(cs[row * H + col]);
          const float dh = dy[row * H + col] + dhp;
          const float dct = dh * go * (1.f - tc * tc) + dc_s[b * kU + u];
          float* drow = dgates + row * H4;
          drow[col] = dct * gg * gi * (1.f - gi);
          drow[H + col] = dct * cp * gf * (1.f - gf);
          drow[2 * H + col] = dct * gi * (1.f - gg * gg);
          drow[3 * H + col] = dh * tc * go * (1.f - go);
          dc_s[b * kU + u] = dct * gf * m;
        }
      }
    }
    if (s >= 0) grid.sync();   // dgates[s] of every unit before s-1
  }
}

constexpr int kErrNotResident = 10001;

// Launch ``kernel`` cooperatively on ceil(H / kU) CTAs, after checking
// that they can all be resident at once.
cudaError_t launch_recurrence(const void* kernel, int H, size_t smem,
                              void** args, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  int dev = 0, n_sm = 0, per_sm = 0, coop = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return err;
  if ((err = cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount,
                                    dev)) != cudaSuccess)
    return err;
  if ((err = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch,
                                    dev)) != cudaSuccess)
    return err;
  if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
           &per_sm, kernel, kRecThreads, smem)) != cudaSuccess)
    return err;
  const int grid = (H + kU - 1) / kU;
  if (!coop || grid > per_sm * n_sm)
    return static_cast<cudaError_t>(kErrNotResident);
  err = cudaLaunchCooperativeKernel(kernel, dim3(grid), dim3(kRecThreads),
                                    args, smem, stream);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// K3a.  x [M, K], wx [K, N], b [N] -> xg [M, N].  Split z sums K rows
// [z*k_chunk, (z+1)*k_chunk); with splits > 1, work holds splits * M * N
// floats of partial sums and k_chunk * splits >= K.
int lstm_proj_launch(const void* x, const void* wx, const void* b, void* xg,
                     void* work, int M, int N, int K, int k_chunk,
                     int splits, void* stream) {
  if (M == 0 || N == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto* A = static_cast<const float*>(x);
  const auto* W = static_cast<const float*>(wx);
  const auto* bias = static_cast<const float*>(b);
  dim3 grid((N + kBN - 1) / kBN, (M + kBM - 1) / kBM, splits);
  if (splits == 1) {
    proj_gemm_kernel<<<grid, kGemmThreads, 0, s>>>(
        A, W, bias, static_cast<float*>(xg), M, N, K, k_chunk);
  } else {
    proj_gemm_kernel<<<grid, kGemmThreads, 0, s>>>(
        A, W, nullptr, static_cast<float*>(work), M, N, K, k_chunk);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    const int64_t MN = (int64_t)M * N;
    splitk_reduce_kernel<<<(unsigned)((MN + 255) / 256), 256, 0, s>>>(
        static_cast<const float*>(work), bias, static_cast<float*>(xg), M,
        N, splits);
  }
  return static_cast<int>(cudaGetLastError());
}

// K3.  xg [T, B, 4H], wh [H, 4H], mask [T, B], h0, c0 [B, H] ->
// y, cs [T, B, H], gates [T, B, 4H], hT, cT [B, H].
int lstm_fwd_launch(const void* xg, const void* wh, const void* mask,
                    const void* h0, const void* c0, void* y, void* gates,
                    void* cs, void* hT, void* cT, int T, int B, int H,
                    void* stream) {
  if (T == 0 || B == 0 || H == 0) return 0;
  const float *a_xg = static_cast<const float*>(xg),
              *a_wh = static_cast<const float*>(wh),
              *a_mask = static_cast<const float*>(mask),
              *a_h0 = static_cast<const float*>(h0),
              *a_c0 = static_cast<const float*>(c0);
  float *a_y = static_cast<float*>(y), *a_g = static_cast<float*>(gates),
        *a_cs = static_cast<float*>(cs), *a_hT = static_cast<float*>(hT),
        *a_cT = static_cast<float*>(cT);
  void* args[] = {&a_xg, &a_wh, &a_mask, &a_h0, &a_c0, &a_y, &a_g,
                  &a_cs, &a_hT, &a_cT, &T, &B, &H};
  const size_t smem = sizeof(float) * ((size_t)kQ * H + (size_t)B * kU);
  return static_cast<int>(launch_recurrence(
      reinterpret_cast<const void*>(lstm_fwd_kernel), H, smem, args,
      static_cast<cudaStream_t>(stream)));
}

// K4.  gates [T, B, 4H], cs [T, B, H], c0 [B, H], mask [T, B], wh [H, 4H],
// dy [T, B, H] (hT's cotangent already added to dy[T-1]), dcT [B, H] ->
// dgates [T, B, 4H], dh0, dc0 [B, H].
int lstm_bwd_launch(const void* gates, const void* cs, const void* c0,
                    const void* mask, const void* wh, const void* dy,
                    const void* dcT, void* dgates, void* dh0, void* dc0,
                    int T, int B, int H, void* stream) {
  if (T == 0 || B == 0 || H == 0) return 0;
  const float *a_g = static_cast<const float*>(gates),
              *a_cs = static_cast<const float*>(cs),
              *a_c0 = static_cast<const float*>(c0),
              *a_mask = static_cast<const float*>(mask),
              *a_wh = static_cast<const float*>(wh),
              *a_dy = static_cast<const float*>(dy),
              *a_dcT = static_cast<const float*>(dcT);
  float *a_dg = static_cast<float*>(dgates), *a_dh0 = static_cast<float*>(dh0),
        *a_dc0 = static_cast<float*>(dc0);
  void* args[] = {&a_g, &a_cs, &a_c0, &a_mask, &a_wh, &a_dy, &a_dcT,
                  &a_dg, &a_dh0, &a_dc0, &T, &B, &H};
  const size_t smem = sizeof(float) * ((size_t)kU * 4 * H + (size_t)B * kU);
  return static_cast<int>(launch_recurrence(
      reinterpret_cast<const void*>(lstm_bwd_kernel), H, smem, args,
      static_cast<cudaStream_t>(stream)));
}

const char* lstm_error_string(int code) {
  if (code == kErrNotResident)
    return "the recurrence's CTAs cannot all be resident at once "
           "(cooperative launch needs them to be)";
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
