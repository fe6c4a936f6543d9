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
//       F = 6919, H = 512) that must give float32 results.  On the fp32
//       pipes it is bound by 67 TFLOP/s (0.61 ms); the tensor cores take
//       TF32 only, whose 10-bit mantissa loses the result at K = 6919.
//       Design: the error-compensated split on wgmma.  Every operand is
//       cut into two TF32 values, hi = v rounded to nearest and lo = v -
//       hi, and each product is three: x_lo@w_hi + x_hi@w_lo + x_hi@w_hi,
//       three times the operations at 7.4 times the rate (bound 0.25 ms).
//       The tensor cores add to their accumulator with truncation, which
//       over the 2,600 adds of a K = 6919 sum would bias it by about one
//       part in 1e4; so the 12 products of a 32-deep stage are summed in
//       the tensor core from zero, where the truncation acts on a small
//       partial sum, and each stage's sum is added to the running fp32
//       accumulator by an ordinary rounded add.
//       wgmma reads TF32 operands from shared memory K-major only, and
//       W_x is [K, N] (N-major).  A transposed copy of the 56.7 MB W_x in
//       device memory would have to be refreshed after every optimizer
//       step; instead the tile is transposed on the chip, by the threads
//       that have to touch every element anyway to split it.  A CTA is
//       one producer warpgroup and up to three consumer warpgroups:
//       - the producer brings raw tiles of x ([BM][32], 4-byte cp.async:
//         rows of K = 6919 floats are only 4-byte aligned) and of W_x
//         ([32][128], 16-byte cp.async) into a ring, zero-filled past M, N
//         and the K range, and rewrites each raw W_x tile as two operand
//         tiles (hi and lo) of K-major 8 x 16-byte core matrices, in a
//         second ring of two stages;
//       - a consumer (64 rows) takes x as wgmma's register operand: it
//         reads its fragments from the raw tile (row stride 36 floats:
//         32 different banks), splits them, and issues m64n64k8 products
//         against the operand tiles' descriptors, one 64-column half at
//         a time so that the stage's sum is 32 registers.
//       Four mbarrier arrays (raw full / empty, operand full / empty)
//       are all that joins them; a wait that never ends traps.
//       Three shapes of the same kernel:
//       - 192 rows, three consumers (setmaxnreg gives them 152 registers
//         each): T*B = 1440 is 8 row tiles, 128 CTAs, one wave;
//       - 128 rows, two consumers, a deeper raw ring: T*B = 640;
//       - few rows (collection: T*B = 64): the product is a stream over
//         W_x, which does not fit the 50 MB L2.  One consumer, a raw ring
//         of 5 stages, K split over the 8 CTAs of a thread-block cluster.
//         The partial tiles never go to device memory: each CTA leaves
//         its tile in shared memory, and after a cluster barrier CTA r
//         sums rows [8r, 8r+8) of all eight over distributed shared
//         memory, in a fixed order, adds the bias and writes.  One
//         launch, no scratch tensor, no atomics: the same bits every run.
//       W_x not 16-byte aligned or 4H not a multiple of 4 take a plain
//       shared-memory-tiled FFMA kernel.
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

constexpr int kBK = 32;                // depth of a shared-memory stage
constexpr int kAStride = kBK + 4;      // floats; x fragments hit 32 banks
constexpr int kSplit = 8;              // CTAs of a cluster sharing a tile's K

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Copy ``Bytes`` from global to shared memory, or fill them with zeros.
template <int Bytes>
__device__ __forceinline__ void cp_async(float* dst, const float* src,
                                         bool valid) {
  const int n = valid ? Bytes : 0;
  if constexpr (Bytes == 16) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                     smem_u32(dst)),
                 "l"(src), "r"(n)
                 : "memory");
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                     smem_u32(dst)),
                 "l"(src), "r"(n)
                 : "memory");
  }
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// v = hi + lo: hi is v rounded to TF32 (10-bit mantissa) to nearest, ties
// away from zero, the value cvt.rna.tf32.f32 gives, made with an integer
// add and a mask on the sign-magnitude bits (cheaper than cvt); lo is the
// rest, of which the tensor core reads the leading 11 bits.
__device__ __forceinline__ void split_tf32(float v, uint32_t& hi,
                                           uint32_t& lo) {
  hi = (__float_as_uint(v) + 0x1000u) & 0xffffe000u;
  lo = __float_as_uint(v - __uint_as_float(hi));
}

constexpr int kWgBN = 128;          // tile width: two wgmma of n = 64
constexpr int kWgOp = 2;            // stages of split, transposed W_x tiles
constexpr int kOpTile = kBK * kWgBN;   // floats of one hi or lo tile

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   smem_u32(bar))
               : "memory");
}

// Wait until the phase of ``bar`` with this parity has completed.  A wait
// that outlasts any real one (a fault in the pipeline) traps instead of
// hanging the card.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done = 0;
  for (uint32_t spins = 0; !done; ++spins) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_u32(bar)), "r"(parity)
        : "memory");
    if (spins > (1u << 24)) __trap();
  }
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// Keeps a register live, and its uses ordered, across the asynchronous
// wgmma that reads or writes it behind the compiler's back.
__device__ __forceinline__ void pin(float& r) {
  asm volatile("" : "+f"(r)::"memory");
}
__device__ __forceinline__ void pin(uint32_t& r) {
  asm volatile("" : "+r"(r)::"memory");
}

// Shared-memory descriptor of a K-major operand tile without swizzle:
// 8-row x 16-byte core matrices, ``lbo`` bytes apart along K and ``sbo``
// bytes apart along the rows.
__device__ __forceinline__ uint64_t wgmma_desc(const void* tile, uint32_t lbo,
                                               uint32_t sbo) {
  return (uint64_t)((smem_u32(tile) & 0x3FFFFu) >> 4) |
         ((uint64_t)(lbo >> 4) << 16) | ((uint64_t)(sbo >> 4) << 32);
}

// d (64 x 64, fp32) = a (64 x 8 TF32, registers) @ b (8 x 64 TF32, shared
// memory, K-major) + (accumulate ? d : 0).
__device__ __forceinline__ void wgmma_m64n64k8(float (&d)[32],
                                               const uint32_t (&a)[4],
                                               uint64_t b_desc,
                                               int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b_desc),
        "r"(accumulate));
}

// C[m0.., n0..] = A @ B + bias for a tile of 64 * CW rows by 128 columns.
// CW consumer warpgroups (64 rows each) and one producer warpgroup, which
// never meet after the first barrier:
// - the producer brings raw tiles of x and W_x into a ring of RAW
//   stages with cp.async, and turns each raw W_x tile [32 k][128 n] into
//   the two operands wgmma can read: hi and lo TF32 values, transposed to
//   K-major core matrices ([k / 4][n][k % 4]), in a ring of kWgOp stages;
// - a consumer reads its rows of raw x from shared memory as wgmma's
//   register operand, splits them, and issues x_lo@w_hi + x_hi@w_lo +
//   x_hi@w_hi for the 4 k-steps of a stage into a zeroed 64 x 64 sum,
//   which it then adds to the running sum: once for each half of the 128
//   columns.
// mbarriers: full_raw / full_op are the producer's "landed" signals,
// empty_raw / empty_op the consumers' "read" signals.
// Needs N % 4 == 0 and B, bias, C 16-byte aligned.
template <int CW, int RAW, int SPLIT>
__global__ void __launch_bounds__((CW + 1) * 128, 1)
proj_wgmma_kernel(const float* __restrict__ A, const float* __restrict__ Bm,
                  const float* __restrict__ bias, float* __restrict__ C, int M,
                  int N, int K, int k_chunk) {
  constexpr int BM = 64 * CW;
  static_assert(SPLIT == 1 || (CW == 1 && BM % SPLIT == 0),
                "a split tile is one warpgroup's 64 rows");
  constexpr int kRawA = BM * kAStride, kRawB = kBK * kWgBN;
  extern __shared__ __align__(16) float smem[];
  float* rawA = smem;                        // [RAW][BM][kAStride]
  float* rawB = rawA + RAW * kRawA;       // [RAW][32][128]
  float* opB = rawB + RAW * kRawB;        // [kWgOp][hi, lo][8][128][4]
  __shared__ __align__(8) uint64_t full_raw[RAW], empty_raw[RAW],
      full_op[kWgOp], empty_op[kWgOp];
  const int tid = threadIdx.x, wg = tid / 128;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * kWgBN;
  const int kb = blockIdx.z * k_chunk;       // this CTA's K range
  const int ke = min(K, kb + k_chunk);
  const int nk = ke > kb ? (ke - kb + kBK - 1) / kBK : 0;
  if (tid == 0) {
    for (int s = 0; s < RAW; ++s) {
      mbar_init(&full_raw[s], 128);
      mbar_init(&empty_raw[s], CW * 128);
    }
    for (int o = 0; o < kWgOp; ++o) {
      mbar_init(&full_op[o], 128);
      mbar_init(&empty_op[o], CW * 128);
    }
  }
  __syncthreads();

  if (wg == CW) {
    // ---------------- producer ----------------
    if constexpr (CW == 3)
      asm volatile("setmaxnreg.dec.sync.aligned.u32 56;\n");
    const int p = tid - CW * 128, prow = p / 32, lane = p % 32;
    auto load_raw = [&](int kt) {
      const int slot = kt % RAW, k0 = kb + kt * kBK;
      {
        float* dst = rawA + slot * kRawA + prow * kAStride + lane;
        const float* src = A + (int64_t)(m0 + prow) * K + k0 + lane;
        const int64_t step = (int64_t)4 * K;
        const bool k_ok = k0 + lane < ke;
#pragma unroll 8
        for (int r = 0; r < BM / 4; ++r) {
          const bool ok = k_ok && m0 + prow + r * 4 < M;
          cp_async<4>(dst, ok ? src : A, ok);
          dst += 4 * kAStride;
          src += step;
        }
      }
      {
        float* dst = rawB + slot * kRawB + prow * kWgBN + lane * 4;
        const float* src = Bm + (int64_t)(k0 + prow) * N + n0 + lane * 4;
        const int64_t step = (int64_t)4 * N;
        const bool n_ok = n0 + lane * 4 < N;
#pragma unroll
        for (int r = 0; r < kBK / 4; ++r) {
          const bool ok = n_ok && k0 + prow + r * 4 < ke;
          cp_async<16>(dst, ok ? src : Bm, ok);
          dst += 4 * kWgBN;
          src += step;
        }
      }
    };
#pragma unroll
    for (int kt = 0; kt < RAW - 1; ++kt) {
      if (kt < nk) load_raw(kt);
      asm volatile("cp.async.commit_group;\n" ::: "memory");
    }
    for (int kt = 0; kt < nk; ++kt) {
      cp_async_wait<RAW - 2>();   // this thread's part of tile kt landed
      // ... and every producer's, and every producer is done with the
      // W_x tile kt-1, whose raw stage the load below refills.
      asm volatile("bar.sync 1, 128;\n" ::: "memory");
      mbar_arrive(&full_raw[kt % RAW]);

      // Split and transpose W_x tile kt: column p of every 4 k-rows.
      const int o = kt % kWgOp;
      if (kt >= kWgOp) mbar_wait(&empty_op[o], (kt / kWgOp - 1) & 1);
      const float* rb = rawB + (kt % RAW) * kRawB + p;
      float* hi = opB + o * 2 * kOpTile + p * 4;
      float* lo = hi + kOpTile;
#pragma unroll
      for (int kc = 0; kc < kBK / 4; ++kc) {
        uint32_t h[4], l[4];
#pragma unroll
        for (int i = 0; i < 4; ++i)
          split_tf32(rb[(kc * 4 + i) * kWgBN], h[i], l[i]);
        *reinterpret_cast<uint4*>(hi + kc * kWgBN * 4) =
            make_uint4(h[0], h[1], h[2], h[3]);
        *reinterpret_cast<uint4*>(lo + kc * kWgBN * 4) =
            make_uint4(l[0], l[1], l[2], l[3]);
      }
      // The tensor cores read shared memory through the async proxy.
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      mbar_arrive(&full_op[o]);

      const int nxt = kt + RAW - 1;
      if (nxt < nk) {
        if (nxt >= RAW)
          mbar_wait(&empty_raw[nxt % RAW], (nxt / RAW - 1) & 1);
        load_raw(nxt);
      }
      asm volatile("cp.async.commit_group;\n" ::: "memory");
    }
  } else {
    // ---------------- consumers ----------------
    if constexpr (CW == 3)
      asm volatile("setmaxnreg.inc.sync.aligned.u32 152;\n");
    const int lane = tid % 32, g = lane >> 2, t = lane & 3;
    const int row = wg * 64 + (tid % 128) / 32 * 16 + g;   // and row + 8
    float acc[64];
#pragma unroll
    for (int i = 0; i < 64; ++i) acc[i] = 0.f;

    for (int kt = 0; kt < nk; ++kt) {
      const int o = kt % kWgOp;
      mbar_wait(&full_raw[kt % RAW], (kt / RAW) & 1);
      mbar_wait(&full_op[o], (kt / kWgOp) & 1);
      const float* ap = rawA + (kt % RAW) * kRawA + row * kAStride + t;
      const float* hi = opB + o * 2 * kOpTile;
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        float d[32];
#pragma unroll
        for (int i = 0; i < 32; ++i) d[i] = 0.f;
        uint32_t ah[2][4], al[2][4];
#pragma unroll
        for (int ks = 0; ks < 4; ++ks) {
          const int b = ks % 2;
          if (ks >= 2) {
            wgmma_wait<1>();   // the products that read buffer b are done
#pragma unroll
            for (int i = 0; i < 4; ++i) { pin(ah[b][i]); pin(al[b][i]); }
          }
          split_tf32(ap[ks * 8], ah[b][0], al[b][0]);
          split_tf32(ap[ks * 8 + 8 * kAStride], ah[b][1], al[b][1]);
          split_tf32(ap[ks * 8 + 4], ah[b][2], al[b][2]);
          split_tf32(ap[ks * 8 + 8 * kAStride + 4], ah[b][3], al[b][3]);
          // W_x^T rows [64 half, +64), k [8 ks, +8): core matrices of 4 k
          // lie 128 * 16 bytes apart, those of 8 n rows 128 bytes apart.
          const float* tile = hi + (2 * ks * kWgBN + half * 64) * 4;
          const uint64_t desc_hi = wgmma_desc(tile, kWgBN * 16, 128);
          const uint64_t desc_lo = wgmma_desc(tile + kOpTile, kWgBN * 16, 128);
          wgmma_fence();
          wgmma_m64n64k8(d, al[b], desc_hi, ks > 0);   // small terms first
          wgmma_m64n64k8(d, ah[b], desc_lo, 1);
          wgmma_m64n64k8(d, ah[b], desc_hi, 1);
          wgmma_commit();
        }
        wgmma_wait<0>();
#pragma unroll
        for (int b = 0; b < 2; ++b)
#pragma unroll
          for (int i = 0; i < 4; ++i) { pin(ah[b][i]); pin(al[b][i]); }
#pragma unroll
        for (int i = 0; i < 32; ++i) {
          pin(d[i]);
          acc[half * 32 + i] += d[i];
        }
      }
      mbar_arrive(&empty_raw[kt % RAW]);
      mbar_arrive(&empty_op[o]);
    }

    // Thread (g, t) holds rows g and g + 8, columns 2t and 2t + 1 of each
    // 8-column tile.
    if constexpr (SPLIT == 1) {
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        const int n = n0 + j * 8 + 2 * t;
        if (n >= N) continue;
        const float2 bv = *reinterpret_cast<const float2*>(bias + n);
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int m = m0 + row + 8 * h;
          if (m < M)
            *reinterpret_cast<float2*>(C + (int64_t)m * N + n) = make_float2(
                acc[j * 4 + 2 * h] + bv.x, acc[j * 4 + 2 * h + 1] + bv.y);
        }
      }
    } else {
      // The SPLIT CTAs of this tile (a cluster along blockIdx.z) leave
      // their partial tiles in shared memory; CTA r then sums rows
      // [r * BM / SPLIT, ...) of all of them over distributed shared
      // memory, a warp per row, in the order of the splits.
      cg::cluster_group cluster = cg::this_cluster();
      constexpr int kRedStride = kWgBN + 4;
      float* red = smem;   // [BM][kRedStride]: the rings are drained
#pragma unroll
      for (int j = 0; j < 16; ++j)
#pragma unroll
        for (int h = 0; h < 2; ++h)
          *reinterpret_cast<float2*>(red + (row + 8 * h) * kRedStride + j * 8 +
                                     2 * t) =
              make_float2(acc[j * 4 + 2 * h], acc[j * 4 + 2 * h + 1]);
      cluster.sync();
      for (int rr = tid / 32; rr < BM / SPLIT; rr += 4) {
        const int r = cluster.block_rank() * (BM / SPLIT) + rr;
        const int col = lane * 4;
        float4 s = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
        for (int z = 0; z < SPLIT; ++z) {
          const float* peer = cluster.map_shared_rank(red, z);
          const float4 v =
              *reinterpret_cast<const float4*>(peer + r * kRedStride + col);
          s.x += v.x; s.y += v.y; s.z += v.z; s.w += v.w;
        }
        const int m = m0 + r, n = n0 + col;
        if (m < M && n < N) {
          const float4 bv = *reinterpret_cast<const float4*>(bias + n);
          *reinterpret_cast<float4*>(C + (int64_t)m * N + n) =
              make_float4(s.x + bv.x, s.y + bv.y, s.z + bv.z, s.w + bv.w);
        }
      }
      cluster.sync();   // no CTA leaves while a peer reads its tile
    }
  }
  if constexpr (SPLIT > 1) {
    if (wg == CW) {   // the producers take part in the cluster's barriers
      cg::cluster_group cluster = cg::this_cluster();
      cluster.sync();
      cluster.sync();
    }
  }
}

template <int CW, int RAW, int SPLIT>
cudaError_t launch_proj_wgmma(const float* A, const float* Bm,
                              const float* bias, float* C, int M, int N, int K,
                              int k_chunk, cudaStream_t stream) {
  constexpr int BM = 64 * CW;
  constexpr size_t smem =
      sizeof(float) * (RAW * (BM * kAStride + kBK * kWgBN) +
                       kWgOp * 2 * kOpTile);
  auto kernel = proj_wgmma_kernel<CW, RAW, SPLIT>;
  static bool opted_in = false;   // once for each shape of the kernel
  if (!opted_in) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
    opted_in = true;
  }
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = 1;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = SPLIT;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((N + kWgBN - 1) / kWgBN, (M + BM - 1) / BM, SPLIT);
  cfg.blockDim = dim3((CW + 1) * 128);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, kernel, A, Bm, bias, C, M, N, K, k_chunk);
}

// The path for any alignment and any N: 128x128x8 shared-memory tiles,
// an 8x8 register block per thread, FFMA.
constexpr int kGenM = 128, kGenN = 128, kGenK = 8;
constexpr int kGemmThreads = 256;

__global__ void __launch_bounds__(kGemmThreads)
proj_generic_kernel(const float* __restrict__ A, const float* __restrict__ Bm,
                    const float* __restrict__ bias, float* __restrict__ C,
                    int M, int N, int K) {
  __shared__ __align__(16) float As[kGenK][kGenM + 4];   // A tile, transposed
  __shared__ __align__(16) float Bs[kGenK][kGenN];
  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  const int m0 = blockIdx.y * kGenM, n0 = blockIdx.x * kGenN;

  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < K; k0 += kGenK) {
#pragma unroll
    for (int r = 0; r < (kGenM * kGenK) / kGemmThreads; ++r) {
      const int e = tid + r * kGemmThreads;
      const int m = e / kGenK, k = e % kGenK;
      const int gm = m0 + m, gk = k0 + k;
      As[k][m] = (gm < M && gk < K) ? A[(int64_t)gm * K + gk] : 0.f;
      const int kk = e / kGenN, n = e % kGenN;
      const int gk2 = k0 + kk, gn = n0 + n;
      Bs[kk][n] = (gk2 < K && gn < N) ? Bm[(int64_t)gk2 * N + gn] : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < kGenK; ++k) {
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

#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int m = m0 + (i < 4 ? ty * 4 + i : 64 + ty * 4 + i - 4);
    if (m >= M) continue;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int n = n0 + (j < 4 ? tx * 4 + j : 64 + tx * 4 + j - 4);
      if (n < N) C[(int64_t)m * N + n] = acc[i][j] + bias[n];
    }
  }
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

int lstm_proj_split() { return kSplit; }
int lstm_proj_k_step() { return kBK; }

// K3a.  x [M, K], wx [K, N], b [N] -> xg [M, N].  ``tile_m`` picks the
// path: 192 and 128 are the tensor-core kernel with three and two
// consumer warpgroups (splits == 1, k_chunk >= K); 64 is its few-row
// shape, one consumer warpgroup, whose cluster of ``splits`` == 8 CTAs
// takes K rows [z*k_chunk, (z+1)*k_chunk) each (k_chunk a multiple of 32,
// k_chunk * 8 >= K).  All need N % 4 == 0 and wx, b, xg 16-byte aligned.
// 0 is the generic kernel.
int lstm_proj_launch(const void* x, const void* wx, const void* b, void* xg,
                     int M, int N, int K, int tile_m, int k_chunk, int splits,
                     void* stream) {
  if (M == 0 || N == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto* A = static_cast<const float*>(x);
  const auto* W = static_cast<const float*>(wx);
  const auto* bias = static_cast<const float*>(b);
  auto* C = static_cast<float*>(xg);
  if (tile_m == 0) {
    dim3 grid((N + kGenN - 1) / kGenN, (M + kGenM - 1) / kGenM);
    proj_generic_kernel<<<grid, kGemmThreads, 0, s>>>(A, W, bias, C, M, N, K);
    return static_cast<int>(cudaGetLastError());
  }
  const bool aligned =
      N % 4 == 0 && (reinterpret_cast<uintptr_t>(wx) & 15u) == 0 &&
      (reinterpret_cast<uintptr_t>(xg) & 15u) == 0 &&
      (reinterpret_cast<uintptr_t>(b) & 15u) == 0;
  const bool whole = (tile_m == 192 || tile_m == 128) && splits == 1 &&
                     k_chunk >= K;
  const bool split = tile_m == 64 && splits == kSplit && k_chunk % kBK == 0 &&
                     (int64_t)k_chunk * splits >= K;
  if (!aligned || !(whole || split) || (M + tile_m - 1) / tile_m > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err =
      tile_m == 192
          ? launch_proj_wgmma<3, 3, 1>(A, W, bias, C, M, N, K, k_chunk, s)
          : tile_m == 128
                ? launch_proj_wgmma<2, 4, 1>(A, W, bias, C, M, N, K, k_chunk, s)
                : launch_proj_wgmma<1, 5, kSplit>(A, W, bias, C, M, N, K,
                                                  k_chunk, s);
  if (err != cudaSuccess) return static_cast<int>(err);
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
