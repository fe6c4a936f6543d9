// Fused LSTM kernels for Hopper (sm_90a), float32 throughout.
//
// Replaces the TPU Pallas kernels of rlpyt_tpu/ops/pallas/lstm.py, four
// kernels here:
//   K3  _lstm_fwd_pallas (body _fwd_kernel :71), via lstm_pallas :276:
//       at T = 1 (every collection and evaluation step)
//       lstm_step:  the whole step in one launch (reset, x @ W_x + h @ W_h
//           + b, cell update; design below, after K4's);
//       at T > 1 split into
//       K3a lstm_proj:  xg[T*B, 4H] = x[T*B, F] @ W_x + b   (the x@W_x of
//           _fwd_kernel :88, hoisted out of the recurrence), and
//       K3  lstm_fwd:   the T-step recurrence over xg with W_h.
//   K4  _lstm_bwd_pallas (body _bwd_kernel :168): the reverse-time
//       recurrence that emits dgates, dh0 and dc0.  The contractions
//       after it (dx, dW_x, dW_h, db) are plain matrix products, outside
//       any kernel, as in the JAX package (lstm.py:257-262).
//   ops/lstm.py's LstmFunction takes lstm_step at T = 1 and K3a + K3 at
//   T > 1; K3a and K3 keep their T = 1 and few-row shapes for direct
//   callers.
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
//         ([32][BN], 16-byte cp.async) into a ring, zero-filled past M, N
//         and the K range, and rewrites each raw W_x tile as two operand
//         tiles (hi and lo) of K-major 8 x 16-byte core matrices, in a
//         second ring of two stages;
//       - a consumer (64 rows) takes x as wgmma's register operand: it
//         reads its fragments from the raw tile (row stride 36 floats:
//         32 different banks), splits them, and issues m64nNk8 products
//         against the operand tiles' descriptors: one of all 128 columns
//         (N = 128) or 64 (N = 64), or under three consumers two 64-column
//         halves, so that the stage's sum fits setmaxnreg's 152 registers.
//       Four mbarrier arrays (raw full / empty, operand full / empty)
//       are all that joins them; a wait that never ends traps.
//       Shapes of the same kernel, rows x columns x splits:
//       - deep K (R2D1's 6919; PR 4): 192 x 128 x 1 (three consumers,
//         setmaxnreg 152 registers each; T*B = 1440 is 8 row tiles, 128
//         CTAs, one wave), 128 x 128 x 1 (T*B = 640), and for few rows
//         (collection: T*B = 64, a stream over W_x, which does not fit the
//         50 MB L2) 64 x 128 x 8: one consumer, a raw ring of 5 stages, K
//         split over the 8 CTAs of a thread-block cluster;
//       - K up to 2048 (the MinAtar and MuJoCo LSTMs, K = 135-1031):
//         128 x 128 x 1-2, 128 x 64 x 1, 2, 4 and 64 x 64 x 1-8, of which
//         ops/lstm.py's plan takes the least time by a cost model fitted
//         to them on an H100: a CTA's fixed cost (3.45-5.46 us) plus 0.75
//         (64 x 64), 1.09 (128 x 64) or 1.48 us (128 x 128) a 32-deep
//         stage, in waves of the SMs.  An SM runs two CTAs' stages no
//         faster than one after the other, so what shortens a launch is
//         fewer stages on each SM: the plan splits K until the grid fills
//         one wave, and no further (at M <= 64, 5-7 splits of 1-5 stages).
//       A split's partial tiles never go to device memory: each CTA leaves
//       its tile in shared memory, and after a cluster barrier CTA r sums
//       its share of the rows of all the splits' tiles over distributed
//       shared memory, in a fixed order, adds the bias and writes.  One
//       launch, no scratch tensor, no atomics: the same bits every run.
//       Without a split the launch is not a cluster launch.
//       Measured on an H100 (bench_torch_proj_shapes.py --sweep) and not
//       kept: two m64n64k8 halves in 128-column tiles under two consumers
//       or fewer (one m64n128k8 is 0-9 % faster); two accumulators a
//       stage, k-steps 0, 2 and 1, 3 (6-20 % slower); a stage's products
//       draining while the next stage's issue (1.32 x slower: ptxas
//       serializes wgmma whose accumulators are read in flight, C7514);
//       64 x 128 tiles below K = 2048 (within 3 % of 128 x 64 at M = 640
//       and 736; 15 % faster at M = 320 in 5 splits, a grid of 100 CTAs
//       that the cost model counts as two waves); the generic FFMA kernel
//       (2.2-27 x slower than the best shape at every config shape).
//       W_x not 16-byte aligned or 4H not a multiple of 4 take a plain
//       shared-memory-tiled FFMA kernel.
//   K3 / K4 do 2*T*B*H*4H operations in T dependent steps: on paper bound
//       by fp32 operations (1.0 us a step at B = 32, H = 512), in fact by
//       what each step waits for.  Two shapes of each; ops/lstm.py's
//       recurrence_plan picks by whether W_h fits one cluster.
//     - H <= 256 (the MinAtar and MuJoCo LSTMs, H = 128 and 256):
//       16 H^2 bytes of W_h fit one thread-block cluster's shared memory,
//       and the batch rows of an LSTM are independent of each other.  So
//       one cluster takes a slice of rows and their whole recurrence (K3
//       at T > 1, and K4): CTA r of its C owns U = H / C units (C * 16
//       >= H: 8 CTAs at H = 128, 16 at H = 256) and keeps their W_h
//       columns in shared memory (34 KB at H = 128, 70 KB at H = 256).
//       Nothing crosses clusters: no device-memory barrier, no
//       cooperative launch, and clusters that do not fit run in waves.
//       A tile is 4 rows x a unit's 4 gates (K3) or 4 rows x 4 units
//       (K4); 4-16 lanes of a warp split its depth one k (or gate column)
//       at a time, each loading h of 4 rows and one float4 of W a k
//       without bank conflicts, and add their sums by shuffles in a fixed
//       tree that leaves each lane one row: no partials in shared memory,
//       no CTA barrier between the contraction and the cell update.  h
//       (K3) or the partial carries (K4, a reduce-scatter: CTA r's sums
//       over its own 4U gate columns for every unit, sent to the unit's
//       owner and added there in rank order) go to the peers by st.async
//       into buffers double-buffered by step parity, each counted on the
//       receiver's mbarrier: a step waits for the bytes it needs, one
//       way, not for a cluster-wide barrier round trip.  A cell's lane
//       keeps c (K3) or dc (K4) in a register and stages its own inputs
//       of a step two steps ahead by cp.async.  Stores to device memory
//       go after the exchange.  The same bits every run: fixed trees and
//       orders, no atomics.
//       Measured on an H100 (bench_torch_lstm_steps.py --sweep and
//       bench_torch_lstm_parts.py on builds of the variants) and not
//       kept, K3 at H = 128, T = 45, B = 32 a step (the kept shape: 1.60
//       us): depth splits of 4-deep groups summed through shared memory
//       by the cell threads, one cluster barrier a step (arrive.release,
//       the next inputs loaded, wait.acquire) and scalar stores into the
//       peers (2.3 us); those split sums with every load issued first,
//       under two CTAs an SM (3.1 us, 1.3 of them waiting for inputs
//       loaded one step ahead; K4 spilled); the shuffle tiles with float4
//       stores into the peers and a cluster barrier a step (1.9 us).
//       Clusters of 2, 4, 8 and 16 at 1-64 rows each: C * 16 >= H is
//       fastest at every config shape; at H = 256 two rows a cluster
//       (each CTA sends to 15 peers).  Not tried: TF32 mma.sync for the
//       contraction (at H = 256 it is 0.65 us of a 1.97 us step), the
//       cluster kernel at T = 1.
//     - H = 512 (R2D1's LSTM): W_h (4 MB) fits no cluster.  One
//       persistent launch per call of ceil(H / 4) CTAs in thread-block
//       clusters of 2 (128 CTAs at H = 512; the plan refuses H above 4 x
//       the SMs).  CTA j owns hidden units [4j, 4j + 4) and all four of
//       their gates, keeps its W_h slice ws [H][16] (32 KB) in shared
//       memory for the whole sequence, the Hopper counterpart of the TPU
//       keeping W_h in VMEM, and its units' c (K3) or dc (K4).  Per step:
//       - a step barrier of one counter in device memory, arrive (release)
//         apart from wait (acquire), so that a CTA loads the next step's
//         own inputs (xg; gates, c, dy) between the two;
//       - K3 stages the step's input h_prev [B][H] in shared memory (64 KB
//         at B = 32; at most 64 rows at a time) by bulk copies multicast
//         over the cluster, so L2 serves 64 copies of h a step, not 128,
//         and contracts it with FFMA from shared memory: warp w takes an
//         eighth of k, a lane 4 rows x its gate's U columns, and the 8
//         warps' tiles are summed in shared memory in warp order;
//       - K4 needs dgates[s+1] of all 4H columns for its units' rows of
//         W_h^T, 256 KB a CTA a step at B = 32; instead the CTAs of a
//         cluster share their dgates over distributed shared memory, each
//         forms the cluster's partial carry over its 32 columns for half
//         the units (B x H / 2 floats stored), and each CTA sums its
//         units' columns of the 64 cluster partials in a fixed order
//         (B x 4 x 64 floats read).
//       No atomics on data: the same bits every run.  T = 1 (a collection
//       step, at every H) is an ordinary launch of this K3 with no
//       barrier.  Ragged H and B are masked in the kernels; H needs no
//       padding.  The CTAs of a launch with a step barrier spin until
//       every CTA has arrived, so all must be resident at once.  The
//       launch is cooperative as well as clustered: CUDA then places
//       every CTA at once or refuses the launch with an error, before any
//       CTA waits, when the grid cannot fit the card.  A wait that still
//       outlasts any real one traps instead of hanging the card.
//       (Measured on an H100: 8 units a CTA, 64 CTAs, was slower than 4
//       units in both kernels; clusters of 1 slower than of 2; 32
//       clusters of 4 one-SM CTAs are not all resident.  Only the shape
//       that won is built.)
//   lstm_step does 2*B*(F+H)*4H operations on (F+H)*4H weights: bound by
//       W's bytes at every config shape (61 MB at H = 512, F = 6917: 18.6
//       us at 3.35 TB/s, more than L2 holds; 0.5-2.4 MB, in L2, at H = 128
//       and 256, where a launch's fixed cost dominates).  Design: CTAs own
//       8 units and all four of their gates' columns (so the cell update
//       needs no other CTA), for a tile of 8-64 rows; the depth F + H runs
//       in 128-deep stages (x @ W_x, then h @ W_h) split over the CTAs of
//       a cluster, reduced in rank order over distributed shared memory;
//       W by TMA boxes.  Paths (ops/lstm.py step_plan, fitted to
//       bench_torch_lstm_step.py --sweep on an H100): FFMA at B <= 16 and
//       at shallow depths (the MinAtar PG LSTM's 3 stages: no split);
//       three TF32 products on mma.sync where the fp32 operations at half
//       the pipes' rate outweigh the bytes (B = 32 and 64 at H = 128 and
//       512).  Measured on an H100 (bench_torch_lstm_step.py, builds of
//       the variants) and not kept: 64-deep stages (a loop
//       iteration costs ~0.5 us of barrier and address latency whatever
//       its work: 44.5 against 38.6 us at B = 4, H = 512); 4-byte copies
//       of x (0.9 us a 64-row stage); one 16 x 16 mma piece a warp; W in
//       16-byte cp.async pieces (within 4 % of TMA boxes; the memory
//       system reads 32-byte column slices of W at 2.4 TB/s); clusters of
//       3 or more at H = 512 (1.3-2 x slower than 2); FFMA lanes of 2-4
//       rows x 16 columns x one k of four (fewer shared-memory wavefronts
//       a FMA; 41.0 against 38.7 us at B = 4, H = 512); 255 registers a
//       thread (40.5 us).  W not 16-byte aligned, or of fewer rows than a
//       box, takes 4-byte cp.async.

#include <cooperative_groups.h>
#include <cuda.h>
#include <cuda_runtime.h>
#include <dlfcn.h>
#include <stdint.h>

#include <type_traits>

namespace cg = cooperative_groups;

namespace {

// ---------------------------------------------------------------------
// K3a: xg = x @ W_x + b
// ---------------------------------------------------------------------

constexpr int kBK = 32;                // depth of a shared-memory stage
constexpr int kAStride = kBK + 4;      // floats; x fragments hit 32 banks

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

constexpr int kWgOp = 2;            // stages of split, transposed W_x tiles

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

// d (64 x 128, fp32) = a (64 x 8 TF32, registers) @ b (8 x 128 TF32,
// shared memory, K-major) + (accumulate ? d : 0).
__device__ __forceinline__ void wgmma_m64n128k8(float (&d)[64],
                                                const uint32_t (&a)[4],
                                                uint64_t b_desc,
                                                int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b_desc),
        "r"(accumulate));
}

// One product of the consumers' loop: WN = 64 or 128 columns.
template <int WN>
__device__ __forceinline__ void wgmma_tf32(float (&d)[WN / 2],
                                           const uint32_t (&a)[4],
                                           uint64_t b_desc, int accumulate) {
  if constexpr (WN == 64)
    wgmma_m64n64k8(d, a, b_desc, accumulate);
  else
    wgmma_m64n128k8(d, a, b_desc, accumulate);
}

// One k-step of a K3a consumer: splits the x fragments of k [8 ks, +8)
// into (ah, al) and issues x_lo@w_hi + x_hi@w_lo + x_hi@w_hi for columns
// [WN half, +WN) of the stage's operand tiles into d, one commit group.
template <int BN, int WN>
__device__ __forceinline__ void proj_kstep(const float* ap, const float* hi,
                                           int ks, int half,
                                           float (&d)[WN / 2],
                                           uint32_t (&ah)[4],
                                           uint32_t (&al)[4]) {
  constexpr int kOpTile = kBK * BN;
  split_tf32(ap[ks * 8], ah[0], al[0]);
  split_tf32(ap[ks * 8 + 8 * kAStride], ah[1], al[1]);
  split_tf32(ap[ks * 8 + 4], ah[2], al[2]);
  split_tf32(ap[ks * 8 + 8 * kAStride + 4], ah[3], al[3]);
  // W_x^T rows [WN half, +WN), k [8 ks, +8): core matrices of 4 k lie
  // BN * 16 bytes apart, those of 8 n rows 128 bytes apart.
  const float* tile = hi + (2 * ks * BN + half * WN) * 4;
  const uint64_t desc_hi = wgmma_desc(tile, BN * 16, 128);
  const uint64_t desc_lo = wgmma_desc(tile + kOpTile, BN * 16, 128);
  wgmma_fence();
  wgmma_tf32<WN>(d, al, desc_hi, ks > 0);   // small terms first
  wgmma_tf32<WN>(d, ah, desc_lo, 1);
  wgmma_tf32<WN>(d, ah, desc_hi, 1);
  wgmma_commit();
}

// C[m0.., n0..] = A @ B + bias for a tile of 64 * CW rows by BN (64 or
// 128) columns.  CW consumer warpgroups (64 rows each) and one producer
// warpgroup, which never meet after the first barrier:
// - the producer brings raw tiles of x and W_x into a ring of RAW
//   stages with cp.async, and turns each raw W_x tile [32 k][BN n] into
//   the two operands wgmma can read: hi and lo TF32 values, transposed to
//   K-major core matrices ([k / 4][n][k % 4]), in a ring of kWgOp stages;
// - a consumer reads its rows of raw x from shared memory as wgmma's
//   register operand, splits them, and issues x_lo@w_hi + x_hi@w_lo +
//   x_hi@w_hi for the 4 k-steps of a stage into a zeroed 64-row sum,
//   which it then adds to the running sum: one wgmma of all BN columns,
//   or of 64 at a time under three consumers.
// mbarriers: full_raw / full_op are the producer's "landed" signals,
// empty_raw / empty_op the consumers' "read" signals.  SPLIT > 1: the
// SPLIT CTAs of a cluster along blockIdx.z each take k_chunk rows of W_x
// and sum their tiles over distributed shared memory.
// Needs N % 4 == 0 and B, bias, C 16-byte aligned.
template <int CW, int BN, int RAW, int SPLIT>
__global__ void __launch_bounds__((CW + 1) * 128, 1)
proj_wgmma_kernel(const float* __restrict__ A, const float* __restrict__ Bm,
                  const float* __restrict__ bias, float* __restrict__ C, int M,
                  int N, int K, int k_chunk) {
  constexpr int BM = 64 * CW;
  // Columns of one wgmma: all of a 128-column tile, but in 64-column
  // halves under three consumers (setmaxnreg's 152 registers).
  constexpr int WN = BN == 128 && CW < 3 ? 128 : 64;
  constexpr int kHalves = BN / WN;
  static_assert(BN == 64 || BN == 128, "tiles of 64 or 128 columns");
  static_assert(SPLIT >= 1 && SPLIT <= 8 && (SPLIT == 1 || CW < 3),
                "clusters of at most 8 CTAs, of one or two consumers");
  constexpr int kRawA = BM * kAStride, kRawB = kBK * BN;
  constexpr int kOpTile = kBK * BN;        // floats of one hi or lo tile
  extern __shared__ __align__(16) float smem[];
  float* rawA = smem;                        // [RAW][BM][kAStride]
  float* rawB = rawA + RAW * kRawA;       // [RAW][32][BN]
  float* opB = rawB + RAW * kRawB;        // [kWgOp][hi, lo][8][BN][4]
  __shared__ __align__(8) uint64_t full_raw[RAW], empty_raw[RAW],
      full_op[kWgOp], empty_op[kWgOp];
  const int tid = threadIdx.x, wg = tid / 128;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
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
    // W_x rows of BN / 4 float4 each, 512 / BN rows a pass.
    constexpr int kVec = BN / 4, kPass = 128 / kVec;
    const int wrow = p / kVec, wv = p % kVec;
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
        float* dst = rawB + slot * kRawB + wrow * BN + wv * 4;
        const float* src = Bm + (int64_t)(k0 + wrow) * N + n0 + wv * 4;
        const int64_t step = (int64_t)kPass * N;
        const bool n_ok = n0 + wv * 4 < N;
#pragma unroll
        for (int r = 0; r < kBK / kPass; ++r) {
          const bool ok = n_ok && k0 + wrow + r * kPass < ke;
          cp_async<16>(dst, ok ? src : Bm, ok);
          dst += kPass * BN;
          src += step;
        }
      }
    };
#pragma unroll
    for (int kt = 0; kt < RAW - 1; ++kt) {
      if (kt < nk) load_raw(kt);
      asm volatile("cp.async.commit_group;\n" ::: "memory");
    }
    // Thread p splits column p % BN of the stage's 4-row groups p / BN,
    // p / BN + 128 / BN, ...
    constexpr int kTpc = 128 / BN;
    const int col = p % BN, kq = p / BN;
    for (int kt = 0; kt < nk; ++kt) {
      cp_async_wait<RAW - 2>();   // this thread's part of tile kt landed
      // ... and every producer's, and every producer is done with the
      // W_x tile kt-1, whose raw stage the load below refills.
      asm volatile("bar.sync 1, 128;\n" ::: "memory");
      mbar_arrive(&full_raw[kt % RAW]);

      // Split and transpose W_x tile kt.
      const int o = kt % kWgOp;
      if (kt >= kWgOp) mbar_wait(&empty_op[o], (kt / kWgOp - 1) & 1);
      const float* rb = rawB + (kt % RAW) * kRawB + col;
      float* hi = opB + o * 2 * kOpTile + col * 4;
      float* lo = hi + kOpTile;
#pragma unroll
      for (int j = 0; j < kBK / 4 / kTpc; ++j) {
        const int kc = kq + j * kTpc;
        uint32_t h[4], l[4];
#pragma unroll
        for (int i = 0; i < 4; ++i)
          split_tf32(rb[(kc * 4 + i) * BN], h[i], l[i]);
        *reinterpret_cast<uint4*>(hi + kc * BN * 4) =
            make_uint4(h[0], h[1], h[2], h[3]);
        *reinterpret_cast<uint4*>(lo + kc * BN * 4) =
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
    float acc[BN / 2];
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) acc[i] = 0.f;
    for (int kt = 0; kt < nk; ++kt) {
      const int o = kt % kWgOp;
      mbar_wait(&full_raw[kt % RAW], (kt / RAW) & 1);
      mbar_wait(&full_op[o], (kt / kWgOp) & 1);
      const float* ap = rawA + (kt % RAW) * kRawA + row * kAStride + t;
      const float* hi = opB + o * 2 * kOpTile;
#pragma unroll
      for (int half = 0; half < kHalves; ++half) {
        float d[WN / 2];
#pragma unroll
        for (int i = 0; i < WN / 2; ++i) d[i] = 0.f;
        uint32_t ah[2][4], al[2][4];
#pragma unroll
        for (int ks = 0; ks < 4; ++ks) {
          const int b = ks % 2;
          if (ks >= 2) {
            wgmma_wait<1>();   // the products that read buffer b are done
#pragma unroll
            for (int i = 0; i < 4; ++i) { pin(ah[b][i]); pin(al[b][i]); }
          }
          proj_kstep<BN, WN>(ap, hi, ks, half, d, ah[b], al[b]);
        }
        wgmma_wait<0>();
#pragma unroll
        for (int b = 0; b < 2; ++b)
#pragma unroll
          for (int i = 0; i < 4; ++i) { pin(ah[b][i]); pin(al[b][i]); }
#pragma unroll
        for (int i = 0; i < WN / 2; ++i) {
          pin(d[i]);
          acc[half * (WN / 2) + i] += d[i];
        }
      }
      mbar_arrive(&empty_raw[kt % RAW]);
      mbar_arrive(&empty_op[o]);
    }

    // Thread (g, t) holds rows g and g + 8, columns 2t and 2t + 1 of each
    // 8-column tile.
    if constexpr (SPLIT == 1) {
#pragma unroll
      for (int j = 0; j < BN / 8; ++j) {
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
      // [r * kRows, (r + 1) * kRows) of all of them over distributed
      // shared memory, a warp per row, in the order of the splits.
      cg::cluster_group cluster = cg::this_cluster();
      constexpr int kRedStride = BN + 4;
      float* red = smem;   // [BM][kRedStride]: the rings are drained
      // ... once every consumer warpgroup has read its last x tile.
      if constexpr (CW > 1)
        asm volatile("bar.sync 2, %0;\n" ::"n"(CW * 128) : "memory");
#pragma unroll
      for (int j = 0; j < BN / 8; ++j)
#pragma unroll
        for (int h = 0; h < 2; ++h)
          *reinterpret_cast<float2*>(red + (row + 8 * h) * kRedStride + j * 8 +
                                     2 * t) =
              make_float2(acc[j * 4 + 2 * h], acc[j * 4 + 2 * h + 1]);
      cluster.sync();
      constexpr int kRows = (BM + SPLIT - 1) / SPLIT;
      const int col = lane * 4, r0 = cluster.block_rank() * kRows;
      for (int rr = tid / 32; rr < kRows && r0 + rr < BM && col < BN;
           rr += CW * 4) {
        const int r = r0 + rr;
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

template <int CW, int BN, int RAW, int SPLIT>
cudaError_t launch_proj_wgmma(const float* A, const float* Bm,
                              const float* bias, float* C, int M, int N, int K,
                              int k_chunk, cudaStream_t stream) {
  constexpr int BM = 64 * CW;
  constexpr size_t smem =
      sizeof(float) * (RAW * (BM * kAStride + kBK * BN) + kWgOp * 2 * kBK * BN);
  auto kernel = proj_wgmma_kernel<CW, BN, RAW, SPLIT>;
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
  cfg.gridDim = dim3((N + BN - 1) / BN, (M + BM - 1) / BM, SPLIT);
  cfg.blockDim = dim3((CW + 1) * 128);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cfg.attrs = &attr;
  cfg.numAttrs = SPLIT > 1 ? 1 : 0;   // no cluster without a split
  return cudaLaunchKernelEx(&cfg, kernel, A, Bm, bias, C, M, N, K, k_chunk);
}

// K3a's shapes, (tile_m, tile_n, splits) -> the kernel that runs them.
using ProjLaunch = cudaError_t (*)(const float*, const float*, const float*,
                                   float*, int, int, int, int, cudaStream_t);
struct ProjShape {
  int tile_m, tile_n, splits;
  ProjLaunch launch;
};
// What ops/lstm.py PROJ_SHAPES lists: the deep-K shapes (PR 4), and
// below ops/lstm.py PROJ_MODEL_K those of PROJ_SPLITS.
constexpr ProjShape kProjShapes[] = {
    {192, 128, 1, launch_proj_wgmma<3, 128, 3, 1>},
    {128, 128, 1, launch_proj_wgmma<2, 128, 4, 1>},
    {64, 128, 8, launch_proj_wgmma<1, 128, 5, 8>},
    {128, 128, 2, launch_proj_wgmma<2, 128, 4, 2>},
    {128, 64, 1, launch_proj_wgmma<2, 64, 4, 1>},
    {128, 64, 2, launch_proj_wgmma<2, 64, 4, 2>},
    {128, 64, 4, launch_proj_wgmma<2, 64, 4, 4>},
    {64, 64, 1, launch_proj_wgmma<1, 64, 4, 1>},
    {64, 64, 2, launch_proj_wgmma<1, 64, 4, 2>},
    {64, 64, 3, launch_proj_wgmma<1, 64, 4, 3>},
    {64, 64, 4, launch_proj_wgmma<1, 64, 4, 4>},
    {64, 64, 5, launch_proj_wgmma<1, 64, 4, 5>},
    {64, 64, 6, launch_proj_wgmma<1, 64, 4, 6>},
    {64, 64, 7, launch_proj_wgmma<1, 64, 4, 7>},
    {64, 64, 8, launch_proj_wgmma<1, 64, 4, 8>},
};

constexpr int kNumProjShapes = sizeof(kProjShapes) / sizeof(kProjShapes[0]);

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

constexpr int kUnits = 4;                 // hidden units of a CTA
constexpr int kCluster = 2;               // CTAs of a thread-block cluster
constexpr int kRecThreads = 256;
constexpr int kRecWarps = kRecThreads / 32;
constexpr int kRowBlock = 32;             // batch rows of a warp's tile
constexpr int kGather = 8;                // K4: partial loads in flight
constexpr int kPartRows = 4;              // K4: rows of a partial at once
// Dynamic shared memory of a recurrence CTA: sm_90's 232448 bytes less
// 1 KB, which leaves room for the kernels' static barriers.
constexpr int kSmemMax = 232448 - 1024;
constexpr size_t kOnePerSm = 116 * 1024;   // over half an SM's 228 KB
constexpr int kErrNotResident = 10001;
constexpr int kErrBadPlan = 10002;
constexpr int kErrNoTensorMap = 10003;

__device__ __forceinline__ float sigmoid(float x) {
  return 1.f / (1.f + expf(-x));
}

// Row stride of staged h in floats: H rounded up to 4, and an odd number
// of 16-byte units, so that the 8 rows a quarter-warp reads at one k lie
// in 8 different bank groups.
__host__ __device__ __forceinline__ int padded_h(int H) { return (H + 3) & ~3; }
__host__ __device__ __forceinline__ int h_stride(int H) {
  const int hp = padded_h(H);
  return (hp / 4) % 2 ? hp : hp + 4;
}

// The step barrier.  After its stores of a step, each CTA adds one to a
// counter in device memory (release); before it reads what the other
// CTAs stored, it polls until the counter reaches the step's share of
// the grid (acquire).  The arrival is taken apart from the wait, so a
// CTA loads the next step's own inputs in between.  The counter is
// zeroed on the stream by the wrapper before each launch.  A wait that
// outlasts any real one traps instead of hanging the card.
__device__ __forceinline__ void step_arrive(int* counter) {
  // K3's readers take h through bulk copies (the async proxy).
  asm volatile("fence.proxy.async.global;\n" ::: "memory");
  __syncthreads();   // every thread's stores of this step are issued
  if (threadIdx.x == 0) {
    __threadfence();
    atomicAdd(counter, 1);
  }
}

__device__ __forceinline__ void step_wait(const int* counter, int target) {
  if (threadIdx.x == 0) {
    int v = 0;
    for (uint32_t spins = 0;; ++spins) {
      asm volatile("ld.acquire.gpu.global.s32 %0, [%1];\n"
                   : "=r"(v)
                   : "l"(counter)
                   : "memory");
      if (v >= target) break;
      if (spins > (1u << 24)) __trap();
    }
  }
  __syncthreads();
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
                   smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

// One bulk copy of ``bytes`` (a multiple of 16, both addresses 16-byte
// aligned) from device memory to shared memory, multicast to the same
// offset in every CTA of the cluster, each of which counts the bytes on
// its own ``bar``.
__device__ __forceinline__ void bulk_load(float* dst, const float* src,
                                          uint32_t bytes, uint64_t* bar) {
  constexpr uint16_t all = (1u << kCluster) - 1;
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes"
      ".multicast::cluster [%0], [%1], %2, [%3], %4;\n" ::"r"(smem_u32(dst)),
      "l"(src), "r"(bytes), "r"(smem_u32(bar)), "h"(all)
      : "memory");
}

// K3's slice of W_h, ws[k][q] = W_h[k, gate q / U, unit j0 + q % U],
// for k < padded_h(H) (zero past H and past the last unit).  With
// ``vec`` (H % 4 == 0, W_h 16-byte aligned) in 16-byte cp.async copies
// that the caller waits for; else in scalar loads.
__device__ __forceinline__ void load_w_slice(float* ws,
                                             const float* __restrict__ wh,
                                             int H, int j0, bool vec) {
  constexpr int U = kUnits, Q = 4 * U;
  const int hp = padded_h(H), H4 = 4 * H;
  if (vec) {
    for (int i = threadIdx.x; i < H * (Q / 4); i += kRecThreads) {
      const int k = i / (Q / 4), v = i % (Q / 4);
      const int g = v / (U / 4), u = (v % (U / 4)) * 4;
      const bool ok = j0 + u < H;
      cp_async<16>(ws + k * Q + v * 4,
                   ok ? wh + (int64_t)k * H4 + g * H + j0 + u : wh, ok);
    }
    asm volatile("cp.async.commit_group;\n" ::: "memory");
  } else {
    for (int i = threadIdx.x; i < hp * Q; i += kRecThreads) {
      const int k = i / Q, q = i % Q, col = j0 + q % U;
      ws[i] = k < H && col < H ? wh[(int64_t)k * H4 + (q / U) * H + col]
                               : 0.f;
    }
  }
}

// K3.  CTA j owns hidden units [U*j, U*j + U) (U = kUnits) and their four
// gates (Q = 4U columns of h @ W_h), keeps its W_h slice ws [Hp][Q] for
// the whole sequence and its units' cell state in shared memory.  Each
// step:
//   1. wait for every CTA's h of the step before (skipped at t = 0);
//   2. stage h_prev [rows][H] in shared memory, at most S rows at a
//      time: one bulk copy a row, multicast to the CTA's cluster (CTA r
//      copies rows r, r + 2, ...), so L2 serves a row once a cluster
//      (with H % 4 != 0: scalar ld.global.cg, from L2, never a stale L1);
//   3. for each 32-row block: warp w takes the k in {4w, 4w+32, ...} for
//      the whole [32][Q] tile, lane (gate gq, row group rg) holds rows
//      rg + 8i (i < 4) x its gate's U columns, FFMA over float4s of h
//      and W; the 8 warps' partial tiles meet in shared memory and
//      thread (row, unit) sums them in warp order (the same bits every
//      run) and does the cell update, with xg and the mask it loaded
//      before step 1;
//   4. store y, gates, c (and hT, cT at the end) and arrive.
// ``counter`` may be null when T == 1 (no barrier: the one-step shape is
// an ordinary launch).
__global__ void __launch_bounds__(kRecThreads, 1)
lstm_fwd_kernel(const float* __restrict__ xg, const float* __restrict__ wh,
                const float* __restrict__ mask, const float* __restrict__ h0,
                const float* __restrict__ c0, float* y, float* gates,
                float* cs, float* hT, float* cT, int* counter, int T, int B,
                int H, int S, int vec) {
  constexpr int U = kUnits, Q = 4 * U;
  constexpr int RS = Q + 4;   // row stride of a partial tile
  extern __shared__ __align__(16) float smem[];
  const int hp = padded_h(H), hs = h_stride(H), H4 = 4 * H;
  float* ws = smem;                          // [hp][Q]
  float* hbuf = ws + hp * Q;                 // [S][hs]
  float* red = hbuf + S * hs;                // [kRecWarps][32][RS]
  float* c_s = red + kRecWarps * kRowBlock * RS;   // [B][U]
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int gq = lane / 8, rg = lane % 8;    // contraction: gate, rows
  const int cr = tid / U, cu = tid % U;      // cell update: row, unit
  const int j0 = blockIdx.x * U, col = j0 + cu;
  const int n_cta = gridDim.x;
  const bool cell = tid < kRowBlock * U && col < H;
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = cluster.block_rank();
  __shared__ __align__(8) uint64_t hbar;   // staged h has landed
  uint32_t phase = 0;

  for (int i = tid; i < S * hs; i += kRecThreads) hbuf[i] = 0.f;
  for (int i = tid; i < B * U; i += kRecThreads) {
    const int c = j0 + i % U;
    c_s[i] = c < H ? c0[(int64_t)(i / U) * H + c] : 0.f;
  }
  if (tid == 0) {
    mbar_init(&hbar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  // The zeros are stored before any bulk copy writes beside them.
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  __syncthreads();
  // No peer multicasts into this CTA before its barrier exists.
  cluster.sync();
  load_w_slice(ws, wh, H, j0, vec);

  // What a cell thread reads besides the sums: xg of its (row, unit)
  // and the row's mask, loaded one row block ahead.
  struct CellIn {
    float x[4], m;
  };
  auto load_cell = [&](int t, int rb) {
    CellIn in = {{0.f, 0.f, 0.f, 0.f}, 0.f};
    const int b = rb + cr;
    if (cell && b < B) {
      const float* xrow = xg + ((int64_t)t * B + b) * H4;
#pragma unroll
      for (int g = 0; g < 4; ++g) in.x[g] = xrow[g * H + col];
      in.m = mask[(int64_t)t * B + b];
    }
    return in;
  };

  CellIn nxt = load_cell(0, 0);
  for (int t = 0; t < T; ++t) {
    const float* hprev = t == 0 ? h0 : y + (int64_t)(t - 1) * B * H;
    for (int s0 = 0; s0 < B; s0 += S) {
      const int s1 = min(B, s0 + S);
      if (s0 == 0 && t > 0) step_wait(counter, t * n_cta);
      // Stage rows [s0, s1) of h_prev: one bulk copy a row, CTA r of
      // the cluster copying rows r, r + kCluster, ... to all of it.
      if (vec) {
        // Every peer is done with the last stage (the first stage of a
        // step waited for every CTA's arrival instead).
        if (s0 > 0) cluster.sync();
        if (tid == 0) {
          asm volatile("fence.proxy.async.global;\n" ::: "memory");
          mbar_expect_tx(&hbar, (uint32_t)((s1 - s0) * H * 4));
          for (int r = rank; r < s1 - s0; r += kCluster)
            bulk_load(hbuf + r * hs, hprev + (int64_t)(s0 + r) * H, H * 4,
                      &hbar);
        }
        cp_async_wait<0>();   // the W slice, at t = 0
        mbar_wait(&hbar, phase);
        phase ^= 1;
      } else {
        const int n = (s1 - s0) * H;
        for (int i = tid; i < n; i += kRecThreads) {
          const int r = i / H, c = i - r * H;
          hbuf[r * hs + c] = __ldcg(hprev + (int64_t)(s0 + r) * H + c);
        }
        cp_async_wait<0>();   // the W slice, at t = 0
      }
      __syncthreads();

      for (int rb = s0; rb < s1; rb += kRowBlock) {
        const CellIn cur = nxt;
        if (rb + kRowBlock < B)
          nxt = load_cell(t, rb + kRowBlock);
        else if (t + 1 < T)
          nxt = load_cell(t + 1, 0);

        float acc[4][U];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int c = 0; c < U; ++c) acc[i][c] = 0.f;
        const float* hrow = hbuf + (rb - s0 + rg) * hs;
        const float* wcol = ws + gq * U;
#pragma unroll 4
        for (int k = 4 * warp; k < hp; k += 4 * kRecWarps) {
          float4 hv[4];
#pragma unroll
          for (int i = 0; i < 4; ++i)
            hv[i] = *reinterpret_cast<const float4*>(hrow + 8 * i * hs + k);
#pragma unroll
          for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
            for (int v = 0; v < U / 4; ++v) {
              const float4 w = *reinterpret_cast<const float4*>(
                  wcol + (k + kk) * Q + 4 * v);
#pragma unroll
              for (int i = 0; i < 4; ++i) {
                const float h = kk == 0   ? hv[i].x
                                : kk == 1 ? hv[i].y
                                : kk == 2 ? hv[i].z
                                          : hv[i].w;
                acc[i][4 * v] = fmaf(h, w.x, acc[i][4 * v]);
                acc[i][4 * v + 1] = fmaf(h, w.y, acc[i][4 * v + 1]);
                acc[i][4 * v + 2] = fmaf(h, w.z, acc[i][4 * v + 2]);
                acc[i][4 * v + 3] = fmaf(h, w.w, acc[i][4 * v + 3]);
              }
            }
          }
        }
        __syncthreads();   // the last block's cell updates are done with red
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int v = 0; v < U / 4; ++v)
            *reinterpret_cast<float4*>(
                red + (warp * kRowBlock + rg + 8 * i) * RS + gq * U + 4 * v) =
                make_float4(acc[i][4 * v], acc[i][4 * v + 1],
                            acc[i][4 * v + 2], acc[i][4 * v + 3]);
        __syncthreads();

        const int b = rb + cr;
        if (cell && b < B) {
          float p[4];
#pragma unroll
          for (int g = 0; g < 4; ++g) {
            float sum = 0.f;
#pragma unroll
            for (int w = 0; w < kRecWarps; ++w)
              sum += red[(w * kRowBlock + cr) * RS + g * U + cu];
            // (h * m) @ W_h = m * (h @ W_h) for m in {0, 1}
            p[g] = fmaf(cur.m, sum, cur.x[g]);
          }
          const float gi = sigmoid(p[0]), gf = sigmoid(p[1]);
          const float gg = tanhf(p[2]), go = sigmoid(p[3]);
          const float cn = gf * (c_s[b * U + cu] * cur.m) + gi * gg;
          const float hn = go * tanhf(cn);
          c_s[b * U + cu] = cn;
          const int64_t row = (int64_t)t * B + b;
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
    }
    if (t + 1 < T) step_arrive(counter);
  }
  cluster.sync();   // no CTA leaves while a peer copies in
}

// K4: k rows of a thread's partial, so that it holds 64 weights.
constexpr int kBwdKW = 64 / (4 * kUnits * kCluster);
static_assert(kBwdKW == 2, "K4 stores a thread's partial as a float2");

// Rows of K4's W_h block: the most k any CTA of the cluster takes, in
// groups of kBwdKW rows.
__host__ __device__ inline int bwd_k_rows(int H) {
  const int n_kg = padded_h(H) / kBwdKW;
  return (n_kg + kCluster - 1) / kCluster * kBwdKW;
}

// K4.  The same CTAs and units as K3.  The carry into step s is dh =
// (dgates[s+1] @ W_h^T) * mask[s+1], a sum over all 4H gate columns,
// which no CTA holds.  Reduce-scatter: after the cell update of step s+1
// the C = kCluster CTAs of a cluster copy each other's dgates (the
// cluster's QC = 4UC gate columns, B x QC floats, over distributed shared
// memory); CTA r of the cluster forms the cluster's partial carry over
// those columns for its C-th of the units, part[g][b][k] = sum_q dg[b][q]
// * W_h[k, q] (QC FFMA each, kBwdKW rows of its W_h block [H / C][QC] in
// registers), and stores it; at step s, CTA j reads its U units' columns
// of the n_cta / C clusters' partials and sums them in a fixed order: the
// same bits every run, no atomics.  Per step and CTA at B = 32
// that is 32 KB stored and 32 KB read, against the 256 KB of all
// dgates[s+1] that its units' rows of W_h would need.  Partials
// alternate between two buffers by step parity: a CTA writes step s's
// only after the barrier of step s+1, which every CTA passes only after
// reading step s+2's.
__global__ void __launch_bounds__(kRecThreads, 1)
lstm_bwd_kernel(const float* __restrict__ gates, const float* __restrict__ cs,
                const float* __restrict__ c0, const float* __restrict__ mask,
                const float* __restrict__ wh, const float* __restrict__ dy,
                const float* __restrict__ dcT, float* dgates, float* dh0,
                float* dc0, float* part, int* counter, int T, int B, int H,
                int vec) {
  constexpr int U = kUnits, C = kCluster, Q = 4 * U, QC = Q * C;
  constexpr int KW = kBwdKW;   // k rows of a thread's partial
  extern __shared__ __align__(16) float smem[];
  const int hp = padded_h(H), H4 = 4 * H;
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = cluster.block_rank();
  // This CTA's k groups of the cluster's partial.
  const int n_kg = hp / KW, kg_lo = rank * n_kg / C;
  const int n_my = (rank + 1) * n_kg / C - kg_lo;
  const int k_lo = kg_lo * KW, kg_max = (n_kg + C - 1) / C;
  // The cluster's W_h block, W_h[k_lo + kg*KW + kk, column c] at float4
  // ws[(c/4 * KW + kk) * kg_max + kg], so that the lanes of a warp, which
  // take consecutive kg, read consecutive 16-byte words.
  float4* ws = reinterpret_cast<float4*>(smem);
  float* dgc = smem + bwd_k_rows(H) * QC;    // [B][QC]: cluster's dg
  float* dgo = dgc + B * QC;                  // [B][Q]: this CTA's dg
  float* dc_s = dgo + B * Q;                  // [B][U]: dc carry
  float* red = dc_s + B * U;                  // [kRecWarps][32][U]
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int cr = tid / U, cu = tid % U;
  const int j0 = blockIdx.x * U, col = j0 + cu;
  const int n_cta = gridDim.x;
  const bool cell = tid < kRowBlock * U;
  // Partials in device memory: one for each cluster.
  const int n_grp = n_cta / C, grp = blockIdx.x / C;
  const int64_t part_grp = (int64_t)B * hp;   // floats of one partial

  // Column c of the block is gate g of unit (grp*C + p)*U + u, c = p*Q +
  // g*U + u (zero past H); 16-byte copies where aligned.
  const int unit0 = grp * C * U;
  if (vec) {
    for (int i = tid; i < n_my * KW * (QC / 4); i += kRecThreads) {
      const int k = i / (QC / 4), c = (i % (QC / 4)) * 4;
      const int p = c / Q, g = (c % Q) / U, u = unit0 + p * U + c % U;
      const bool ok = k_lo + k < H && u < H;
      cp_async<16>(reinterpret_cast<float*>(
                       ws + (c / 4 * KW + k % KW) * kg_max + k / KW),
                   ok ? wh + (int64_t)(k_lo + k) * H4 + g * H + u : wh, ok);
    }
    asm volatile("cp.async.commit_group;\n" ::: "memory");
  } else {
    for (int i = tid; i < n_my * KW * QC; i += kRecThreads) {
      const int k = i / QC, c = i % QC;
      const int p = c / Q, g = (c % Q) / U, u = unit0 + p * U + c % U;
      reinterpret_cast<float*>(ws + (c / 4 * KW + k % KW) * kg_max +
                               k / KW)[c % 4] =
          k_lo + k < H && u < H ? wh[(int64_t)(k_lo + k) * H4 + g * H + u]
                                : 0.f;
    }
  }
  for (int i = tid; i < B * U; i += kRecThreads) {
    const int c = j0 + i % U;
    dc_s[i] = c < H ? dcT[(int64_t)(i / U) * H + c] : 0.f;
  }
  cp_async_wait<0>();
  __syncthreads();

  struct CellIn {
    float g[4], c, cp, dy, m, mn;
  };
  auto load_cell = [&](int s, int rb) {
    CellIn in = {{0.f, 0.f, 0.f, 0.f}, 0.f, 0.f, 0.f, 0.f, 0.f};
    const int b = rb + cr;
    if (cell && b < B && col < H) {
      if (s + 1 < T) in.mn = mask[(int64_t)(s + 1) * B + b];
      if (s >= 0) {
        const int64_t row = (int64_t)s * B + b;
        const float* grow = gates + row * H4;
#pragma unroll
        for (int g = 0; g < 4; ++g) in.g[g] = grow[g * H + col];
        in.c = cs[row * H + col];
        in.cp = s == 0 ? c0[(int64_t)b * H + col] : cs[(row - B) * H + col];
        in.dy = dy[row * H + col];
        in.m = mask[row];
      }
    }
    return in;
  };

  // Step s = T-1 .. 0 emits dgates[s]; the pass at s = -1 only forms dh0
  // from the partials of step 0.
  CellIn nxt = load_cell(T - 1, 0);
  for (int s = T - 1; s >= -1; --s) {
    const float* pin = part + (int64_t)((s + 1) & 1) * n_grp * part_grp;
    for (int rb = 0; rb < B; rb += kRowBlock) {
      const CellIn cur = nxt;
      if (rb + kRowBlock < B)
        nxt = load_cell(s, rb + kRowBlock);
      else if (s >= 0)
        nxt = load_cell(s - 1, 0);

      if (s + 1 < T) {
        if (rb == 0) step_wait(counter, (T - 1 - s) * n_cta);
        // Warp w sums partials w, w + 8, ... for row rb + lane, in that
        // order, with the loads of 8 partials in flight at once.
        float acc[U];
#pragma unroll
        for (int u = 0; u < U; ++u) acc[u] = 0.f;
        const int b = rb + lane;
        if (b < B) {
          const float* src = pin + (int64_t)b * hp + j0;
          for (int c0 = warp; c0 < n_grp; c0 += kGather * kRecWarps) {
            float4 p[kGather][U / 4];
#pragma unroll
            for (int i = 0; i < kGather; ++i)
#pragma unroll
              for (int v = 0; v < U / 4; ++v) {
                const int c = c0 + i * kRecWarps;
                // (a CTA past H: j0 past the padded row)
                p[i][v] = c < n_grp && j0 + 4 * v < hp
                              ? __ldcg(reinterpret_cast<const float4*>(
                                    src + c * part_grp + 4 * v))
                              : make_float4(0.f, 0.f, 0.f, 0.f);
              }
#pragma unroll
            for (int i = 0; i < kGather; ++i)
#pragma unroll
              for (int v = 0; v < U / 4; ++v) {
                acc[4 * v] += p[i][v].x;
                acc[4 * v + 1] += p[i][v].y;
                acc[4 * v + 2] += p[i][v].z;
                acc[4 * v + 3] += p[i][v].w;
              }
          }
        }
#pragma unroll
        for (int u = 0; u < U; ++u)
          red[(warp * kRowBlock + lane) * U + u] = acc[u];
        __syncthreads();
      }

      const int b = rb + cr;
      if (cell && b < B) {
        float dhp = 0.f;
        if (s + 1 < T) {
#pragma unroll
          for (int w = 0; w < kRecWarps; ++w)
            dhp += red[(w * kRowBlock + cr) * U + cu];
          dhp *= cur.mn;
        }
        if (col >= H) {
          if (s >= 0)
#pragma unroll
            for (int g = 0; g < 4; ++g) dgo[b * Q + g * U + cu] = 0.f;
        } else if (s < 0) {
          dh0[(int64_t)b * H + col] = dhp;
          dc0[(int64_t)b * H + col] = dc_s[b * U + cu];
        } else {
          const float gi = cur.g[0], gf = cur.g[1], gg = cur.g[2],
                      go = cur.g[3];
          const float tc = tanhf(cur.c);
          const float dh = cur.dy + dhp;
          const float dct = dh * go * (1.f - tc * tc) + dc_s[b * U + cu];
          const float dg[4] = {dct * gg * gi * (1.f - gi),
                               dct * (cur.cp * cur.m) * gf * (1.f - gf),
                               dct * gi * (1.f - gg * gg),
                               dh * tc * go * (1.f - go)};
          float* drow = dgates + ((int64_t)s * B + b) * H4;
#pragma unroll
          for (int g = 0; g < 4; ++g) {
            drow[g * H + col] = dg[g];
            dgo[b * Q + g * U + cu] = dg[g];
          }
          dc_s[b * U + cu] = dct * gf * cur.m;
        }
      }
      __syncthreads();   // red is free again; dgo holds this block's rows
    }
    if (s < 0) break;

    // The cluster's dgates of step s, from each CTA's dgo (its peers'
    // over distributed shared memory, after the cluster's barrier).  A
    // peer writes its dgo again only after every CTA's next arrival.
    cluster.sync();
    for (int i = tid; i < B * (QC / 4); i += kRecThreads) {
      const int b = i / (QC / 4), c = (i % (QC / 4)) * 4, p = c / Q;
      const float* src = cluster.map_shared_rank(dgo, p);
      *reinterpret_cast<float4*>(dgc + b * QC + c) =
          *reinterpret_cast<const float4*>(src + b * Q + c % Q);
    }
    __syncthreads();

    // The cluster's partial of the carry into step s - 1, for this CTA's
    // k groups, to device memory.
    float* pout = part + ((int64_t)(s & 1) * n_grp + grp) * part_grp + k_lo;
    const int kg_threads = min(n_my, kRecThreads);
    if (kg_threads > 0 && tid < kRecThreads / kg_threads * kg_threads) {
      const int phases = kRecThreads / kg_threads;
      for (int kg = tid % kg_threads; kg < n_my; kg += kg_threads) {
        float w[KW][QC];
#pragma unroll
        for (int kk = 0; kk < KW; ++kk)
#pragma unroll
          for (int v = 0; v < QC / 4; ++v) {
            const float4 x = ws[(v * KW + kk) * kg_max + kg];
            w[kk][4 * v] = x.x;
            w[kk][4 * v + 1] = x.y;
            w[kk][4 * v + 2] = x.z;
            w[kk][4 * v + 3] = x.w;
          }
        // kPartRows rows at once: as many independent FFMA chains.
        for (int b0 = tid / kg_threads; b0 < B; b0 += kPartRows * phases) {
          float o[kPartRows][KW];
#pragma unroll
          for (int r = 0; r < kPartRows; ++r)
#pragma unroll
            for (int kk = 0; kk < KW; ++kk) o[r][kk] = 0.f;
#pragma unroll
          for (int v = 0; v < QC / 4; ++v) {
#pragma unroll
            for (int r = 0; r < kPartRows; ++r) {
              const int b = min(b0 + r * phases, B - 1);
              const float4 d =
                  *reinterpret_cast<const float4*>(dgc + b * QC + 4 * v);
#pragma unroll
              for (int kk = 0; kk < KW; ++kk) {
                o[r][kk] = fmaf(d.x, w[kk][4 * v], o[r][kk]);
                o[r][kk] = fmaf(d.y, w[kk][4 * v + 1], o[r][kk]);
                o[r][kk] = fmaf(d.z, w[kk][4 * v + 2], o[r][kk]);
                o[r][kk] = fmaf(d.w, w[kk][4 * v + 3], o[r][kk]);
              }
            }
          }
#pragma unroll
          for (int r = 0; r < kPartRows; ++r) {
            const int b = b0 + r * phases;
            if (b >= B) break;
            *reinterpret_cast<float2*>(pout + (int64_t)b * hp + kg * KW) =
                make_float2(o[r][0], o[r][1]);
          }
        }
      }
    }
    step_arrive(counter);
  }
  cluster.sync();   // no CTA leaves while a peer reads it
}

// ---------------------------------------------------------------------
// K3 / K4 for narrow LSTMs: one thread-block cluster a slice of rows
// ---------------------------------------------------------------------

constexpr int kMaxSplits = 16;  // lanes that split one tile's depth
constexpr int kMaxCluster = 16;
constexpr int kStages = 3;      // steps of inputs staged, two ahead

// Lanes that split the depth of one tile of 4 rows x 4 outputs, for
// ``tiles`` tiles: the most, a power of two from 4 up to kMaxSplits, with
// which the CTA's threads hold every tile at once (4 where they cannot,
// and the tiles go in passes).  At least 4: the reduction leaves each
// lane one row.
__host__ __device__ inline int tile_lanes(int tiles) {
  int ks = 4;
  while (2 * ks * tiles <= kRecThreads && 2 * ks <= kMaxSplits) ks *= 2;
  return ks;
}

__device__ __forceinline__ void commit_group() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// The address of ``addr`` (this CTA's shared memory) in CTA ``rank`` of
// the cluster, for st.async.
__device__ __forceinline__ uint32_t peer_addr(const void* addr, int rank) {
  uint32_t out;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(out)
               : "r"(smem_u32(addr)), "r"(rank));
  return out;
}

// 16 bytes into a CTA of the cluster, counted on its mbarrier ``bar``.
__device__ __forceinline__ void st_async(uint32_t addr, float4 v,
                                         uint32_t bar) {
  asm volatile(
      "st.async.shared::cluster.mbarrier::complete_tx::bytes.v4.f32 [%0], "
      "{%1, %2, %3, %4}, [%5];\n" ::"r"(addr),
      "f"(v.x), "f"(v.y), "f"(v.z), "f"(v.w), "r"(bar)
      : "memory");
}

// mbar_wait with acquire at cluster scope: the phase's bytes came from
// the peers' st.async.
__device__ __forceinline__ void mbar_wait_cluster(uint64_t* bar,
                                                  uint32_t parity) {
  uint32_t done = 0;
  for (uint32_t spins = 0; !done; ++spins) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.acquire.cluster.shared::cta.b64 p, [%1], "
        "%2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_u32(bar)), "r"(parity)
        : "memory");
    if (spins > (1u << 24)) __trap();
  }
}

// The 4 x 4 tile acc[row][j] of KS lanes (lane ks of the tile at bit
// positions below KS) summed over the KS lanes, by shuffles in a fixed
// tree (the same bits every run): the two highest bits of ks scatter
// the rows (a lane keeps rows 0-1 or 2-3, then one of them), the others
// add the lanes' sums.  Returns the row this lane holds, 2 * (ks & KS/2
// set) + (ks & KS/4 set); v[j] is its sum.
__device__ __forceinline__ int reduce_rows(const float (&acc)[4][4], int ks,
                                           int KS, float (&v)[4]) {
  constexpr unsigned kAll = 0xffffffffu;
  const int d1 = KS / 2, d2 = KS / 4;
  const bool hi1 = ks & d1, hi2 = ks & d2;
  float two[2][4];
#pragma unroll
  for (int r = 0; r < 2; ++r)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float send = hi1 ? acc[r][j] : acc[r + 2][j];
      const float keep = hi1 ? acc[r + 2][j] : acc[r][j];
      two[r][j] = keep + __shfl_xor_sync(kAll, send, d1);
    }
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const float send = hi2 ? two[0][j] : two[1][j];
    const float keep = hi2 ? two[1][j] : two[0][j];
    v[j] = keep + __shfl_xor_sync(kAll, send, d2);
  }
  for (int d = d2 / 2; d >= 1; d /= 2)
#pragma unroll
    for (int j = 0; j < 4; ++j) v[j] += __shfl_xor_sync(kAll, v[j], d);
  return 2 * hi1 + hi2;
}

// K3 for W_h that fits one cluster.  Cluster c of C CTAs takes batch
// rows [c * rows, c * rows + rows) and runs their whole recurrence; CTA r
// of it owns hidden units [r * U, r * U + U) and their four gates, and
// keeps their W_h columns ws[k][4u + g] (unit-major, row stride ldw) and
// a copy of the cluster's h in shared memory, double-buffered by step
// parity: hbuf[t & 1] [rows4][hs].  Tile (row group, unit u) is 4 rows x
// the 4 gates of u, and KS lanes split its depth k by k (lane ks takes k
// = ks, ks + KS, ...): a lane loads h of 4 rows and one float4 of W a k
// (both free of bank conflicts) for 16 FFMA.  Per step:
//   1. contract hbuf[t & 1] with ws into each tile's 4 x 4 sums, and add
//      the KS lanes' sums by shuffles (reduce_rows): each lane then holds
//      one row's 4 gates, and one lane of each group is the cell's;
//   2. the cell lane does the cell update with the xg and mask it staged
//      itself by cp.async two steps before, keeps c in a register and
//      writes h into its own hbuf[(t + 1) & 1];
//   3. this CTA's units of h go to every peer's hbuf[(t + 1) & 1] over
//      distributed shared memory, 16 bytes a thread; the CTA arrives at
//      the cluster barrier (release), stores y, gates and c to device
//      memory (out of the release's way), stages the inputs of step t + 2
//      and waits (acquire).
// No data crosses clusters: no device-memory barrier, no co-residency.
__global__ void __launch_bounds__(kRecThreads, 2)
lstm_fwd_cluster_kernel(const float* __restrict__ xg,
                        const float* __restrict__ wh,
                        const float* __restrict__ mask,
                        const float* __restrict__ h0,
                        const float* __restrict__ c0, float* y, float* gates,
                        float* cs, float* hT, float* cT, int T, int B, int H,
                        int C, int rows, int U) {
  const int Q = 4 * U, hk = padded_h(H), hs = h_stride(H), ldw = h_stride(Q);
  const int rows4 = (rows + 3) & ~3, H4 = 4 * H;
  const int tiles = rows4 / 4 * U, KS = tile_lanes(tiles);
  extern __shared__ __align__(16) float smem[];
  float* ws = smem;                         // [hk][ldw]
  float* hbuf = ws + hk * ldw;              // [2][rows4][hs]
  float4* xs = reinterpret_cast<float4*>(hbuf + 2 * rows4 * hs);
  float* ms = reinterpret_cast<float*>(xs + kStages * kRecThreads);
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = cluster.block_rank(), tid = threadIdx.x;
  const int b0 = blockIdx.x / C * rows, nb = min(rows, B - b0);
  const int j0 = rank * U;
  // This thread's tile and part of its depth; its row after the
  // reduction; whether it is a live cell's lane.
  const int tile = min(tid / KS, tiles - 1), ks = tid % KS;
  const int rg = tile / U, u = tile % U, col = j0 + u;
  const int b = rg * 4 + 2 * ((ks & (KS / 2)) != 0) + ((ks & (KS / 4)) != 0);
  const bool cell = tid / KS < tiles && (ks & (KS / 4 - 1)) == 0 &&
                    b < nb && col < H;

  // W_h[k][g * H + j0 + u] into ws[k][4u + g]: lanes along u read
  // device memory contiguously.
  for (int i = tid; i < hk * Q; i += kRecThreads) {
    const int uu = i % U, g = i / U % 4, k = i / Q;
    const bool ok = k < H && j0 + uu < H;
    cp_async<4>(ws + k * ldw + 4 * uu + g,
                ok ? wh + (int64_t)k * H4 + g * H + j0 + uu : wh, ok);
  }
  commit_group();
  // The cell lane's xg (4 gates) and mask of step t into slot t % 3.
  auto stage = [&](int t) {
    if (cell && t < T) {
      float* x = reinterpret_cast<float*>(xs + (t % kStages) * kRecThreads +
                                          tid);
      const float* src = xg + ((int64_t)t * B + b0 + b) * H4 + col;
#pragma unroll
      for (int g = 0; g < 4; ++g) cp_async<4>(x + g, src + g * H, true);
      cp_async<4>(ms + (t % kStages) * kRecThreads + tid,
                  mask + (int64_t)t * B + b0 + b, true);
    }
    commit_group();
  };
  stage(0);
  stage(1);
  for (int i = tid; i < 2 * rows4 * hs; i += kRecThreads) {
    const int r = i / hs, k = i % hs;
    hbuf[i] = r < nb && k < H ? h0[(int64_t)(b0 + r) * H + k] : 0.f;
  }
  float c = cell ? c0[(int64_t)(b0 + b) * H + col] : 0.f, h = 0.f;
  // hbar[p]: the peers' h of a step has landed in hbuf[p].  The bytes it
  // waits for: this CTA's rows of the peers' live 16-byte pieces.
  __shared__ __align__(8) uint64_t hbar[2];
  const int nv = U / 4;
  int pieces = 0;
  for (int p = 0; p < C; ++p)
    if (p != rank) pieces += min(nv, max(0, (hk - p * U) / 4));
  const uint32_t h_bytes = 16u * nb * pieces;
  if (tid == 0) {
    mbar_init(&hbar[0], 1);
    mbar_init(&hbar[1], 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    if (T > 1) mbar_expect_tx(&hbar[1], h_bytes);
    if (T > 2) mbar_expect_tx(&hbar[0], h_bytes);
  }
  uint32_t phase = 0;   // bit p: the parity of hbar[p]'s next phase
  cp_async_wait<0>();
  // W, both h buffers and the barriers are in place before any peer
  // stores into them.
  cluster.sync();

  for (int t = 0; t < T; ++t) {
    if (t > 0) {
      const int p = t & 1;
      mbar_wait_cluster(&hbar[p], (phase >> p) & 1);
      phase ^= 1u << p;
      // Armed for the step after next before this CTA sends the h that
      // the peers need to send into it again.
      if (tid == 0 && t + 2 < T) mbar_expect_tx(&hbar[p], h_bytes);
    }
    const float* hcur = hbuf + (t & 1) * rows4 * hs + rg * 4 * hs;
    float acc[4][4] = {};
#pragma unroll 4
    for (int k = ks; k < hk; k += KS) {
      const float4 w = *reinterpret_cast<const float4*>(ws + k * ldw + 4 * u);
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const float a = hcur[r * hs + k];
        acc[r][0] = fmaf(a, w.x, acc[r][0]);
        acc[r][1] = fmaf(a, w.y, acc[r][1]);
        acc[r][2] = fmaf(a, w.z, acc[r][2]);
        acc[r][3] = fmaf(a, w.w, acc[r][3]);
      }
    }
    float gate[4];
    reduce_rows(acc, ks, KS, gate);
    cp_async_wait<1>();   // this step's xg and mask (this lane's copies)
    float* hnext = hbuf + ((t + 1) & 1) * rows4 * hs;
    if (cell) {
      const float4 x = xs[(t % kStages) * kRecThreads + tid];
      const float m = ms[(t % kStages) * kRecThreads + tid];
      // (h * m) @ W_h = m * (h @ W_h) for m in {0, 1}
      gate[0] = sigmoid(fmaf(m, gate[0], x.x));
      gate[1] = sigmoid(fmaf(m, gate[1], x.y));
      gate[2] = tanhf(fmaf(m, gate[2], x.z));
      gate[3] = sigmoid(fmaf(m, gate[3], x.w));
      c = gate[1] * (c * m) + gate[0] * gate[2];
      h = gate[3] * tanhf(c);
      hnext[b * hs + col] = h;
    }
    if (t + 1 < T) {
      __syncthreads();   // this CTA's h of the step is whole
      // ... and goes to the peers, 16 bytes a thread, each counted on the
      // peer's hbar.
      const int items = nb * nv * (C - 1);
      for (int i = tid; i < items; i += kRecThreads) {
        const int peer = (rank + 1 + i / (nb * nv)) % C;
        const int r = i % (nb * nv) / nv, k = j0 + (i % nv) * 4;
        if (k < hk)
          st_async(peer_addr(hnext + r * hs + k, peer),
                   *reinterpret_cast<const float4*>(hnext + r * hs + k),
                   peer_addr(&hbar[(t + 1) & 1], peer));
      }
    }
    if (cell) {
      const int64_t row = (int64_t)t * B + b0 + b;
      y[row * H + col] = h;
      cs[row * H + col] = c;
      float* grow = gates + row * H4 + col;
#pragma unroll
      for (int g = 0; g < 4; ++g) grow[g * H] = gate[g];
      if (t == T - 1) {
        hT[(int64_t)(b0 + b) * H + col] = h;
        cT[(int64_t)(b0 + b) * H + col] = c;
      }
    }
    stage(t + 2);
  }
}

// K4 for W_h that fits one cluster: the same clusters, CTAs and units as
// K3.  The carry into step s is dh = (dgates[s+1] @ W_h^T) * mask[s+1], a
// sum over all 4H gate columns.  Reduce-scatter inside the cluster: CTA r
// keeps its units' W_h columns transposed, wt[4u + g][k] (row stride ldk,
// an odd number of 16-byte units), and after the cell update of step s+1
// forms its partial carry over its own 4U columns for every unit,
// part_r[b][k]: tile (row group, k0) is 4 rows x units k0 .. k0 + 3, KS
// lanes split its depth q by q (a lane loads dgates of 4 rows and one
// float4 of wt a q), the lanes' sums are added by shuffles
// (reduce_rows), and each lane holding a row stores its float4 into
// pbuf[r] of CTA k0 / U over distributed shared memory.  At step s, the
// cell lane of (row, unit) adds the C partials of its unit in rank order.
// Per step and CTA rows x H floats stored, none in device memory; the
// partials alternate between two buffers by step parity, so one cluster
// barrier a step orders them.  The cell lane stages its own inputs of a
// step (gates, c, c before, dy, the masks) by cp.async two steps before.
__global__ void __launch_bounds__(kRecThreads, 2)
lstm_bwd_cluster_kernel(const float* __restrict__ gates,
                        const float* __restrict__ cs,
                        const float* __restrict__ c0,
                        const float* __restrict__ mask,
                        const float* __restrict__ wh,
                        const float* __restrict__ dy,
                        const float* __restrict__ dcT, float* dgates,
                        float* dh0, float* dc0, int T, int B, int H, int C,
                        int rows, int U) {
  constexpr int kIn = 12;   // staged floats of a cell lane a step
  const int Q = 4 * U, hk = padded_h(H), ldk = h_stride(hk), ldq = h_stride(Q);
  const int rows4 = (rows + 3) & ~3, H4 = 4 * H;
  const int tiles = rows4 / 4 * (hk / 4), KS = tile_lanes(tiles);
  const int per_pass = kRecThreads / KS;
  extern __shared__ __align__(16) float smem[];
  float* wt = smem;                         // [4U][ldk]
  float* dgs = wt + Q * ldk;                // [rows4][ldq]: this CTA's dg
  float* pbuf = dgs + rows4 * ldq;          // [2][C][rows][U]
  float* in = pbuf + 2 * C * rows * U;      // [3][threads][kIn]
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = cluster.block_rank(), tid = threadIdx.x;
  const int b0 = blockIdx.x / C * rows, nb = min(rows, B - b0);
  const int j0 = rank * U;
  // The cell lane of (row b, unit u): thread b * U + u.
  const int b = tid / U, u = tid % U, col = j0 + u;
  const bool cell = b < nb && col < H;
  const int ks = tid % KS;

  // W_h[k][g * H + j0 + u] into wt[4u + g][k]: 8 units x 4 k a warp, so
  // that it reads device memory in 32-byte pieces and shared memory with
  // few bank conflicts.
  for (int i = tid; i < hk * Q; i += kRecThreads) {
    const int k = i / (4 * Q) * 4 + i % 4, uu = i / 4 % U, g = i / (4 * U) % 4;
    const bool ok = k < H && j0 + uu < H;
    cp_async<4>(wt + (4 * uu + g) * ldk + k,
                ok ? wh + (int64_t)k * H4 + g * H + j0 + uu : wh, ok);
  }
  commit_group();
  // What step s's cell update reads, into slot (s + 3) % 3: gates (4), c,
  // c before, dy, mask, mask of step s + 1 (s = -1: only the last).
  auto stage = [&](int s) {
    if (cell && s >= -1) {
      float* d = in + ((s + kStages) % kStages * kRecThreads + tid) * kIn;
      if (s >= 0) {
        const int64_t row = (int64_t)s * B + b0 + b;
#pragma unroll
        for (int g = 0; g < 4; ++g)
          cp_async<4>(d + g, gates + row * H4 + g * H + col, true);
        cp_async<4>(d + 4, cs + row * H + col, true);
        cp_async<4>(d + 5,
                    s == 0 ? c0 + (int64_t)(b0 + b) * H + col
                           : cs + (row - B) * H + col,
                    true);
        cp_async<4>(d + 6, dy + row * H + col, true);
        cp_async<4>(d + 7, mask + row, true);
      }
      if (s + 1 < T)
        cp_async<4>(d + 8, mask + (int64_t)(s + 1) * B + b0 + b, true);
    }
    commit_group();
  };
  stage(T - 1);
  stage(T - 2);
  for (int i = tid; i < rows4 * ldq; i += kRecThreads) dgs[i] = 0.f;
  float dc = cell ? dcT[(int64_t)(b0 + b) * H + col] : 0.f;
  // pbar[p]: every CTA's partial carry of a step has landed in pbuf[p].
  // The bytes it waits for: C senders x this CTA's rows x its units' live
  // 16-byte pieces.
  __shared__ __align__(8) uint64_t pbar[2];
  const uint32_t p_bytes =
      16u * C * nb * min(U / 4, max(0, (hk - rank * U) / 4));
  if (tid == 0) {
    mbar_init(&pbar[0], 1);
    mbar_init(&pbar[1], 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    mbar_expect_tx(&pbar[(T - 1) & 1], p_bytes);
    if (T > 1) mbar_expect_tx(&pbar[T & 1], p_bytes);
  }
  uint32_t phase = 0;   // bit p: the parity of pbar[p]'s next phase
  cp_async_wait<0>();
  // Every CTA of the cluster runs, with its barriers, before any stores
  // into it.
  cluster.sync();

  // Step s = T-1 .. 0 emits dgates[s]; the pass at s = -1 only forms dh0
  // from the partials of step 0.
  for (int s = T - 1; s >= -1; --s) {
    const float* pin = pbuf + ((s + 1) & 1) * C * rows * U;
    if (s + 1 < T) {
      const int p = (s + 1) & 1;
      mbar_wait_cluster(&pbar[p], (phase >> p) & 1);
      phase ^= 1u << p;
      // Armed for the partials of step s - 1 before this CTA sends those
      // of step s, which the peers need first.
      if (tid == 0 && s >= 1) mbar_expect_tx(&pbar[p], p_bytes);
    }
    cp_async_wait<1>();   // this step's inputs (this lane's copies)
    float dg[4];
    if (cell) {
      const float* d =
          in + ((s + kStages) % kStages * kRecThreads + tid) * kIn;
      float dhp = 0.f;
      if (s + 1 < T) {
#pragma unroll 4
        for (int p = 0; p < C; ++p) dhp += pin[(p * rows + b) * U + u];
        dhp *= d[8];
      }
      if (s >= 0) {
        const float gi = d[0], gf = d[1], gg = d[2], go = d[3];
        const float m = d[7];
        const float tc = tanhf(d[4]);
        const float dh = d[6] + dhp;
        const float dct = dh * go * (1.f - tc * tc) + dc;
        dg[0] = dct * gg * gi * (1.f - gi);
        dg[1] = dct * (d[5] * m) * gf * (1.f - gf);
        dg[2] = dct * gi * (1.f - gg * gg);
        dg[3] = dh * tc * go * (1.f - go);
        *reinterpret_cast<float4*>(dgs + b * ldq + 4 * u) =
            make_float4(dg[0], dg[1], dg[2], dg[3]);
        dc = dct * gf * m;
      } else {
        dh0[(int64_t)(b0 + b) * H + col] = dhp;
        dc0[(int64_t)(b0 + b) * H + col] = dc;
      }
    }
    if (s < 0) break;
    __syncthreads();   // the CTA's dgates of the step are whole
    float* pout = pbuf + (s & 1) * C * rows * U;
    for (int base = 0; base < tiles; base += per_pass) {
      const int tl = min(base + tid / KS, tiles - 1);
      const int rg = tl / (hk / 4), k0 = tl % (hk / 4) * 4;
      const float* a = dgs + rg * 4 * ldq;
      float acc[4][4] = {};
#pragma unroll 4
      for (int q = ks; q < Q; q += KS) {
        const float4 w = *reinterpret_cast<const float4*>(wt + q * ldk + k0);
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const float x = a[r * ldq + q];
          acc[r][0] = fmaf(x, w.x, acc[r][0]);
          acc[r][1] = fmaf(x, w.y, acc[r][1]);
          acc[r][2] = fmaf(x, w.z, acc[r][2]);
          acc[r][3] = fmaf(x, w.w, acc[r][3]);
        }
      }
      float v[4];
      const int r = rg * 4 + reduce_rows(acc, ks, KS, v);
      if (base + tid / KS < tiles && (ks & (KS / 4 - 1)) == 0 && r < nb)
        st_async(peer_addr(pout + (rank * rows + r) * U + k0 % U, k0 / U),
                 make_float4(v[0], v[1], v[2], v[3]),
                 peer_addr(&pbar[s & 1], k0 / U));
    }
    __syncthreads();   // dgs is read before the next step writes it
    if (cell) {
      float* drow = dgates + ((int64_t)s * B + b0 + b) * H4 + col;
#pragma unroll
      for (int g = 0; g < 4; ++g) drow[g * H] = dg[g];
    }
    stage(s - 2);
  }
}

// Dynamic shared memory of the cluster path's CTAs.
__host__ __device__ inline size_t fwd_cluster_smem(int H, int rows, int U) {
  const int rows4 = (rows + 3) & ~3;
  return sizeof(float) *
         ((size_t)padded_h(H) * h_stride(4 * U) +
          (size_t)2 * rows4 * h_stride(H) + (size_t)kStages * kRecThreads * 5);
}

__host__ __device__ inline size_t bwd_cluster_smem(int H, int C, int rows,
                                                   int U) {
  const int rows4 = (rows + 3) & ~3;
  return sizeof(float) *
         ((size_t)4 * U * h_stride(padded_h(H)) +
          (size_t)rows4 * h_stride(4 * U) +
          (size_t)2 * C * rows * U + (size_t)kStages * kRecThreads * 12);
}

__host__ __device__ inline size_t fwd_smem(int B, int H, int S) {
  constexpr int U = kUnits;
  return sizeof(float) *
         ((size_t)padded_h(H) * 4 * U + (size_t)S * h_stride(H) +
          (size_t)kRecWarps * kRowBlock * (4 * U + 4) + (size_t)B * U);
}

__host__ __device__ inline size_t bwd_smem(int B, int H) {
  constexpr int U = kUnits;
  return sizeof(float) *
         ((size_t)(bwd_k_rows(H) + B) * 4 * U * kCluster + (size_t)B * 4 * U +
          (size_t)B * U + (size_t)kRecWarps * kRowBlock * U);
}

// Launch a recurrence on ``ctas`` CTAs in clusters of kCluster.  When its
// CTAs wait for each other (``resident``) they must all be resident at
// once: the launch is also cooperative, which guarantees it or is refused
// (kErrNotResident); otherwise an ordinary clustered launch.  The
// shared-memory opt-in is made once for each kernel (``which``) and
// device.
cudaError_t launch_recurrence(const void* kernel, int which, int ctas,
                              size_t smem, bool resident, void** args,
                              cudaStream_t stream) {
  static bool opted_in[2][64];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= 64) return cudaErrorInvalidDevice;
  // CTAs that wait for each other take an SM each: with more than half of
  // an SM's shared memory no two share one.
  if (resident) smem = smem > kOnePerSm ? smem : kOnePerSm;
  if (!opted_in[which][dev]) {
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemMax);
    if (err != cudaSuccess) return err;
    opted_in[which][dev] = true;
  }
  cudaLaunchAttribute attr[2];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = kCluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  attr[1].id = cudaLaunchAttributeCooperative;
  attr[1].val.cooperative = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(ctas);
  cfg.blockDim = dim3(kRecThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = resident ? 2 : 1;
  err = cudaLaunchKernelExC(&cfg, kernel, args);
  if (err == cudaErrorCooperativeLaunchTooLarge)
    return static_cast<cudaError_t>(kErrNotResident);
  return err;
}

// CTAs enough for H in whole clusters.
bool plan_ok(int H, int ctas) {
  return ctas % kCluster == 0 && (int64_t)ctas * kUnits >= H &&
         (ctas - kCluster) * kUnits < H;
}

// A cluster-path plan: C CTAs of U units (a multiple of 4) enough for H,
// rows a cluster (rounded up to 4) times U cells, one a thread.
bool cluster_plan_ok(int H, int C, int rows, int U) {
  return C >= 1 && C <= kMaxCluster && U > 0 && U % 4 == 0 && C * U >= H &&
         rows >= 1 && ((rows + 3) & ~3) * U <= kRecThreads;
}

// Launch a cluster-path recurrence: ``clusters`` clusters of C CTAs, an
// ordinary clustered launch (clusters that do not fit run in waves).
// Clusters of 16 are non-portable and need the kernel's opt-in, made once
// for each kernel (``which``) and device with the shared-memory one.
cudaError_t launch_clusters(const void* kernel, int which, int clusters,
                            int C, size_t smem, void** args,
                            cudaStream_t stream) {
  static bool opted_in[2][64];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= 64) return cudaErrorInvalidDevice;
  if (!opted_in[which][dev]) {
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemMax);
    if (err != cudaSuccess) return err;
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (err != cudaSuccess) return err;
    opted_in[which][dev] = true;
  }
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = C;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(clusters * C);
  cfg.blockDim = dim3(kRecThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelExC(&cfg, kernel, args);
}

// ---------------------------------------------------------------------
// The one-step forward (T = 1): projection, reset and cell in one launch
// ---------------------------------------------------------------------

constexpr int kStepUnits = 8;                  // hidden units of a CTA
constexpr int kStepCols = 4 * kStepUnits;      // their four gates' columns
constexpr int kStepK = 128;                    // depth of a ring stage
constexpr int kStepXStride = kStepK + 4;       // floats: a staged x / h row
constexpr int kStepWTile = kStepK * kStepUnits;   // floats: a gate's W tile
constexpr int kStepBudget = 210 * 1024;        // ring bytes
constexpr int kStepMaxSplits = 8;              // CTAs of a cluster

// Floats of one ring stage: [W_x; W_h] rows of the stage as four gate
// tiles [kStepK][kStepUnits] (first: a TMA box lands 128-byte aligned),
// then R rows of x (or h0) by kStepK.
__host__ __device__ constexpr int step_stage_floats(int R) {
  return 4 * kStepWTile + R * kStepXStride;
}
__host__ __device__ constexpr int step_stages(int R) {
  return kStepBudget / (4 * step_stage_floats(R)) < 8
             ? kStepBudget / (4 * step_stage_floats(R))
             : 8;
}
// Groups of warps that split each stage's depth: all 8 warps on the FFMA
// path; on the TF32 path a warp takes 32 rows x all 32 columns, and the
// 256 / R groups of R / 32 warps split the depth.
__host__ __device__ constexpr int step_k_groups(int R, bool tf32) {
  return tf32 ? 256 / R : kRecWarps;
}
// The ring, or the warp groups' partials and their sum where those take
// more, and 128 bytes to align the ring.
__host__ __device__ constexpr size_t step_smem(int R, bool tf32) {
  const int ring = step_stages(R) * step_stage_floats(R);
  const int kg = step_k_groups(R, tf32);
  const int tail = (kg + (kg > 1)) * R * kStepCols;
  return sizeof(float) * (size_t)(ring > tail ? ring : tail) + 128;
}

// d (16 x 8, fp32) += a (16 x 8 TF32, row) @ b (8 x 8 TF32, col).
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// One TMA box of a 2D tensor map (column c, row r) into shared memory,
// counted on ``bar``; rows and columns outside the tensor read as zero.
__device__ __forceinline__ void tma_load_2d(float* dst, const CUtensorMap* map,
                                            int c, int r, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3}], [%4];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c), "r"(r),
      "r"(smem_u32(bar))
      : "memory");
}

// The one-step LSTM forward: y = h, gates and c of
//   h_, c_ = h0 * m, c0 * m;  pre = x @ W_x + h_ @ W_h + b;  cell update.
// CTA (group, split z, row tile) owns hidden units [8 group, +8) and their
// 4 x 8 gate columns for rows [R tile, +R).  The depth runs in stages of
// kStepK = 128 rows that never cross from W_x to W_h: ceil(F / 128)
// stages of x @ W_x, then ceil(H / 128) of h_ @ W_h; the ``splits`` CTAs
// of a cluster (blockIdx.x = group * splits + z) take ``split_stages``
// stages each, z the stages [z split_stages, +split_stages).  All 256
// threads keep step_stages(R) stages in flight in a ring:
// - W: with ``tma``, thread 0 asks for four TMA boxes (one a gate, [128
//   rows][8 columns]) of the tensor map of W_x or W_h, counted on the
//   stage's mbarrier; rows past F or H read as zero.  Without it (W not
//   16-byte aligned, or of fewer rows than a box), 4-byte cp.async.
// - x and h0: the 33 16-byte pieces from the one that holds the stage's
//   first k of a row (x rows of F = 6917 floats are 4-byte aligned only:
//   a row lands (b F) % 4 floats to the right, and the consumer reads it
//   there), zero past the tensor's end; 4-byte cp.async where x or h0 is
//   not 16-byte aligned.  Rows past the stage's depth hold the next row's
//   values, against rows of W that read as zero.  The reset is the
//   consumer's: on a stage of h0 it scales row b by m[b] (h0 * m, as the
//   plain version computes).
// Each stage is contracted:
// - FFMA (TF32 false, R = 8, 16, 32): lane (rg, cq) of every warp holds
//   rows rg + 8i (i < R / 8) x the 8 columns of gate cq; warp w takes the
//   k quads 4w + 32j (j < 4) of each stage (x one k at a time, float4s of
//   W), so the 8 warps' sums are partials over k;
// - TF32 (R = 32, 64): the error-compensated split of K3a on mma.sync
//   m16n8k8: a warp takes 32 rows x all 32 columns (two 16-row pieces by
//   four m16n8 tiles, one a gate: eight independent accumulator chains,
//   each W fragment split once for 32 rows), and the 256 / R groups of
//   R / 32 warps split a stage's 8-deep steps; a stage's three products
//   (x_lo w_hi, x_hi w_lo, x_hi w_hi, small terms first) are summed from
//   zero in the tensor core and each stage's sum added to the fp32 sum by
//   a rounded add.
// The warp groups' partials are summed in shared memory in group order;
// after a cluster barrier CTA z sums its share of the (row, unit) cells
// over the splits' partials in rank order over distributed shared memory,
// adds b and applies the cell update with the b and c0 it staged with the
// first stage, and writes y, gates, c, hT and cT.  No atomics, no
// device-memory partials: the same bits every launch.
template <int R, bool TF32>
__global__ void __launch_bounds__(kRecThreads, TF32 ? 1 : 2)
lstm_step_kernel(const __grid_constant__ CUtensorMap tmx,
                 const __grid_constant__ CUtensorMap tmh,
                 const float* __restrict__ x, const float* __restrict__ wx,
                 const float* __restrict__ wh, const float* __restrict__ bias,
                 const float* __restrict__ mask, const float* __restrict__ h0,
                 const float* __restrict__ c0, float* y, float* gates,
                 float* cs, float* hT, float* cT, int B, int H, int F,
                 int splits, int split_stages, int tma, int xal) {
  constexpr int U = kStepUnits, Q = kStepCols, KS = kStepK;
  constexpr int NST = step_stages(R), SF = step_stage_floats(R);
  constexpr int KG = step_k_groups(R, TF32);
  static_assert(R % 8 == 0 && R <= 64 && NST >= 2, "step tile");
  extern __shared__ __align__(16) float smem_raw[];
  float* smem = reinterpret_cast<float*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 127) & ~uintptr_t(127));
  __shared__ float mrow[R];           // the rows' masks, for the cells
  __shared__ float cin[R * U];        // c0 of this CTA's share of cells
  __shared__ float bin[Q];            // b of its 32 columns
  __shared__ __align__(8) uint64_t full[NST];   // a stage's W landed
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int z = blockIdx.x % splits, j0 = blockIdx.x / splits * U;
  const int r0 = blockIdx.y * R, H4 = 4 * H;
  const int nx = (F + KS - 1) / KS, n_all = nx + (H + KS - 1) / KS;
  const int s0 = z * split_stages;
  const int nk = max(0, min(n_all, s0 + split_stages) - s0);
  const int per = (R * U + splits - 1) / splits;   // cells of a split
  const int c_beg = z * per, c_end = min(R * U, c_beg + per);
  if (tid < R) mrow[tid] = r0 + tid < B ? mask[r0 + tid] : 0.f;
  if (tma && tid == 0) {
    for (int s = 0; s < NST; ++s) mbar_init(&full[s], 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  auto load_stage = [&](int kt) {
    float* ws = smem + (kt % NST) * SF;   // [4 gates][KS][U]
    float* xs = ws + 4 * kStepWTile;      // [R][kStepXStride]
    const int s = s0 + kt;
    const bool is_x = s < nx;
    const int k0 = (is_x ? s : s - nx) * KS;
    const int kv = min(KS, (is_x ? F : H) - k0);   // rows of the stage
    if (tma) {
      if (tid == 0) {
        // This slot's last reads (generic proxy) come before the TMA
        // writes (async proxy).
        asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
        mbar_expect_tx(&full[kt % NST], 4 * kStepWTile * 4);
        for (int g = 0; g < 4; ++g)
          tma_load_2d(ws + g * kStepWTile, is_x ? &tmx : &tmh, g * H + j0,
                      k0, &full[kt % NST]);
      }
    } else {
      const float* w = is_x ? wx : wh;
      for (int i = tid; i < KS * Q; i += kRecThreads) {
        const int g = i / (KS * U), kk = i / U % KS, u = i % U;
        const bool ok = kk < kv && j0 + u < H;
        cp_async<4>(ws + i,
                    ok ? w + (int64_t)(k0 + kk) * H4 + g * H + j0 + u : h0, ok);
      }
    }
    const float* src = is_x ? x : h0;
    const int ld = is_x ? F : H;
    if (xal) {
      // Row r's kStepXStride / 4 16-byte pieces from the one holding
      // (r0 + r, k0): the row lands o = its offset in that piece floats to
      // the right; bytes past the tensor's end are zero-filled.  (B F and
      // B H are below 2^31 where xal is set.)
      const int n_elem = B * ld;
      for (int i = tid; i < R * kStepXStride / 4; i += kRecThreads) {
        const int r = i / (kStepXStride / 4), c = i % (kStepXStride / 4);
        const int e = (r0 + r) * ld / 4 * 4 + k0 + 4 * c;
        const int left = r0 + r < B ? n_elem - e : 0;
        const int n = left >= 4 ? 16 : left > 0 ? left * 4 : 0;
        asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                         smem_u32(xs + 4 * i)),
                     "l"(n > 0 ? src + e : h0), "r"(n)
                     : "memory");
      }
    } else {   // thread t takes k0 + t % 128 of rows t / 128, ...
      const int kk = tid % KS;
#pragma unroll 4
      for (int r = tid / KS; r < R; r += kRecThreads / KS) {
        const bool ok = kk < kv && r0 + r < B;
        cp_async<4>(xs + r * kStepXStride + kk,
                    ok ? src + (int64_t)(r0 + r) * ld + k0 + kk : h0, ok);
      }
    }
  };

  // b and c0 of the cells, with the first stage.
  if (tid < Q) {
    const bool ok = j0 + tid % U < H;
    cp_async<4>(bin + tid, ok ? bias + (tid / U) * H + j0 + tid % U : h0, ok);
  }
  for (int c = c_beg + tid; c < c_end; c += kRecThreads) {
    const int b = r0 + c / U, j = j0 + c % U;
    const bool ok = b < B && j < H;
    cp_async<4>(cin + c - c_beg, ok ? c0 + (int64_t)b * H + j : h0, ok);
  }

  // FFMA: acc[8i + c] of row rg + 8i, column 8 cq + c (gate cq, unit c).
  // TF32: acc[16 mi + 4n + e] of the warp's 16-row piece mi x gate n's 8
  // columns, fragment element e.
  constexpr int TR = R / 8;
  constexpr int kAcc = TF32 ? 32 : TR * 8;
  float acc[kAcc];
#pragma unroll
  for (int i = 0; i < kAcc; ++i) acc[i] = 0.f;
  const int rg = lane % 8, cq = lane / 8;             // FFMA
  const int g8 = lane >> 2, t4 = lane & 3;            // TF32 fragments
  constexpr int kPieces = R / 32;                     // TF32 32-row pieces
  const int kgi = TF32 ? warp / kPieces : warp;
  const int rp = warp % kPieces;
  // The rows this lane contracts: their masks (for the stages of h0) and
  // where their x and h0 sit in a staged row (the offset in the 16-byte
  // piece that holds the stage's first k).
  constexpr int kM = TF32 ? 4 : TR;
  float mreg[kM];
  int ox[kM], oh[kM];
#pragma unroll
  for (int i = 0; i < kM; ++i) {
    const int64_t b = r0 + (TF32 ? 32 * rp + g8 + 8 * i : rg + 8 * i);
    mreg[i] = b < B ? mask[b] : 0.f;
    ox[i] = xal ? (int)(b * F % 4) : 0;
    oh[i] = xal ? (int)(b * H % 4) : 0;
  }

#pragma unroll
  for (int kt = 0; kt < NST - 1; ++kt) {
    if (kt < nk) load_stage(kt);
    commit_group();
  }
  for (int kt = 0; kt < nk; ++kt) {
    cp_async_wait<NST - 2>();   // this thread's part of stage kt landed
    if (tma) mbar_wait(&full[kt % NST], (kt / NST) & 1);   // and W
    __syncthreads();            // everyone's; stage kt-1 is read
    if (kt + NST - 1 < nk) load_stage(kt + NST - 1);
    commit_group();
    const float* ws = smem + (kt % NST) * SF;
    const float* xs = ws + 4 * kStepWTile;
    // The stage's contraction, with the rows' masks applied to h0 where
    // ``masked`` (a stage of h0) and not otherwise.
    auto contract = [&](auto masked) {
      if constexpr (!TF32) {
        const float* xr[TR];
#pragma unroll
        for (int i = 0; i < TR; ++i)
          xr[i] = xs + (rg + 8 * i) * kStepXStride +
                  (decltype(masked)::value ? oh[i] : ox[i]);
#pragma unroll
        for (int half = 0; half < KS / 32; ++half) {
          const int k = 4 * warp + 32 * half;
#pragma unroll
          for (int kk = 0; kk < 4; ++kk) {
            const float* wrow = ws + (cq * KS + k + kk) * U;
            const float4 w0 = *reinterpret_cast<const float4*>(wrow);
            const float4 w1 = *reinterpret_cast<const float4*>(wrow + 4);
#pragma unroll
            for (int i = 0; i < TR; ++i) {
              float v = xr[i][k + kk];
              if constexpr (decltype(masked)::value) v *= mreg[i];
              float* a = acc + 8 * i;
              a[0] = fmaf(v, w0.x, a[0]);
              a[1] = fmaf(v, w0.y, a[1]);
              a[2] = fmaf(v, w0.z, a[2]);
              a[3] = fmaf(v, w0.w, a[3]);
              a[4] = fmaf(v, w1.x, a[4]);
              a[5] = fmaf(v, w1.y, a[5]);
              a[6] = fmaf(v, w1.z, a[6]);
              a[7] = fmaf(v, w1.w, a[7]);
            }
          }
        }
      } else {
        float d[2][4][4];
#pragma unroll
        for (int i = 0; i < 32; ++i) d[i / 16][i / 4 % 4][i % 4] = 0.f;
        // Rows 32 rp + 8 i + g8: i = 0, 1 the piece mi = 0, i = 2, 3 mi = 1.
        const float* ar[4];
#pragma unroll
        for (int i = 0; i < 4; ++i)
          ar[i] = xs + (32 * rp + 8 * i + g8) * kStepXStride +
                  (decltype(masked)::value ? oh[i] : ox[i]) + t4;
        auto a_at = [&](int i, int k) {
          float v = ar[i][k];
          if constexpr (decltype(masked)::value) v *= mreg[i];
          return v;
        };
#pragma unroll
        for (int j = 0; j < KS / 8 / KG; ++j) {
          const int k = 8 * (kgi + KG * j);
          uint32_t ah[2][4], al[2][4];
#pragma unroll
          for (int mi = 0; mi < 2; ++mi) {
            split_tf32(a_at(2 * mi, k), ah[mi][0], al[mi][0]);         // (g, t)
            split_tf32(a_at(2 * mi + 1, k), ah[mi][1], al[mi][1]);     // (g+8, t)
            split_tf32(a_at(2 * mi, k + 4), ah[mi][2], al[mi][2]);     // (g, t+4)
            split_tf32(a_at(2 * mi + 1, k + 4), ah[mi][3], al[mi][3]); // (g+8, t+4)
          }
#pragma unroll
          for (int n = 0; n < 4; ++n) {   // gate n: its 8 units' columns
            const float* bp = ws + (n * KS + k + t4) * U + g8;
            uint32_t bh0, bl0, bh1, bl1;
            split_tf32(bp[0], bh0, bl0);                 // (k t, unit g)
            split_tf32(bp[4 * U], bh1, bl1);             // (k t+4)
#pragma unroll
            for (int mi = 0; mi < 2; ++mi) {
              mma_tf32(d[mi][n], al[mi], bh0, bh1);   // small terms first
              mma_tf32(d[mi][n], ah[mi], bl0, bl1);
              mma_tf32(d[mi][n], ah[mi], bh0, bh1);
            }
          }
        }
#pragma unroll
        for (int i = 0; i < 32; ++i) acc[i] += d[i / 16][i / 4 % 4][i % 4];
      }
    };
    if (s0 + kt >= nx)
      contract(std::true_type{});
    else
      contract(std::false_type{});
  }
  cp_async_wait<0>();
  __syncthreads();   // the ring is read; the partials take its place

  float* part = smem;                               // [KG][R][Q]
  float* red = KG > 1 ? part + KG * R * Q : part;   // [R][Q]
  if constexpr (!TF32) {
#pragma unroll
    for (int i = 0; i < TR; ++i) {
      float* p = part + (warp * R + rg + 8 * i) * Q + 8 * cq;
      *reinterpret_cast<float4*>(p) =
          make_float4(acc[8 * i], acc[8 * i + 1], acc[8 * i + 2], acc[8 * i + 3]);
      *reinterpret_cast<float4*>(p + 4) = make_float4(
          acc[8 * i + 4], acc[8 * i + 5], acc[8 * i + 6], acc[8 * i + 7]);
    }
  } else {
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
      for (int n = 0; n < 4; ++n)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          float* p = part + (kgi * R + 32 * rp + 16 * mi + g8 + 8 * h) * Q +
                     8 * n + 2 * t4;
          const float* a = acc + 16 * mi + 4 * n + 2 * h;
          *reinterpret_cast<float2*>(p) = make_float2(a[0], a[1]);
        }
  }
  __syncthreads();
  if constexpr (KG > 1) {
    for (int e = tid; e < R * Q; e += kRecThreads) {
      float s = part[e];
#pragma unroll
      for (int k = 1; k < KG; ++k) s += part[k * R * Q + e];
      red[e] = s;
    }
  }
  cg::cluster_group cluster = cg::this_cluster();
  if (splits > 1)
    cluster.sync();   // every split's partial tile is in its red
  else
    __syncthreads();

  // Cells (row r, unit u): this CTA's share [c_beg, c_end).
  for (int c = c_beg + tid; c < c_end; c += kRecThreads) {
    const int r = c / U, u = c % U, b = r0 + r, j = j0 + u;
    if (b >= B || j >= H) continue;
    float p[4];
#pragma unroll
    for (int g = 0; g < 4; ++g) {
      const int q = r * Q + g * U + u;
      float s = red[q];
      if (splits > 1) {
        s = cluster.map_shared_rank(red, 0)[q];
        for (int zz = 1; zz < splits; ++zz)
          s += cluster.map_shared_rank(red, zz)[q];
      }
      p[g] = s + bin[g * U + u];
    }
    const float gi = sigmoid(p[0]), gf = sigmoid(p[1]);
    const float gg = tanhf(p[2]), go = sigmoid(p[3]);
    const float cn = gf * (cin[c - c_beg] * mrow[r]) + gi * gg;
    const float hn = go * tanhf(cn);
    const int64_t o = (int64_t)b * H + j;
    y[o] = hn;
    cs[o] = cn;
    hT[o] = hn;
    cT[o] = cn;
    float* grow = gates + (int64_t)b * H4 + j;
    grow[0] = gi;
    grow[H] = gf;
    grow[2 * H] = gg;
    grow[3 * H] = go;
  }
  if (splits > 1) cluster.sync();   // no CTA leaves while a peer reads it
}

// The one-step kernel's shapes: (rows a CTA, TF32 path).
using StepKernel = void (*)(const CUtensorMap, const CUtensorMap,
                            const float*, const float*, const float*,
                            const float*, const float*, const float*,
                            const float*, float*, float*, float*, float*,
                            float*, int, int, int, int, int, int, int);
struct StepShape {
  int rows, tf32;
  StepKernel kernel;
  size_t smem;
};
// What ops/lstm.py STEP_SHAPES lists.
const StepShape kStepShapes[] = {
    {8, 0, lstm_step_kernel<8, false>, step_smem(8, false)},
    {16, 0, lstm_step_kernel<16, false>, step_smem(16, false)},
    {32, 0, lstm_step_kernel<32, false>, step_smem(32, false)},
    {32, 1, lstm_step_kernel<32, true>, step_smem(32, true)},
    {64, 1, lstm_step_kernel<64, true>, step_smem(64, true)},
};
constexpr int kNumStepShapes = sizeof(kStepShapes) / sizeof(kStepShapes[0]);

// cuTensorMapEncodeTiled from the CUDA driver library (loaded already), so
// that the library links against the runtime alone.
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType,
                                 cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

EncodeTiled tensor_map_encoder() {
  static EncodeTiled fn = nullptr;
  static bool tried = false;
  if (!tried) {
    tried = true;
    void* lib = dlopen("libcuda.so.1", RTLD_NOW | RTLD_NOLOAD);
    if (lib == nullptr) lib = dlopen("libcuda.so.1", RTLD_NOW);
    if (lib != nullptr)
      fn = reinterpret_cast<EncodeTiled>(dlsym(lib, "cuTensorMapEncodeTiled"));
  }
  return fn;
}

// The tensor map of a row-major float32 W [rows][cols] in boxes of
// kStepK rows x kStepUnits columns; the last few made are kept, by
// address and shape (a model's weights keep theirs from call to call).
bool step_weight_map(CUtensorMap* out, const float* w, int rows, int cols) {
  struct Entry {
    CUtensorMap map;
    const float* w;
    int rows, cols;
  };
  static Entry cache[8];
  static int next = 0;
  for (const Entry& e : cache)
    if (e.w == w && e.rows == rows && e.cols == cols) {
      *out = e.map;
      return true;
    }
  EncodeTiled encode = tensor_map_encoder();
  if (encode == nullptr) return false;
  const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)cols * sizeof(float)};
  const cuuint32_t box[2] = {kStepUnits, kStepK};
  const cuuint32_t elem[2] = {1, 1};
  Entry& e = cache[next];
  if (encode(&e.map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 2,
             const_cast<float*>(w), dims, strides, box, elem,
             CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
             CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS) {
    e.w = nullptr;
    return false;
  }
  e.w = w;
  e.rows = rows;
  e.cols = cols;
  next = (next + 1) % 8;
  *out = e.map;
  return true;
}

}  // namespace

extern "C" {

int lstm_proj_k_step() { return kBK; }

// K3a's tensor-core shapes: how many, and shape ``i`` as (tile_m, tile_n,
// splits); ``ops/lstm.py`` checks its plan against these.
int lstm_proj_shape_count() { return kNumProjShapes; }
void lstm_proj_shape(int i, int* tile_m, int* tile_n, int* splits) {
  *tile_m = kProjShapes[i].tile_m;
  *tile_n = kProjShapes[i].tile_n;
  *splits = kProjShapes[i].splits;
}

// K3a.  x [M, K], wx [K, N], b [N] -> xg [M, N].  (tile_m, tile_n,
// splits) picks one of kProjShapes, the tensor-core kernel with tiles of
// tile_m rows (64 for each consumer warpgroup) by tile_n columns; with
// splits > 1 a cluster of ``splits`` CTAs takes K rows [z*k_chunk,
// (z+1)*k_chunk) each (k_chunk a multiple of 32, no split empty), else
// k_chunk >= K.  All need N % 4 == 0 and wx, b, xg 16-byte aligned.
// tile_m == 0 is the generic kernel.
int lstm_proj_launch(const void* x, const void* wx, const void* b, void* xg,
                     int M, int N, int K, int tile_m, int tile_n, int k_chunk,
                     int splits, void* stream) {
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
  const bool covered =
      splits == 1 ? k_chunk >= K
                  : k_chunk > 0 && k_chunk % kBK == 0 &&
                        (int64_t)k_chunk * splits >= K &&
                        (int64_t)k_chunk * (splits - 1) < K;
  ProjLaunch launch = nullptr;
  for (const ProjShape& shape : kProjShapes)
    if (shape.tile_m == tile_m && shape.tile_n == tile_n &&
        shape.splits == splits)
      launch = shape.launch;
  if (!aligned || !covered || launch == nullptr ||
      (M + tile_m - 1) / tile_m > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = launch(A, W, bias, C, M, N, K, k_chunk, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

// The recurrences' CTA shape and shared memory for a plan
// (``ops/lstm.py``'s ``recurrence_plan`` computes the same and checks it
// against these).
int lstm_rec_units() { return kUnits; }
int lstm_rec_cluster() { return kCluster; }
long long lstm_fwd_smem(int B, int H, int stage_rows) {
  return (long long)fwd_smem(B, H, stage_rows);
}
long long lstm_bwd_smem(int B, int H) { return (long long)bwd_smem(B, H); }

// K3.  xg [T, B, 4H], wh [H, 4H], mask [T, B], h0, c0 [B, H] ->
// y, cs [T, B, H], gates [T, B, 4H], hT, cT [B, H].  ``ctas`` CTAs of
// kUnits hidden units (ceil(H / kUnits) rounded up to whole clusters);
// h staged ``stage_rows`` (a multiple of 32) rows at a time; ``counter``
// a zeroed int in device memory (unused, and may be null, when T == 1:
// then the launch is an ordinary one).
int lstm_fwd_launch(const void* xg, const void* wh, const void* mask,
                    const void* h0, const void* c0, void* y, void* gates,
                    void* cs, void* hT, void* cT, void* counter, int T, int B,
                    int H, int ctas, int stage_rows, void* stream) {
  if (T == 0 || B == 0 || H == 0) return 0;
  const size_t smem = fwd_smem(B, H, stage_rows);
  if (stage_rows <= 0 || stage_rows % kRowBlock != 0 ||
      smem > (size_t)kSmemMax || (T > 1 && counter == nullptr) ||
      !plan_ok(H, ctas))
    return kErrBadPlan;
  const float *a_xg = static_cast<const float*>(xg),
              *a_wh = static_cast<const float*>(wh),
              *a_mask = static_cast<const float*>(mask),
              *a_h0 = static_cast<const float*>(h0),
              *a_c0 = static_cast<const float*>(c0);
  float *a_y = static_cast<float*>(y), *a_g = static_cast<float*>(gates),
        *a_cs = static_cast<float*>(cs), *a_hT = static_cast<float*>(hT),
        *a_cT = static_cast<float*>(cT);
  int* a_cnt = static_cast<int*>(counter);
  int vec = H % 4 == 0 &&
            ((reinterpret_cast<uintptr_t>(wh) | reinterpret_cast<uintptr_t>(h0) |
              reinterpret_cast<uintptr_t>(y)) & 15u) == 0;
  void* args[] = {&a_xg, &a_wh, &a_mask, &a_h0, &a_c0, &a_y, &a_g, &a_cs,
                  &a_hT, &a_cT, &a_cnt, &T, &B, &H, &stage_rows, &vec};
  return static_cast<int>(launch_recurrence(
      reinterpret_cast<const void*>(lstm_fwd_kernel), 0, ctas, smem, T > 1,
      args, static_cast<cudaStream_t>(stream)));
}

// K4.  gates [T, B, 4H], cs [T, B, H], c0 [B, H], mask [T, B], wh [H, 4H],
// dy [T, B, H] (hT's cotangent already added to dy[T-1]), dcT [B, H] ->
// dgates [T, B, 4H], dh0, dc0 [B, H].  CTAs as for K3.  ``part`` is
// scratch of 2 * (ctas / kCluster) * B * padded_h(H) floats,
// ``counter`` a zeroed int.
int lstm_bwd_launch(const void* gates, const void* cs, const void* c0,
                    const void* mask, const void* wh, const void* dy,
                    const void* dcT, void* dgates, void* dh0, void* dc0,
                    void* part, void* counter, int T, int B, int H, int ctas,
                    void* stream) {
  if (T == 0 || B == 0 || H == 0) return 0;
  if (!plan_ok(H, ctas)) return kErrBadPlan;
  const size_t smem = bwd_smem(B, H);
  if (smem > (size_t)kSmemMax || counter == nullptr ||
      (reinterpret_cast<uintptr_t>(part) & 15u) != 0)
    return kErrBadPlan;
  const float *a_g = static_cast<const float*>(gates),
              *a_cs = static_cast<const float*>(cs),
              *a_c0 = static_cast<const float*>(c0),
              *a_mask = static_cast<const float*>(mask),
              *a_wh = static_cast<const float*>(wh),
              *a_dy = static_cast<const float*>(dy),
              *a_dcT = static_cast<const float*>(dcT);
  float *a_dg = static_cast<float*>(dgates), *a_dh0 = static_cast<float*>(dh0),
        *a_dc0 = static_cast<float*>(dc0), *a_part = static_cast<float*>(part);
  int* a_cnt = static_cast<int*>(counter);
  int vec = H % 4 == 0 && (reinterpret_cast<uintptr_t>(wh) & 15u) == 0;
  void* args[] = {&a_g,   &a_cs, &a_c0,  &a_mask, &a_wh,   &a_dy,
                  &a_dcT, &a_dg, &a_dh0, &a_dc0,  &a_part, &a_cnt,
                  &T,     &B,    &H,     &vec};
  return static_cast<int>(launch_recurrence(
      reinterpret_cast<const void*>(lstm_bwd_kernel), 1, ctas, smem, true,
      args, static_cast<cudaStream_t>(stream)));
}

// The cluster path's shared memory for C CTAs of ``units`` units taking
// ``rows`` rows each (``ops/lstm.py`` checks its plan against these).
long long lstm_fwd_cluster_smem(int H, int rows, int units) {
  return (long long)fwd_cluster_smem(H, rows, units);
}
long long lstm_bwd_cluster_smem(int H, int C, int rows, int units) {
  return (long long)bwd_cluster_smem(H, C, rows, units);
}
int lstm_tile_lanes(int tiles) { return tile_lanes(tiles); }

// How many clusters of C CTAs with ``smem`` bytes each the device holds
// at once (cudaOccupancyMaxActiveClusters; ``which`` 0 is K3, 1 is K4),
// or minus a CUDA error code.
int lstm_cluster_capacity(int which, int C, long long smem) {
  const void* kernel =
      which == 0 ? reinterpret_cast<const void*>(lstm_fwd_cluster_kernel)
                 : reinterpret_cast<const void*>(lstm_bwd_cluster_kernel);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemMax);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (err != cudaSuccess) return -static_cast<int>(err);
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = C;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(C);
  cfg.blockDim = dim3(kRecThreads);
  cfg.dynamicSmemBytes = (size_t)smem;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  int n = 0;
  err = cudaOccupancyMaxActiveClusters(&n, kernel, &cfg);
  return err == cudaSuccess ? n : -static_cast<int>(err);
}

// K3 on the cluster path, T > 1: the arguments of lstm_fwd_launch but the
// counter, on ``clusters`` clusters of C CTAs of ``units`` units, each
// cluster taking ``rows`` batch rows.
int lstm_fwd_cluster_launch(const void* xg, const void* wh, const void* mask,
                            const void* h0, const void* c0, void* y,
                            void* gates, void* cs, void* hT, void* cT, int T,
                            int B, int H, int C, int rows, int units,
                            void* stream) {
  if (T == 0 || B == 0 || H == 0) return 0;
  const size_t smem = fwd_cluster_smem(H, rows, units);
  if (!cluster_plan_ok(H, C, rows, units) || smem > (size_t)kSmemMax)
    return kErrBadPlan;
  int clusters = (B + rows - 1) / rows;
  const float *a_xg = static_cast<const float*>(xg),
              *a_wh = static_cast<const float*>(wh),
              *a_mask = static_cast<const float*>(mask),
              *a_h0 = static_cast<const float*>(h0),
              *a_c0 = static_cast<const float*>(c0);
  float *a_y = static_cast<float*>(y), *a_g = static_cast<float*>(gates),
        *a_cs = static_cast<float*>(cs), *a_hT = static_cast<float*>(hT),
        *a_cT = static_cast<float*>(cT);
  void* args[] = {&a_xg, &a_wh, &a_mask, &a_h0, &a_c0, &a_y, &a_g, &a_cs,
                  &a_hT, &a_cT, &T,    &B,      &H,    &C,   &rows, &units};
  return static_cast<int>(launch_clusters(
      reinterpret_cast<const void*>(lstm_fwd_cluster_kernel), 0, clusters, C,
      smem, args, static_cast<cudaStream_t>(stream)));
}

// K4 on the cluster path: the arguments of lstm_bwd_launch but the
// scratch and the counter, on clusters as for K3.
int lstm_bwd_cluster_launch(const void* gates, const void* cs, const void* c0,
                            const void* mask, const void* wh, const void* dy,
                            const void* dcT, void* dgates, void* dh0,
                            void* dc0, int T, int B, int H, int C, int rows,
                            int units, void* stream) {
  if (T == 0 || B == 0 || H == 0) return 0;
  const size_t smem = bwd_cluster_smem(H, C, rows, units);
  if (!cluster_plan_ok(H, C, rows, units) || smem > (size_t)kSmemMax)
    return kErrBadPlan;
  int clusters = (B + rows - 1) / rows;
  const float *a_g = static_cast<const float*>(gates),
              *a_cs = static_cast<const float*>(cs),
              *a_c0 = static_cast<const float*>(c0),
              *a_mask = static_cast<const float*>(mask),
              *a_wh = static_cast<const float*>(wh),
              *a_dy = static_cast<const float*>(dy),
              *a_dcT = static_cast<const float*>(dcT);
  float *a_dg = static_cast<float*>(dgates), *a_dh0 = static_cast<float*>(dh0),
        *a_dc0 = static_cast<float*>(dc0);
  void* args[] = {&a_g,   &a_cs, &a_c0,  &a_mask, &a_wh, &a_dy,
                  &a_dcT, &a_dg, &a_dh0, &a_dc0,  &T,    &B,
                  &H,     &C,    &rows,  &units};
  return static_cast<int>(launch_clusters(
      reinterpret_cast<const void*>(lstm_bwd_cluster_kernel), 1, clusters, C,
      smem, args, static_cast<cudaStream_t>(stream)));
}

// The one-step kernel's CTA shape and built shapes: ``ops/lstm.py``'s
// step_plan computes the same and checks it against these.
int lstm_step_units() { return kStepUnits; }
int lstm_step_depth() { return kStepK; }
int lstm_step_shape_count() { return kNumStepShapes; }
// Dynamic shared memory of the shape (rows, tf32), or -1 where not built.
long long lstm_step_smem(int rows, int tf32) {
  for (const StepShape& s : kStepShapes)
    if (s.rows == rows && s.tf32 == tf32) return (long long)s.smem;
  return -1;
}

// The one-step forward.  x [B, F], wx [F, 4H], wh [H, 4H], b [4H],
// mask [B] (1 - done), h0, c0 [B, H] -> y, cs, hT, cT [B, H], gates
// [B, 4H].  CTAs of kStepUnits units and ``rows`` rows (one of
// kStepShapes, ``tf32`` its path); ``splits`` CTAs of a cluster take
// ``split_stages`` of the ceil(F / 64) + ceil(H / 64) stages each (none
// empty).  W by TMA where H % 4 == 0 and both W are 16-byte aligned.
int lstm_step_launch(const void* x, const void* wx, const void* wh,
                     const void* b, const void* mask, const void* h0,
                     const void* c0, void* y, void* gates, void* cs, void* hT,
                     void* cT, int B, int H, int F, int rows, int tf32,
                     int splits, int split_stages, void* stream) {
  if (B == 0) return 0;
  int shape = -1;
  for (int i = 0; i < kNumStepShapes; ++i)
    if (kStepShapes[i].rows == rows && kStepShapes[i].tf32 == tf32) shape = i;
  const int64_t n_all = ((int64_t)F + kStepK - 1) / kStepK +
                        ((int64_t)H + kStepK - 1) / kStepK;
  const int64_t tiles = ((int64_t)B + rows - 1) / (rows > 0 ? rows : 1);
  const int64_t groups = ((int64_t)H + kStepUnits - 1) / kStepUnits;
  if (shape < 0 || B < 0 || H < 1 || F < 0 || splits < 1 ||
      splits > kStepMaxSplits || split_stages < 1 ||
      (int64_t)split_stages * splits < n_all ||
      (int64_t)split_stages * (splits - 1) >= n_all || tiles > 65535 ||
      groups * splits > 0x7fffffff)
    return kErrBadPlan;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (dev >= 64) return static_cast<int>(cudaErrorInvalidDevice);
  static bool opted_in[kNumStepShapes][64];
  const StepShape& s = kStepShapes[shape];
  if (!opted_in[shape][dev]) {
    err = cudaFuncSetAttribute(s.kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)s.smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    opted_in[shape][dev] = true;
  }
  // A TMA box of kStepK rows needs W of as many rows or more.
  int tma = ((reinterpret_cast<uintptr_t>(wx) |
              reinterpret_cast<uintptr_t>(wh)) & 15u) == 0 &&
            H >= kStepK && (F == 0 || F >= kStepK);
  int xal = ((reinterpret_cast<uintptr_t>(x) |
              reinterpret_cast<uintptr_t>(h0)) & 15u) == 0 &&
            (int64_t)B * ((int64_t)F + H) < 0x7fffff00;
  alignas(64) CUtensorMap tmx = {}, tmh = {};
  if (tma && ((F > 0 && !step_weight_map(&tmx, static_cast<const float*>(wx),
                                         F, 4 * H)) ||
              !step_weight_map(&tmh, static_cast<const float*>(wh), H,
                               4 * H)))
    return kErrNoTensorMap;
  const float *a_x = static_cast<const float*>(x),
              *a_wx = static_cast<const float*>(wx),
              *a_wh = static_cast<const float*>(wh),
              *a_b = static_cast<const float*>(b),
              *a_m = static_cast<const float*>(mask),
              *a_h0 = static_cast<const float*>(h0),
              *a_c0 = static_cast<const float*>(c0);
  float *a_y = static_cast<float*>(y), *a_g = static_cast<float*>(gates),
        *a_cs = static_cast<float*>(cs), *a_hT = static_cast<float*>(hT),
        *a_cT = static_cast<float*>(cT);
  void* args[] = {&tmx, &tmh,  &a_x,   &a_wx,   &a_wh,         &a_b,
                  &a_m, &a_h0, &a_c0,  &a_y,    &a_g,          &a_cs,
                  &a_hT, &a_cT, &B,    &H,      &F,            &splits,
                  &split_stages, &tma, &xal};
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = splits;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)(groups * splits), (unsigned)tiles);
  cfg.blockDim = dim3(kRecThreads);
  cfg.dynamicSmemBytes = s.smem;
  cfg.stream = static_cast<cudaStream_t>(stream);
  cfg.attrs = &attr;
  cfg.numAttrs = splits > 1 ? 1 : 0;   // no cluster without a split
  err = cudaLaunchKernelExC(&cfg, reinterpret_cast<const void*>(s.kernel),
                            args);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

const char* lstm_error_string(int code) {
  if (code == kErrNotResident)
    return "the recurrence's CTAs cannot all be resident at once "
           "(they wait for each other at every step)";
  if (code == kErrNoTensorMap)
    return "the one-step kernel could not make W's TMA tensor map "
           "(cuTensorMapEncodeTiled from libcuda.so.1)";
  if (code == kErrBadPlan)
    return "the recurrence's plan does not fit the kernel (CTAs of 4 "
           "units enough for H in whole clusters of 2, stage rows a "
           "multiple of 32, a counter for T > 1, 16-byte aligned scratch; "
           "on the cluster path at most 16 CTAs of a multiple of 4 units "
           "enough for H, at most 256 cells a CTA; shared memory within "
           "226 KB), or the one-step kernel's (a built shape of rows and "
           "path, 1-8 splits of the stages, none empty)";
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
