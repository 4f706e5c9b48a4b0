// Approximate k smallest distances of each row of a dense tile: the seeding's
// fused distance epilogue + partial reduction + top-k.
//
// Replaces jax.lax.approx_min_k as XLA lowers it on the TPU (its ApproxTopK
// partial reduction; not a Pallas kernel), where the JAX package picks its
// seeds: ggnn_tpu/query/fused.py:758 (the fused query with seed_approx) and
// ggnn_tpu/build/merge.py:108 (every dense-seeded build merge). The port's
// definition, and its plain version, are in ggnn_torch/ops/approx_topk.py.
// For row b of the dot products dot[b, :n], with M bins (M = n: exact):
//
//   d[c]      = finish(dot[b, c], q_sq[b], c_sq[c])     (ops/distance.py)
//   win[j]    = the smallest (d[c], c) over c = j, j + M, j + 2M, ... < n
//   out[b, :] = the k smallest win[j] by (distance, position), ascending
//
// The epilogue does finish's f32 operations in its order, each rounded
// (__fadd_rn / __fmul_rn / __fsub_rn, so no FMA contraction): Euclidean
// max((q_sq + c_sq) - 2 * dot, 0); cosine |1 - dot * rsqrtf(q_sq * c_sq)|
// (1 where the product of the norms is not positive), rsqrtf as torch's
// CUDA rsqrt.
//
// What bounds it on Hopper: its bytes -- the [B, n] dot matrix read once
// (1.008 GB per tile of the headline's 8,192 x 30,752, 0.30 ms at 3.35
// TB/s); the norms and the [B, k] outputs are small. It does a few flops an
// element. Measured on an H100 (approx_bench.py), the first kernel of this
// file (one 128-thread block a row, 4-byte loads, k block-barrier rounds)
// lost its time to three things, in this order: 4-byte loads (16-byte
// loads alone took the 8,192-row tiles from 0.50 / 0.79 ms to 0.38 / 0.49
// ms at k = 8 / 32); the k rounds of a block barrier at k = 32 (0.11 ms of
// the 0.49); and the ramp of a 1,024-row tile. The norms' re-reads cost
// nothing measurable: they hit L1. Bytes in flight decide the rest: loads
// into registers (8 of 16 bytes a lane, 16 warps an SM) reached 0.77 of
// the bound, the copies below 0.83.
//
// The reducing rows (M < n, M % 128 == 0, k <= 32: every seeding shape)
// whose rows and norms are 16-byte aligned take approx_topk_kernel_warp:
//
//   * a block of 4 warps takes 4 rows, a warp a row. Lane l owns bins
//     4l .. 4l + 3 of every 128-wide sub-tile, so a bin's elements always
//     fall in the same lane, and keeps each bin's minimum (distance and
//     tile index: the position is recomputed) in registers, 4 * NSUB bins a
//     pass (NSUB = the sub-tiles of a tile rounded up to 1, 2, 4 or 8; bins
//     past 1,024 take passes);
//   * the rows stream through a ring of kStages stages in shared memory:
//     thread 0 fills a stage with bulk copies (cp.async.bulk, 1-D TMA, an
//     mbarrier counting the bytes) of a batch of each of the block's rows --
//     8 / NSUB tiles, 4 KB a row -- and of the norms' same columns, read
//     once for the 4 rows. Each warp waits on the stage's mbarrier, folds
//     its row with 16-byte shared loads, and arrives on the stage's "empty"
//     mbarrier; thread 0 refills a stage once all 4 have. No register holds
//     a load in flight, so 5 blocks (20 warps) fit an SM at 40 KB each. A
//     row's short last tile is read straight from device memory. A first
//     minimum is replaced only by a smaller distance, tiles in order, so
//     equal distances keep their lowest position; a NaN is never taken, so
//     it counts as +inf, the bin's start value at its first position (the
//     plain version's rule);
//   * the aggregation stays in the warp, with no barrier: a winner is the
//     64-bit key (order-preserving map of its distance's bits << 32) |
//     position, one signed compare ordering by (distance, position); the
//     warp keeps a sorted list, lane i holding the i-th smallest key, and
//     each bin's key below the list's k-th is inserted by a ballot (its
//     rank) and a shuffle up. Lane i < k writes out[b, i];
//   * a grid of at most the blocks the card holds at once (occupancy x SMs),
//     each block striding over the row groups, so a 1,024-row tile spreads
//     over every SM; the measure is a template argument.
//
// fold4 is the bin reduction of 4 columns of a row: a later gemm epilogue
// can call it on its accumulators, so that the dot matrix never reaches
// device memory.
//
// The exact rows (M == n: n <= 128, or k > M), the reducing rows with
// k > 32 and unaligned rows keep the first kernel, approx_topk_kernel_block:
// one block of 128 threads a row, thread l owning bins l, l + 128, ... in
// registers, the winners in shared memory (8 * M bytes), k rounds of a
// block argmin. They are launch-bound and rare on the main path, and the
// seeding's product always has aligned rows (ops/approx_topk.py).

#include <climits>
#include <cstdint>

#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

constexpr int kThreads = 128;           // both kernels' block
constexpr int kWarps = kThreads / 32;
constexpr int kUnroll = 4;              // the block kernel's tiles in flight
// the warp kernel: a warp a row, kRows a block; a stage of its ring holds a
// batch of kBatch 16-byte pieces a lane (4 KB) of each row and of the norms
constexpr int kRows = kWarps;
constexpr int kStages = 2;
constexpr int kBatch = 8;
constexpr int kSlot = kBatch * 32;      // 16-byte pieces of a row's batch
static_assert(kBatch % 8 == 0, "a stage holds whole 1,024-bin tiles (NSUB <= 8)");
constexpr int kRingBytes = kStages * (kRows + 1) * kSlot * 16;
constexpr int kMaxDevices = 64;

// finish (ggnn_torch/ops/distance.py) for one element
__device__ __forceinline__ float distance(float dot, float a_sq, float b_sq,
                                          int measure) {
  if (measure == 0) {
    const float x = __fsub_rn(__fadd_rn(a_sq, b_sq), __fmul_rn(2.0f, dot));
    return x < 0.0f ? 0.0f : x;
  }
  const float norm_sq = __fmul_rn(a_sq, b_sq);
  const bool safe = norm_sq > 0.0f;
  const float d = fabsf(__fsub_rn(1.0f, __fmul_rn(dot, rsqrtf(safe ? norm_sq : 1.0f))));
  return safe ? d : 1.0f;
}

// (da, pa) orders before (db, pb): by distance, then by position
__device__ __forceinline__ bool before(float da, int pa, float db, int pb) {
  return da < db || (da == db && pa < pb);
}

// ---------------------------------------------------------------------------
// the warp kernel: reducing rows, k <= 32, 16-byte aligned rows and norms

// (distance, position) as one signed 64-bit key that orders as the pair:
// NaN as +inf, -0.0 as 0.0, negative distances by their flipped magnitude
__device__ __forceinline__ long long order_key(float d, int pos) {
  int s = isnan(d) ? __float_as_int(CUDART_INF_F) : __float_as_int(d);
  if (s == INT_MIN) s = 0;
  if (s < 0) s ^= INT_MAX;
  return (static_cast<long long>(s) << 32) | static_cast<unsigned>(pos);
}

__device__ __forceinline__ float key_distance(long long key) {
  const int s = static_cast<int>(key >> 32);
  return __int_as_float(s < 0 ? s ^ INT_MAX : s);
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_addr(bar)),
               "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(
                   smem_addr(bar)), "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(smem_addr(bar))
               : "memory");
}

// spins until the phase of parity ``parity`` of the barrier has completed
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}"
        : "=r"(done) : "r"(smem_addr(bar)), "r"(parity) : "memory");
  }
}

// one bulk copy (1-D TMA) of ``bytes`` (a multiple of 16, both addresses
// 16-byte aligned) from device memory to shared memory, counted on ``bar``
__device__ __forceinline__ void bulk_load(void* dst, const void* src,
                                          uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];" ::"r"(smem_addr(dst)), "l"(src), "r"(bytes),
      "r"(smem_addr(bar)) : "memory");
}

// 4 values at column c of a row or the norms, those at or past n zero (the
// row's short last tile)
__device__ __forceinline__ float4 load_part(const float* p, int c, int n) {
  if (c + 3 < n) return __ldg(reinterpret_cast<const float4*>(p + c));
  float4 v;
  float* vs = &v.x;
#pragma unroll
  for (int e = 0; e < 4; ++e) vs[e] = c + e < n ? __ldg(p + c + e) : 0.0f;
  return v;
}

// The bin reduction of 4 consecutive columns c .. c + 3 of one row, in tile
// t, into a lane's bins b0 .. b0 + 3: dots and their columns' norms in,
// finish's distance, a bin's minimum replaced only by a smaller one. With
// CHECK the columns at or past n are skipped.
template <bool CHECK, int BL>
__device__ __forceinline__ void fold4(float4 v, float4 w, float a_sq, int t,
                                      int c, int n, int measure, int b0,
                                      float (&bd)[BL], int (&bt)[BL]) {
  const float vs[4] = {v.x, v.y, v.z, v.w};
  const float ws[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const float d = distance(vs[e], a_sq, ws[e], measure);
    if ((!CHECK || c + e < n) && d < bd[b0 + e]) {
      bd[b0 + e] = d;
      bt[b0 + e] = t;
    }
  }
}

// Offers each lane's key to the warp's sorted list (lane i holds the i-th
// smallest key so far; keys are distinct): the keys below the list's k-th,
// in lane order, each inserted at its rank
__device__ __forceinline__ long long warp_offer(long long list, long long key,
                                                int k, int lane) {
  long long kth = __shfl_sync(0xffffffffu, list, k - 1);
  unsigned todo = __ballot_sync(0xffffffffu, key < kth);
  while (todo) {
    const int src = __ffs(todo) - 1;
    todo &= todo - 1;
    const long long x = __shfl_sync(0xffffffffu, key, src);
    if (x < kth) {
      const int rank = __popc(__ballot_sync(0xffffffffu, list < x));
      const long long up = __shfl_up_sync(0xffffffffu, list, 1);
      list = lane < rank ? list : (lane == rank ? x : up);
      kth = __shfl_sync(0xffffffffu, list, k - 1);
    }
  }
  return list;
}

// The ring's geometry. A stage holds one batch (TU = kBatch / NSUB tiles of
// the pass's sub-tiles) of each of the block's kRows rows and of the norms:
// kBatch 16-byte pieces a lane, (kRows + 1) x 4 KB. A job is one stage's
// batch; the block's jobs run row group by row group, pass by pass, batch by
// batch, and thread 0 issues each kStages jobs ahead of the warps.
struct Ring {
  int M, B, G, NSUB, TU, nb, per_group;
  long long ld;

  // job j of this block: its row group, pass's first sub-tile, first tile
  __device__ void job(long long j, long long& group, int& g0, int& t0) const {
    const long long gi = j / per_group;
    const int r = static_cast<int>(j % per_group);
    group = blockIdx.x + gi * gridDim.x;
    g0 = r / nb * NSUB;
    t0 = r % nb * TU;
  }

  // thread 0: bulk copies of job j into its stage, counted on full[stage]
  __device__ void issue(long long j, float4* ring, uint64_t* full,
                        const float* dot, const float* c_sq) const {
    long long group;
    int g0, t0;
    job(j, group, g0, t0);
    const int slot = static_cast<int>(j % kStages);
    const int gp = min(NSUB, G - g0);
    const uint32_t seg = gp * 512;  // bytes of one tile's sub-tiles of the pass
    float4* stage = ring + slot * (kRows + 1) * kSlot;
    mbar_expect_tx(&full[slot], (kRows + 1) * TU * seg);
    for (int r = 0; r <= kRows; ++r) {
      // a row past B copies row B - 1 (its warp writes nothing)
      const long long row = min(group * kRows + r, static_cast<long long>(B) - 1);
      const float* src = r < kRows ? dot + row * ld : c_sq;
      if (gp * 128 == M && gp == NSUB)  // whole tiles back to back
        bulk_load(stage + r * kSlot, src + static_cast<long long>(t0) * M,
                  TU * seg, &full[slot]);
      else
        for (int u = 0; u < TU; ++u)
          bulk_load(stage + r * kSlot + u * NSUB * 32,
                    src + static_cast<long long>(t0 + u) * M + g0 * 128, seg,
                    &full[slot]);
    }
  }
};

template <int NSUB, int MEASURE>
__global__ void __launch_bounds__(kThreads)
approx_topk_kernel_warp(const float* __restrict__ dot, long long ld,
                        const float* __restrict__ q_sq,
                        const float* __restrict__ c_sq,
                        float* __restrict__ out_d, int32_t* __restrict__ out_p,
                        int B, int n, int M, int k) {
  constexpr int TU = kBatch / NSUB;  // tiles a batch
  constexpr int BL = 4 * NSUB;       // bins a lane holds a pass
  extern __shared__ float4 ring[];   // [kStages][kRows + 1][kSlot]
  __shared__ uint64_t full[kStages], empty[kStages];
  const int warp = threadIdx.x / 32, lane = threadIdx.x & 31;
  const int G = M / 128;                    // sub-tiles of a tile
  const int T = (n + M - 1) / M;            // tiles, the last maybe short
  const int t_whole = (n / M) / TU * TU;    // tiles the ring brings
  const int nb = t_whole / TU;              // ring batches a pass
  const int passes = (G + NSUB - 1) / NSUB;
  const Ring geo{M, B, G, NSUB, TU, nb, passes * nb, ld};
  const int groups = (B + kRows - 1) / kRows;
  const int my_groups = static_cast<int>(blockIdx.x) < groups
                            ? (groups - 1 - blockIdx.x) / gridDim.x + 1 : 0;
  const long long jobs = static_cast<long long>(my_groups) * geo.per_group;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], kRows);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    for (long long j = 0; j < jobs && j < kStages; ++j)
      geo.issue(j, ring, full, dot, c_sq);
  }
  __syncthreads();

  long long j = 0;  // this block's next job
  for (int gi = 0; gi < my_groups; ++gi) {
    const long long row = (blockIdx.x + static_cast<long long>(gi) * gridDim.x) * kRows + warp;
    const long long rowc = row < B ? row : B - 1;
    const float* drow = dot + rowc * ld;
    const float a_sq = q_sq[rowc];
    long long list = LLONG_MAX;
    for (int g0 = 0; g0 < G; g0 += NSUB) {
      const int gp = min(NSUB, G - g0);
      float bd[BL];
      int bt[BL];
#pragma unroll
      for (int b = 0; b < BL; ++b) {
        bd[b] = CUDART_INF_F;
        bt[b] = 0;
      }
      // the whole batches from the ring
      for (int t0 = 0; t0 < t_whole; t0 += TU, ++j) {
        const int slot = static_cast<int>(j % kStages);
        const uint32_t parity = static_cast<uint32_t>(j / kStages) & 1;
        mbar_wait(&full[slot], parity);
        const float4* stage = ring + slot * (kRows + 1) * kSlot;
#pragma unroll
        for (int u = 0; u < TU; ++u)
#pragma unroll
          for (int s = 0; s < NSUB; ++s) {
            if (s < gp) {
              const int piece = (u * NSUB + s) * 32 + lane;
              const int c = (t0 + u) * M + (g0 + s) * 128 + 4 * lane;
              fold4<false>(stage[warp * kSlot + piece], stage[kRows * kSlot + piece],
                           a_sq, t0 + u, c, n, MEASURE, 4 * s, bd, bt);
            }
          }
        __syncwarp();
        if (lane == 0) mbar_arrive(&empty[slot]);
        if (threadIdx.x == 0 && j + kStages < jobs) {
          mbar_wait(&empty[slot], parity);  // every warp is done with the stage
          geo.issue(j + kStages, ring, full, dot, c_sq);
        }
      }
      // the last, short tiles straight from device memory
      for (int t = t_whole; t < T; ++t)
#pragma unroll
        for (int s = 0; s < NSUB; ++s) {
          const int c = t * M + (g0 + s) * 128 + 4 * lane;
          if (s < gp)
            fold4<true>(load_part(drow, c, n), load_part(c_sq, c, n), a_sq, t, c,
                        n, MEASURE, 4 * s, bd, bt);
        }
#pragma unroll
      for (int b = 0; b < BL; ++b) {
        if (b / 4 < gp) {
          const int pos = bt[b] * M + (g0 + b / 4) * 128 + 4 * lane + b % 4;
          list = warp_offer(list, order_key(bd[b], pos), k, lane);
        }
      }
    }
    if (row < B && lane < k) {
      out_d[row * k + lane] = key_distance(list);
      out_p[row * k + lane] = static_cast<int32_t>(list & 0xffffffffll);
    }
  }
}

// a grid of at most the blocks the card holds at once (SMs x occupancy at
// the ring's shared memory, asked once per device), each block striding
// over the row groups
template <int NSUB, int MEASURE>
int launch_warp(const float* dot, long long ld, const float* q_sq,
                const float* c_sq, float* out_d, int32_t* out_p, int B, int n,
                int M, int k, cudaStream_t stream) {
  static int resident[kMaxDevices] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (dev >= kMaxDevices) return static_cast<int>(cudaErrorInvalidDevice);
  if (resident[dev] == 0) {
    int sms = 0, per_sm = 0;
    err = cudaFuncSetAttribute(approx_topk_kernel_warp<NSUB, MEASURE>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               kRingBytes);
    if (err == cudaSuccess)
      err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &per_sm, approx_topk_kernel_warp<NSUB, MEASURE>, kThreads, kRingBytes);
    if (err != cudaSuccess) return static_cast<int>(err);
    if (sms * per_sm <= 0) return static_cast<int>(cudaErrorInvalidConfiguration);
    resident[dev] = sms * per_sm;
  }
  const int needed = (B + kRows - 1) / kRows;
  const int grid = needed < resident[dev] ? needed : resident[dev];
  approx_topk_kernel_warp<NSUB, MEASURE><<<grid, kThreads, kRingBytes, stream>>>(
      dot, ld, q_sq, c_sq, out_d, out_p, B, n, M, k);
  return static_cast<int>(cudaGetLastError());
}

template <int MEASURE>
int dispatch_warp(const float* dot, long long ld, const float* q_sq,
                  const float* c_sq, float* out_d, int32_t* out_p, int B, int n,
                  int M, int k, cudaStream_t s) {
  const int G = M / 128;
  if (G <= 1) return launch_warp<1, MEASURE>(dot, ld, q_sq, c_sq, out_d, out_p, B, n, M, k, s);
  if (G <= 2) return launch_warp<2, MEASURE>(dot, ld, q_sq, c_sq, out_d, out_p, B, n, M, k, s);
  if (G <= 4) return launch_warp<4, MEASURE>(dot, ld, q_sq, c_sq, out_d, out_p, B, n, M, k, s);
  return launch_warp<8, MEASURE>(dot, ld, q_sq, c_sq, out_d, out_p, B, n, M, k, s);
}

// ---------------------------------------------------------------------------
// the block kernel: exact rows, k > 32 and unaligned rows

template <int RB>
__global__ void __launch_bounds__(kThreads)
approx_topk_kernel_block(const float* __restrict__ dot, long long ld,
                         const float* __restrict__ q_sq,
                         const float* __restrict__ c_sq, float* __restrict__ out_d,
                         int32_t* __restrict__ out_p, int n, int M, int k,
                         int measure) {
  extern __shared__ float smem[];
  float* s_d = smem;                                  // [M] winners' distances
  int* s_p = reinterpret_cast<int*>(smem + M);        // [M] positions, -1 taken
  __shared__ float w_d[2][kWarps];
  __shared__ int w_p[2][kWarps];

  const int tid = threadIdx.x;
  const long long row = blockIdx.x;
  const float* drow = dot + row * ld;
  const float a_sq = q_sq[row];

  // 1. partial reduction, RB of this thread's bins at a time
  for (int g0 = 0; g0 < M; g0 += RB * kThreads) {
    float bd[RB];
    int bp[RB];
#pragma unroll
    for (int r = 0; r < RB; ++r) {
      bd[r] = CUDART_INF_F;
      bp[r] = g0 + r * kThreads + tid;
    }
#pragma unroll kUnroll
    for (int t0 = 0; t0 < n; t0 += M) {
#pragma unroll
      for (int r = 0; r < RB; ++r) {
        const int j = g0 + r * kThreads + tid;
        const int c = t0 + j;
        if (j < M && c < n) {
          const float d = distance(__ldg(drow + c), a_sq, __ldg(c_sq + c), measure);
          if (d < bd[r]) {
            bd[r] = d;
            bp[r] = c;
          }
        }
      }
    }
#pragma unroll
    for (int r = 0; r < RB; ++r) {
      const int j = g0 + r * kThreads + tid;
      if (j < M) {
        s_d[j] = bd[r];
        s_p[j] = bp[r];
      }
    }
  }

  // the smallest of this thread's own winners (its bins only: no barrier)
  float my_d = CUDART_INF_F;
  int my_p = INT_MAX;
  for (int j = tid; j < M; j += kThreads) {
    if (before(s_d[j], s_p[j], my_d, my_p)) {
      my_d = s_d[j];
      my_p = s_p[j];
    }
  }

  // 2. aggregation: k rounds of a block argmin over the winners
  const int lane = tid & 31, warp = tid >> 5;
  for (int i = 0; i < k; ++i) {
    float d = my_d;
    int p = my_p;
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      const float od = __shfl_xor_sync(0xffffffffu, d, off);
      const int op = __shfl_xor_sync(0xffffffffu, p, off);
      if (before(od, op, d, p)) {
        d = od;
        p = op;
      }
    }
    const int buf = i & 1;
    if (lane == 0) {
      w_d[buf][warp] = d;
      w_p[buf][warp] = p;
    }
    __syncthreads();
    d = w_d[buf][0];
    p = w_p[buf][0];
#pragma unroll
    for (int w = 1; w < kWarps; ++w) {
      if (before(w_d[buf][w], w_p[buf][w], d, p)) {
        d = w_d[buf][w];
        p = w_p[buf][w];
      }
    }
    if (tid == 0) {
      out_d[row * k + i] = d;
      out_p[row * k + i] = p;
    }
    if (p == my_p) {  // positions are unique: this thread owns the bin
      s_p[p % M] = -1;
      my_d = CUDART_INF_F;
      my_p = INT_MAX;
      for (int j = tid; j < M; j += kThreads) {
        const int q = s_p[j];
        if (q >= 0 && before(s_d[j], q, my_d, my_p)) {
          my_d = s_d[j];
          my_p = q;
        }
      }
    }
  }
}

template <int RB>
int launch_block(const float* dot, long long ld, const float* q_sq,
                 const float* c_sq, float* out_d, int32_t* out_p, int B, int n,
                 int M, int k, int measure, cudaStream_t stream) {
  const int smem = 8 * M;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        approx_topk_kernel_block<RB>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  approx_topk_kernel_block<RB><<<B, kThreads, smem, stream>>>(
      dot, ld, q_sq, c_sq, out_d, out_p, n, M, k, measure);
  return static_cast<int>(cudaGetLastError());
}

bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

}  // namespace

// dot [B, n] f32, rows contiguous at row stride ld (elements); q_sq [B],
// c_sq [n] f32; out_d [B, k] f32 and out_p [B, k] i32, contiguous. M bins,
// 0 < k <= M <= n, M % 128 == 0 unless M == n. measure: 0 Euclidean, 1
// cosine. All on one device; B > 0. Reducing rows with k <= 32 whose rows
// and norms are 16-byte aligned take the warp kernel, the others the block
// kernel. Returns cudaGetLastError().
extern "C" int approx_topk_launch(const void* dot, long long ld,
                                  const void* q_sq, const void* c_sq,
                                  void* out_d, void* out_p, int B, int n,
                                  int M, int k, int measure, void* stream) {
  if (B <= 0 || n <= 0 || k <= 0 || k > M || M > n)
    return static_cast<int>(cudaErrorInvalidValue);
  const auto* d = static_cast<const float*>(dot);
  const auto* a = static_cast<const float*>(q_sq);
  const auto* b = static_cast<const float*>(c_sq);
  auto* od = static_cast<float*>(out_d);
  auto* op = static_cast<int32_t*>(out_p);
  auto s = static_cast<cudaStream_t>(stream);
  if (M < n && M % 128 == 0 && k <= 32 && aligned16(d) && ld % 4 == 0 &&
      aligned16(b))
    return measure == 0 ? dispatch_warp<0>(d, ld, a, b, od, op, B, n, M, k, s)
                        : dispatch_warp<1>(d, ld, a, b, od, op, B, n, M, k, s);
  // bins a thread holds: the fewest registers that take them in one pass
  const int per_thread = (M + kThreads - 1) / kThreads;
  if (per_thread <= 1) return launch_block<1>(d, ld, a, b, od, op, B, n, M, k, measure, s);
  if (per_thread <= 2) return launch_block<2>(d, ld, a, b, od, op, B, n, M, k, measure, s);
  if (per_thread <= 4) return launch_block<4>(d, ld, a, b, od, op, B, n, M, k, measure, s);
  return launch_block<8>(d, ld, a, b, od, op, B, n, M, k, measure, s);
}
