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
// element. The design streams each row once and keeps everything else on
// chip:
//
//   * one block of 128 threads per row. Thread l owns bins l, l + 128, ...
//     (M % 128 == 0 wherever M < n, so a bin's elements sit in the same
//     lane of every 128-lane tile, and a warp's loads are 128 contiguous
//     bytes). It holds the running minima of up to RB of its bins in
//     registers (RB = 1, 2, 4 or 8, a template argument, from M / 128) and
//     walks the row tile by tile: tile t's loads for those bins, unrolled
//     by 4 tiles so that several loads are in flight. A first minimum is
//     replaced only by a smaller distance, so equal distances keep their
//     lowest position; a NaN is never taken, so it counts as +inf, the
//     bin's start value at its first position (the plain version's rule).
//     More than 8 bins a thread (M > 1024: an exact row) take passes of 8,
//     each reading its own columns once;
//   * the bin winners go to shared memory, M distances and M positions
//     (8 * M bytes; above 48 KB opted in, and a launch fails where the
//     device has less). Each thread writes and reads only its own bins, so
//     no barrier is needed before the aggregation; each thread keeps the
//     smallest of its own winners;
//   * the aggregation takes k rounds: a warp argmin by shuffles, the four
//     warps' results through shared memory (double buffered: one barrier a
//     round), the block's winner written by thread 0, and the thread that
//     owns its bin marks it taken and rescans its own winners. The output
//     comes out in (distance, position) order. k rounds of a barrier are
//     small next to the row's 120 KB at the seeding's k <= 32.
//
// Later work (not needed for a correct first kernel): TMA loads of the
// row, and fusing this into the gemm's epilogue so that the matrix never
// reaches device memory.

#include <climits>
#include <cstdint>

#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kUnroll = 4;

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

template <int RB>
__global__ void __launch_bounds__(kThreads)
approx_topk_kernel(const float* __restrict__ dot, long long ld,
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
int launch(const float* dot, long long ld, const float* q_sq, const float* c_sq,
           float* out_d, int32_t* out_p, int B, int n, int M, int k,
           int measure, cudaStream_t stream) {
  const int smem = 8 * M;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        approx_topk_kernel<RB>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  approx_topk_kernel<RB><<<B, kThreads, smem, stream>>>(
      dot, ld, q_sq, c_sq, out_d, out_p, n, M, k, measure);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// dot [B, n] f32, rows contiguous at row stride ld (elements); q_sq [B],
// c_sq [n] f32; out_d [B, k] f32 and out_p [B, k] i32, contiguous. M bins,
// 0 < k <= M <= n, M % 128 == 0 unless M == n. measure: 0 Euclidean, 1
// cosine. All on one device; B > 0. Returns cudaGetLastError().
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
  // bins a thread holds: the fewest registers that take them in one pass
  const int per_thread = (M + kThreads - 1) / kThreads;
  if (per_thread <= 1) return launch<1>(d, ld, a, b, od, op, B, n, M, k, measure, s);
  if (per_thread <= 2) return launch<2>(d, ld, a, b, od, op, B, n, M, k, measure, s);
  if (per_thread <= 4) return launch<4>(d, ld, a, b, od, op, B, n, M, k, measure, s);
  return launch<8>(d, ld, a, b, od, op, B, n, M, k, measure, s);
}
