// Fused gather + distance of the walks: each row's candidate base rows read
// once, dotted with the row's query vector(s) and finished into distances.
//
// Replaces the JAX package's gather feeding an einsum at Precision.HIGHEST,
// which XLA fuses into one computation inside the walks' lax.while_loop (not
// a Pallas kernel): ggnn_tpu/ops/traverse.py:33 (gather_dists: the row
// walk's step, seed_beam, the merges' own distances), ggnn_tpu/build/sym.py:55
// (_pair_dists with the gather at :176, the sym walk's distances to the node
// and to the half-way point) and ggnn_tpu/query/fused.py:782 (the fused
// query's exact re-rank). The port's definition, and its plain version, are
// in ggnn_torch/ops/gather_dist.py. For row b, query j < Q and candidate k:
//
//   t         = translation[max(ids[b, k], 0)]   (max(ids[b, k], 0) without one)
//   out_ids   = t                                 (where out_ids is not null)
//   out_d     = finish(sum_d qs[b, j, d] * f32(base[t, d]), q_sq[b, j], base_sq[t])
//
// finish's f32 operations are done in its order, each rounded (__fadd_rn /
// __fmul_rn / __fsub_rn, so no FMA contraction), as csrc/approx_topk.cu does:
// Euclidean max((q_sq + c_sq) - 2 * dot, 0); cosine |1 - dot * rsqrtf(q_sq *
// c_sq)| (1 where the product of the norms is not positive). The dot is a sum
// in a fixed order (each lane's fmaf over its dims in order, then a butterfly
// of shuffles), not cuBLAS's: the two differ by the rounding of a sum of D
// products, |d - d_plain| <= D * 2^-23 * (q_sq + c_sq) (cosine D * 2^-22).
//
// What bounds it on Hopper: its bytes -- one D-wide base row per candidate
// (512 B at D = 128 f32); the ids, norms, queries and outputs are a few bytes
// a candidate. It does 2 flops per 4 bytes read (f32), far below the card's
// ridge, so no tensor core: the plain route's [B, K, D] gather written to
// and read back from device memory is what this kernel removes.
//
// Design (the simple kernel; wide copies and rings are later work):
//   * a warp per row b, 8 rows a block. The lanes first take 32 candidates
//     at a time, one each: its id, its translation, its norm and the base id
//     written out -- coalesced, and off the rows' critical path;
//   * lane l covers dims 4l .. 4l + 3 of every 128-wide slab of the row, so a
//     warp reads a D = 128 f32 row as 32 16-byte loads (u8: 4-byte loads,
//     converted in registers). Rows whose stride or start is not aligned, or
//     D % 4 != 0, take the scalar path: lane l covers dims l + 32e;
//   * the queries' values of the lane's dims stay in registers (NS slabs a
//     pass; more dims take passes that reload them);
//   * kUnroll candidates' rows are loaded before any is summed, so each lane
//     keeps kUnroll loads in flight; their base ids come from the owning lane
//     by a shuffle;
//   * the Q sums of each candidate are reduced over the warp by xor
//     shuffles (every lane ends with the same bits), kept by the candidate's
//     lane, finished there and stored coalesced.
// Nothing is allocated: a launch is captured into the walks' CUDA graphs.
// An id past the layer (or the translation), or a base id past the base,
// fails a device assert, as the plain route's indexing does: the launch's
// stream then reports cudaErrorAssert. Row 0 is read in its place, so no
// read leaves the tensors, and the assert waits for the warp's last store
// (an assert at the id itself made the row and sym steps 4-5% slower on an
// H100, gather_bench.py).

#undef NDEBUG
#include <cassert>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kWarps = 8;               // rows (a warp each) a block
constexpr int kThreads = kWarps * 32;
constexpr int kUnroll = 4;              // candidates' rows in flight a lane
constexpr int kSlab = 128;              // dims a warp covers, 4 a lane

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

// dim of the lane's element e (0..3) of slab s: 4 consecutive dims a lane
// (kVec) or dims 32 apart
template <bool kVec>
__device__ __forceinline__ int dim_of(int s, int lane, int e) {
  return kVec ? s * kSlab + 4 * lane + e : s * kSlab + lane + 32 * e;
}

// the lane's 4 elements of slab s of a base row, as f32; 0 past D
template <bool kU8, bool kVec>
__device__ __forceinline__ void load_row(const void* row, int s, int lane, int D,
                                         float x[4]) {
  if (kVec) {
    const int d0 = dim_of<true>(s, lane, 0);
    if (d0 < D) {  // D % 4 == 0: all 4 dims in
      if (kU8) {
        const uint32_t w = __ldg(reinterpret_cast<const uint32_t*>(
            static_cast<const uint8_t*>(row) + d0));
#pragma unroll
        for (int e = 0; e < 4; ++e) x[e] = __uint2float_rn((w >> (8 * e)) & 0xffu);
      } else {
        const float4 v = __ldg(reinterpret_cast<const float4*>(
            static_cast<const float*>(row) + d0));
        x[0] = v.x; x[1] = v.y; x[2] = v.z; x[3] = v.w;
      }
    } else {
#pragma unroll
      for (int e = 0; e < 4; ++e) x[e] = 0.0f;
    }
    return;
  }
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const int d = dim_of<false>(s, lane, e);
    x[e] = d >= D ? 0.0f
         : kU8 ? __uint2float_rn(__ldg(static_cast<const uint8_t*>(row) + d))
               : __ldg(static_cast<const float*>(row) + d);
  }
}

// the lane's query values of pass p (NS slabs), 0 past D
template <int Q, int NS, bool kVec>
__device__ __forceinline__ void load_queries(const float* q, long long q_sj,
                                             int p, int lane, int D,
                                             float (&qr)[Q][NS][4]) {
#pragma unroll
  for (int j = 0; j < Q; ++j)
#pragma unroll
    for (int s = 0; s < NS; ++s)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int d = dim_of<kVec>(p * NS + s, lane, e);
        qr[j][s][e] = d < D ? __ldg(q + j * q_sj + d) : 0.0f;
      }
}

// qs [B, Q, D] f32 at strides (q_sb, q_sj, 1); q_sq [B, Q] f32; ids [B, K]
// i32 below n_ids (N_l, or N without a translation); trans [N_l] i32 or
// null; base [N, D] f32 or u8 at row stride ld (elements), N = n_base;
// base_sq [N] f32; out_d [B, Q, K] f32; out_ids [B, K] i64 or null.
template <int Q, int NS, bool kU8, bool kVec>
__global__ void __launch_bounds__(kThreads)
gather_dist_kernel(const float* __restrict__ qs, long long q_sb, long long q_sj,
                   const float* __restrict__ q_sq,
                   const int32_t* __restrict__ ids,
                   const int32_t* __restrict__ trans,
                   const void* __restrict__ base, long long ld,
                   const float* __restrict__ base_sq,
                   float* __restrict__ out_d, int64_t* __restrict__ out_ids,
                   int B, int K, int D, int n_ids, int n_base, int measure) {
  const int lane = threadIdx.x & 31;
  const int b = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (b >= B) return;  // the whole warp: no shuffle is left waiting
  const int passes = (D + NS * kSlab - 1) / (NS * kSlab);
  const float* q = qs + b * q_sb;
  const size_t elem = kU8 ? 1 : 4;
  const char* rows = static_cast<const char*>(base);

  float qr[Q][NS][4];
  load_queries<Q, NS, kVec>(q, q_sj, 0, lane, D, qr);
  float qn[Q];
#pragma unroll
  for (int j = 0; j < Q; ++j) qn[j] = __ldg(q_sq + static_cast<long long>(b) * Q + j);

  bool bad = false;
  for (int k0 = 0; k0 < K; k0 += 32) {
    const int nk = min(32, K - k0);
    const long long bk = static_cast<long long>(b) * K + k0 + lane;
    // the lane's candidate: id, base id, norm
    int t = 0;
    float c_sq = 0.0f;
    if (lane < nk) {
      int id = max(__ldg(ids + bk), 0);  // out of range: row 0, then assert
      bad |= id >= n_ids;
      id = id < n_ids ? id : 0;
      t = trans != nullptr ? __ldg(trans + id) : id;
      bad |= t < 0 || t >= n_base;
      t = t >= 0 && t < n_base ? t : 0;
      c_sq = __ldg(base_sq + t);
      if (out_ids != nullptr) out_ids[bk] = t;
    }
    float mine[Q];
#pragma unroll
    for (int j = 0; j < Q; ++j) mine[j] = 0.0f;
    for (int i = 0; i < nk; i += kUnroll) {
      const void* row[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u)  // i + u <= 31: a lane of the warp
        row[u] = rows + static_cast<size_t>(__shfl_sync(0xffffffffu, t, i + u)) *
                            static_cast<size_t>(ld) * elem;
      float acc[kUnroll][Q];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u)
#pragma unroll
        for (int j = 0; j < Q; ++j) acc[u][j] = 0.0f;
      for (int p = 0; p < passes; ++p) {
        if (passes > 1) load_queries<Q, NS, kVec>(q, q_sj, p, lane, D, qr);
#pragma unroll
        for (int s = 0; s < NS; ++s) {
          float x[kUnroll][4];
#pragma unroll
          for (int u = 0; u < kUnroll; ++u) {
            if (i + u < nk) {
              load_row<kU8, kVec>(row[u], p * NS + s, lane, D, x[u]);
            } else {
#pragma unroll
              for (int e = 0; e < 4; ++e) x[u][e] = 0.0f;
            }
          }
#pragma unroll
          for (int u = 0; u < kUnroll; ++u)
#pragma unroll
            for (int j = 0; j < Q; ++j)
#pragma unroll
              for (int e = 0; e < 4; ++e)
                acc[u][j] = fmaf(qr[j][s][e], x[u][e], acc[u][j]);
        }
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u)
#pragma unroll
        for (int j = 0; j < Q; ++j) {
          float v = acc[u][j];
#pragma unroll
          for (int off = 16; off > 0; off >>= 1)
            v += __shfl_xor_sync(0xffffffffu, v, off);
          if (lane == i + u) mine[j] = v;
        }
    }
    if (lane < nk) {
#pragma unroll
      for (int j = 0; j < Q; ++j)
        out_d[(static_cast<long long>(b) * Q + j) * K + k0 + lane] =
            distance(mine[j], qn[j], c_sq, measure);
    }
  }
  assert(!bad);
}

template <int Q, int NS, bool kU8, bool kVec>
int launch(const float* qs, long long q_sb, long long q_sj, const float* q_sq,
           const int32_t* ids, const int32_t* trans, const void* base,
           long long ld, const float* base_sq, float* out_d, int64_t* out_ids,
           int B, int K, int D, int n_ids, int n_base, int measure,
           cudaStream_t s) {
  const int blocks = (B + kWarps - 1) / kWarps;
  gather_dist_kernel<Q, NS, kU8, kVec><<<blocks, kThreads, 0, s>>>(
      qs, q_sb, q_sj, q_sq, ids, trans, base, ld, base_sq, out_d, out_ids, B,
      K, D, n_ids, n_base, measure);
  return static_cast<int>(cudaGetLastError());
}

template <int Q, bool kU8, bool kVec>
int dispatch_ns(const float* qs, long long q_sb, long long q_sj,
                const float* q_sq, const int32_t* ids, const int32_t* trans,
                const void* base, long long ld, const float* base_sq,
                float* out_d, int64_t* out_ids, int B, int K, int D,
                int n_ids, int n_base, int measure, cudaStream_t s) {
  // one slab in registers up to D = 128 (the repository's data), else 4 a
  // pass (512 dims), the rest in passes
  if (D <= kSlab)
    return launch<Q, 1, kU8, kVec>(qs, q_sb, q_sj, q_sq, ids, trans, base, ld,
                                   base_sq, out_d, out_ids, B, K, D, n_ids,
                                   n_base, measure, s);
  return launch<Q, 4, kU8, kVec>(qs, q_sb, q_sj, q_sq, ids, trans, base, ld,
                                 base_sq, out_d, out_ids, B, K, D, n_ids,
                                 n_base, measure, s);
}

template <int Q>
int dispatch(const float* qs, long long q_sb, long long q_sj, const float* q_sq,
             const int32_t* ids, const int32_t* trans, const void* base,
             long long ld, bool u8, bool vec, const float* base_sq,
             float* out_d, int64_t* out_ids, int B, int K, int D, int n_ids,
             int n_base, int measure, cudaStream_t s) {
#define GATHER_DIST_ARGS                                                     \
  qs, q_sb, q_sj, q_sq, ids, trans, base, ld, base_sq, out_d, out_ids, B, K, \
      D, n_ids, n_base, measure, s
  if (u8)
    return vec ? dispatch_ns<Q, true, true>(GATHER_DIST_ARGS)
               : dispatch_ns<Q, true, false>(GATHER_DIST_ARGS);
  return vec ? dispatch_ns<Q, false, true>(GATHER_DIST_ARGS)
             : dispatch_ns<Q, false, false>(GATHER_DIST_ARGS);
#undef GATHER_DIST_ARGS
}

}  // namespace

// See the kernel. qs rows at strides (q_sb, q_sj), elements contiguous;
// q_sq [B, Q], ids [B, K], base_sq and out_* contiguous; trans and out_ids
// may be null; n_ids is trans's length (the base's rows without it), n_base
// the base's rows; u8: base is uint8, else float32. Q is 1 or 2; B, K > 0.
// Rows take 16-byte (f32) or 4-byte (u8) loads where D % 4 == 0 and the
// base's start and row stride are aligned to them, else 4-byte / 1-byte
// loads. Returns cudaGetLastError().
extern "C" int gather_dist_launch(const void* qs, long long q_sb, long long q_sj,
                                  const void* q_sq, const void* ids,
                                  const void* trans, const void* base,
                                  long long ld, int u8, const void* base_sq,
                                  void* out_d, void* out_ids, int B, int Q,
                                  int K, int D, int n_ids, int n_base,
                                  int measure, void* stream) {
  if (B <= 0 || K <= 0 || D <= 0 || n_ids <= 0 || n_base <= 0 ||
      (Q != 1 && Q != 2))
    return static_cast<int>(cudaErrorInvalidValue);
  const auto* q = static_cast<const float*>(qs);
  const auto* qn = static_cast<const float*>(q_sq);
  const auto* i = static_cast<const int32_t*>(ids);
  const auto* tr = static_cast<const int32_t*>(trans);
  const auto* bn = static_cast<const float*>(base_sq);
  auto* od = static_cast<float*>(out_d);
  auto* oi = static_cast<int64_t*>(out_ids);
  auto s = static_cast<cudaStream_t>(stream);
  const uintptr_t align = u8 ? 4 : 16;
  const bool vec = D % 4 == 0 && ld % 4 == 0 &&
                   reinterpret_cast<uintptr_t>(base) % align == 0;
  if (Q == 1)
    return dispatch<1>(q, q_sb, q_sj, qn, i, tr, base, ld, u8 != 0, vec, bn, od,
                       oi, B, K, D, n_ids, n_base, measure, s);
  return dispatch<2>(q, q_sb, q_sj, qn, i, tr, base, ld, u8 != 0, vec, bn, od,
                     oi, B, K, D, n_ids, n_base, measure, s);
}
