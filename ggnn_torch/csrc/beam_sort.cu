// The beam's sorted merge, and the fused walk's cap cut, for the walks.
//
// Replaces no Pallas kernel: it is the stable sort of `beam_insert`
// (ggnn_tpu/ops/beam.py:191, one lax.sort of the beam and the candidates
// side by side) and of the fused step's cap cut (ggnn_tpu/query/fused.py:
// 527), which XLA runs as its TPU sort. The port ran both as torch.sort
// (ggnn_torch/ops/beam.py: `beam_insert_plain`, `cap_candidates_plain`):
// PyTorch sorts a row of 129-4,096 keys as a block radix sort of a segment
// padded to 1,024 (or 128) keys, several passes over 32-bit digits, then
// gathers the payload by the sort's int64 order, with a dozen elementwise
// launches around it. For every row b:
//
//   admitted[j] = cand_i[b, j] != -1 && cand_d[b, j] < criteria[b]
//   entries     = [beam (d, i, exp) of W columns, candidates of K columns],
//                 a candidate not admitted as (+inf, -1), exp False for
//                 every candidate
//   out[b]      = the first Wout entries in torch.sort's stable order on
//                 the card: by distance as the radix sort orders f32, then
//                 by column in the concatenation
//   rows whose row_mask[b] is false keep the beam unchanged (Wout == W).
// The cap cut is the same call with no beam (W = 0) and no exp.
//
// What bounds it on Hopper: its bytes are few -- per row W * 9 read and
// written, K * 8 read: 2.3 KB at the row walk's 64 + 144, 7 us a step at
// B = 10,240 and 3.35 TB/s -- so its time is its instructions per row and
// their latency. The design keeps that work to what the order can change:
//
//   * one 64-bit key an entry: the f32's bits in the radix sort's order
//     (cub's twiddle, -0.0 taken as +0.0 as cub's digit extractor does)
//     above the column. Keys are distinct, so any correct sort of keys is
//     the stable sort, and no payload travels: a key's column finds its
//     d, i and exp when the output is written;
//   * only finite keys are ordered. A candidate not admitted and a beam
//     entry at +inf (a hole that beam_pop blanked, an empty slot) come after
//     every finite key, in column order, so they are placed by count: the
//     beam's +inf entries in their order after the finite ones, then
//     (+inf, -1, false) to the end. The beam's finite entries are already in
//     key order (every beam the walks make holds its finite entries
//     ascending; equal distances stay in column order), so a stable
//     compaction of them (a ballot) is the sorted list A. Only the admitted
//     candidates, B, are sorted: m of them, a few once a walk's criterion
//     tightens, all of a tile on a row's first steps;
//   * B is sorted in registers by a bitonic network over warp shuffles, one
//     warp a row, keys per lane following m (1, 2, 4 or 8: m <= 32, 64, 128,
//     256; the template's NMAX caps it, 2 for W + K <= 64); a B longer than
//     32 * NMAX (W + K up to 1,024) is sorted in runs of that length. A row
//     with m <= 1 sorts nothing;
//   * A and the runs of B are merged by rank, not by a second network: an
//     entry's output column is its index in its own list plus the keys below
//     it in each other list, binary searches in the row's shared memory --
//     the merge path with one entry a partition. A bitonic merge would pad
//     W to a power of two (the walks' widths include 96 and 600), reorder
//     every key and then cut; the rank merge writes each entry of the first
//     Wout columns once, straight to its column, and skips the rest;
//   * candidates are loaded four a lane, one 16-byte load of distances and
//     one of ids, where the rows are 16-byte aligned (else four scalar
//     loads in the same layout); their order in B does not matter, as B is
//     sorted. The beam is loaded one entry a lane in column order, which
//     the compaction keeps;
//   * a row's keys live in shared memory between the phases (8 bytes a key,
//     W + K keys), up to 8 rows a block under 48 KB, __syncwarp only -- no
//     block barrier. A row that keeps its state is a copy.
// The kernel launches on the caller's stream, never synchronises and
// allocates nothing, so it may be captured into a CUDA graph; the C entry
// point returns cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

using u64 = unsigned long long;  // the shuffles' 64-bit overload

constexpr int kMaxWarps = 8;            // rows of a block at most
constexpr int kSmemTarget = 48 * 1024;  // shared memory a block aims under
constexpr int kMaxKeys = 1024;          // W + K of a row at most
constexpr unsigned kFull = 0xffffffffu;
constexpr uint32_t kInfBits = 0x7f800000u;
constexpr u64 kPad = ~0ull;  // a key above every entry's

// the f32's bits as an unsigned integer in the order of cub's radix sort,
// which torch.sort runs on the card: -0.0 as +0.0 (cub's digit extractor
// maps one to the other), then the sign-magnitude twiddle
__device__ __forceinline__ u64 key_of(float d, int col) {
  uint32_t b = __float_as_uint(d);
  if (b == 0x80000000u) b = 0u;
  b ^= (b & 0x80000000u) ? 0xffffffffu : 0x80000000u;
  return (static_cast<u64>(b) << 32) | static_cast<uint32_t>(col);
}

__device__ __forceinline__ int col_of(u64 key) {
  return static_cast<int>(static_cast<uint32_t>(key));
}

// a bitonic sort of 32 * N keys held N a lane, lane l holding elements
// l * N .. l * N + N - 1: strides below N compare within a lane, the rest
// across lanes by shuffles
template <int N>
__device__ __forceinline__ void bitonic_sort(u64 (&k)[N], int lane) {
#pragma unroll
  for (int size = 2; size <= 32 * N; size <<= 1) {
#pragma unroll
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      if (stride >= N) {
        const int lanes = stride / N;
        const bool upper = (lane & lanes) != 0;
        const bool desc = ((lane * N) & size) != 0;
        const bool keep_min = upper == desc;
#pragma unroll
        for (int r = 0; r < N; ++r) {
          const u64 o = __shfl_xor_sync(kFull, k[r], lanes);
          k[r] = keep_min ? (o < k[r] ? o : k[r]) : (o > k[r] ? o : k[r]);
        }
      } else {
#pragma unroll
        for (int r = 0; r < N; ++r) {
          if ((r & stride) == 0) {
            const bool desc = ((lane * N + r) & size) != 0;
            const u64 a = k[r], b = k[r | stride];
            const bool swap = desc ? a < b : b < a;
            k[r] = swap ? b : a;
            k[r | stride] = swap ? a : b;
          }
        }
      }
    }
  }
}

// sort the n <= 32 * N keys at p in place
template <int N>
__device__ __forceinline__ void sort_keys(u64* p, int n, int lane) {
  u64 k[N];
#pragma unroll
  for (int r = 0; r < N; ++r) {
    const int e = lane * N + r;
    k[r] = e < n ? p[e] : kPad;
  }
  __syncwarp();
  bitonic_sort<N>(k, lane);
#pragma unroll
  for (int r = 0; r < N; ++r) {
    const int e = lane * N + r;
    if (e < n) p[e] = k[r];
  }
}

// the fewest keys a lane (N, 2N, ... up to NMAX) that hold n keys
template <int N, int NMAX>
__device__ __forceinline__ void sort_run(u64* p, int n, int lane) {
  if constexpr (N < NMAX) {
    if (n > 32 * N) {
      sort_run<2 * N, NMAX>(p, n, lane);
      return;
    }
  }
  sort_keys<N>(p, n, lane);
}

// keys of the sorted list a[0, n) below `key`
__device__ __forceinline__ int below(const u64* a, int n, u64 key) {
  int lo = 0, hi = n;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (a[mid] < key) {
      lo = mid + 1;
    } else {
      hi = mid;
    }
  }
  return lo;
}

// candidates j .. j + 3 of a row, (+inf, -1) past K: one 16-byte load of
// distances and one of ids where the row allows, else four scalar loads
__device__ __forceinline__ void load4(const float* dr, const int32_t* ir,
                                      int j, int K, bool vec, float (&d)[4],
                                      int (&id)[4]) {
  if (vec && j + 3 < K) {
    const float4 a = __ldg(reinterpret_cast<const float4*>(dr + j));
    const int4 b = __ldg(reinterpret_cast<const int4*>(ir + j));
    d[0] = a.x, d[1] = a.y, d[2] = a.z, d[3] = a.w;
    id[0] = b.x, id[1] = b.y, id[2] = b.z, id[3] = b.w;
    return;
  }
#pragma unroll
  for (int u = 0; u < 4; ++u) {
    d[u] = j + u < K ? __ldg(dr + j + u) : __int_as_float(kInfBits);
    id[u] = j + u < K ? __ldg(ir + j + u) : -1;
  }
}

// NMAX: keys a lane at most when sorting a run of B (2 or 8)
template <int NMAX>
__global__ void __launch_bounds__(kMaxWarps * 32) beam_sort_merge_kernel(
    const float* __restrict__ bd, long long ld_bd,
    const int32_t* __restrict__ bi, long long ld_bi,
    const uint8_t* __restrict__ bx, long long ld_bx,
    const float* __restrict__ cd, long long ld_cd,
    const int32_t* __restrict__ ci, long long ld_ci,
    const float* __restrict__ crit, const uint8_t* __restrict__ mask,
    float* __restrict__ od, int32_t* __restrict__ oi,
    uint8_t* __restrict__ ox, int B, int W, int K, int Wout, int vec) {
  extern __shared__ u64 smem[];
  constexpr int kRun = 32 * NMAX;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const long long b = static_cast<long long>(blockIdx.x) * (blockDim.x >> 5) + warp;
  if (b >= B) return;  // the whole warp: no block barrier follows
  const float* bdr = bd + b * ld_bd;
  const int32_t* bir = bi + b * ld_bi;
  const uint8_t* bxr = bx + b * ld_bx;
  const float* cdr = cd + b * ld_cd;
  const int32_t* cir = ci + b * ld_ci;
  float* odr = od + b * Wout;
  int32_t* oir = oi + b * Wout;
  uint8_t* oxr = ox == nullptr ? nullptr : ox + b * Wout;

  if (mask != nullptr && mask[b] == 0) {  // the row keeps its beam
    for (int x = lane; x < W; x += 32) {
      odr[x] = __ldg(bdr + x);
      oir[x] = __ldg(bir + x);
      oxr[x] = __ldg(bxr + x);
    }
    return;
  }
  u64* keys_a = smem + static_cast<size_t>(warp) * (W + K);
  u64* keys_b = keys_a + W;
  const float c = crit[b];
  const uint32_t lower = (1u << lane) - 1u;

  // B: the admitted candidates' keys, in any order
  int m = 0;
  for (int j0 = 0; j0 < K; j0 += 128) {
    const int j = j0 + 4 * lane;
    float d[4];
    int id[4];
    load4(cdr, cir, j, K, vec != 0, d, id);
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const bool ok = id[u] != -1 && d[u] < c;
      const uint32_t bal = __ballot_sync(kFull, ok);
      if (ok) keys_b[m + __popc(bal & lower)] = key_of(d[u], W + j + u);
      m += __popc(bal);
    }
  }
  // A: the beam's finite entries' keys, in column order
  int f = 0;
  for (int x0 = 0; x0 < W; x0 += 32) {
    const int x = x0 + lane;
    const float d = x < W ? __ldg(bdr + x) : __int_as_float(kInfBits);
    const bool fin = __float_as_uint(d) != kInfBits;
    const uint32_t bal = __ballot_sync(kFull, fin);
    if (fin) keys_a[f + __popc(bal & lower)] = key_of(d, x);
    f += __popc(bal);
  }
  __syncwarp();
  for (int r0 = 0; r0 < m; r0 += kRun) {
    const int n = m - r0 < kRun ? m - r0 : kRun;
    if (n > 1) sort_run<1, NMAX>(keys_b + r0, n, lane);
    __syncwarp();
  }

  // every finite entry to its column: its index in its own list plus the
  // keys below it in A and in each other run of B
  const int runs = (m + kRun - 1) / kRun;
  auto below_b = [&](u64 key, int own) {
    int r = 0;
    for (int q = 0; q < runs; ++q) {
      if (q != own) {
        const int n = m - q * kRun < kRun ? m - q * kRun : kRun;
        r += below(keys_b + q * kRun, n, key);
      }
    }
    return r;
  };
  const int na = f < Wout ? f : Wout;
  for (int a = lane; a < na; a += 32) {
    const u64 key = keys_a[a];
    const int r = a + below_b(key, -1);
    if (r < Wout) {
      const int x = col_of(key);
      odr[r] = __ldg(bdr + x);
      oir[r] = __ldg(bir + x);
      oxr[r] = __ldg(bxr + x);
    }
  }
  for (int y = lane; y < m; y += 32) {
    const int own = y / kRun;
    if (y - own * kRun >= Wout) continue;
    const u64 key = keys_b[y];
    const int r = y - own * kRun + below(keys_a, f, key) + below_b(key, own);
    if (r < Wout) {
      const int j = col_of(key) - W;
      odr[r] = __ldg(cdr + j);
      oir[r] = __ldg(cir + j);
      if (oxr != nullptr) oxr[r] = 0;
    }
  }

  // then the beam's +inf entries in column order, then (+inf, -1, false)
  int r0 = f + m;
  for (int x0 = 0; x0 < W && r0 < Wout; x0 += 32) {
    const int x = x0 + lane;
    const bool hole = x < W && __float_as_uint(__ldg(bdr + x)) == kInfBits;
    const uint32_t bal = __ballot_sync(kFull, hole);
    const int r = r0 + __popc(bal & lower);
    if (hole && r < Wout) {
      odr[r] = __int_as_float(kInfBits);
      oir[r] = __ldg(bir + x);
      oxr[r] = __ldg(bxr + x);
    }
    r0 += __popc(bal);
  }
  for (int r = r0 + lane; r < Wout; r += 32) {
    odr[r] = __int_as_float(kInfBits);
    oir[r] = -1;
    if (oxr != nullptr) oxr[r] = 0;
  }
}

// rows (warps) of a block: kMaxWarps, halved while the block's keys exceed
// kSmemTarget (ggnn_torch/ops/beam_sort.py: rows_per_block)
int rows_per_block(int n) {
  int r = kMaxWarps;
  while (r > 1 && r * 8LL * n > kSmemTarget) r /= 2;
  return r;
}

template <int NMAX>
int launch_keys(const void* bd, long long ld_bd, const void* bi,
                long long ld_bi, const void* bx, long long ld_bx,
                const void* cd, long long ld_cd, const void* ci,
                long long ld_ci, const void* crit, const void* mask, void* od,
                void* oi, void* ox, int B, int W, int K, int Wout, int vec,
                void* stream) {
  const int rows = rows_per_block(W + K);
  const size_t smem = static_cast<size_t>(rows) * 8 * (W + K);
  const int blocks = (B + rows - 1) / rows;
  beam_sort_merge_kernel<NMAX><<<blocks, rows * 32, smem,
                                 static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(bd), ld_bd, static_cast<const int32_t*>(bi),
      ld_bi, static_cast<const uint8_t*>(bx), ld_bx,
      static_cast<const float*>(cd), ld_cd, static_cast<const int32_t*>(ci),
      ld_ci, static_cast<const float*>(crit),
      static_cast<const uint8_t*>(mask), static_cast<float*>(od),
      static_cast<int32_t*>(oi), static_cast<uint8_t*>(ox), B, W, K, Wout,
      vec);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// beam d [B, W] f32, i [B, W] i32, exp [B, W] bool (all null with W = 0),
// cand_d [B, K] f32, cand_i [B, K] i32, each row contiguous at the given
// row stride (elements; 0 repeats one row); criteria [B] f32 and row_mask
// [B] bool (or null) contiguous; out d [B, Wout] f32, i [B, Wout] i32 and
// exp [B, Wout] bool (null with W = 0), contiguous. vec: the candidates'
// rows are 16-byte aligned. All on one device; B > 0, 0 < W + K <= 1,024,
// Wout <= W + K, Wout == W where row_mask is given.
extern "C" int beam_sort_merge_launch(const void* bd, long long ld_bd,
                                      const void* bi, long long ld_bi,
                                      const void* bx, long long ld_bx,
                                      const void* cd, long long ld_cd,
                                      const void* ci, long long ld_ci,
                                      const void* crit, const void* mask,
                                      void* od, void* oi, void* ox, int B,
                                      int W, int K, int Wout, int vec,
                                      void* stream) {
  const int n = W + K;
  if (n <= 64) {
    return launch_keys<2>(bd, ld_bd, bi, ld_bi, bx, ld_bx, cd, ld_cd, ci,
                          ld_ci, crit, mask, od, oi, ox, B, W, K, Wout, vec,
                          stream);
  }
  if (n <= kMaxKeys) {
    return launch_keys<8>(bd, ld_bd, bi, ld_bi, bx, ld_bx, cd, ld_cd, ci,
                          ld_ci, crit, mask, od, oi, ox, B, W, K, Wout, vec,
                          stream);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
