// Beam id dedup, and the dedup fused with the compaction, for the walks.
//
// Replaces no Pallas kernel: it is the XLA fusion of the JAX package's
// `beam_dedup_mask` (ggnn_tpu/ops/beam.py:112-138) and, fused with it, of
// `beam_compact_candidates` (:141-161). On the TPU, XLA fuses the
// [B, K, K] and [B, K, W+V] id compares and their `any` into one reduction
// loop; PyTorch's eager plain version (ggnn_torch/ops/beam.py:
// `beam_dedup_mask_plain`, `beam_compact_candidates_plain`) writes both
// bool tensors to device memory and reads them back, then sorts, gathers
// and sums to compact. For every row b and candidate column j:
//
//   ok[b, j]  = cand[b, j] != -1 && valid[b, j] (when given)
//               && cand[b, j] != cand[b, i] for every i < j
//               && cand[b, j] is in neither beam_i[b, :W] nor vis[b, :V]
//   packed[b] = the cand[b, j] with ok[b, j] in column order, the first
//               min(cap, K) of them, padded with -1
//
// What bounds it on Hopper: its bytes -- per row K*4 + K (valid) + (W+V)*4
// read and K (+ min(cap, K)*4) written, 11 us a walk step at B = 8192,
// K = 384, W+V = 256 at 3.35 TB/s. The work is O(K + W + V) a row: each
// candidate is inserted once into a hash table and each seen id probes it
// once, a few shared-memory operations per id. Measured on the H100, what
// stands between the kernel and its bytes is those operations -- their
// bank conflicts, their latency where a warp waits for its slowest lane's
// probe, the instructions of a narrow row -- more than its one trip to
// device memory, so the design keeps the shared-memory work per id small
// and in flight together:
//
//   * one warp per row, kMaxWarps rows per block at most (as many as fit in
//     48 KB of shared memory), synchronised with __syncwarp only -- no block
//     barrier, so small-K shapes fill the SM's warp slots rather than its
//     block slots;
//   * a per-warp open-addressing table in shared memory, sized by K:
//     2^L slots, 2^L >= max(32, 2K), an int32 id (-1 = empty) and an int32
//     column each, in two arrays (a probe reads 32-bit ids, all 32 banks).
//     Where the seen ids outnumber 8K (k_query 6000's beam), their probes
//     take most of the time and the table doubles (>= 4K: a quarter full
//     at most, fewer rounds); it never grows with W + V beyond that.
//     Fibonacci hashing, linear probing. Only the ids are cleared;
//   * probes run in rounds: a lane's first slots for all of its ids at
//     once, then, while any lane of the warp has a probe that met neither
//     its id nor an empty slot, the next slot of every such probe -- one
//     shared-memory latency a round, not one a slot for each id in turn
//     (as a loop per id would cost, with the warp waiting for its longest);
//   * loads first: a lane's candidates and `valid` bits (C chunks of 32
//     columns in registers; C = 1, 3 or 12 by K, a template argument) and
//     the first batch of seen ids are loaded before the table is cleared,
//     so the walks' shapes make one trip to memory. A row none of whose
//     candidates is both an id and valid keeps none: it writes its outputs
//     and stops there (a walk's converged and dead rows, most of a sym
//     walk's late steps);
//   * a narrow row (K <= 32, C = 1: the fused walks' steps) is a candidate
//     a lane: its repeats are the lanes of equal ids (__match_any_sync),
//     only first occurrences enter the table, valid or not, and a slot's
//     column says seen or not; its seen ids come two a lane by scalar
//     loads. It is a few dozen instructions a lane;
//   * a wide row, phase 1: every candidate with c != -1, valid or not, is
//     inserted, so that an invalid first occurrence still drops its later
//     copies, as the plain rule says: atomicCAS on the id; the lane that
//     claimed a slot stores its column, and after a __syncwarp the repeats
//     take the atomicMin. A lane keeps each candidate's slot for phase 3;
//   * phase 2: the seen ids beam_i[b, :W] then vis[b, :V] are streamed from
//     device memory once, never staged: lane-strided 16-byte loads from each
//     segment's first 16-byte boundary (up to 3 ids at either end come
//     singly), kSeen of them a lane per batch, the next batch in flight
//     while one is probed; each id other than -1 probes the table and marks
//     its slot seen (column -1). Shared memory does not grow with W + V;
//   * phase 3: ok[j] = c != -1 && valid[j] && column(slot(c)) == j, the
//     slot kept from phase 1 (found again only where K takes passes). The
//     compaction ballots each 32-column chunk and writes a survivor at the
//     running total of the warp's earlier chunks (a register) plus the
//     popcount of the ballot below its lane: the order of a stable sort on
//     the drop flag, with no serial prefix. The tail of packed[b, :min(cap,
//     K)] is padded with -1. K above 384 runs in passes of 384 columns,
//     loaded again for phase 3;
//   * inputs may have padded rows (a row stride per input; elements of a
//     row contiguous). Shared memory above 48 KB (one row of K > 2048) is
//     asked for with cudaFuncAttributeMaxDynamicSharedMemorySize, up to the
//     device's opt-in limit; above it the launch returns
//     cudaErrorInvalidValue.
// The kernel launches on the caller's stream, never synchronises and
// allocates nothing, so it may be captured into a CUDA graph; each C entry
// point returns cudaGetLastError().

#include <climits>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxWarps = 8;             // rows of a block at most
constexpr int kSmemTarget = 48 * 1024;   // shared memory a block aims under
constexpr int kSeen = 2;                 // 16-byte seen loads a lane holds
                                         // per batch: 4 * 32 * kSeen ids
constexpr int kPassChunks = 12;          // the widest pass: 32 * 12 columns

__device__ __forceinline__ uint32_t slot_of(int id, int shift) {
  return (static_cast<uint32_t>(id) * 0x9E3779B1u) >> shift;
}

// one row's seen list (beam, then ring) as 16-byte groups, each segment
// from its first 16-byte boundary on; the up to 3 ids before that boundary
// and after the last whole group of a segment are its edge ids
struct Seen {
  const int4* beam4;
  const int4* ring4;
  int nbeam4, n4;  // groups of the beam, of both

  __device__ __forceinline__ int4 group(int i) const {
    if (i < nbeam4) return __ldg(beam4 + i);
    if (i < n4) return __ldg(ring4 + (i - nbeam4));
    return make_int4(-1, -1, -1, -1);
  }
};

// a segment's first id on a 16-byte boundary, its whole groups and its
// edge ids; lane e < its edge count loads edge id e (else -1)
__device__ __forceinline__ int split(const int32_t* p, int n, int e,
                                     const int4** p4, int* n4) {
  const int to_edge =
      static_cast<int>(((16 - (reinterpret_cast<uintptr_t>(p) & 15)) & 15) >> 2);
  const int head = n < to_edge ? n : to_edge;
  *p4 = reinterpret_cast<const int4*>(p + head);
  *n4 = (n - head) >> 2;
  const int nedge = n - 4 * *n4;
  if (e < 0 || e >= nedge) return -1;
  return __ldg(p + (e < head ? e : e + 4 * *n4));
}

// probe the table for N ids at once, in rounds: the first slot of every
// id, then, while any lane has a probe that met neither its id nor an
// empty slot, the next slot of each such probe -- all of a round's reads
// issued back to back, so a round costs one shared-memory latency however
// many probes it holds (a probe per id and lane in a loop of its own would
// pay one per slot, and the warp would wait for its longest). The whole
// warp calls it. s[e]: the slot where id e's probe ended; returns the
// bits e whose id was found (never an id of -1)
template <int N>
__device__ __forceinline__ uint32_t find_all(const int* keys, uint32_t mask,
                                             int shift, const int (&id)[N],
                                             uint32_t (&s)[N]) {
  int k[N];
#pragma unroll
  for (int e = 0; e < N; ++e) {
    s[e] = slot_of(id[e], shift);
    k[e] = keys[s[e]];
  }
  uint32_t open = 0;
#pragma unroll
  for (int e = 0; e < N; ++e) {
    if (id[e] != -1 && k[e] != id[e] && k[e] != -1) open |= 1u << e;
  }
  while (__any_sync(0xffffffffu, open != 0)) {
#pragma unroll
    for (int e = 0; e < N; ++e) {
      if ((open >> e) & 1u) {
        s[e] = (s[e] + 1) & mask;
        k[e] = keys[s[e]];
      }
    }
#pragma unroll
    for (int e = 0; e < N; ++e) {
      if (k[e] == id[e] || k[e] == -1) open &= ~(1u << e);
    }
  }
  uint32_t found = 0;
#pragma unroll
  for (int e = 0; e < N; ++e) {
    if (id[e] != -1 && k[e] == id[e]) found |= 1u << e;
  }
  return found;
}

// mark the slots of these ids seen (column -1)
template <int N>
__device__ __forceinline__ void see(const int* keys, int* cols, uint32_t mask,
                                    int shift, const int (&id)[N]) {
  uint32_t s[N];
  const uint32_t found = find_all(keys, mask, shift, id, s);
#pragma unroll
  for (int e = 0; e < N; ++e) {
    if ((found >> e) & 1u) cols[s[e]] = -1;
  }
}

__device__ __forceinline__ void load_batch(const Seen& seen, int i0, int lane,
                                           int4 (&g)[kSeen]) {
#pragma unroll
  for (int u = 0; u < kSeen; ++u) g[u] = seen.group(i0 + 32 * u + lane);
}

// the ids of a batch, probed together
__device__ __forceinline__ void see_batch(const int* keys, int* cols,
                                          uint32_t mask, int shift,
                                          const int4 (&g)[kSeen]) {
  int id[4 * kSeen];
#pragma unroll
  for (int u = 0; u < kSeen; ++u) {
    id[4 * u] = g[u].x;
    id[4 * u + 1] = g[u].y;
    id[4 * u + 2] = g[u].z;
    id[4 * u + 3] = g[u].w;
  }
  see(keys, cols, mask, shift, id);
}

// one pass of candidates: columns p0 + 32 n + lane for n < C, -1 past K;
// bit n of *vmask set where that column passes `valid`
template <int C>
__device__ __forceinline__ void load_pass(const int32_t* crow,
                                          const uint8_t* vrow, int K, int p0,
                                          int lane, int (&c)[C],
                                          uint32_t* vmask) {
  uint32_t m = 0;
#pragma unroll
  for (int n = 0; n < C; ++n) {
    const int j = p0 + 32 * n + lane;
    c[n] = j < K ? __ldg(crow + j) : -1;
    if (j < K && (vrow == nullptr || __ldg(vrow + j) != 0)) m |= 1u << n;
  }
  *vmask = m;
}

// insert one pass's candidates: the ids by atomicCAS in rounds (as
// find_all), then each id's first column -- the lane that claimed a slot
// stores its column, and after it the repeats take the minimum. s[n]: the
// slot of candidate n
template <int C>
__device__ __forceinline__ void insert_pass(int* keys, int* cols,
                                            uint32_t mask, int shift,
                                            const int (&c)[C], int p0,
                                            int lane, uint32_t (&s)[C]) {
  int k[C];
  uint32_t open = 0;
#pragma unroll
  for (int n = 0; n < C; ++n) {
    s[n] = slot_of(c[n], shift);
    k[n] = c[n] == -1 ? -1 : atomicCAS(keys + s[n], -1, c[n]);
    if (k[n] != -1 && k[n] != c[n]) open |= 1u << n;
  }
  while (__any_sync(0xffffffffu, open != 0)) {
#pragma unroll
    for (int n = 0; n < C; ++n) {
      if ((open >> n) & 1u) {
        s[n] = (s[n] + 1) & mask;
        k[n] = atomicCAS(keys + s[n], -1, c[n]);
      }
    }
#pragma unroll
    for (int n = 0; n < C; ++n) {
      if (k[n] == -1 || k[n] == c[n]) open &= ~(1u << n);
    }
  }
#pragma unroll
  for (int n = 0; n < C; ++n) {
    if (c[n] != -1 && k[n] == -1) cols[s[n]] = p0 + 32 * n + lane;
  }
  __syncwarp();
#pragma unroll
  for (int n = 0; n < C; ++n) {
    if (c[n] != -1 && k[n] == c[n]) atomicMin(cols + s[n], p0 + 32 * n + lane);
  }
}

// a row of K <= 32 columns, a candidate a lane: its repeats are the lanes
// of equal ids (__match_any_sync), so only first occurrences -- one a id --
// enter the table, and a lane's slot is marked seen or not; the seen ids
// come two a lane per batch by scalar loads (coalesced), with no
// alignment to find: a narrow row's time is its instructions
template <bool COMPACT>
__device__ __forceinline__ void narrow_row(
    int* keys, int* cols, uint32_t mask, int shift, int lane,
    const int32_t* crow, const uint8_t* vrow, const int32_t* brow,
    const int32_t* rrow, int K, int W, int V, uint8_t* ok, int32_t* packed,
    long long b, int cap) {
  const int c = lane < K ? __ldg(crow + lane) : -1;
  const bool v = lane < K && (vrow == nullptr || __ldg(vrow + lane) != 0);
  const int S = W + V;
  int id[2];
  auto load = [&](int i0) {
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      const int i = i0 + 32 * u + lane;
      id[u] = i < W ? __ldg(brow + i) : i < S ? __ldg(rrow + (i - W)) : -1;
    }
  };
  load(0);
  const int capK = cap < K ? cap : K;
  int32_t* prow = COMPACT ? packed + b * capK : nullptr;
  if (!__any_sync(0xffffffffu, c != -1 && v)) {  // nothing to keep
    if (lane < K) ok[b * K + lane] = 0;
    if (COMPACT) {
      for (int p = lane; p < capK; p += 32) prow[p] = -1;
    }
    return;
  }
  int4* keys4 = reinterpret_cast<int4*>(keys);
  for (int i = lane; i <= static_cast<int>(mask >> 2); i += 32) {
    keys4[i] = make_int4(-1, -1, -1, -1);
  }
  const uint32_t below = (1u << lane) - 1u;
  const bool first = (__match_any_sync(0xffffffffu, c) & below) == 0;
  __syncwarp();

  // no two lanes insert one id: a slot taken is another id's
  uint32_t s = slot_of(c, shift);
  bool open = c != -1 && first && atomicCAS(keys + s, -1, c) != -1;
  while (__any_sync(0xffffffffu, open)) {
    if (open) {
      s = (s + 1) & mask;
      open = atomicCAS(keys + s, -1, c) != -1;
    }
  }
  if (c != -1 && first) cols[s] = 0;
  __syncwarp();

  for (int i0 = 0; i0 < S; i0 += 64) {
    if (i0 > 0) load(i0);
    see(keys, cols, mask, shift, id);
  }
  __syncwarp();

  const bool keep = c != -1 && v && first && cols[s] == 0;
  if (lane < K) ok[b * K + lane] = keep;
  if (COMPACT) {
    const uint32_t m = __ballot_sync(0xffffffffu, keep);
    const int pos = __popc(m & below);
    if (keep && pos < capK) prow[pos] = c;
    for (int p = __popc(m) + lane; p < capK; p += 32) prow[p] = -1;
  }
}

// a row of any K, in passes of 32 * C columns, C chunks of 32 a lane holds
// in registers; the seen ids by 16-byte loads, kSeen a lane per batch with
// the next batch in flight
template <bool COMPACT, int C>
__device__ __forceinline__ void wide_row(
    int* keys, int* cols, int T, uint32_t mask, int shift, int lane,
    const int32_t* crow, const uint8_t* vrow, const int32_t* brow,
    const int32_t* rrow, int K, int W, int V, uint8_t* ok, int32_t* packed,
    long long b, int cap) {
  // every load of the row's first pass and first seen batch is issued
  // before the table is touched: one trip to memory for the walks' shapes
  int c[C];
  uint32_t vmask;
  load_pass(crow, vrow, K, 0, lane, c, &vmask);
  Seen seen;
  int nbeam4, nring4;
  const int edge_b = split(brow, W, lane, &seen.beam4, &nbeam4);
  const int edge_r = split(rrow, V, lane - 16, &seen.ring4, &nring4);
  seen.nbeam4 = nbeam4;
  seen.n4 = nbeam4 + nring4;
  int4 g[kSeen];
  load_batch(seen, 0, lane, g);

  const int pass = 32 * C;
  const int capK = cap < K ? cap : K;
  if (K <= pass) {  // a row whose candidates are all -1 or invalid keeps none
    bool any = false;
#pragma unroll
    for (int n = 0; n < C; ++n) any |= c[n] != -1 && ((vmask >> n) & 1u);
    if (!__any_sync(0xffffffffu, any)) {
#pragma unroll
      for (int n = 0; n < C; ++n) {
        if (32 * n + lane < K) ok[b * K + 32 * n + lane] = 0;
      }
      if (COMPACT) {
        for (int p = lane; p < capK; p += 32) packed[b * capK + p] = -1;
      }
      return;
    }
  }

  int4* keys4 = reinterpret_cast<int4*>(keys);
  for (int i = lane; i < T / 4; i += 32) keys4[i] = make_int4(-1, -1, -1, -1);
  __syncwarp();

  // phase 1: every candidate other than -1, valid or not, at its first
  // column; with one pass, each candidate's slot stays in s for phase 3
  uint32_t s[C];
  for (int p0 = 0; p0 < K; p0 += pass) {
    if (p0 > 0) load_pass(crow, vrow, K, p0, lane, c, &vmask);
    insert_pass(keys, cols, mask, shift, c, p0, lane, s);
  }
  __syncwarp();

  // phase 2: the beam's and the ring's ids mark their slots seen, the next
  // batch of loads in flight while one is probed
  {
    const int edge[2] = {edge_b, edge_r};
    see(keys, cols, mask, shift, edge);
  }
  for (int i0 = 0; i0 < seen.n4; i0 += 32 * kSeen) {
    int4 next[kSeen];
    load_batch(seen, i0 + 32 * kSeen, lane, next);
    see_batch(keys, cols, mask, shift, g);
#pragma unroll
    for (int u = 0; u < kSeen; ++u) g[u] = next[u];
  }
  __syncwarp();

  // phase 3: keep a candidate at its first column unless seen; compact
  uint8_t* orow = ok + b * K;
  int32_t* prow = COMPACT ? packed + b * capK : nullptr;
  const uint32_t below = (1u << lane) - 1u;
  int total = 0;  // survivors of the earlier chunks, the same in every lane
  for (int p0 = 0; p0 < K; p0 += pass) {
    if (K > pass) {  // several passes: load and look up again
      load_pass(crow, vrow, K, p0, lane, c, &vmask);
      find_all(keys, mask, shift, c, s);
    }
    int col[C];
#pragma unroll
    for (int n = 0; n < C; ++n) {
      col[n] = c[n] != -1 && ((vmask >> n) & 1u) ? cols[s[n]] : -1;
    }
#pragma unroll
    for (int n = 0; n < C; ++n) {
      const int j = p0 + 32 * n + lane;
      const bool keep = col[n] == j;
      if (j < K) orow[j] = keep;
      if (COMPACT) {
        const uint32_t m = __ballot_sync(0xffffffffu, keep);
        const int pos = total + __popc(m & below);
        if (keep && pos < capK) prow[pos] = c[n];
        total += __popc(m);
      }
    }
  }
  if (COMPACT) {
    for (int p = total + lane; p < capK; p += 32) prow[p] = -1;
  }
}

// C: 32-column chunks of candidates a lane holds (1, 3 or 12 by K): C = 1
// takes the narrow row, the others the wide one
template <bool COMPACT, int C>
__global__ void __launch_bounds__(kMaxWarps * 32) beam_dedup_kernel(
    const int32_t* __restrict__ cand, long long ld_cand,
    const uint8_t* __restrict__ valid, long long ld_valid,
    const int32_t* __restrict__ beam_i, long long ld_beam,
    const int32_t* __restrict__ vis, long long ld_vis,
    uint8_t* __restrict__ ok, int32_t* __restrict__ packed, int B, int K,
    int W, int V, int cap, int log_slots) {
  extern __shared__ int4 smem[];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const long long b = static_cast<long long>(blockIdx.x) * (blockDim.x >> 5) + warp;
  if (b >= B) return;  // the whole warp: no block barrier follows
  const int T = 1 << log_slots;
  int* keys = reinterpret_cast<int*>(smem) + 2 * static_cast<size_t>(warp) * T;
  int* cols = keys + T;  // written for the slots that hold an id only
  const uint8_t* vrow = valid == nullptr ? nullptr : valid + b * ld_valid;
  if constexpr (C == 1) {
    narrow_row<COMPACT>(keys, cols, T - 1u, 32 - log_slots, lane,
                        cand + b * ld_cand, vrow, beam_i + b * ld_beam,
                        vis + b * ld_vis, K, W, V, ok, packed, b, cap);
  } else {
    wide_row<COMPACT, C>(keys, cols, T, T - 1u, 32 - log_slots, lane,
                         cand + b * ld_cand, vrow, beam_i + b * ld_beam,
                         vis + b * ld_vis, K, W, V, ok, packed, b, cap);
  }
}

// log2 of a row's table slots: the least 2^L >= max(32, 2K), and >= 4K
// where the row's seen ids outnumber 8K, so that their probes, which then
// take most of the time, meet fewer filled slots
int log_slots(int K, int S) {
  const long long want = (S > 8LL * K ? 4LL : 2LL) * K;
  int l = 5;
  while ((1LL << l) < want) ++l;
  return l;
}

// rows (warps) of a block: kMaxWarps, halved while the block's tables
// exceed kSmemTarget, at least 1 (ggnn_torch/ops/beam.py: rows_per_block)
int rows_per_block(int K, int S) {
  const long long row = 8LL << log_slots(K, S);
  int r = kMaxWarps;
  while (r > 1 && r * row > kSmemTarget) r /= 2;
  return r;
}

// bytes of dynamic shared memory a block takes (ggnn_torch/ops/beam.py:
// shared_bytes computes the same)
long long shared_bytes(int K, int S) {
  return static_cast<long long>(rows_per_block(K, S)) * (8LL << log_slots(K, S));
}

template <bool COMPACT, int C>
int launch_chunks(const void* cand, long long ld_cand, const void* valid,
                  long long ld_valid, const void* beam_i, long long ld_beam,
                  const void* vis, long long ld_vis, void* ok, void* packed,
                  int B, int K, int W, int V, int cap, void* stream) {
  const long long smem = shared_bytes(K, W + V);
  if (smem > 48 * 1024) {
    int dev = 0, optin = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
    if (smem > optin) return static_cast<int>(cudaErrorInvalidValue);
    cudaFuncSetAttribute(beam_dedup_kernel<COMPACT, C>,
                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                         static_cast<int>(smem));
  }
  const int rows = rows_per_block(K, W + V);
  const int blocks = (B + rows - 1) / rows;
  beam_dedup_kernel<COMPACT, C><<<blocks, rows * 32, smem,
                                  static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(cand), ld_cand,
      static_cast<const uint8_t*>(valid), ld_valid,
      static_cast<const int32_t*>(beam_i), ld_beam,
      static_cast<const int32_t*>(vis), ld_vis, static_cast<uint8_t*>(ok),
      static_cast<int32_t*>(packed), B, K, W, V, cap, log_slots(K, W + V));
  return static_cast<int>(cudaGetLastError());
}

// the fewest register chunks that hold K in one pass: 1 (the fused
// walks' K = 32), 3 (the merges' 96), else kPassChunks (passes above 384)
template <bool COMPACT>
int launch(const void* cand, long long ld_cand, const void* valid,
           long long ld_valid, const void* beam_i, long long ld_beam,
           const void* vis, long long ld_vis, void* ok, void* packed, int B,
           int K, int W, int V, int cap, void* stream) {
  if (K <= 32) {
    return launch_chunks<COMPACT, 1>(cand, ld_cand, valid, ld_valid, beam_i,
                                     ld_beam, vis, ld_vis, ok, packed, B, K, W,
                                     V, cap, stream);
  }
  if (K <= 96) {
    return launch_chunks<COMPACT, 3>(cand, ld_cand, valid, ld_valid, beam_i,
                                     ld_beam, vis, ld_vis, ok, packed, B, K, W,
                                     V, cap, stream);
  }
  return launch_chunks<COMPACT, kPassChunks>(cand, ld_cand, valid, ld_valid,
                                             beam_i, ld_beam, vis, ld_vis, ok,
                                             packed, B, K, W, V, cap, stream);
}

}  // namespace

// cand [B, K] i32, valid [B, K] bool or null, beam_i [B, W] i32, vis [B, V]
// i32, each row contiguous at the given row stride (elements); ok [B, K]
// bool, contiguous. All on one device; B, K, W + V > 0.
extern "C" int beam_dedup_launch(const void* cand, long long ld_cand,
                                 const void* valid, long long ld_valid,
                                 const void* beam_i, long long ld_beam,
                                 const void* vis, long long ld_vis, void* ok,
                                 int B, int K, int W, int V, void* stream) {
  return launch<false>(cand, ld_cand, valid, ld_valid, beam_i, ld_beam, vis,
                       ld_vis, ok, nullptr, B, K, W, V, K, stream);
}

// as beam_dedup_launch, and packed [B, min(cap, K)] i32, contiguous
extern "C" int beam_dedup_compact_launch(const void* cand, long long ld_cand,
                                         const void* valid, long long ld_valid,
                                         const void* beam_i, long long ld_beam,
                                         const void* vis, long long ld_vis,
                                         void* ok, void* packed, int B, int K,
                                         int W, int V, int cap, void* stream) {
  return launch<true>(cand, ld_cand, valid, ld_valid, beam_i, ld_beam, vis,
                      ld_vis, ok, packed, B, K, W, V, cap, stream);
}
