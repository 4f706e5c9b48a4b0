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
// What bounds it on Hopper: the function needs only its bytes -- per row
// K*4 + K (valid) + (W+V)*4 read and K (+ min(cap, K)*4) written, 6-8 us a
// walk step at B = 8192, K = 384, W+V = 256 at 3.35 TB/s. This first
// design compares pairwise, K*(K-1)/2 + K*(W+V) 32-bit compares a row (1.4 G
// a step at those shapes), so the compares bound it, not the bytes; a
// hashed or sorted form that reaches the bytes bound is later work. What it
// does keep out of device memory is every intermediate of the plain
// version: one pass reads each input once and writes each output once.
//
// Layout of the work:
//   * one block per row, blockDim a multiple of 32 (at most 256 threads,
//     each taking the columns j = threadIdx.x + n * blockDim.x);
//   * the row's seen ids (beam ++ ring) and its candidates are staged in
//     shared memory, each list padded to a multiple of 4 with -1 (a -1
//     candidate is dropped anyway, so a match with the padding changes
//     nothing); a thread holds its candidate in a register and scans the
//     lists with 16-byte shared loads that every lane of the warp makes at
//     the same address (a broadcast, no bank conflicts), stopping at its
//     first match; a column already dropped by -1 or `valid` compares
//     nothing;
//   * compaction: each warp ballots its 32 columns' flags into shared
//     memory, one thread turns the per-chunk popcounts into offsets, and a
//     survivor writes itself at its chunk's offset plus the popcount of the
//     ballot below its lane -- the order of a stable sort on the drop flag;
//   * inputs may have padded rows (a row stride per input; elements of a
//     row contiguous). Shared memory above 48 KB is asked for with
//     cudaFuncAttributeMaxDynamicSharedMemorySize, up to the device's
//     opt-in limit; above it the launch returns cudaErrorInvalidValue.
// The kernel launches on the caller's stream, never synchronises and
// allocates nothing; each C entry point returns cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxThreads = 256;

// does any of the n4 16-byte groups at p hold c?
__device__ __forceinline__ bool any_equal(const int4* p, int n4, int c) {
  for (int i = 0; i < n4; ++i) {
    const int4 s = p[i];
    if ((s.x == c) | (s.y == c) | (s.z == c) | (s.w == c)) return true;
  }
  return false;
}

template <bool COMPACT>
__global__ void __launch_bounds__(kMaxThreads) beam_dedup_kernel(
    const int32_t* __restrict__ cand, long long ld_cand,
    const uint8_t* __restrict__ valid, long long ld_valid,
    const int32_t* __restrict__ beam_i, long long ld_beam,
    const int32_t* __restrict__ vis, long long ld_vis,
    uint8_t* __restrict__ ok, int32_t* __restrict__ packed, int K, int W,
    int V, int cap) {
  extern __shared__ int4 smem[];
  const int S = W + V;
  const int S4 = (S + 3) / 4, K4 = (K + 3) / 4;
  const int nchunk = (K + 31) / 32;
  int* seen = reinterpret_cast<int*>(smem);  // [4 * S4]
  int* cs = seen + 4 * S4;                   // [4 * K4]
  uint32_t* masks = reinterpret_cast<uint32_t*>(cs + 4 * K4);  // [nchunk]
  int* offs = reinterpret_cast<int*>(masks + nchunk);          // [nchunk + 1]

  const long long b = blockIdx.x;
  const int32_t* crow = cand + b * ld_cand;
  for (int i = threadIdx.x; i < 4 * S4; i += blockDim.x) {
    int v = -1;
    if (i < W) {
      v = beam_i[b * ld_beam + i];
    } else if (i < S) {
      v = vis[b * ld_vis + (i - W)];
    }
    seen[i] = v;
  }
  for (int i = threadIdx.x; i < 4 * K4; i += blockDim.x) cs[i] = i < K ? crow[i] : -1;
  __syncthreads();

  const int4* seen4 = smem;
  const int4* cs4 = smem + S4;
  const int lane = threadIdx.x & 31;
  // the same trip count for every thread, so that a warp ballots whole
  const int steps = (K + blockDim.x - 1) / blockDim.x;
  for (int n = 0; n < steps; ++n) {
    const int j = n * blockDim.x + threadIdx.x;
    bool keep = false;
    if (j < K) {
      const int c = cs[j];
      keep = c != -1 && (valid == nullptr || valid[b * ld_valid + j] != 0);
      if (keep) {
        // earlier candidates of the row: whole groups of 4 below j, then
        // the up to 3 columns of j's own group before it
        bool dup = any_equal(cs4, j / 4, c);
        for (int i = j & ~3; i < j && !dup; ++i) dup = cs[i] == c;
        keep = !dup && !any_equal(seen4, S4, c);
      }
      ok[b * K + j] = keep;
    }
    if (COMPACT) {
      const uint32_t m = __ballot_sync(0xffffffffu, keep);
      const int chunk = (j - lane) / 32;
      if (lane == 0 && chunk < nchunk) masks[chunk] = m;
    }
  }
  if (!COMPACT) return;
  __syncthreads();
  if (threadIdx.x == 0) {
    int total = 0;
    for (int c = 0; c < nchunk; ++c) {
      offs[c] = total;
      total += __popc(masks[c]);
    }
    offs[nchunk] = total;
  }
  __syncthreads();
  const int capK = cap < K ? cap : K;
  int32_t* prow = packed + b * capK;
  for (int n = 0; n < steps; ++n) {
    const int j = n * blockDim.x + threadIdx.x;
    if (j >= K) break;
    const uint32_t m = masks[j / 32];
    if ((m >> lane) & 1u) {
      const int pos = offs[j / 32] + __popc(m & ((1u << lane) - 1u));
      if (pos < capK) prow[pos] = cs[j];
    }
  }
  for (int c = offs[nchunk] + threadIdx.x; c < capK; c += blockDim.x) prow[c] = -1;
}

// bytes of dynamic shared memory a row takes (ggnn_torch/ops/beam.py:
// shared_bytes computes the same)
long long shared_bytes(int K, int W, int V, bool compact) {
  const long long S4 = (static_cast<long long>(W) + V + 3) / 4;
  const long long K4 = (static_cast<long long>(K) + 3) / 4;
  const long long nchunk = (static_cast<long long>(K) + 31) / 32;
  return 16 * (S4 + K4) + (compact ? 4 * (2 * nchunk + 1) : 0);
}

template <bool COMPACT>
int launch(const void* cand, long long ld_cand, const void* valid,
           long long ld_valid, const void* beam_i, long long ld_beam,
           const void* vis, long long ld_vis, void* ok, void* packed, int B,
           int K, int W, int V, int cap, void* stream) {
  const long long smem = shared_bytes(K, W, V, COMPACT);
  if (smem > 48 * 1024) {
    int dev = 0, optin = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
    if (smem > optin) return static_cast<int>(cudaErrorInvalidValue);
    cudaFuncSetAttribute(beam_dedup_kernel<COMPACT>,
                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                         static_cast<int>(smem));
  }
  // threads: the fewest passes of at most kMaxThreads, then the fewest
  // warps that cover K in that many passes
  const int passes = (K + kMaxThreads - 1) / kMaxThreads;
  const int threads = ((K + passes - 1) / passes + 31) / 32 * 32;
  beam_dedup_kernel<COMPACT><<<B, threads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(cand), ld_cand,
      static_cast<const uint8_t*>(valid), ld_valid,
      static_cast<const int32_t*>(beam_i), ld_beam,
      static_cast<const int32_t*>(vis), ld_vis, static_cast<uint8_t*>(ok),
      static_cast<int32_t*>(packed), K, W, V, cap);
  return static_cast<int>(cudaGetLastError());
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
