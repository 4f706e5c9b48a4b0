// Anchor-block fetch + dequant dot for the quantized-adjacency walk.
//
// Replaces the JAX package's Pallas TPU kernel `_adjacency_dot_tpu`
// (ops/adjacency_pallas.py: `_kernel`, wrapper `adjacency_dot`). It computes
//
//   out[b, p, k] = sum_d bf16(qs[b, d]) * codes[anchors[b, p], k, d]
//
// accumulated in f32, for every popped anchor of every walk row. With NIB
// (int4 codes) each code row packs two neighbours, low nibble first, and the
// output row is [all low halves (CR) | all high halves (CR)].
//
// What bounds it on Hopper: the bytes it reads. Each anchor's block is
// CR*D contiguous bytes (6 KB at CR=48, D=128) that is read once and used
// once -- 2 flops per byte, far below the ~300 flops/byte where an H100
// stops being memory-bound. So the design streams each block with 16-byte
// coalesced loads and never stages it: no shared-memory tile, no tensor
// cores. The TPU kernel instead multiplied the block of QT queries' anchors
// with all QT query rows on the MXU and masked the diagonal, QT times the
// needed arithmetic; here every anchor is dotted with its own query row only.
//
// At the bytes bound each SM must consume 13-15 code bytes per clock.
// Three things inside the SM stood in the way of that rate in the first
// version of this kernel, and the design keeps clear of each:
//   * the int -> f32 conversion pipe (16 results per clock per SM): a code
//     becomes a float with integer ops and one exact subtraction instead --
//     PRMT puts the byte into the mantissa of 2^23 (0x4B0000bb) and
//     subtracting 2^23 leaves the byte, exact for 0..255; int4 masks its
//     nibbles in place first (the high ones as 16x their value, the row's
//     sum scaled back by 1/16, a power of two). Per code: one PRMT, one
//     FADD, one FFMA, and no I2F in the SASS;
//   * shared memory: each lane reads the query floats of its one 16-byte
//     chunk straight from `qs` (L2-resident, shared by the anchors of a
//     row), rounds them to bf16 once and keeps them in registers for the
//     whole block -- no shared memory, no __syncthreads;
//   * loads waited on one at a time, and the per-row epilogue: each lane
//     loads kRows rows at once (a streaming load: the bytes are read once)
//     and issues the next batch before it reduces this one; the T lanes of
//     a row reduce with xor shuffles that exchange halves while a lane holds
//     several sums, so that the stores spread over the lanes.
// The product of a bf16-rounded query and an integer <= 255 is exact in
// f32, and the shuffles pair the lanes as a plain butterfly does, so every
// sum is bit-identical to the first version's (which summed in the same
// order with I2F conversions).
//
// Layout of the work:
//   * one warp per (b, p) anchor, four anchors per thread block;
//   * T lanes share one code row (T = the power of two covering D/16
//     16-byte chunks, at most 32; a template parameter), so a warp covers
//     32/T rows per pass and neighbouring lanes read neighbouring 16-byte
//     chunks of the block; a batch of kRows passes is loaded together,
//     rows past CR masked;
//   * D > 512 (more than one chunk per lane: the "wide" kernels) loops
//     over the lane's chunks and reads each chunk's query floats again --
//     right, not tuned;
//   * an anchor of -1 (or out of range) returns without writing: callers
//     mask those lanes by their empty ids.
//
// The tail kernels (`adjacency_dot_<layout>_tail_t<lanes>`, `..._tail_wide`)
// take code rows whose width D is a multiple of 4 but not of 16 (GloVe's
// D = 100). Code row r starts at r*D bytes, so most rows of a block are
// only 4-byte aligned and a 16-byte load of them would fault. Their
// "chunk" is one 4-byte word: T lanes cover the row's D/4 words (the power
// of two covering them, at most 32; above 32 words the wide loop), each
// lane reads its word of R rows with 4-byte streaming loads and its 4 query
// floats with one 16-byte load (a query row of D % 4 == 0 floats stays
// 16-byte aligned). Coalescing is unchanged: the lanes of a row read its
// D contiguous bytes, and consecutive rows follow each other. A 4-byte load
// carries a quarter of the bytes of a 16-byte one, so the tail kernels keep
// kTailRows rows in flight a lane instead of kRows. Summation order is the
// same scheme: each lane sums its words' bytes in order, then the row's
// lanes reduce in a butterfly, so that every product is exact and a sum is
// rounded the same way wherever it runs. The D % 16 == 0 instances are the
// same code at 4 words a chunk and kRows rows.
// The kernel launches on the caller's stream, never synchronises and
// allocates nothing; the C entry point returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 4;  // anchors per thread block
// rows each lane loads together, a power of two: 2 was the fastest of 1, 2,
// 4 and 8 on the H100 (u8 and int4 check shapes, builds timed in turns)
constexpr int kRows = 2;
// the same for the tail kernels' 4-byte words: 8 was the fastest of 2, 4
// and 8 on the H100 at glove100's u8 step (8,192 rows, 8 pops, 24 x 100 B)
constexpr int kTailRows = 8;
static_assert(kRows > 0 && (kRows & (kRows - 1)) == 0, "rows in flight: a power of two");
static_assert(kTailRows > 0 && (kTailRows & (kTailRows - 1)) == 0,
              "rows in flight: a power of two");

// A chunk of a code row: W 32-bit words, one load. W = 4 (16 bytes, the
// D % 16 == 0 kernels) or 1 (4 bytes, the tail kernels).
template <int W> struct Chunk;
template <> struct Chunk<4> {
  using T = uint4;
  static __device__ __forceinline__ uint32_t word(const uint4& v, int j) {
    return j == 0 ? v.x : j == 1 ? v.y : j == 2 ? v.z : v.w;
  }
  static __device__ __forceinline__ uint4 zero() { return make_uint4(0u, 0u, 0u, 0u); }
};
template <> struct Chunk<1> {
  using T = uint32_t;
  static __device__ __forceinline__ uint32_t word(uint32_t v, int) { return v; }
  static __device__ __forceinline__ uint32_t zero() { return 0u; }
};

__host__ __device__ constexpr int log2i(int x) { return x > 1 ? 1 + log2i(x / 2) : 0; }

// byte K of w as an exact f32, without the conversion pipe. `magic` is
// 0x4B000000 (2^23), a kernel argument so that it lives in a register and
// PRMT's immediate holds the selector: given the constant, ptxas puts it in
// the immediate and moves the selector into a register before every PRMT
// (10% slower for int4 on the H100).
template <int K>
__device__ __forceinline__ float byte_as_float(uint32_t w, uint32_t magic) {
  return __int_as_float(__byte_perm(w, magic, 0x7440u | K)) - 8388608.0f;
}

// the 4W query floats of chunk c, rounded to bf16 (round-to-nearest-even,
// as `qs.astype(bfloat16)` does) and kept as f32
template <int W>
__device__ __forceinline__ void load_query(const float* qrow, int c, float (&q)[4 * W]) {
  const float4* src = reinterpret_cast<const float4*>(qrow) + W * c;
#pragma unroll
  for (int j = 0; j < W; ++j) {
    const float4 f = __ldg(src + j);
    q[4 * j + 0] = __bfloat162float(__float2bfloat16_rn(f.x));
    q[4 * j + 1] = __bfloat162float(__float2bfloat16_rn(f.y));
    q[4 * j + 2] = __bfloat162float(__float2bfloat16_rn(f.z));
    q[4 * j + 3] = __bfloat162float(__float2bfloat16_rn(f.w));
  }
}

template <int K, bool NIB>
__device__ __forceinline__ void dot_byte(uint32_t w, uint32_t l, uint32_t h,
                                         uint32_t magic, float qk, float& lo,
                                         float& hi) {
  if (NIB) {
    lo = fmaf(qk, byte_as_float<K>(l, magic), lo);
    hi = fmaf(qk, byte_as_float<K>(h, magic), hi);
  } else {
    lo = fmaf(qk, byte_as_float<K>(w, magic), lo);
  }
}

// one chunk of a code row against the query slice, bytes in order
template <bool NIB, int W>
__device__ __forceinline__ void dot_chunk(const typename Chunk<W>::T& v,
                                          const float (&q)[4 * W], uint32_t magic,
                                          float& lo, float& hi) {
  uint32_t w[W];
#pragma unroll
  for (int j = 0; j < W; ++j) w[j] = Chunk<W>::word(v, j);
#pragma unroll
  for (int j = 0; j < W; ++j) {
    // int4: the high nibbles stay in place, as 16x their value; the
    // row's sum is scaled back by 1/16 (exact: a power of two)
    const uint32_t l = w[j] & 0x0F0F0F0Fu;
    const uint32_t h = w[j] & 0xF0F0F0F0u;
    dot_byte<0, NIB>(w[j], l, h, magic, q[4 * j + 0], lo, hi);
    dot_byte<1, NIB>(w[j], l, h, magic, q[4 * j + 1], lo, hi);
    dot_byte<2, NIB>(w[j], l, h, magic, q[4 * j + 2], lo, hi);
    dot_byte<3, NIB>(w[j], l, h, magic, q[4 * j + 3], lo, hi);
  }
}

// rows row0, row0 + RP, ... (R of them) of chunk c; rows past CR read
// nothing (zeros)
template <int RP, int R, int W>
__device__ __forceinline__ void load_rows(typename Chunk<W>::T (&v)[R],
                                          const uint8_t* blk, int row0, int CR,
                                          int D, int c) {
  using T = typename Chunk<W>::T;
#pragma unroll
  for (int u = 0; u < R; ++u) {
    const int row = row0 + u * RP;
    // ld.global.cs: the bytes are read once (faster than __ldg on the H100)
    v[u] = row < CR ? __ldcs(reinterpret_cast<const T*>(blk + (long long)row * D) + c)
                    : Chunk<W>::zero();
  }
}

// Level S of the sum of each of the lane's V partial sums over the 2^LG_T
// lanes of its code row: xor shuffles at offsets 2^LG_T / 2, / 4, ..., 1
// -- the pairing of a plain butterfly, so the same f32 sums -- but while a
// lane holds n > 1 sums it keeps one half and sends the other, so that each
// level costs n / 2 shuffles instead of n. Afterwards the lane holds the
// whole sums of values j0, j0 + 1, ... (j0 grows by the halves it kept).
template <int S, int LG_T, int V>
__device__ __forceinline__ void reduce_level(float (&val)[V], int sub, int& j0) {
  if constexpr (S < LG_T) {
    constexpr int off = (1 << LG_T) >> (S + 1);
    constexpr int n = V >> S;
    if constexpr (n > 1) {
      const bool upper = (sub & off) != 0;
#pragma unroll
      for (int i = 0; i < n / 2; ++i) {
        const float send = upper ? val[i] : val[i + n / 2];
        const float keep = upper ? val[i + n / 2] : val[i];
        val[i] = keep + __shfl_xor_sync(0xffffffffu, send, off);
      }
      if (upper) j0 += n / 2;
    } else {
      val[0] += __shfl_xor_sync(0xffffffffu, val[0], off);
    }
    reduce_level<S + 1, LG_T, V>(val, sub, j0);
  }
}

// ONE_CHUNK: at most one chunk of W words per lane (D <= 128 * W); T =
// 2^LG_T lanes per code row
template <bool NIB, int LG_T, bool ONE_CHUNK, int W>
__device__ __forceinline__ void adjacency_dot_body(
    const float* __restrict__ qs, const int32_t* __restrict__ anchors,
    const uint8_t* __restrict__ blocks, float* __restrict__ out, int P, int CR,
    int D, long long N, uint32_t magic) {
  constexpr int T = 1 << LG_T;
  constexpr int RP = 32 >> LG_T;           // rows per pass of the warp
  constexpr int R = W == 4 ? kRows : kTailRows;  // rows in flight a lane
  constexpr int V = NIB ? 2 * R : R;       // sums per lane and batch
  constexpr int NF = (V >> LG_T) > 1 ? (V >> LG_T) : 1;  // ... once reduced
  // the lanes that hold a reduced sum first: the low bits of `sub` that
  // the plain butterfly levels run over are 0
  constexpr int WRITER_MASK = log2i(V) < LG_T ? (T >> log2i(V)) - 1 : 0;

  const int p = blockIdx.y * kWarps + threadIdx.x / 32;
  if (p >= P) return;
  const int b = blockIdx.x;
  const int aid = anchors[(long long)b * P + p];
  if (aid < 0 || aid >= N) return;

  const int lane = threadIdx.x % 32;
  const int sub = lane & (T - 1);  // which chunk(s) of the row
  const int nchunk = D / (4 * W);
  const uint8_t* blk = blocks + (long long)aid * CR * D;
  const float* qrow = qs + (long long)b * D;
  float* o = out + ((long long)b * P + p) * (NIB ? 2 * CR : CR);
  const bool has_chunk = sub < nchunk;

  float q[4 * W];
  typename Chunk<W>::T v[R];
  if (ONE_CHUNK && has_chunk) {
    load_rows<RP, R, W>(v, blk, lane >> LG_T, CR, D, sub);
    load_query<W>(qrow, sub, q);
  }
  // the trip count is the same for every lane of the warp: the shuffles
  // below need all 32
  for (int r0 = 0; r0 < CR; r0 += R * RP) {
    const int row0 = r0 + (lane >> LG_T);
    float val[V];  // [lo of each row | hi of each row (int4)]
#pragma unroll
    for (int i = 0; i < V; ++i) val[i] = 0.f;
    float* lo = val;
    float* hi = val + (NIB ? R : 0);
    if (ONE_CHUNK) {
      if (has_chunk) {
#pragma unroll
        for (int u = 0; u < R; ++u) dot_chunk<NIB, W>(v[u], q, magic, lo[u], hi[u]);
        // the next batch's loads go out before this batch's sums
        if (r0 + R * RP < CR) load_rows<RP, R, W>(v, blk, row0 + R * RP, CR, D, sub);
      }
    } else {
      for (int c = sub; c < nchunk; c += T) {
        load_query<W>(qrow, c, q);
        load_rows<RP, R, W>(v, blk, row0, CR, D, c);
#pragma unroll
        for (int u = 0; u < R; ++u) dot_chunk<NIB, W>(v[u], q, magic, lo[u], hi[u]);
      }
    }
    // every lane takes part in the shuffles, rows past CR with zeros
    int j0 = 0;
    reduce_level<0, LG_T, V>(val, sub, j0);
    if ((sub & WRITER_MASK) == 0) {
#pragma unroll
      for (int i = 0; i < NF; ++i) {
        const int j = j0 + i;  // value j: row u of the batch, high half past R
        const int row = row0 + (j % R) * RP;
        const bool high = NIB && j >= R;
        if (row < CR) o[(high ? CR : 0) + row] = high ? val[i] * 0.0625f : val[i];
      }
    }
  }
}

}  // namespace

// One kernel per (codes, lanes per code row, chunk), under plain names for
// cuobjdump; the "wide" ones loop over more than 32 chunks a row with 32
// lanes per row; the "tail" ones read 4-byte words (D % 16 != 0).
#define ADJACENCY_DOT_KERNEL(NAME, NIB, LG_T, ONE_CHUNK, W)                     \
  extern "C" __global__ void __launch_bounds__(kWarps * 32) NAME(              \
      const float* __restrict__ qs, const int32_t* __restrict__ anchors,       \
      const uint8_t* __restrict__ blocks, float* __restrict__ out, int P,      \
      int CR, int D, long long N, uint32_t magic) {                            \
    adjacency_dot_body<NIB, LG_T, ONE_CHUNK, W>(qs, anchors, blocks, out, P,   \
                                                CR, D, N, magic);              \
  }
ADJACENCY_DOT_KERNEL(adjacency_dot_u8_t1, false, 0, true, 4)
ADJACENCY_DOT_KERNEL(adjacency_dot_u8_t2, false, 1, true, 4)
ADJACENCY_DOT_KERNEL(adjacency_dot_u8_t4, false, 2, true, 4)
ADJACENCY_DOT_KERNEL(adjacency_dot_u8_t8, false, 3, true, 4)
ADJACENCY_DOT_KERNEL(adjacency_dot_u8_t16, false, 4, true, 4)
ADJACENCY_DOT_KERNEL(adjacency_dot_u8_t32, false, 5, true, 4)
ADJACENCY_DOT_KERNEL(adjacency_dot_u8_wide, false, 5, false, 4)
ADJACENCY_DOT_KERNEL(adjacency_dot_int4_t1, true, 0, true, 4)
ADJACENCY_DOT_KERNEL(adjacency_dot_int4_t2, true, 1, true, 4)
ADJACENCY_DOT_KERNEL(adjacency_dot_int4_t4, true, 2, true, 4)
ADJACENCY_DOT_KERNEL(adjacency_dot_int4_t8, true, 3, true, 4)
ADJACENCY_DOT_KERNEL(adjacency_dot_int4_t16, true, 4, true, 4)
ADJACENCY_DOT_KERNEL(adjacency_dot_int4_t32, true, 5, true, 4)
ADJACENCY_DOT_KERNEL(adjacency_dot_int4_wide, true, 5, false, 4)
ADJACENCY_DOT_KERNEL(adjacency_dot_u8_tail_t1, false, 0, true, 1)
ADJACENCY_DOT_KERNEL(adjacency_dot_u8_tail_t2, false, 1, true, 1)
ADJACENCY_DOT_KERNEL(adjacency_dot_u8_tail_t4, false, 2, true, 1)
ADJACENCY_DOT_KERNEL(adjacency_dot_u8_tail_t8, false, 3, true, 1)
ADJACENCY_DOT_KERNEL(adjacency_dot_u8_tail_t16, false, 4, true, 1)
ADJACENCY_DOT_KERNEL(adjacency_dot_u8_tail_t32, false, 5, true, 1)
ADJACENCY_DOT_KERNEL(adjacency_dot_u8_tail_wide, false, 5, false, 1)
ADJACENCY_DOT_KERNEL(adjacency_dot_int4_tail_t1, true, 0, true, 1)
ADJACENCY_DOT_KERNEL(adjacency_dot_int4_tail_t2, true, 1, true, 1)
ADJACENCY_DOT_KERNEL(adjacency_dot_int4_tail_t4, true, 2, true, 1)
ADJACENCY_DOT_KERNEL(adjacency_dot_int4_tail_t8, true, 3, true, 1)
ADJACENCY_DOT_KERNEL(adjacency_dot_int4_tail_t16, true, 4, true, 1)
ADJACENCY_DOT_KERNEL(adjacency_dot_int4_tail_t32, true, 5, true, 1)
ADJACENCY_DOT_KERNEL(adjacency_dot_int4_tail_wide, true, 5, false, 1)
#undef ADJACENCY_DOT_KERNEL

// qs [B, D] f32 (16-byte aligned), anchors [B, P] i32, blocks [N, CR, D] u8
// (16-byte aligned, D % 4 == 0: the tail kernels where D % 16 != 0), out
// [B, P, CR or 2*CR] f32; all contiguous on one device. D % 4 != 0 returns
// cudaErrorInvalidValue and launches nothing.
extern "C" int adjacency_dot_launch(const void* qs, const void* anchors,
                                    const void* blocks, void* out, int B,
                                    int P, int CR, int D, long long N,
                                    int nibbles, void* stream) {
  using Kernel = void (*)(const float*, const int32_t*, const uint8_t*, float*,
                          int, int, int, long long, uint32_t);
  static const Kernel kernels[2][2][7] = {
      {{adjacency_dot_u8_t1, adjacency_dot_u8_t2, adjacency_dot_u8_t4,
        adjacency_dot_u8_t8, adjacency_dot_u8_t16, adjacency_dot_u8_t32,
        adjacency_dot_u8_wide},
       {adjacency_dot_int4_t1, adjacency_dot_int4_t2, adjacency_dot_int4_t4,
        adjacency_dot_int4_t8, adjacency_dot_int4_t16, adjacency_dot_int4_t32,
        adjacency_dot_int4_wide}},
      {{adjacency_dot_u8_tail_t1, adjacency_dot_u8_tail_t2,
        adjacency_dot_u8_tail_t4, adjacency_dot_u8_tail_t8,
        adjacency_dot_u8_tail_t16, adjacency_dot_u8_tail_t32,
        adjacency_dot_u8_tail_wide},
       {adjacency_dot_int4_tail_t1, adjacency_dot_int4_tail_t2,
        adjacency_dot_int4_tail_t4, adjacency_dot_int4_tail_t8,
        adjacency_dot_int4_tail_t16, adjacency_dot_int4_tail_t32,
        adjacency_dot_int4_tail_wide}}};
  if (D % 4) return static_cast<int>(cudaErrorInvalidValue);
  // T = 2^lgT lanes per code row: enough for its chunks (16 bytes, or 4 in
  // the tail kernels), at most 32
  const bool tail = D % 16 != 0;
  const int nchunk = D / (tail ? 4 : 16);
  int lgT = 0;
  while ((1 << lgT) < nchunk && lgT < 5) ++lgT;
  const Kernel k = kernels[tail][nibbles ? 1 : 0][nchunk <= 32 ? lgT : 6];
  const dim3 grid(B, (P + kWarps - 1) / kWarps);
  k<<<grid, kWarps * 32, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(qs), static_cast<const int32_t*>(anchors),
      static_cast<const uint8_t*>(blocks), static_cast<float*>(out), P, CR, D,
      N, 0x4B000000u);
  return static_cast<int>(cudaGetLastError());
}
