// The walks' pop: each beam row's first P unexpanded entries below its
// criterion become the step's anchors, and the beam and the visited ring
// are updated in place.
//
// Replaces no Pallas kernel: it is the XLA fusion of `beam_pop`
// (ggnn_tpu/ops/beam.py:205). The port ran it as plain PyTorch
// (ggnn_torch/ops/beam.py: `beam_pop_plain`): a cumsum of the eligible
// flags, a [B, W, P] one-hot for the anchors, and the ring's update as a
// torch.cat of the whole ring and an out-of-place scatter -- about 38
// launches a walk step and two copies of the [B, V] ring (13 MB each at
// 1,024 rows of 3,200 ids). For every row b:
//
//   crit        = criteria[b], or d[b, k_best - 1] + xi[b] (one f32 add)
//   eligible(c) = !exp[b, c] && i[b, c] != -1 && d[b, c] < crit, and
//                 row_mask[b] where a mask is given
//   the hits    = the first P eligible columns, in column order; cnt of them
//   anchors[b, r] = i[b, hit r] for r < cnt, else -1
//   exp[b, hit] = true; a hit at a column >= k_best is blanked to (+inf, -1)
//   ring[b, (head[b] + r) % V] = anchors[b, r] for r < cnt
//   head[b]     = (head[b] + cnt) % V;  active[b] = cnt > 0
//
// What bounds it on Hopper: its bytes are few. A row reads its beam only up
// to the chunk that holds its P-th hit (9 bytes a column) and writes O(P)
// values: at 1,024 rows of 32 columns and P = 16 about 0.4 MB, 0.1 us at
// 3.35 TB/s. So its time is a launch and the latency of a row's loads. The
// design keeps both to one:
//
//   * one warp a row, kRows rows a block; a lane holds one column of a
//     32-column chunk, whose d, i and exp are three coalesced loads;
//   * the eligible lanes are ranked by __ballot_sync and __popc against the
//     running count of hits; a lane whose rank is below P writes its anchor,
//     its flag, its blank and its ring slot straight to device memory -- no
//     shared memory, no second pass;
//   * the warp stops after the chunk that holds the P-th hit: the rest of
//     the beam is never read;
//   * the ring is written in place, cnt slots a row; it is never copied.
// The kernel launches on the caller's stream, never synchronises and
// allocates nothing, so it may be captured into a CUDA graph; the C entry
// point returns cudaGetLastError().

#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace {

constexpr int kRows = 4;  // rows (warps) of a block
constexpr unsigned kFull = 0xffffffffu;

__global__ void __launch_bounds__(kRows * 32) beam_pop_kernel(
    float* __restrict__ d, long long ld_d, int32_t* __restrict__ ids,
    long long ld_i, uint8_t* __restrict__ exp, long long ld_x,
    int32_t* __restrict__ ring, long long ld_v, int32_t* __restrict__ head,
    const float* __restrict__ xi, const float* __restrict__ criteria,
    const uint8_t* __restrict__ row_mask, int32_t* __restrict__ anchors,
    uint8_t* __restrict__ active, int B, int W, int P, int V, int k_best) {
  const int lane = threadIdx.x & 31;
  const int b = blockIdx.x * kRows + (threadIdx.x >> 5);
  if (b >= B) return;  // the whole warp
  float* drow = d + b * ld_d;
  int32_t* irow = ids + b * ld_i;
  uint8_t* xrow = exp + b * ld_x;
  int32_t* arow = anchors + static_cast<long long>(b) * P;
  int cnt = 0;
  if (row_mask == nullptr || row_mask[b]) {
    const float crit =
        criteria != nullptr ? criteria[b] : drow[k_best - 1] + xi[b];
    const int h = head[b];
    int32_t* vrow = ring + b * ld_v;
    const unsigned below = (1u << lane) - 1u;
    for (int c0 = 0; c0 < W && cnt < P; c0 += 32) {
      const int c = c0 + lane;
      bool hit = false;
      int32_t id = -1;
      if (c < W) {
        const float dv = drow[c];
        const uint8_t x = xrow[c];
        id = irow[c];
        hit = (x == 0) & (id != -1) & (dv < crit);
      }
      const unsigned m = __ballot_sync(kFull, hit);
      const int r = cnt + __popc(m & below);
      if (hit && r < P) {
        arow[r] = id;
        xrow[c] = 1;
        if (c >= k_best) {
          drow[c] = CUDART_INF_F;
          irow[c] = -1;
        }
        vrow[(h + r) % V] = id;
      }
      cnt += __popc(m);
    }
    cnt = min(cnt, P);
    if (lane == 0) head[b] = (h + cnt) % V;
  }
  for (int r = cnt + lane; r < P; r += 32) arow[r] = -1;
  if (lane == 0) active[b] = cnt > 0;
}

}  // namespace

// d [B, W] f32, i [B, W] i32, exp [B, W] bool, ring [B, V] i32: rows
// contiguous at the given row stride (elements), updated in place; head [B]
// i32 contiguous, updated in place; xi [B] f32 (read where criteria is
// null), criteria [B] f32 and row_mask [B] bool (or null) contiguous;
// anchors [B, P] i32 and active [B] bool written, contiguous. All on one
// device; B > 0, P >= 0, V > 0, and 1 <= k_best <= W where criteria is null.
extern "C" int beam_pop_launch(void* d, long long ld_d, void* i,
                               long long ld_i, void* x, long long ld_x,
                               void* ring, long long ld_v, void* head,
                               const void* xi, const void* criteria,
                               const void* mask, void* anchors, void* active,
                               int B, int W, int P, int V, int k_best,
                               void* stream) {
  const int blocks = (B + kRows - 1) / kRows;
  beam_pop_kernel<<<blocks, kRows * 32, 0,
                    static_cast<cudaStream_t>(stream)>>>(
      static_cast<float*>(d), ld_d, static_cast<int32_t*>(i), ld_i,
      static_cast<uint8_t*>(x), ld_x, static_cast<int32_t*>(ring), ld_v,
      static_cast<int32_t*>(head), static_cast<const float*>(xi),
      static_cast<const float*>(criteria), static_cast<const uint8_t*>(mask),
      static_cast<int32_t*>(anchors), static_cast<uint8_t*>(active), B, W, P,
      V, k_best);
  return static_cast<int>(cudaGetLastError());
}
