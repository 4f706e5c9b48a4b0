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
// Layout of the work:
//   * one warp per (b, p) anchor, four anchors per block; the block's
//     threads first round qs[b] to bf16 (round-to-nearest-even, as
//     `qs.astype(bfloat16)` does) and keep it in shared memory as f32;
//   * T threads share one code row (T = the power of two covering D/16
//     16-byte chunks, at most 32), so a warp covers 32/T rows per pass and
//     neighbouring lanes read neighbouring 16-byte chunks of the block;
//   * each lane dots its chunk(s) with the query slice, and T-lane xor
//     shuffles reduce the row; lane 0 of the row writes it;
//   * an anchor of -1 (or out of range) returns without writing: callers
//     mask those lanes by their empty ids.
// The kernel launches on the caller's stream, never synchronises and
// allocates nothing; the C entry point returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 4;  // anchors per thread block

template <bool NIB>
__global__ void __launch_bounds__(kWarps * 32)
adjacency_dot_kernel(const float* __restrict__ qs,
                     const int32_t* __restrict__ anchors,
                     const uint8_t* __restrict__ blocks,
                     float* __restrict__ out,
                     int P, int CR, int D, long long N, int T) {
  extern __shared__ float q_s[];  // [D] bf16-rounded query row, as f32
  const int b = blockIdx.x;
  for (int d = threadIdx.x; d < D; d += blockDim.x) {
    q_s[d] = __bfloat162float(__float2bfloat16_rn(qs[(long long)b * D + d]));
  }
  __syncthreads();

  const int p = blockIdx.y * kWarps + threadIdx.x / 32;
  if (p >= P) return;
  const int aid = anchors[(long long)b * P + p];
  if (aid < 0 || aid >= N) return;

  const int lane = threadIdx.x % 32;
  const int sub = lane % T;  // which 16-byte chunk(s) of the row
  const int rows_per_pass = 32 / T;
  const int nchunk = D / 16;
  const int KC = NIB ? 2 * CR : CR;
  const uint8_t* blk = blocks + (long long)aid * CR * D;
  float* o = out + ((long long)b * P + p) * KC;

  for (int r0 = 0; r0 < CR; r0 += rows_per_pass) {
    const int row = r0 + lane / T;
    float lo = 0.f;
    float hi = 0.f;
    if (row < CR) {
      const uint4* src = reinterpret_cast<const uint4*>(blk + (long long)row * D);
      for (int c = sub; c < nchunk; c += T) {
        const uint4 v = __ldg(src + c);
        const uint32_t w[4] = {v.x, v.y, v.z, v.w};
        const float4* qv = reinterpret_cast<const float4*>(q_s + c * 16);
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const float4 q4 = qv[j];
          const float qf[4] = {q4.x, q4.y, q4.z, q4.w};
#pragma unroll
          for (int k = 0; k < 4; ++k) {
            const uint32_t byte = (w[j] >> (8 * k)) & 0xffu;
            if (NIB) {
              lo = fmaf(qf[k], static_cast<float>(byte & 15u), lo);
              hi = fmaf(qf[k], static_cast<float>(byte >> 4), hi);
            } else {
              lo = fmaf(qf[k], static_cast<float>(byte), lo);
            }
          }
        }
      }
    }
    // every lane takes part in the shuffles, rows past CR with zeros
    for (int off = T / 2; off > 0; off >>= 1) {
      lo += __shfl_xor_sync(0xffffffffu, lo, off);
      if (NIB) hi += __shfl_xor_sync(0xffffffffu, hi, off);
    }
    if (row < CR && sub == 0) {
      o[row] = lo;
      if (NIB) o[CR + row] = hi;
    }
  }
}

}  // namespace

// qs [B, D] f32, anchors [B, P] i32, blocks [N, CR, D] u8 (16-byte aligned,
// D % 16 == 0), out [B, P, CR or 2*CR] f32; all contiguous on one device.
extern "C" int adjacency_dot_launch(const void* qs, const void* anchors,
                                    const void* blocks, void* out, int B,
                                    int P, int CR, int D, long long N,
                                    int nibbles, void* stream) {
  const int nchunk = D / 16;
  int T = 1;
  while (T < nchunk && T < 32) T <<= 1;
  const dim3 grid(B, (P + kWarps - 1) / kWarps);
  const dim3 block(kWarps * 32);
  const size_t smem = static_cast<size_t>(D) * sizeof(float);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* q = static_cast<const float*>(qs);
  const int32_t* a = static_cast<const int32_t*>(anchors);
  const uint8_t* c = static_cast<const uint8_t*>(blocks);
  float* o = static_cast<float*>(out);
  if (nibbles) {
    adjacency_dot_kernel<true><<<grid, block, smem, s>>>(q, a, c, o, P, CR, D, N, T);
  } else {
    adjacency_dot_kernel<false><<<grid, block, smem, s>>>(q, a, c, o, P, CR, D, N, T);
  }
  return static_cast<int>(cudaGetLastError());
}
