// Hamming nearest + second-nearest search over packed 256-bit descriptors,
// for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel tpuslam/kernels/pallas_match.py:_kernel
// (called through hamming_top2).  Semantics are those of the reference's
// dense CPU path, pallas_match._dense_top2, which the port's plain version
// tpuslam_torch/kernels/cuda_match.py:hamming_top2_plain mirrors:
//   dist[j] = popcount(a ^ b[j]) if valid_b[j] else 1e9;
//   idx = first argmin (the lower index wins ties, like jnp.argmin);
//   d1 = dist[idx];  d2 = min over j != idx of dist[j], capped at 1e9, so a
//   tied minimum surfaces as d2 == d1.
// Distances are returned as float32, as the reference returns them.
//
// What bounds it: N*M*8 XOR+popcount pairs (8.4 M at the main path's
// 1024 x 1024) against N*32 + M*33 bytes in: at these sizes it is
// launch- and latency-bound, not compute- or memory-bound.
// Design: one warp per query row, eight rows per block.  The block streams
// B through shared memory in tiles of 256 columns, stored word-major so the
// lanes of a warp read consecutive columns without bank conflicts.  Each
// lane folds its columns, in ascending order, into a running (best, index,
// second); the warp then merges the 32 partial results with shuffles, the
// lower index winning a tie.  Nothing goes through device memory but the
// inputs and the three outputs.

#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int WARPS = 8;
constexpr int TILE_M = 256;
constexpr int PAD = 4;  // word-major rows offset by 4 banks: conflict-free stores
constexpr float BIG = 1e9f;

__global__ void __launch_bounds__(WARPS * 32) hamming_top2_kernel(
    const uint32_t* __restrict__ a, const uint32_t* __restrict__ b,
    const uint8_t* __restrict__ valid_b, int N, int M, int32_t* __restrict__ idx_out,
    float* __restrict__ d1_out, float* __restrict__ d2_out) {
  __shared__ uint32_t s_b[8][TILE_M + PAD];
  __shared__ uint8_t s_valid[TILE_M];
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int row = blockIdx.x * WARPS + warp;
  const bool live = row < N;

  uint32_t q[8];
#pragma unroll
  for (int w = 0; w < 8; ++w) q[w] = live ? a[(size_t)row * 8 + w] : 0u;

  float best = INFINITY, second = INFINITY;
  int best_idx = INT_MAX;
  for (int t0 = 0; t0 < M; t0 += TILE_M) {
    const int cols = min(TILE_M, M - t0);
    __syncthreads();  // the previous tile has been read by every warp
    for (int i = threadIdx.x; i < cols * 8; i += blockDim.x)
      s_b[i % 8][i / 8] = b[(size_t)t0 * 8 + i];
    for (int c = threadIdx.x; c < cols; c += blockDim.x) s_valid[c] = valid_b[t0 + c];
    __syncthreads();
    if (live) {
      for (int c = lane; c < cols; c += 32) {
        int ham = 0;
#pragma unroll
        for (int w = 0; w < 8; ++w) ham += __popc(q[w] ^ s_b[w][c]);
        const float d = s_valid[c] ? static_cast<float>(ham) : BIG;
        if (d < best) {
          second = best;
          best = d;
          best_idx = t0 + c;
        } else if (d < second) {
          second = d;
        }
      }
    }
  }

  // merge the lanes' partial results; the lower column index wins a tie
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const float o_best = __shfl_down_sync(0xffffffffu, best, off);
    const float o_second = __shfl_down_sync(0xffffffffu, second, off);
    const int o_idx = __shfl_down_sync(0xffffffffu, best_idx, off);
    if (o_best < best || (o_best == best && o_idx < best_idx)) {
      second = fminf(o_second, best);
      best = o_best;
      best_idx = o_idx;
    } else {
      second = fminf(second, o_best);
    }
  }
  if (live && lane == 0) {
    idx_out[row] = best_idx;
    d1_out[row] = best;
    d2_out[row] = fminf(second, BIG);
  }
}

}  // namespace

// a: (N, 8), b: (M, 8) contiguous 32-bit words; valid_b: (M,) bytes (torch.bool);
// outputs (N,) int32 / float32 / float32.  Requires M >= 1.  Returns cudaError_t.
extern "C" int hamming_top2_launch(const void* a, const void* b, const void* valid_b, int N,
                                   int M, void* idx, void* d1, void* d2, void* stream) {
  const int blocks = (N + WARPS - 1) / WARPS;
  hamming_top2_kernel<<<blocks, WARPS * 32, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(a), static_cast<const uint32_t*>(b),
      static_cast<const uint8_t*>(valid_b), N, M, static_cast<int32_t*>(idx),
      static_cast<float*>(d1), static_cast<float*>(d2));
  return static_cast<int>(cudaGetLastError());
}
