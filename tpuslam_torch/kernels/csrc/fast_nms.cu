// Fused dense FAST-9 score + 3x3 non-maximum suppression for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel tpuslam/kernels/pallas_fast.py:
// _fast_nms_kernel (called through fast_nms_score).  Semantics are those of
// the port's plain version, tpuslam_torch/kernels/orb.py:fast_nms_plain
// (= the reference's orb.fast_response + orb._nms3) on EVERY pixel:
//   * the 16-pixel Bresenham ring wraps in both y and x (jnp.roll);
//   * a pixel is a corner at threshold th iff >= 9 circularly consecutive ring
//     pixels are all brighter (diff > th) or all darker (diff < -th);
//   * score = max(sum of bright excess, sum of dark excess) at the weak
//     threshold, summed in ring order, +1e6 iff also a strict-threshold
//     corner, 0 if not a weak corner;
//   * NMS keeps the score iff it is >= the max of its 3x3 neighbourhood,
//     with neighbours outside the image treated as -inf.
//
// What bounds it: one read and one write of the (L, H, W) float32 pyramid
// (8 x 480 x 640 = 9.8 MB each way on the main path), so it is memory- and
// launch-bound; the arithmetic is ~100 simple ops per pixel.
// Design: one block per (level, 32x32 output tile).  The block stages its
// tile plus a 4-pixel halo (ring radius 3 + 1 NMS pixel) in shared memory
// with wrap-around indices, computes the pre-NMS score of the tile plus its
// 1-pixel NMS ring into shared memory, syncs, and writes the suppressed
// tile.  Global reads and writes are row-contiguous across the threads of a
// warp.  The halo re-read costs (40*40)/(32*32) = 1.56x of the input bytes.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int TILE = 32;
constexpr int HALO = 4;
constexpr int SW = TILE + 2 * HALO;  // staged image tile width (40)
constexpr int SC = TILE + 2;         // pre-NMS score tile width (34)

// (dy, dx) of the ring, in the order of orb.py _FAST_RING
__constant__ int RING_DY[16] = {0, 1, 2, 3, 3, 3, 2, 1, 0, -1, -2, -3, -3, -3, -2, -1};
__constant__ int RING_DX[16] = {3, 3, 2, 1, 0, -1, -2, -3, -3, -3, -2, -1, 0, 1, 2, 3};

__device__ __forceinline__ int wrap(int v, int n) {
  int r = v % n;
  return r < 0 ? r + n : r;
}

__device__ __forceinline__ bool has_run9(uint32_t m16) {
  uint32_t m = m16 | (m16 << 16);
  uint32_t acc = m;
#pragma unroll
  for (int k = 1; k < 9; ++k) acc &= m >> k;
  return acc != 0u;
}

// Pre-NMS score of the pixel staged at img[sy][sx].
__device__ __forceinline__ float fast_score(float (*img)[SW + 1], int sy, int sx,
                                            float strict_th, float weak_th) {
  const float c = img[sy][sx];
  uint32_t bw = 0, dw = 0, bs = 0, ds = 0;
  float sb = 0.0f, sd = 0.0f;
#pragma unroll
  for (int p = 0; p < 16; ++p) {
    const float d = img[sy + RING_DY[p]][sx + RING_DX[p]] - c;
    const float excess = fabsf(d) - weak_th;
    if (d > weak_th) { bw |= 1u << p; sb = sb + excess; }
    if (d < -weak_th) { dw |= 1u << p; sd = sd + excess; }
    if (d > strict_th) bs |= 1u << p;
    if (d < -strict_th) ds |= 1u << p;
  }
  if (!(has_run9(bw) || has_run9(dw))) return 0.0f;
  const float bonus = (has_run9(bs) || has_run9(ds)) ? 1e6f : 0.0f;
  return fmaxf(sb, sd) + bonus;
}

__global__ void __launch_bounds__(256) fast_nms_kernel(const float* __restrict__ pyr,
                                                       float* __restrict__ out, int H, int W,
                                                       float strict_th, float weak_th) {
  __shared__ float s_img[SW][SW + 1];
  __shared__ float s_sc[SC][SC + 1];
  const int lvl = blockIdx.z;
  const int y0 = blockIdx.y * TILE;
  const int x0 = blockIdx.x * TILE;
  const float* img = pyr + (size_t)lvl * H * W;
  float* dst = out + (size_t)lvl * H * W;
  const int tid = threadIdx.x;
  const int nth = blockDim.x;

  for (int i = tid; i < SW * SW; i += nth) {
    const int sy = i / SW, sx = i % SW;
    const int gy = wrap(y0 - HALO + sy, H), gx = wrap(x0 - HALO + sx, W);
    s_img[sy][sx] = img[(size_t)gy * W + gx];
  }
  __syncthreads();

  // score tile covers image rows y0-1 .. y0+TILE, staged at s_img row +3
  for (int i = tid; i < SC * SC; i += nth) {
    const int cy = i / SC, cx = i % SC;
    const int gy = y0 - 1 + cy, gx = x0 - 1 + cx;
    float s = -INFINITY;
    if (gy >= 0 && gy < H && gx >= 0 && gx < W)
      s = fast_score(s_img, cy + HALO - 1, cx + HALO - 1, strict_th, weak_th);
    s_sc[cy][cx] = s;
  }
  __syncthreads();

  for (int i = tid; i < TILE * TILE; i += nth) {
    const int oy = i / TILE, ox = i % TILE;
    const int gy = y0 + oy, gx = x0 + ox;
    if (gy >= H || gx >= W) continue;
    const float centre = s_sc[oy + 1][ox + 1];
    float m = -INFINITY;
#pragma unroll
    for (int dy = 0; dy < 3; ++dy)
#pragma unroll
      for (int dx = 0; dx < 3; ++dx) m = fmaxf(m, s_sc[oy + dy][ox + dx]);
    dst[(size_t)gy * W + gx] = centre >= m ? centre : 0.0f;
  }
}

}  // namespace

// pyr, out: contiguous (L, H, W) float32 on the device.  Returns cudaError_t.
extern "C" int fast_nms_launch(const void* pyr, void* out, int L, int H, int W,
                               float strict_th, float weak_th, void* stream) {
  dim3 grid((W + TILE - 1) / TILE, (H + TILE - 1) / TILE, L);
  fast_nms_kernel<<<grid, 256, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(pyr), static_cast<float*>(out), H, W, strict_th, weak_th);
  return static_cast<int>(cudaGetLastError());
}
