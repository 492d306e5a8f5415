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
// What bounds it: one read of the pixels it needs and one write of the
// (L, H, W) float32 map.  On the main path, with the live level sizes, that
// is 3.8 MB of live pixels in and 9.8 MB out, 4.07 us at 3.35 TB/s (the
// whole array, without them, 9.8 MB each way, 5.87 us).
// On a textured image the arithmetic costs more than that: many live
// pixels of the main path's texture are corners, and each needs the full
// 16-position ring.  The design cuts instructions:
//   * one block of 4 warps per (level, 32 x 32 output tile) stages the tile
//     plus a 4-pixel halo in shared memory.  Interior tiles copy it in
//     16-byte pieces with no index arithmetic; only tiles within 4 px of
//     the array edge wrap;
//   * exact early rejection: any 9 consecutive ring positions cover 4
//     consecutive even positions (0, 2, .., 14, cyclically).  fl(v - c) is
//     monotone in v, so "4 consecutive evens all bright" is
//     fl(min of the 4 - c) > weak, and "some such run" takes the max of the
//     window minima: a pixel failing that, and its dark mirror, scores 0.
//     On the main path's texture it rejects many more than that.  Each
//     thread tests a vertical run of 4 pixels, reusing its column loads from
//     registers (34 loads for 4 pixels), and the survivors are compacted
//     into a per-block list (warp ballots, one shared atomic a warp), so the
//     full 16-pixel ring runs on full warps;
//   * the circular run-of-9 test is four and-shift steps (doubling);
//   * optional padding skip: given the live (h, w) of every level, a tile
//     whose wrapped 4-px window holds no live pixel writes zeros and reads
//     nothing.  The pyramid is zero there, FAST on a flat zero field scores
//     0 and NMS keeps 0, so the output equals the whole-array plain version.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int TH = 32, TW = 32;     // output tile
constexpr int HALO = 4;             // ring radius 3 + 1 NMS pixel
constexpr int SH = TH + 2 * HALO;   // staged window rows (40)
constexpr int SW = TW + 2 * HALO;   // staged window columns (40, 16-byte rows)
constexpr int CH = TH + 2, CW = TW + 2;  // pre-NMS score region (34 x 34)
constexpr int CWP = CW + 2;         // its row stride (16-byte rows)
constexpr int RUN = 4;              // pixels per thread in the pre-test
constexpr int RUNS = (CH + RUN - 1) / RUN;  // 9 runs per score column
constexpr int THREADS = 128;

// Ring position p (orb.py _FAST_RING): dy = 0,1,2,3,3,3,2,1,0,-1,-2,-3,-3,-3,-2,-1
// and dx(p) = dy(p + 4).
__host__ __device__ constexpr int ring_dy(int p) {
  return ((p & 15) < 8 ? 1 : -1) *
         ((p & 7) < 8 - (p & 7) ? ((p & 7) < 3 ? (p & 7) : 3) : (8 - (p & 7) < 3 ? 8 - (p & 7) : 3));
}
__host__ __device__ constexpr int ring_dx(int p) { return ring_dy(p + 4); }
static_assert(ring_dy(0) == 0 && ring_dy(3) == 3 && ring_dy(5) == 3 && ring_dy(7) == 1 &&
                  ring_dy(11) == -3 && ring_dy(15) == -1 && ring_dx(0) == 3 && ring_dx(7) == -3 &&
                  ring_dx(12) == 0 && ring_dx(15) == 3,
              "ring table");

__device__ __forceinline__ int wrap(int v, int n) {
  int r = v % n;
  return r < 0 ? r + n : r;
}

// a circular run of >= 9 set bits in a 16-bit mask, by doubling
__device__ __forceinline__ bool has_run9(uint32_t m16) {
  const uint32_t m = m16 | (m16 << 16);
  const uint32_t a = m & (m >> 1);  // runs of 2 start here
  const uint32_t b = a & (a >> 2);  // 4
  const uint32_t c = b & (b >> 4);  // 8
  return (c & (m >> 8)) != 0u;      // 9
}

// The exact pre-test on the even ring positions 0, 2, .., 14 (e[0..7]): is
// there a cyclic run of 4 all bright, or 4 all dark, at the weak threshold?
// fl(v - c) is monotone in v, so "all of a window bright" is
// fl(min(window) - c) > weak, and "some window" takes the max of the mins.
__device__ __forceinline__ bool even_pretest(const float (&e)[8], float c, float weak_th) {
  float lo[8], hi[8];
#pragma unroll
  for (int q = 0; q < 8; ++q) {
    lo[q] = fminf(e[q], e[(q + 1) & 7]);
    hi[q] = fmaxf(e[q], e[(q + 1) & 7]);
  }
  float best_lo = -INFINITY, best_hi = INFINITY;
#pragma unroll
  for (int q = 0; q < 8; ++q) {
    best_lo = fmaxf(best_lo, fminf(lo[q], lo[(q + 2) & 7]));
    best_hi = fminf(best_hi, fmaxf(hi[q], hi[(q + 2) & 7]));
  }
  return (best_lo - c > weak_th) || (best_hi - c < -weak_th);
}

// Full pre-NMS score of the pixel staged at *s (row stride SW).  With
// weak_th >= 0 (the wrapper's check) no ring pixel is both bright and dark,
// so a pixel cannot hold a bright and a dark weak run (9 + 9 > 16), and
// only the side of its weak run is tested at the strict threshold: if
// strict_th >= weak_th, a strict run on the other side would also be a weak
// run there; if strict_th < weak_th, the weak run is itself a strict run.
__device__ __forceinline__ float fast_score(const float* s, float strict_th, float weak_th) {
  const float c = s[0];
  float d[16];
  uint32_t bw = 0, dw = 0;
  float sb = 0.0f, sd = 0.0f;
#pragma unroll
  for (int p = 0; p < 16; ++p) {
    d[p] = s[ring_dy(p) * SW + ring_dx(p)] - c;
    const float excess = fabsf(d[p]) - weak_th;
    if (d[p] > weak_th) { bw |= 1u << p; sb = sb + excess; }
    if (d[p] < -weak_th) { dw |= 1u << p; sd = sd + excess; }
  }
  const bool bright = has_run9(bw);
  if (!(bright || has_run9(dw))) return 0.0f;
  uint32_t strict = 0;
#pragma unroll
  for (int p = 0; p < 16; ++p) strict |= static_cast<uint32_t>((bright ? d[p] : -d[p]) > strict_th) << p;
  return fmaxf(sb, sd) + (has_run9(strict) ? 1e6f : 0.0f);
}

// Write four outputs starting at column gx of row gy, vector or scalar.
__device__ __forceinline__ void store4(float* dst, int gy, int gx, int W, bool vec, float4 v) {
  float* p = dst + (size_t)gy * W + gx;
  if (vec) {
    *reinterpret_cast<float4*>(p) = v;
  } else {
    if (gx < W) p[0] = v.x;
    if (gx + 1 < W) p[1] = v.y;
    if (gx + 2 < W) p[2] = v.z;
    if (gx + 3 < W) p[3] = v.w;
  }
}

__global__ void __launch_bounds__(THREADS, 8) fast_nms_kernel(
    const float* __restrict__ pyr, float* __restrict__ out, int H, int W, float strict_th,
    float weak_th, const int32_t* __restrict__ live_dims) {
  // two spare rows: the last pre-test run reads past the 40 staged rows
  // for pixels it then masks
  __shared__ __align__(16) float s_img[SH + 2][SW];
  __shared__ __align__(16) float s_sc[CH][CWP];
  __shared__ uint16_t s_list[CH * CW];
  __shared__ int s_n;

  const int lvl = blockIdx.z;
  const int y0 = blockIdx.y * TH;
  const int x0 = blockIdx.x * TW;
  const float* img = pyr + (size_t)lvl * H * W;
  float* dst = out + (size_t)lvl * H * W;
  const int tid = threadIdx.x;
  const bool vec_out = (W % 4 == 0) && (x0 + TW <= W);

  if (live_dims != nullptr) {
    const int h = live_dims[2 * lvl], w = live_dims[2 * lvl + 1];
    const bool rows_live = (y0 - HALO < h) || (y0 + TH + HALO > H);
    const bool cols_live = (x0 - HALO < w) || (x0 + TW + HALO > W);
    if (!(rows_live && cols_live)) {
      const float4 z = make_float4(0.f, 0.f, 0.f, 0.f);
      for (int i = tid; i < TH * (TW / 4); i += THREADS) {
        const int gy = y0 + i / (TW / 4);
        if (gy < H) store4(dst, gy, x0 + 4 * (i % (TW / 4)), W, vec_out, z);
      }
      return;
    }
  }

  // --- stage the window: image rows y0-4 .. y0+35, columns x0-4 .. x0+35 ---
  if (tid == 0) s_n = 0;
  const bool interior = (W % 4 == 0) && y0 >= HALO && y0 + TH + HALO <= H && x0 >= HALO &&
                        x0 + TW + HALO <= W;
  if (interior) {
    const float* src = img + (size_t)(y0 - HALO) * W + (x0 - HALO);
    for (int i = tid; i < SH * (SW / 4); i += THREADS) {
      const int sy = i / (SW / 4), q = i % (SW / 4);
      *reinterpret_cast<float4*>(&s_img[sy][4 * q]) =
          __ldg(reinterpret_cast<const float4*>(src + (size_t)sy * W) + q);
    }
  } else {
    for (int i = tid; i < SH * SW; i += THREADS) {
      const int sy = i / SW, sx = i % SW;
      s_img[sy][sx] = img[(size_t)wrap(y0 - HALO + sy, H) * W + wrap(x0 - HALO + sx, W)];
    }
  }
  __syncthreads();

  // --- the pre-test on runs of 4 pixels down one score column; score pixel
  // (cy, cx) is image (y0-1+cy, x0-1+cx), staged at (cy+3, cx+3) -----------
  const int lane = tid & 31;
  for (int base = 0; base < CW * RUNS; base += THREADS) {  // uniform trip count
    const int item = base + tid;
    const int cx = item % CW, cy0 = (item / CW) * RUN;
    uint32_t keep = 0;  // bit r: pixel cy0+r goes to the full ring
    if (item < CW * RUNS) {
      const int sx = cx + 3;
      float col[RUN + 6], l2[RUN + 4], r2[RUN + 4], l3[RUN], r3[RUN];
#pragma unroll
      for (int k = 0; k < RUN + 6; ++k) col[k] = s_img[cy0 + k][sx];  // dx 0, dy -3 .. +3
#pragma unroll
      for (int k = 0; k < RUN + 4; ++k) {                              // dx -/+2, dy -2 .. +2
        l2[k] = s_img[cy0 + 1 + k][sx - 2];
        r2[k] = s_img[cy0 + 1 + k][sx + 2];
      }
#pragma unroll
      for (int k = 0; k < RUN; ++k) {                                  // dx -/+3, dy 0
        l3[k] = s_img[cy0 + 3 + k][sx - 3];
        r3[k] = s_img[cy0 + 3 + k][sx + 3];
      }
      const int gx = x0 - 1 + cx;
#pragma unroll
      for (int r = 0; r < RUN; ++r) {
        const int cy = cy0 + r, gy = y0 - 1 + cy;
        if (cy >= CH) continue;
        if (gy < 0 || gy >= H || gx < 0 || gx >= W) {
          s_sc[cy][cx] = -INFINITY;
          continue;
        }
        const float e[8] = {r3[r], r2[r + 4], col[r + 6], l2[r + 4], l3[r], l2[r], col[r], r2[r]};
        if (even_pretest(e, col[r + 3], weak_th)) keep |= 1u << r;
        else s_sc[cy][cx] = 0.0f;
      }
    }
    // append this round's survivors to the block's list, one atomic a warp
    uint32_t ballot[RUN];
    int total = 0;
#pragma unroll
    for (int r = 0; r < RUN; ++r) {
      ballot[r] = __ballot_sync(0xffffffffu, (keep >> r) & 1u);
      total += __popc(ballot[r]);
    }
    if (total > 0) {
      int slot = 0;
      if (lane == 0) slot = atomicAdd(&s_n, total);
      slot = __shfl_sync(0xffffffffu, slot, 0);
      const uint32_t below = (1u << lane) - 1u;
#pragma unroll
      for (int r = 0; r < RUN; ++r) {
        if ((keep >> r) & 1u)
          s_list[slot + __popc(ballot[r] & below)] = static_cast<uint16_t>((cy0 + r) * CW + cx);
        slot += __popc(ballot[r]);
      }
    }
  }
  __syncthreads();

  // --- the full ring on the survivors, on full warps ------------------------
  const int n = s_n;
  for (int j = tid; j < n; j += THREADS) {
    const int cy = s_list[j] / CW, cx = s_list[j] % CW;
    s_sc[cy][cx] = fast_score(&s_img[cy + 3][cx + 3], strict_th, weak_th);
  }
  __syncthreads();

  // --- 3x3 NMS, four outputs a thread, and the write ------------------------
  for (int i = tid; i < TH * (TW / 4); i += THREADS) {
    const int oy = i / (TW / 4), ox = 4 * (i % (TW / 4));
    const int gy = y0 + oy;
    if (gy >= H) continue;
    float v[3][6];
#pragma unroll
    for (int dy = 0; dy < 3; ++dy) {
      const float4 a = *reinterpret_cast<const float4*>(&s_sc[oy + dy][ox]);
      const float2 b = *reinterpret_cast<const float2*>(&s_sc[oy + dy][ox + 4]);
      v[dy][0] = a.x; v[dy][1] = a.y; v[dy][2] = a.z; v[dy][3] = a.w; v[dy][4] = b.x; v[dy][5] = b.y;
    }
    float res[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      float m = -INFINITY;
#pragma unroll
      for (int dy = 0; dy < 3; ++dy)
#pragma unroll
        for (int dx = 0; dx < 3; ++dx) m = fmaxf(m, v[dy][k + dx]);
      const float centre = v[1][k + 1];
      res[k] = centre >= m ? centre : 0.0f;
    }
    store4(dst, gy, x0 + ox, W, vec_out, make_float4(res[0], res[1], res[2], res[3]));
  }
}

}  // namespace

// pyr, out: contiguous (L, H, W) float32 on the device.  live_dims: null, or
// a contiguous (L, 2) int32 array of each level's live (h, w), outside which
// the caller guarantees the pyramid is zero.  Returns cudaError_t.
extern "C" int fast_nms_launch(const void* pyr, void* out, int L, int H, int W, float strict_th,
                               float weak_th, const void* live_dims, void* stream) {
  dim3 grid((W + TW - 1) / TW, (H + TH - 1) / TH, L);
  fast_nms_kernel<<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(pyr), static_cast<float*>(out), H, W, strict_th, weak_th,
      static_cast<const int32_t*>(live_dims));
  return static_cast<int>(cudaGetLastError());
}
