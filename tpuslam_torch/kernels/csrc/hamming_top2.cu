// Hamming nearest + second-nearest search over packed 256-bit descriptors,
// for Hopper (sm_90a), on the int8 tensor cores.
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
// What bounds it: 2*N*M*256 int8 operations (0.54 G at the main path's
// 1024 x 1024, 0.27 us at 1,979 TOP/s) against N*32 + M*33 bytes in.  At
// these sizes the time is latency: the kernel is a few dependent steps long
// and each must be short.  Design, the TPU kernel's algebra on Hopper's
// tensor cores:
//   * bits become +-1 int8, so dot(a, b) = 256 - 2 * ham exactly, computed
//     by mma.sync m16n8k32 s8 x s8 -> s32; one 32-bit descriptor word is one
//     k-step, and bit 4q+j of a word is byte j of fragment register q, so a
//     lane expands the two nibbles it needs straight into its fragment
//     registers: no unpacked copy in shared memory, no barrier in the loop;
//   * a block owns 16 query rows (one m16 tile) and one of 4 column slices;
//     the 4 slices of a row tile form a thread block cluster.  N = M = 1024
//     gives 256 blocks of 8 warps on 132 SMs.  A warp takes 32 columns at a
//     time, loading each column's 32 bytes with two 16-byte loads;
//   * each lane folds its accumulator fragment into running (best, idx,
//     second) for its two rows, in ascending column order, in registers;
//     the triples are merged across the 4 lanes of a row and then across
//     the 8 warps (shuffles), and each block pushes its 16 triples into the
//     shared memory of the cluster's first block, which merges them in
//     slice order after one cluster barrier.  Every merge takes the lower
//     index on equal distance, so the result does not depend on the order;
//     no atomics.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int WARPS = 8;
constexpr int THREADS = WARPS * 32;
constexpr int BM = 16;          // query rows per block (one m16 tile)
constexpr int CHUNK = 32;       // columns a warp takes at a time (4 n8 tiles)
constexpr int SPLIT = 4;        // column slices = blocks per cluster
constexpr int KW = 8;           // 32-bit words per descriptor = k-steps
constexpr int BIG = 1000000000;   // cost of an invalid column
constexpr int NONE = INT_MAX;     // no column (padding, empty slice)

struct Top2 {
  int best, idx, second;
};

// Fold the triple of a disjoint column set y into x; the lower index wins
// equal distances, so the result is the same in any order.
__device__ __forceinline__ void merge(Top2& x, const Top2& y) {
  if (y.best < x.best || (y.best == x.best && y.idx < x.idx)) {
    x.second = min(y.second, x.best);
    x.best = y.best;
    x.idx = y.idx;
  } else {
    x.second = min(x.second, y.best);
  }
}

// Fold one column, visited in ascending order.
__device__ __forceinline__ void fold(Top2& x, int d, int col) {
  if (d < x.best) {
    x.second = x.best;
    x.best = d;
    x.idx = col;
  } else if (d < x.second) {
    x.second = d;
  }
}

__device__ __forceinline__ void merge_xor(Top2& x, int mask) {
  const Top2 y{__shfl_xor_sync(0xffffffffu, x.best, mask), __shfl_xor_sync(0xffffffffu, x.idx, mask),
               __shfl_xor_sync(0xffffffffu, x.second, mask)};
  merge(x, y);
}

// Four bits -> four bytes, +1 for a set bit and -1 (0xFF) for a clear one.
__device__ __forceinline__ uint32_t pm1(uint32_t nibble) {
  const uint32_t s = (nibble * 0x00204081u) & 0x01010101u;  // bit j -> bit 0 of byte j
  return ~(s * 0xFEu);
}

// Fragment registers of k-step w from a packed word: nibble t, nibble t + 4.
__device__ __forceinline__ uint32_t lo_frag(uint32_t word, int t) { return pm1((word >> (4 * t)) & 15u); }
__device__ __forceinline__ uint32_t hi_frag(uint32_t word, int t) { return pm1((word >> (16 + 4 * t)) & 15u); }

// The 8 words of a descriptor, two 16-byte loads (zeros past the end).
__device__ __forceinline__ void load_desc(const uint32_t* __restrict__ p, bool ok, uint32_t (&w)[KW]) {
  uint4 u0 = make_uint4(0u, 0u, 0u, 0u), u1 = u0;
  if (ok) {
    u0 = __ldg(reinterpret_cast<const uint4*>(p));
    u1 = __ldg(reinterpret_cast<const uint4*>(p) + 1);
  }
  w[0] = u0.x; w[1] = u0.y; w[2] = u0.z; w[3] = u0.w;
  w[4] = u1.x; w[5] = u1.y; w[6] = u1.z; w[7] = u1.w;
}

__device__ __forceinline__ void mma_s8(int (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                       uint32_t b1) {
  asm("mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__global__ void __cluster_dims__(SPLIT, 1, 1) __launch_bounds__(THREADS) hamming_top2_kernel(
    const uint32_t* __restrict__ a, const uint32_t* __restrict__ b,
    const uint8_t* __restrict__ valid_b, int N, int M, int slice, int32_t* __restrict__ idx_out,
    float* __restrict__ d1_out, float* __restrict__ d2_out) {
  __shared__ Top2 s_warp[WARPS][BM];
  __shared__ Top2 s_slice[SPLIT][BM];  // filled in the cluster's first block
  // announce that this block runs; its pushes below wait for the others
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::);

  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;  // mma group and thread in group
  const int row0 = blockIdx.y * BM;
  const int c_begin = min(M, rank * slice), c_end = min(M, c_begin + slice);

  // A fragments of rows g and g + 8, all 8 k-steps, in registers
  uint32_t af[KW][4];
  {
    uint32_t w0[KW], w1[KW];
    load_desc(a + (size_t)(row0 + g) * KW, row0 + g < N, w0);
    load_desc(a + (size_t)(row0 + g + 8) * KW, row0 + g + 8 < N, w1);
#pragma unroll
    for (int w = 0; w < KW; ++w) {
      af[w][0] = lo_frag(w0[w], t);
      af[w][1] = lo_frag(w1[w], t);
      af[w][2] = hi_frag(w0[w], t);
      af[w][3] = hi_frag(w1[w], t);
    }
  }

  Top2 top[2] = {{NONE, NONE, NONE}, {NONE, NONE, NONE}};  // rows g, g + 8
  for (int cb = c_begin + warp * CHUNK; cb < c_end; cb += WARPS * CHUNK) {
    uint32_t bw[4][KW];  // lane's column cb + 8 nt + g
    int pen[4][2];       // columns cb + 8 nt + 2 t + e: 0 valid, BIG invalid, NONE past the slice
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) {
      const int col = cb + 8 * nt + g;
      load_desc(b + (size_t)col * KW, col < c_end, bw[nt]);
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int c = cb + 8 * nt + 2 * t + e;
        pen[nt][e] = c < c_end ? (valid_b[c] ? 0 : BIG) : NONE;
      }
    }
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) {
      // two independent chains of 4 k-steps, then one sum: shorter latency
      int acc[4] = {0, 0, 0, 0}, acc2[4] = {0, 0, 0, 0};
#pragma unroll
      for (int w = 0; w < KW; w += 2) {
        mma_s8(acc, af[w], lo_frag(bw[nt][w], t), hi_frag(bw[nt][w], t));
        mma_s8(acc2, af[w + 1], lo_frag(bw[nt][w + 1], t), hi_frag(bw[nt][w + 1], t));
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[i] += acc2[i];
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int p = pen[nt][e], col = cb + 8 * nt + 2 * t + e;
        fold(top[0], p == 0 ? (256 - acc[e]) >> 1 : p, col);
        fold(top[1], p == 0 ? (256 - acc[2 + e]) >> 1 : p, col);
      }
    }
  }

  // the 4 lanes of a row (shuffles), then the 8 warps (shared memory and
  // shuffles), then the cluster's blocks
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    merge_xor(top[r], 1);
    merge_xor(top[r], 2);
  }
  if (t == 0) {
    s_warp[warp][g] = top[0];
    s_warp[warp][g + 8] = top[1];
  }
  __syncthreads();
  static_assert(BM * WARPS == 4 * 32, "the warp merge uses the first 4 warps");
  if (tid < BM * WARPS) {
    const int row = tid / WARPS, wp = tid % WARPS;
    Top2 x = s_warp[wp][row];
#pragma unroll
    for (int m = 1; m < WARPS; m <<= 1) merge_xor(x, m);
    asm volatile("barrier.cluster.wait.aligned;\n" ::);  // every block of the cluster runs
    if (wp == 0) cluster.map_shared_rank(&s_slice[0][0], 0)[rank * BM + row] = x;
  } else {
    asm volatile("barrier.cluster.wait.aligned;\n" ::);
  }
  cluster.sync();  // the pushes are in
  if (rank == 0 && tid < BM) {
    Top2 x = s_slice[0][tid];
#pragma unroll
    for (int r = 1; r < SPLIT; ++r) merge(x, s_slice[r][tid]);
    const int row = row0 + tid;
    if (row < N) {
      idx_out[row] = x.idx;
      d1_out[row] = static_cast<float>(x.best);
      d2_out[row] = static_cast<float>(min(x.second, BIG));
    }
  }
}

}  // namespace

// a: (N, 8), b: (M, 8) contiguous 32-bit words, both 16-byte aligned; valid_b:
// (M,) bytes (torch.bool); outputs (N,) int32 / float32 / float32.  Requires
// M >= 1 and N <= BM * 65535.  Returns cudaError_t.
extern "C" int hamming_top2_launch(const void* a, const void* b, const void* valid_b, int N,
                                   int M, void* idx, void* d1, void* d2, void* stream) {
  const int slice = (M + SPLIT - 1) / SPLIT;
  dim3 grid(SPLIT, (N + BM - 1) / BM);
  hamming_top2_kernel<<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(a), static_cast<const uint32_t*>(b),
      static_cast<const uint8_t*>(valid_b), N, M, slice, static_cast<int32_t*>(idx),
      static_cast<float*>(d1), static_cast<float*>(d2));
  return static_cast<int>(cudaGetLastError());
}
