// Motion-only pose Levenberg-Marquardt (PoseOptimization, Optimizer.cc:
// 247-459) in one launch, for Hopper (sm_90a).
//
// Replaces no TPU kernel: the JAX package leaves the pose LM to XLA
// (tpuslam/graph/lm.py:optimize_pose).  The port's plain version,
// tpuslam_torch/graph/lm.py:_optimize_pose_body, issues ~8,443 small kernels
// a call; replayed as one CUDA graph they still paced the call, ~1.3 us a
// node: ~11 device ms and ~4.6 host ms of cudaGraphLaunch, three calls a
// tracked frame.  This kernel computes what that body computes:
//   * T = se3_renorm(T_init); residuals (u, v, u_right) and the analytic
//     stereo Jacobian, the third row only where ur >= 0;
//   * rounds of LM iterations, Huber-robustified (weights and rho) in
//     rounds 0-1, on the damped system H + lam diag(H) + 1e-6 I; a step is
//     taken iff rho_new < rho_cur with the pose and the step finite; lam
//     x0.3 (down to 1e-7) on an accepted step, x8 (up to 1e4) otherwise;
//   * inliers re-classified between rounds and at the end: valid and
//     chi2 <= chi2_th, or chi2_th_stereo on rows with ur >= 0.
// The body freezes a round's iterations once an accepted step is <= 1e-6;
// here the round ends then, with the same result.
//
// What bounds it: ~250 flops an observation an iteration, ~10 MFLOP a call at
// N = 1024 (0.15 us at 67 TFLOP/s fp32), ~31 KB in and out (0.01 us at
// 3.35 TB/s).  Neither: the time is the latency of 4 rounds x 10 dependent
// iterations, each a pass over the observations, a block-wide sum, a 6x6
// solve and an SE3 exponential.  Design, to keep each iteration short:
//   * one thread block per call; the observations are strided over its
//     threads, each thread always the same ones, so an observation's inlier
//     flag lives in the output mask, read and written by its thread alone;
//   * one pass per iteration: at the trial pose a thread computes the
//     residual, the cost and the linearization (J^T W J, J^T W r) together;
//     an accepted step keeps that system for the next iteration and a
//     rejected one keeps the old.  So one block-wide sum per iteration, of
//     21 + 6 + 1 values (and one at each round's start, at the new inliers);
//   * the sum: a butterfly reduce-scatter inside each warp (31 shuffles
//     leave lane l with the warp's sum of value l), one shared-memory row a
//     warp, one barrier, then lane l of every warp adds the rows in warp
//     order and shuffles the totals to its warp.  The rows are double
//     buffered, so one barrier a sum is enough.  The order is fixed and
//     there are no atomics: one input gives the same bits on every run;
//   * every thread then solves the damped system (LDL^T) and forms the trial
//     pose itself, from the same totals with the same instructions, so the
//     pose needs no broadcast and no second barrier.

#include <cuda_runtime.h>

namespace {

// 512 threads, 2 observations each at N = 1024: 0.14 ms a call on the
// main path's rows against 0.17 with 256 and 0.21 with 128 (H100)
constexpr int THREADS = 512;
constexpr int WARPS = THREADS / 32;
constexpr int NV = 32;  // summed values: 21 of H (upper), 6 of J^T W r, rho, 4 unused
constexpr int G = 21;   // first entry of J^T W r
constexpr int RHO = 27;
constexpr unsigned FULL = 0xffffffffu;

struct Args {
  const float* T_init;      // (4, 4)
  const float* points;      // (N, 3)
  const float* uv;          // (N, 2)
  const float* inv_sigma2;  // (N,)
  const bool* valid;        // (N,)
  const float* ur;          // (N,), or null: no stereo row
  int n, rounds, iters;
  float fx, fy, cx, cy, bf, chi2_th, chi2_th_stereo;
  float* T_out;             // (4, 4)
  bool* inlier;             // (N,): the working inlier flags, then the result
  int* n_inliers;           // ()
};

struct Pose {
  float R[9], t[3];
};

// One observation at a pose: the camera point, the clamped depth, the
// residual (third row 0 without a right-view coordinate) and chi2 with its
// threshold (stereo_residual, lm._optimize_pose_body's chi2_of / chi2_lim).
struct Proj {
  float px, py, pz, z, live, r[3], chi2, lim;
  bool stereo;
};

template <bool STEREO>
__device__ __forceinline__ Proj project(const Pose& T, const Args& a, int i) {
  Proj o;
  const float X0 = a.points[3 * i], X1 = a.points[3 * i + 1], X2 = a.points[3 * i + 2];
  o.px = T.R[0] * X0 + T.R[1] * X1 + T.R[2] * X2 + T.t[0];
  o.py = T.R[3] * X0 + T.R[4] * X1 + T.R[5] * X2 + T.t[1];
  o.pz = T.R[6] * X0 + T.R[7] * X1 + T.R[8] * X2 + T.t[2];
  const bool shallow = fabsf(o.pz) < 1e-6f;
  o.z = shallow ? 1e-6f : o.pz;
  o.live = shallow ? 0.f : 1.f;
  const float u = a.fx * o.px / o.z + a.cx;
  const float v = a.fy * o.py / o.z + a.cy;
  o.r[0] = u - a.uv[2 * i];
  o.r[1] = v - a.uv[2 * i + 1];
  o.r[2] = 0.f;
  o.stereo = false;
  if (STEREO) {
    const float ur = a.ur[i];
    o.stereo = ur >= 0.f;
    if (o.stereo) o.r[2] = (u - a.bf / o.z) - ur;
  }
  o.chi2 = (o.r[0] * o.r[0] + o.r[1] * o.r[1] + o.r[2] * o.r[2]) * a.inv_sigma2[i];
  o.lim = o.stereo ? a.chi2_th_stereo : a.chi2_th;
  return o;
}

// factors.huber_weight and lm._rho_huber; the clamps pass a NaN through, as torch.clamp does
__device__ __forceinline__ float huber_weight(float chi2, float d2) {
  return chi2 <= d2 ? 1.f : sqrtf(d2 / (chi2 < 1e-12f ? 1e-12f : chi2));
}

__device__ __forceinline__ float huber_rho(float chi2, float d2) {
  return chi2 <= d2 ? chi2 : 2.f * sqrtf(d2 * (chi2 < 0.f ? 0.f : chi2)) - d2;
}

// One Jacobian row J (1 x 6) with weight w and residual r into the sums.
__device__ __forceinline__ void add_row(float (&s)[NV], const float (&J)[6], float w, float r) {
  float wJ[6];
#pragma unroll
  for (int p = 0; p < 6; ++p) wJ[p] = J[p] * w;
  int k = 0;
#pragma unroll
  for (int p = 0; p < 6; ++p)
#pragma unroll
    for (int q = p; q < 6; ++q) s[k++] += wJ[p] * J[q];
#pragma unroll
  for (int p = 0; p < 6; ++p) s[G + p] += wJ[p] * r;
}

// factors.stereo_jacobian: d r / d p (rows du, dv, du + d(-bf / z)) times
// d p / d [omega, upsilon] = [-[p]x, I], written out.
template <bool STEREO>
__device__ __forceinline__ void linearize(const Proj& o, const Args& a, float w, float (&s)[NV]) {
  const float iz = 1.f / o.z;
  const float A = a.fx * iz, B = a.fy * iz;
  const float C = -a.fx * o.px * iz * iz * o.live;
  const float E = -a.fy * o.py * iz * iz * o.live;
  const float J0[6] = {C * o.py, A * o.pz - C * o.px, -A * o.py, A, 0.f, C};
  const float J1[6] = {-B * o.pz + E * o.py, -E * o.px, B * o.px, 0.f, B, E};
  add_row(s, J0, w, o.r[0]);
  add_row(s, J1, w, o.r[1]);
  if (STEREO && o.stereo) {
    const float F = C + a.bf * iz * iz * o.live;
    const float J2[6] = {F * o.py, A * o.pz - F * o.px, -A * o.py, A, 0.f, F};
    add_row(s, J2, w, o.r[2]);
  }
}

enum Inliers { KEEP, FROM_VALID, RECLASSIFY };

// This thread's share of the system at pose T, over its observations in
// ascending order; FROM_VALID and RECLASSIFY first set the inlier flags.
template <bool STEREO>
__device__ __forceinline__ void system_at(const Pose& T, const Args& a, bool huber, Inliers mode,
                                          float (&s)[NV]) {
#pragma unroll
  for (int k = 0; k < NV; ++k) s[k] = 0.f;
  for (int i = threadIdx.x; i < a.n; i += blockDim.x) {
    const Proj o = project<STEREO>(T, a, i);
    bool in;
    if (mode == KEEP) {
      in = a.inlier[i];
    } else {
      in = a.valid[i] && (mode == FROM_VALID || o.chi2 <= o.lim);
      a.inlier[i] = in;
    }
    const float inl = in ? 1.f : 0.f;
    const float w = (huber ? huber_weight(o.chi2, o.lim) : 1.f) * inl * a.inv_sigma2[i];
    linearize<STEREO>(o, a, w, s);
    s[RHO] += (huber ? huber_rho(o.chi2, o.lim) : o.chi2) * inl;
  }
}

// One butterfly stage: lanes with bit OFF clear keep values [0, OFF) and the
// others [OFF, 2 OFF), renumbered from 0, each summed with its partner's.
template <int OFF>
__device__ __forceinline__ void butterfly(float (&v)[NV], int lane) {
  const bool upper = lane & OFF;
#pragma unroll
  for (int j = 0; j < OFF; ++j) {
    const float send = upper ? v[j] : v[j + OFF];
    const float keep = upper ? v[j + OFF] : v[j];
    v[j] = keep + __shfl_xor_sync(FULL, send, OFF);
  }
}

// v <- the block's sum of v, in every thread, in a fixed order.  ``rows``:
// this sum's buffer, one row per warp; the caller alternates two.
__device__ __forceinline__ void block_sum(float (&v)[NV], float (*rows)[NV]) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, warps = blockDim.x >> 5;
  butterfly<16>(v, lane);
  butterfly<8>(v, lane);
  butterfly<4>(v, lane);
  butterfly<2>(v, lane);
  butterfly<1>(v, lane);
  rows[warp][lane] = v[0];  // the warp's sum of value `lane`
  __syncthreads();
  float total = rows[0][lane];
  for (int w = 1; w < warps; ++w) total += rows[w][lane];
#pragma unroll
  for (int k = 0; k < NV; ++k) v[k] = __shfl_sync(FULL, total, k);
}

// The step of the damped system: (H + lam diag(H) + 1e-6 I) d = -g, by
// LDL^T (the system is symmetric positive definite for finite sums; a bad
// one gives a non-finite step, which the accept test rejects).
__device__ __forceinline__ void solve(const float (&s)[NV], float lam, float (&d)[6]) {
  float A[6][6];
  int k = 0;
#pragma unroll
  for (int p = 0; p < 6; ++p)
#pragma unroll
    for (int q = p; q < 6; ++q) {
      A[p][q] = s[k];
      A[q][p] = s[k];
      ++k;
    }
#pragma unroll
  for (int p = 0; p < 6; ++p) A[p][p] = (A[p][p] + lam * A[p][p]) + 1e-6f;
  float L[6][6], D[6];
#pragma unroll
  for (int j = 0; j < 6; ++j) {
    float dj = A[j][j];
#pragma unroll
    for (int q = 0; q < j; ++q) dj -= L[j][q] * L[j][q] * D[q];
    D[j] = dj;
#pragma unroll
    for (int i = j + 1; i < 6; ++i) {
      float lij = A[i][j];
#pragma unroll
      for (int q = 0; q < j; ++q) lij -= L[i][q] * L[j][q] * D[q];
      L[i][j] = lij / dj;
    }
  }
  float y[6];
#pragma unroll
  for (int i = 0; i < 6; ++i) {
    float yi = -s[G + i];
#pragma unroll
    for (int q = 0; q < i; ++q) yi -= L[i][q] * y[q];
    y[i] = yi;
  }
#pragma unroll
  for (int i = 5; i >= 0; --i) {
    float di = y[i] / D[i];
#pragma unroll
    for (int q = i + 1; q < 6; ++q) di -= L[q][i] * d[q];
    d[i] = di;
  }
}

// factors.retract_pose: se3_exp(d) @ T, d = [omega, upsilon] (geometry.se3_exp).
__device__ __forceinline__ Pose retract(const float (&d)[6], const Pose& T) {
  const float w0 = d[0], w1 = d[1], w2 = d[2];
  const float th2 = w0 * w0 + w1 * w1 + w2 * w2;
  const float th = sqrtf(th2 + 1e-32f);
  float a, b, c;
  if (th2 > 1e-12f) {
    float sn, cs;
    sincosf(th, &sn, &cs);
    a = sn / th;
    b = (1.f - cs) / th2;
    c = (th - sn) / (th2 * th);
  } else {
    a = 1.f - th2 / 6.f;
    b = 0.5f - th2 / 24.f;
    c = 1.f / 6.f - th2 / 120.f;
  }
  const float W[9] = {0.f, -w2, w1, w2, 0.f, -w0, -w1, w0, 0.f};
  float W2[9], E[9], V[9];
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int j = 0; j < 3; ++j)
      W2[3 * i + j] = W[3 * i] * W[j] + W[3 * i + 1] * W[3 + j] + W[3 * i + 2] * W[6 + j];
#pragma unroll
  for (int k = 0; k < 9; ++k) {
    const float eye = (k % 4 == 0) ? 1.f : 0.f;
    E[k] = eye + a * W[k] + b * W2[k];
    V[k] = eye + b * W[k] + c * W2[k];
  }
  Pose out;
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    const float ti = V[3 * i] * d[3] + V[3 * i + 1] * d[4] + V[3 * i + 2] * d[5];
#pragma unroll
    for (int j = 0; j < 3; ++j)
      out.R[3 * i + j] = E[3 * i] * T.R[j] + E[3 * i + 1] * T.R[3 + j] + E[3 * i + 2] * T.R[6 + j];
    out.t[i] = E[3 * i] * T.t[0] + E[3 * i + 1] * T.t[1] + E[3 * i + 2] * T.t[2] + ti;
  }
  return out;
}

__device__ __forceinline__ bool finite_pose(const Pose& T) {
  bool ok = true;
#pragma unroll
  for (int k = 0; k < 9; ++k) ok = ok && isfinite(T.R[k]);
#pragma unroll
  for (int k = 0; k < 3; ++k) ok = ok && isfinite(T.t[k]);
  return ok;
}

// geometry.se3_renorm: the rotation rows by Gram-Schmidt, the third their cross product.
__device__ __forceinline__ Pose renorm(const float* T) {
  float r0[3] = {T[0], T[1], T[2]}, r1[3] = {T[4], T[5], T[6]};
  const float n0 = sqrtf(r0[0] * r0[0] + r0[1] * r0[1] + r0[2] * r0[2]) + 1e-12f;
#pragma unroll
  for (int k = 0; k < 3; ++k) r0[k] /= n0;
  const float dot = r0[0] * r1[0] + r0[1] * r1[1] + r0[2] * r1[2];
#pragma unroll
  for (int k = 0; k < 3; ++k) r1[k] -= dot * r0[k];
  const float n1 = sqrtf(r1[0] * r1[0] + r1[1] * r1[1] + r1[2] * r1[2]) + 1e-12f;
#pragma unroll
  for (int k = 0; k < 3; ++k) r1[k] /= n1;
  Pose P;
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    P.R[k] = r0[k];
    P.R[3 + k] = r1[k];
  }
  P.R[6] = r0[1] * r1[2] - r0[2] * r1[1];
  P.R[7] = r0[2] * r1[0] - r0[0] * r1[2];
  P.R[8] = r0[0] * r1[1] - r0[1] * r1[0];
  P.t[0] = T[3];
  P.t[1] = T[7];
  P.t[2] = T[11];
  return P;
}

template <bool STEREO>
__global__ void __launch_bounds__(THREADS) pose_lm_kernel(const Args a) {
  __shared__ float rows[2][WARPS][NV];
  __shared__ int warp_inliers[WARPS];
  Pose T = renorm(a.T_init);
  float S[NV];  // the system at T, summed over the block
  int buf = 0;
  for (int rnd = 0; rnd < a.rounds; ++rnd) {
    const bool huber = rnd < 2;
    system_at<STEREO>(T, a, huber, rnd == 0 ? FROM_VALID : RECLASSIFY, S);
    block_sum(S, rows[buf]);
    buf ^= 1;
    float lam = 1e-3f, dn = 1.f;
    for (int it = 0; it < a.iters && dn > 1e-6f; ++it) {
      float d[6];
      solve(S, lam, d);
      const float dn_new = sqrtf(d[0] * d[0] + d[1] * d[1] + d[2] * d[2] + d[3] * d[3] + d[4] * d[4] + d[5] * d[5]);
      const Pose Tn = retract(d, T);
      float Sn[NV];
      system_at<STEREO>(Tn, a, huber, KEEP, Sn);
      block_sum(Sn, rows[buf]);
      buf ^= 1;
      if (Sn[RHO] < S[RHO] && finite_pose(Tn) && isfinite(dn_new)) {
        T = Tn;
#pragma unroll
        for (int k = 0; k < NV; ++k) S[k] = Sn[k];
        dn = dn_new;
        lam = fmaxf(lam * 0.3f, 1e-7f);
      } else {
        lam = fminf(lam * 8.f, 1e4f);
      }
    }
  }
  // the final classification at T (with no round, the valid flags)
  int mine = 0;
  for (int i = threadIdx.x; i < a.n; i += blockDim.x) {
    bool in = a.valid[i];
    if (in && a.rounds > 0) {
      const Proj o = project<STEREO>(T, a, i);
      in = o.chi2 <= o.lim;
    }
    a.inlier[i] = in;
    mine += in;
  }
  mine = __reduce_add_sync(FULL, mine);
  if ((threadIdx.x & 31) == 0) warp_inliers[threadIdx.x >> 5] = mine;
  __syncthreads();
  if (threadIdx.x == 0) {
    int total = 0;
    for (int w = 0; w < WARPS; ++w) total += warp_inliers[w];
    *a.n_inliers = total;
#pragma unroll
    for (int i = 0; i < 3; ++i) {
#pragma unroll
      for (int j = 0; j < 3; ++j) a.T_out[4 * i + j] = T.R[3 * i + j];
      a.T_out[4 * i + 3] = T.t[i];
    }
    a.T_out[12] = 0.f;
    a.T_out[13] = 0.f;
    a.T_out[14] = 0.f;
    a.T_out[15] = 1.f;
  }
}

}  // namespace

// One call of the LM on `stream`; ur may be null (no stereo row).  Returns
// the launch's cudaError_t.
extern "C" int pose_lm_launch(const void* T_init, const void* points, const void* uv, const void* inv_sigma2,
                              const void* valid, const void* ur, int n, float fx, float fy, float cx, float cy,
                              float bf, float chi2_th, float chi2_th_stereo, int rounds, int iters,
                              void* T_out, void* inlier, void* n_inliers, void* stream) {
  Args a;
  a.T_init = static_cast<const float*>(T_init);
  a.points = static_cast<const float*>(points);
  a.uv = static_cast<const float*>(uv);
  a.inv_sigma2 = static_cast<const float*>(inv_sigma2);
  a.valid = static_cast<const bool*>(valid);
  a.ur = static_cast<const float*>(ur);
  a.n = n;
  a.rounds = rounds;
  a.iters = iters;
  a.fx = fx;
  a.fy = fy;
  a.cx = cx;
  a.cy = cy;
  a.bf = bf;
  a.chi2_th = chi2_th;
  a.chi2_th_stereo = chi2_th_stereo;
  a.T_out = static_cast<float*>(T_out);
  a.inlier = static_cast<bool*>(inlier);
  a.n_inliers = static_cast<int*>(n_inliers);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (a.ur != nullptr)
    pose_lm_kernel<true><<<1, THREADS, 0, s>>>(a);
  else
    pose_lm_kernel<false><<<1, THREADS, 0, s>>>(a);
  return static_cast<int>(cudaGetLastError());
}
