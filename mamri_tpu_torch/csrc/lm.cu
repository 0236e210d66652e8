// The full-chain pose IK's Levenberg-Marquardt solve: every iteration of every
// guess in one launch (wrapper and plain twin: mamri_tpu_torch/ik/fused_lm.py).
//
// It replaces no TPU kernel: the JAX package jits the LM (api/engine.py). It
// was added because the port's eager LM, a Python loop of ~480 host-dispatched
// ops an iteration, was 92-95 % of every pose. The work is tiny (12 guesses of
// a 6-joint chain, an 18-row residual, a 6x6 solve, 25 dependent steps): the
// solve is bound by the latency of that chain of steps, not by bytes or
// operations, and the least any launch takes is the launch floor of noop.cu.
//
// Design: one warp per guess, LM_WARPS guesses a block. The chain (fixed
// offsets, base, markers, targets) sits in shared memory. Each evaluation runs
// the forward kinematics in every lane (the chain is serial, so lanes would
// only wait on each other) and keeps the link frames in the warp's shared
// memory; lane l < 18 then takes residual row l and its Jacobian row in closed
// form (column j = w * cross(omega_j, p - o_j) for a marker p on a link at or
// below joint j, zero above it); lane k < 28 takes entry k of the upper
// triangle of [J r]^T [J r] (J^T J, J^T r and |r|^2). Every lane solves the
// damped 6x6 normal equations by Cholesky in registers, so every lane holds
// the same step and no broadcast is needed. All float32, FMA contracted.
//
// Semantics of ik/lm.least_squares_lm on ik/residuals.full_chain_residual:
// x0 clamped; per step the damped system (J^T J + mu diag(max(diag, eps)) +
// eps I) d = -J^T r, x + d clamped, accepted only on a strictly lower cost (a
// NaN trial is rejected), mu * mu_dec or * mu_inc clamped to [1e-12, 1e12];
// the gradient norm from the Jacobian at the final x. Clamps keep a NaN.

#include "common.cuh"

#define LM_N 6            // joints of the chain
#define LM_ROWS 18        // 9 Joint6 errors, then 9 Joint4 errors
#define LM_COLS (LM_N + 1)  // a Jacobian row, then its residual
#define LM_SUMS 28        // upper triangle of the 7 x 7 [J r]^T [J r]
#define LM_MAX_LINKS 16
#define LM_WARPS 4        // guesses a block, one warp each

#define LM_AXIS_IS 1      // core/transforms.py: IS turns about +z, PA about -y, LR (3) about +x
#define LM_AXIS_PA 2

struct LmChain {
  int num_links, link6, link4;
  int parent[LM_MAX_LINKS];        // -1 for the root
  int joint[LM_MAX_LINKS];         // the angle a link turns by, -1 if fixed
  int axis[LM_MAX_LINKS];
  unsigned int above[LM_MAX_LINKS];  // bit k: link k is this link or one of its ancestors
  int joint_link[LM_N];
};

struct LmShared {
  float offset[LM_MAX_LINKS][12];  // top three rows of each fixed offset
  float base[12];
  float marker[2][9];              // local markers: Joint6 (flipped under the correction), Joint4
  float target[2][9];
  float w4;
  float world[LM_WARPS][LM_MAX_LINKS][12];
  float rows[LM_WARPS][LM_ROWS][LM_COLS];
  float sums[LM_WARPS][LM_SUMS];
};

// torch.clamp: a NaN stays NaN
__device__ __forceinline__ float lm_clamp(float v, float lo, float hi) {
  return v != v ? v : fminf(fmaxf(v, lo), hi);
}

// 0.5 |r|^2 at x for this warp's guess; with `jacobian`, sums[] then holds
// the upper triangle of [J r]^T [J r] too (every lane may read it on return).
__device__ __forceinline__ float lm_eval(const LmChain& ch, LmShared& s, int warp, int lane,
                                         const float (&x)[LM_N], bool jacobian, int pair_a, int pair_b) {
  float (*world)[12] = s.world[warp];
  float cs[LM_N], sn[LM_N];
#pragma unroll
  for (int j = 0; j < LM_N; ++j) sincosf(x[j], &sn[j], &cs[j]);
  __syncwarp();  // the previous evaluation's readers are done with world, rows and sums
  for (int i = 0; i < ch.num_links; ++i) {
    const float* P = ch.parent[i] < 0 ? s.base : world[ch.parent[i]];
    const float* O = s.offset[i];
    float L[12];  // fixed offset @ articulation
    const int j = ch.joint[i];
    if (j < 0) {
#pragma unroll
      for (int e = 0; e < 12; ++e) L[e] = O[e];
    } else {
      float c = 0.f, sv = 0.f;
#pragma unroll
      for (int k = 0; k < LM_N; ++k)
        if (k == j) { c = cs[k]; sv = sn[k]; }
      float A[9];  // articulation_matrix: IS RotZ(t), PA RotY(-t), LR RotX(t)
      const int ax = ch.axis[i];
      if (ax == LM_AXIS_IS) {
        A[0] = c; A[1] = -sv; A[2] = 0.f; A[3] = sv; A[4] = c; A[5] = 0.f; A[6] = 0.f; A[7] = 0.f; A[8] = 1.f;
      } else if (ax == LM_AXIS_PA) {
        A[0] = c; A[1] = 0.f; A[2] = -sv; A[3] = 0.f; A[4] = 1.f; A[5] = 0.f; A[6] = sv; A[7] = 0.f; A[8] = c;
      } else {
        A[0] = 1.f; A[1] = 0.f; A[2] = 0.f; A[3] = 0.f; A[4] = c; A[5] = -sv; A[6] = 0.f; A[7] = sv; A[8] = c;
      }
#pragma unroll
      for (int r = 0; r < 3; ++r) {
#pragma unroll
        for (int q = 0; q < 3; ++q)
          L[r * 4 + q] = O[r * 4 + 0] * A[q] + O[r * 4 + 1] * A[3 + q] + O[r * 4 + 2] * A[6 + q];
        L[r * 4 + 3] = O[r * 4 + 3];
      }
    }
    float W[12];
#pragma unroll
    for (int r = 0; r < 3; ++r) {
#pragma unroll
      for (int q = 0; q < 4; ++q)
        W[r * 4 + q] = P[r * 4 + 0] * L[q] + P[r * 4 + 1] * L[4 + q] + P[r * 4 + 2] * L[8 + q];
      W[r * 4 + 3] += P[r * 4 + 3];
    }
    if (lane == 0) {
#pragma unroll
      for (int e = 0; e < 12; ++e) world[i][e] = W[e];
    }
    __syncwarp();
  }

  float (*rows)[LM_COLS] = s.rows[warp];
  if (lane < LM_ROWS) {
    const int blk = lane / 9, m = (lane % 9) / 3, k = lane % 3;
    const int link = blk ? ch.link4 : ch.link6;
    const float* W = world[link];
    const float* q = s.marker[blk] + 3 * m;
    float p[3];
#pragma unroll
    for (int a = 0; a < 3; ++a) p[a] = (W[a * 4] * q[0] + W[a * 4 + 1] * q[1] + W[a * 4 + 2] * q[2]) + W[a * 4 + 3];
    const float w = blk ? s.w4 : 1.f;
    rows[lane][LM_N] = w * (p[k] - s.target[blk][3 * m + k]);
    if (jacobian) {
#pragma unroll
      for (int j = 0; j < LM_N; ++j) {
        const int jl = ch.joint_link[j];
        float v = 0.f;
        if ((ch.above[link] >> jl) & 1u) {
          const float* F = world[jl];
          const int ax = ch.axis[jl];
          const int col = ax == LM_AXIS_IS ? 2 : ax == LM_AXIS_PA ? 1 : 0;
          const float sg = ax == LM_AXIS_PA ? -1.f : 1.f;
          const float om0 = sg * F[col], om1 = sg * F[4 + col], om2 = sg * F[8 + col];
          const float d0 = p[0] - F[3], d1 = p[1] - F[7], d2 = p[2] - F[11];
          const float cr = k == 0 ? om1 * d2 - om2 * d1 : k == 1 ? om2 * d0 - om0 * d2 : om0 * d1 - om1 * d0;
          v = w * cr;
        }
        rows[lane][j] = v;
      }
    }
  }
  __syncwarp();
  float* sums = s.sums[warp];
  if (lane < LM_SUMS && (jacobian || lane == LM_SUMS - 1)) {
    float acc = 0.f;
    for (int r = 0; r < LM_ROWS; ++r) acc += rows[r][pair_a] * rows[r][pair_b];
    sums[lane] = acc;
  }
  __syncwarp();
  return 0.5f * sums[LM_SUMS - 1];
}

// Entry (a, b), a <= b, of the upper triangle of the 7 x 7 [J r]^T [J r], read row by row.
__device__ __forceinline__ int lm_sum_index(int a, int b) { return a * LM_COLS - a * (a - 1) / 2 + (b - a); }

__global__ void __launch_bounds__(32 * LM_WARPS) full_chain_lm_kernel(
    LmChain ch, const float* __restrict__ guesses, int g_count, const float* __restrict__ lower,
    const float* __restrict__ upper, const float* __restrict__ fixed_offsets, const float* __restrict__ base_tf,
    const float* __restrict__ targets6, const float* __restrict__ local6, const float* __restrict__ targets4,
    const float* __restrict__ local4, const bool* __restrict__ apply_correction,
    const bool* __restrict__ joint4_found, float joint4_weight, int num_iters, float mu0, float mu_inc,
    float mu_dec, float jac_eps, float* __restrict__ x_out, float* __restrict__ cost_out,
    float* __restrict__ grad_out, int* __restrict__ iters_out) {
  __shared__ LmShared s;
  const int t = threadIdx.x;
  for (int e = t; e < ch.num_links * 12; e += blockDim.x)
    s.offset[e / 12][e % 12] = fixed_offsets[(e / 12) * 16 + e % 12];
  if (t < 12) s.base[t] = base_tf[t];
  if (t < 9) {
    const bool flip = *apply_correction && t % 3 < 2;  // transforms.flip_xy
    s.marker[0][t] = flip ? -local6[t] : local6[t];
    s.marker[1][t] = local4[t];
    s.target[0][t] = targets6[t];
    s.target[1][t] = targets4 ? targets4[t] : 0.f;
  }
  if (t == 0) s.w4 = joint4_found && *joint4_found ? joint4_weight : 0.f;
  __syncthreads();

  const int warp = t / 32, lane = t % 32;
  const int gi = blockIdx.x * LM_WARPS + warp;
  if (gi >= g_count) return;  // a whole warp leaves; no block barrier follows
  int pair_a = 0, pair_b = 0;  // this lane's entry of [J r]^T [J r]
  for (int a = 0, e = 0; a < LM_COLS; ++a)
    for (int b = a; b < LM_COLS; ++b, ++e)
      if (e == lane) { pair_a = a; pair_b = b; }

  float lo[LM_N], hi[LM_N], x[LM_N];
#pragma unroll
  for (int j = 0; j < LM_N; ++j) {
    lo[j] = lower[j];
    hi[j] = upper[j];
    x[j] = lm_clamp(guesses[gi * LM_N + j], lo[j], hi[j]);
  }
  float mu = mu0;
  float c = lm_eval(ch, s, warp, lane, x, false, pair_a, pair_b);
  int accepted = 0;
  const float* sums = s.sums[warp];
  for (int it = 0; it < num_iters; ++it) {
    lm_eval(ch, s, warp, lane, x, true, pair_a, pair_b);
    float Lc[LM_N][LM_N], g[LM_N];
#pragma unroll
    for (int a = 0; a < LM_N; ++a) g[a] = sums[lm_sum_index(a, LM_N)];
#pragma unroll
    for (int j = 0; j < LM_N; ++j) {
      const float h = sums[lm_sum_index(j, j)];
      const float d = h != h ? h : fmaxf(h, jac_eps);
      float v = (h + mu * d) + jac_eps;
#pragma unroll
      for (int k = 0; k < j; ++k) v -= Lc[j][k] * Lc[j][k];
      Lc[j][j] = sqrtf(v);
#pragma unroll
      for (int i = j + 1; i < LM_N; ++i) {
        float u = sums[lm_sum_index(j, i)];
#pragma unroll
        for (int k = 0; k < j; ++k) u -= Lc[i][k] * Lc[j][k];
        Lc[i][j] = u / Lc[j][j];
      }
    }
    float y[LM_N], xn[LM_N];
#pragma unroll
    for (int i = 0; i < LM_N; ++i) {
      float v = -g[i];
#pragma unroll
      for (int k = 0; k < i; ++k) v -= Lc[i][k] * y[k];
      y[i] = v / Lc[i][i];
    }
#pragma unroll
    for (int i = LM_N - 1; i >= 0; --i) {
      float v = y[i];
#pragma unroll
      for (int k = i + 1; k < LM_N; ++k) v -= Lc[k][i] * y[k];  // y[k], k > i, already holds the step
      y[i] = v / Lc[i][i];
    }
#pragma unroll
    for (int j = 0; j < LM_N; ++j) xn[j] = lm_clamp(x[j] + y[j], lo[j], hi[j]);
    const float cn = lm_eval(ch, s, warp, lane, xn, false, pair_a, pair_b);
    const bool improve = cn < c;  // every lane computed the same cn and c
    if (improve) {
#pragma unroll
      for (int j = 0; j < LM_N; ++j) x[j] = xn[j];
      c = cn;
    }
    mu = fminf(fmaxf(improve ? mu * mu_dec : mu * mu_inc, 1e-12f), 1e12f);
    accepted += improve;
  }
  lm_eval(ch, s, warp, lane, x, true, pair_a, pair_b);
  float gg = 0.f;
#pragma unroll
  for (int a = 0; a < LM_N; ++a) {
    const float ga = sums[lm_sum_index(a, LM_N)];
    gg += ga * ga;
  }
  if (lane == 0) {
#pragma unroll
    for (int j = 0; j < LM_N; ++j) x_out[gi * LM_N + j] = x[j];
    cost_out[gi] = c;
    grad_out[gi] = sqrtf(gg);
    iters_out[gi] = accepted;
  }
}

// The chain as the port's RobotModel gives it (parent, joint index and axis
// code of each link; host arrays), checked and packed into the kernel's
// argument. cudaErrorInvalidValue for a chain the kernel does not take.
extern "C" int mamri_full_chain_lm(
    const float* guesses, int g_count, const float* lower, const float* upper, const int* parent,
    const int* joint, const int* axis, int num_links, int link6, int link4, const float* fixed_offsets,
    const float* base_tf, const float* targets6, const float* local6, const float* targets4, const float* local4,
    const bool* apply_correction, const bool* joint4_found, float joint4_weight, int num_iters, float mu0,
    float mu_inc, float mu_dec, float jac_eps, float* x_out, float* cost_out, float* grad_out, int* iters_out,
    cudaStream_t stream) {
  if (g_count < 1 || num_iters < 0 || num_links < 1 || num_links > LM_MAX_LINKS || link6 < 0 ||
      link6 >= num_links || link4 < 0 || link4 >= num_links)
    return (int)cudaErrorInvalidValue;
  LmChain ch = {};
  ch.num_links = num_links;
  ch.link6 = link6;
  ch.link4 = link4;
  int seen = 0;
  for (int i = 0; i < num_links; ++i) {
    if (parent[i] < -1 || parent[i] >= i || joint[i] < -1 || joint[i] >= LM_N || axis[i] < 0 || axis[i] > 3 ||
        (joint[i] >= 0) != (axis[i] != 0) || (joint[i] >= 0 && (seen >> joint[i]) & 1))
      return (int)cudaErrorInvalidValue;
    ch.parent[i] = parent[i];
    ch.joint[i] = joint[i];
    ch.axis[i] = axis[i];
    ch.above[i] = (parent[i] < 0 ? 0u : ch.above[parent[i]]) | (1u << i);
    if (joint[i] >= 0) {
      seen |= 1 << joint[i];
      ch.joint_link[joint[i]] = i;
    }
  }
  if (seen != (1 << LM_N) - 1) return (int)cudaErrorInvalidValue;
  const unsigned int blocks = (unsigned int)((g_count + LM_WARPS - 1) / LM_WARPS);
  full_chain_lm_kernel<<<blocks, 32 * LM_WARPS, 0, stream>>>(
      ch, guesses, g_count, lower, upper, fixed_offsets, base_tf, targets6, local6, targets4, local4,
      apply_correction, joint4_found, joint4_weight, num_iters, mu0, mu_inc, mu_dec, jac_eps, x_out, cost_out,
      grad_out, iters_out);
  return (int)cudaGetLastError();
}
