// Rigid point-set fit by Horn's quaternion method: every problem of a batch in
// one launch (wrapper and plain twin: mamri_tpu_torch/registration/kabsch.py).
//
// It replaces no TPU kernel: the JAX package fits with jnp ops and eigh. It
// was added because the port's fit on a card, a fixed cyclic Jacobi solve in
// tensor ops (eigh checks its status on the host), was ~675 host-dispatched
// ops a call, and the pose path calls it twice a pose (the baseplate, the
// Joint6 frame). The work is a few hundred dependent flops a problem: the
// launch is bound by the latency of that chain, and the least it can take is
// the launch floor of noop.cu.
//
// Design: one thread per problem. The thread reads its points twice (the
// means, then the centred cross-covariance; the second pass hits L1), keeps
// Horn's symmetric 4x4 profile matrix and the accumulated rotations in
// registers (32 floats, every index known at compile time), and writes the
// homogeneous 4x4 straight into the output. No shared memory, no
// synchronisation. All float32, every rounding spelled out (__fmul_rn,
// __fadd_rn, __fmaf_rn: nothing is contracted behind the source's back) in
// the order the twin's ops take on a card: an elementwise op rounds once;
// a sum over k of a matrix or vector product starts from the first nonzero
// product, rounded, and adds each further one by an FMA, as cuBLAS's small
// products do (the zeros of a rotation add nothing).
//
// Semantics of the twin (kabsch_rigid_transform_plain): equal weights 1/N
// (1 / max(N, 1e-12)); the means and the covariance of the weighted centred
// source against the centred target; 6 cyclic Jacobi sweeps of 3 rounds, each
// round two disjoint planes (0,1)(2,3), (0,2)(1,3), (0,3)(1,2), applied as
// A <- (R^T A) R and V <- V R with R[p][p] = R[q][q] = c, R[p][q] = s,
// R[q][p] = -s; per plane tau = (a_qq - a_pp) / (2 a_pq), t = sign(tau) /
// (|tau| + hypot(1, tau)) (sign(NaN) = -1), t = 0 where a_pq == 0, c =
// rsqrt(1 + t^2), s = t c. The eigenvector is the column of V at the largest
// diagonal entry of A, the first on ties and the first NaN before any number,
// as torch.argmax takes it. The zero matrix (no spread) gives the identity;
// a NaN coordinate makes every diagonal entry NaN and the output's top three
// rows NaN.

#include <cuda_runtime.h>

#define KABSCH_THREADS 64

__device__ __forceinline__ void kabsch_schur(float app, float aqq, float apq, float* c, float* s) {
  const bool zero = apq == 0.f;
  const float tau = (aqq - app) / (2.f * (zero ? 1.f : apq));
  float t = (tau >= 0.f ? 1.f : -1.f) / __fadd_rn(fabsf(tau), hypotf(1.f, tau));
  t = zero ? 0.f : t;
  const float cr = rsqrtf(__fadd_rn(1.f, __fmul_rn(t, t)));
  *c = cr;
  *s = __fmul_rn(t, cr);
}

// x p + y q as a product of two 4x4 rotations sums it (p's row comes first)
__device__ __forceinline__ float kabsch_dot2(float x, float p, float y, float q) {
  return __fmaf_rn(y, q, __fmul_rn(x, p));
}

// one round: the rotations of planes (P1, Q1) and (P2, Q2) at once
template <int P1, int Q1, int P2, int Q2>
__device__ __forceinline__ void kabsch_round(float (&a)[4][4], float (&v)[4][4]) {
  float c1, s1, c2, s2;
  kabsch_schur(a[P1][P1], a[Q1][Q1], a[P1][Q1], &c1, &s1);
  kabsch_schur(a[P2][P2], a[Q2][Q2], a[P2][Q2], &c2, &s2);
  float b[4][4];  // R^T A: rows p and q of each plane
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    b[P1][j] = kabsch_dot2(c1, a[P1][j], -s1, a[Q1][j]);
    b[Q1][j] = kabsch_dot2(s1, a[P1][j], c1, a[Q1][j]);
    b[P2][j] = kabsch_dot2(c2, a[P2][j], -s2, a[Q2][j]);
    b[Q2][j] = kabsch_dot2(s2, a[P2][j], c2, a[Q2][j]);
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {  // (R^T A) R and V R: columns p and q of each plane
    a[i][P1] = kabsch_dot2(b[i][P1], c1, b[i][Q1], -s1);
    a[i][Q1] = kabsch_dot2(b[i][P1], s1, b[i][Q1], c1);
    a[i][P2] = kabsch_dot2(b[i][P2], c2, b[i][Q2], -s2);
    a[i][Q2] = kabsch_dot2(b[i][P2], s2, b[i][Q2], c2);
    const float vp1 = v[i][P1], vq1 = v[i][Q1], vp2 = v[i][P2], vq2 = v[i][Q2];
    v[i][P1] = kabsch_dot2(vp1, c1, vq1, -s1);
    v[i][Q1] = kabsch_dot2(vp1, s1, vq1, c1);
    v[i][P2] = kabsch_dot2(vp2, c2, vq2, -s2);
    v[i][Q2] = kabsch_dot2(vp2, s2, vq2, c2);
  }
}

__global__ void __launch_bounds__(KABSCH_THREADS)
kabsch_kernel(const float* __restrict__ source, const float* __restrict__ target, long long problems, int n,
              float* __restrict__ out) {
  const long long k = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (k >= problems) return;
  const float* src = source + k * n * 3;
  const float* tgt = target + k * n * 3;
  const float w = 1.f / fmaxf((float)n, 1e-12f);
  float sm[3] = {0.f, 0.f, 0.f}, tm[3] = {0.f, 0.f, 0.f};
  for (int i = 0; i < n; ++i) {
#pragma unroll
    for (int d = 0; d < 3; ++d) {
      sm[d] = __fadd_rn(sm[d], __fmul_rn(src[3 * i + d], w));
      tm[d] = __fadd_rn(tm[d], __fmul_rn(tgt[3 * i + d], w));
    }
  }
  float h[3][3] = {};
  for (int i = 0; i < n; ++i) {
    float sc[3], tc[3];
#pragma unroll
    for (int d = 0; d < 3; ++d) {
      sc[d] = __fmul_rn(src[3 * i + d] - sm[d], w);
      tc[d] = tgt[3 * i + d] - tm[d];
    }
#pragma unroll
    for (int r = 0; r < 3; ++r)
#pragma unroll
      for (int c = 0; c < 3; ++c) h[r][c] = i == 0 ? __fmul_rn(sc[r], tc[c]) : __fmaf_rn(sc[r], tc[c], h[r][c]);
  }
  const float sxx = h[0][0], sxy = h[0][1], sxz = h[0][2];
  const float syx = h[1][0], syy = h[1][1], syz = h[1][2];
  const float szx = h[2][0], szy = h[2][1], szz = h[2][2];
  float a[4][4] = {
      {sxx + syy + szz, syz - szy, szx - sxz, sxy - syx},
      {syz - szy, sxx - syy - szz, sxy + syx, szx + sxz},
      {szx - sxz, sxy + syx, -sxx + syy - szz, syz + szy},
      {sxy - syx, szx + sxz, syz + szy, -sxx - syy + szz},
  };
  float v[4][4] = {{1.f, 0.f, 0.f, 0.f}, {0.f, 1.f, 0.f, 0.f}, {0.f, 0.f, 1.f, 0.f}, {0.f, 0.f, 0.f, 1.f}};
#pragma unroll 1
  for (int sweep = 0; sweep < 6; ++sweep) {
    kabsch_round<0, 1, 2, 3>(a, v);
    kabsch_round<0, 2, 1, 3>(a, v);
    kabsch_round<0, 3, 1, 2>(a, v);
  }
  int top = 0;
  float best = a[0][0];
#pragma unroll
  for (int i = 1; i < 4; ++i) {
    const float d = a[i][i];
    if (best == best && (d != d || d > best)) {
      top = i;
      best = d;
    }
  }
  float q[4];
#pragma unroll
  for (int r = 0; r < 4; ++r) q[r] = top == 0 ? v[r][0] : top == 1 ? v[r][1] : top == 2 ? v[r][2] : v[r][3];
  const float qw = q[0], qx = q[1], qy = q[2], qz = q[3];
  const float ww = __fmul_rn(qw, qw), xx = __fmul_rn(qx, qx), yy = __fmul_rn(qy, qy), zz = __fmul_rn(qz, qz);
  const float xy = __fmul_rn(qx, qy), xz = __fmul_rn(qx, qz), yz = __fmul_rn(qy, qz);
  const float wx = __fmul_rn(qw, qx), wy = __fmul_rn(qw, qy), wz = __fmul_rn(qw, qz);
  const float rot[3][3] = {
      {__fadd_rn(ww, xx) - yy - zz, 2.f * (xy - wz), 2.f * (xz + wy)},
      {2.f * (xy + wz), __fsub_rn(ww, xx) + yy - zz, 2.f * (yz - wx)},
      {2.f * (xz - wy), 2.f * (yz + wx), __fsub_rn(ww, xx) - yy + zz},
  };
  float* o = out + k * 16;
#pragma unroll
  for (int r = 0; r < 3; ++r) {
    o[4 * r + 0] = rot[r][0];
    o[4 * r + 1] = rot[r][1];
    o[4 * r + 2] = rot[r][2];
    o[4 * r + 3] = tm[r] - __fmaf_rn(rot[r][2], sm[2], __fmaf_rn(rot[r][1], sm[1], __fmul_rn(rot[r][0], sm[0])));
  }
  o[12] = 0.f;
  o[13] = 0.f;
  o[14] = 0.f;
  o[15] = 1.f;
}

// `problems` fits of `n` points each: source and target (problems, n, 3)
// C-contiguous float32, out (problems, 4, 4). cudaErrorInvalidValue for an
// empty batch or a negative n.
extern "C" int mamri_kabsch(const float* source, const float* target, long long problems, int n, float* out,
                            cudaStream_t stream) {
  if (problems < 1 || n < 0) return (int)cudaErrorInvalidValue;
  const unsigned int blocks = (unsigned int)((problems + KABSCH_THREADS - 1) / KABSCH_THREADS);
  kabsch_kernel<<<blocks, KABSCH_THREADS, 0, stream>>>(source, target, problems, n, out);
  return (int)cudaGetLastError();
}
