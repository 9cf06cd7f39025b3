// The proper rotation of the Kabsch alignment from each graph's 3x3
// covariance, without an SVD: one thread per graph.
//
// Replaces no TPU kernel. `ops/geometry.kabsch_align` on the card used
// `torch.linalg.svd`, which reads its error flag on the host and so made
// every aligned training step wait; JAX's jitted SVD
// (jamun_tpu/ops/geometry.py:39) waits nowhere. This kernel computes the
// same rotation, R = V diag(1, 1, det(V U^T)) U^T of H = U S V^T, which
// maximises tr(R H) over proper rotations, by Horn's quaternion method:
// the unit quaternion of R is the eigenvector of the largest eigenvalue of
// a symmetric 4x4 matrix built from H. The eigenvectors come from a fixed
// number of cyclic Jacobi sweeps in registers, in f32: no data-dependent
// loop, no error flag, nothing read back by the host.
//
// Sweeps: cyclic Jacobi converges quadratically; on random, reflected and
// near-planar covariances the off-diagonal part is at f32 rounding after
// four sweeps, and clustered eigenvalues take one or two more. Eight
// leave a margin at no cost that matters (48 rotations of one thread).
//
// Bound on the H100: neither bytes nor operations (72 bytes and ~5 kflop
// per graph); the launch itself. It exists to take the host out of the
// training step.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int SWEEPS = 8;

// one Jacobi rotation zeroing a[p][q] of the symmetric a; v accumulates them
template <int P, int Q>
__device__ __forceinline__ void rotate(float (&a)[4][4], float (&v)[4][4]) {
  const float apq = a[P][Q];
  float t = 0.0f;
  if (apq != 0.0f) {
    const float tau = (a[Q][Q] - a[P][P]) / (2.0f * apq);
    t = copysignf(1.0f, tau) / (fabsf(tau) + sqrtf(1.0f + tau * tau));
  }
  const float c = 1.0f / sqrtf(1.0f + t * t), s = t * c;
#pragma unroll
  for (int k = 0; k < 4; ++k) {  // columns: A P
    const float akp = a[k][P], akq = a[k][Q];
    a[k][P] = c * akp - s * akq;
    a[k][Q] = s * akp + c * akq;
  }
#pragma unroll
  for (int k = 0; k < 4; ++k) {  // rows: P^T (A P)
    const float apk = a[P][k], aqk = a[Q][k];
    a[P][k] = c * apk - s * aqk;
    a[Q][k] = s * apk + c * aqk;
  }
#pragma unroll
  for (int k = 0; k < 4; ++k) {  // V P
    const float vkp = v[k][P], vkq = v[k][Q];
    v[k][P] = c * vkp - s * vkq;
    v[k][Q] = s * vkp + c * vkq;
  }
}

// H [G, 3, 3] f32 (H[i][j] = sum_n y_i x_j) -> R [G, 3, 3] f32
__global__ void kabsch_kernel(const float* __restrict__ H, float* __restrict__ R, int G) {
  const int g = blockIdx.x * blockDim.x + threadIdx.x;
  if (g >= G) return;
  const float* h = H + 9 * g;
  const float xx = h[0], xy = h[1], xz = h[2];
  const float yx = h[3], yy = h[4], yz = h[5];
  const float zx = h[6], zy = h[7], zz = h[8];
  float a[4][4] = {{xx + yy + zz, yz - zy, zx - xz, xy - yx},
                   {yz - zy, xx - yy - zz, xy + yx, zx + xz},
                   {zx - xz, xy + yx, -xx + yy - zz, yz + zy},
                   {xy - yx, zx + xz, yz + zy, -xx - yy + zz}};
  float v[4][4] = {{1.0f, 0.0f, 0.0f, 0.0f},
                   {0.0f, 1.0f, 0.0f, 0.0f},
                   {0.0f, 0.0f, 1.0f, 0.0f},
                   {0.0f, 0.0f, 0.0f, 1.0f}};
#pragma unroll 1
  for (int sweep = 0; sweep < SWEEPS; ++sweep) {
    rotate<0, 1>(a, v);
    rotate<0, 2>(a, v);
    rotate<0, 3>(a, v);
    rotate<1, 2>(a, v);
    rotate<1, 3>(a, v);
    rotate<2, 3>(a, v);
  }
  // the eigenvector of the largest eigenvalue (the first one on a tie)
  float q0 = v[0][0], q1 = v[1][0], q2 = v[2][0], q3 = v[3][0], best = a[0][0];
#pragma unroll
  for (int k = 1; k < 4; ++k) {
    if (a[k][k] > best) {
      best = a[k][k];
      q0 = v[0][k];
      q1 = v[1][k];
      q2 = v[2][k];
      q3 = v[3][k];
    }
  }
  const float n = 1.0f / sqrtf(q0 * q0 + q1 * q1 + q2 * q2 + q3 * q3);
  q0 *= n;
  q1 *= n;
  q2 *= n;
  q3 *= n;
  float* r = R + 9 * g;
  r[0] = q0 * q0 + q1 * q1 - q2 * q2 - q3 * q3;
  r[1] = 2.0f * (q1 * q2 - q0 * q3);
  r[2] = 2.0f * (q1 * q3 + q0 * q2);
  r[3] = 2.0f * (q2 * q1 + q0 * q3);
  r[4] = q0 * q0 - q1 * q1 + q2 * q2 - q3 * q3;
  r[5] = 2.0f * (q2 * q3 - q0 * q1);
  r[6] = 2.0f * (q3 * q1 - q0 * q2);
  r[7] = 2.0f * (q3 * q2 + q0 * q1);
  r[8] = q0 * q0 - q1 * q1 - q2 * q2 + q3 * q3;
}

}  // namespace

extern "C" int kabsch_rotation_f32(const void* H, void* R, int G, void* stream) {
  if (G == 0) return 0;
  const int nt = 128;
  kabsch_kernel<<<(G + nt - 1) / nt, nt, 0, (cudaStream_t)stream>>>((const float*)H, (float*)R, G);
  return (int)cudaGetLastError();
}
