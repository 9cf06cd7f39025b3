// Edge geometry of the dense separable E3Conv, shared by the edge-features
// kernel (edge_features.cu) and the whole-model kernel (e3_stack.cu):
//
//   dist     = sqrt(dx^2 + dy^2 + dz^2 + 1e-12)
//   sh       = sqrt(3) * d / max(dist, 1e-12)
//   radial_k = exp(-((dist - (k + 1) * step) / step)^2) / 1.12,
//              step = cutoff / (NR + 1)
//
// Every product and sum is a rounded intrinsic, so the compiler fuses none of
// them into an FMA whatever its flags: the distance, and with it the cutoff
// test `dist < cutoff`, rounds as the plain PyTorch version's does, and the
// two kernels agree on every adjacency entry.

#pragma once

#include <cuda_runtime.h>

namespace edge_geometry {

__device__ __forceinline__ float pair_dist(float dx, float dy, float dz) {
  return __fsqrt_rn(__fadd_rn(
      __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)), __fmul_rn(dz, dz)), 1e-12f));
}

// one l = 1 spherical-harmonic component from the vector component d
__device__ __forceinline__ float sh_component(float d, float dist) {
  const float kSqrt3 = 1.7320508075688772f;
  return __fmul_rn(__fmul_rn(kSqrt3, d), __fdiv_rn(1.0f, fmaxf(dist, 1e-12f)));
}

// Gaussian radial basis function k (0-based) of nr
__device__ __forceinline__ float radial_basis(int k, float dist, float cutoff, int nr) {
  float step = __fdiv_rn(cutoff, (float)(nr + 1));
  float diff = __fdiv_rn(__fsub_rn(dist, __fmul_rn((float)(k + 1), step)), step);
  return __fmul_rn(expf(-__fmul_rn(diff, diff)), 1.0f / 1.12f);
}

}  // namespace edge_geometry
