// Per-forward edge features of the dense separable E3Conv (l <= 1 SH,
// cutoff adjacency, Gaussian radial basis) for every dense pair and bond.
//
// Replaces the TPU kernel `_edge_feat_kernel` / `_edge_features_body` of
// jamun_tpu/ops/pallas/packed_conv.py (pallas_call at line 806, entry
// `packed_edge_features`). The TPU kernel builds lane-packed [EFR, N*N] rows
// through one-hot matmuls; here the output is pair-major with EC = 4 + NR
// channels per edge:
//
//   ef[g, i, j, :] = [shy, shz, shx, adj, radial_0 .. radial_{NR-1}]
//   for the dense pair src j -> dst i, vector pos[j] - pos[i];
//   bf[g, b, :]    = the same for bond b, vector pos[src] - pos[dst], with
//   the bond mask in place of adj.
//
// Bound on the H100: bytes. The kernel is a streaming write of
// G*(N*N + B)*EC elements; the positions it reads stay in L1/L2 and each
// element costs one expf. One thread writes one element, so a warp's store
// covers 32 consecutive elements (a first version with one thread per pair
// wrote 72-byte strided rows and ran at 22x the bound); each thread
// recomputes its pair's distance, which is cheaper than the traffic it saves.
//
// Formulas (as _geom_radial_rows) in edge_geometry.cuh;
// adj = (dist < cutoff) & mask_i & mask_j & (i != j). The geometry uses
// rounded intrinsics and the source is built with --fmad=false, so the
// distance (and the cutoff test) rounds as the plain version's does.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "edge_geometry.cuh"

namespace {

using edge_geometry::pair_dist;
using edge_geometry::radial_basis;
using edge_geometry::sh_component;

__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) { *p = __float2bfloat16_rn(v); }

// channel ch of an edge with vector (dx, dy, dz) and flag (adjacency or mask)
__device__ float feature(int ch, float dx, float dy, float dz, float flag, float cutoff, int nr) {
  float dist = pair_dist(dx, dy, dz);
  if (ch == 3) return flag;
  if (ch < 3) return sh_component(ch == 0 ? dy : (ch == 1 ? dz : dx), dist);
  return radial_basis(ch - 4, dist, cutoff, nr);
}

template <typename T>
__global__ void edge_features_kernel(const float* __restrict__ pos,
                                     const uint8_t* __restrict__ node_mask,
                                     const int64_t* __restrict__ bond_src,
                                     const int64_t* __restrict__ bond_dst,
                                     const uint8_t* __restrict__ bond_mask, float cutoff,
                                     T* __restrict__ ef, T* __restrict__ bf, int G, int N,
                                     int B, int nr) {
  // 32-bit index arithmetic: the launcher checks that every index fits
  const int ec = 4 + nr;
  const int n_dense = G * N * N * ec;
  const int total = n_dense + G * B * ec;
  for (int idx = blockIdx.x * blockDim.x + threadIdx.x; idx < total;
       idx += gridDim.x * blockDim.x) {
    if (idx < n_dense) {
      int pair = idx / ec, ch = idx % ec;
      int g = pair / (N * N), r = pair % (N * N);
      int i = r / N, j = r % N;
      const float* pi = pos + (g * N + i) * 3;
      const float* pj = pos + (g * N + j) * 3;
      float dx = pj[0] - pi[0], dy = pj[1] - pi[1], dz = pj[2] - pi[2];
      float flag = 0.0f;
      if (ch == 3) {
        flag = (pair_dist(dx, dy, dz) < cutoff && i != j && node_mask[g * N + i] && node_mask[g * N + j])
                   ? 1.0f : 0.0f;
      }
      store(ef + idx, feature(ch, dx, dy, dz, flag, cutoff, nr));
    } else {
      int e = idx - n_dense;
      int k = e / ec, ch = e % ec;
      int g = k / B;
      const float* ps = pos + (g * N + (int)bond_src[k]) * 3;
      const float* pd = pos + (g * N + (int)bond_dst[k]) * 3;
      store(bf + e, feature(ch, ps[0] - pd[0], ps[1] - pd[1], ps[2] - pd[2],
                            bond_mask[k] ? 1.0f : 0.0f, cutoff, nr));
    }
  }
}

template <typename T>
int launch(const void* pos, const void* node_mask, const void* bond_src,
           const void* bond_dst, const void* bond_mask, float cutoff, void* ef, void* bf,
           int G, int N, int B, int nr, void* stream) {
  long long total = ((long long)G * N * N + (long long)G * B) * (4 + nr);
  if (total == 0) return 0;
  if (total > 0x7fffffffLL - 65536LL * 256LL) return (int)cudaErrorInvalidValue;
  const int threads = 256;
  long long blocks = (total + threads - 1) / threads;
  if (blocks > 65536LL) blocks = 65536LL;
  edge_features_kernel<T><<<(unsigned)blocks, threads, 0, (cudaStream_t)stream>>>(
      (const float*)pos, (const uint8_t*)node_mask, (const int64_t*)bond_src,
      (const int64_t*)bond_dst, (const uint8_t*)bond_mask, cutoff, (T*)ef, (T*)bf, G, N, B,
      nr);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int edge_features_f32(const void* pos, const void* node_mask, const void* bond_src,
                                 const void* bond_dst, const void* bond_mask, float cutoff,
                                 void* ef, void* bf, int G, int N, int B, int nr,
                                 void* stream) {
  return launch<float>(pos, node_mask, bond_src, bond_dst, bond_mask, cutoff, ef, bf, G, N, B,
                       nr, stream);
}

extern "C" int edge_features_bf16(const void* pos, const void* node_mask, const void* bond_src,
                                  const void* bond_dst, const void* bond_mask, float cutoff,
                                  void* ef, void* bf, int G, int N, int B, int nr,
                                  void* stream) {
  return launch<__nv_bfloat16>(pos, node_mask, bond_src, bond_dst, bond_mask, cutoff, ef, bf,
                               G, N, B, nr, stream);
}
