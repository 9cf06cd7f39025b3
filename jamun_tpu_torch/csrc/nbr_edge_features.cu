// Per-forward edge features of the sparse path from a Verlet-cached
// neighbour list (nbr_idx, superset flag) built within cutoff + skin: for
// every slot (g, i, k) the source position, then
//
//   dist   = sqrt(dx^2 + dy^2 + dz^2 + 1e-12),  d = pos[src] - pos[i]
//   sh     = [0, sqrt(3) (dy, dz, dx) / dist]
//   radial = the NR Gaussian radial values of edge_geometry.cuh
//   mask   = superset & (dist < cutoff)   (f32)
//   idx    = nbr_idx where mask, else the sentinel N
//
// sh and radial are stored in T. A slot outside the superset reads its own
// atom's position (d = 0), so its index is never followed.
//
// Replaces the TPU kernel `_geom_kernel` of jamun_tpu/ops/pallas/nbr_conv.py
// (pallas_call at line 559, entry `nbr_edge_features`). The TPU kernel runs
// tiles of 512 destination atoms and gathers the source positions with
// one-hot matmuls over 128-atom source blocks; here one thread owns one slot
// and reads its source's position directly (12 bytes per atom, cached in
// L1/L2).
//
// Bound on the H100: bytes. A slot reads its index and flag and writes
// 4 + NR values in T, a f32 mask and an int64 index (84 bytes in bf16 with
// NR = 32); its NR expf stay well inside the FP32 rate. Each thread writes
// its slot's rows whole, so a warp's stores cover 32 consecutive rows.
//
// The geometry is edge_geometry.cuh's rounded intrinsics, shared with the
// edge-features kernel, the whole-model kernel and the tiled kernel and
// followed by the plain versions, so the cutoff test agrees entry for entry.

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

template <typename T>
__global__ void nbr_edge_features_kernel(const float* __restrict__ pos,
                                         const int64_t* __restrict__ idx,
                                         const uint8_t* __restrict__ sup, float cutoff,
                                         T* __restrict__ sh, T* __restrict__ rad,
                                         float* __restrict__ mask, int64_t* __restrict__ idx_out,
                                         int G, int N, int K, int nr) {
  const long long slot = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (slot >= (long long)G * N * K) return;
  const long long gi = slot / K;  // g * N + i
  const long long g = gi / N;
  const bool in_superset = sup[slot] != 0;
  const long long src = in_superset ? g * N + idx[slot] : gi;
  const float dx = pos[3 * src + 0] - pos[3 * gi + 0];
  const float dy = pos[3 * src + 1] - pos[3 * gi + 1];
  const float dz = pos[3 * src + 2] - pos[3 * gi + 2];
  const float dist = pair_dist(dx, dy, dz);
  const bool kept = in_superset && dist < cutoff;

  T* shp = sh + slot * 4;
  store(shp + 0, 0.0f);
  store(shp + 1, sh_component(dy, dist));
  store(shp + 2, sh_component(dz, dist));
  store(shp + 3, sh_component(dx, dist));
  T* rp = rad + slot * nr;
  for (int k = 0; k < nr; ++k) store(rp + k, radial_basis(k, dist, cutoff, nr));
  mask[slot] = kept ? 1.0f : 0.0f;
  idx_out[slot] = kept ? idx[slot] : (int64_t)N;
}

template <typename T>
int launch(const void* pos, const void* idx, const void* sup, float cutoff, void* sh, void* rad,
           void* mask, void* idx_out, int G, int N, int K, int nr, void* stream) {
  const long long slots = (long long)G * N * K;
  if (slots == 0) return 0;
  const int threads = 256;
  const long long blocks = (slots + threads - 1) / threads;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  nbr_edge_features_kernel<T><<<(unsigned)blocks, threads, 0, (cudaStream_t)stream>>>(
      (const float*)pos, (const int64_t*)idx, (const uint8_t*)sup, cutoff, (T*)sh, (T*)rad,
      (float*)mask, (int64_t*)idx_out, G, N, K, nr);
  return (int)cudaGetLastError();
}

}  // namespace

#define NBR_EDGE_FEATURES_ENTRY(NAME, TYPE)                                                   \
  extern "C" int NAME(const void* pos, const void* idx, const void* sup, float cutoff,       \
                      void* sh, void* rad, void* mask, void* idx_out, int G, int N, int K,   \
                      int nr, void* stream) {                                                \
    return launch<TYPE>(pos, idx, sup, cutoff, sh, rad, mask, idx_out, G, N, K, nr, stream); \
  }

NBR_EDGE_FEATURES_ENTRY(nbr_edge_features_f32, float)
NBR_EDGE_FEATURES_ENTRY(nbr_edge_features_bf16, __nv_bfloat16)
