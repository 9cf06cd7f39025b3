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
// one-hot matmuls over 128-atom source blocks; here a thread reads its
// slot's source position directly (12 bytes per atom, cached in L1/L2).
//
// Bound on the H100: bytes. A slot reads its index and flag and writes
// 4 + NR values in T, a f32 mask and an int64 index (84 bytes in bf16 with
// NR = 32); its NR expf stay well inside the FP32 rate, once each lane
// computes one value. A first design ran one thread per slot and wrote its
// 64-byte radial row as 32 scalar stores, so each warp store touched 32
// rows. Here a CTA owns a tile of at most 256 slots of one graph (whole
// destination rows of K slots, or one row's chunk when K is larger), so its
// outputs are contiguous runs and a thread's indices are 32-bit offsets
// from the CTA's 64-bit base. Two steps, two barriers:
//   1. one thread per slot: the distance, the mask and the folded index
//      (coalesced stores), the sh row as one 8-byte (bf16) or 16-byte (f32)
//      store, the distance staged in shared memory;
//   2. one warp per slot, one lane per radial channel: the radial rows
//      staged in shared memory, then written out as the tile's one run with
//      16-byte vector stores (the staging buffer sits at the output's offset
//      modulo 16).
// The tiles, the radial step and the copy out are edge_tiles.cuh's,
// shared with the edge-features kernel.
//
// The geometry is edge_geometry.cuh's rounded intrinsics, shared with the
// edge-features kernel, the whole-model kernel and the tiled kernel and
// followed by the plain versions, so the cutoff test agrees entry for entry
// and every value is the one the first design wrote, bit for bit.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "edge_geometry.cuh"
#include "edge_tiles.cuh"

namespace {

using edge_geometry::pair_dist;
using edge_geometry::sh_component;

using namespace edge_tiles;

// the sh row [0, y, z, x] as one store
__device__ __forceinline__ void put_sh(float* p, float y, float z, float x) {
  *reinterpret_cast<float4*>(p) = make_float4(0.0f, y, z, x);
}
__device__ __forceinline__ void put_sh(__nv_bfloat16* p, float y, float z, float x) {
  __nv_bfloat162 lo = __halves2bfloat162(__float2bfloat16_rn(0.0f), __float2bfloat16_rn(y));
  __nv_bfloat162 hi = __halves2bfloat162(__float2bfloat16_rn(z), __float2bfloat16_rn(x));
  uint2 v;
  v.x = *reinterpret_cast<uint32_t*>(&lo);
  v.y = *reinterpret_cast<uint32_t*>(&hi);
  *reinterpret_cast<uint2*>(p) = v;
}

struct Params {
  const float* pos;
  const int64_t* idx;
  const uint8_t* sup;
  float cutoff;
  void* sh;
  void* rad;
  float* mask;
  int64_t* idx_out;
  int G, N, K, nr, cap;  // cap: the slots of the largest tile
  Tiling tl;             // [N, K] slots per graph
};

template <typename T>
__global__ void __launch_bounds__(kThreads) nbr_edge_features_kernel(const Params p) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int g = (int)blockIdx.x / p.tl.per_graph;
  const Tile t = tile_at((int)blockIdx.x - g * p.tl.per_graph, p.N, p.K, p.tl);
  const int n = t.rows * t.cols;
  const long long base = ((long long)g * p.N + t.i0) * p.K + t.j0;  // the tile's first slot
  T* rad = (T*)p.rad + base * p.nr;
  T* stage = (T*)smem + (((uintptr_t)rad & 15) / sizeof(T));
  float* dists = (float*)(smem + smem_bytes(p.cap, p.nr, sizeof(T)) - p.cap * sizeof(float));

  // step 1: one thread per slot
  const int s = threadIdx.x;
  if (s < n) {
    const long long slot = base + s;
    const float* gpos = p.pos + (long long)g * p.N * 3;
    const float* pi = gpos + (t.i0 + s / t.cols) * 3;
    const bool in_superset = p.sup[slot] != 0;
    const int64_t nbr = p.idx[slot];
    const float* pj = in_superset ? gpos + nbr * 3 : pi;
    const float dx = pj[0] - pi[0];
    const float dy = pj[1] - pi[1];
    const float dz = pj[2] - pi[2];
    const float dist = pair_dist(dx, dy, dz);
    const bool kept = in_superset && dist < p.cutoff;
    put_sh((T*)p.sh + slot * 4, sh_component(dy, dist), sh_component(dz, dist),
           sh_component(dx, dist));
    p.mask[slot] = kept ? 1.0f : 0.0f;
    p.idx_out[slot] = kept ? nbr : (int64_t)p.N;
    dists[s] = dist;
  }
  __syncthreads();
  stage_radial(stage, dists, n, p.nr, p.nr, __fdiv_rn(p.cutoff, (float)(p.nr + 1)));
  __syncthreads();
  copy_out(stage, rad, n * p.nr);
}

template <typename T>
Params make_params(const void* pos, const void* idx, const void* sup, float cutoff, void* sh,
                   void* rad, void* mask, void* idx_out, int G, int N, int K, int nr) {
  const int slots = tile_edges(nr, sizeof(T));
  const Tiling tl = tiling(N, K, slots);
  return Params{(const float*)pos, (const int64_t*)idx, (const uint8_t*)sup, cutoff, sh, rad,
                (float*)mask, (int64_t*)idx_out, G, N, K, nr, tile_cap(tl, N), tl};
}

template <typename T>
int launch(const Params& p, void* stream) {
  if ((long long)p.G * p.N * p.K == 0) return 0;
  const long long ctas = (long long)p.G * p.tl.per_graph;
  if (tile_edges(p.nr, sizeof(T)) < 1 || ctas > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  // at most kStageBytes staged: under the 48 KB a CTA takes without opting in
  const size_t smem = smem_bytes(p.cap, p.nr, sizeof(T));
  nbr_edge_features_kernel<T><<<(unsigned)ctas, kThreads, smem, (cudaStream_t)stream>>>(p);
  return (int)cudaGetLastError();
}

// out = {threads, bytes of shared memory per CTA, registers per thread,
// local (spill) bytes per thread, CTAs resident per SM, slots in the largest
// tile, destination rows per tile, CTAs}
template <typename T>
int occupancy(int G, int N, int K, int nr, int* out) {
  const Params p = make_params<T>(nullptr, nullptr, nullptr, 0.0f, nullptr, nullptr, nullptr,
                                  nullptr, G, N, K, nr);
  if (tile_edges(nr, sizeof(T)) < 1) return (int)cudaErrorInvalidValue;
  const size_t smem = smem_bytes(p.cap, nr, sizeof(T));
  cudaFuncAttributes attr;
  cudaError_t err = cudaFuncGetAttributes(&attr, nbr_edge_features_kernel<T>);
  if (err != cudaSuccess) return (int)err;
  int ctas = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&ctas, nbr_edge_features_kernel<T>, kThreads,
                                                      smem);
  if (err != cudaSuccess) return (int)err;
  const int values[8] = {kThreads, (int)smem, attr.numRegs, (int)attr.localSizeBytes, ctas,
                         p.cap, p.tl.rows, (int)((long long)G * p.tl.per_graph)};
  for (int k = 0; k < 8; ++k) out[k] = values[k];
  return 0;
}

}  // namespace

#define NBR_EDGE_FEATURES_ENTRY(NAME, TYPE)                                                   \
  extern "C" int NAME(const void* pos, const void* idx, const void* sup, float cutoff,       \
                      void* sh, void* rad, void* mask, void* idx_out, int G, int N, int K,   \
                      int nr, void* stream) {                                                \
    return launch<TYPE>(make_params<TYPE>(pos, idx, sup, cutoff, sh, rad, mask, idx_out, G,  \
                                          N, K, nr),                                         \
                        stream);                                                             \
  }

NBR_EDGE_FEATURES_ENTRY(nbr_edge_features_f32, float)
NBR_EDGE_FEATURES_ENTRY(nbr_edge_features_bf16, __nv_bfloat16)

// How a build (bf16 = 0: f32) is launched at these sizes and what the card
// makes of it (see `occupancy`)
extern "C" int nbr_edge_features_occupancy(int bf16, int G, int N, int K, int nr, int* out) {
  return bf16 ? occupancy<__nv_bfloat16>(G, N, K, nr, out) : occupancy<float>(G, N, K, nr, out);
}
