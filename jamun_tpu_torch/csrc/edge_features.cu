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
// Bound on the H100: its instructions, then its bytes. The kernel is a
// streaming write of G*(N*N + B)*EC elements, but every radial value costs
// one IEEE division and one expf. A first design ran one thread per output
// element and spent about 150 instructions on each (index divisions, the
// pair's distance and 1/dist again for every channel). Here a CTA owns a
// tile of at most 256 edges of one graph: whole rows of destination atoms
// (a row of N pairs, or of a graph's B bonds) or, for a row longer than the
// tile, one chunk of it, so the tile's outputs are one contiguous run and
// its indices come from the CTA's number and the thread's, with one
// division each. Three steps, two barriers:
//   1. one thread per edge: the distance, the flag and the three sh values,
//      staged in shared memory in the output's layout, the distance beside;
//   2. one warp per edge, one lane per radial channel: the radial basis,
//      staged beside the geometry;
//   3. the tile's run written out with 16-byte vector stores (a scalar head
//      and tail; the staging buffer sits at the output's offset modulo 16).
// Several CTAs share an SM, so one CTA's stores overlap another's
// arithmetic; a plain store does not hold the staging buffer, so it needs
// no second one.
//
// Formulas (as _geom_radial_rows) in edge_geometry.cuh, the tiles, the
// radial step and the copy out in edge_tiles.cuh (shared with K7);
// adj = (dist < cutoff) & mask_i & mask_j & (i != j). The geometry uses
// rounded intrinsics and the source is built with --fmad=false, so the
// distance (and the cutoff test) rounds as the plain version's does, and
// every value is the one the first design wrote, bit for bit.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "edge_geometry.cuh"
#include "edge_tiles.cuh"

namespace {

using edge_geometry::pair_dist;
using edge_geometry::sh_component;

using namespace edge_tiles;

constexpr long long kMaxElements = 0x7fffffffLL - 65536LL * 256LL;  // the wrapper's limit

struct Params {
  const float* pos;
  const uint8_t* node_mask;
  const int64_t* bond_src;
  const int64_t* bond_dst;
  const uint8_t* bond_mask;
  float cutoff;
  void* ef;
  void* bf;
  int G, N, B, nr, cap;  // cap: the edges of the largest tile
  Tiling dense, bonds;   // [N, N] pairs and [1, B] bonds per graph
};

template <typename T>
__global__ void __launch_bounds__(kThreads) edge_features_kernel(const Params p) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int ec = 4 + p.nr;
  const int n_dense = p.G * p.dense.per_graph;
  const bool dense = (int)blockIdx.x < n_dense;
  const int b = dense ? (int)blockIdx.x : (int)blockIdx.x - n_dense;
  const Tiling tl = dense ? p.dense : p.bonds;  // a copy: a reference would copy p to local memory
  const int g = b / tl.per_graph;
  const Tile t = dense ? tile_at(b - g * tl.per_graph, p.N, p.N, tl)
                       : tile_at(b - g * tl.per_graph, 1, p.B, tl);
  const int n = t.rows * t.cols;
  // the tile's run: whole rows or one row's chunk of [G, rows, len, EC]
  T* dst = dense ? (T*)p.ef + (((long long)g * p.N + t.i0) * p.N + t.j0) * ec
                 : (T*)p.bf + ((long long)g * p.B + t.j0) * ec;
  T* stage = (T*)smem + (((uintptr_t)dst & 15) / sizeof(T));
  float* dists = (float*)(smem + smem_bytes(p.cap, ec, sizeof(T)) - p.cap * sizeof(float));

  // step 1: one thread per edge
  const int e = threadIdx.x;
  if (e < n) {
    const int rr = e / t.cols, jj = e - rr * t.cols;
    const float* gpos = p.pos + (long long)g * p.N * 3;
    float dx, dy, dz, flag;
    if (dense) {
      const int i = t.i0 + rr, j = t.j0 + jj;
      const float* pi = gpos + i * 3;
      const float* pj = gpos + j * 3;
      dx = pj[0] - pi[0], dy = pj[1] - pi[1], dz = pj[2] - pi[2];
      const uint8_t* m = p.node_mask + (long long)g * p.N;
      flag = (pair_dist(dx, dy, dz) < p.cutoff && i != j && m[i] && m[j]) ? 1.0f : 0.0f;
    } else {
      const long long k = (long long)g * p.B + t.j0 + jj;
      const float* ps = gpos + (int)p.bond_src[k] * 3;
      const float* pd = gpos + (int)p.bond_dst[k] * 3;
      dx = ps[0] - pd[0], dy = ps[1] - pd[1], dz = ps[2] - pd[2];
      flag = p.bond_mask[k] ? 1.0f : 0.0f;
    }
    const float dist = pair_dist(dx, dy, dz);
    T* row = stage + e * ec;
    put(row + 0, sh_component(dy, dist));
    put(row + 1, sh_component(dz, dist));
    put(row + 2, sh_component(dx, dist));
    put(row + 3, flag);
    dists[e] = dist;
  }
  __syncthreads();
  stage_radial(stage, dists, n, ec, p.nr, __fdiv_rn(p.cutoff, (float)(p.nr + 1)));
  __syncthreads();
  copy_out(stage, dst, n * ec);
}

template <typename T>
Params make_params(const void* pos, const void* node_mask, const void* bond_src,
                   const void* bond_dst, const void* bond_mask, float cutoff, void* ef, void* bf,
                   int G, int N, int B, int nr) {
  const int edges = tile_edges(4 + nr, sizeof(T));
  const Tiling dense = tiling(N, N, edges), bonds = tiling(1, B, edges);
  const int cap_dense = tile_cap(dense, N), cap_bonds = tile_cap(bonds, 1);
  const int cap = cap_dense > cap_bonds ? cap_dense : cap_bonds;
  return Params{(const float*)pos, (const uint8_t*)node_mask, (const int64_t*)bond_src,
                (const int64_t*)bond_dst, (const uint8_t*)bond_mask, cutoff, ef, bf, G, N, B, nr,
                cap, dense, bonds};
}

long long ctas_of(const Params& p) {
  return (long long)p.G * (p.dense.per_graph + p.bonds.per_graph);
}

template <typename T>
int launch(const Params& p, void* stream) {
  const long long total = ((long long)p.G * p.N * p.N + (long long)p.G * p.B) * (4 + p.nr);
  if (total == 0) return 0;
  if (total > kMaxElements || tile_edges(4 + p.nr, sizeof(T)) < 1) return (int)cudaErrorInvalidValue;
  // at most kStageBytes staged: under the 48 KB a CTA takes without opting in
  const size_t smem = smem_bytes(p.cap, 4 + p.nr, sizeof(T));
  edge_features_kernel<T><<<(unsigned)ctas_of(p), kThreads, smem, (cudaStream_t)stream>>>(p);
  return (int)cudaGetLastError();
}

// out = {threads, bytes of shared memory per CTA, registers per thread,
// local (spill) bytes per thread, CTAs resident per SM, edges in the largest
// tile, rows of pairs per tile, CTAs}
template <typename T>
int occupancy(int G, int N, int B, int nr, int* out) {
  const Params p = make_params<T>(nullptr, nullptr, nullptr, nullptr, nullptr, 0.0f, nullptr,
                                  nullptr, G, N, B, nr);
  if (tile_edges(4 + nr, sizeof(T)) < 1) return (int)cudaErrorInvalidValue;
  const size_t smem = smem_bytes(p.cap, 4 + nr, sizeof(T));
  cudaFuncAttributes attr;
  cudaError_t err = cudaFuncGetAttributes(&attr, edge_features_kernel<T>);
  if (err != cudaSuccess) return (int)err;
  int ctas = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&ctas, edge_features_kernel<T>, kThreads, smem);
  if (err != cudaSuccess) return (int)err;
  const int values[8] = {kThreads, (int)smem, attr.numRegs, (int)attr.localSizeBytes, ctas,
                         p.cap, p.dense.rows, (int)ctas_of(p)};
  for (int k = 0; k < 8; ++k) out[k] = values[k];
  return 0;
}

}  // namespace

#define EDGE_FEATURES_ENTRY(NAME, TYPE)                                                        \
  extern "C" int NAME(const void* pos, const void* node_mask, const void* bond_src,           \
                      const void* bond_dst, const void* bond_mask, float cutoff, void* ef,    \
                      void* bf, int G, int N, int B, int nr, void* stream) {                  \
    return launch<TYPE>(make_params<TYPE>(pos, node_mask, bond_src, bond_dst, bond_mask,     \
                                          cutoff, ef, bf, G, N, B, nr),                       \
                        stream);                                                              \
  }

EDGE_FEATURES_ENTRY(edge_features_f32, float)
EDGE_FEATURES_ENTRY(edge_features_bf16, __nv_bfloat16)

// How a build (bf16 = 0: f32) is launched at these sizes and what the card
// makes of it (see `occupancy`)
extern "C" int edge_features_occupancy(int bf16, int G, int N, int B, int nr, int* out) {
  return bf16 ? occupancy<__nv_bfloat16>(G, N, B, nr, out) : occupancy<float>(G, N, B, nr, out);
}
