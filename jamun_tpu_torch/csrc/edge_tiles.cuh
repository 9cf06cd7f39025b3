// The tiles of the two edge-feature kernels (edge_features.cu, K1, and
// nbr_edge_features.cu, K7), included by those two sources alone: a CTA of
// kThreads threads owns a tile of at most kMaxEdges edges of one graph
// (whole rows of a graph's [rows, len] edges, or one chunk of a row longer
// than the tile), stages the tile's rows in shared memory in the output's
// layout and writes them out as one run of 16-byte stores.
//
// The radial values are edge_geometry::radial_basis with its step and center
// hoisted: the same operations in the same order, so every value is the one
// edge_geometry.cuh gives, bit for bit (the sources are built with
// --fmad=false).

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

namespace edge_tiles {

constexpr int kThreads = 256;
constexpr int kMaxEdges = kThreads;  // edges per tile: one per thread in step 1
constexpr int kStageBytes = 36864;   // staged rows per CTA at most: 256 f32 rows of K1's EC = 36

__device__ __forceinline__ void put(float* p, float v) { *p = v; }
__device__ __forceinline__ void put(__nv_bfloat16* p, float v) { *p = __float2bfloat16_rn(v); }

// edge_geometry::radial_basis with its step and its center (k + 1) * step
// hoisted: the same operations in the same order
__device__ __forceinline__ float radial_at(float center, float dist, float step) {
  float diff = __fdiv_rn(__fsub_rn(dist, center), step);
  return __fmul_rn(expf(-__fmul_rn(diff, diff)), 1.0f / 1.12f);
}

__device__ __forceinline__ float center_of(int k, float step) {
  return __fmul_rn((float)(k + 1), step);
}

// How one graph's [rows, len] edges split into tiles of at most `edges`:
// whole rows (cols == len) or chunks of one row
struct Tiling {
  int rows, cols, chunks, per_graph;  // rows and columns per tile, chunks per row, tiles per graph
};

__host__ __device__ inline Tiling tiling(int rows, int len, int edges) {
  if (rows == 0 || len == 0 || edges < 1) return {0, 0, 1, 0};
  if (len <= edges) {
    const int r = edges / len;
    return {r, len, 1, (rows + r - 1) / r};
  }
  const int chunks = (len + edges - 1) / edges;
  return {1, edges, chunks, rows * chunks};
}

// edges per tile for rows of `values` staged values of `esz` bytes
__host__ __device__ inline int tile_edges(int values, int esz) {
  const int e = kStageBytes / (values * esz);
  return e < kMaxEdges ? e : kMaxEdges;
}

// shared bytes of a CTA: `edges` staged rows of `values` values (and the
// shift that aligns them with their output), then a f32 distance per edge
__host__ __device__ inline size_t smem_bytes(int edges, int values, int esz) {
  const size_t stage = ((size_t)edges * values * esz + 16 + 15) / 16 * 16;
  return stage + (size_t)edges * sizeof(float);
}

// edges in the largest tile of a tiling of [rows, len]
__host__ __device__ inline int tile_cap(const Tiling& tl, int rows) {
  return (tl.rows < rows ? tl.rows : rows) * tl.cols;
}

// A tile of one graph: rows [i0, i0 + rows), columns [j0, j0 + cols)
struct Tile {
  int i0, j0, rows, cols;
};

__device__ __forceinline__ Tile tile_at(int t, int n_rows, int len, const Tiling& tl) {
  if (tl.chunks == 1) {
    const int i0 = t * tl.rows;
    return {i0, 0, min(tl.rows, n_rows - i0), len};
  }
  const int i0 = t / tl.chunks, j0 = (t - i0 * tl.chunks) * tl.cols;
  return {i0, j0, 1, min(tl.cols, len - j0)};
}

// One warp per staged edge, one lane per radial channel; the n staged rows
// are ec values apart, the radial basis their last nr
template <typename T>
__device__ __forceinline__ void stage_radial(T* stage, const float* dists, int n, int ec, int nr,
                                             float step) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  T* rows = stage + (ec - nr);
  if (nr <= 32) {  // a lane's one channel and its center, for every edge
    if (lane >= nr) return;
    const float center = center_of(lane, step);
    for (int p = warp; p < n; p += kThreads / 32)
      put(rows + p * ec + lane, radial_at(center, dists[p], step));
    return;
  }
  for (int p = warp; p < n; p += kThreads / 32) {
    const float dist = dists[p];
    for (int k = lane; k < nr; k += 32)
      put(rows + p * ec + k, radial_at(center_of(k, step), dist, step));
  }
}

// n staged elements to dst, 16 bytes a store (a scalar head and tail);
// stage and dst agree modulo 16 bytes
template <typename T>
__device__ __forceinline__ void copy_out(const T* stage, T* __restrict__ dst, int n) {
  constexpr int kVec = 16 / sizeof(T);
  int head = (int)(((16 - ((uintptr_t)dst & 15)) & 15) / sizeof(T));
  head = head < n ? head : n;
  const int nv = (n - head) / kVec;
  for (int e = threadIdx.x; e < head; e += kThreads) dst[e] = stage[e];
  const int4* s4 = reinterpret_cast<const int4*>(stage + head);
  int4* d4 = reinterpret_cast<int4*>(dst + head);
  for (int v = threadIdx.x; v < nv; v += kThreads) d4[v] = s4[v];
  for (int e = head + nv * kVec + threadIdx.x; e < n; e += kThreads) dst[e] = stage[e];
}

}  // namespace edge_tiles
