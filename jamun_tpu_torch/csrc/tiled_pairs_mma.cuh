// The bf16 CTA of the kernels that build their pairs from the positions:
// the tiled ConvBlock (fused_block_tiled.cu, K5) and the dense messages
// (dense_conv.cu, K8 and K9). It owns TDM = 16 destination atoms of one
// graph, as the bf16 per-layer kernel (conv_block.cu) does, and runs the
// same tensor-core steps (conv_block_mma.cuh) on pairs that it lists and
// whose geometry it rebuilds itself:
//   - the graph's positions and node mask go to shared memory as one float4
//     per atom, beside the radial weights' 16-byte loads issued first;
//   - the pairs inside the cutoff (and, for K5, the real bonds into the
//     CTA's atoms) are listed dst-major by every warp at once, one dst atom
//     per warp: a pass that counts, then a pass that writes at the sum of
//     the earlier atoms' counts. A bond entry holds its source atom, so a
//     tile reads no bond array;
//   - per tile of PT entries, the spherical harmonics and the NR radial
//     values are recomputed with edge_geometry.cuh's rounded intrinsics and
//     rounded to bf16 where the edge-features kernel stores them, straight
//     into the A operand of radial layer 1, beside the pairs' source rows;
//   - radial layer 1, then layer 2 with the messages, warp by warp
//     (mma::radial_layer1, mma::layer2_messages), into the same ChannelSum
//     and accumulators as the per-layer kernel.
// With the same pairs in the same order, the tiled ConvBlock's bf16 build
// gives the per-layer kernel's bf16 outputs bit for bit.
//
// The range of N. The per-layer kernel keeps the whole pair list of its 16
// atoms (16 N + B entries) and its source atoms beside it. Here the list
// covers J sources at a time: the CTA walks the sources in passes of J, each
// pass listing its pairs (dst-major, the bonds in the last pass) and running
// their tiles, with the running sums carried over. J is every source where
// the list of 16 N + B entries fits a block's shared memory, else the largest
// multiple of 32 that fits; at the flagship width a graph needs one pass up
// to about 950 atoms (hidden block, two bonds per atom). Shared memory then
// grows by 16 bytes per atom (the positions), and the pass list and its
// tiles share one region with the epilogue's tiles (K5), which run after the
// last pass. Over passes the f32 sums of an atom are grouped otherwise than
// in one pass; J is picked from the shape by `layout`, which the launchers
// and the libraries' queries read.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "conv_block_body.cuh"
#include "conv_block_mma.cuh"
#include "edge_geometry.cuh"

namespace conv_block {
namespace tiled {

using bf16 = __nv_bfloat16;

// destination atoms per CTA: a full m-tile of the epilogue's products
constexpr int TDM = 16;
static_assert(TDM <= 16, "the dst slot takes 4 bits of pair_info and 12 of a list entry");

// shared memory of one CTA: what lives through it (accumulators, degree,
// counts, the list's length), then one region that the pair loop (the
// positions, the tile's pair data, the operand tiles, the source rows and
// the pass list) and, after it, the epilogue's tiles share
struct Layout {
  size_t acc, deg, counts, n_list, region, pos, ps4, pair, rows, list, total;
  int J;       // sources per pass
  bool stage;  // the epilogue stages its B operands
};

// the layout at these sizes; Sc + Vg == 0 for the dense messages (no
// epilogue) and B == 0 without bonds
__host__ __device__ inline Layout layout(int N, int B, int S, int V, int Sc, int Vg, int nt) {
  using namespace conv_block::mma;
  const int W = 2 * S + 3 * V, F = S + 3 * V;
  Layout l;
  l.acc = 0;
  l.deg = l.acc + align16((size_t)TDM * 3 * nt * 4);
  l.counts = l.deg + align16((size_t)TDM * 4);
  l.n_list = l.counts + align16((size_t)TDM * 4);
  l.region = l.n_list + 16;
  l.pos = l.region;
  l.ps4 = l.pos + align16((size_t)N * 16);
  l.pair = l.ps4 + align16((size_t)PT * 16);
  l.rows = l.pair + pair_tiles_bytes(W);
  l.list = l.rows + align16((size_t)PT * F * 2);
  // one pass where its list fits, else the largest multiple of 32 (at least 32)
  const long long entries = ((long long)MAX_SMEM_BYTES - (long long)l.list) / 16 * 4 - B;
  if (entries >= (long long)TDM * N)
    l.J = N;
  else
    l.J = entries >= (long long)TDM * 32 ? (int)(entries / TDM) / 32 * 32 : 32;
  const size_t pair_end = l.list + align16(((size_t)TDM * l.J + B) * 4);
  size_t total[2] = {pair_end, pair_end};
  if (Sc + Vg > 0) {
    for (int stage = 0; stage < 2; ++stage) {
      const size_t epi_end = l.region + epilogue_tiles_bytes(S, V, Sc + Vg, Vg, Sc, Vg, TDM, stage);
      total[stage] = pair_end > epi_end ? pair_end : epi_end;
    }
  }
  l.stage = Sc + Vg > 0 && stage_fits(total[1], total[0]);
  l.total = total[l.stage];
  return l;
}

// the graph's geometry: positions and node mask [N], bonds [B] (or none)
struct Geometry {
  const float* pos;          // [N, 3] scaled positions
  const uint8_t* node_mask;  // [N]
  const int64_t* bond_src;   // [B]
  const int64_t* bond_dst;   // [B]
  const uint8_t* bond_mask;  // [B]
  float cutoff;
  int N, B;
};

// the pair loop of the CTA's nd atoms from i0 on: the messages of every
// listed pair summed into s.acc ([TDM][3][nt], zeroed here) and the number
// of entries per atom into s.deg; ends with the last flush behind a barrier
__device__ __forceinline__ void pair_loop(const Layout& l, char* base, const Scratch& s,
                                          const Geometry& geo, const Weights& w, const bf16* x,
                                          int S, int V, int i0, int nd, int tid, int nt) {
  using edge_geometry::pair_dist;
  using edge_geometry::radial_basis;
  using edge_geometry::sh_component;
  const int N = geo.N, B = geo.B, F = S + 3 * V, W = 2 * S + 3 * V, J = l.J;
  const int warp = tid >> 5, lane = tid & 31, nwarps = nt >> 5;
  float4* pos4 = (float4*)(base + l.pos);  // x, y, z, 1 for a real atom
  float4* ps4 = (float4*)(base + l.ps4);
  int* counts = (int*)(base + l.counts);
  int* n_list = (int*)(base + l.n_list);
  int* list = (int*)(base + l.list);
  const mma::PairTiles t = mma::carve_pair_tiles(base + l.pair, W);
  bf16* xt = (bf16*)(base + l.rows);

  mma::load_pair_weights(t, w, W, tid, nt);
  for (int k = tid; k < TDM * 3 * nt; k += nt) s.acc[k] = 0.0f;
  if (tid < TDM) s.deg[tid] = 0.0f;
  for (int k = tid; k < N; k += nt)
    pos4[k] = make_float4(geo.pos[3 * k], geo.pos[3 * k + 1], geo.pos[3 * k + 2],
                          geo.node_mask[k] ? 1.0f : 0.0f);
  __syncthreads();

  // the pairs of dst slot td with sources j0..j1-1 inside the cutoff, by
  // source, then (with `bonds`) the real bonds into it; one warp, all lanes.
  // Returns their number; with at >= 0 the entries go to list[at ...].
  const unsigned lt = (1u << lane) - 1u;
  auto scan = [&](int td, int j0, int j1, bool bonds, int at) {
    const int i = i0 + td;
    const float4 pi = pos4[i];
    int count = 0;
    if (pi.w != 0.0f) {
      for (int jb = j0; jb < j1; jb += 32) {
        const int j = jb + lane;
        bool a = false;
        if (j < j1 && j != i) {
          const float4 pj = pos4[j];
          a = pj.w != 0.0f && pair_dist(pj.x - pi.x, pj.y - pi.y, pj.z - pi.z) < geo.cutoff;
        }
        const unsigned m = __ballot_sync(0xffffffffu, a);
        if (a && at >= 0) list[at + count + __popc(m & lt)] = encode(td, 0, j);
        count += __popc(m);
      }
    }
    if (bonds) {
      for (int b0 = 0; b0 < B; b0 += 32) {
        const int b = b0 + lane;
        const bool a = b < B && geo.bond_dst[b] == i && geo.bond_mask[b];
        const unsigned m = __ballot_sync(0xffffffffu, a);
        if (a && at >= 0) list[at + count + __popc(m & lt)] = encode(td, 1, (int)geo.bond_src[b]);
        count += __popc(m);
      }
    }
    return count;
  };

  constexpr int L1 = mma::ld_of(NR);
  const mma::TileRows xq{xt, F};
  const bool x16 = (F & 7) == 0 && ((uintptr_t)x & 15) == 0;
  ChannelSum st;
  for (int j0 = 0; j0 < N; j0 += J) {
    const int j1 = min(N, j0 + J);
    const bool bonds = j1 == N && B > 0;
    for (int td = warp; td < nd; td += nwarps) {
      const int count = scan(td, j0, j1, bonds, -1);
      if (lane == 0) counts[td] = count;
    }
    __syncthreads();
    for (int td = warp; td < nd; td += nwarps) {
      int at = 0;
      for (int u = 0; u < td; ++u) at += counts[u];
      scan(td, j0, j1, bonds, at);
      if (lane == 0) s.deg[td] += (float)counts[td];
    }
    if (tid == 0) {
      int total = 0;
      for (int u = 0; u < nd; ++u) total += counts[u];
      *n_list = total;
    }
    __syncthreads();
    const int nl = *n_list;

    for (int t0 = 0; t0 < nl; t0 += PT) {
      const int np = min(PT, nl - t0);
      const int* tile = list + t0;
      // stage the tile: per pair its dst slot and spherical harmonics, its
      // NR radial values (4 per thread, the distance recomputed) as layer
      // 1's A operand, and its source row
      if (tid < PT) {
        int td = 0;
        float s0 = 0.0f, s1 = 0.0f, s2 = 0.0f;
        if (tid < np) {
          const int e = tile[tid];
          td = entry_slot(e);
          const float4 a = pos4[i0 + td], b = pos4[entry_index(e)];
          const float dx = b.x - a.x, dy = b.y - a.y, dz = b.z - a.z;
          const float dist = pair_dist(dx, dy, dz);
          s0 = rnd<bf16>(sh_component(dy, dist));
          s1 = rnd<bf16>(sh_component(dz, dist));
          s2 = rnd<bf16>(sh_component(dx, dist));
        }
        ps4[tid] = mma::pair_info(s0, s1, s2, td, 0);
      }
      for (int o = tid; o < PT * (NR / 4); o += nt) {
        const int q = o / (NR / 4), k = 4 * (o % (NR / 4));
        uint2 v = make_uint2(0u, 0u);
        if (q < np) {
          const int e = tile[q];
          const float4 a = pos4[i0 + entry_slot(e)], b = pos4[entry_index(e)];
          const float dist = pair_dist(b.x - a.x, b.y - a.y, b.z - a.z);
          v.x = mma::pack2(radial_basis(k, dist, geo.cutoff, NR),
                           radial_basis(k + 1, dist, geo.cutoff, NR));
          v.y = mma::pack2(radial_basis(k + 2, dist, geo.cutoff, NR),
                           radial_basis(k + 3, dist, geo.cutoff, NR));
        }
        *reinterpret_cast<uint2*>(t.rs + q * L1 + k) = v;
      }
      if (x16) {
        const int chunks = F / 8;
        for (int o = tid; o < np * chunks; o += nt) {
          const int q = o / chunks, part = o % chunks;
          reinterpret_cast<uint4*>(xt + q * F)[part] = __ldg(
              reinterpret_cast<const uint4*>(x + (long long)entry_index(tile[q]) * F) + part);
        }
      } else {
        for (int o = tid; o < np * F; o += nt) {
          const int q = o / F, ch = o % F;
          xt[o] = x[(long long)entry_index(tile[q]) * F + ch];
        }
      }
      __syncthreads();
      mma::radial_layer1(t, w, tile, np, warp, nwarps, lane);
      __syncthreads();
      mma::layer2_messages(s, ps4, t, xq, w.b2, W, np, S, V, warp, lane, nt, st);
      __syncthreads();
    }
  }
  flush(s, st, tid, tid < W, nt);
  __syncthreads();
}

}  // namespace tiled
}  // namespace conv_block
