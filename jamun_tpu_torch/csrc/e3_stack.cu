// The whole E3Conv arch forward of one walk step in one launch: edge
// geometry, the projector ConvBlock (S_emb scalars in, no vectors), L hidden
// layers [noise scale -> ConvBlock -> noise-conditioned skip blend] and the
// EquivariantMLP head, per graph, with nothing but the output going back to
// device memory.
//
// Replaces the TPU kernel `_stack_kernel` of
// jamun_tpu/ops/pallas/e3_stack.py (pallas_call at line 367, entry
// `packed_e3conv_stack`). The TPU kernel keeps the [EFR, N*N] edge features
// of K graphs in VMEM and runs every one of the N*N pairs through one-hot
// aggregation matmuls. Here a thread-block cluster owns one graph: 1, 2 or
// 4 CTAs (8 only where shared memory forces it), each keeping the role a
// CTA has in the per-layer kernel (conv_block.cu) for its share of at most
// 16 destination atoms (N <= 64) across all L + 1 blocks:
//   - the list of visited pairs (inside the cutoff, and bonds into its
//     atoms) is built once from the positions; the [N, N, 36] edge features
//     never exist: a tile's spherical harmonics and 32 radial values are
//     recomputed from the positions in shared memory for every block (32
//     expf against ~50 kflop of radial MLP per pair), rounded where the
//     edge-features kernel rounds them (edge_geometry.cuh);
//   - each CTA carries its atoms' features x in f32 in its own shared
//     memory; before a block every CTA copies all N atoms' scaled, rounded
//     inputs out of the cluster's shared memory (distributed shared memory)
//     into its own, so the pair loop reads sources locally;
//   - one cluster.sync() per block separates a block's writes from the next
//     block's reads (the inputs ping-pong between two buffers);
//   - the head runs on the CTA's own atoms.
// The ConvBlock steps are the device code of conv_block_body.cuh (the f32
// build, e3_stack_kernel<float>: FP32 FMAs) and conv_block_mma.cuh (the
// bf16 build, e3_stack_mma_kernel: the radial MLP, every block's epilogue
// and the head's four products on the tensor cores, mma.sync m16n8k16 bf16
// -> f32, with the FMA build's rounding points).
//
// Bound on the H100: by its peaks, operations (the radial MLP of every
// visited pair in every block; ~0.04 ms at 4AA in bf16). What bounds it on
// this card is latency, as in conv_block.cu: per block a CTA of ~11 atoms
// runs ~4 tiles of dependent shared-memory and L2 reads at one CTA per SM
// (the weights' loads, layer 2 with the messages and the epilogue's
// products take most of it, clock64 stamps). The bf16 build issues each
// block's weights as 16-byte loads together, copies the cluster's inputs 16
// bytes at a time, and shares conv_block_mma.cuh's prefetching message and
// epilogue steps. Beyond the per-layer kernel's limits: a cluster waits for
// its slowest CTA at every block, and a cluster needs all its CTAs resident
// at once on one GPC (at one CTA per SM, clusters of 4 fill a GPC of 16 or
// 18 SMs and clusters of 6 do not, which is why N = 44 runs as 4 x 11 atoms
// and not 6 x 8: see shape_for).
//
// Rounding points are `_stack_kernel`'s: x carried in f32 across layers,
// scaled then cast (xs = T(x * scale)), blended in f32; in the head f32
// accumulation out of every product, sigmoid and leaky-ReLU in f32, the
// activated scalars and the gated vectors cast to T once.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "conv_block_body.cuh"
#include "conv_block_mma.cuh"
#include "edge_geometry.cuh"

namespace {

namespace cg = cooperative_groups;
using namespace conv_block;
using edge_geometry::pair_dist;
using edge_geometry::radial_basis;
using edge_geometry::sh_component;

struct StackParams {
  const float* pos;          // [G, N, 3] scaled positions
  const uint8_t* node_mask;  // [G, N]
  const int64_t* bond_src;   // [G, B]
  const int64_t* bond_dst;   // [G, B]
  const uint8_t* bond_mask;  // [G, B]
  const float* nf0;          // [G, N, Se] noise-scaled atom embedding
  Weights proj;              // projector block (S = Se, V = 0)
  Weights layers;            // hidden blocks, every operand stacked [L, ...]
  const float* scales;       // [L, S + V] pre-layer noise scales
  const float* skipw;        // [L, S + V] skip blend weights
  const void* hb00;          // [S, S] T   head block, scalars
  const void* hb01;          // [S, V] T   head block, gate scalars
  const void* hb12;          // [V, V] T   head block, vectors
  const void* hf0;           // [S, C0o] T final linear, l = 0 outputs
  const void* hf1;           // [V, V1o] T final linear, l = 1 outputs
  float* out;                // [G, N, C0o + 3 * V1o] f32 (vector block [V1o][3])
  float cutoff;
  int N, B, S, V, Se, L, C0o, V1o;
  int td;                    // destination atoms per CTA (0 at the entry: chosen by shape_for)
};

// hidden block l of the stacked operands
template <typename T>
__device__ __forceinline__ Weights layer_weights(const Weights& w, int l, int S, int V) {
  const long long W = 2 * S + 3 * V;
  auto at = [&](const void* p, long long n) { return (const void*)((const T*)p + l * n); };
  return Weights{at(w.w1, NR * H),
                 w.b1d + l * H,
                 w.b1b + l * H,
                 at(w.w2, H * W),
                 w.b2 + l * W,
                 at(w.pl0, (long long)(S + V) * (S + V)),
                 at(w.pl1, (long long)(S + 2 * V) * V),
                 at(w.lin20, (long long)S * S),
                 at(w.lin21, (long long)V * V),
                 at(w.sk0, (long long)S * S),
                 at(w.sk1, (long long)V * V)};
}

// words of shared memory after conv_block's scratch
__host__ __device__ inline size_t stack_words(int N, int S, int V, int Se, int td) {
  const int F = S + 3 * V, Fmax = F > Se ? F : Se;
  return (size_t)3 * N + PT + (size_t)N * Fmax + (size_t)3 * td * F;
}

template <typename T>
__global__ void __launch_bounds__(MAX_THREADS) e3_stack_kernel(StackParams p) {
  extern __shared__ float smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int N = p.N, B = p.B, S = p.S, V = p.V, Se = p.Se, L = p.L;
  const int F = S + 3 * V, Fmax = F > Se ? F : Se, NC = S + V;
  const int nt = blockDim.x, tid = threadIdx.x;
  const int td_n = p.td;
  const int g = blockIdx.y, i0 = blockIdx.x * td_n;
  const int nd = min(td_n, N - i0);

  const float* pos = p.pos + (long long)g * N * 3;
  const uint8_t* nmask = p.node_mask + (long long)g * N;
  const int64_t* bsrc = p.bond_src + (long long)g * B;
  const int64_t* bdst = p.bond_dst + (long long)g * B;
  const uint8_t* bmask = p.bond_mask + (long long)g * B;

  const Scratch s = carve(smem, N, B, nt, S, V, td_n);
  float* pos_s = smem + scratch_words(N, B, nt, S, V, td_n);  // [N][3]
  float* ps_dist = pos_s + 3 * N;                        // [PT]
  float* xs_all = ps_dist + PT;                          // [N][Fmax] block input, all atoms
  float* x_own = xs_all + (size_t)N * Fmax;              // [td][F] f32 features of own atoms
  float* xs_own = x_own + td_n * F;                      // [2][td][F] next block's input rows

  for (int k = tid; k < 3 * N; k += nt) pos_s[k] = pos[k];
  __syncthreads();

  // vector src -> dst of a list entry and its source atom
  auto edge = [&](int e, int& src, float& dx, float& dy, float& dz) {
    const int i = i0 + entry_slot(e);
    src = entry_is_bond(e) ? (int)bsrc[entry_index(e)] : entry_index(e);
    dx = pos_s[3 * src + 0] - pos_s[3 * i + 0];
    dy = pos_s[3 * src + 1] - pos_s[3 * i + 1];
    dz = pos_s[3 * src + 2] - pos_s[3 * i + 2];
  };

  // warp 0 lists the pairs inside the cutoff and the real bonds, dst-major
  if (tid < 32) {
    const int lane = tid;
    const unsigned lt = (1u << lane) - 1u;
    int count = 0;
    for (int td = 0; td < nd; ++td) {
      const int i = i0 + td;
      const bool mi = nmask[i] != 0;
      int dcount = 0;
      for (int j0 = 0; j0 < N; j0 += 32) {
        int j = j0 + lane;
        bool a = false;
        if (j < N && j != i && mi && nmask[j]) {
          a = pair_dist(pos_s[3 * j + 0] - pos_s[3 * i + 0], pos_s[3 * j + 1] - pos_s[3 * i + 1],
                        pos_s[3 * j + 2] - pos_s[3 * i + 2]) < p.cutoff;
        }
        unsigned m = __ballot_sync(0xffffffffu, a);
        if (a) s.list[count + __popc(m & lt)] = encode(td, 0, j);
        count += __popc(m);
        dcount += __popc(m);
      }
      for (int b0 = 0; b0 < B; b0 += 32) {
        int b = b0 + lane;
        bool a = b < B && bdst[b] == i && bmask[b];
        unsigned m = __ballot_sync(0xffffffffu, a);
        if (a) s.list[count + __popc(m & lt)] = encode(td, 1, b);
        count += __popc(m);
        dcount += __popc(m);
      }
      if (lane == 0) s.deg[td] = (float)dcount;
    }
    if (lane == 0) *s.n_list = count;
  }
  __syncthreads();
  const int nl = *s.n_list;

  const int c = tid;  // this thread's radial output channel
  for (int blk = 0; blk <= L; ++blk) {
    const bool first = blk == 0;
    const int Sin = first ? Se : S, Vin = first ? 0 : V;
    const int Fin = Sin + 3 * Vin, W = 2 * Sin + 3 * Vin;
    const Weights w = first ? p.proj : layer_weights<T>(p.layers, blk - 1, S, V);
    const bool has_c = c < W;

    // the block's input rows of all atoms, rounded to T
    if (first) {
      const float* nf0 = p.nf0 + (long long)g * N * Se;
      for (int k = tid; k < N * Se; k += nt) xs_all[k] = rnd<T>(nf0[k]);
    } else {
      float* buf = xs_own + ((blk - 1) & 1) * td_n * F;
      for (int k = tid; k < N * F; k += nt) {
        const int j = k / F, ch = k % F;
        const float* remote = cluster.map_shared_rank(buf, j / td_n);
        xs_all[k] = remote[(j % td_n) * F + ch];
      }
    }
    const SharedRows x{xs_all, Fin};
    float w2r[H];
    float b2c;
    load_weights<T>(s, w, W, td_n, tid, nt, w2r, b2c);
    __syncthreads();

    ChannelSum st;
    for (int t0 = 0; t0 < nl; t0 += PT) {
      const int np = min(PT, nl - t0);
      // stage the tile: source, dst slot, spherical harmonics, distance
      if (tid < PT) {
        int src = 0, td = 0;
        float s0 = 0.0f, s1 = 0.0f, s2 = 0.0f, dist = 0.0f;
        if (tid < np) {
          const int e = s.list[t0 + tid];
          float dx, dy, dz;
          edge(e, src, dx, dy, dz);
          td = entry_slot(e);
          dist = pair_dist(dx, dy, dz);
          s0 = rnd<T>(sh_component(dy, dist));
          s1 = rnd<T>(sh_component(dz, dist));
          s2 = rnd<T>(sh_component(dx, dist));
        }
        s.ps_src[tid] = src;
        s.ps_td[tid] = td;
        s.ps_sh[tid * 3 + 0] = s0;
        s.ps_sh[tid * 3 + 1] = s1;
        s.ps_sh[tid * 3 + 2] = s2;
        ps_dist[tid] = dist;
      }
      __syncthreads();
      for (int o = tid; o < PT * NR; o += nt) {
        int q = o / NR, k = o % NR;
        s.rs[o] = q < np ? rnd<T>(radial_basis(k, ps_dist[q], p.cutoff, NR)) : 0.0f;
      }
      __syncthreads();
      radial_layer1<T>(s, w, s.list + t0, np, tid, nt);
      __syncthreads();
      if (has_c) messages<T>(s, x, w2r, b2c, np, c, Sin, Vin, nt, st);
      __syncthreads();
    }
    flush(s, st, c, has_c, nt);
    __syncthreads();
    normalise<T>(s, nd, tid, nt);
    __syncthreads();

    // irrep copy of an output column (scalars, then [V][3] vectors)
    auto copy_of = [&](int col) { return col < S ? col : S + (col - S) / 3; };
    if (first) {
      epilogue<T>(s, w, x, [&](int td, int col, float v) { x_own[td * F + col] = v; },
                  i0, nd, Sin, Vin, S, V, tid, nt);
    } else {
      const float* sw = p.skipw + (long long)(blk - 1) * NC;
      epilogue<T>(s, w, x,
                  [&](int td, int col, float v) {
                    const float wgt = sw[copy_of(col)];
                    x_own[td * F + col] = x_own[td * F + col] * wgt + v * (1.0f - wgt);
                  },
                  i0, nd, Sin, Vin, S, V, tid, nt);
    }
    __syncthreads();
    if (blk < L) {  // the next block's input: scaled, then rounded to T
      const float* sc = p.scales + (long long)blk * NC;
      float* buf = xs_own + (blk & 1) * td_n * F;
      for (int k = tid; k < nd * F; k += nt) buf[k] = rnd<T>(x_own[k] * sc[copy_of(k % F)]);
    }
    // every CTA has read this block's inputs and written the next block's
    cluster.sync();
  }

  // head: EquivariantMLP(hidden -> hidden -> irreps_out) on the own atoms
  const int C0o = p.C0o, V1o = p.V1o, OD = C0o + 3 * V1o;
  float* h_s = s.acc;            // [td][S] activated scalars
  float* h_g = h_s + td_n * S;   // [td][V] gates
  float* h_v = h_g + td_n * V;   // [td][3][V] gated vectors
  const T* hb00 = (const T*)p.hb00;
  const T* hb01 = (const T*)p.hb01;
  const T* hb12 = (const T*)p.hb12;
  const T* hf0 = (const T*)p.hf0;
  const T* hf1 = (const T*)p.hf1;
  for (int o = tid; o < nd * S; o += nt) {
    int td = o / S, q = o % S;
    float sum = 0.0f;
    for (int u = 0; u < S; ++u) sum += rnd<T>(x_own[td * F + u]) * ld(hb00 + (long long)u * S + q);
    h_s[o] = rnd<T>(sum >= 0.0f ? sum : 0.01f * sum);
  }
  for (int o = tid; o < nd * V; o += nt) {
    int td = o / V, q = o % V;
    float sum = 0.0f;
    for (int u = 0; u < S; ++u) sum += rnd<T>(x_own[td * F + u]) * ld(hb01 + (long long)u * V + q);
    h_g[o] = sigmoidf(sum);
  }
  __syncthreads();
  for (int o = tid; o < nd * 3 * V; o += nt) {
    int td = o / (3 * V), comp = (o / V) % 3, q = o % V;
    float sum = 0.0f;
    for (int v = 0; v < V; ++v)
      sum += rnd<T>(x_own[td * F + S + 3 * v + comp]) * ld(hb12 + (long long)v * V + q);
    h_v[o] = rnd<T>(sum * h_g[td * V + q]);
  }
  __syncthreads();
  float* out = p.out + ((long long)g * N + i0) * OD;
  for (int o = tid; o < nd * C0o; o += nt) {
    int td = o / C0o, q = o % C0o;
    float sum = 0.0f;
    for (int u = 0; u < S; ++u) sum += h_s[td * S + u] * ld(hf0 + (long long)u * C0o + q);
    out[(long long)td * OD + q] = sum;
  }
  for (int o = tid; o < nd * 3 * V1o; o += nt) {
    int td = o / (3 * V1o), comp = (o / V1o) % 3, q = o % V1o;
    float sum = 0.0f;
    for (int v = 0; v < V; ++v)
      sum += h_v[(td * 3 + comp) * V + v] * ld(hf1 + (long long)v * V1o + q);
    out[(long long)td * OD + C0o + 3 * q + comp] = sum;
  }
}

// the source rows of a staged tile from the block input of all atoms
// ([N][F] bf16 in shared memory): xq(q, src, ch)
struct SourceRows {
  const __nv_bfloat16* x;
  int F;
  __device__ __forceinline__ float operator()(int, int src, int ch) const {
    return __bfloat162float(x[src * F + ch]);
  }
};

// shared memory of the bf16 kernel: what lives through the whole CTA, then
// one region for the pair loop's tiles, each block's epilogue and the head;
// the epilogues stage their B operands there too where that fits (`stage`)
struct StackLayout {
  size_t acc, deg, ps4, ps_dist, list, pos, xs_all, x_own, xs_own, uni, total;
  bool stage;
};

__host__ __device__ inline size_t head_tiles_bytes(int S, int V, int td) {
  using namespace conv_block::mma;
  const int M1 = comp_rows(td);
  return 2 * align16((size_t)16 * ld_of(S) * 2) + 2 * align16((size_t)M1 * ld_of(V) * 2) +
         align16((size_t)td * V * 4);
}

__host__ __device__ inline StackLayout stack_layout(int N, int B, int S, int V, int Se, int td,
                                                    int nt) {
  using namespace conv_block::mma;
  const int Wh = 2 * S + 3 * V, Wp = 2 * Se, Wmax = Wh > Wp ? Wh : Wp;
  const int F = S + 3 * V, Fmax = F > Se ? F : Se;
  StackLayout l;
  l.acc = 0;
  l.deg = l.acc + align16((size_t)td * 3 * nt * 4);
  l.ps4 = l.deg + align16((size_t)td * 4);
  l.ps_dist = l.ps4 + align16((size_t)PT * 16);
  l.list = l.ps_dist + align16((size_t)PT * 4);
  l.pos = l.list + align16((size_t)(td * N + B + 1) * 4);
  l.xs_all = l.pos + align16((size_t)N * 3 * 4);
  l.x_own = l.xs_all + align16((size_t)N * Fmax * 2);
  l.xs_own = l.x_own + align16((size_t)td * F * 4);
  l.uni = l.xs_own + align16((size_t)2 * td * F * 2);
  size_t total[2];
  for (int stage = 0; stage < 2; ++stage) {
    size_t u = pair_tiles_bytes(Wmax);
    const size_t eh = epilogue_tiles_bytes(S, V, S + V, V, S, V, td, stage);
    const size_t ep = epilogue_tiles_bytes(Se, 0, S + V, V, S, V, td, stage);
    const size_t hd = head_tiles_bytes(S, V, td);
    u = u > eh ? u : eh;
    u = u > ep ? u : ep;
    u = u > hd ? u : hd;
    total[stage] = l.uni + u;
  }
  l.stage = stage_fits(total[1], total[0]);
  l.total = total[l.stage];
  return l;
}

// The bf16 kernel: the same function with the pair loop, each block's
// epilogue and the head on the tensor cores (conv_block_mma.cuh).
__global__ void __launch_bounds__(MAX_THREADS) e3_stack_mma_kernel(StackParams p) {
  using bf16 = __nv_bfloat16;
  extern __shared__ float4 smem_mma[];
  char* base = reinterpret_cast<char*>(smem_mma);
  cg::cluster_group cluster = cg::this_cluster();
  const int N = p.N, B = p.B, S = p.S, V = p.V, Se = p.Se, L = p.L;
  const int F = S + 3 * V, NC = S + V;
  const int nt = blockDim.x, tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int nwarps = nt >> 5;
  const int td_n = p.td;
  const int g = blockIdx.y, i0 = blockIdx.x * td_n;
  const int nd = min(td_n, N - i0);

  const float* pos = p.pos + (long long)g * N * 3;
  const uint8_t* nmask = p.node_mask + (long long)g * N;
  const int64_t* bsrc = p.bond_src + (long long)g * B;
  const int64_t* bdst = p.bond_dst + (long long)g * B;
  const uint8_t* bmask = p.bond_mask + (long long)g * B;

  const StackLayout l = stack_layout(N, B, S, V, Se, td_n, nt);
  Scratch s{};
  s.acc = (float*)(base + l.acc);
  s.deg = (float*)(base + l.deg);
  s.list = (int*)(base + l.list);
  s.n_list = s.list + td_n * N + B;
  float4* ps4 = (float4*)(base + l.ps4);
  float* ps_dist = (float*)(base + l.ps_dist);
  float* pos_s = (float*)(base + l.pos);
  bf16* xs_all = (bf16*)(base + l.xs_all);  // [N][Fmax] block input, all atoms
  float* x_own = (float*)(base + l.x_own);   // [td][F] f32 features of own atoms
  bf16* xs_own = (bf16*)(base + l.xs_own);   // [2][td][F] next block's input rows
  char* uni = base + l.uni;

  for (int k = tid; k < 3 * N; k += nt) pos_s[k] = pos[k];
  __syncthreads();

  auto edge = [&](int e, int& src, float& dx, float& dy, float& dz) {
    const int i = i0 + entry_slot(e);
    src = entry_is_bond(e) ? (int)bsrc[entry_index(e)] : entry_index(e);
    dx = pos_s[3 * src + 0] - pos_s[3 * i + 0];
    dy = pos_s[3 * src + 1] - pos_s[3 * i + 1];
    dz = pos_s[3 * src + 2] - pos_s[3 * i + 2];
  };

  // warp 0 lists the pairs inside the cutoff and the real bonds, dst-major
  if (tid < 32) {
    const unsigned lt = (1u << lane) - 1u;
    int count = 0;
    for (int td = 0; td < nd; ++td) {
      const int i = i0 + td;
      const bool mi = nmask[i] != 0;
      int dcount = 0;
      for (int j0 = 0; j0 < N; j0 += 32) {
        int j = j0 + lane;
        bool a = false;
        if (j < N && j != i && mi && nmask[j]) {
          a = pair_dist(pos_s[3 * j + 0] - pos_s[3 * i + 0], pos_s[3 * j + 1] - pos_s[3 * i + 1],
                        pos_s[3 * j + 2] - pos_s[3 * i + 2]) < p.cutoff;
        }
        unsigned m = __ballot_sync(0xffffffffu, a);
        if (a) s.list[count + __popc(m & lt)] = encode(td, 0, j);
        count += __popc(m);
        dcount += __popc(m);
      }
      for (int b0 = 0; b0 < B; b0 += 32) {
        int b = b0 + lane;
        bool a = b < B && bdst[b] == i && bmask[b];
        unsigned m = __ballot_sync(0xffffffffu, a);
        if (a) s.list[count + __popc(m & lt)] = encode(td, 1, b);
        count += __popc(m);
        dcount += __popc(m);
      }
      if (lane == 0) s.deg[td] = (float)dcount;
    }
    if (lane == 0) *s.n_list = count;
  }
  __syncthreads();
  const int nl = *s.n_list;

  constexpr int L1 = mma::ld_of(NR);
  for (int blk = 0; blk <= L; ++blk) {
    const bool first = blk == 0;
    const int Sin = first ? Se : S, Vin = first ? 0 : V;
    const int Fin = Sin + 3 * Vin, W = 2 * Sin + 3 * Vin;
    const Weights w = first ? p.proj : layer_weights<bf16>(p.layers, blk - 1, S, V);

    // the block's input rows of all atoms, rounded to bf16
    if (first) {
      const float* nf0 = p.nf0 + (long long)g * N * Se;
      for (int k = tid; k < N * Se; k += nt) xs_all[k] = __float2bfloat16_rn(nf0[k]);
    } else if ((F & 7) == 0) {  // 16 bytes per read from the owning CTA
      const uint4* buf = reinterpret_cast<const uint4*>(xs_own + ((blk - 1) & 1) * td_n * F);
      const int row = F / 8;
#pragma unroll 4
      for (int k = tid; k < N * row; k += nt) {
        const int j = k / row;
        const uint4* remote = cluster.map_shared_rank(buf, j / td_n);
        reinterpret_cast<uint4*>(xs_all)[k] = remote[(j % td_n) * row + k % row];
      }
    } else {
      bf16* buf = xs_own + ((blk - 1) & 1) * td_n * F;
      for (int k = tid; k < N * F; k += nt) {
        const int j = k / F, ch = k % F;
        const bf16* remote = cluster.map_shared_rank(buf, j / td_n);
        xs_all[k] = remote[(j % td_n) * F + ch];
      }
    }
    const mma::PairTiles t = mma::carve_pair_tiles(uni, W);
    mma::load_pair_weights(t, w, W, tid, nt);
    for (int k = tid; k < td_n * 3 * nt; k += nt) s.acc[k] = 0.0f;
    __syncthreads();

    const SourceRows xq{xs_all, Fin};
    ChannelSum st;
    for (int t0 = 0; t0 < nl; t0 += PT) {
      const int np = min(PT, nl - t0);
      // stage the tile: source, dst slot, spherical harmonics, distance
      if (tid < PT) {
        int src = 0, td = 0;
        float s0 = 0.0f, s1 = 0.0f, s2 = 0.0f, dist = 0.0f;
        if (tid < np) {
          const int e = s.list[t0 + tid];
          float dx, dy, dz;
          edge(e, src, dx, dy, dz);
          td = entry_slot(e);
          dist = pair_dist(dx, dy, dz);
          s0 = rnd<bf16>(sh_component(dy, dist));
          s1 = rnd<bf16>(sh_component(dz, dist));
          s2 = rnd<bf16>(sh_component(dx, dist));
        }
        ps4[tid] = mma::pair_info(s0, s1, s2, td, src);
        ps_dist[tid] = dist;
      }
      __syncthreads();
      for (int o = tid; o < PT * NR; o += nt) {
        const int q = o / NR, k = o % NR;
        t.rs[q * L1 + k] =
            __float2bfloat16_rn(q < np ? radial_basis(k, ps_dist[q], p.cutoff, NR) : 0.0f);
      }
      __syncthreads();
      mma::radial_layer1(t, w, s.list + t0, np, warp, nwarps, lane);
      __syncthreads();
      mma::layer2_messages(s, ps4, t, xq, w.b2, W, np, Sin, Vin, warp, lane, nt, st);
      __syncthreads();
    }
    flush(s, st, tid, tid < W, nt);
    __syncthreads();
    mma::normalise(s, nd, tid, nt);
    __syncthreads();

    auto copy_of = [&](int col) { return col < S ? col : S + (col - S) / 3; };
    const mma::EpilogueTiles e =
        mma::carve_epilogue_tiles(uni, Sin, Vin, S + V, V, S, V, td_n, l.stage);
    const GlobalRows<bf16> x{xs_all, Fin};
    if (first) {
      mma::epilogue(s, e, w, x, [&](int td, int col, float v) { x_own[td * F + col] = v; }, i0,
                    nd, Sin, Vin, S, V, tid, nt);
    } else {
      const float* sw = p.skipw + (long long)(blk - 1) * NC;
      mma::epilogue(s, e, w, x,
                    [&](int td, int col, float v) {
                      const float wgt = sw[copy_of(col)];
                      x_own[td * F + col] = x_own[td * F + col] * wgt + v * (1.0f - wgt);
                    },
                    i0, nd, Sin, Vin, S, V, tid, nt);
    }
    __syncthreads();
    if (blk < L) {  // the next block's input: scaled, then rounded to bf16
      const float* sc = p.scales + (long long)blk * NC;
      bf16* buf = xs_own + (blk & 1) * td_n * F;
      for (int k = tid; k < nd * F; k += nt)
        buf[k] = __float2bfloat16_rn(x_own[k] * sc[copy_of(k % F)]);
    }
    // every CTA has read this block's inputs and written the next block's
    cluster.sync();
  }

  // head: EquivariantMLP(hidden -> hidden -> irreps_out) on the own atoms
  const int C0o = p.C0o, V1o = p.V1o, OD = C0o + 3 * V1o, M1 = mma::comp_rows(nd);
  const int Ls = mma::ld_of(S), Lv = mma::ld_of(V);
  char* hb = uni;
  auto take = [&](size_t bytes) {
    char* q = hb;
    hb += mma::align16(bytes);
    return q;
  };
  bf16* a_xs = (bf16*)take((size_t)16 * Ls * 2);
  bf16* a_hs = (bf16*)take((size_t)16 * Ls * 2);
  bf16* a_xv = (bf16*)take((size_t)mma::comp_rows(td_n) * Lv * 2);
  bf16* a_hv = (bf16*)take((size_t)mma::comp_rows(td_n) * Lv * 2);
  float* gates = (float*)take((size_t)td_n * V * 4);
  mma::clear_tile(a_xs, 16, S, tid, nt);
  mma::clear_tile(a_hs, 16, S, tid, nt);
  mma::clear_tile(a_xv, M1, V, tid, nt);
  mma::clear_tile(a_hv, M1, V, tid, nt);
  __syncthreads();
  for (int o = tid; o < nd * S; o += nt) {
    const int td = o / S, u = o % S;
    a_xs[td * Ls + u] = __float2bfloat16_rn(x_own[td * F + u]);
  }
  for (int o = tid; o < nd * 3 * V; o += nt) {
    const int r = o / V, v = o % V;
    a_xv[r * Lv + v] = __float2bfloat16_rn(x_own[(r / 3) * F + S + 3 * v + r % 3]);
  }
  __syncthreads();
  {
    const mma::Segment s00[1] = {{a_xs, (const bf16*)p.hb00, S}};
    mma::row_product<1>(s00, S, nd, warp, nwarps, lane, [&](int m, int n, float v) {
      a_hs[m * Ls + n] = __float2bfloat16_rn(v >= 0.0f ? v : 0.01f * v);
    });
    const mma::Segment s01[1] = {{a_xs, (const bf16*)p.hb01, S}};
    mma::row_product<1>(s01, V, nd, warp, nwarps, lane,
                        [&](int m, int n, float v) { gates[m * V + n] = sigmoidf(v); });
  }
  __syncthreads();
  {
    const mma::Segment s12[1] = {{a_xv, (const bf16*)p.hb12, V}};
    mma::rows_product(s12, V, 3 * nd, warp, nwarps, lane, [&](int r, int n, float v) {
      a_hv[r * Lv + n] = __float2bfloat16_rn(v * gates[(r / 3) * V + n]);
    });
  }
  __syncthreads();
  float* out = p.out + ((long long)g * N + i0) * OD;
  const mma::Segment sf0[1] = {{a_hs, (const bf16*)p.hf0, S}};
  mma::row_product<1>(sf0, C0o, nd, warp, nwarps, lane,
                      [&](int m, int n, float v) { out[(long long)m * OD + n] = v; });
  const mma::Segment sf1[1] = {{a_hv, (const bf16*)p.hf1, V}};
  mma::rows_product(sf1, V1o, 3 * nd, warp, nwarps, lane, [&](int r, int n, float v) {
    out[(long long)(r / 3) * OD + C0o + 3 * n + r % 3] = v;
  });
}

// the kernel of a compute type and the shared memory of td atoms per CTA
template <typename T>
struct StackKernel {
  static constexpr auto fn = e3_stack_kernel<T>;
  static size_t smem(const StackParams& p, int nt, int td) {
    return (scratch_words(p.N, p.B, nt, p.S, p.V, td) + stack_words(p.N, p.S, p.V, p.Se, td)) * 4;
  }
};
template <>
struct StackKernel<__nv_bfloat16> {
  static constexpr auto fn = e3_stack_mma_kernel;
  static size_t smem(const StackParams& p, int nt, int td) {
    return stack_layout(p.N, p.B, p.S, p.V, p.Se, td, nt).total;
  }
};

constexpr int MAX_CLUSTER = 8;   // the portable cluster size
constexpr int MAX_TD = 16;       // destination atoms per CTA

// The launch shape. With p.td == 0: the smallest power-of-two cluster whose
// CTAs own at most MAX_TD atoms each and fit their shared memory (N <= 16:
// 1 CTA, <= 32: 2, <= 64: 4), atoms spread evenly and a CTA that would own
// none left out. At one CTA per SM, clusters of 1, 2 and 4 fill the card's
// GPCs of 16 or 18 SMs; clusters of 3, 6 or 8 leave SMs unused. p.td > 0
// asks for that many atoms per CTA.
struct Shape {
  int nt, ncta, td;
  size_t smem;
};

template <typename T>
Shape shape_for(const StackParams& p) {
  const int Wh = 2 * p.S + 3 * p.V, Wp = 2 * p.Se;
  Shape sh;
  sh.nt = threads_for(Wh > Wp ? Wh : Wp);
  auto with_td = [&](int td) {
    sh.td = td;
    sh.ncta = (p.N + td - 1) / td;
    sh.smem = StackKernel<T>::smem(p, sh.nt, td);
  };
  if (p.td > 0 || p.N == 0) {
    with_td(p.td > 0 ? p.td : 1);
    return sh;
  }
  for (int ncta = 1;; ncta *= 2) {
    with_td((p.N + ncta - 1) / ncta);
    if ((sh.td <= MAX_TD && sh.smem <= mma::MAX_SMEM_BYTES) || ncta >= MAX_CLUSTER) return sh;
  }
}

// the launch of one cluster per graph; its size is a run-time value
struct ClusterLaunch {
  cudaLaunchConfig_t config;
  cudaLaunchAttribute attr[1];
};

template <typename T>
cudaError_t configure(const Shape& sh, int G, void* stream, ClusterLaunch& cl) {
  cl.config = cudaLaunchConfig_t{};
  cl.config.gridDim = dim3(sh.ncta, G, 1);
  cl.config.blockDim = dim3(sh.nt, 1, 1);
  cl.config.dynamicSmemBytes = sh.smem;
  cl.config.stream = (cudaStream_t)stream;
  cl.attr[0].id = cudaLaunchAttributeClusterDimension;
  cl.attr[0].val.clusterDim.x = sh.ncta;
  cl.attr[0].val.clusterDim.y = 1;
  cl.attr[0].val.clusterDim.z = 1;
  cl.config.attrs = cl.attr;
  cl.config.numAttrs = 1;
  return cudaFuncSetAttribute(StackKernel<T>::fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)sh.smem);
}

template <typename T>
int launch(StackParams p, int G, void* stream) {
  const Shape sh = shape_for<T>(p);
  p.td = sh.td;
  if (sh.nt > MAX_THREADS || sh.ncta > MAX_CLUSTER || p.B >= MAX_INDEX || G > 65535 || p.V < 1)
    return (int)cudaErrorInvalidValue;
  if (G == 0 || p.N == 0) return 0;
  ClusterLaunch cl;
  cudaError_t err = configure<T>(sh, G, stream, cl);
  if (err != cudaSuccess) return (int)err;
  err = cudaLaunchKernelEx(&cl.config, StackKernel<T>::fn, p);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

}  // namespace

// pointer arguments in the order of StackParams; w[0..10] the projector's
// operands, w[11..21] the stacked hidden operands (the order of Weights)
#define E3_STACK_ENTRY(NAME, TYPE)                                                             \
  extern "C" int NAME(const void* pos, const void* node_mask, const void* bond_src,            \
                      const void* bond_dst, const void* bond_mask, float cutoff,               \
                      const void* nf0, const void* const* w, const void* scales,               \
                      const void* skipw, const void* hb00, const void* hb01, const void* hb12, \
                      const void* hf0, const void* hf1, void* out, int G, int N, int B, int S, \
                      int V, int Se, int L, int C0o, int V1o, int td, void* stream) {          \
    auto block = [&](int o) {                                                                  \
      return Weights{w[o],     (const float*)w[o + 1], (const float*)w[o + 2], w[o + 3],       \
                     (const float*)w[o + 4], w[o + 5], w[o + 6], w[o + 7], w[o + 8], w[o + 9], \
                     w[o + 10]};                                                               \
    };                                                                                         \
    StackParams p{(const float*)pos, (const uint8_t*)node_mask, (const int64_t*)bond_src,      \
                  (const int64_t*)bond_dst, (const uint8_t*)bond_mask, (const float*)nf0,      \
                  block(0), block(11), (const float*)scales, (const float*)skipw, hb00, hb01,  \
                  hb12, hf0, hf1, (float*)out, cutoff, N, B, S, V, Se, L, C0o, V1o, td};       \
    return launch<TYPE>(p, G, stream);                                                         \
  }

E3_STACK_ENTRY(e3_stack_f32, float)
E3_STACK_ENTRY(e3_stack_bf16, __nv_bfloat16)

// The launch shape for these sizes and how the card takes it: shape =
// {CTAs per cluster, atoms per CTA, threads, bytes of shared memory,
// clusters resident at once, registers per thread, local (spill) bytes per
// thread, CTAs resident per SM}.
template <typename T>
int stack_shape(const StackParams& p, int* shape) {
  const Shape sh = shape_for<T>(p);
  if (sh.ncta > MAX_CLUSTER) return (int)cudaErrorInvalidValue;
  ClusterLaunch cl;
  cudaError_t err = configure<T>(sh, 1, nullptr, cl);
  if (err != cudaSuccess) return (int)err;
  int clusters = 0, ctas = 0;
  err = cudaOccupancyMaxActiveClusters(&clusters, StackKernel<T>::fn, &cl.config);
  if (err != cudaSuccess) return (int)err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&ctas, StackKernel<T>::fn, sh.nt, sh.smem);
  if (err != cudaSuccess) return (int)err;
  cudaFuncAttributes attr;
  err = cudaFuncGetAttributes(&attr, StackKernel<T>::fn);
  if (err != cudaSuccess) return (int)err;
  shape[0] = sh.ncta;
  shape[1] = sh.td;
  shape[2] = sh.nt;
  shape[3] = (int)sh.smem;
  shape[4] = clusters;
  shape[5] = attr.numRegs;
  shape[6] = (int)attr.localSizeBytes;
  shape[7] = ctas;
  return 0;
}

extern "C" int e3_stack_shape(int bf16, int N, int B, int S, int V, int Se, int td, int* shape) {
  StackParams p{};
  p.N = N;
  p.B = B;
  p.S = S;
  p.V = V;
  p.Se = Se;
  p.td = td;
  return bf16 ? stack_shape<__nv_bfloat16>(p, shape) : stack_shape<float>(p, shape);
}
