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
// The ConvBlock steps are the device code of conv_block_body.cuh.
//
// Bound on the H100: operations (the radial MLP of every visited pair in
// every block, FP32 FMAs in this version). What holds it back beyond the
// per-layer kernel's limits: a cluster waits for its slowest CTA at every
// block, and a cluster needs all its CTAs resident at once on one GPC (at
// one CTA per SM, clusters of 4 fill a GPC of 16 or 18 SMs and clusters of
// 6 do not, which is why N = 44 runs as 4 x 11 atoms and not 6 x 8: see
// shape_for).
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

constexpr int MAX_CLUSTER = 8;   // the portable cluster size
constexpr int MAX_TD = 16;       // destination atoms per CTA
constexpr size_t MAX_SMEM = 232448;  // bytes of shared memory a block may use

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

Shape shape_for(const StackParams& p) {
  const int Wh = 2 * p.S + 3 * p.V, Wp = 2 * p.Se;
  Shape sh;
  sh.nt = threads_for(Wh > Wp ? Wh : Wp);
  auto with_td = [&](int td) {
    sh.td = td;
    sh.ncta = (p.N + td - 1) / td;
    sh.smem = (scratch_words(p.N, p.B, sh.nt, p.S, p.V, td) +
               stack_words(p.N, p.S, p.V, p.Se, td)) * 4;
  };
  if (p.td > 0 || p.N == 0) {
    with_td(p.td > 0 ? p.td : 1);
    return sh;
  }
  for (int ncta = 1;; ncta *= 2) {
    with_td((p.N + ncta - 1) / ncta);
    if ((sh.td <= MAX_TD && sh.smem <= MAX_SMEM) || ncta >= MAX_CLUSTER) return sh;
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
  return cudaFuncSetAttribute(e3_stack_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)sh.smem);
}

template <typename T>
int launch(StackParams p, int G, void* stream) {
  const Shape sh = shape_for(p);
  p.td = sh.td;
  if (sh.nt > MAX_THREADS || sh.ncta > MAX_CLUSTER || p.B >= MAX_INDEX || G > 65535 || p.V < 1)
    return (int)cudaErrorInvalidValue;
  if (G == 0 || p.N == 0) return 0;
  ClusterLaunch cl;
  cudaError_t err = configure<T>(sh, G, stream, cl);
  if (err != cudaSuccess) return (int)err;
  err = cudaLaunchKernelEx(&cl.config, e3_stack_kernel<T>, p);
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

// The launch shape for these sizes (bf16) and how many of its clusters the
// card can hold at once: shape = {CTAs per cluster, atoms per CTA, threads,
// bytes of shared memory, clusters resident at once}.
extern "C" int e3_stack_shape(int N, int B, int S, int V, int Se, int td, int* shape) {
  StackParams p{};
  p.N = N;
  p.B = B;
  p.S = S;
  p.V = V;
  p.Se = Se;
  p.td = td;
  const Shape sh = shape_for(p);
  if (sh.ncta > MAX_CLUSTER) return (int)cudaErrorInvalidValue;
  ClusterLaunch cl;
  cudaError_t err = configure<__nv_bfloat16>(sh, 1, nullptr, cl);
  if (err != cudaSuccess) return (int)err;
  int clusters = 0;
  err = cudaOccupancyMaxActiveClusters(&clusters, e3_stack_kernel<__nv_bfloat16>, &cl.config);
  if (err != cudaSuccess) return (int)err;
  shape[0] = sh.ncta;
  shape[1] = sh.td;
  shape[2] = sh.nt;
  shape[3] = (int)sh.smem;
  shape[4] = clusters;
  return 0;
}
