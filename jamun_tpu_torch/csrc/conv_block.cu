// One whole separable ConvBlock of the dense E3Conv (l <= 1, uvu):
// radial MLP per pair, depthwise messages over dense pairs and bonds, mean
// over the combined degree, post-linear, gate, second linear and the linear
// skip of the block input.
//
// Replaces the TPU kernel `_layer_kernel` / `_conv_block_body` with
// fuse_block=True of jamun_tpu/ops/pallas/packed_conv.py (pallas_call at
// line 1495, entry `packed_separable_conv_layer`, reached through
// `make_trainable_conv_block`). The TPU kernel evaluates every one of the
// N*N pairs as lane-packed [C, N*N] panels and aggregates with one-hot
// matmuls; here one CTA owns TD destination atoms of one graph, lists the
// pairs that are inside the cutoff (and the bonds into its atoms) and
// visits only those, so the work follows the adjacency.
//
// Bound on the H100: operations. Per visited pair the radial MLP costs
// 2 * (NR * 64 + 64 * W) flops (W = 2S + 3V), about 50 kflop at the
// flagship width, against ~100 bytes of features read from L2, and the
// per-node epilogue about 2 * 76 k flops. This first version runs the
// pair products as FP32 FMAs: thread c owns radial output channel c and
// keeps its 64 layer-2 weights in registers, the layer-1 activations of a
// tile of PT pairs sit in shared memory (read as broadcasts), and the
// messages of channel c accumulate in three registers, so nothing but the
// final [G, N, Sc + 3Vg] output goes back to device memory. Tensor cores
// (mma / wgmma over the pair tile) are the next step.
//
// The block's steps after the staging of a pair tile live in
// conv_block_body.cuh (shared with the whole-model kernel, e3_stack.cu),
// with their rounding points.
//
// Under autograd the wrapper also asks for the residuals of the backward
// kernel (csrc/conv_block_bwd.cu): the normalised aggregates as
// [G, N, 3, W] f32 (component, radial channel) and the degree [G, N], the
// counterpart of the TPU kernel's save_residuals mode.
//
// Layer mode (template flag LAYER, entries conv_layer_*): the same kernel
// with fuse_block=False (packed_conv.py:1364-1404), which JAX's `Conv`
// reaches for a dense call whose fused layer applies (jamun_tpu/ops/conv.py
// :271-315): dense pairs and bonds, the mean, then only the post-linear, for
// any l <= 1, even irreps_out with at least one 0e block. Sc and Vg then
// hold C0 and V1, the 0e and 1e output channels (pl0 [S + V, C0], pl1
// [S + 2V, V1]), and the row [C0 + 3 V1] leaves in irreps order through a
// column map: 0e channel q goes to column out_col[q], 1e channel q to
// out_col[C0 + q] + component. No gate, second linear or skip.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "conv_block_body.cuh"

namespace {

using namespace conv_block;

struct Params {
  const void* x;      // [G, N, F] T, F = S + 3V (vector block [V][3] in y, z, x)
  const void* ef;     // [G, N, N, EC] T
  const void* bf;     // [G, B, EC] T
  const int64_t* bond_src;  // [G, B]
  const int64_t* bond_dst;  // [G, B]
  Weights w;
  float* out;         // [G, N, Sc + 3Vg] f32 (vector block [Vg][3])
  float* agg_out;     // [G, N, 3, W] f32 or null: normalised aggregates
  float* deg_out;     // [G, N] f32 or null: degree
  const int* out_col; // layer mode: [C0 + V1] output column of each channel
  int N, B, S, V, Sc, Vg;  // layer mode: Sc = C0, Vg = V1
};

template <typename T, bool LAYER>
__global__ void __launch_bounds__(MAX_THREADS) conv_block_kernel(Params p) {
  extern __shared__ float smem[];
  const int N = p.N, B = p.B, S = p.S, V = p.V, Sc = p.Sc, Vg = p.Vg;
  const int F = S + 3 * V, W = 2 * S + 3 * V, OF = Sc + 3 * Vg;
  const int nt = blockDim.x, tid = threadIdx.x;
  const int g = blockIdx.y, i0 = blockIdx.x * TD;
  const int nd = min(TD, N - i0);

  const GlobalRows<T> x{(const T*)p.x + (long long)g * N * F, F};
  const T* ef = (const T*)p.ef + (long long)g * N * N * EC;
  const T* bf = (const T*)p.bf + (long long)g * B * EC;
  const int64_t* bsrc = p.bond_src + (long long)g * B;
  const int64_t* bdst = p.bond_dst + (long long)g * B;

  const Scratch s = carve(smem, N, B, nt, Sc, Vg, TD);
  const int c = tid;  // this thread's radial output channel
  const bool has_c = c < W;
  float w2r[H];
  float b2c;
  load_weights<T>(s, p.w, W, TD, tid, nt, w2r, b2c);

  // warp 0 lists the pairs inside the cutoff and the bonds, dst-major
  if (tid < 32) {
    const int lane = tid;
    const unsigned lt = (1u << lane) - 1u;
    int count = 0;
    for (int td = 0; td < nd; ++td) {
      const int i = i0 + td;
      int dcount = 0;
      for (int j0 = 0; j0 < N; j0 += 32) {
        int j = j0 + lane;
        bool a = j < N && ld(ef + ((long long)i * N + j) * EC + 3) > 0.5f;
        unsigned m = __ballot_sync(0xffffffffu, a);
        if (a) s.list[count + __popc(m & lt)] = encode(td, 0, j);
        count += __popc(m);
        dcount += __popc(m);
      }
      for (int b0 = 0; b0 < B; b0 += 32) {
        int b = b0 + lane;
        bool a = b < B && bdst[b] == i && ld(bf + (long long)b * EC + 3) > 0.5f;
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

  // the edge-feature row of a list entry
  auto row = [&](int e) {
    return entry_is_bond(e) ? bf + (long long)entry_index(e) * EC
                            : ef + ((long long)(i0 + entry_slot(e)) * N + entry_index(e)) * EC;
  };

  ChannelSum st;
  for (int t0 = 0; t0 < nl; t0 += PT) {
    const int np = min(PT, nl - t0);
    // stage the tile's pair geometry and radial features
    if (tid < PT) {
      int src = 0, td = 0;
      float s0 = 0.0f, s1 = 0.0f, s2 = 0.0f;
      if (tid < np) {
        int e = s.list[t0 + tid];
        td = entry_slot(e);
        src = entry_is_bond(e) ? (int)bsrc[entry_index(e)] : entry_index(e);
        const T* fp = row(e);
        s0 = ld(fp + 0);
        s1 = ld(fp + 1);
        s2 = ld(fp + 2);
      }
      s.ps_src[tid] = src;
      s.ps_td[tid] = td;
      s.ps_sh[tid * 3 + 0] = s0;
      s.ps_sh[tid * 3 + 1] = s1;
      s.ps_sh[tid * 3 + 2] = s2;
    }
    for (int o = tid; o < PT * NR; o += nt) {
      int q = o / NR, k = o % NR;
      s.rs[q * NR + k] = q < np ? ld(row(s.list[t0 + q]) + 4 + k) : 0.0f;
    }
    __syncthreads();
    radial_layer1<T>(s, p.w, s.list + t0, np, tid, nt);
    __syncthreads();
    if (has_c) messages<T>(s, x, w2r, b2c, np, c, S, V, nt, st);
    __syncthreads();
  }
  flush(s, st, c, has_c, nt);
  __syncthreads();

  normalise<T>(s, nd, tid, nt);
  __syncthreads();
  if (p.agg_out != nullptr) {
    for (int k = tid; k < nd * 3 * W; k += nt) {
      int td = k / (3 * W), comp = (k / W) % 3, ch = k % W;
      p.agg_out[(((long long)g * N + i0 + td) * 3 + comp) * W + ch] = s.acc[(td * 3 + comp) * nt + ch];
    }
    if (tid < nd) p.deg_out[(long long)g * N + i0 + tid] = s.deg[tid];
  }
  float* out = p.out + ((long long)g * N + i0) * OF;
  if constexpr (LAYER) {
    post_linear<T>(s, p.w, nd, S, V, Sc, Vg, tid, nt);
    __syncthreads();
    for (int o = tid; o < nd * Sc; o += nt) {
      const int td = o / Sc, q = o % Sc;
      out[(long long)td * OF + p.out_col[q]] = s.conv0[td * Sc + q];
    }
    for (int o = tid; o < nd * 3 * Vg; o += nt) {
      const int td = o / (3 * Vg), comp = (o / Vg) % 3, q = o % Vg;
      out[(long long)td * OF + p.out_col[Sc + q] + comp] = s.conv1[(td * 3 + comp) * Vg + q];
    }
  } else {
    epilogue<T>(s, p.w, x, [&](int td, int col, float v) { out[(long long)td * OF + col] = v; },
                i0, nd, S, V, Sc, Vg, tid, nt);
  }
}

template <typename T, bool LAYER>
int launch(const Params& p, int G, void* stream) {
  const int W = 2 * p.S + 3 * p.V;
  const int nt = threads_for(W);
  if (nt > MAX_THREADS || p.N >= MAX_INDEX || p.B >= MAX_INDEX) return (int)cudaErrorInvalidValue;
  if (G == 0 || p.N == 0) return 0;
  size_t smem = scratch_words(p.N, p.B, nt, p.Sc, p.Vg, TD) * 4;
  cudaError_t err = cudaFuncSetAttribute(conv_block_kernel<T, LAYER>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((p.N + TD - 1) / TD, G);
  conv_block_kernel<T, LAYER><<<grid, nt, smem, (cudaStream_t)stream>>>(p);
  return (int)cudaGetLastError();
}

Params make_params(const void* x, const void* ef, const void* bf, const void* bond_src,
                   const void* bond_dst, const void* w1, const void* b1d, const void* b1b,
                   const void* w2, const void* b2, const void* pl0, const void* pl1,
                   const void* lin20, const void* lin21, const void* sk0, const void* sk1,
                   void* out, void* agg_out, void* deg_out, int N, int B, int S, int V, int Sc,
                   int Vg) {
  Params p;
  p.x = x;
  p.ef = ef;
  p.bf = bf;
  p.bond_src = (const int64_t*)bond_src;
  p.bond_dst = (const int64_t*)bond_dst;
  p.w = Weights{w1, (const float*)b1d, (const float*)b1b, w2, (const float*)b2, pl0, pl1,
                lin20, lin21, sk0, sk1};
  p.out = (float*)out;
  p.agg_out = (float*)agg_out;
  p.deg_out = (float*)deg_out;
  p.out_col = nullptr;
  p.N = N;
  p.B = B;
  p.S = S;
  p.V = V;
  p.Sc = Sc;
  p.Vg = Vg;
  return p;
}

}  // namespace

#define CONV_BLOCK_ENTRY(NAME, TYPE)                                                          \
  extern "C" int NAME(const void* x, const void* ef, const void* bf, const void* bond_src,   \
                      const void* bond_dst, const void* w1, const void* b1d,                 \
                      const void* b1b, const void* w2, const void* b2, const void* pl0,      \
                      const void* pl1, const void* lin20, const void* lin21,                 \
                      const void* sk0, const void* sk1, void* out, void* agg_out,            \
                      void* deg_out, int G, int N, int B, int S, int V, int Sc, int Vg,      \
                      void* stream) {                                                        \
    Params p = make_params(x, ef, bf, bond_src, bond_dst, w1, b1d, b1b, w2, b2, pl0, pl1,    \
                           lin20, lin21, sk0, sk1, out, agg_out, deg_out, N, B, S, V, Sc,    \
                           Vg);                                                              \
    return launch<TYPE, false>(p, G, stream);                                                \
  }

CONV_BLOCK_ENTRY(conv_block_f32, float)
CONV_BLOCK_ENTRY(conv_block_bf16, __nv_bfloat16)

// layer mode: out [G, N, C0 + 3 V1] in irreps order (out_col [C0 + V1] int32)
#define CONV_LAYER_ENTRY(NAME, TYPE)                                                          \
  extern "C" int NAME(const void* x, const void* ef, const void* bf, const void* bond_src,   \
                      const void* bond_dst, const void* w1, const void* b1d,                 \
                      const void* b1b, const void* w2, const void* b2, const void* pl0,      \
                      const void* pl1, const void* out_col, void* out, int G, int N, int B,  \
                      int S, int V, int C0, int V1, void* stream) {                          \
    Params p = make_params(x, ef, bf, bond_src, bond_dst, w1, b1d, b1b, w2, b2, pl0, pl1,    \
                           nullptr, nullptr, nullptr, nullptr, out, nullptr, nullptr, N, B,  \
                           S, V, C0, V1);                                                    \
    p.out_col = (const int*)out_col;                                                         \
    return launch<TYPE, true>(p, G, stream);                                                 \
  }

CONV_LAYER_ENTRY(conv_layer_f32, float)
CONV_LAYER_ENTRY(conv_layer_bf16, __nv_bfloat16)
