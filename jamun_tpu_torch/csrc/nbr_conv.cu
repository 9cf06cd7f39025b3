// Sparse capped-neighbour messages of one separable conv layer (l <= 1,
// uvu): for every kept neighbour slot the radial MLP on the slot's edge
// attributes and the uvu messages of the gathered source features, summed
// over the slots of each destination atom, and the degree.
//
// Replaces the TPU kernel `_kernel` of jamun_tpu/ops/pallas/nbr_conv.py
// (pallas_call at line 371, entry `nbr_uvu_conv`), which the JAX model runs
// for every ConvBlock of a forward without a gradient on the sparse path.
// The TPU kernel evaluates all K slots of a tile of 128 destination atoms,
// gathers the sources with one-hot matmuls over blocks of 128 source atoms
// (a bitmap skips the blocks no slot touches), tiles the vector weights
// three times across the lanes and rolls lanes for the cross product. None
// of that carries over. Here one CTA owns TDN destination atoms of one
// graph, K2's CTA shape: it lists their masked-in slots dst-major (on the
// repo's chain geometry about a quarter of the K slots pass the mask, so the
// work follows the kept edges, not K), stages each tile of PT slots (source
// atom, spherical harmonics, A edge attributes) in shared memory and runs
// the ConvBlock steps of conv_block_body.cuh: radial_layer1 with a first
// layer A wide, then messages, which reads the source rows from device
// memory through L2 (GlobalRows). The normalisation and the epilogue are
// not run: the messages leave unnormalised in f32, in JAX's packed order
// [Sx0e | Sx1e | Vx1e | Vx0e | Vx1e] with l = 1 in (y, z, x), beside the
// count of masked-in slots as the degree. The caller adds the bonds,
// divides by the combined degree and applies the post-linear.
//
// A = 64 takes the model's whole edge attributes (bondedness embedding and
// radial basis); A = 32 the radial half from the edge-features kernel
// (nbr_edge_features.cu), the constant bondedness-0 block folded into b1 by
// the caller in f32.
//
// Bound on the H100: operations. Per kept slot the radial MLP costs
// 2 * (A * 64 + 64 * W) flops (W = 2S + 3V), about 51 kflop at the
// flagship width with A = 64, against A + 4 attributes read once and one
// source row from L2; the output is 4S + 7V f32 per atom. This version runs
// the products as FP32 FMAs (thread c owns radial channel c and keeps its
// 64 layer-2 weights in registers), as K2, K3 and K5 do; tensor cores over
// the slot tile are the next step for all four.
//
// Rounding points are the body's: h and the radial weights in T, f32
// message products and sums (the TPU kernel rounds each product to T before
// its f32 sum).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "conv_block_body.cuh"

namespace {

using namespace conv_block;

constexpr int TDN = 16;         // destination atoms per CTA
constexpr int MAX_SLOTS = 256;  // K of one list (a CTA lists TDN * K entries)
constexpr size_t MAX_SMEM = 232448;  // bytes of shared memory a block may use

struct Params {
  const void* x;       // [G, N, F] T, F = S + 3V (vector block [V][3] in y, z, x)
  const void* sh;      // [G, N, K, 4] T, channels 1-3 the l = 1 harmonics (y, z, x)
  const void* attr;    // [G, N, K, A] T
  const int64_t* idx;  // [G, N, K] source atom of each slot
  const float* mask;   // [G, N, K] 1 for a kept edge
  Weights w;           // w1 [A, H] T, b1d = b1b = b1 [H] f32, w2 [H, W] T, b2 [W] f32
  float* out;          // [G, N, 4S + 7V] f32
  float* deg_out;      // [G, N] f32
  int N, K, S, V;
};

// words of shared memory: w1s [A][H], hs [H][PT], rs [PT][A], ps_sh [PT][3],
// deg [TDN], acc [TDN][3][nt]; ps_src, ps_td [PT], list [TDN * K], n_list
__host__ __device__ inline size_t nbr_words(int A, int K, int nt) {
  size_t floats = (size_t)A * H + H * PT + (size_t)PT * A + PT * 3 + TDN + (size_t)TDN * 3 * nt;
  size_t ints = 2 * PT + (size_t)TDN * K + 1;
  return floats + ints;
}

__device__ __forceinline__ Scratch carve_nbr(float* smem, int A, int K, int nt) {
  Scratch s{};
  s.w1s = smem;
  s.hs = s.w1s + A * H;
  s.rs = s.hs + H * PT;
  s.ps_sh = s.rs + PT * A;
  s.deg = s.ps_sh + PT * 3;
  s.acc = s.deg + TDN;
  s.ps_src = (int*)(s.acc + TDN * 3 * nt);
  s.ps_td = s.ps_src + PT;
  s.list = s.ps_td + PT;
  s.n_list = s.list + TDN * K;
  return s;
}

template <typename T, int A>
__global__ void __launch_bounds__(MAX_THREADS) nbr_conv_kernel(Params p) {
  extern __shared__ float smem[];
  const int N = p.N, K = p.K, S = p.S, V = p.V;
  const int F = S + 3 * V, W = 2 * S + 3 * V, OW = 4 * S + 7 * V;
  const int nt = blockDim.x, tid = threadIdx.x;
  const int g = blockIdx.y, i0 = blockIdx.x * TDN;
  const int nd = min(TDN, N - i0);

  const GlobalRows<T> x{(const T*)p.x + (long long)g * N * F, F};
  const long long slot0 = ((long long)g * N + i0) * K;  // the first slot of the CTA's atoms
  const float* mask = p.mask + slot0;
  const int64_t* idx = p.idx + slot0;
  const T* sh = (const T*)p.sh + slot0 * 4;
  const T* attr = (const T*)p.attr + slot0 * A;

  const Scratch s = carve_nbr(smem, A, K, nt);
  const int c = tid;  // this thread's radial output channel
  const bool has_c = c < W;
  float w2r[H];
  float b2c;
  load_weights<T, A>(s, p.w, W, TDN, tid, nt, w2r, b2c);

  // The masked-in slots of dst slot td in slot order; one warp, all lanes.
  // Returns their number; with `write` the entries go to list[base ...].
  const int warp = tid >> 5, lane = tid & 31, nwarps = nt >> 5;
  const unsigned lt = (1u << lane) - 1u;
  auto scan = [&](int td, int base, bool write) {
    int count = 0;
    for (int k0 = 0; k0 < K; k0 += 32) {
      const int k = k0 + lane;
      const bool a = k < K && mask[(long long)td * K + k] > 0.0f;
      const unsigned m = __ballot_sync(0xffffffffu, a);
      if (write && a) s.list[base + count + __popc(m & lt)] = encode(td, 0, k);
      count += __popc(m);
    }
    return count;
  };
  for (int td = warp; td < nd; td += nwarps) {
    const int count = scan(td, 0, false);
    if (lane == 0) s.deg[td] = (float)count;
  }
  __syncthreads();
  for (int td = warp; td < nd; td += nwarps) {
    int base = 0;
    for (int t = 0; t < td; ++t) base += (int)s.deg[t];
    scan(td, base, true);
  }
  if (tid == 0) {
    int total = 0;
    for (int t = 0; t < nd; ++t) total += (int)s.deg[t];
    *s.n_list = total;
  }
  __syncthreads();
  const int nl = *s.n_list;

  ChannelSum st;
  for (int t0 = 0; t0 < nl; t0 += PT) {
    const int np = min(PT, nl - t0);
    // stage the tile: source, dst slot, spherical harmonics, edge attributes
    if (tid < PT) {
      int src = 0, td = 0;
      float s0 = 0.0f, s1 = 0.0f, s2 = 0.0f;
      if (tid < np) {
        const int e = s.list[t0 + tid];
        td = entry_slot(e);
        const long long slot = (long long)td * K + entry_index(e);
        src = (int)idx[slot];
        s0 = ld(sh + slot * 4 + 1);
        s1 = ld(sh + slot * 4 + 2);
        s2 = ld(sh + slot * 4 + 3);
      }
      s.ps_src[tid] = src;
      s.ps_td[tid] = td;
      s.ps_sh[tid * 3 + 0] = s0;
      s.ps_sh[tid * 3 + 1] = s1;
      s.ps_sh[tid * 3 + 2] = s2;
    }
    for (int o = tid; o < PT * A; o += nt) {
      const int q = o / A, k = o % A;
      float r = 0.0f;
      if (q < np) {
        const int e = s.list[t0 + q];
        r = ld(attr + ((long long)entry_slot(e) * K + entry_index(e)) * A + k);
      }
      s.rs[o] = r;
    }
    __syncthreads();
    radial_layer1<T, A>(s, p.w, s.list + t0, np, tid, nt);
    __syncthreads();
    if (has_c) messages<T>(s, x, w2r, b2c, np, c, S, V, nt, st);
    __syncthreads();
  }
  flush(s, st, c, has_c, nt);
  __syncthreads();

  float* out = p.out + ((long long)g * N + i0) * OW;
  for (int o = tid; o < nd * OW; o += nt) {
    const int td = o / OW;
    int comp, ch;  // conv_block_body.cuh's packed order
    column_source(o % OW, S, V, comp, ch);
    out[o] = s.acc[(td * 3 + comp) * nt + ch];
  }
  if (tid < nd) p.deg_out[(long long)g * N + i0 + tid] = s.deg[tid];
}

template <typename T, int A>
int launch(const Params& p, int G, void* stream) {
  const int nt = threads_for(2 * p.S + 3 * p.V);
  const size_t smem = nbr_words(A, p.K, nt) * 4;
  if (nt > MAX_THREADS || p.K > MAX_SLOTS || G > 65535 || smem > MAX_SMEM)
    return (int)cudaErrorInvalidValue;
  if (G == 0 || p.N == 0) return 0;
  cudaError_t err = cudaFuncSetAttribute(nbr_conv_kernel<T, A>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((p.N + TDN - 1) / TDN, G);
  nbr_conv_kernel<T, A><<<grid, nt, smem, (cudaStream_t)stream>>>(p);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch(const Params& p, int A, int G, void* stream) {
  if (A == 64) return launch<T, 64>(p, G, stream);
  if (A == 32) return launch<T, 32>(p, G, stream);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

#define NBR_CONV_ENTRY(NAME, TYPE)                                                            \
  extern "C" int NAME(const void* x, const void* sh, const void* attr, const void* idx,      \
                      const void* mask, const void* w1, const void* b1, const void* w2,      \
                      const void* b2, void* out, void* deg_out, int G, int N, int K, int A,  \
                      int S, int V, void* stream) {                                          \
    Params p{x,                                                                              \
             sh,                                                                             \
             attr,                                                                           \
             (const int64_t*)idx,                                                            \
             (const float*)mask,                                                             \
             Weights{w1, (const float*)b1, (const float*)b1, w2, (const float*)b2, nullptr,  \
                     nullptr, nullptr, nullptr, nullptr, nullptr},                           \
             (float*)out,                                                                    \
             (float*)deg_out,                                                                \
             N,                                                                              \
             K,                                                                              \
             S,                                                                              \
             V};                                                                             \
    return dispatch<TYPE>(p, A, G, stream);                                                  \
  }

NBR_CONV_ENTRY(nbr_conv_f32, float)
NBR_CONV_ENTRY(nbr_conv_bf16, __nv_bfloat16)
