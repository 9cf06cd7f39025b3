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
// of that carries over. Here one CTA owns the destination atoms of one
// graph that fill an m-tile, as the per-layer kernel's CTA does: it lists
// their masked-in slots dst-major, every warp one atom at a time (on the
// repo's chain geometry about a quarter of the K slots pass the mask, so
// the work follows the kept edges, not K), stages each tile of PT slots
// (source atom, spherical harmonics, A edge attributes) in shared memory
// and runs the ConvBlock steps up to the messages. The normalisation and
// the epilogue are not run: the messages leave unnormalised in f32, in
// JAX's packed order [Sx0e | Sx1e | Vx1e | Vx0e | Vx1e] with l = 1 in
// (y, z, x), beside the count of masked-in slots as the degree. The caller
// adds the bonds, divides by the combined degree and applies the
// post-linear.
//
// A = 64 takes the model's whole edge attributes (bondedness embedding and
// radial basis); A = 32 the radial half from the edge-features kernel
// (nbr_edge_features.cu), the constant bondedness-0 block folded into b1 by
// the caller in f32.
//
// Two builds. f32 (nbr_conv_kernel<float, A>) keeps conv_block_body.cuh's
// FP32 FMA steps for TDN = 16 atoms: thread c owns radial channel c and
// keeps its 64 layer-2 weights in registers, the tile's attributes are
// staged by scalar loads, the source rows read from device memory
// (GlobalRows). bf16 (nbr_conv_mma_kernel<A>) runs radial layers 1 and 2 on
// the tensor cores (mma.sync m16n8k16 bf16 -> f32, conv_block_mma.cuh, with
// layer 1 A wide) for TDM = 8 atoms: the weights staged once per CTA as
// bf16 tiles with 16-byte loads (w2 swizzled, 43 KB at the flagship width,
// out of the registers), each slot's attributes copied straight into layer
// 1's A operand with 16-byte loads; the list keeps each slot's source atom
// beside it, read once while listing, and the messages read the source rows
// from device memory (SourceRows), QB pairs' reads issued together. Then the
// same messages, order and output as the FMA build. With w2 out of the
// registers, 8 atoms' accumulators and no staged tile of source rows, two
// CTAs of the hidden block share an SM (16 atoms per CTA, or the rows staged
// per tile, leave one), and the walk's 256-512 CTAs run in fewer waves.
//
// Bound on the H100: the bytes at bf16's tensor-core rate (per kept slot
// 2 * (A * 64 + 64 * W) flops, about 51 kflop at the flagship width with
// A = 64, against A + 4 attributes, an index and one source row; the output
// is 4S + 7V f32 per atom). In practice latency: a CTA owns a few tiles,
// each a chain of staging, layer 1, layer 2 and the message loop behind
// barriers (scripts/torch_phase_split.py splits it).
//
// Rounding points are the body's: h and the radial weights in T, f32
// message products and sums (the TPU kernel rounds each product to T before
// its f32 sum).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "conv_block_body.cuh"
#include "conv_block_mma.cuh"

namespace {

using namespace conv_block;

constexpr int TDN = 16;         // destination atoms per CTA of the FMA build
constexpr int TDM = 8;          // destination atoms per CTA of the bf16 build
constexpr int MAX_SLOTS = 256;  // K of one list (a CTA lists TDN * K entries)
constexpr int MAX_SOURCE = 1 << 16;  // atoms the bf16 build indexes (mma::pair_info)
constexpr size_t MAX_SMEM = 232448;  // bytes of shared memory a block may use
static_assert(TDM <= 16, "the dst slot takes the top bits of mma::pair_info");

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

// shared memory of the bf16 CTA (bytes): the accumulators, degree and the
// list's length live through it; then the tile's pair data, the operand
// tiles and the list (slot entries, then their source atoms)
struct MmaLayout {
  size_t acc, deg, n_list, ps4, pair, list, srcs, total;
};

__host__ __device__ inline MmaLayout mma_layout(int A, int K, int S, int V, int nt) {
  using namespace conv_block::mma;
  const int W = 2 * S + 3 * V;
  MmaLayout l;
  l.acc = 0;
  l.deg = l.acc + align16((size_t)TDM * 3 * nt * 4);
  l.n_list = l.deg + align16((size_t)TDM * 4);
  l.ps4 = l.n_list + 16;
  l.pair = l.ps4 + align16((size_t)PT * 16);
  l.list = l.pair + (A == 32 ? pair_tiles_bytes<32>(W) : pair_tiles_bytes<64>(W));
  l.srcs = l.list + align16((size_t)TDM * K * 4);
  l.total = l.srcs + align16((size_t)TDM * K * 4);
  return l;
}

// The bf16 kernel: the FMA kernel's function on the tensor cores for TDM
// destination atoms
template <int A>
__global__ void __launch_bounds__(MAX_THREADS) nbr_conv_mma_kernel(Params p) {
  using bf16 = __nv_bfloat16;
  extern __shared__ float4 smem_mma[];
  char* base = reinterpret_cast<char*>(smem_mma);
  const int N = p.N, K = p.K, S = p.S, V = p.V;
  const int F = S + 3 * V, W = 2 * S + 3 * V, OW = 4 * S + 7 * V;
  const int nt = blockDim.x, tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31, nwarps = nt >> 5;
  const int g = blockIdx.y, i0 = blockIdx.x * TDM;
  const int nd = min(TDM, N - i0);

  const MmaLayout l = mma_layout(A, K, S, V, nt);
  Scratch s{};
  s.acc = (float*)(base + l.acc);
  s.deg = (float*)(base + l.deg);
  int* n_list = (int*)(base + l.n_list);
  float4* ps4 = (float4*)(base + l.ps4);
  const mma::PairTiles t = mma::carve_pair_tiles<A>(base + l.pair, W);
  int* list = (int*)(base + l.list);
  int* srcs = (int*)(base + l.srcs);

  const bf16* x = (const bf16*)p.x + (long long)g * N * F;
  const long long slot0 = ((long long)g * N + i0) * K;  // the first slot of the CTA's atoms
  const float* mask = p.mask + slot0;
  const int64_t* idx = p.idx + slot0;
  const bf16* sh = (const bf16*)p.sh + slot0 * 4;
  const bf16* attr = (const bf16*)p.attr + slot0 * A;

  mma::load_pair_weights<A>(t, p.w, W, tid, nt);
  for (int k = tid; k < TDM * 3 * nt; k += nt) s.acc[k] = 0.0f;

  // The masked-in slots of dst slot td in slot order; one warp, all lanes.
  // Returns their number; with at >= 0 the entries go to list[at ...] and
  // their source atoms to srcs[at ...].
  const unsigned lt = (1u << lane) - 1u;
  auto scan = [&](int td, int at) {
    int count = 0;
    for (int k0 = 0; k0 < K; k0 += 32) {
      const int k = k0 + lane;
      const bool a = k < K && mask[(long long)td * K + k] > 0.0f;
      const unsigned m = __ballot_sync(0xffffffffu, a);
      if (a && at >= 0) {
        const int e = at + count + __popc(m & lt);
        list[e] = encode(td, 0, k);
        srcs[e] = (int)idx[(long long)td * K + k];
      }
      count += __popc(m);
    }
    return count;
  };
  for (int td = warp; td < nd; td += nwarps) {
    const int count = scan(td, -1);
    if (lane == 0) s.deg[td] = (float)count;
  }
  __syncthreads();
  for (int td = warp; td < nd; td += nwarps) {
    int at = 0;
    for (int u = 0; u < td; ++u) at += (int)s.deg[u];
    scan(td, at);
  }
  if (tid == 0) {
    int total = 0;
    for (int u = 0; u < nd; ++u) total += (int)s.deg[u];
    *n_list = total;
  }
  __syncthreads();
  const int nl = *n_list;

  constexpr int L1 = mma::ld_of(A), AC = A / 8;  // 16-byte chunks of a slot's attributes
  const mma::SourceRows xq{x, F};
  const bool a16 = ((uintptr_t)attr & 15) == 0;
  ChannelSum st;
  for (int t0 = 0; t0 < nl; t0 += PT) {
    const int np = min(PT, nl - t0);
    const int* tile = list + t0;
    const int* tsrc = srcs + t0;
    // stage the tile: per slot its dst slot, source and spherical harmonics,
    // and its attributes as layer 1's A operand
    if (tid < PT) {
      int td = 0, src = 0;
      float s0 = 0.0f, s1 = 0.0f, s2 = 0.0f;
      if (tid < np) {
        const int e = tile[tid];
        const long long slot = (long long)entry_slot(e) * K + entry_index(e);
        td = entry_slot(e);
        src = tsrc[tid];
        s0 = ld(sh + slot * 4 + 1);
        s1 = ld(sh + slot * 4 + 2);
        s2 = ld(sh + slot * 4 + 3);
      }
      ps4[tid] = mma::pair_info(s0, s1, s2, td, src);
    }
    if (a16) {
      for (int o = tid; o < PT * AC; o += nt) {
        const int q = o / AC, part = o % AC;
        uint4 v = make_uint4(0u, 0u, 0u, 0u);
        if (q < np) {
          const int e = tile[q];
          const long long slot = (long long)entry_slot(e) * K + entry_index(e);
          v = __ldg(reinterpret_cast<const uint4*>(attr + slot * A) + part);
        }
        *reinterpret_cast<uint4*>(t.rs + q * L1 + part * 8) = v;
      }
    } else {
      for (int o = tid; o < PT * A; o += nt) {
        const int q = o / A, k = o % A;
        bf16 v = __float2bfloat16_rn(0.0f);
        if (q < np) {
          const int e = tile[q];
          v = attr[((long long)entry_slot(e) * K + entry_index(e)) * A + k];
        }
        t.rs[q * L1 + k] = v;
      }
    }
    __syncthreads();
    mma::radial_layer1<A>(t, p.w, tile, np, warp, nwarps, lane);
    __syncthreads();
    mma::layer2_messages(s, ps4, t, xq, p.w.b2, W, np, S, V, warp, lane, nt, st);
    __syncthreads();
  }
  flush(s, st, tid, tid < W, nt);
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

// the kernel of a compute type and attribute width, its dst atoms per CTA
// and its shared memory
template <typename T, int A>
struct KernelOf {
  static constexpr auto fn = nbr_conv_kernel<T, A>;
  static constexpr int td = TDN;
  static constexpr int max_n = 1 << 30;
  static size_t smem(int K, int S, int V, int nt) { return nbr_words(A, K, nt) * 4; }
};
template <int A>
struct KernelOf<__nv_bfloat16, A> {
  static constexpr auto fn = nbr_conv_mma_kernel<A>;
  static constexpr int td = TDM;
  static constexpr int max_n = MAX_SOURCE - 1;
  static size_t smem(int K, int S, int V, int nt) { return mma_layout(A, K, S, V, nt).total; }
};

template <typename T, int A>
int launch(const Params& p, int G, void* stream) {
  using KO = KernelOf<T, A>;
  const int nt = threads_for(2 * p.S + 3 * p.V);
  const size_t smem = KO::smem(p.K, p.S, p.V, nt);
  if (nt > MAX_THREADS || p.K > MAX_SLOTS || G > 65535 || smem > MAX_SMEM || p.N > KO::max_n)
    return (int)cudaErrorInvalidValue;
  if (G == 0 || p.N == 0) return 0;
  cudaError_t err = cudaFuncSetAttribute(KO::fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((p.N + KO::td - 1) / KO::td, G);
  const auto kernel = KO::fn;
  kernel<<<grid, nt, smem, (cudaStream_t)stream>>>(p);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch(const Params& p, int A, int G, void* stream) {
  if (A == 64) return launch<T, 64>(p, G, stream);
  if (A == 32) return launch<T, 32>(p, G, stream);
  return (int)cudaErrorInvalidValue;
}

template <typename T, int A>
int occupancy(int K, int S, int V, int* out) {
  using KO = KernelOf<T, A>;
  const int nt = threads_for(2 * S + 3 * V);
  const size_t smem = KO::smem(K, S, V, nt);
  if (nt > MAX_THREADS || K > MAX_SLOTS || smem > MAX_SMEM) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(KO::fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  cudaFuncAttributes attr;
  err = cudaFuncGetAttributes(&attr, KO::fn);
  if (err != cudaSuccess) return (int)err;
  int ctas = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&ctas, KO::fn, nt, smem);
  if (err != cudaSuccess) return (int)err;
  const int values[6] = {nt, (int)smem, attr.numRegs, (int)attr.localSizeBytes, ctas, KO::td};
  for (int k = 0; k < 6; ++k) out[k] = values[k];
  return 0;
}

template <typename T>
int occupancy_of(int A, int K, int S, int V, int* out) {
  if (A == 64) return occupancy<T, 64>(K, S, V, out);
  if (A == 32) return occupancy<T, 32>(K, S, V, out);
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

// bytes of dynamic shared memory one CTA of the f32 (bf16 = 0) or bf16 build
// takes at these sizes
extern "C" int nbr_conv_smem(int bf16, int A, int K, int S, int V) {
  const int nt = threads_for(2 * S + 3 * V);
  if (A != 32 && A != 64) return -1;
  if (bf16) return (int)mma_layout(A, K, S, V, nt).total;
  return (int)(nbr_words(A, K, nt) * 4);
}

// How a build is launched at these sizes and what the card makes of it:
// out = {threads, bytes of shared memory per CTA, registers per thread,
// local (spill) bytes per thread, CTAs resident per SM, dst atoms per CTA}
extern "C" int nbr_conv_occupancy(int bf16, int A, int K, int S, int V, int* out) {
  return bf16 ? occupancy_of<__nv_bfloat16>(A, K, S, V, out) : occupancy_of<float>(A, K, S, V, out);
}
