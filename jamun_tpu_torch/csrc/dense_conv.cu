// The dense messages of one separable conv layer (l <= 1, uvu) straight
// from the positions: pair geometry, adjacency, radial MLP per pair and the
// uvu messages of the source features, summed per destination atom, and the
// degree. No bonds, no mean, no post-linear: the caller adds them.
//
// Replaces two TPU kernels that compute this one function:
//   K8: `_kernel` of jamun_tpu/ops/pallas/packed_conv.py (pallas_call at
//       line 515, entry `packed_uvu_conv_dense`), V >= 0;
//   K9: `_kernel_one` of jamun_tpu/ops/pallas/fused_conv.py (pallas_call at
//       line 317, entry `fused_uvu_conv_dense`), V > 0 only.
// JAX's `Conv` runs K8 for a dense call under pallas_variant="packed" that
// the fused layer does not take, and K9 for every hidden layer of
// `E3Conv(pallas_variant="plane")`. The TPU kernels evaluate all N*N pairs
// of a graph (K8 as lane-packed [C, N*N] panels with one-hot gathers and
// aggregation matmuls; K9 as [N, N, C] planes with the adjacency applied to
// the path weights, one output plane per path). Their layouts are Mosaic's
// and do not carry over. Here one CTA owns TD destination atoms of one
// graph, as in the tiled ConvBlock kernel (fused_block_tiled.cu): it keeps
// the graph's positions and node mask in shared memory (16 bytes per atom),
// lists the pairs inside the cutoff dst-major (one warp per atom, two
// passes: count, then write at the offsets the counts give), and for every
// tile of PT pairs rebuilds the spherical harmonics and the NR radial values
// (edge_geometry.cuh's rounded intrinsics) before conv_block_body.cuh's
// radial_layer1 (the bondedness-0 block of the first layer folded into b1 by
// the caller in f32, as both TPU wrappers do) and messages. Then it stops,
// as the sparse kernel (nbr_conv.cu) does: the raw f32 sums leave in the
// packed order [Sx0e | Sx1e | Vx1e | Vx0e | Vx1e] (l = 1 interleaved as
// (mul, component) in (y, z, x)), or [Sx0e | Sx1e] at V = 0, beside the
// count of dense pairs per atom as the degree. K8 and K9 run the same code,
// so they agree bit for bit; their entries differ only in that K9 refuses
// V = 0, as `supports_fused_conv` does.
//
// Two builds. f32 (dense_conv_kernel<float>) keeps the FP32 FMA steps of
// conv_block_body.cuh for 8 dst atoms per CTA. bf16 (dense_conv_mma_kernel)
// runs radial layers 1 and 2 on the tensor cores (mma.sync m16n8k16,
// conv_block_mma.cuh) for 16 dst atoms per CTA, with the pair list built by
// every warp and walked in passes over the sources where one list would not
// fit (tiled_pairs_mma.cuh, shared with the tiled ConvBlock's bf16 build),
// then the same messages, order and output.
//
// Bound on the H100: the bytes, at bf16's tensor-core rate (the block input
// read once, the f32 output written once; about 0.011 ms at 4AA). What bounds
// it in practice is latency, as for the per-layer kernel: the FMA build spent
// 68% of its time in radial layer 2 with the messages (layer 2 alone 58%),
// 15% in layer 1 and under 10% in the list and the geometry (clock64 stamps
// and builds that leave one step out, scripts/torch_phase_split.py, 4AA); the
// bf16 build moves both radial layers to the tensor cores, so the message
// loop, bound by its instructions per (pair, channel), is what is left.
// Shared memory grows with N: FMA, the pair list (TD * N entries) and the
// positions, refused where it does not fit; bf16, 16 bytes of position per
// atom beside a pass list of 16 J entries.
//
// Rounding points are conv_block_body.cuh's: the pair features and h in T,
// the radial weights in T, f32 message products and sums (the TPU kernels
// round each message product to T before their f32 sums).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "conv_block_body.cuh"
#include "edge_geometry.cuh"
#include "tiled_pairs_mma.cuh"

namespace {

using namespace conv_block;
using edge_geometry::pair_dist;
using edge_geometry::radial_basis;
using edge_geometry::sh_component;

struct Params {
  const void* x;             // [G, N, F] T, F = S + 3V (vector block [V][3] in y, z, x)
  const float* pos;          // [G, N, 3] scaled positions
  const uint8_t* node_mask;  // [G, N]
  Weights w;                 // w1 [NR, H] T, b1d = b1b = b1 [H] f32, w2 [H, W] T, b2 [W] f32
  float* out;                // [G, N, 4S + 7V] f32
  float* deg_out;            // [G, N] f32
  float cutoff;
  int N, S, V;
};

constexpr size_t MAX_SMEM = 232448;  // bytes of shared memory a block may use

// words of shared memory: conv_block's scratch without bonds or epilogue,
// then positions [N][3], node mask [N] and a tile's distances [PT]
__host__ __device__ inline size_t dense_words(int N, int nt) {
  return scratch_words(N, 0, nt, 0, 0, TD) + (size_t)4 * N + PT;
}

template <typename T>
__global__ void __launch_bounds__(MAX_THREADS) dense_conv_kernel(Params p) {
  extern __shared__ float smem[];
  const int N = p.N, S = p.S, V = p.V;
  const int F = S + 3 * V, W = 2 * S + 3 * V, OW = 4 * S + 7 * V;
  const int nt = blockDim.x, tid = threadIdx.x;
  const int g = blockIdx.y, i0 = blockIdx.x * TD;
  const int nd = min(TD, N - i0);

  const GlobalRows<T> x{(const T*)p.x + (long long)g * N * F, F};
  const float* pos = p.pos + (long long)g * N * 3;
  const uint8_t* nmask = p.node_mask + (long long)g * N;

  const Scratch s = carve(smem, N, 0, nt, 0, 0, TD);
  float* pos_s = smem + scratch_words(N, 0, nt, 0, 0, TD);  // [N][3]
  float* mask_s = pos_s + 3 * N;                            // [N] 1 for a real atom
  float* ps_dist = mask_s + N;                              // [PT]

  for (int k = tid; k < 3 * N; k += nt) pos_s[k] = pos[k];
  for (int k = tid; k < N; k += nt) mask_s[k] = nmask[k] ? 1.0f : 0.0f;
  const int c = tid;  // this thread's radial output channel
  const bool has_c = c < W;
  float w2r[H];
  float b2c;
  load_weights<T>(s, p.w, W, TD, tid, nt, w2r, b2c);
  __syncthreads();

  // The pairs inside the cutoff into dst slot td, by source; one warp, all
  // lanes. Returns their number; with `write` the entries go to
  // list[base ...].
  const int warp = tid >> 5, lane = tid & 31, nwarps = nt >> 5;
  const unsigned lt = (1u << lane) - 1u;
  auto scan = [&](int td, int base, bool write) {
    const int i = i0 + td;
    const bool mi = mask_s[i] != 0.0f;
    const float xi = pos_s[3 * i + 0], yi = pos_s[3 * i + 1], zi = pos_s[3 * i + 2];
    int count = 0;
    for (int j0 = 0; j0 < N; j0 += 32) {
      const int j = j0 + lane;
      bool a = false;
      if (mi && j < N && j != i && mask_s[j] != 0.0f) {
        a = pair_dist(pos_s[3 * j + 0] - xi, pos_s[3 * j + 1] - yi, pos_s[3 * j + 2] - zi) <
            p.cutoff;
      }
      const unsigned m = __ballot_sync(0xffffffffu, a);
      if (write && a) s.list[base + count + __popc(m & lt)] = encode(td, 0, j);
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
    // stage the tile: source, dst slot, spherical harmonics, distance
    if (tid < PT) {
      int src = 0, td = 0;
      float s0 = 0.0f, s1 = 0.0f, s2 = 0.0f, dist = 0.0f;
      if (tid < np) {
        const int e = s.list[t0 + tid];
        td = entry_slot(e);
        src = entry_index(e);
        const int i = i0 + td;
        const float dx = pos_s[3 * src + 0] - pos_s[3 * i + 0];
        const float dy = pos_s[3 * src + 1] - pos_s[3 * i + 1];
        const float dz = pos_s[3 * src + 2] - pos_s[3 * i + 2];
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
      const int q = o / NR, k = o % NR;
      s.rs[o] = q < np ? rnd<T>(radial_basis(k, ps_dist[q], p.cutoff, NR)) : 0.0f;
    }
    __syncthreads();
    radial_layer1<T>(s, p.w, s.list + t0, np, tid, nt);
    __syncthreads();
    if (has_c) messages<T>(s, x, w2r, b2c, np, c, S, V, nt, st);
    __syncthreads();
  }
  flush(s, st, c, has_c, nt);
  __syncthreads();

  float* out = p.out + ((long long)g * N + i0) * OW;
  for (int o = tid; o < nd * OW; o += nt) {
    const int td = o / OW;
    int comp, ch;
    column_source(o % OW, S, V, comp, ch);
    out[o] = s.acc[(td * 3 + comp) * nt + ch];
  }
  if (tid < nd) p.deg_out[(long long)g * N + i0 + tid] = s.deg[tid];
}

// The bf16 kernel: the same function on the tensor cores for TDM = 16
// destination atoms (tiled_pairs_mma.cuh's pair loop without bonds), then
// the raw sums out as the FMA kernel writes them
__global__ void __launch_bounds__(MAX_THREADS) dense_conv_mma_kernel(Params p) {
  using bf16 = __nv_bfloat16;
  extern __shared__ float4 smem_mma[];
  char* base = reinterpret_cast<char*>(smem_mma);
  const int N = p.N, S = p.S, V = p.V;
  const int F = S + 3 * V, OW = 4 * S + 7 * V;
  const int nt = blockDim.x, tid = threadIdx.x;
  const int g = blockIdx.y, i0 = blockIdx.x * tiled::TDM;
  const int nd = min(tiled::TDM, N - i0);

  const bf16* x = (const bf16*)p.x + (long long)g * N * F;
  const tiled::Geometry geo{p.pos + (long long)g * N * 3, p.node_mask + (long long)g * N,
                            nullptr, nullptr, nullptr, p.cutoff, N, 0};
  const tiled::Layout l = tiled::layout(N, 0, S, V, 0, 0, nt);
  Scratch s{};
  s.acc = (float*)(base + l.acc);
  s.deg = (float*)(base + l.deg);
  tiled::pair_loop(l, base, s, geo, p.w, x, S, V, i0, nd, tid, nt);

  float* out = p.out + ((long long)g * N + i0) * OW;
  for (int o = tid; o < nd * OW; o += nt) {
    const int td = o / OW;
    int comp, ch;
    column_source(o % OW, S, V, comp, ch);
    out[o] = s.acc[(td * 3 + comp) * nt + ch];
  }
  if (tid < nd) p.deg_out[(long long)g * N + i0 + tid] = s.deg[tid];
}

// the kernel of a compute type, its dst atoms per CTA and its shared memory
template <typename T>
struct KernelOf {
  static constexpr auto fn = dense_conv_kernel<T>;
  static constexpr int td = TD;
  static size_t smem(int N, int S, int V, int nt) { return dense_words(N, nt) * 4; }
};
template <>
struct KernelOf<__nv_bfloat16> {
  static constexpr auto fn = dense_conv_mma_kernel;
  static constexpr int td = tiled::TDM;
  static size_t smem(int N, int S, int V, int nt) { return tiled::layout(N, 0, S, V, 0, 0, nt).total; }
};

template <typename T>
size_t smem_bytes(int N, int S, int V) {
  return KernelOf<T>::smem(N, S, V, threads_for(2 * S + 3 * V));
}

template <typename T>
int launch(const Params& p, int G, void* stream) {
  const int nt = threads_for(2 * p.S + 3 * p.V);
  const size_t smem = smem_bytes<T>(p.N, p.S, p.V);
  if (nt > MAX_THREADS || p.N >= MAX_INDEX || G > 65535 || smem > MAX_SMEM)
    return (int)cudaErrorInvalidValue;
  if (G == 0 || p.N == 0) return 0;
  cudaError_t err =
      cudaFuncSetAttribute(KernelOf<T>::fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((p.N + KernelOf<T>::td - 1) / KernelOf<T>::td, G);
  const auto kernel = KernelOf<T>::fn;
  kernel<<<grid, nt, smem, (cudaStream_t)stream>>>(p);
  return (int)cudaGetLastError();
}

template <typename T>
int occupancy(int N, int S, int V, int* out) {
  const int nt = threads_for(2 * S + 3 * V);
  const size_t smem = smem_bytes<T>(N, S, V);
  if (nt > MAX_THREADS || smem > MAX_SMEM) return (int)cudaErrorInvalidValue;
  cudaError_t err =
      cudaFuncSetAttribute(KernelOf<T>::fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  cudaFuncAttributes attr;
  err = cudaFuncGetAttributes(&attr, KernelOf<T>::fn);
  if (err != cudaSuccess) return (int)err;
  int ctas = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&ctas, KernelOf<T>::fn, nt, smem);
  if (err != cudaSuccess) return (int)err;
  const bool mma = KernelOf<T>::td == tiled::TDM;
  const int values[8] = {nt, (int)smem, attr.numRegs, (int)attr.localSizeBytes, ctas,
                         KernelOf<T>::td, mma ? tiled::layout(N, 0, S, V, 0, 0, nt).J : N, 0};
  for (int k = 0; k < 8; ++k) out[k] = values[k];
  return 0;
}

}  // namespace

// K8 takes V >= 0, K9 V > 0 only; both launch the same kernel
#define DENSE_CONV_ENTRY(NAME, TYPE, MIN_V)                                                     \
  extern "C" int NAME(const void* x, const void* pos, const void* node_mask, const void* w1,   \
                      const void* b1, const void* w2, const void* b2, void* out, void* deg_out, \
                      float cutoff, int G, int N, int S, int V, void* stream) {                \
    if (V < MIN_V) return (int)cudaErrorInvalidValue;                                          \
    Params p{x,                                                                                \
             (const float*)pos,                                                                \
             (const uint8_t*)node_mask,                                                        \
             Weights{w1, (const float*)b1, (const float*)b1, w2, (const float*)b2, nullptr,    \
                     nullptr, nullptr, nullptr, nullptr, nullptr},                             \
             (float*)out,                                                                      \
             (float*)deg_out,                                                                  \
             cutoff,                                                                           \
             N,                                                                                \
             S,                                                                                \
             V};                                                                               \
    return launch<TYPE>(p, G, stream);                                                         \
  }

DENSE_CONV_ENTRY(packed_uvu_conv_dense_f32, float, 0)
DENSE_CONV_ENTRY(packed_uvu_conv_dense_bf16, __nv_bfloat16, 0)
DENSE_CONV_ENTRY(fused_uvu_conv_dense_f32, float, 1)
DENSE_CONV_ENTRY(fused_uvu_conv_dense_bf16, __nv_bfloat16, 1)

// bytes of dynamic shared memory one CTA of the f32 (bf16 = 0) or bf16 build
// takes at these sizes
extern "C" int dense_conv_smem(int bf16, int N, int S, int V) {
  return (int)(bf16 ? smem_bytes<__nv_bfloat16>(N, S, V) : smem_bytes<float>(N, S, V));
}

// How a build is launched at these sizes and what the card makes of it:
// out = {threads, bytes of shared memory per CTA, registers per thread,
// local (spill) bytes per thread, CTAs resident per SM, dst atoms per CTA,
// sources per pass of the pair list, 0 (no epilogue)}
extern "C" int dense_conv_occupancy(int bf16, int N, int S, int V, int* out) {
  return bf16 ? occupancy<__nv_bfloat16>(N, S, V, out) : occupancy<float>(N, S, V, out);
}
