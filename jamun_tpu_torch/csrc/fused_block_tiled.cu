// One whole separable ConvBlock of the dense E3Conv (l <= 1, uvu) straight
// from the positions, for any number of atoms: pair geometry, radial MLP per
// pair, depthwise messages over dense pairs and bonds, mean over the combined
// degree, post-linear, gate, second linear and the linear skip of the block
// input.
//
// Replaces the TPU kernel `_tiled_block_kernel` / `_block_body` of
// jamun_tpu/ops/pallas/packed_conv.py (pallas_call at line 2819, entry
// `packed_fused_block_v2`, reached through `make_trainable_conv_block_v2`),
// which the JAX model takes above 128 atoms. The TPU kernel runs one program
// per (K graphs, block of Nblk destination atoms), evaluates all Nblk x N
// pairs of the block as lane-packed panels, gathers sources by tiling and
// aggregates with one-hot matmuls; its point is that the [N*N] edge features
// never reach device memory. Here one CTA owns TD destination atoms of one
// graph, as in the per-layer kernel (conv_block.cu), but it reads no edge
// features: it keeps the graph's positions and node mask in shared memory
// (16 bytes per atom), lists the pairs inside the cutoff and the real bonds
// into its atoms from them, and for every tile of PT list entries recomputes
// the spherical harmonics and the NR radial values (edge_geometry.cuh, the
// rounded intrinsics of the edge-features kernel, so both agree on every
// adjacency entry) before the shared ConvBlock steps of conv_block_body.cuh.
// Bond geometry is computed the same way, from the positions of the bond's
// two atoms. Nothing with two atom axes exists in device memory.
//
// The pair list is built by up to TD warps at once, one destination atom
// each, in two passes over the atom's candidates (count, then write at the
// offset the counts give), so the list stays dst-major and contiguous.
//
// Two builds. f32 (fused_block_tiled_kernel<float>) keeps the FP32 FMA steps
// of conv_block_body.cuh for 8 dst atoms per CTA: thread c owns radial
// channel c with its 64 layer-2 weights in registers. bf16
// (fused_block_tiled_mma_kernel) is the per-layer kernel's bf16 build
// (conv_block.cu) with this kernel's geometry: 16 dst atoms per CTA, the
// radial MLP and the epilogue's products on the tensor cores (mma.sync
// m16n8k16, conv_block_mma.cuh), the pair list built by every warp and
// walked in passes over the sources where one list would not fit
// (tiled_pairs_mma.cuh). Its rounding points are the FMA build's, and with
// the same pairs in the same order its outputs are the per-layer kernel's
// bf16 outputs bit for bit.
//
// Bound on the H100. By the card's peaks the bf16 block is bound by its
// operations on the tensor cores, about 0.013 ms at the N = 256 walk's first
// frame: per visited pair 2 * (NR * 64 + 64 * W) flops of radial MLP
// (W = 2S + 3V), per atom the epilogue, against 12 bytes of positions per
// atom and the block input read through L2 (GlobalRows). What bounds it in
// practice is latency: a CTA owns 16 atoms and a few hundred pairs, each
// step a short chain of dependent loads at one CTA per SM (hidden block).
// The FMA build spent 57% of its time in radial layer 2 with the messages,
// 30% in the epilogue and under 10% in the list and the geometry (clock64
// stamps, scripts/torch_phase_split.py); the bf16 build moves layer 2 and the
// epilogue's products to the tensor cores and keeps the geometry's
// recomputation, which costs a few percent. Shared memory grows with N and B
// through the pair list (FMA: TD * N + B entries, refused where it does not
// fit; bf16: 16 J + B entries for J sources per pass, plus 16 bytes of
// position per atom).
//
// Rounding points are those of conv_block_body.cuh (K2's), with the pair
// features rounded to T where the edge-features kernel stores them.

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
  const int64_t* bond_src;   // [G, B]
  const int64_t* bond_dst;   // [G, B]
  const uint8_t* bond_mask;  // [G, B]
  Weights w;
  float* out;      // [G, N, Sc + 3Vg] f32 (vector block [Vg][3])
  float* deg_out;  // [G, N] f32 or null: the combined degree
  float cutoff;
  int N, B, S, V, Sc, Vg;
};

constexpr size_t MAX_SMEM = 232448;  // bytes of shared memory a block may use

// words of shared memory after conv_block's scratch: positions [N][3], node
// mask [N], a tile's distances [PT]
__host__ __device__ inline size_t geometry_words(int N) { return (size_t)4 * N + PT; }

template <typename T>
__global__ void __launch_bounds__(MAX_THREADS) fused_block_tiled_kernel(Params p) {
  extern __shared__ float smem[];
  const int N = p.N, B = p.B, S = p.S, V = p.V, Sc = p.Sc, Vg = p.Vg;
  const int F = S + 3 * V, W = 2 * S + 3 * V, OF = Sc + 3 * Vg;
  const int nt = blockDim.x, tid = threadIdx.x;
  const int g = blockIdx.y, i0 = blockIdx.x * TD;
  const int nd = min(TD, N - i0);

  const GlobalRows<T> x{(const T*)p.x + (long long)g * N * F, F};
  const float* pos = p.pos + (long long)g * N * 3;
  const uint8_t* nmask = p.node_mask + (long long)g * N;
  const int64_t* bsrc = p.bond_src + (long long)g * B;
  const int64_t* bdst = p.bond_dst + (long long)g * B;
  const uint8_t* bmask = p.bond_mask + (long long)g * B;

  const Scratch s = carve(smem, N, B, nt, Sc, Vg, TD);
  float* pos_s = smem + scratch_words(N, B, nt, Sc, Vg, TD);  // [N][3]
  float* mask_s = pos_s + 3 * N;                              // [N] 1 for a real atom
  float* ps_dist = mask_s + N;                                // [PT]

  for (int k = tid; k < 3 * N; k += nt) pos_s[k] = pos[k];
  for (int k = tid; k < N; k += nt) mask_s[k] = nmask[k] ? 1.0f : 0.0f;
  const int c = tid;  // this thread's radial output channel
  const bool has_c = c < W;
  float w2r[H];
  float b2c;
  load_weights<T>(s, p.w, W, TD, tid, nt, w2r, b2c);
  __syncthreads();

  // The pairs inside the cutoff and the real bonds into dst slot td, in the
  // order (dense pairs by source, then bonds); one warp, all lanes. Returns
  // their number; with `write` the entries go to list[base ...].
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
    for (int b0 = 0; b0 < B; b0 += 32) {
      const int b = b0 + lane;
      const bool a = b < B && bdst[b] == i && bmask[b];
      const unsigned m = __ballot_sync(0xffffffffu, a);
      if (write && a) s.list[base + count + __popc(m & lt)] = encode(td, 1, b);
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
        src = entry_is_bond(e) ? (int)bsrc[entry_index(e)] : entry_index(e);
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

  normalise<T>(s, nd, tid, nt);
  __syncthreads();
  if (p.deg_out != nullptr && tid < nd) p.deg_out[(long long)g * N + i0 + tid] = s.deg[tid];
  float* out = p.out + ((long long)g * N + i0) * OF;
  epilogue<T>(s, p.w, x, [&](int td, int col, float v) { out[(long long)td * OF + col] = v; },
              i0, nd, S, V, Sc, Vg, tid, nt);
}

// The bf16 kernel: the same function on the tensor cores for TDM = 16
// destination atoms (tiled_pairs_mma.cuh's pair loop, then conv_block_mma's
// mean and epilogue, as the per-layer kernel's bf16 build)
__global__ void __launch_bounds__(MAX_THREADS) fused_block_tiled_mma_kernel(Params p) {
  using bf16 = __nv_bfloat16;
  extern __shared__ float4 smem_mma[];
  char* base = reinterpret_cast<char*>(smem_mma);
  const int N = p.N, B = p.B, S = p.S, V = p.V, Sc = p.Sc, Vg = p.Vg;
  const int F = S + 3 * V, OF = Sc + 3 * Vg;
  const int nt = blockDim.x, tid = threadIdx.x;
  const int g = blockIdx.y, i0 = blockIdx.x * tiled::TDM;
  const int nd = min(tiled::TDM, N - i0);

  const bf16* x = (const bf16*)p.x + (long long)g * N * F;
  const tiled::Geometry geo{p.pos + (long long)g * N * 3, p.node_mask + (long long)g * N,
                            p.bond_src + (long long)g * B, p.bond_dst + (long long)g * B,
                            p.bond_mask + (long long)g * B, p.cutoff, N, B};
  const tiled::Layout l = tiled::layout(N, B, S, V, Sc, Vg, nt);
  Scratch s{};
  s.acc = (float*)(base + l.acc);
  s.deg = (float*)(base + l.deg);
  tiled::pair_loop(l, base, s, geo, p.w, x, S, V, i0, nd, tid, nt);

  mma::normalise(s, nd, tid, nt);
  __syncthreads();
  if (p.deg_out != nullptr && tid < nd) p.deg_out[(long long)g * N + i0 + tid] = s.deg[tid];
  float* out = p.out + ((long long)g * N + i0) * OF;
  const mma::EpilogueTiles e =
      mma::carve_epilogue_tiles(base + l.region, S, V, Sc + Vg, Vg, Sc, Vg, tiled::TDM, l.stage);
  mma::epilogue(s, e, p.w, GlobalRows<bf16>{x, F},
                [&](int td, int col, float v) { out[(long long)td * OF + col] = v; }, i0, nd, S,
                V, Sc, Vg, tid, nt);
}

// the kernel of a compute type, its dst atoms per CTA and its shared memory
template <typename T>
struct KernelOf {
  static constexpr auto fn = fused_block_tiled_kernel<T>;
  static constexpr int td = TD;
  static size_t smem(int N, int B, int S, int V, int Sc, int Vg, int nt) {
    return (scratch_words(N, B, nt, Sc, Vg, TD) + geometry_words(N)) * 4;
  }
};
template <>
struct KernelOf<__nv_bfloat16> {
  static constexpr auto fn = fused_block_tiled_mma_kernel;
  static constexpr int td = tiled::TDM;
  static size_t smem(int N, int B, int S, int V, int Sc, int Vg, int nt) {
    return tiled::layout(N, B, S, V, Sc, Vg, nt).total;
  }
};

template <typename T>
size_t smem_bytes(int N, int B, int S, int V, int Sc, int Vg) {
  return KernelOf<T>::smem(N, B, S, V, Sc, Vg, threads_for(2 * S + 3 * V));
}

template <typename T>
int launch(const Params& p, int G, void* stream) {
  const int nt = threads_for(2 * p.S + 3 * p.V);
  const size_t smem = smem_bytes<T>(p.N, p.B, p.S, p.V, p.Sc, p.Vg);
  if (nt > MAX_THREADS || p.N >= MAX_INDEX || p.B >= MAX_INDEX || G > 65535 || smem > MAX_SMEM)
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
int occupancy(int N, int B, int S, int V, int Sc, int Vg, int* out) {
  const int nt = threads_for(2 * S + 3 * V);
  const size_t smem = smem_bytes<T>(N, B, S, V, Sc, Vg);
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
  const tiled::Layout l = tiled::layout(N, B, S, V, Sc, Vg, nt);
  const int values[8] = {nt, (int)smem, attr.numRegs, (int)attr.localSizeBytes, ctas,
                         KernelOf<T>::td, mma ? l.J : N, mma ? (int)l.stage : 0};
  for (int k = 0; k < 8; ++k) out[k] = values[k];
  return 0;
}

}  // namespace

#define FUSED_BLOCK_TILED_ENTRY(NAME, TYPE)                                                    \
  extern "C" int NAME(const void* x, const void* pos, const void* node_mask,                   \
                      const void* bond_src, const void* bond_dst, const void* bond_mask,       \
                      const void* w1, const void* b1d, const void* b1b, const void* w2,        \
                      const void* b2, const void* pl0, const void* pl1, const void* lin20,     \
                      const void* lin21, const void* sk0, const void* sk1, void* out,          \
                      void* deg_out, float cutoff, int G, int N, int B, int S, int V, int Sc,  \
                      int Vg, void* stream) {                                                  \
    Params p{x,                                                                                \
             (const float*)pos,                                                                \
             (const uint8_t*)node_mask,                                                        \
             (const int64_t*)bond_src,                                                         \
             (const int64_t*)bond_dst,                                                         \
             (const uint8_t*)bond_mask,                                                        \
             Weights{w1, (const float*)b1d, (const float*)b1b, w2, (const float*)b2, pl0,      \
                     pl1, lin20, lin21, sk0, sk1},                                             \
             (float*)out,                                                                      \
             (float*)deg_out,                                                                  \
             cutoff,                                                                           \
             N,                                                                                \
             B,                                                                                \
             S,                                                                                \
             V,                                                                                \
             Sc,                                                                               \
             Vg};                                                                              \
    return launch<TYPE>(p, G, stream);                                                         \
  }

FUSED_BLOCK_TILED_ENTRY(fused_block_tiled_f32, float)
FUSED_BLOCK_TILED_ENTRY(fused_block_tiled_bf16, __nv_bfloat16)

// bytes of dynamic shared memory one CTA of the f32 (bf16 = 0) or bf16 build
// takes at these sizes
extern "C" int fused_block_tiled_smem(int bf16, int N, int B, int S, int V, int Sc, int Vg) {
  return (int)(bf16 ? smem_bytes<__nv_bfloat16>(N, B, S, V, Sc, Vg)
                    : smem_bytes<float>(N, B, S, V, Sc, Vg));
}

// How a build is launched at these sizes and what the card makes of it:
// out = {threads, bytes of shared memory per CTA, registers per thread,
// local (spill) bytes per thread, CTAs resident per SM, dst atoms per CTA,
// sources per pass of the pair list, 1 if the epilogue stages its B operands}
extern "C" int fused_block_tiled_occupancy(int bf16, int N, int B, int S, int V, int Sc, int Vg,
                                           int* out) {
  return bf16 ? occupancy<__nv_bfloat16>(N, B, S, V, Sc, Vg, out)
              : occupancy<float>(N, B, S, V, Sc, Vg, out);
}
