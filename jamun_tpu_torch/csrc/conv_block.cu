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
// Work per visited pair: the radial MLP, 2 * (NR * 64 + 64 * W) flops
// (W = 2S + 3V), about 50 kflop at the flagship width, against ~100 bytes of
// features read from L2; per node the epilogue, about 2 * 76 kflop. By the
// card's peaks the bf16 block is bound by its bytes (~0.011 ms at 4AA), the
// f32 one by its operations. What bounds the kernels on this card is
// neither: a CTA owns a few atoms and ~100-200 pairs, so each step is a
// short chain of dependent loads from L2 and shared memory at one to three
// CTAs per SM (clock64 stamps of the FMA build: the list and the weights'
// loads, layer 2 with the messages, and the epilogue, each about a third),
// and in the bf16 build below the message loop, about a third of the time,
// is bound by its instructions per (pair, channel).
//
// Two builds. f32 (conv_block_kernel<float>) keeps the FP32 FMA steps of
// conv_block_body.cuh: thread c owns radial output channel c with its 64
// layer-2 weights in registers, the messages of channel c accumulate in
// three registers. bf16 (conv_block_mma_kernel) runs the radial MLP and the
// epilogue's products on the tensor cores (mma.sync m16n8k16, bf16 -> f32,
// conv_block_mma.cuh) with the same rounding points, for 16 dst atoms per
// CTA (one full m-tile of the epilogue, the weights' loads shared by twice
// the atoms); against the latency it issues the weights' 16-byte loads
// first, lists the pairs with every warp at once, reads QB pairs' message
// inputs before summing them and stages the epilogue's B operands in shared
// memory with the whole CTA where that keeps the CTAs per SM. Nothing but
// the [G, N, Sc + 3Vg] output goes back to device memory.
//
// The block's steps after the staging of a pair tile live in
// conv_block_body.cuh (FMA) and conv_block_mma.cuh (tensor cores), shared
// with the whole-model kernel, e3_stack.cu, with their rounding points.
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
#include "conv_block_mma.cuh"

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

// destination atoms per CTA of the bf16 kernel: a full m-tile of the
// epilogue's products, and the weights' loads shared by twice the atoms of
// the FMA build's CTA
constexpr int TDM = 16;

// shared memory of the bf16 kernel: what lives through the whole CTA, then
// one region that the pair loop's tiles and, after it, the epilogue's share;
// the epilogue stages its B operands there too where that fits (`stage`)
struct MmaLayout {
  size_t acc, deg, ps4, counts, list, lsrc, pair, rows, epi, total;
  bool stage;
};

__host__ __device__ inline MmaLayout mma_layout(int N, int B, int S, int V, int Sc, int Vg,
                                                bool layer, int nt) {
  using namespace conv_block::mma;
  const int W = 2 * S + 3 * V, F = S + 3 * V, nl = TDM * N + B;
  MmaLayout l;
  l.acc = 0;
  l.deg = l.acc + align16((size_t)TDM * 3 * nt * 4);
  l.ps4 = l.deg + align16((size_t)TDM * 4);
  l.counts = l.ps4 + align16((size_t)PT * 16);
  l.list = l.counts + align16((size_t)TDM * 4);
  l.lsrc = l.list + align16((size_t)(nl + 1) * 4);
  l.pair = l.lsrc + align16((size_t)nl * 4);
  l.rows = l.pair + pair_tiles_bytes(W);
  const size_t pair_end = l.rows + align16((size_t)PT * F * 2);
  l.epi = l.pair;
  size_t total[2];
  for (int stage = 0; stage < 2; ++stage) {
    const size_t epi_end =
        l.epi + (layer ? epilogue_tiles_bytes(S, V, Sc, Vg, 0, 0, TDM, stage)
                       : epilogue_tiles_bytes(S, V, Sc + Vg, Vg, Sc, Vg, TDM, stage));
    total[stage] = pair_end > epi_end ? pair_end : epi_end;
  }
  l.stage = stage_fits(total[1], total[0]);
  l.total = total[l.stage];
  return l;
}

// The bf16 kernel: the same function on the tensor cores (conv_block_mma.cuh)
// for TDM destination atoms. The radial weights' loads are issued first and
// the warps list the pairs meanwhile, one dst atom each. Per tile: stage the
// pairs' geometry, radial values and source rows (x is read once per pair,
// 16 bytes at a time where the row allows), layer 1, then layer 2 and the
// messages warp by warp.
template <bool LAYER>
__global__ void __launch_bounds__(MAX_THREADS) conv_block_mma_kernel(Params p) {
  using bf16 = __nv_bfloat16;
  extern __shared__ float4 smem_mma[];
  char* base = reinterpret_cast<char*>(smem_mma);
  const int N = p.N, B = p.B, S = p.S, V = p.V, Sc = p.Sc, Vg = p.Vg;
  const int F = S + 3 * V, W = 2 * S + 3 * V, OF = Sc + 3 * Vg;
  const int nt = blockDim.x, tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int nwarps = nt >> 5;
  const int g = blockIdx.y, i0 = blockIdx.x * TDM;
  const int nd = min(TDM, N - i0);

  const bf16* x = (const bf16*)p.x + (long long)g * N * F;
  const bf16* ef = (const bf16*)p.ef + (long long)g * N * N * EC;
  const bf16* bf = (const bf16*)p.bf + (long long)g * B * EC;
  const int64_t* bsrc = p.bond_src + (long long)g * B;
  const int64_t* bdst = p.bond_dst + (long long)g * B;

  const MmaLayout l = mma_layout(N, B, S, V, Sc, Vg, LAYER, nt);
  Scratch s{};
  s.acc = (float*)(base + l.acc);
  s.deg = (float*)(base + l.deg);
  float4* ps4 = (float4*)(base + l.ps4);
  s.list = (int*)(base + l.list);
  s.n_list = s.list + TDM * N + B;
  int* lsrc = (int*)(base + l.lsrc);
  const mma::PairTiles t = mma::carve_pair_tiles(base + l.pair, W);
  bf16* xt = (bf16*)(base + l.rows);

  mma::load_pair_weights(t, p.w, W, tid, nt);
  for (int k = tid; k < TDM * 3 * nt; k += nt) s.acc[k] = 0.0f;

  // the warps list the pairs inside the cutoff and the bonds, dst-major,
  // with each entry's source atom: one dst atom per warp, a pass that counts,
  // then a pass that writes at the sum of the earlier atoms' counts
  const unsigned lt = (1u << lane) - 1u;
  int* counts = (int*)(base + l.counts);
  auto list_atom = [&](int td, int at) {  // at < 0: count only
    const int i = i0 + td;
    int count = 0;
    for (int j0 = 0; j0 < N; j0 += 32) {
      const int j = j0 + lane;
      const bool a = j < N && ld(ef + ((long long)i * N + j) * EC + 3) > 0.5f;
      const unsigned m = __ballot_sync(0xffffffffu, a);
      if (a && at >= 0) {
        s.list[at + count + __popc(m & lt)] = encode(td, 0, j);
        lsrc[at + count + __popc(m & lt)] = j;
      }
      count += __popc(m);
    }
    for (int b0 = 0; b0 < B; b0 += 32) {
      const int b = b0 + lane;
      const bool a = b < B && bdst[b] == i && ld(bf + (long long)b * EC + 3) > 0.5f;
      const unsigned m = __ballot_sync(0xffffffffu, a);
      if (a && at >= 0) {
        s.list[at + count + __popc(m & lt)] = encode(td, 1, b);
        lsrc[at + count + __popc(m & lt)] = (int)bsrc[b];
      }
      count += __popc(m);
    }
    return count;
  };
  for (int td = warp; td < nd; td += nwarps) {
    const int count = list_atom(td, -1);
    if (lane == 0) {
      s.deg[td] = (float)count;
      counts[td] = count;
    }
  }
  __syncthreads();
  for (int td = warp; td < nd; td += nwarps) {
    int at = 0;
    for (int u = 0; u < td; ++u) at += counts[u];
    list_atom(td, at);
  }
  if (tid == 0) {
    int total = 0;
    for (int u = 0; u < nd; ++u) total += counts[u];
    *s.n_list = total;
  }
  __syncthreads();
  const int nl = *s.n_list;

  auto row = [&](int e) {
    return entry_is_bond(e) ? bf + (long long)entry_index(e) * EC
                            : ef + ((long long)(i0 + entry_slot(e)) * N + entry_index(e)) * EC;
  };
  constexpr int L1 = mma::ld_of(NR);
  const mma::TileRows xq{xt, F};
  // vector loads where the rows allow them (8-byte radial values, 16-byte source rows)
  const bool ef8 = (((uintptr_t)p.ef | (uintptr_t)p.bf) & 7) == 0;
  const bool x16 = (F & 7) == 0 && ((uintptr_t)p.x & 15) == 0;
  ChannelSum st;
  for (int t0 = 0; t0 < nl; t0 += PT) {
    const int np = min(PT, nl - t0);
    // stage the tile: dst slot and SH per pair, its 32 radial values (8
    // bytes at a time), and its source row
    if (tid < PT) {
      int td = 0;
      float s0 = 0.0f, s1 = 0.0f, s2 = 0.0f;
      if (tid < np) {
        const int e = s.list[t0 + tid];
        td = entry_slot(e);
        const bf16* fp = row(e);
        s0 = ld(fp + 0);
        s1 = ld(fp + 1);
        s2 = ld(fp + 2);
      }
      ps4[tid] = mma::pair_info(s0, s1, s2, td, 0);
    }
    for (int o = tid; o < PT * (NR / 4); o += nt) {
      const int q = o / (NR / 4), part = o % (NR / 4);
      uint2 v = make_uint2(0u, 0u);
      if (q < np) {
        const bf16* fp = row(s.list[t0 + q]) + 4 + 4 * part;
        if (ef8) {
          v = __ldg(reinterpret_cast<const uint2*>(fp));
        } else {
          v.x = mma::pack2(fp[0], fp[1]);
          v.y = mma::pack2(fp[2], fp[3]);
        }
      }
      *reinterpret_cast<uint2*>(t.rs + q * L1 + 4 * part) = v;
    }
    if (x16) {
      const int chunks = F / 8;
      for (int o = tid; o < np * chunks; o += nt) {
        const int q = o / chunks, part = o % chunks;
        reinterpret_cast<uint4*>(xt + q * F)[part] =
            __ldg(reinterpret_cast<const uint4*>(x + (long long)lsrc[t0 + q] * F) + part);
      }
    } else {
      for (int o = tid; o < np * F; o += nt) {
        const int q = o / F, ch = o % F;
        xt[o] = x[(long long)lsrc[t0 + q] * F + ch];
      }
    }
    __syncthreads();
    mma::radial_layer1(t, p.w, s.list + t0, np, warp, nwarps, lane);
    __syncthreads();
    mma::layer2_messages(s, ps4, t, xq, p.w.b2, W, np, S, V, warp, lane, nt, st);
    __syncthreads();
  }
  flush(s, st, tid, tid < W, nt);
  __syncthreads();

  mma::normalise(s, nd, tid, nt);
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
    const mma::EpilogueTiles e =
        mma::carve_epilogue_tiles(base + l.epi, S, V, Sc, Vg, 0, 0, TDM, l.stage);
    mma::post_linear(s, e, p.w, nd, S, V, Sc, Vg, tid, nt);
    __syncthreads();
    for (int o = tid; o < nd * Sc; o += nt) {
      const int td = o / Sc, q = o % Sc;
      out[(long long)td * OF + p.out_col[q]] = e.conv0[td * Sc + q];
    }
    for (int o = tid; o < nd * 3 * Vg; o += nt) {
      const int td = o / (3 * Vg), comp = (o / Vg) % 3, q = o % Vg;
      out[(long long)td * OF + p.out_col[Sc + q] + comp] = e.conv1[(td * 3 + comp) * Vg + q];
    }
  } else {
    const mma::EpilogueTiles e =
        mma::carve_epilogue_tiles(base + l.epi, S, V, Sc + Vg, Vg, Sc, Vg, TDM, l.stage);
    mma::epilogue(s, e, p.w, GlobalRows<bf16>{x, F},
                  [&](int td, int col, float v) { out[(long long)td * OF + col] = v; }, i0, nd, S,
                  V, Sc, Vg, tid, nt);
  }
}

// the kernel of a compute type and mode, and its shared memory
template <typename T, bool LAYER>
struct KernelOf {
  static constexpr auto fn = conv_block_kernel<T, LAYER>;
  static constexpr int td = TD;
  static size_t smem(const Params& p, int nt) {
    return scratch_words(p.N, p.B, nt, p.Sc, p.Vg, TD) * 4;
  }
};
template <bool LAYER>
struct KernelOf<__nv_bfloat16, LAYER> {
  static constexpr auto fn = conv_block_mma_kernel<LAYER>;
  static constexpr int td = TDM;
  static size_t smem(const Params& p, int nt) {
    return mma_layout(p.N, p.B, p.S, p.V, p.Sc, p.Vg, LAYER, nt).total;
  }
};

template <typename T, bool LAYER>
int launch(const Params& p, int G, void* stream) {
  const int W = 2 * p.S + 3 * p.V;
  const int nt = threads_for(W);
  if (nt > MAX_THREADS || p.N >= MAX_INDEX || p.B >= MAX_INDEX) return (int)cudaErrorInvalidValue;
  if (G == 0 || p.N == 0) return 0;
  const size_t smem = KernelOf<T, LAYER>::smem(p, nt);
  cudaError_t err = cudaFuncSetAttribute(KernelOf<T, LAYER>::fn,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((p.N + KernelOf<T, LAYER>::td - 1) / KernelOf<T, LAYER>::td, G);
  const auto kernel = KernelOf<T, LAYER>::fn;
  kernel<<<grid, nt, smem, (cudaStream_t)stream>>>(p);
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

namespace {

template <typename T, bool LAYER>
int occupancy(int N, int B, int S, int V, int Sc, int Vg, int* out) {
  const int nt = threads_for(2 * S + 3 * V);
  Params p{};
  p.N = N;
  p.B = B;
  p.S = S;
  p.V = V;
  p.Sc = Sc;
  p.Vg = Vg;
  const size_t smem = KernelOf<T, LAYER>::smem(p, nt);
  cudaError_t err = cudaFuncSetAttribute(KernelOf<T, LAYER>::fn,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  cudaFuncAttributes attr;
  err = cudaFuncGetAttributes(&attr, KernelOf<T, LAYER>::fn);
  if (err != cudaSuccess) return (int)err;
  int ctas = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&ctas, KernelOf<T, LAYER>::fn, nt, smem);
  if (err != cudaSuccess) return (int)err;
  out[0] = nt;
  out[1] = (int)smem;
  out[2] = attr.numRegs;
  out[3] = (int)attr.localSizeBytes;
  out[4] = ctas;
  return 0;
}

}  // namespace

// How the kernel is launched at these sizes and what the card makes of it:
// out = {threads, bytes of shared memory per CTA, registers per thread,
// local (spill) bytes per thread, CTAs resident per SM}.
extern "C" int conv_block_occupancy(int bf16, int layer, int N, int B, int S, int V, int Sc,
                                    int Vg, int* out) {
  if (bf16)
    return layer ? occupancy<__nv_bfloat16, true>(N, B, S, V, Sc, Vg, out)
                 : occupancy<__nv_bfloat16, false>(N, B, S, V, Sc, Vg, out);
  return layer ? occupancy<float, true>(N, B, S, V, Sc, Vg, out)
               : occupancy<float, false>(N, B, S, V, Sc, Vg, out);
}
