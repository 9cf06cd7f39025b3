// Backward of one whole separable ConvBlock of the dense E3Conv (l <= 1,
// uvu): given the cotangent g of K2's output (csrc/conv_block.cu), the
// gradient of the block input x and the weight gradients, summed over graphs.
//
// Replaces the TPU kernel `_block_bwd_kernel` of
// jamun_tpu/ops/pallas/packed_conv.py (pallas_call at line 2220, entry
// `packed_conv_block_bwd`), the VJP of `make_trainable_conv_block`. The TPU
// kernel walks K graphs per program over all N*N pairs as lane-packed
// panels, scatters and gathers with one-hot matmuls, and carries the weight
// gradients from one grid step to the next. Here four kernels (five in the
// bf16 build) run in one stream, and nothing is summed with atomics:
//   (a) node pass, one block per 8 destination atoms: from K2's saved
//       aggregates and degree (its residuals) it recomputes the post-linear
//       and the gate, runs the epilogue backward (second linear, skip, gate,
//       post-linear), writes d_pre [G, N, 3, W] (the cotangent of each
//       atom's pre-normalisation aggregate), the skip part of dx, and one
//       row per atom of the operands of the epilogue's weight gradients;
//   (b) row products: each epilogue weight gradient is sum_n A[n]^T B[n]
//       over those rows, one block per 32 x 32 tile, in a fixed order;
//   (c) pair pass, one block per 8 SOURCE atoms: the dense adjacency is
//       symmetric, so the block lists the pairs (dst i, src j) of its own
//       sources, and the bonds whose source is its own, recomputes each
//       pair's radial MLP (h32, h, w_all), reads d_pre at the pair's
//       destination and forms d_w_all and the source cotangent. It sums dx
//       of its own sources in shared memory (no atomics) and keeps block
//       partials of dW2, db2, dW1, db1d, db1b;
//   (d) a fixed-order sum of the block partials.
//
// Bound on the H100: operations. Per visited pair the pass recomputes the
// radial MLP (2 * (NR * 64 + 64 * W) flops) and adds dW2, dh and dW1
// (2 * (2 * 64 * W + NR * 64)), about 4x K2's per-pair work. Two builds.
// The f32 build runs everything as FP32 FMAs for 8 atoms (node pass) and 8
// sources (pair pass) per block: thread c owns radial channel c, keeps its
// 64 dW2 partial sums in registers, and reads W2 from a shared transposed
// copy padded to 65 columns; the row products stage 32 rows at a time per
// 32 x 32 output tile. The bf16 build puts every product on the tensor cores
// (mma.sync m16n8k16 bf16 -> f32, conv_block_mma.cuh's fragments), since all
// their operands are values rounded to bf16 already: the node pass for 16
// atoms per block (node_mma_kernel), the row products split over chunks of
// rows with a fixed-order sum of the chunks (atb_mma_kernel,
// atb_reduce_kernel), and the pair pass for 16 sources per block, so the
// training shape (G = 32, N = 48) runs in one wave (pair_mma_kernel). Its
// latency, not its flops, bounds it: a block holds a few tiles of pairs,
// each a chain of steps behind barriers (scripts/torch_phase_split.py splits
// it), and d_w_all and the source cotangents stay on the CUDA cores.
//
// Rounding points follow `_block_bwd_kernel` without its o2 fold (K2's
// forward does not fold either): g, d_scal, d_conv0, d_conv1, d_in0/d_in1,
// d_pre, rnd(t2_cot), d_w_all, d_h32 and each pair's source cotangent are
// rounded to the compute type T; products and sums are f32.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "conv_block_mma.cuh"

namespace {

namespace cm = conv_block::mma;

constexpr int NR = 32;   // radial basis functions
constexpr int H = 64;    // radial MLP hidden width
constexpr int EC = 4 + NR;
constexpr int TD = 8;    // destination atoms per block of the node pass
constexpr int TS = 8;    // source atoms per block of the pair pass
constexpr int PT = 16;   // pairs per tile of the pair pass
constexpr int MAX_THREADS = 384;
constexpr int W2S = H + 1;  // row stride of the shared transposed W2
constexpr int PART = (NR + 2) * H;  // [dW1; db1d; db1b] of a block partial
constexpr int ATB_THREADS = 256;
constexpr size_t MAX_SMEM = 232448;  // bytes of shared memory a block may use

__device__ __forceinline__ float ld(const float* p) { return __ldg(p); }
__device__ __forceinline__ float ld(const __nv_bfloat16* p) { return __bfloat162float(*p); }

template <typename T>
__device__ __forceinline__ float rnd(float v);
template <>
__device__ __forceinline__ float rnd<float>(float v) { return v; }
template <>
__device__ __forceinline__ float rnd<__nv_bfloat16>(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

__device__ __forceinline__ float sigmoidf(float v) { return 1.0f / (1.0f + expf(-v)); }

struct Params {
  const float* g;           // [G, N, Sc + 3Vg] f32 cotangent (vector block [Vg][3])
  const void* x;            // [G, N, F] T, F = S + 3V (vector block [V][3])
  const void* ef;           // [G, N, N, EC] T
  const void* bf;           // [G, B, EC] T
  const int64_t* bond_src;  // [G, B]
  const int64_t* bond_dst;  // [G, B]
  const float* agg;         // [G, N, 3, W] f32: K2's normalised aggregates
  const float* deg;         // [G, N] f32
  const void* w1;           // [NR, H] T
  const float* b1d;         // [H]
  const float* b1b;         // [H]
  const void* w2;           // [H, W] T
  const float* b2;          // [W]
  const void* pl0;          // [S + V, Sc + Vg] T
  const void* pl1;          // [S + 2V, Vg] T
  const void* lin20;        // [Sc, Sc] T
  const void* lin21;        // [Vg, Vg] T
  const void* sk0;          // [S, Sc] T
  const void* sk1;          // [V, Vg] T
  float* d_pre;             // scratch [G, N, 3, W]
  float* rows;              // scratch [G * N, R] (RowLayout)
  float* part;              // scratch [blocks of the pair pass, PART + H * W + W]
  float* dx;                // [G, N, F]
  float *dw1, *db1d, *db1b, *dw2, *db2, *dpl0, *dpl1, *dlin20, *dlin21, *dsk0, *dsk1;
  int G, N, B, S, V, Sc, Vg;
};

// one row per atom: the operands of the epilogue's weight gradients
// (vectors component-major, [3][C])
struct RowLayout {
  int in0, dconv0, in1, dconv1, scal, g0, gated, g1, xs, xv, R;
};

__host__ __device__ inline RowLayout row_layout(int S, int V, int Sc, int Vg) {
  RowLayout L;
  L.in0 = 0;
  L.dconv0 = L.in0 + S + V;
  L.in1 = L.dconv0 + Sc + Vg;
  L.dconv1 = L.in1 + 3 * (S + 2 * V);
  L.scal = L.dconv1 + 3 * Vg;
  L.g0 = L.scal + Sc;
  L.gated = L.g0 + Sc;
  L.g1 = L.gated + 3 * Vg;
  L.xs = L.g1 + 3 * Vg;
  L.xv = L.xs + S;
  L.R = L.xv + 3 * V;
  return L;
}

// ---------------------------------------------------------------- (a) node pass
template <typename T>
__global__ void __launch_bounds__(MAX_THREADS) node_kernel(Params p) {
  extern __shared__ float smem[];
  const int N = p.N, S = p.S, V = p.V, Sc = p.Sc, Vg = p.Vg;
  const int F = S + 3 * V, W = 2 * S + 3 * V, C0 = Sc + Vg, OF = Sc + 3 * Vg;
  const RowLayout L = row_layout(S, V, Sc, Vg);
  const int nt = blockDim.x, tid = threadIdx.x;
  const int g = blockIdx.y, i0 = blockIdx.x * TD;
  const int nd = min(TD, N - i0);
  const long long node0 = (long long)g * N + i0;

  float* conv0 = smem;                  // [TD][C0]
  float* conv1 = conv0 + TD * C0;       // [TD][3][Vg]
  float* dscal = conv1 + TD * 3 * Vg;   // [TD][Sc]
  float* dgated = dscal + TD * Sc;      // [TD][3][Vg]
  float* dconv0 = dgated + TD * 3 * Vg; // [TD][C0]
  float* dconv1 = dconv0 + TD * C0;     // [TD][3][Vg]

  const T* x = (const T*)p.x;
  const T* pl0 = (const T*)p.pl0;
  const T* pl1 = (const T*)p.pl1;
  const T* lin20 = (const T*)p.lin20;
  const T* lin21 = (const T*)p.lin21;
  const T* sk0 = (const T*)p.sk0;
  const T* sk1 = (const T*)p.sk1;
  auto row = [&](int td) { return p.rows + (node0 + td) * L.R; };
  auto aggv = [&](int td, int comp, int ch) {
    return p.agg[((node0 + td) * 3 + comp) * W + ch];
  };

  // 1. the rows' inputs: aggregates split as the post-linear reads them,
  //    the rounded cotangent, the block input; d_pre's empty components
  for (int o = tid; o < nd * (S + V); o += nt) {
    int td = o / (S + V), k = o % (S + V);
    row(td)[L.in0 + k] = k < S ? aggv(td, 0, k) : aggv(td, 0, 2 * S + V + (k - S));
  }
  for (int o = tid; o < nd * 3 * (S + 2 * V); o += nt) {
    int td = o / (3 * (S + 2 * V)), c = (o / (S + 2 * V)) % 3, k = o % (S + 2 * V);
    int ch = k < S ? S + k : (k < S + V ? 2 * S + (k - S) : 2 * S + 2 * V + (k - S - V));
    row(td)[L.in1 + c * (S + 2 * V) + k] = aggv(td, c, ch);
  }
  for (int o = tid; o < nd * OF; o += nt) {
    int td = o / OF, q = o % OF;
    float v = rnd<T>(p.g[(node0 + td) * OF + q]);
    if (q < Sc) {
      row(td)[L.g0 + q] = v;
    } else {
      int t = q - Sc;  // [Vg][3] -> [3][Vg]
      row(td)[L.g1 + (t % 3) * Vg + t / 3] = v;
    }
  }
  for (int o = tid; o < nd * F; o += nt) {
    int td = o / F, f = o % F;
    float v = ld(x + (node0 + td) * F + f);
    if (f < S) {
      row(td)[L.xs + f] = v;
    } else {
      int t = f - S;
      row(td)[L.xv + (t % 3) * V + t / 3] = v;
    }
  }
  for (int o = tid; o < nd * 2 * (S + V); o += nt) {  // components 1, 2 of o1 and o4
    int td = o / (2 * (S + V)), c = 1 + (o / (S + V)) % 2, k = o % (S + V);
    int ch = k < S ? k : 2 * S + V + (k - S);
    p.d_pre[((node0 + td) * 3 + c) * W + ch] = 0.0f;
  }
  __syncthreads();

  // 2. forward recompute of the post-linear; the backward of the second
  //    linear and of the skip (whose dx part goes straight to dx)
  for (int o = tid; o < nd * C0; o += nt) {
    int td = o / C0, q = o % C0;
    const float* r = row(td) + L.in0;
    float s = 0.0f;
    for (int k = 0; k < S + V; ++k) s += r[k] * ld(pl0 + (long long)k * C0 + q);
    conv0[o] = s;
  }
  for (int o = tid; o < nd * 3 * Vg; o += nt) {
    int td = o / (3 * Vg), c = (o / Vg) % 3, q = o % Vg;
    const float* r = row(td) + L.in1 + c * (S + 2 * V);
    float s = 0.0f;
    for (int k = 0; k < S + 2 * V; ++k) s += r[k] * ld(pl1 + (long long)k * Vg + q);
    conv1[o] = s;
    const float* g1 = row(td) + L.g1 + c * Vg;
    float d = 0.0f;
    for (int k = 0; k < Vg; ++k) d += g1[k] * ld(lin21 + (long long)q * Vg + k);
    dgated[o] = d;
  }
  for (int o = tid; o < nd * Sc; o += nt) {
    int td = o / Sc, k = o % Sc;
    const float* g0 = row(td) + L.g0;
    float d = 0.0f;
    for (int q = 0; q < Sc; ++q) d += g0[q] * ld(lin20 + (long long)k * Sc + q);
    dscal[o] = rnd<T>(d);
  }
  for (int o = tid; o < nd * F; o += nt) {
    int td = o / F, f = o % F;
    float d = 0.0f;
    if (f < S) {
      const float* g0 = row(td) + L.g0;
      for (int q = 0; q < Sc; ++q) d += g0[q] * ld(sk0 + (long long)f * Sc + q);
    } else {
      int v = (f - S) / 3, c = (f - S) % 3;
      const float* g1 = row(td) + L.g1 + c * Vg;
      for (int q = 0; q < Vg; ++q) d += g1[q] * ld(sk1 + (long long)v * Vg + q);
    }
    p.dx[(node0 + td) * F + f] = d;
  }
  __syncthreads();

  // 3. gate forward and backward
  for (int o = tid; o < nd * Sc; o += nt) {
    int td = o / Sc, k = o % Sc;
    float pre = conv0[td * C0 + k];
    row(td)[L.scal + k] = rnd<T>(pre >= 0.0f ? pre : 0.01f * pre);
    float d = rnd<T>(dscal[o] * (pre >= 0.0f ? 1.0f : 0.01f));
    dconv0[td * C0 + k] = d;
    row(td)[L.dconv0 + k] = d;
  }
  for (int o = tid; o < nd * Vg; o += nt) {
    int td = o / Vg, q = o % Vg;
    float gate = sigmoidf(conv0[td * C0 + Sc + q]);
    float dgates = 0.0f;
    for (int c = 0; c < 3; ++c) {
      int e = (td * 3 + c) * Vg + q;
      dgates += dgated[e] * conv1[e];
      row(td)[L.gated + c * Vg + q] = rnd<T>(conv1[e] * gate);
      float d1 = rnd<T>(dgated[e] * gate);
      dconv1[e] = d1;
      row(td)[L.dconv1 + c * Vg + q] = d1;
    }
    float d0 = rnd<T>(dgates * (gate * (1.0f - gate)));
    dconv0[td * C0 + Sc + q] = d0;
    row(td)[L.dconv0 + Sc + q] = d0;
  }
  __syncthreads();

  // 4. post-linear backward -> d_pre = rnd(rnd(d_in) / max(deg, 1))
  for (int o = tid; o < nd * (S + V); o += nt) {
    int td = o / (S + V), k = o % (S + V);
    float s = 0.0f;
    for (int q = 0; q < C0; ++q) s += dconv0[td * C0 + q] * ld(pl0 + (long long)k * C0 + q);
    float inv = 1.0f / fmaxf(p.deg[node0 + td], 1.0f);
    int ch = k < S ? k : 2 * S + V + (k - S);
    p.d_pre[((node0 + td) * 3) * W + ch] = rnd<T>(rnd<T>(s) * inv);
  }
  for (int o = tid; o < nd * 3 * (S + 2 * V); o += nt) {
    int td = o / (3 * (S + 2 * V)), c = (o / (S + 2 * V)) % 3, k = o % (S + 2 * V);
    float s = 0.0f;
    for (int q = 0; q < Vg; ++q)
      s += dconv1[(td * 3 + c) * Vg + q] * ld(pl1 + (long long)k * Vg + q);
    float inv = 1.0f / fmaxf(p.deg[node0 + td], 1.0f);
    int ch = k < S ? S + k : (k < S + V ? 2 * S + (k - S) : 2 * S + 2 * V + (k - S - V));
    p.d_pre[((node0 + td) * 3 + c) * W + ch] = rnd<T>(rnd<T>(s) * inv);
  }
}

// ---------------------------------------------------------- (b) row products
// out[k, q] = sum over rows n and components c of A[n, c, k] * B[n, c, q]:
// one block per 32 x 32 output tile, 32 (row, component) pairs staged in
// shared memory per step, summed in row order (deterministic).
constexpr int AT = 32;  // output tile edge
constexpr int AR = 32;  // rows staged per step

struct AtbJob {
  float* out;  // [K, Q]
  int a, b;    // row offsets of the [ncomp][K] and [ncomp][Q] operands
  int K, Q, ncomp, tiles;
};
constexpr int MAX_JOBS = 6;
struct AtbJobs {
  AtbJob job[MAX_JOBS];
  int n;
};

__global__ void __launch_bounds__(ATB_THREADS) atb_kernel(AtbJobs jobs, const float* rows, int R,
                                                          int M) {
  __shared__ float As[AR][AT + 1];
  __shared__ float Bs[AR][AT + 1];
  int t = blockIdx.x, j = 0;
  while (j < jobs.n && t >= jobs.job[j].tiles) t -= jobs.job[j++].tiles;
  if (j == jobs.n) return;
  const AtbJob J = jobs.job[j];
  const int tk = (J.K + AT - 1) / AT;
  const int k0 = (t % tk) * AT, q0 = (t / tk) * AT;
  const int tx = threadIdx.x % AT, ty = threadIdx.x / AT;  // 32 x 8 threads, 4 outputs each
  float acc[4] = {0.0f, 0.0f, 0.0f, 0.0f};
  const long long total = (long long)M * J.ncomp;
  for (long long r0 = 0; r0 < total; r0 += AR) {
    for (int e = threadIdx.x; e < AR * AT; e += blockDim.x) {
      const int rr = e / AT, cc = e % AT;
      const long long r = r0 + rr;
      float a = 0.0f, b = 0.0f;
      if (r < total) {
        const int n = (int)(r / J.ncomp), c = (int)(r % J.ncomp);
        const float* row = rows + (long long)n * R;
        if (k0 + cc < J.K) a = row[J.a + c * J.K + k0 + cc];
        if (q0 + cc < J.Q) b = row[J.b + c * J.Q + q0 + cc];
      }
      As[rr][cc] = a;
      Bs[rr][cc] = b;
    }
    __syncthreads();
#pragma unroll 8
    for (int rr = 0; rr < AR; ++rr) {
      const float b = Bs[rr][tx];
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[i] += As[rr][ty + 8 * i] * b;
    }
    __syncthreads();
  }
  for (int i = 0; i < 4; ++i) {
    const int k = k0 + ty + 8 * i, q = q0 + tx;
    if (k < J.K && q < J.Q) J.out[(long long)k * J.Q + q] = acc[i];
  }
}

// -------------------------------------------------------------- (c) pair pass
__device__ __forceinline__ int encode(int ts, int bond, int idx) {
  return (ts << 20) | (bond << 19) | idx;
}

template <typename T>
__global__ void __launch_bounds__(MAX_THREADS, 1) pair_kernel(Params p) {
  extern __shared__ float smem[];
  const int N = p.N, B = p.B, S = p.S, V = p.V;
  const int F = S + 3 * V, W = 2 * S + 3 * V, CS = 2 * S + 9 * V;
  const float kInvSqrt3 = 0.57735026918962576f, kInvSqrt2 = 0.70710678118654752f;
  const int nt = blockDim.x, tid = threadIdx.x;
  const int g = blockIdx.y, j0 = blockIdx.x * TS;
  const int ns = min(TS, N - j0);

  const T* x = (const T*)p.x + (long long)g * N * F;
  const T* ef = (const T*)p.ef + (long long)g * N * N * EC;
  const T* bf = (const T*)p.bf + (long long)g * B * EC;
  const int64_t* bsrc = p.bond_src + (long long)g * B;
  const int64_t* bdst = p.bond_dst + (long long)g * B;
  const float* d_pre = p.d_pre + (long long)g * N * 3 * W;

  float* hs = smem;                 // [H][PT] h, rounded (16-byte aligned)
  float* h32s = hs + H * PT;        // [H][PT] h32, then d_h32
  float* w1s = h32s + H * PT;       // [NR][H]
  float* w2t = w1s + NR * H;        // [W][W2S] W2 transposed
  float* rs = w2t + W * W2S;        // [PT][NR] radial features
  float* dws = rs + PT * NR;        // [PT][W] d_w_all
  float* cs = dws + PT * W;         // [PT][CS] source-cotangent contributions
  float* xsrc = cs + PT * CS;       // [TS][F] the block's source features
  float* dxs = xsrc + TS * F;       // [TS][F] their dx sums
  float* dw1s = dxs + TS * F;       // [NR + 2][H] dW1, db1d, db1b partials
  float* ps_sh = dw1s + PART;       // [PT][3]
  int* ps_dst = (int*)(ps_sh + PT * 3);  // [PT]
  int* ps_ts = ps_dst + PT;         // [PT]
  int* ps_bond = ps_ts + PT;        // [PT]
  int* list = ps_bond + PT;         // [TS * N + B]
  int* n_list = list + TS * N + B;  // [1]

  for (int k = tid; k < NR * H; k += nt) w1s[k] = ld((const T*)p.w1 + k);
  for (int k = tid; k < H * W; k += nt) {
    int r = k / W, c = k % W;
    w2t[c * W2S + r] = ld((const T*)p.w2 + k);
  }
  for (int k = tid; k < TS * F; k += nt) {
    int ts = k / F;
    xsrc[k] = ts < ns ? ld(x + (long long)(j0 + ts) * F + k % F) : 0.0f;
    dxs[k] = 0.0f;
  }
  for (int k = tid; k < PART; k += nt) dw1s[k] = 0.0f;

  const int c = tid;
  const bool has_c = c < W;
  const float b2c = has_c ? p.b2[c] : 0.0f;
  float dw2acc[H];
#pragma unroll
  for (int k = 0; k < H; ++k) dw2acc[k] = 0.0f;
  float db2acc = 0.0f;

  // warp 0 lists the pairs of the block's sources: (dst i, src j) inside the
  // cutoff, then the bonds leaving j
  if (tid < 32) {
    const int lane = tid;
    const unsigned lt = (1u << lane) - 1u;
    int count = 0;
    for (int ts = 0; ts < ns; ++ts) {
      const int j = j0 + ts;
      for (int b0 = 0; b0 < N; b0 += 32) {
        int i = b0 + lane;
        bool a = i < N && ld(ef + ((long long)i * N + j) * EC + 3) > 0.5f;
        unsigned m = __ballot_sync(0xffffffffu, a);
        if (a) list[count + __popc(m & lt)] = encode(ts, 0, i);
        count += __popc(m);
      }
      for (int b0 = 0; b0 < B; b0 += 32) {
        int b = b0 + lane;
        bool a = b < B && bsrc[b] == j && ld(bf + (long long)b * EC + 3) > 0.5f;
        unsigned m = __ballot_sync(0xffffffffu, a);
        if (a) list[count + __popc(m & lt)] = encode(ts, 1, b);
        count += __popc(m);
      }
    }
    if (lane == 0) *n_list = count;
  }
  __syncthreads();
  const int nl = *n_list;

  auto feat = [&](int e) -> const T* {
    const int idx = e & ((1 << 19) - 1), ts = e >> 20;
    if (e & (1 << 19)) return bf + (long long)idx * EC;
    return ef + ((long long)idx * N + j0 + ts) * EC;
  };

  for (int t0 = 0; t0 < nl; t0 += PT) {
    const int np = min(PT, nl - t0);
    // stage the tile: destination, source slot, SH, radial features
    if (tid < PT) {
      int dst = 0, ts = 0, bond = 0;
      float s0 = 0.0f, s1 = 0.0f, s2 = 0.0f;
      if (tid < np) {
        const int e = list[t0 + tid];
        ts = e >> 20;
        bond = (e >> 19) & 1;
        const int idx = e & ((1 << 19) - 1);
        dst = bond ? (int)bdst[idx] : idx;
        const T* fp = feat(e);
        s0 = ld(fp + 0);
        s1 = ld(fp + 1);
        s2 = ld(fp + 2);
      }
      ps_dst[tid] = dst;
      ps_ts[tid] = ts;
      ps_bond[tid] = bond;
      ps_sh[tid * 3 + 0] = s0;
      ps_sh[tid * 3 + 1] = s1;
      ps_sh[tid * 3 + 2] = s2;
    }
    for (int o = tid; o < PT * NR; o += nt) {
      int q = o / NR, k = o % NR;
      rs[o] = q < np ? ld(feat(list[t0 + q]) + 4 + k) : 0.0f;
    }
    __syncthreads();
    // radial layer 1 recomputed: h32 and h = rnd(silu(h32))
    for (int o = tid; o < PT * H; o += nt) {
      int q = o / H, m = o % H;
      float h32 = 0.0f, h = 0.0f;
      if (q < np) {
        float s = 0.0f;
#pragma unroll 8
        for (int k = 0; k < NR; ++k) s += rs[q * NR + k] * w1s[k * H + m];
        h32 = (ps_bond[q] ? p.b1b[m] : p.b1d[m]) + s;
        h = rnd<T>(h32 * sigmoidf(h32));
      }
      h32s[m * PT + q] = h32;
      hs[m * PT + q] = h;
    }
    __syncthreads();
    // channel c: w_all recomputed, d_w_all, this channel's share of the
    // source cotangent, and the dW2 / db2 sums
    if (has_c) {
      for (int q0 = 0; q0 < np; q0 += 4) {
        float wq[4] = {b2c, b2c, b2c, b2c};
#pragma unroll 8
        for (int k = 0; k < H; ++k) {
          const float wv = w2t[c * W2S + k];
          const float4 hv = *reinterpret_cast<const float4*>(hs + k * PT + q0);
          wq[0] += wv * hv.x;
          wq[1] += wv * hv.y;
          wq[2] += wv * hv.z;
          wq[3] += wv * hv.w;
        }
        float dq[4] = {0.0f, 0.0f, 0.0f, 0.0f};
        const int qn = min(4, np - q0);
        for (int u = 0; u < qn; ++u) {
          const int q = q0 + u;
          const float w = rnd<T>(wq[u]);
          const float* dp = d_pre + (long long)ps_dst[q] * 3 * W;
          const float* xj = xsrc + ps_ts[q] * F;
          const float shy = ps_sh[q * 3 + 0], shz = ps_sh[q * 3 + 1], shx = ps_sh[q * 3 + 2];
          float* cq = cs + q * CS;
          float dw;
          if (c < S) {
            const float d = dp[c];
            dw = d * xj[c];
            cq[c] = d * w;
          } else if (c < 2 * S) {
            const int s = c - S;
            float t2c = dp[c] * shy;
            t2c += dp[W + c] * shz;
            t2c += dp[2 * W + c] * shx;
            dw = t2c * xj[s];
            cq[S + s] = rnd<T>(t2c) * w;
          } else {
            const int v = (c - 2 * S) % V, path = (c - 2 * S) / V;
            const float vy = xj[S + 3 * v], vz = xj[S + 3 * v + 1], vx = xj[S + 3 * v + 2];
            const float d0 = dp[c], d1 = dp[W + c], d2 = dp[2 * W + c];
            float* cv = cq + 2 * S + (path * V + v) * 3;
            if (path == 0) {
              dw = d0 * vy + d1 * vz + d2 * vx;
              cv[0] = d0 * w;
              cv[1] = d1 * w;
              cv[2] = d2 * w;
            } else if (path == 1) {
              dw = d0 * (vy * shy + vz * shz + vx * shx) * kInvSqrt3;
              cv[0] = d0 * w * shy * kInvSqrt3;
              cv[1] = d0 * w * shz * kInvSqrt3;
              cv[2] = d0 * w * shx * kInvSqrt3;
            } else {
              const float cy = vz * shx - vx * shz, cz = vx * shy - vy * shx,
                          cx = vy * shz - vz * shy;
              dw = (d0 * cy + d1 * cz + d2 * cx) * kInvSqrt2;
              cv[0] = (d2 * shz - d1 * shx) * w * kInvSqrt2;
              cv[1] = (d0 * shx - d2 * shy) * w * kInvSqrt2;
              cv[2] = (d1 * shy - d0 * shz) * w * kInvSqrt2;
            }
          }
          dw = rnd<T>(dw);
          dws[q * W + c] = dw;
          dq[u] = dw;
        }
#pragma unroll
        for (int k = 0; k < H; ++k) {
          const float4 hv = *reinterpret_cast<const float4*>(hs + k * PT + q0);
          dw2acc[k] += hv.x * dq[0];
          dw2acc[k] += hv.y * dq[1];
          dw2acc[k] += hv.z * dq[2];
          dw2acc[k] += hv.w * dq[3];
        }
        db2acc += dq[0];
        db2acc += dq[1];
        db2acc += dq[2];
        db2acc += dq[3];
      }
    }
    __syncthreads();
    // d_h = d_w_all @ W2^T, d_h32 = rnd(d_h * silu'(h32)) (in place of h32)
    for (int o = tid; o < PT * H; o += nt) {
      int q = o / H, k = o % H;
      float r = 0.0f;
      if (q < np) {
        float s = 0.0f;
        for (int cc = 0; cc < W; ++cc) s += dws[q * W + cc] * w2t[cc * W2S + k];
        const float h32 = h32s[k * PT + q], sg = sigmoidf(h32);
        r = rnd<T>(s * (sg + h32 * sg * (1.0f - sg)));
      }
      h32s[k * PT + q] = r;
    }
    // source cotangents: one thread per feature f, pairs in list order
    if (tid < F) {
      const int f = tid;
      for (int q = 0; q < np; ++q) {
        const float* cq = cs + q * CS;
        float v;
        if (f < S) {
          v = cq[f] + cq[S + f];
        } else {
          const int vi = (f - S) / 3, k = (f - S) % 3;
          v = cq[2 * S + vi * 3 + k] + cq[2 * S + (V + vi) * 3 + k];
          v += cq[2 * S + (2 * V + vi) * 3 + k];
        }
        dxs[ps_ts[q] * F + f] += rnd<T>(v);
      }
    }
    __syncthreads();
    // dW1, db1d, db1b: one thread per entry, pairs in list order
    for (int o = tid; o < PART; o += nt) {
      const int kk = o / H, m = o % H;
      float s = dw1s[o];
      for (int q = 0; q < np; ++q) {
        // rows NR and NR + 1 are the biases of the dense and the bond stream
        const float rk = kk < NR ? rs[q * NR + kk] : (kk == NR ? (float)!ps_bond[q] : (float)ps_bond[q]);
        s += rk * h32s[m * PT + q];
      }
      dw1s[o] = s;
    }
    __syncthreads();
  }

  // dx of the block's sources: the node pass's skip part plus the pairs'
  for (int k = tid; k < ns * F; k += nt) {
    const long long node = (long long)g * N + j0 + k / F;
    p.dx[node * F + k % F] += dxs[k];
  }
  float* part = p.part + (long long)(blockIdx.y * gridDim.x + blockIdx.x) * (PART + H * W + W);
  for (int k = tid; k < PART; k += nt) part[k] = dw1s[k];
  if (has_c) {
#pragma unroll
    for (int k = 0; k < H; ++k) part[PART + k * W + c] = dw2acc[k];
    part[PART + H * W + c] = db2acc;
  }
}

// ------------------------------------------------ (a) node pass, bf16 build
// The node pass of the bf16 build for TDM atoms per CTA (one m-tile of
// atoms, three of (atom, component) rows), its eight products on the tensor
// cores with the weights read from device memory (L2) as B operands:
// conv0 = in0 . pl0, conv1 = in1 . pl1, d_gated = g1 . lin21^T, d_scal =
// g0 . lin20^T, the skip's dx = [g0 . sk0^T | g1 . sk1^T], then after the
// gate d_in0 = d_conv0 . pl0^T and d_in1 = d_conv1 . pl1^T. Its function,
// rows and rounding points are node_kernel's.
constexpr int TDM = 16;          // atoms per CTA
constexpr int TDM3 = 3 * TDM;    // (atom, component) rows

// the node pass's shared memory (bytes): A tiles (bf16, [rows][ld_of(K)],
// zero past K and past the CTA's atoms), then the f32 results
struct NodeLayout {
  size_t in0, in1, g0, g1, dc0, dc1, conv0, conv1, dgated, dscal, total;
};

__host__ __device__ inline NodeLayout node_layout(int S, int V, int Sc, int Vg) {
  const int C0 = Sc + Vg;
  NodeLayout l;
  l.in0 = 0;
  l.in1 = l.in0 + cm::align16((size_t)TDM * cm::ld_of(S + V) * 2);
  l.g0 = l.in1 + cm::align16((size_t)TDM3 * cm::ld_of(S + 2 * V) * 2);
  l.g1 = l.g0 + cm::align16((size_t)TDM * cm::ld_of(Sc) * 2);
  l.dc0 = l.g1 + cm::align16((size_t)TDM3 * cm::ld_of(Vg) * 2);
  l.dc1 = l.dc0 + cm::align16((size_t)TDM * cm::ld_of(C0) * 2);
  l.conv0 = l.dc1 + cm::align16((size_t)TDM3 * cm::ld_of(Vg) * 2);
  l.conv1 = l.conv0 + cm::align16((size_t)TDM * C0 * 4);
  l.dgated = l.conv1 + cm::align16((size_t)TDM3 * Vg * 4);
  l.dscal = l.dgated + cm::align16((size_t)TDM3 * Vg * 4);
  l.total = l.dscal + cm::align16((size_t)TDM * Sc * 4);
  return l;
}

// the B fragment of columns n0..n0+7, rows k0..k0+15 of B in device memory:
// row-major [K][N], or with `nmajor` the transpose of a stored [N][K]
// weight; zero past K or N
__device__ __forceinline__ void load_b_weight(uint32_t (&b)[2], const __nv_bfloat16* B, bool nmajor,
                                              int K, int N, int n0, int k0, int lane) {
  const int n = n0 + (lane >> 2), k = k0 + 2 * (lane & 3);
  const unsigned short* u = reinterpret_cast<const unsigned short*>(B);
  unsigned short v[4] = {0, 0, 0, 0};
  if (n < N) {
    const int ks[4] = {k, k + 1, k + 8, k + 9};
#pragma unroll
    for (int e = 0; e < 4; ++e)
      if (ks[e] < K) v[e] = __ldg(u + (nmajor ? (long long)n * K + ks[e] : (long long)ks[e] * N + n));
  }
  b[0] = (uint32_t)v[0] | ((uint32_t)v[1] << 16);
  b[1] = (uint32_t)v[2] | ((uint32_t)v[3] << 16);
}

// D[m][n] = A[m][:K] . B[:K][n] for m < M (MT m-tiles), n < N: A in shared
// memory, B from device memory (load_b_weight), KC k-tiles of B fetched
// together; the n-tiles are spread over the warps from `first`, and
// out(m, n, value) takes each element once
template <int MT, typename Out>
__device__ __forceinline__ void node_product(const __nv_bfloat16* A, int K, const __nv_bfloat16* B,
                                             bool nmajor, int N, int M, int first, int nwarps,
                                             int lane, Out out) {
  constexpr int KC = 4;
  const int lda = cm::ld_of(K);
  for (int n0 = first * 8; n0 < N; n0 += nwarps * 8) {
    float d[MT][4];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) d[mt][0] = d[mt][1] = d[mt][2] = d[mt][3] = 0.0f;
    for (int kc = 0; kc < K; kc += 16 * KC) {
      uint32_t b[KC][2];
#pragma unroll
      for (int j = 0; j < KC; ++j) load_b_weight(b[j], B, nmajor, K, N, n0, kc + 16 * j, lane);
#pragma unroll
      for (int j = 0; j < KC; ++j) {
        if (kc + 16 * j >= K) break;
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          uint32_t a[4];
          cm::load_a(a, A, lda, mt * 16, kc + 16 * j, lane);
          cm::mma_bf16(d[mt], a, b[j]);
        }
      }
    }
    const int col = n0 + 2 * (lane & 3);
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int m = mt * 16 + (lane >> 2) + 8 * (e >> 1), n = col + (e & 1);
        if (m < M && n < N) out(m, n, d[mt][e]);
      }
    }
  }
}

__global__ void __launch_bounds__(MAX_THREADS) node_mma_kernel(Params p) {
  using bf16 = __nv_bfloat16;
  extern __shared__ float4 smem_mma[];
  char* base = reinterpret_cast<char*>(smem_mma);
  const int N = p.N, S = p.S, V = p.V, Sc = p.Sc, Vg = p.Vg;
  const int F = S + 3 * V, W = 2 * S + 3 * V, C0 = Sc + Vg, OF = Sc + 3 * Vg;
  const int K0 = S + V, K1 = S + 2 * V;
  const RowLayout L = row_layout(S, V, Sc, Vg);
  const int nt = blockDim.x, tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31, nwarps = nt >> 5;
  const int g = blockIdx.y, i0 = blockIdx.x * TDM;
  const int nd = min(TDM, N - i0);
  const long long node0 = (long long)g * N + i0;

  const NodeLayout l = node_layout(S, V, Sc, Vg);
  bf16* a_in0 = (bf16*)(base + l.in0);   // [TDM][ld(K0)]
  bf16* a_in1 = (bf16*)(base + l.in1);   // [TDM3][ld(K1)], row (atom, comp)
  bf16* a_g0 = (bf16*)(base + l.g0);     // [TDM][ld(Sc)]
  bf16* a_g1 = (bf16*)(base + l.g1);     // [TDM3][ld(Vg)]
  bf16* a_dc0 = (bf16*)(base + l.dc0);   // [TDM][ld(C0)]
  bf16* a_dc1 = (bf16*)(base + l.dc1);   // [TDM3][ld(Vg)]
  float* conv0 = (float*)(base + l.conv0);    // [TDM][C0]
  float* conv1 = (float*)(base + l.conv1);    // [TDM3][Vg]
  float* dgated = (float*)(base + l.dgated);  // [TDM3][Vg]
  float* dscal = (float*)(base + l.dscal);    // [TDM][Sc]
  const int L0 = cm::ld_of(K0), L1 = cm::ld_of(K1), Lg0 = cm::ld_of(Sc), Lg1 = cm::ld_of(Vg),
            Ld0 = cm::ld_of(C0);

  const bf16* x = (const bf16*)p.x;
  auto row = [&](int td) { return p.rows + (node0 + td) * L.R; };
  auto aggv = [&](int td, int comp, int ch) { return p.agg[((node0 + td) * 3 + comp) * W + ch]; };

  // 1. zero the A tiles (their padding must read as 0)
  {
    uint32_t* z = reinterpret_cast<uint32_t*>(base);
    for (int k = tid; k < (int)(l.conv0 / 4); k += nt) z[k] = 0u;
  }
  __syncthreads();
  // 2. the rows' inputs and the A tiles: aggregates split as the post-linear
  //    reads them, the rounded cotangent, the block input; d_pre's empty
  //    components
  for (int o = tid; o < nd * K0; o += nt) {
    const int td = o / K0, k = o % K0;
    const float v = k < S ? aggv(td, 0, k) : aggv(td, 0, 2 * S + V + (k - S));
    row(td)[L.in0 + k] = v;
    a_in0[td * L0 + k] = __float2bfloat16_rn(v);
  }
  for (int o = tid; o < nd * 3 * K1; o += nt) {
    const int td = o / (3 * K1), c = (o / K1) % 3, k = o % K1;
    const int ch = k < S ? S + k : (k < S + V ? 2 * S + (k - S) : 2 * S + 2 * V + (k - S - V));
    const float v = aggv(td, c, ch);
    row(td)[L.in1 + c * K1 + k] = v;
    a_in1[(td * 3 + c) * L1 + k] = __float2bfloat16_rn(v);
  }
  for (int o = tid; o < nd * OF; o += nt) {
    const int td = o / OF, q = o % OF;
    const float v = rnd<bf16>(p.g[(node0 + td) * OF + q]);
    if (q < Sc) {
      row(td)[L.g0 + q] = v;
      a_g0[td * Lg0 + q] = __float2bfloat16_rn(v);
    } else {
      const int t = q - Sc, c = t % 3, qq = t / 3;  // [Vg][3] -> [3][Vg]
      row(td)[L.g1 + c * Vg + qq] = v;
      a_g1[(td * 3 + c) * Lg1 + qq] = __float2bfloat16_rn(v);
    }
  }
  for (int o = tid; o < nd * F; o += nt) {
    const int td = o / F, f = o % F;
    const float v = ld(x + (node0 + td) * F + f);
    if (f < S) {
      row(td)[L.xs + f] = v;
    } else {
      const int t = f - S;
      row(td)[L.xv + (t % 3) * V + t / 3] = v;
    }
  }
  for (int o = tid; o < nd * 2 * K0; o += nt) {  // components 1, 2 of o1 and o4
    const int td = o / (2 * K0), c = 1 + (o / K0) % 2, k = o % K0;
    const int ch = k < S ? k : 2 * S + V + (k - S);
    p.d_pre[((node0 + td) * 3 + c) * W + ch] = 0.0f;
  }
  __syncthreads();

  // 3. the post-linear recomputed; the backward of the second linear and of
  //    the skip (whose dx part goes straight to dx); the products' n-tiles
  //    are dealt out over the warps one product after the other
  const bf16* pl0 = (const bf16*)p.pl0;
  const bf16* pl1 = (const bf16*)p.pl1;
  int first = warp;
  auto next = [&](int n_tiles) { first = (first + nwarps - n_tiles % nwarps) % nwarps; };
  node_product<1>(a_in0, K0, pl0, false, C0, nd, first, nwarps, lane,
                  [&](int m, int n, float v) { conv0[m * C0 + n] = v; });
  next((C0 + 7) / 8);
  node_product<3>(a_in1, K1, pl1, false, Vg, 3 * nd, first, nwarps, lane,
                  [&](int m, int n, float v) { conv1[m * Vg + n] = v; });
  next((Vg + 7) / 8);
  node_product<3>(a_g1, Vg, (const bf16*)p.lin21, true, Vg, 3 * nd, first, nwarps, lane,
                  [&](int m, int n, float v) { dgated[m * Vg + n] = v; });
  next((Vg + 7) / 8);
  node_product<1>(a_g0, Sc, (const bf16*)p.lin20, true, Sc, nd, first, nwarps, lane,
                  [&](int m, int n, float v) { dscal[m * Sc + n] = rnd<bf16>(v); });
  next((Sc + 7) / 8);
  node_product<1>(a_g0, Sc, (const bf16*)p.sk0, true, S, nd, first, nwarps, lane,
                  [&](int m, int n, float v) { p.dx[(node0 + m) * F + n] = v; });
  next((S + 7) / 8);
  if (V > 0)
    node_product<3>(a_g1, Vg, (const bf16*)p.sk1, true, V, 3 * nd, first, nwarps, lane,
                    [&](int m, int n, float v) { p.dx[(node0 + m / 3) * F + S + 3 * n + m % 3] = v; });
  __syncthreads();

  // 4. gate forward and backward
  for (int o = tid; o < nd * Sc; o += nt) {
    const int td = o / Sc, k = o % Sc;
    const float pre = conv0[td * C0 + k];
    row(td)[L.scal + k] = rnd<bf16>(pre >= 0.0f ? pre : 0.01f * pre);
    const float d = rnd<bf16>(dscal[o] * (pre >= 0.0f ? 1.0f : 0.01f));
    a_dc0[td * Ld0 + k] = __float2bfloat16_rn(d);
    row(td)[L.dconv0 + k] = d;
  }
  for (int o = tid; o < nd * Vg; o += nt) {
    const int td = o / Vg, q = o % Vg;
    const float gate = sigmoidf(conv0[td * C0 + Sc + q]);
    float dgates = 0.0f;
    for (int c = 0; c < 3; ++c) {
      const int e = (td * 3 + c) * Vg + q;
      dgates += dgated[e] * conv1[e];
      row(td)[L.gated + c * Vg + q] = rnd<bf16>(conv1[e] * gate);
      const float d1 = rnd<bf16>(dgated[e] * gate);
      a_dc1[(td * 3 + c) * Lg1 + q] = __float2bfloat16_rn(d1);
      row(td)[L.dconv1 + c * Vg + q] = d1;
    }
    const float d0 = rnd<bf16>(dgates * (gate * (1.0f - gate)));
    a_dc0[td * Ld0 + Sc + q] = __float2bfloat16_rn(d0);
    row(td)[L.dconv0 + Sc + q] = d0;
  }
  __syncthreads();

  // 5. post-linear backward -> d_pre = rnd(rnd(d_in) / max(deg, 1))
  first = warp;
  node_product<1>(a_dc0, C0, pl0, true, K0, nd, first, nwarps, lane, [&](int m, int k, float v) {
    const float inv = 1.0f / fmaxf(p.deg[node0 + m], 1.0f);
    const int ch = k < S ? k : 2 * S + V + (k - S);
    p.d_pre[((node0 + m) * 3) * W + ch] = rnd<bf16>(rnd<bf16>(v) * inv);
  });
  next((K0 + 7) / 8);
  node_product<3>(a_dc1, Vg, pl1, true, K1, 3 * nd, first, nwarps, lane, [&](int m, int k, float v) {
    const int td = m / 3, c = m % 3;
    const float inv = 1.0f / fmaxf(p.deg[node0 + td], 1.0f);
    const int ch = k < S ? S + k : (k < S + V ? 2 * S + (k - S) : 2 * S + 2 * V + (k - S - V));
    p.d_pre[((node0 + td) * 3 + c) * W + ch] = rnd<bf16>(rnd<bf16>(v) * inv);
  });
}

// ------------------------------------------- (b, c) the bf16 build: tensor cores
// Both operands of every product below are values rounded to bf16 already
// (K2's normalised aggregates, the rounded cotangents, the block input, h,
// d_w_all, d_h32, the edge features), so their products are exact in f32:
// on mma.sync bf16 -> f32 only the order of the f32 sums changes.

// (b) row products, split over the rows: one CTA per 32 x 32 output tile
// and chunk of RC (row, component) pairs; each chunk's partial goes to
// scratch and atb_reduce_kernel sums the chunks in order (deterministic, no
// atomics). A chunk stages 32 rows at a time, transposed to bf16 tiles
// ([k][row] and [q][row]), and each of the 8 warps runs one 16 x 8 output
// fragment over them.
constexpr int RC = 256;  // rows per chunk
constexpr int AL = 40;   // leading dimension (bf16) of a staged [32][32] tile

// chunks of a job's M * ncomp rows
__host__ __device__ inline int atb_chunks(long long rows) { return (int)((rows + RC - 1) / RC); }

__global__ void __launch_bounds__(ATB_THREADS) atb_mma_kernel(AtbJobs jobs, const float* rows, int R,
                                                              int M, float* part) {
  using bf16 = __nv_bfloat16;
  __shared__ __align__(16) bf16 At[AT][AL];  // [k][row]
  __shared__ __align__(16) bf16 Bt[AT][AL];  // [q][row]
  int t = blockIdx.x, j = 0;
  long long base = 0;  // the first partial float of this job
  while (j < jobs.n && t >= jobs.job[j].tiles * atb_chunks((long long)M * jobs.job[j].ncomp)) {
    const int span = jobs.job[j].tiles * atb_chunks((long long)M * jobs.job[j].ncomp);
    t -= span;
    base += (long long)span * AT * AT;
    ++j;
  }
  if (j == jobs.n) return;
  const AtbJob J = jobs.job[j];
  const long long total = (long long)M * J.ncomp;
  const int tk = (J.K + AT - 1) / AT;
  const int tile = t % J.tiles, chunk = t / J.tiles;
  const int k0 = (tile % tk) * AT, q0 = (tile / tk) * AT;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int m0 = (warp & 1) * 16, n0 = (warp >> 1) * 8;  // this warp's fragment
  float d[4] = {0.0f, 0.0f, 0.0f, 0.0f};
  const long long r_end = min(total, (long long)(chunk + 1) * RC);
  for (long long r0 = (long long)chunk * RC; r0 < r_end; r0 += AT) {
    // 32 rows x 32 columns of each operand, 4 per thread, read before stored
    float a[4], b[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int e = threadIdx.x + u * ATB_THREADS, rr = e / AT, cc = e % AT;
      const long long r = r0 + rr;
      a[u] = b[u] = 0.0f;
      if (r < r_end) {
        const int n = (int)(r / J.ncomp), c = (int)(r % J.ncomp);
        const float* row = rows + (long long)n * R;
        if (k0 + cc < J.K) a[u] = row[J.a + c * J.K + k0 + cc];
        if (q0 + cc < J.Q) b[u] = row[J.b + c * J.Q + q0 + cc];
      }
    }
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int e = threadIdx.x + u * ATB_THREADS, rr = e / AT, cc = e % AT;
      At[cc][rr] = __float2bfloat16_rn(a[u]);
      Bt[cc][rr] = __float2bfloat16_rn(b[u]);
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < AT; kk += 16) {
      uint32_t fa[4], fb[2];
      cm::load_a(fa, &At[0][0], AL, m0, kk, lane);
      cm::load_bt(fb, &Bt[0][0], AL, n0, kk, lane);
      cm::mma_bf16(d, fa, fb);
    }
    __syncthreads();
  }
  float* out = part + base + ((long long)chunk * J.tiles + tile) * AT * AT;
  const int col = n0 + 2 * (lane & 3), row = m0 + (lane >> 2);
  out[row * AT + col] = d[0];
  out[row * AT + col + 1] = d[1];
  out[(row + 8) * AT + col] = d[2];
  out[(row + 8) * AT + col + 1] = d[3];
}

// the chunks' partials of every row product, summed in chunk order
__global__ void atb_reduce_kernel(AtbJobs jobs, int M, const float* part) {
  int e = blockIdx.x * blockDim.x + threadIdx.x, j = 0;
  long long base = 0;
  while (j < jobs.n && e >= jobs.job[j].K * jobs.job[j].Q) {
    base += (long long)jobs.job[j].tiles * atb_chunks((long long)M * jobs.job[j].ncomp) * AT * AT;
    e -= jobs.job[j].K * jobs.job[j].Q;
    ++j;
  }
  if (j == jobs.n) return;
  const AtbJob J = jobs.job[j];
  const int k = e / J.Q, q = e % J.Q, tk = (J.K + AT - 1) / AT;
  const int tile = (q / AT) * tk + k / AT, within = (k % AT) * AT + q % AT;
  const int chunks = atb_chunks((long long)M * J.ncomp);
  float s = 0.0f;
  for (int c = 0; c < chunks; ++c) s += part[base + ((long long)c * J.tiles + tile) * AT * AT + within];
  J.out[(long long)k * J.Q + q] = s;
}

// (c) the pair pass of the bf16 build: TSM sources per CTA, tiles of PTM
// pairs. The pairs are listed by every warp, one source at a time (count,
// then write at the earlier sources' sum), in the FMA build's order. Per
// tile, behind four barriers:
//   1. stage: per pair its destination, source slot, bond bit and harmonics;
//      its radial features as layer 1's A operand ([pair][radial]) and
//      transposed with the bias rows [1 - bond | bond] ([radial][pair], A of
//      dW1), 8 bytes per load;
//   2. layer 1 on the tensor cores, h32 kept in f32 and h rounded (also
//      transposed, A of dW2); beside it thread c forms d_w_all for its
//      channel (FMA, the FMA build's expressions and rounding), stored as A
//      of dh ([pair][channel]) and as B of dW2 ([channel][pair]), and sums
//      db2;
//   3. layer 2 (conv_block_mma.cuh's radial_layer2: w rounded to bf16), dW2
//      += h^T . d_w_all into fragments each warp carries across tiles (its
//      32 channels x 64), and dh = d_w_all . W2^T with d_h32 = rnd(dh *
//      silu'(h32)) stored as B of dW1 ([hidden][pair]);
//   4. [dW1; db1d; db1b] += [r | 1 - bond | bond]^T . d_h32 into shared f32
//      sums (one owner per element), and thread f sums its feature's source
//      cotangent of each pair (rounded), pairs in list order, as the FMA
//      build does.
constexpr int TSM = 16;  // source atoms per CTA
constexpr int PTM = 32;  // pairs per tile (two m-tiles)
constexpr int MTM = PTM / 16;
constexpr int LR = cm::ld_of(NR), LH = cm::ld_of(H), LP = cm::ld_of(PTM);
constexpr int R1 = 48;   // rows of dW1's A operand: NR radial, 1 - bond, bond, zeros
constexpr int QB = 4;    // pairs whose d_pre reads are issued together
static_assert(TSM <= 16, "the source slot takes 4 bits of a list entry here");

// the pair pass's shared memory (bytes)
struct PairLayout {
  size_t w1t, w2t, rs, rsT, h, hT, h32, wt, dws, dwsT, dh32T, xsrc, dxs, dw1s, ps, counts, list, total;
  int Wk;  // channels padded to the k-steps of dh
};

__host__ __device__ inline PairLayout pair_layout(int N, int B, int S, int V) {
  const int W = 2 * S + 3 * V, F = S + 3 * V, Wk = cm::round_up(W, 16), ldw = cm::ld_of(Wk);
  PairLayout l;
  l.Wk = Wk;
  l.w1t = 0;
  l.w2t = l.w1t + cm::align16((size_t)H * LR * 2);
  l.rs = l.w2t + cm::align16((size_t)Wk * H * 2);
  l.rsT = l.rs + cm::align16((size_t)PTM * LR * 2);
  l.h = l.rsT + cm::align16((size_t)R1 * LP * 2);
  l.hT = l.h + cm::align16((size_t)PTM * LH * 2);
  l.h32 = l.hT + cm::align16((size_t)H * LP * 2);
  l.wt = l.h32 + cm::align16((size_t)PTM * H * 4);
  l.dws = l.wt + cm::align16((size_t)PTM * ldw * 2);
  l.dwsT = l.dws + cm::align16((size_t)PTM * ldw * 2);
  l.dh32T = l.dwsT + cm::align16((size_t)Wk * LP * 2);
  l.xsrc = l.dh32T + cm::align16((size_t)H * LP * 2);
  l.dxs = l.xsrc + cm::align16((size_t)TSM * F * 2);
  l.dw1s = l.dxs + cm::align16((size_t)TSM * F * 4);
  l.ps = l.dw1s + cm::align16((size_t)PART * 4);
  l.counts = l.ps + cm::align16((size_t)PTM * 6 * 4);
  l.list = l.counts + cm::align16((size_t)(TSM + 1) * 4);
  l.total = l.list + cm::align16(((size_t)TSM * N + B) * 4);
  return l;
}

__global__ void __launch_bounds__(MAX_THREADS, 1) pair_mma_kernel(Params p) {
  using bf16 = __nv_bfloat16;
  extern __shared__ float4 smem_mma[];
  char* base = reinterpret_cast<char*>(smem_mma);
  const int N = p.N, B = p.B, S = p.S, V = p.V;
  const int F = S + 3 * V, W = 2 * S + 3 * V;
  const float kInvSqrt3 = 0.57735026918962576f, kInvSqrt2 = 0.70710678118654752f;
  const int nt = blockDim.x, tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31, nwarps = nt >> 5;
  const int g = blockIdx.y, j0 = blockIdx.x * TSM;
  const int ns = min(TSM, N - j0);

  const PairLayout l = pair_layout(N, B, S, V);
  const int Wk = l.Wk;
  cm::PairTiles t;
  t.w1t = (bf16*)(base + l.w1t);
  t.w2t = (bf16*)(base + l.w2t);
  t.rs = (bf16*)(base + l.rs);
  t.h = (bf16*)(base + l.h);
  t.wt = (bf16*)(base + l.wt);
  t.Wp = Wk;
  t.ldw = cm::ld_of(Wk);
  bf16* rsT = (bf16*)(base + l.rsT);   // [R1][LP]
  bf16* hT = (bf16*)(base + l.hT);     // [H][LP]
  float* h32s = (float*)(base + l.h32);  // [PTM][H]
  bf16* dws = (bf16*)(base + l.dws);   // [PTM][ldw]
  bf16* dwsT = (bf16*)(base + l.dwsT); // [Wk][LP]
  bf16* dh32T = (bf16*)(base + l.dh32T);  // [H][LP]
  bf16* xsrc = (bf16*)(base + l.xsrc); // [TSM][F]
  float* dxs = (float*)(base + l.dxs); // [TSM][F]
  float* dw1s = (float*)(base + l.dw1s);  // [NR + 2][H]
  int* ps_dst = (int*)(base + l.ps);   // [PTM]
  int* ps_ts = ps_dst + PTM;           // [PTM]
  int* ps_bond = ps_ts + PTM;          // [PTM]
  float* ps_sh = (float*)(ps_bond + PTM);  // [PTM][3]
  int* counts = (int*)(base + l.counts);  // [TSM], then the list's length
  int* list = (int*)(base + l.list);   // [TSM * N + B]
  const int ldw = t.ldw;

  const bf16* x = (const bf16*)p.x + (long long)g * N * F;
  const bf16* ef = (const bf16*)p.ef + (long long)g * N * N * EC;
  const bf16* bf = (const bf16*)p.bf + (long long)g * B * EC;
  const int64_t* bsrc = p.bond_src + (long long)g * B;
  const int64_t* bdst = p.bond_dst + (long long)g * B;
  const float* d_pre = p.d_pre + (long long)g * N * 3 * W;

  // weights (w2 n-major and swizzled, rows W..Wk zero), the block's sources,
  // zeroed sums and the constant rows of dW1's A operand
  conv_block::Weights wts{};
  wts.w1 = p.w1;
  wts.w2 = p.w2;
  for (int k = tid; k < (Wk - W) * H; k += nt) t.w2t[cm::w2_at(W + k / H, k % H)] = __float2bfloat16_rn(0.0f);
  cm::load_pair_weights(t, wts, W, tid, nt);
  for (int k = tid; k < TSM * F; k += nt) {
    const int ts = k / F;
    xsrc[k] = ts < ns ? x[(long long)(j0 + ts) * F + k % F] : __float2bfloat16_rn(0.0f);
    dxs[k] = 0.0f;
  }
  for (int k = tid; k < PART; k += nt) dw1s[k] = 0.0f;
  for (int k = tid; k < (R1 - NR - 2) * LP; k += nt) rsT[(NR + 2) * LP + k] = __float2bfloat16_rn(0.0f);

  // the pairs of source slot ts: (dst i, src j) inside the cutoff, then the
  // bonds leaving j; one warp, all lanes; with at >= 0 the entries go to
  // list[at ...]
  const unsigned lt = (1u << lane) - 1u;
  auto scan = [&](int ts, int at) {
    const int j = j0 + ts;
    int count = 0;
    for (int b0 = 0; b0 < N; b0 += 32) {
      const int i = b0 + lane;
      const bool a = i < N && ld(ef + ((long long)i * N + j) * EC + 3) > 0.5f;
      const unsigned m = __ballot_sync(0xffffffffu, a);
      if (a && at >= 0) list[at + count + __popc(m & lt)] = encode(ts, 0, i);
      count += __popc(m);
    }
    for (int b0 = 0; b0 < B; b0 += 32) {
      const int b = b0 + lane;
      const bool a = b < B && bsrc[b] == j && ld(bf + (long long)b * EC + 3) > 0.5f;
      const unsigned m = __ballot_sync(0xffffffffu, a);
      if (a && at >= 0) list[at + count + __popc(m & lt)] = encode(ts, 1, b);
      count += __popc(m);
    }
    return count;
  };
  for (int ts = warp; ts < ns; ts += nwarps) {
    const int count = scan(ts, -1);
    if (lane == 0) counts[ts] = count;
  }
  __syncthreads();
  for (int ts = warp; ts < ns; ts += nwarps) {
    int at = 0;
    for (int u = 0; u < ts; ++u) at += counts[u];
    scan(ts, at);
  }
  if (tid == 0) {
    int total = 0;
    for (int u = 0; u < ns; ++u) total += counts[u];
    counts[TSM] = total;
  }
  __syncthreads();
  const int nl = counts[TSM];

  auto feat = [&](int e) -> const bf16* {
    const int idx = e & ((1 << 19) - 1), ts = e >> 20;
    if (e & (1 << 19)) return bf + (long long)idx * EC;
    return ef + ((long long)idx * N + j0 + ts) * EC;
  };

  const int c = tid;  // this thread's radial channel (d_w_all) and feature (source cotangent)
  float db2acc = 0.0f;
  float acc2[4][H / 16][4];  // dW2 fragments: this warp's channels n0 = 32 warp + 8 jn, hidden rows
#pragma unroll
  for (int jn = 0; jn < 4; ++jn)
#pragma unroll
    for (int mt = 0; mt < H / 16; ++mt) acc2[jn][mt][0] = acc2[jn][mt][1] = acc2[jn][mt][2] = acc2[jn][mt][3] = 0.0f;

  for (int t0 = 0; t0 < nl; t0 += PTM) {
    const int np = min(PTM, nl - t0);
    // 1. stage the tile
    if (tid < PTM) {
      int dst = 0, ts = 0, bond = 0;
      float s0 = 0.0f, s1 = 0.0f, s2 = 0.0f;
      if (tid < np) {
        const int e = list[t0 + tid];
        ts = e >> 20;
        bond = (e >> 19) & 1;
        const int idx = e & ((1 << 19) - 1);
        dst = bond ? (int)bdst[idx] : idx;
        const bf16* fp = feat(e);
        s0 = ld(fp + 0);
        s1 = ld(fp + 1);
        s2 = ld(fp + 2);
      }
      ps_dst[tid] = dst;
      ps_ts[tid] = ts;
      ps_bond[tid] = bond;
      ps_sh[tid * 3 + 0] = s0;
      ps_sh[tid * 3 + 1] = s1;
      ps_sh[tid * 3 + 2] = s2;
      rsT[NR * LP + tid] = __float2bfloat16_rn(tid < np ? (float)!bond : 0.0f);
      rsT[(NR + 1) * LP + tid] = __float2bfloat16_rn(tid < np ? (float)bond : 0.0f);
    }
    for (int o = tid; o < PTM * (NR / 4); o += nt) {
      const int q = o / (NR / 4), k = 4 * (o % (NR / 4));
      uint2 v = make_uint2(0u, 0u);
      if (q < np) v = *reinterpret_cast<const uint2*>(feat(list[t0 + q]) + 4 + k);
      *reinterpret_cast<uint2*>(t.rs + q * LR + k) = v;
      const bf16* e = reinterpret_cast<const bf16*>(&v);
#pragma unroll
      for (int u = 0; u < 4; ++u) rsT[(k + u) * LP + q] = e[u];
    }
    __syncthreads();

    // 2. layer 1 (tensor cores) and d_w_all (thread c)
    for (int o = warp; o < MTM * (H / 8); o += nwarps) {
      const int m0 = (o / (H / 8)) * 16, n0 = (o % (H / 8)) * 8;
      float d[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
      for (int k0 = 0; k0 < NR; k0 += 16) {
        uint32_t a[4], b[2];
        cm::load_a(a, t.rs, LR, m0, k0, lane);
        cm::load_bt(b, t.w1t, LR, n0, k0, lane);
        cm::mma_bf16(d, a, b);
      }
      const int col = n0 + 2 * (lane & 3);
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int q = m0 + (lane >> 2) + 8 * half;
        const bool live = q < np;
        const float* b1 = ps_bond[q] ? p.b1b : p.b1d;
        const float v0 = live ? d[2 * half] + __ldg(b1 + col) : 0.0f;
        const float v1 = live ? d[2 * half + 1] + __ldg(b1 + col + 1) : 0.0f;
        const float h0 = live ? v0 * sigmoidf(v0) : 0.0f, h1 = live ? v1 * sigmoidf(v1) : 0.0f;
        *reinterpret_cast<float2*>(h32s + q * H + col) = make_float2(v0, v1);
        const uint32_t hh = cm::pack2(h0, h1);
        *reinterpret_cast<uint32_t*>(t.h + q * LH + col) = hh;
        hT[col * LP + q] = __ushort_as_bfloat16((unsigned short)(hh & 0xffffu));
        hT[(col + 1) * LP + q] = __ushort_as_bfloat16((unsigned short)(hh >> 16));
      }
    }
    if (c < Wk) {
      // the channel's d_pre components of QB pairs are read before their sums
      for (int q0 = 0; q0 < PTM; q0 += QB) {
        float e0[QB], e1[QB], e2[QB];
#pragma unroll
        for (int u = 0; u < QB; ++u) {
          const int q = q0 + u;
          e0[u] = e1[u] = e2[u] = 0.0f;
          if (q < np && c < W) {
            const float* dp = d_pre + (long long)ps_dst[q] * 3 * W + c;
            e0[u] = dp[0];
            if (c >= S) {
              e1[u] = dp[W];
              e2[u] = dp[2 * W];
            }
          }
        }
#pragma unroll
        for (int u = 0; u < QB; ++u) {
          const int q = q0 + u;
          float dw = 0.0f;
          if (q < np && c < W) {
            const bf16* xj = xsrc + ps_ts[q] * F;
            const float shy = ps_sh[q * 3 + 0], shz = ps_sh[q * 3 + 1], shx = ps_sh[q * 3 + 2];
            if (c < S) {
              dw = e0[u] * __bfloat162float(xj[c]);
            } else if (c < 2 * S) {
              float t2c = e0[u] * shy;
              t2c += e1[u] * shz;
              t2c += e2[u] * shx;
              dw = t2c * __bfloat162float(xj[c - S]);
            } else {
              const int vi = (c - 2 * S) % V, path = (c - 2 * S) / V;
              const float vy = __bfloat162float(xj[S + 3 * vi]);
              const float vz = __bfloat162float(xj[S + 3 * vi + 1]);
              const float vx = __bfloat162float(xj[S + 3 * vi + 2]);
              const float d0 = e0[u], d1 = e1[u], d2 = e2[u];
              if (path == 0) {
                dw = d0 * vy + d1 * vz + d2 * vx;
              } else if (path == 1) {
                dw = d0 * (vy * shy + vz * shz + vx * shx) * kInvSqrt3;
              } else {
                const float cy = vz * shx - vx * shz, cz = vx * shy - vy * shx, cx = vy * shz - vz * shy;
                dw = (d0 * cy + d1 * cz + d2 * cx) * kInvSqrt2;
              }
            }
            dw = rnd<bf16>(dw);
            db2acc += dw;
          }
          const bf16 v = __float2bfloat16_rn(dw);
          dws[q * ldw + c] = v;
          dwsT[c * LP + q] = v;
        }
      }
    }
    __syncthreads();

    // 3. layer 2, dW2 and dh
    for (int m0 = 0; m0 < PTM; m0 += 16) {
      cm::PairTiles th = t;
      th.wt = t.wt + m0 * ldw;
      cm::radial_layer2(th, p.b2, W, m0, warp, lane);
    }
#pragma unroll
    for (int k0 = 0; k0 < PTM; k0 += 16) {
      uint32_t a[H / 16][4];
#pragma unroll
      for (int mt = 0; mt < H / 16; ++mt) cm::load_a(a[mt], hT, LP, mt * 16, k0, lane);
#pragma unroll
      for (int jn = 0; jn < 4; ++jn) {
        const int n0 = warp * 32 + jn * 8;
        if (n0 < Wk) {
          uint32_t b[2];
          cm::load_bt(b, dwsT, LP, n0, k0, lane);
#pragma unroll
          for (int mt = 0; mt < H / 16; ++mt) cm::mma_bf16(acc2[jn][mt], a[mt], b);
        }
      }
    }
    for (int o = warp; o < MTM * (H / 8); o += nwarps) {
      const int m0 = (o / (H / 8)) * 16, n0 = (o % (H / 8)) * 8;
      float d[4] = {0.0f, 0.0f, 0.0f, 0.0f};
      const int n = n0 + (lane >> 2), kq = 2 * (lane & 3);
      for (int k0 = 0; k0 < Wk; k0 += 16) {  // dh
        uint32_t a[4], b[2];
        cm::load_a(a, dws, ldw, m0, k0, lane);
        b[0] = cm::pack2(t.w2t[cm::w2_at(k0 + kq, n)], t.w2t[cm::w2_at(k0 + kq + 1, n)]);
        b[1] = cm::pack2(t.w2t[cm::w2_at(k0 + kq + 8, n)], t.w2t[cm::w2_at(k0 + kq + 9, n)]);
        cm::mma_bf16(d, a, b);
      }
      const int col = n0 + 2 * (lane & 3);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int q = m0 + (lane >> 2) + 8 * (e >> 1), hcol = col + (e & 1);
        float r = 0.0f;
        if (q < np) {
          const float h32 = h32s[q * H + hcol], sg = sigmoidf(h32);
          r = d[e] * (sg + h32 * sg * (1.0f - sg));
        }
        dh32T[hcol * LP + q] = __float2bfloat16_rn(r);
      }
    }
    __syncthreads();

    // 4. dW1 and the source cotangents
    for (int o = warp; o < (R1 / 16) * (H / 8); o += nwarps) {
      const int m0 = (o / (H / 8)) * 16, n0 = (o % (H / 8)) * 8;
      float d[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
      for (int k0 = 0; k0 < PTM; k0 += 16) {  // dW1
        uint32_t a[4], b[2];
        cm::load_a(a, rsT, LP, m0, k0, lane);
        cm::load_bt(b, dh32T, LP, n0, k0, lane);
        cm::mma_bf16(d, a, b);
      }
      const int col = n0 + 2 * (lane & 3);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int kk = m0 + (lane >> 2) + 8 * (e >> 1);
        if (kk < NR + 2) dw1s[kk * H + col + (e & 1)] += d[e];
      }
    }
    if (c < F) {
      // feature f's source cotangent of each pair (the FMA build's sum of
      // its channels' contributions, rounded), QB pairs' reads first
      const int f = c;
      const bool scalar = f < S;
      const int vi = scalar ? 0 : (f - S) / 3, k = scalar ? 0 : (f - S) % 3;
      const int ca = 2 * S + vi, cb = 2 * S + V + vi, cc = 2 * S + 2 * V + vi;
      for (int q0 = 0; q0 < np; q0 += QB) {
        float r0[QB], r1[QB], r2[QB], r3[QB], r4[QB];
#pragma unroll
        for (int u = 0; u < QB; ++u) {
          const int q = min(q0 + u, np - 1);
          const float* dp = d_pre + (long long)ps_dst[q] * 3 * W;
          if (scalar) {
            r0[u] = dp[f];
            r1[u] = dp[S + f];
            r2[u] = dp[W + S + f];
            r3[u] = dp[2 * W + S + f];
            r4[u] = 0.0f;
          } else {
            r0[u] = dp[k * W + ca];
            r1[u] = dp[cb];
            r2[u] = dp[cc];
            r3[u] = dp[W + cc];
            r4[u] = dp[2 * W + cc];
          }
        }
#pragma unroll
        for (int u = 0; u < QB; ++u) {
          const int q = q0 + u;
          if (q >= np) break;
          const bf16* wq = t.wt + q * ldw;
          const float shy = ps_sh[q * 3 + 0], shz = ps_sh[q * 3 + 1], shx = ps_sh[q * 3 + 2];
          float v;
          if (scalar) {
            const float w0 = __bfloat162float(wq[f]), w1 = __bfloat162float(wq[S + f]);
            float t2c = r1[u] * shy;
            t2c += r2[u] * shz;
            t2c += r3[u] * shx;
            v = r0[u] * w0 + rnd<bf16>(t2c) * w1;
          } else {
            const float wa = __bfloat162float(wq[ca]), wb = __bfloat162float(wq[cb]);
            const float wc = __bfloat162float(wq[cc]);
            const float sk = k == 0 ? shy : (k == 1 ? shz : shx);
            const float e0 = r2[u], e1 = r3[u], e2 = r4[u];
            float cross;
            if (k == 0)
              cross = (e2 * shz - e1 * shx) * wc * kInvSqrt2;
            else if (k == 1)
              cross = (e0 * shx - e2 * shy) * wc * kInvSqrt2;
            else
              cross = (e1 * shy - e0 * shz) * wc * kInvSqrt2;
            v = r0[u] * wa + r1[u] * wb * sk * kInvSqrt3;
            v += cross;
          }
          dxs[ps_ts[q] * F + f] += rnd<bf16>(v);
        }
      }
    }
    __syncthreads();
  }

  // dx of the block's sources: the node pass's skip part plus the pairs'
  for (int k = tid; k < ns * F; k += nt) {
    const long long node = (long long)g * N + j0 + k / F;
    p.dx[node * F + k % F] += dxs[k];
  }
  float* part = p.part + (long long)(blockIdx.y * gridDim.x + blockIdx.x) * (PART + H * W + W);
  for (int k = tid; k < PART; k += nt) part[k] = dw1s[k];
  if (c < W) part[PART + H * W + c] = db2acc;
#pragma unroll
  for (int jn = 0; jn < 4; ++jn) {
    const int col = warp * 32 + jn * 8 + 2 * (lane & 3);
#pragma unroll
    for (int mt = 0; mt < H / 16; ++mt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int k = mt * 16 + (lane >> 2) + 8 * (e >> 1), n = col + (e & 1);
        if (n < W) part[PART + k * W + n] = acc2[jn][mt][e];
      }
    }
  }
}

// ------------------------------------------------------------- (d) reduction
__global__ void reduce_kernel(Params p, int n_blocks) {
  const int W = 2 * p.S + 3 * p.V;
  const int P = PART + H * W + W;
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= P) return;
  float s = 0.0f;
  for (int b = 0; b < n_blocks; ++b) s += p.part[(long long)b * P + e];
  if (e < NR * H) {
    p.dw1[e] = s;
  } else if (e < (NR + 1) * H) {
    p.db1d[e - NR * H] = s;
  } else if (e < PART) {
    p.db1b[e - (NR + 1) * H] = s;
  } else if (e < PART + H * W) {
    p.dw2[e - PART] = s;
  } else {
    p.db2[e - PART - H * W] = s;
  }
}

int threads_for(int W) {
  int t = ((W + 31) / 32) * 32;
  return t < 64 ? 64 : t;
}

size_t node_smem(const Params& p) {
  const int C0 = p.Sc + p.Vg;
  return (size_t)TD * (2 * C0 + 2 * 3 * p.Vg + 3 * p.Vg + p.Sc) * 4;
}

size_t pair_smem(const Params& p) {
  const int W = 2 * p.S + 3 * p.V, F = p.S + 3 * p.V, CS = 2 * p.S + 9 * p.V;
  size_t floats = 2 * H * PT + NR * H + (size_t)W * W2S + PT * NR + (size_t)PT * W +
                  (size_t)PT * CS + 2 * (size_t)TS * F + PART + PT * 3;
  size_t ints = 3 * PT + (size_t)TS * p.N + p.B + 1;
  return (floats + ints) * 4;
}

// the six row products of the epilogue's weight gradients
AtbJobs atb_jobs(const Params& p) {
  const RowLayout L = row_layout(p.S, p.V, p.Sc, p.Vg);
  AtbJobs jobs;
  jobs.n = 0;
  auto add = [&](float* out, int a, int b, int K, int Q, int ncomp) {
    if (K == 0 || Q == 0) return;
    const int n = ((K + AT - 1) / AT) * ((Q + AT - 1) / AT);
    jobs.job[jobs.n++] = AtbJob{out, a, b, K, Q, ncomp, n};
  };
  add(p.dpl0, L.in0, L.dconv0, p.S + p.V, p.Sc + p.Vg, 1);
  add(p.dpl1, L.in1, L.dconv1, p.S + 2 * p.V, p.Vg, 3);
  add(p.dlin20, L.scal, L.g0, p.Sc, p.Sc, 1);
  add(p.dlin21, L.gated, L.g1, p.Vg, p.Vg, 3);
  add(p.dsk0, L.xs, L.g0, p.S, p.Sc, 1);
  add(p.dsk1, L.xv, L.g1, p.V, p.Vg, 3);
  return jobs;
}

int atb_tiles(const AtbJobs& jobs) {
  int n = 0;
  for (int j = 0; j < jobs.n; ++j) n += jobs.job[j].tiles;
  return n;
}

// CTAs of atb_mma_kernel (tiles x chunks per job) and outputs of its reduce
int atb_mma_blocks(const AtbJobs& jobs, int M) {
  int n = 0;
  for (int j = 0; j < jobs.n; ++j) n += jobs.job[j].tiles * atb_chunks((long long)M * jobs.job[j].ncomp);
  return n;
}

int atb_outputs(const AtbJobs& jobs) {
  int n = 0;
  for (int j = 0; j < jobs.n; ++j) n += jobs.job[j].K * jobs.job[j].Q;
  return n;
}

template <typename T>
int launch(const Params& p, void* stream) {
  constexpr bool mma = std::is_same<T, __nv_bfloat16>::value;
  const int W = 2 * p.S + 3 * p.V;
  const int nt = threads_for(W);
  if (nt > MAX_THREADS || p.N >= (1 << 19) || p.B >= (1 << 19)) return (int)cudaErrorInvalidValue;
  const size_t node_bytes = mma ? node_layout(p.S, p.V, p.Sc, p.Vg).total : node_smem(p);
  const size_t pair_bytes = mma ? pair_layout(p.N, p.B, p.S, p.V).total : pair_smem(p);
  if (node_bytes > MAX_SMEM || pair_bytes > MAX_SMEM) return (int)cudaErrorInvalidValue;
  if (p.G == 0 || p.N == 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  cudaError_t err;
  const int td = mma ? TDM : TD, ts = mma ? TSM : TS;
  const dim3 node_grid((p.N + td - 1) / td, p.G), pair_grid((p.N + ts - 1) / ts, p.G);
  const AtbJobs jobs = atb_jobs(p);
  const int M = p.G * p.N, R = row_layout(p.S, p.V, p.Sc, p.Vg).R;

  if constexpr (mma) {
    err = cudaFuncSetAttribute(node_mma_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)node_bytes);
    if (err != cudaSuccess) return (int)err;
    err = cudaFuncSetAttribute(pair_mma_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)pair_bytes);
    if (err != cudaSuccess) return (int)err;
    node_mma_kernel<<<node_grid, nt, node_bytes, s>>>(p);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
    atb_mma_kernel<<<atb_mma_blocks(jobs, M), ATB_THREADS, 0, s>>>(jobs, p.rows, R, M, p.part);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
    atb_reduce_kernel<<<(atb_outputs(jobs) + 255) / 256, 256, 0, s>>>(jobs, M, p.part);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
    pair_mma_kernel<<<pair_grid, nt, pair_bytes, s>>>(p);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  } else {
    err = cudaFuncSetAttribute(node_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)node_bytes);
    if (err != cudaSuccess) return (int)err;
    err = cudaFuncSetAttribute(pair_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)pair_bytes);
    if (err != cudaSuccess) return (int)err;
    node_kernel<T><<<node_grid, nt, node_bytes, s>>>(p);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
    atb_kernel<<<atb_tiles(jobs), ATB_THREADS, 0, s>>>(jobs, p.rows, R, M);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
    pair_kernel<T><<<pair_grid, nt, pair_bytes, s>>>(p);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  }

  const int P = PART + H * W + W;
  reduce_kernel<<<(P + 255) / 256, 256, 0, s>>>(p, pair_grid.x * pair_grid.y);
  return (int)cudaGetLastError();
}

}  // namespace

#define CONV_BLOCK_BWD_ENTRY(NAME, TYPE)                                                       \
  extern "C" int NAME(const void* g, const void* x, const void* ef, const void* bf,           \
                      const void* bond_src, const void* bond_dst, const void* agg,            \
                      const void* deg, const void* w1, const void* b1d, const void* b1b,      \
                      const void* w2, const void* b2, const void* pl0, const void* pl1,       \
                      const void* lin20, const void* lin21, const void* sk0, const void* sk1, \
                      void* d_pre, void* rows, void* part, void* dx, void* dw1, void* db1d,   \
                      void* db1b, void* dw2, void* db2, void* dpl0, void* dpl1, void* dlin20, \
                      void* dlin21, void* dsk0, void* dsk1, int G, int N, int B, int S,       \
                      int V, int Sc, int Vg, void* stream) {                                  \
    Params p;                                                                                 \
    p.g = (const float*)g;                                                                    \
    p.x = x;                                                                                  \
    p.ef = ef;                                                                                \
    p.bf = bf;                                                                                \
    p.bond_src = (const int64_t*)bond_src;                                                    \
    p.bond_dst = (const int64_t*)bond_dst;                                                    \
    p.agg = (const float*)agg;                                                                \
    p.deg = (const float*)deg;                                                                \
    p.w1 = w1;                                                                                \
    p.b1d = (const float*)b1d;                                                                \
    p.b1b = (const float*)b1b;                                                                \
    p.w2 = w2;                                                                                \
    p.b2 = (const float*)b2;                                                                  \
    p.pl0 = pl0;                                                                              \
    p.pl1 = pl1;                                                                              \
    p.lin20 = lin20;                                                                          \
    p.lin21 = lin21;                                                                          \
    p.sk0 = sk0;                                                                              \
    p.sk1 = sk1;                                                                              \
    p.d_pre = (float*)d_pre;                                                                  \
    p.rows = (float*)rows;                                                                    \
    p.part = (float*)part;                                                                    \
    p.dx = (float*)dx;                                                                        \
    p.dw1 = (float*)dw1;                                                                      \
    p.db1d = (float*)db1d;                                                                    \
    p.db1b = (float*)db1b;                                                                    \
    p.dw2 = (float*)dw2;                                                                      \
    p.db2 = (float*)db2;                                                                      \
    p.dpl0 = (float*)dpl0;                                                                    \
    p.dpl1 = (float*)dpl1;                                                                    \
    p.dlin20 = (float*)dlin20;                                                                \
    p.dlin21 = (float*)dlin21;                                                                \
    p.dsk0 = (float*)dsk0;                                                                    \
    p.dsk1 = (float*)dsk1;                                                                    \
    p.G = G;                                                                                  \
    p.N = N;                                                                                  \
    p.B = B;                                                                                  \
    p.S = S;                                                                                  \
    p.V = V;                                                                                  \
    p.Sc = Sc;                                                                                \
    p.Vg = Vg;                                                                                \
    return launch<TYPE>(p, stream);                                                           \
  }

CONV_BLOCK_BWD_ENTRY(conv_block_bwd_f32, float)
CONV_BLOCK_BWD_ENTRY(conv_block_bwd_bf16, __nv_bfloat16)

// bytes of dynamic shared memory of the pair pass of the f32 (bf16 = 0) or
// bf16 build at these sizes
extern "C" int conv_block_bwd_smem(int bf16, int N, int B, int S, int V) {
  Params p{};
  p.N = N;
  p.B = B;
  p.S = S;
  p.V = V;
  return (int)(bf16 ? pair_layout(N, B, S, V).total : pair_smem(p));
}

// How the pair pass of a build is launched at these sizes and what the card
// makes of it: out = {threads, bytes of shared memory per CTA, registers
// per thread, local (spill) bytes per thread, CTAs resident per SM, source
// atoms per CTA}
extern "C" int conv_block_bwd_occupancy(int bf16, int N, int B, int S, int V, int* out) {
  const int nt = threads_for(2 * S + 3 * V);
  const size_t smem = (size_t)conv_block_bwd_smem(bf16, N, B, S, V);
  if (nt > MAX_THREADS || smem > MAX_SMEM) return (int)cudaErrorInvalidValue;
  const auto fn = bf16 ? pair_mma_kernel : pair_kernel<float>;
  cudaError_t err = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  cudaFuncAttributes attr;
  err = cudaFuncGetAttributes(&attr, fn);
  if (err != cudaSuccess) return (int)err;
  int ctas = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&ctas, fn, nt, smem);
  if (err != cudaSuccess) return (int)err;
  const int values[6] = {nt, (int)smem, attr.numRegs, (int)attr.localSizeBytes, ctas, bf16 ? TSM : TS};
  for (int k = 0; k < 6; ++k) out[k] = values[k];
  return 0;
}
