// Backward of one whole separable ConvBlock of the dense E3Conv (l <= 1,
// uvu): given the cotangent g of K2's output (csrc/conv_block.cu), the
// gradient of the block input x and the weight gradients, summed over graphs.
//
// Replaces the TPU kernel `_block_bwd_kernel` of
// jamun_tpu/ops/pallas/packed_conv.py (pallas_call at line 2220, entry
// `packed_conv_block_bwd`), the VJP of `make_trainable_conv_block`. The TPU
// kernel walks K graphs per program over all N*N pairs as lane-packed
// panels, scatters and gathers with one-hot matmuls, and carries the weight
// gradients from one grid step to the next. Here four kernels run in one
// stream, and nothing is summed with atomics:
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
// (2 * (2 * 64 * W + NR * 64)), about 4x K2's per-pair work. This first
// version runs them as FP32 FMAs: thread c owns radial channel c, keeps its
// 64 dW2 partial sums in registers, and reads W2 from a shared transposed
// copy padded to 65 columns, so both the forward product (thread c walks
// row c) and dh (thread k walks column k) are free of bank conflicts.
//
// Rounding points follow `_block_bwd_kernel` without its o2 fold (K2's
// forward does not fold either): g, d_scal, d_conv0, d_conv1, d_in0/d_in1,
// d_pre, rnd(t2_cot), d_w_all, d_h32 and each pair's source cotangent are
// rounded to the compute type T; products and sums are f32.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

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

template <typename T>
int launch(const Params& p, void* stream) {
  const int W = 2 * p.S + 3 * p.V;
  const int nt = threads_for(W);
  if (nt > MAX_THREADS || p.N >= (1 << 19) || p.B >= (1 << 19)) return (int)cudaErrorInvalidValue;
  if (p.G == 0 || p.N == 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  cudaError_t err;

  size_t smem = node_smem(p);
  err = cudaFuncSetAttribute(node_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  node_kernel<T><<<dim3((p.N + TD - 1) / TD, p.G), nt, smem, s>>>(p);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;

  const RowLayout L = row_layout(p.S, p.V, p.Sc, p.Vg);
  AtbJobs jobs;
  jobs.n = 0;
  int tiles = 0;
  auto add = [&](float* out, int a, int b, int K, int Q, int ncomp) {
    if (K == 0 || Q == 0) return;
    const int n = ((K + AT - 1) / AT) * ((Q + AT - 1) / AT);
    jobs.job[jobs.n++] = AtbJob{out, a, b, K, Q, ncomp, n};
    tiles += n;
  };
  add(p.dpl0, L.in0, L.dconv0, p.S + p.V, p.Sc + p.Vg, 1);
  add(p.dpl1, L.in1, L.dconv1, p.S + 2 * p.V, p.Vg, 3);
  add(p.dlin20, L.scal, L.g0, p.Sc, p.Sc, 1);
  add(p.dlin21, L.gated, L.g1, p.Vg, p.Vg, 3);
  add(p.dsk0, L.xs, L.g0, p.S, p.Sc, 1);
  add(p.dsk1, L.xv, L.g1, p.V, p.Vg, 3);
  atb_kernel<<<tiles, ATB_THREADS, 0, s>>>(jobs, p.rows, L.R, p.G * p.N);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;

  smem = pair_smem(p);
  err = cudaFuncSetAttribute(pair_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((p.N + TS - 1) / TS, p.G);
  pair_kernel<T><<<grid, nt, smem, s>>>(p);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;

  const int P = PART + H * W + W;
  reduce_kernel<<<(P + 255) / 256, 256, 0, s>>>(p, grid.x * grid.y);
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
