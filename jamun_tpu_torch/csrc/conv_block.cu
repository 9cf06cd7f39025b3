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
// Rounding points follow the TPU kernel: radial features and
// h = silu(h32) in the compute type T, message weights in T, f32
// accumulation, the normalised aggregates in T, the gate's scalars and
// gated vectors in T, f32 output.
//
// Under autograd the wrapper also asks for the residuals of the backward
// kernel (csrc/conv_block_bwd.cu): the normalised aggregates as
// [G, N, 3, W] f32 (component, radial channel) and the degree [G, N], the
// counterpart of the TPU kernel's save_residuals mode.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int NR = 32;   // radial basis functions (edge_attr_dim / 2)
constexpr int H = 64;    // radial MLP hidden width (edge_attr_dim)
constexpr int EC = 4 + NR;
constexpr int TD = 8;    // destination atoms per CTA
constexpr int PT = 32;   // pairs per tile
constexpr int MAX_THREADS = 384;

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
  const void* x;      // [G, N, F] T, F = S + 3V (vector block [V][3] in y, z, x)
  const void* ef;     // [G, N, N, EC] T
  const void* bf;     // [G, B, EC] T
  const int64_t* bond_src;  // [G, B]
  const int64_t* bond_dst;  // [G, B]
  const void* w1;     // [NR, H] T (radial rows of the first Dense kernel)
  const float* b1d;   // [H] bias with the bondedness-0 embedding folded in
  const float* b1b;   // [H] bias with the bondedness-1 embedding folded in
  const void* w2;     // [H, W] T
  const float* b2;    // [W]
  const void* pl0;    // [S + V, Sc + Vg] T  rows [o1 | o4]
  const void* pl1;    // [S + 2V, Vg] T      rows [o2 | o3 | o5]
  const void* lin20;  // [Sc, Sc] T
  const void* lin21;  // [Vg, Vg] T
  const void* sk0;    // [S, Sc] T
  const void* sk1;    // [V, Vg] T (unused when V == 0)
  float* out;         // [G, N, Sc + 3Vg] f32 (vector block [Vg][3])
  float* agg_out;     // [G, N, 3, W] f32 or null: normalised aggregates
  float* deg_out;     // [G, N] f32 or null: degree
  int N, B, S, V, Sc, Vg;
};

// entry of the pair list: dst slot (3 bits), bond flag (1 bit), index
__device__ __forceinline__ int encode(int td, int bond, int idx) {
  return (td << 20) | (bond << 19) | idx;
}

template <typename T>
__global__ void __launch_bounds__(MAX_THREADS) conv_block_kernel(Params p) {
  extern __shared__ float smem[];
  const int N = p.N, B = p.B, S = p.S, V = p.V, Sc = p.Sc, Vg = p.Vg;
  const int F = S + 3 * V, W = 2 * S + 3 * V, C0 = Sc + Vg, OF = Sc + 3 * Vg;
  const int nt = blockDim.x, tid = threadIdx.x;
  const int g = blockIdx.y, i0 = blockIdx.x * TD;
  const int nd = min(TD, N - i0);

  const T* x = (const T*)p.x + (long long)g * N * F;
  const T* ef = (const T*)p.ef + (long long)g * N * N * EC;
  const T* bf = (const T*)p.bf + (long long)g * B * EC;
  const int64_t* bsrc = p.bond_src + (long long)g * B;
  const int64_t* bdst = p.bond_dst + (long long)g * B;

  // shared memory carve-up (floats)
  float* w1s = smem;                       // [NR][H]
  float* hs = w1s + NR * H;                // [H][PT]
  float* rs = hs + H * PT;                 // [PT][NR]
  float* ps_sh = rs + PT * NR;             // [PT][3]
  float* deg = ps_sh + PT * 3;             // [TD]
  float* acc = deg + TD;                   // [TD][3][nt]
  float* conv0 = acc + TD * 3 * nt;        // [TD][C0]
  float* conv1 = conv0 + TD * C0;          // [TD][3][Vg]
  float* scal = conv1 + TD * 3 * Vg;       // [TD][Sc]
  float* gated = scal + TD * Sc;           // [TD][3][Vg]
  int* ps_src = (int*)(gated + TD * 3 * Vg);  // [PT]
  int* ps_td = ps_src + PT;                // [PT]
  int* list = ps_td + PT;                  // [TD * N + B]
  int* n_list = list + TD * N + B;         // [1]

  for (int k = tid; k < NR * H; k += nt) w1s[k] = ld((const T*)p.w1 + k);
  for (int k = tid; k < TD * 3 * nt; k += nt) acc[k] = 0.0f;

  // this thread's radial output channel: layer-2 column in registers
  const int c = tid;
  const bool has_c = c < W;
  float w2r[H];
#pragma unroll
  for (int k = 0; k < H; ++k) w2r[k] = has_c ? ld((const T*)p.w2 + (long long)k * W + c) : 0.0f;
  const float b2c = has_c ? p.b2[c] : 0.0f;

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
        if (a) list[count + __popc(m & lt)] = encode(td, 0, j);
        count += __popc(m);
        dcount += __popc(m);
      }
      for (int b0 = 0; b0 < B; b0 += 32) {
        int b = b0 + lane;
        bool a = b < B && bdst[b] == i && ld(bf + (long long)b * EC + 3) > 0.5f;
        unsigned m = __ballot_sync(0xffffffffu, a);
        if (a) list[count + __popc(m & lt)] = encode(td, 1, b);
        count += __popc(m);
        dcount += __popc(m);
      }
      if (lane == 0) deg[td] = (float)dcount;
    }
    if (lane == 0) *n_list = count;
  }
  __syncthreads();
  const int nl = *n_list;

  int cur = -1;
  float a0 = 0.0f, a1 = 0.0f, a2 = 0.0f;
  auto flush = [&]() {
    if (cur >= 0 && has_c) {
      acc[(cur * 3 + 0) * nt + c] += a0;
      acc[(cur * 3 + 1) * nt + c] += a1;
      acc[(cur * 3 + 2) * nt + c] += a2;
    }
    a0 = a1 = a2 = 0.0f;
  };
  const float kInvSqrt3 = 0.57735026918962576f, kInvSqrt2 = 0.70710678118654752f;

  for (int t0 = 0; t0 < nl; t0 += PT) {
    const int np = min(PT, nl - t0);
    // stage the tile's pair geometry and radial features
    if (tid < PT) {
      int src = 0, td = 0;
      float s0 = 0.0f, s1 = 0.0f, s2 = 0.0f;
      if (tid < np) {
        int e = list[t0 + tid];
        td = e >> 20;
        int idx = e & ((1 << 19) - 1);
        const T* fp;
        if (e & (1 << 19)) {
          fp = bf + (long long)idx * EC;
          src = (int)bsrc[idx];
        } else {
          fp = ef + ((long long)(i0 + td) * N + idx) * EC;
          src = idx;
        }
        s0 = ld(fp + 0);
        s1 = ld(fp + 1);
        s2 = ld(fp + 2);
      }
      ps_src[tid] = src;
      ps_td[tid] = td;
      ps_sh[tid * 3 + 0] = s0;
      ps_sh[tid * 3 + 1] = s1;
      ps_sh[tid * 3 + 2] = s2;
    }
    for (int o = tid; o < PT * NR; o += nt) {
      int q = o / NR, k = o % NR;
      float v = 0.0f;
      if (q < np) {
        int e = list[t0 + q];
        int idx = e & ((1 << 19) - 1);
        const T* fp = (e & (1 << 19)) ? bf + (long long)idx * EC
                                      : ef + ((long long)(i0 + (e >> 20)) * N + idx) * EC;
        v = ld(fp + 4 + k);
      }
      rs[q * NR + k] = v;
    }
    __syncthreads();
    // radial layer 1: h = silu(r @ w1 + b1), rounded to T
    for (int o = tid; o < PT * H; o += nt) {
      int q = o / H, m = o % H;
      float h = 0.0f;
      if (q < np) {
        bool bond = (list[t0 + q] >> 19) & 1;
        h = bond ? p.b1b[m] : p.b1d[m];
        float s = 0.0f;
#pragma unroll 8
        for (int k = 0; k < NR; ++k) s += rs[q * NR + k] * w1s[k * H + m];
        h = rnd<T>((h + s) * sigmoidf(h + s));
      }
      hs[m * PT + q] = h;
    }
    __syncthreads();
    // radial layer 2 for channel c, then the channel's messages
    if (has_c) {
      for (int q0 = 0; q0 < np; q0 += 4) {
        float wq[4] = {b2c, b2c, b2c, b2c};
#pragma unroll
        for (int k = 0; k < H; ++k) {
          float4 hv = *reinterpret_cast<const float4*>(hs + k * PT + q0);
          wq[0] += w2r[k] * hv.x;
          wq[1] += w2r[k] * hv.y;
          wq[2] += w2r[k] * hv.z;
          wq[3] += w2r[k] * hv.w;
        }
        const int qn = min(4, np - q0);
        for (int u = 0; u < qn; ++u) {
          const int q = q0 + u;
          const float w = rnd<T>(wq[u]);
          const int td = ps_td[q];
          if (td != cur) {
            flush();
            cur = td;
          }
          const T* xs = x + (long long)ps_src[q] * F;
          const float shy = ps_sh[q * 3 + 0], shz = ps_sh[q * 3 + 1], shx = ps_sh[q * 3 + 2];
          if (c < S) {
            a0 += w * ld(xs + c);
          } else if (c < 2 * S) {
            float t = w * ld(xs + (c - S));
            a0 += t * shy;
            a1 += t * shz;
            a2 += t * shx;
          } else {
            const int v = (c - 2 * S) % V, path = (c - 2 * S) / V;
            const float vy = ld(xs + S + 3 * v), vz = ld(xs + S + 3 * v + 1),
                        vx = ld(xs + S + 3 * v + 2);
            if (path == 0) {
              a0 += w * vy;
              a1 += w * vz;
              a2 += w * vx;
            } else if (path == 1) {
              a0 += w * (vy * shy + vz * shz + vx * shx) * kInvSqrt3;
            } else {
              a0 += w * (vz * shx - vx * shz) * kInvSqrt2;
              a1 += w * (vx * shy - vy * shx) * kInvSqrt2;
              a2 += w * (vy * shz - vz * shy) * kInvSqrt2;
            }
          }
        }
      }
    }
    __syncthreads();
  }
  flush();
  __syncthreads();

  // mean over the combined degree, rounded to T (in place)
  for (int k = tid; k < nd * 3 * nt; k += nt) {
    int td = k / (3 * nt);
    acc[k] = rnd<T>(acc[k] * (1.0f / fmaxf(deg[td], 1.0f)));
  }
  __syncthreads();
  if (p.agg_out != nullptr) {
    for (int k = tid; k < nd * 3 * W; k += nt) {
      int td = k / (3 * W), comp = (k / W) % 3, ch = k % W;
      p.agg_out[(((long long)g * N + i0 + td) * 3 + comp) * W + ch] = acc[(td * 3 + comp) * nt + ch];
    }
    if (tid < nd) p.deg_out[(long long)g * N + i0 + tid] = deg[tid];
  }
  // aggregate views: acc[(td * 3 + comp) * nt + channel]
  auto agg = [&](int td, int comp, int ch) { return acc[(td * 3 + comp) * nt + ch]; };

  // post-linear: conv0 = [o1 | o4] @ pl0, conv1_comp = [o2 | o3 | o5]_comp @ pl1
  const T* pl0 = (const T*)p.pl0;
  const T* pl1 = (const T*)p.pl1;
  for (int o = tid; o < nd * C0; o += nt) {
    int td = o / C0, q = o % C0;
    float s = 0.0f;
    for (int u = 0; u < S; ++u) s += agg(td, 0, u) * ld(pl0 + (long long)u * C0 + q);
    for (int v = 0; v < V; ++v)
      s += agg(td, 0, 2 * S + V + v) * ld(pl0 + (long long)(S + v) * C0 + q);
    conv0[td * C0 + q] = s;
  }
  for (int o = tid; o < nd * 3 * Vg; o += nt) {
    int td = o / (3 * Vg), comp = (o / Vg) % 3, q = o % Vg;
    float s = 0.0f;
    for (int u = 0; u < S; ++u) s += agg(td, comp, S + u) * ld(pl1 + (long long)u * Vg + q);
    for (int v = 0; v < V; ++v) {
      s += agg(td, comp, 2 * S + v) * ld(pl1 + (long long)(S + v) * Vg + q);
      s += agg(td, comp, 2 * S + 2 * V + v) * ld(pl1 + (long long)(S + V + v) * Vg + q);
    }
    conv1[(td * 3 + comp) * Vg + q] = s;
  }
  __syncthreads();
  // gate: LeakyReLU(0.01) on the scalars, sigmoid gates on the vectors
  for (int o = tid; o < nd * Sc; o += nt) {
    int td = o / Sc, q = o % Sc;
    float v = conv0[td * C0 + q];
    scal[o] = rnd<T>(v >= 0.0f ? v : 0.01f * v);
  }
  for (int o = tid; o < nd * 3 * Vg; o += nt) {
    int td = o / (3 * Vg), q = o % Vg;
    gated[o] = rnd<T>(conv1[o] * sigmoidf(conv0[td * C0 + Sc + q]));
  }
  __syncthreads();
  // second linear + linear skip of the block input
  const T* lin20 = (const T*)p.lin20;
  const T* lin21 = (const T*)p.lin21;
  const T* sk0 = (const T*)p.sk0;
  const T* sk1 = (const T*)p.sk1;
  for (int o = tid; o < nd * Sc; o += nt) {
    int td = o / Sc, q = o % Sc;
    const T* xi = x + (long long)(i0 + td) * F;
    float s = 0.0f;
    for (int k = 0; k < Sc; ++k) s += scal[td * Sc + k] * ld(lin20 + (long long)k * Sc + q);
    for (int u = 0; u < S; ++u) s += ld(xi + u) * ld(sk0 + (long long)u * Sc + q);
    p.out[((long long)g * N + i0 + td) * OF + q] = s;
  }
  for (int o = tid; o < nd * 3 * Vg; o += nt) {
    int td = o / (3 * Vg), comp = (o / Vg) % 3, q = o % Vg;
    const T* xi = x + (long long)(i0 + td) * F;
    float s = 0.0f;
    for (int k = 0; k < Vg; ++k)
      s += gated[(td * 3 + comp) * Vg + k] * ld(lin21 + (long long)k * Vg + q);
    for (int v = 0; v < V; ++v) s += ld(xi + S + 3 * v + comp) * ld(sk1 + (long long)v * Vg + q);
    p.out[((long long)g * N + i0 + td) * OF + Sc + 3 * q + comp] = s;
  }
}

int threads_for(int W) {
  int t = ((W + 31) / 32) * 32;
  return t < 64 ? 64 : t;
}

size_t smem_bytes(int N, int B, int nt, int Sc, int Vg) {
  size_t floats = NR * H + H * PT + PT * NR + PT * 3 + TD + (size_t)TD * 3 * nt +
                  (size_t)TD * (Sc + Vg) + (size_t)TD * 3 * Vg + (size_t)TD * Sc +
                  (size_t)TD * 3 * Vg;
  size_t ints = 2 * PT + (size_t)TD * N + B + 1;
  return (floats + ints) * 4;
}

template <typename T>
int launch(const Params& p, int G, void* stream) {
  const int W = 2 * p.S + 3 * p.V;
  const int nt = threads_for(W);
  if (nt > MAX_THREADS || p.N >= (1 << 19) || p.B >= (1 << 19)) return (int)cudaErrorInvalidValue;
  if (G == 0 || p.N == 0) return 0;
  size_t smem = smem_bytes(p.N, p.B, nt, p.Sc, p.Vg);
  cudaError_t err = cudaFuncSetAttribute(conv_block_kernel<T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((p.N + TD - 1) / TD, G);
  conv_block_kernel<T><<<grid, nt, smem, (cudaStream_t)stream>>>(p);
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
  p.w1 = w1;
  p.b1d = (const float*)b1d;
  p.b1b = (const float*)b1b;
  p.w2 = w2;
  p.b2 = (const float*)b2;
  p.pl0 = pl0;
  p.pl1 = pl1;
  p.lin20 = lin20;
  p.lin21 = lin21;
  p.sk0 = sk0;
  p.sk1 = sk1;
  p.out = (float*)out;
  p.agg_out = (float*)agg_out;
  p.deg_out = (float*)deg_out;
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
    return launch<TYPE>(p, G, stream);                                                       \
  }

CONV_BLOCK_ENTRY(conv_block_f32, float)
CONV_BLOCK_ENTRY(conv_block_bf16, __nv_bfloat16)
