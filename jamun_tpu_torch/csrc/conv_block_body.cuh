// Device code of one separable ConvBlock (l <= 1, uvu) for a CTA that owns
// td destination atoms of one graph, as FP32 FMAs. Its callers: the f32
// builds of the per-layer kernel (conv_block.cu, whose layer mode stops
// after the post-linear), of the whole-model kernel (e3_stack.cu) and of the
// tiled kernel (fused_block_tiled.cu), and, up to the messages, both builds
// of the sparse messages kernel (nbr_conv.cu) and the f32 build of the dense
// messages kernel (dense_conv.cu). The bf16 builds of conv_block.cu,
// e3_stack.cu, fused_block_tiled.cu and dense_conv.cu take the tensor-core
// steps of conv_block_mma.cuh instead, which use this header's list
// encoding, Scratch, ChannelSum, flush and normalise.
//
// The caller lists the visited pairs of its atoms (dense pairs inside the
// cutoff and bonds, dst-major) and stages each tile of PT pairs: source
// atom, dst slot, spherical harmonics and radial basis values into shared
// memory. From there on both kernels run the same steps:
//   radial_layer1  h = silu(r @ w1 + b1), rounded to T
//   messages       w = h @ w2 + b2 for the thread's radial channel, then the
//                  channel's uvu messages, accumulated per dst atom
//   normalise      mean over the combined degree, rounded to T
//   post_linear    the post-linear alone (conv_block.cu's layer mode)
//   epilogue       post-linear, gate, second linear, linear skip
// The block input is read through an accessor x(atom, channel) -> float
// (GlobalRows: rows in device memory; SharedRows: f32 rows in shared memory)
// and the output leaves through out(dst slot, column, value).
//
// Thread c owns radial output channel c: its 64 layer-2 weights sit in
// registers and its messages accumulate in three registers. Rounding
// points follow the TPU kernel `_conv_block_body`
// (jamun_tpu/ops/pallas/packed_conv.py): radial features and h in the
// compute type T, message weights in T, f32 accumulation, the normalised
// aggregates in T, the gate's scalars and gated vectors in T, f32 output.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace conv_block {

constexpr int NR = 32;   // radial basis functions (edge_attr_dim / 2)
constexpr int H = 64;    // radial MLP hidden width (edge_attr_dim)
constexpr int EC = 4 + NR;
constexpr int TD = 8;    // destination atoms per CTA of the per-layer kernel
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

// entry of the pair list: dst slot, bond flag (1 bit), index (19 bits)
constexpr int MAX_INDEX = 1 << 19;
__device__ __forceinline__ int encode(int td, int bond, int idx) {
  return (td << 20) | (bond << 19) | idx;
}
__device__ __forceinline__ int entry_slot(int e) { return e >> 20; }
__device__ __forceinline__ bool entry_is_bond(int e) { return (e >> 19) & 1; }
__device__ __forceinline__ int entry_index(int e) { return e & (MAX_INDEX - 1); }

// one block's weights, [in, out] matrices in T (W = 2S + 3V)
struct Weights {
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
};

// block input rows in device memory, [atoms, F] T
template <typename T>
struct GlobalRows {
  const T* x;
  int F;
  __device__ __forceinline__ float operator()(int atom, int ch) const {
    return ld(x + (long long)atom * F + ch);
  }
};

// block input rows in shared memory, [atoms, F] f32
struct SharedRows {
  const float* x;
  int F;
  __device__ __forceinline__ float operator()(int atom, int ch) const { return x[atom * F + ch]; }
};

// the CTA's working set in shared memory (4-byte words) for td dst atoms
struct Scratch {
  float* w1s;    // [NR][H]
  float* hs;     // [H][PT]
  float* rs;     // [PT][NR]
  float* ps_sh;  // [PT][3]
  float* deg;    // [td]
  float* acc;    // [td][3][nt]
  float* conv0;  // [td][Sc + Vg]
  float* conv1;  // [td][3][Vg]
  float* scal;   // [td][Sc]
  float* gated;  // [td][3][Vg]
  int* ps_src;   // [PT]
  int* ps_td;    // [PT]
  int* list;     // [td * N + B]
  int* n_list;   // [1]
};

__host__ __device__ inline size_t scratch_words(int N, int B, int nt, int Sc, int Vg, int td) {
  size_t floats = NR * H + H * PT + PT * NR + PT * 3 + td + (size_t)td * 3 * nt +
                  (size_t)td * (Sc + Vg) + (size_t)td * 3 * Vg + (size_t)td * Sc +
                  (size_t)td * 3 * Vg;
  size_t ints = 2 * PT + (size_t)td * N + B + 1;
  return floats + ints;
}

__device__ __forceinline__ Scratch carve(float* smem, int N, int B, int nt, int Sc, int Vg,
                                         int td) {
  Scratch s;
  s.w1s = smem;
  s.hs = s.w1s + NR * H;
  s.rs = s.hs + H * PT;
  s.ps_sh = s.rs + PT * NR;
  s.deg = s.ps_sh + PT * 3;
  s.acc = s.deg + td;
  s.conv0 = s.acc + td * 3 * nt;
  s.conv1 = s.conv0 + td * (Sc + Vg);
  s.scal = s.conv1 + td * 3 * Vg;
  s.gated = s.scal + td * Sc;
  s.ps_src = (int*)(s.gated + td * 3 * Vg);
  s.ps_td = s.ps_src + PT;
  s.list = s.ps_td + PT;
  s.n_list = s.list + td * N + B;
  return s;
}

inline int threads_for(int W) {
  int t = ((W + 31) / 32) * 32;
  return t < 64 ? 64 : t;
}

// stage the first radial layer (A input rows), clear the accumulators and
// load the thread's layer-2 column (thread tid owns radial channel tid < W)
template <typename T, int A = NR>
__device__ __forceinline__ void load_weights(const Scratch& s, const Weights& w, int W, int td,
                                             int tid, int nt, float (&w2r)[H], float& b2c) {
  for (int k = tid; k < A * H; k += nt) s.w1s[k] = ld((const T*)w.w1 + k);
  for (int k = tid; k < td * 3 * nt; k += nt) s.acc[k] = 0.0f;
  const bool has_c = tid < W;
#pragma unroll
  for (int k = 0; k < H; ++k)
    w2r[k] = has_c ? ld((const T*)w.w2 + (long long)k * W + tid) : 0.0f;
  b2c = has_c ? w.b2[tid] : 0.0f;
}

// radial layer 1 of a tile: h = silu(r @ w1 + b1), rounded to T, over A
// input features per pair (rs [PT][A], w1s [A][H]); `tile` points at the
// tile's np list entries
template <typename T, int A = NR>
__device__ __forceinline__ void radial_layer1(const Scratch& s, const Weights& w, const int* tile,
                                              int np, int tid, int nt) {
  for (int o = tid; o < PT * H; o += nt) {
    int q = o / H, m = o % H;
    float h = 0.0f;
    if (q < np) {
      h = entry_is_bond(tile[q]) ? w.b1b[m] : w.b1d[m];
      float sum = 0.0f;
#pragma unroll 8
      for (int k = 0; k < A; ++k) sum += s.rs[q * A + k] * s.w1s[k * H + m];
      h = rnd<T>((h + sum) * sigmoidf(h + sum));
    }
    s.hs[m * PT + q] = h;
  }
}

// the running sum of one radial channel's messages into one dst slot
struct ChannelSum {
  int cur = -1;
  float a0 = 0.0f, a1 = 0.0f, a2 = 0.0f;
};

__device__ __forceinline__ void flush(const Scratch& s, ChannelSum& st, int c, bool has_c, int nt) {
  if (st.cur >= 0 && has_c) {
    s.acc[(st.cur * 3 + 0) * nt + c] += st.a0;
    s.acc[(st.cur * 3 + 1) * nt + c] += st.a1;
    s.acc[(st.cur * 3 + 2) * nt + c] += st.a2;
  }
  st.a0 = st.a1 = st.a2 = 0.0f;
}

// radial layer 2 for channel c over a tile, then the channel's messages
template <typename T, typename X>
__device__ __forceinline__ void messages(const Scratch& s, const X& x, const float (&w2r)[H],
                                         float b2c, int np, int c, int S, int V, int nt,
                                         ChannelSum& st) {
  const float kInvSqrt3 = 0.57735026918962576f, kInvSqrt2 = 0.70710678118654752f;
  for (int q0 = 0; q0 < np; q0 += 4) {
    float wq[4] = {b2c, b2c, b2c, b2c};
#pragma unroll
    for (int k = 0; k < H; ++k) {
      float4 hv = *reinterpret_cast<const float4*>(s.hs + k * PT + q0);
      wq[0] += w2r[k] * hv.x;
      wq[1] += w2r[k] * hv.y;
      wq[2] += w2r[k] * hv.z;
      wq[3] += w2r[k] * hv.w;
    }
    const int qn = min(4, np - q0);
    for (int u = 0; u < qn; ++u) {
      const int q = q0 + u;
      const float w = rnd<T>(wq[u]);
      const int td = s.ps_td[q];
      if (td != st.cur) {
        flush(s, st, c, true, nt);
        st.cur = td;
      }
      const int src = s.ps_src[q];
      const float shy = s.ps_sh[q * 3 + 0], shz = s.ps_sh[q * 3 + 1], shx = s.ps_sh[q * 3 + 2];
      if (c < S) {
        st.a0 += w * x(src, c);
      } else if (c < 2 * S) {
        float t = w * x(src, c - S);
        st.a0 += t * shy;
        st.a1 += t * shz;
        st.a2 += t * shx;
      } else {
        const int v = (c - 2 * S) % V, path = (c - 2 * S) / V;
        const float vy = x(src, S + 3 * v), vz = x(src, S + 3 * v + 1), vx = x(src, S + 3 * v + 2);
        if (path == 0) {
          st.a0 += w * vy;
          st.a1 += w * vz;
          st.a2 += w * vx;
        } else if (path == 1) {
          st.a0 += w * (vy * shy + vz * shz + vx * shx) * kInvSqrt3;
        } else {
          st.a0 += w * (vz * shx - vx * shz) * kInvSqrt2;
          st.a1 += w * (vx * shy - vy * shx) * kInvSqrt2;
          st.a2 += w * (vy * shz - vz * shy) * kInvSqrt2;
        }
      }
    }
  }
}

// mean over the combined degree, rounded to T (in place)
template <typename T>
__device__ __forceinline__ void normalise(const Scratch& s, int nd, int tid, int nt) {
  for (int k = tid; k < nd * 3 * nt; k += nt) {
    int td = k / (3 * nt);
    s.acc[k] = rnd<T>(s.acc[k] * (1.0f / fmaxf(s.deg[td], 1.0f)));
  }
}

// the accumulator (component, radial channel) of column col of the packed
// message row [Sx0e | Sx1e | Vx1e | Vx0e | Vx1e] (4S + 7V columns, l = 1
// interleaved as (mul, component))
__device__ __forceinline__ void column_source(int col, int S, int V, int& comp, int& ch) {
  if (col < S) {
    comp = 0;
    ch = col;
  } else if (col < 4 * S) {
    comp = (col - S) % 3;
    ch = S + (col - S) / 3;
  } else if (col < 4 * S + 3 * V) {
    comp = (col - 4 * S) % 3;
    ch = 2 * S + (col - 4 * S) / 3;
  } else if (col < 4 * S + 4 * V) {
    comp = 0;
    ch = 2 * S + V + (col - 4 * S - 3 * V);
  } else {
    comp = (col - 4 * S - 4 * V) % 3;
    ch = 2 * S + 2 * V + (col - 4 * S - 4 * V) / 3;
  }
}

// post-linear of the normalised aggregates of the nd atoms:
// conv0 [td][C0] = [o1 | o4] @ pl0 ([S + V, C0]) and
// conv1 [td][3][V1] = [o2 | o3 | o5]_comp @ pl1 ([S + 2V, V1])
template <typename T>
__device__ __forceinline__ void post_linear(const Scratch& s, const Weights& w, int nd, int S,
                                            int V, int C0, int V1, int tid, int nt) {
  // aggregate views: acc[(td * 3 + comp) * nt + channel]
  auto agg = [&](int td, int comp, int ch) { return s.acc[(td * 3 + comp) * nt + ch]; };
  const T* pl0 = (const T*)w.pl0;
  const T* pl1 = (const T*)w.pl1;
  for (int o = tid; o < nd * C0; o += nt) {
    int td = o / C0, q = o % C0;
    float sum = 0.0f;
    for (int u = 0; u < S; ++u) sum += agg(td, 0, u) * ld(pl0 + (long long)u * C0 + q);
    for (int v = 0; v < V; ++v)
      sum += agg(td, 0, 2 * S + V + v) * ld(pl0 + (long long)(S + v) * C0 + q);
    s.conv0[td * C0 + q] = sum;
  }
  for (int o = tid; o < nd * 3 * V1; o += nt) {
    int td = o / (3 * V1), comp = (o / V1) % 3, q = o % V1;
    float sum = 0.0f;
    for (int u = 0; u < S; ++u) sum += agg(td, comp, S + u) * ld(pl1 + (long long)u * V1 + q);
    for (int v = 0; v < V; ++v) {
      sum += agg(td, comp, 2 * S + v) * ld(pl1 + (long long)(S + v) * V1 + q);
      sum += agg(td, comp, 2 * S + 2 * V + v) * ld(pl1 + (long long)(S + V + v) * V1 + q);
    }
    s.conv1[(td * 3 + comp) * V1 + q] = sum;
  }
}

// post-linear, gate, second linear and the linear skip of the block input
// for the nd atoms from i0 on; out(td, column, value) takes each element of
// the [Sc + 3Vg] output row (vector block [Vg][3]) once
template <typename T, typename X, typename Out>
__device__ __forceinline__ void epilogue(const Scratch& s, const Weights& w, const X& x, Out out,
                                         int i0, int nd, int S, int V, int Sc, int Vg, int tid,
                                         int nt) {
  const int C0 = Sc + Vg;
  post_linear<T>(s, w, nd, S, V, C0, Vg, tid, nt);
  __syncthreads();
  // gate: LeakyReLU(0.01) on the scalars, sigmoid gates on the vectors
  for (int o = tid; o < nd * Sc; o += nt) {
    int td = o / Sc, q = o % Sc;
    float v = s.conv0[td * C0 + q];
    s.scal[o] = rnd<T>(v >= 0.0f ? v : 0.01f * v);
  }
  for (int o = tid; o < nd * 3 * Vg; o += nt) {
    int td = o / (3 * Vg), q = o % Vg;
    s.gated[o] = rnd<T>(s.conv1[o] * sigmoidf(s.conv0[td * C0 + Sc + q]));
  }
  __syncthreads();
  // second linear + linear skip of the block input
  const T* lin20 = (const T*)w.lin20;
  const T* lin21 = (const T*)w.lin21;
  const T* sk0 = (const T*)w.sk0;
  const T* sk1 = (const T*)w.sk1;
  for (int o = tid; o < nd * Sc; o += nt) {
    int td = o / Sc, q = o % Sc;
    float sum = 0.0f;
    for (int k = 0; k < Sc; ++k) sum += s.scal[td * Sc + k] * ld(lin20 + (long long)k * Sc + q);
    for (int u = 0; u < S; ++u) sum += x(i0 + td, u) * ld(sk0 + (long long)u * Sc + q);
    out(td, q, sum);
  }
  for (int o = tid; o < nd * 3 * Vg; o += nt) {
    int td = o / (3 * Vg), comp = (o / Vg) % 3, q = o % Vg;
    float sum = 0.0f;
    for (int k = 0; k < Vg; ++k)
      sum += s.gated[(td * 3 + comp) * Vg + k] * ld(lin21 + (long long)k * Vg + q);
    for (int v = 0; v < V; ++v)
      sum += x(i0 + td, S + 3 * v + comp) * ld(sk1 + (long long)v * Vg + q);
    out(td, Sc + 3 * q + comp, sum);
  }
}

}  // namespace conv_block
