// Tensor-core (mma.sync bf16 -> f32) steps of one separable ConvBlock, for
// the bf16 builds of the per-layer kernel (conv_block.cu, block and layer
// modes), the whole-model kernel (e3_stack.cu), through the pair loop of
// tiled_pairs_mma.cuh the tiled ConvBlock (fused_block_tiled.cu) and the
// dense messages (dense_conv.cu, no epilogue), and the sparse messages
// (nbr_conv.cu: layer 1 A = 64 or 32 wide, no epilogue). The f32 builds
// keep conv_block_body.cuh's FP32 FMA steps.
//
// What moves to the tensor cores (m16n8k16, bf16 operands, f32 sums):
//   radial layer 1   [PT, A] . [A, 64]    -> + b1 (bond or dense row), SiLU,
//                    rounded to bf16 (the FMA path's rounding point) into h
//   radial layer 2   [16, 64] . [64, W]   -> + b2, rounded to bf16: the
//                    message weights of half a tile, stored as bf16
//   the epilogue     post-linear, second linear and linear skip, and in the
//                    whole-model kernel the head's products: [atoms padded
//                    to 16 (or atom x component rows), K] . [K, N] with B
//                    staged in shared memory by the whole CTA (16-byte
//                    loads) where the CTAs per SM stay the same, else read
//                    from device memory (L2), four k-tiles at a time
// The messages step keeps thread c on radial channel c: it reads w[q][c]
// from the tile and accumulates into the same ChannelSum and flush as the
// FMA path, in the same order, with its fused multiply-adds written out.
// Every rounding point of the FMA path is kept; only the order of f32 sums
// inside a product differs.
//
// The steps are short and latency-bound (a CTA owns 11-16 atoms and a few
// tiles of pairs), so each issues its independent reads together: the
// weights as 16-byte loads, the inputs of QB pairs before their sums (one
// 16-byte broadcast of a pair's data), the epilogue's B operands staged
// whole. On the H100 (builds that skip one step) the message loop is then
// the largest step, about a third of the time, and it is bound by its
// instructions per (pair, channel), not by its loads or the tensor cores.
//
// Layouts in shared memory (bf16 elements):
//   A operands: row-major [M][ld_of(K)], K padded to 16 with zeros, and 8
//     more columns so that the eight rows a fragment load touches sit in
//     eight different bank groups (ld/2 is 4 mod 8 words);
//   w1: n-major [64][ld_of(A)] (B of layer 1, transposed on the load);
//   w2: n-major [Wp][64], Wp = W rounded up to 8 (zero rows past W), with
//     its 16-byte chunks XOR-swizzled by (n & 7), conflict-free without
//     padding;
//   the message weights: [16][ld_of(Wp)], half a tile at a time; warp w
//     writes and reads only its own 32 columns (its threads' channels), so
//     layer 2 and the messages of a tile need a __syncwarp and no CTA
//     barrier.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "conv_block_body.cuh"

namespace conv_block {
namespace mma {

using bf16 = __nv_bfloat16;

// shared memory one block may use on the H100 (227 KB)
constexpr size_t MAX_SMEM_BYTES = 232448;

// whether the epilogue stages its B operands: where the CTA still fits and
// as many CTAs share an SM as without (228 KB per SM, 1 KB of it reserved
// per CTA)
__host__ __device__ inline bool stage_fits(size_t staged, size_t unstaged) {
  constexpr size_t SM_SMEM = 233472;
  return staged <= MAX_SMEM_BYTES && SM_SMEM / (staged + 1024) >= SM_SMEM / (unstaged + 1024);
}

// leading dimension of an operand tile with k columns (see above)
__host__ __device__ constexpr int ld_of(int k) { return ((k + 15) / 16) * 16 + 8; }
__host__ __device__ constexpr int round_up(int v, int m) { return ((v + m - 1) / m) * m; }
__host__ __device__ constexpr size_t align16(size_t bytes) { return (bytes + 15) / 16 * 16; }

__device__ __forceinline__ uint32_t pack2(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t pack2(bf16 lo, bf16 hi) {
  return (uint32_t)__bfloat16_as_ushort(lo) | ((uint32_t)__bfloat16_as_ushort(hi) << 16);
}

// d += a . b for one m16n8k16 tile
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// the A fragment of rows m0..m0+15, columns k0..k0+15 of a row-major tile
__device__ __forceinline__ void load_a(uint32_t (&a)[4], const bf16* A, int lda, int m0, int k0,
                                       int lane) {
  const bf16* p = A + (m0 + (lane >> 2)) * lda + k0 + 2 * (lane & 3);
  a[0] = *reinterpret_cast<const uint32_t*>(p);
  a[1] = *reinterpret_cast<const uint32_t*>(p + 8 * lda);
  a[2] = *reinterpret_cast<const uint32_t*>(p + 8);
  a[3] = *reinterpret_cast<const uint32_t*>(p + 8 * lda + 8);
}

// the B fragment of columns n0..n0+7, rows k0..k0+15 of an n-major tile
__device__ __forceinline__ void load_bt(uint32_t (&b)[2], const bf16* Bt, int ldb, int n0, int k0,
                                        int lane) {
  const bf16* p = Bt + (n0 + (lane >> 2)) * ldb + k0 + 2 * (lane & 3);
  b[0] = *reinterpret_cast<const uint32_t*>(p);
  b[1] = *reinterpret_cast<const uint32_t*>(p + 8);
}

// element (n, k) of the swizzled n-major layer-2 weights [Wp][H]
__device__ __forceinline__ int w2_at(int n, int k) {
  return n * H + ((((k >> 3) ^ (n & 7))) << 3) + (k & 7);
}

// the B fragment of columns n0..n0+7, rows k0..k0+15 of a row-major
// [K][ldb] matrix in device memory, zero past K rows or N columns
__device__ __forceinline__ void load_b_global(uint32_t (&b)[2], const bf16* B, int ldb, int K,
                                              int N, int n0, int k0, int lane) {
  const int n = n0 + (lane >> 2), k = k0 + 2 * (lane & 3);
  const unsigned short* p = reinterpret_cast<const unsigned short*>(B);
  unsigned short v[4] = {0, 0, 0, 0};
  if (n < N) {
    if (k < K) v[0] = __ldg(p + (long long)k * ldb + n);
    if (k + 1 < K) v[1] = __ldg(p + (long long)(k + 1) * ldb + n);
    if (k + 8 < K) v[2] = __ldg(p + (long long)(k + 8) * ldb + n);
    if (k + 9 < K) v[3] = __ldg(p + (long long)(k + 9) * ldb + n);
  }
  b[0] = (uint32_t)v[0] | ((uint32_t)v[1] << 16);
  b[1] = (uint32_t)v[2] | ((uint32_t)v[3] << 16);
}

// ---------------------------------------------------------------------------
// the pair loop

// the pair loop's operand tiles (bf16), in the union region of the caller;
// A is the width of layer 1's input: the NR radial basis values of a dense
// pair or bond, or a sparse slot's edge attributes (nbr_conv.cu: 64, or 32)
struct PairTiles {
  bf16* w1t;  // [H][ld_of(A)]
  bf16* w2t;  // [Wp][H], swizzled
  bf16* rs;   // [PT][ld_of(A)] layer 1's input of the tile
  bf16* h;    // [PT][ld_of(H)]
  bf16* wt;   // [16][ldw] message weights of half a tile
  int Wp, ldw;
};

template <int A = NR>
__host__ __device__ inline size_t pair_tiles_bytes(int W) {
  const int Wp = round_up(W, 8);
  return align16((size_t)H * ld_of(A) * 2) + align16((size_t)Wp * H * 2) +
         align16((size_t)PT * ld_of(A) * 2) + align16((size_t)PT * ld_of(H) * 2) +
         align16((size_t)16 * ld_of(Wp) * 2);
}

template <int A = NR>
__device__ __forceinline__ PairTiles carve_pair_tiles(char* base, int W) {
  PairTiles t;
  t.Wp = round_up(W, 8);
  t.ldw = ld_of(t.Wp);
  t.w1t = reinterpret_cast<bf16*>(base);
  base += align16((size_t)H * ld_of(A) * 2);
  t.w2t = reinterpret_cast<bf16*>(base);
  base += align16((size_t)t.Wp * H * 2);
  t.rs = reinterpret_cast<bf16*>(base);
  base += align16((size_t)PT * ld_of(A) * 2);
  t.h = reinterpret_cast<bf16*>(base);
  base += align16((size_t)PT * ld_of(H) * 2);
  t.wt = reinterpret_cast<bf16*>(base);
  return t;
}

// one block's radial weights into the tiles (transposed; w2 rows past W
// zero); the caller barriers before the first tile. 16 bytes (8 columns of
// one row) per load where the rows allow it, every thread's loads issued
// together; the input row varies fastest across a warp, so the transposed
// stores fall into different banks
template <int A = NR>
__device__ __forceinline__ void load_pair_weights(const PairTiles& t, const Weights& w, int W,
                                                  int tid, int nt) {
  const bf16* w1 = (const bf16*)w.w1;
  const bf16* w2 = (const bf16*)w.w2;
  constexpr int L1 = ld_of(A);
  if ((((uintptr_t)w1 | (uintptr_t)w2) & 15) == 0 && (W & 7) == 0) {
#pragma unroll 2
    for (int o = tid; o < A * H / 8; o += nt) {  // w1 [A][H] -> w1t [H][L1]
      const int r = o % A, m0 = (o / A) * 8;
      const uint4 v = __ldg(reinterpret_cast<const uint4*>(w1 + r * H + m0));
      const bf16* e = reinterpret_cast<const bf16*>(&v);
#pragma unroll
      for (int k = 0; k < 8; ++k) t.w1t[(m0 + k) * L1 + r] = e[k];
    }
#pragma unroll 8
    for (int o = tid; o < H * (W / 8); o += nt) {  // w2 [H][W] -> w2t [W][H]
      const int r = o % H, n0 = (o / H) * 8;
      const uint4 v = __ldg(reinterpret_cast<const uint4*>(w2 + (long long)r * W + n0));
      const bf16* e = reinterpret_cast<const bf16*>(&v);
#pragma unroll
      for (int k = 0; k < 8; ++k) t.w2t[w2_at(n0 + k, r)] = e[k];
    }
    return;
  }
  for (int k = tid; k < A * H; k += nt) {  // w1 [A][H] -> w1t [H][L1]
    const int r = k / H, m = k % H;
    t.w1t[m * L1 + r] = w1[k];
  }
  for (int k = tid; k < t.Wp * H; k += nt) {  // w2 [H][W] -> w2t [Wp][H]
    const int r = k / t.Wp, n = k % t.Wp;
    t.w2t[w2_at(n, r)] = n < W ? w2[(long long)r * W + n] : __float2bfloat16_rn(0.0f);
  }
}

// radial layer 1 of a tile: h = rnd(silu(rs . w1 + b1)), b1 the bond or
// dense bias of each pair's list entry; 16 output tiles over the warps
template <int A = NR>
__device__ __forceinline__ void radial_layer1(const PairTiles& t, const Weights& w,
                                              const int* tile, int np, int warp, int nwarps,
                                              int lane) {
  constexpr int L1 = ld_of(A), LH = ld_of(H);
  for (int o = warp; o < (PT / 16) * (H / 8); o += nwarps) {
    const int m0 = (o / (H / 8)) * 16, n0 = (o % (H / 8)) * 8;
    float d[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
    for (int k0 = 0; k0 < A; k0 += 16) {
      uint32_t a[4], b[2];
      load_a(a, t.rs, L1, m0, k0, lane);
      load_bt(b, t.w1t, L1, n0, k0, lane);
      mma_bf16(d, a, b);
    }
    const int col = n0 + 2 * (lane & 3);
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int q = m0 + (lane >> 2) + 8 * half;
      const bool bond = q < np && entry_is_bond(tile[q]);
      const float* b1 = bond ? w.b1b : w.b1d;
      const float v0 = d[2 * half] + __ldg(b1 + col), v1 = d[2 * half + 1] + __ldg(b1 + col + 1);
      *reinterpret_cast<uint32_t*>(t.h + q * LH + col) =
          pack2(v0 * sigmoidf(v0), v1 * sigmoidf(v1));
    }
  }
}

// radial layer 2 of the 16 pairs from m0 for this warp's 32 columns:
// w = rnd(h . w2 + b2) into the message-weight tile (row q - m0)
__device__ __forceinline__ void radial_layer2(const PairTiles& t, const float* b2, int W, int m0,
                                              int warp, int lane) {
  constexpr int LH = ld_of(H);
  uint32_t a[H / 16][4];
#pragma unroll
  for (int kk = 0; kk < H / 16; ++kk) load_a(a[kk], t.h, LH, m0, kk * 16, lane);
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int n0 = warp * 32 + j * 8;
    if (n0 >= t.Wp) break;
    float d[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
    for (int kk = 0; kk < H / 16; ++kk) {
      const int n = n0 + (lane >> 2), k = kk * 16 + 2 * (lane & 3);
      uint32_t b[2];
      b[0] = *reinterpret_cast<const uint32_t*>(t.w2t + w2_at(n, k));
      b[1] = *reinterpret_cast<const uint32_t*>(t.w2t + w2_at(n, k + 8));
      mma_bf16(d, a[kk], b);
    }
    const int col = n0 + 2 * (lane & 3);
    const float c0 = col < W ? __ldg(b2 + col) : 0.0f;
    const float c1 = col + 1 < W ? __ldg(b2 + col + 1) : 0.0f;
    const int r = lane >> 2;
    *reinterpret_cast<uint32_t*>(t.wt + r * t.ldw + col) = pack2(d[0] + c0, d[1] + c1);
    *reinterpret_cast<uint32_t*>(t.wt + (r + 8) * t.ldw + col) = pack2(d[2] + c0, d[3] + c1);
  }
}

// what the messages read of pair q of a staged tile, one 16-byte broadcast:
// its spherical harmonics (y, z, x) and, in the last word, dst slot << 16 |
// source atom. The bf16 kernels keep [PT] of them where the FMA kernels keep
// ps_sh ([PT][3]) and ps_td.
__device__ __forceinline__ float4 pair_info(float shy, float shz, float shx, int td, int src) {
  return make_float4(shy, shz, shx, __int_as_float((td << 16) | src));
}

// the source rows of a staged tile, [PT][F] bf16, as the messages read
// them: xq(q, src, ch)
struct TileRows {
  const bf16* x;
  int F;
  __device__ __forceinline__ float operator()(int q, int, int ch) const {
    return __bfloat162float(x[q * F + ch]);
  }
};

// the source rows in device memory, [atoms][F] bf16, read through L2 as the
// messages need them: xq(q, src, ch)
struct SourceRows {
  const bf16* x;
  int F;
  __device__ __forceinline__ float operator()(int, int src, int ch) const {
    return __bfloat162float(x[(long long)src * F + ch]);
  }
};

// the messages of pairs q0..q1-1 for radial channel c: the FMA path's
// messages() with w read from the tile (row q - q0) and the pair's data
// from ps4 (pair_info); xq(q, src, ch) is the source row of pair q. What a
// pair contributes is read for QB pairs at a time before any of them is
// summed, so the reads of the next pairs do not wait behind the flush of an
// earlier one.
template <typename XQ>
__device__ __forceinline__ void messages(const Scratch& s, const float4* ps4, const PairTiles& t,
                                         const XQ& xq, int q0, int q1, int c, int S, int V, int nt,
                                         ChannelSum& st) {
  constexpr int QB = 4;
  const float kInvSqrt3 = 0.57735026918962576f, kInvSqrt2 = 0.70710678118654752f;
  // the channel's path: 0 scalar (0e x 0e), 1 scalar to vector (0e x 1e), 2-4
  // the vector paths (1e x 0e, 1e x 1e -> 0e, 1e x 1e -> 1e); its first input
  const int path = c < S ? 0 : (c < 2 * S ? 1 : 2 + (c - 2 * S) / V);
  const int ch = path == 0 ? c : (path == 1 ? c - S : S + 3 * ((c - 2 * S) % V));
  for (int qb = q0; qb < q1; qb += QB) {
    float w[QB], x0[QB], x1[QB], x2[QB];
    float4 pi[QB];
#pragma unroll
    for (int u = 0; u < QB; ++u) {
      const int q = min(qb + u, q1 - 1);
      pi[u] = ps4[q];
      const int src = __float_as_int(pi[u].w) & 0xffff;
      w[u] = __bfloat162float(t.wt[(q - q0) * t.ldw + c]);
      x0[u] = xq(q, src, ch);
      x1[u] = path >= 2 ? xq(q, src, ch + 1) : 0.0f;
      x2[u] = path >= 2 ? xq(q, src, ch + 2) : 0.0f;
    }
    // every product and sum is written out (fmaf, or a rounded product), so
    // the compiler contracts nothing by itself and every kernel that inlines
    // this step rounds alike: left to the compiler, the vector paths were
    // contracted otherwise in the tiled ConvBlock than in the per-layer
    // kernel, and their bf16 outputs differed in a few atoms
    auto add = [&](int u) {
      const float shy = pi[u].x, shz = pi[u].y, shx = pi[u].z;
      if (path == 0) {
        st.a0 = __fmaf_rn(w[u], x0[u], st.a0);
      } else if (path == 1) {
        const float tt = __fmul_rn(w[u], x0[u]);
        st.a0 = __fmaf_rn(tt, shy, st.a0);
        st.a1 = __fmaf_rn(tt, shz, st.a1);
        st.a2 = __fmaf_rn(tt, shx, st.a2);
      } else {
        const float vy = x0[u], vz = x1[u], vx = x2[u];
        if (path == 2) {
          st.a0 = __fmaf_rn(w[u], vy, st.a0);
          st.a1 = __fmaf_rn(w[u], vz, st.a1);
          st.a2 = __fmaf_rn(w[u], vx, st.a2);
        } else if (path == 3) {
          const float dot = __fmaf_rn(vx, shx, __fmaf_rn(vz, shz, __fmul_rn(vy, shy)));
          st.a0 = __fmaf_rn(__fmul_rn(w[u], dot), kInvSqrt3, st.a0);
        } else {
          const float c0 = __fmaf_rn(vz, shx, -__fmul_rn(vx, shz));
          const float c1 = __fmaf_rn(vx, shy, -__fmul_rn(vy, shx));
          const float c2 = __fmaf_rn(vy, shz, -__fmul_rn(vz, shy));
          st.a0 = __fmaf_rn(__fmul_rn(w[u], c0), kInvSqrt2, st.a0);
          st.a1 = __fmaf_rn(__fmul_rn(w[u], c1), kInvSqrt2, st.a1);
          st.a2 = __fmaf_rn(__fmul_rn(w[u], c2), kInvSqrt2, st.a2);
        }
      }
    };
    // the list is dst-major: a full group whose first and last pairs go to
    // the current dst atom has no flush inside (the common case)
    if (qb + QB <= q1 && (__float_as_int(pi[0].w) >> 16) == st.cur &&
        (__float_as_int(pi[QB - 1].w) >> 16) == st.cur) {
#pragma unroll
      for (int u = 0; u < QB; ++u) add(u);
      continue;
    }
#pragma unroll
    for (int u = 0; u < QB; ++u) {
      if (qb + u >= q1) break;
      const int td = __float_as_int(pi[u].w) >> 16;
      if (td != st.cur) {
        flush(s, st, c, true, nt);
        st.cur = td;
      }
      add(u);
    }
  }
}

// layer 2 and the messages of a staged tile whose layer 1 is done: per
// half tile of 16 pairs, this warp's columns, then its channels' messages
template <typename XQ>
__device__ __forceinline__ void layer2_messages(const Scratch& s, const float4* ps4,
                                                const PairTiles& t, const XQ& xq, const float* b2,
                                                int W, int np, int S, int V, int warp, int lane,
                                                int nt, ChannelSum& st) {
  const int c = warp * 32 + lane;
  for (int m0 = 0; m0 < np; m0 += 16) {
    radial_layer2(t, b2, W, m0, warp, lane);
    __syncwarp();
    if (c < W) mma::messages(s, ps4, t, xq, m0, min(m0 + 16, np), c, S, V, nt, st);
    __syncwarp();
  }
}

// mean over the combined degree, rounded to bf16, in place: conv_block_body's
// normalise with each atom's 1 / degree computed once per thread
__device__ __forceinline__ void normalise(const Scratch& s, int nd, int tid, int nt) {
  for (int td = 0; td < nd; ++td) {
    const float inv = 1.0f / fmaxf(s.deg[td], 1.0f);
#pragma unroll
    for (int comp = 0; comp < 3; ++comp) {
      float* a = s.acc + (td * 3 + comp) * nt + tid;
      *a = rnd<bf16>(*a * inv);
    }
  }
}

// ---------------------------------------------------------------------------
// products over the CTA's atoms

// one operand segment of a row product: A in shared memory (row-major,
// lda = ld_of(K), zero past K), B [K][N] row-major in device memory and,
// where the caller staged it, Bt: the same B n-major in shared memory
// ([round_up(N, 8)][ld_of(K)], zero in columns K.., stage_bt)
struct Segment {
  const bf16* A;
  const bf16* B;
  int K;
  const bf16* Bt = nullptr;
};

// bytes of a staged Bt of B [K][N]
__host__ __device__ inline size_t bt_bytes(int K, int N) {
  return align16((size_t)round_up(N, 8) * ld_of(K) * 2);
}

// B [K][N] (device memory, row-major) -> Bt [round_up(N, 8)][ld_of(K)] in
// shared memory, 16 bytes (8 columns of one row) per load where the rows
// allow, k fastest across a warp so the transposed stores fall into
// different banks; columns K..round_up(K, 16) zero (the A tiles' padding is
// zero, and zero times a stale NaN is NaN). The rows past N are left as they
// are: they only reach output columns that are dropped.
__device__ __forceinline__ void stage_bt(bf16* Bt, const bf16* B, int K, int N, int tid, int nt) {
  const int ldb = ld_of(K);
  if ((N & 7) == 0 && ((uintptr_t)B & 15) == 0) {
#pragma unroll 4
    for (int o = tid; o < K * (N / 8); o += nt) {
      const int k = o % K, n0 = (o / K) * 8;
      const uint4 v = __ldg(reinterpret_cast<const uint4*>(B + (long long)k * N + n0));
      const bf16* e = reinterpret_cast<const bf16*>(&v);
#pragma unroll
      for (int j = 0; j < 8; ++j) Bt[(n0 + j) * ldb + k] = e[j];
    }
  } else {
    for (int o = tid; o < K * N; o += nt) {
      const int k = o % K, n = o / K;
      Bt[n * ldb + k] = B[(long long)k * N + n];
    }
  }
  const int pad = round_up(K, 16) - K;
  for (int o = tid; o < N * pad; o += nt) Bt[(o / pad) * ldb + K + o % pad] = __float2bfloat16_rn(0.0f);
}

// D[m][n] = sum over the segments of A . B for rows m < 16 * MT, columns
// n < N; the n-tiles are spread over the warps, and out(m, n, value) takes
// each element of the rows below M once. B comes from the staged Bt, or
// else from device memory (L2), KC k-tiles of it fetched together before
// their products (KC = 4: 8 fetched together spilled registers and ran the
// unstaged projector 7% slower)
template <int MT, int NSEG, typename Out>
__device__ __forceinline__ void row_product(const Segment (&seg)[NSEG], int N, int M, int warp,
                                            int nwarps, int lane, Out out) {
  constexpr int KC = 4;
  for (int n0 = warp * 8; n0 < N; n0 += nwarps * 8) {
    float d[MT][4];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) d[mt][0] = d[mt][1] = d[mt][2] = d[mt][3] = 0.0f;
#pragma unroll
    for (int sg = 0; sg < NSEG; ++sg) {
      const int K = seg[sg].K, lda = ld_of(K);
      if (seg[sg].Bt != nullptr) {
#pragma unroll 2
        for (int k0 = 0; k0 < K; k0 += 16) {
          uint32_t b[2];
          load_bt(b, seg[sg].Bt, lda, n0, k0, lane);
#pragma unroll
          for (int mt = 0; mt < MT; ++mt) {
            uint32_t a[4];
            load_a(a, seg[sg].A, lda, mt * 16, k0, lane);
            mma_bf16(d[mt], a, b);
          }
        }
        continue;
      }
      for (int kc = 0; kc < K; kc += 16 * KC) {
        uint32_t b[KC][2];
#pragma unroll
        for (int j = 0; j < KC; ++j) load_b_global(b[j], seg[sg].B, N, K, N, n0, kc + 16 * j, lane);
#pragma unroll
        for (int j = 0; j < KC; ++j) {
          if (kc + 16 * j >= K) break;
#pragma unroll
          for (int mt = 0; mt < MT; ++mt) {
            uint32_t a[4];
            load_a(a, seg[sg].A, lda, mt * 16, kc + 16 * j, lane);
            mma_bf16(d[mt], a, b[j]);
          }
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

// zero an A tile of rows x ld_of(K) (the padding must read as 0)
__device__ __forceinline__ void clear_tile(bf16* A, int rows, int K, int tid, int nt) {
  uint32_t* p = reinterpret_cast<uint32_t*>(A);
  for (int k = tid; k < rows * ld_of(K) / 2; k += nt) p[k] = 0u;
}

// the epilogue's operand tiles and f32 results in the union region
struct EpilogueTiles {
  bf16* a0;     // [16][ld_of(S + V)]      [o1 | o4]
  bf16* a1;     // [M1][ld_of(S + 2V)]     [o2 | o3 | o5] per (atom, component) row
  bf16* a_s;    // [16][ld_of(Sc)]         activated scalars
  bf16* a_xs;   // [16][ld_of(S)]          block input scalars
  bf16* a_g;    // [M1][ld_of(Vg)]         gated vectors per (atom, component)
  bf16* a_xv;   // [M1][ld_of(V)]          block input vectors per (atom, component)
  float* conv0; // [td][C0]
  float* conv1; // [td][3][V1]
  bf16* bst;    // the staged B operands of one product step, or null
};

// rows of the (atom, component) tiles for td atoms
__host__ __device__ inline int comp_rows(int td) { return round_up(3 * td, 16); }

// bytes of the staged B operands: the larger of the post-linear's (pl0,
// pl1) and the second step's (lin20, sk0, lin21, sk1; none in layer mode,
// Sc = Vg = 0)
__host__ __device__ inline size_t staged_b_bytes(int S, int V, int C0, int V1, int Sc, int Vg) {
  const size_t post = bt_bytes(S + V, C0) + bt_bytes(S + 2 * V, V1);
  const size_t second =
      Sc + Vg > 0 ? bt_bytes(Sc, Sc) + bt_bytes(S, Sc) + bt_bytes(Vg, Vg) + (V > 0 ? bt_bytes(V, Vg) : 0)
                  : 0;
  return post > second ? post : second;
}

// the epilogue's region; with `stage` the B operands are staged in it too
__host__ __device__ inline size_t epilogue_tiles_bytes(int S, int V, int C0, int V1, int Sc,
                                                       int Vg, int td, bool stage) {
  const int M1 = comp_rows(td);
  return align16((size_t)16 * ld_of(S + V) * 2) + align16((size_t)M1 * ld_of(S + 2 * V) * 2) +
         align16((size_t)16 * ld_of(Sc) * 2) + align16((size_t)16 * ld_of(S) * 2) +
         align16((size_t)M1 * ld_of(Vg) * 2) + align16((size_t)M1 * ld_of(V) * 2) +
         align16((size_t)td * C0 * 4) + align16((size_t)td * 3 * V1 * 4) +
         (stage ? staged_b_bytes(S, V, C0, V1, Sc, Vg) : 0);
}

__device__ __forceinline__ EpilogueTiles carve_epilogue_tiles(char* base, int S, int V, int C0,
                                                              int V1, int Sc, int Vg, int td,
                                                              bool stage) {
  const int M1 = comp_rows(td);
  EpilogueTiles e;
  auto take = [&](size_t bytes) {
    char* p = base;
    base += align16(bytes);
    return p;
  };
  e.a0 = (bf16*)take((size_t)16 * ld_of(S + V) * 2);
  e.a1 = (bf16*)take((size_t)M1 * ld_of(S + 2 * V) * 2);
  e.a_s = (bf16*)take((size_t)16 * ld_of(Sc) * 2);
  e.a_xs = (bf16*)take((size_t)16 * ld_of(S) * 2);
  e.a_g = (bf16*)take((size_t)M1 * ld_of(Vg) * 2);
  e.a_xv = (bf16*)take((size_t)M1 * ld_of(V) * 2);
  e.conv0 = (float*)take((size_t)td * C0 * 4);
  e.conv1 = (float*)take((size_t)td * 3 * V1 * 4);
  e.bst = stage ? (bf16*)base : nullptr;
  return e;
}

// row products with 1 to 3 m-tiles (M rows of the caller: up to 48)
template <int NSEG, typename Out>
__device__ __forceinline__ void rows_product(const Segment (&seg)[NSEG], int N, int M, int warp,
                                             int nwarps, int lane, Out out) {
  if (M <= 16)
    row_product<1>(seg, N, M, warp, nwarps, lane, out);
  else if (M <= 32)
    row_product<2>(seg, N, M, warp, nwarps, lane, out);
  else
    row_product<3>(seg, N, M, warp, nwarps, lane, out);
}

// post-linear of the normalised aggregates (acc, rounded to bf16 already)
// of nd atoms: conv0 [td][C0] = [o1 | o4] . pl0, conv1 [td][3][V1] =
// [o2 | o3 | o5]_comp . pl1, f32
__device__ __forceinline__ void post_linear(const Scratch& s, const EpilogueTiles& e,
                                            const Weights& w, int nd, int S, int V, int C0, int V1,
                                            int tid, int nt) {
  const int K0 = S + V, K1 = S + 2 * V, L0 = ld_of(K0), L1 = ld_of(K1), M1 = comp_rows(nd);
  clear_tile(e.a0, 16, K0, tid, nt);
  clear_tile(e.a1, M1, K1, tid, nt);
  __syncthreads();
  // the B operands' loads first, the A tiles' fill meanwhile
  bf16* bt1 = e.bst == nullptr ? nullptr : e.bst + bt_bytes(K0, C0) / 2;
  if (e.bst != nullptr) {
    stage_bt(e.bst, (const bf16*)w.pl0, K0, C0, tid, nt);
    stage_bt(bt1, (const bf16*)w.pl1, K1, V1, tid, nt);
  }
  auto agg = [&](int td, int comp, int ch) { return s.acc[(td * 3 + comp) * nt + ch]; };
  for (int o = tid; o < nd * K0; o += nt) {
    const int td = o / K0, k = o % K0;
    e.a0[td * L0 + k] = __float2bfloat16_rn(k < S ? agg(td, 0, k) : agg(td, 0, 2 * S + V + k - S));
  }
  for (int o = tid; o < nd * 3 * K1; o += nt) {
    const int r = o / K1, k = o % K1, td = r / 3, comp = r % 3;
    const int ch = k < S ? S + k : (k < S + V ? 2 * S + (k - S) : 2 * S + 2 * V + (k - S - V));
    e.a1[r * L1 + k] = __float2bfloat16_rn(agg(td, comp, ch));
  }
  __syncthreads();
  const int warp = tid >> 5, lane = tid & 31, nwarps = nt >> 5;
  const Segment s0[1] = {{e.a0, (const bf16*)w.pl0, K0, e.bst}};
  row_product<1>(s0, C0, nd, warp, nwarps, lane,
                 [&](int m, int n, float v) { e.conv0[m * C0 + n] = v; });
  const Segment s1[1] = {{e.a1, (const bf16*)w.pl1, K1, bt1}};
  rows_product(s1, V1, 3 * nd, warp, nwarps, lane,
               [&](int r, int n, float v) { e.conv1[r * V1 + n] = v; });
}

// post-linear, gate, second linear and the linear skip of the block input
// for the nd atoms from i0 on (the FMA epilogue's function and rounding
// points); x(atom, ch) holds values exact in bf16; out(td, column, value)
// takes each element of the [Sc + 3Vg] row (vector block [Vg][3]) once
template <typename X, typename Out>
__device__ __forceinline__ void epilogue(const Scratch& s, const EpilogueTiles& e, const Weights& w,
                                         const X& x, Out out, int i0, int nd, int S, int V, int Sc,
                                         int Vg, int tid, int nt) {
  const int C0 = Sc + Vg, M1 = comp_rows(nd);
  mma::post_linear(s, e, w, nd, S, V, C0, Vg, tid, nt);
  clear_tile(e.a_s, 16, Sc, tid, nt);
  clear_tile(e.a_xs, 16, S, tid, nt);
  clear_tile(e.a_g, M1, Vg, tid, nt);
  clear_tile(e.a_xv, M1, V, tid, nt);
  __syncthreads();
  // the second step's B operands, staged while the gate's tiles fill
  bf16 *bt_l20 = nullptr, *bt_s0 = nullptr, *bt_l21 = nullptr, *bt_s1 = nullptr;
  if (e.bst != nullptr) {
    bt_l20 = e.bst;
    bt_s0 = bt_l20 + bt_bytes(Sc, Sc) / 2;
    bt_l21 = bt_s0 + bt_bytes(S, Sc) / 2;
    bt_s1 = V > 0 ? bt_l21 + bt_bytes(Vg, Vg) / 2 : nullptr;
    stage_bt(bt_l20, (const bf16*)w.lin20, Sc, Sc, tid, nt);
    stage_bt(bt_s0, (const bf16*)w.sk0, S, Sc, tid, nt);
    stage_bt(bt_l21, (const bf16*)w.lin21, Vg, Vg, tid, nt);
    if (V > 0) stage_bt(bt_s1, (const bf16*)w.sk1, V, Vg, tid, nt);
  }
  // gate: LeakyReLU(0.01) on the scalars, sigmoid gates on the vectors,
  // rounded to bf16; the block input beside them
  const int Ls = ld_of(Sc), Lxs = ld_of(S), Lg = ld_of(Vg), Lxv = ld_of(V);
  for (int o = tid; o < nd * Sc; o += nt) {
    const int td = o / Sc, q = o % Sc;
    const float v = e.conv0[td * C0 + q];
    e.a_s[td * Ls + q] = __float2bfloat16_rn(v >= 0.0f ? v : 0.01f * v);
  }
  for (int o = tid; o < nd * S; o += nt) {
    const int td = o / S, u = o % S;
    e.a_xs[td * Lxs + u] = __float2bfloat16_rn(x(i0 + td, u));
  }
  for (int o = tid; o < nd * 3 * Vg; o += nt) {
    const int r = o / Vg, q = o % Vg, td = r / 3;
    e.a_g[r * Lg + q] =
        __float2bfloat16_rn(e.conv1[r * Vg + q] * sigmoidf(e.conv0[td * C0 + Sc + q]));
  }
  for (int o = tid; o < nd * 3 * V; o += nt) {
    const int r = o / V, v = o % V, td = r / 3, comp = r % 3;
    e.a_xv[r * Lxv + v] = __float2bfloat16_rn(x(i0 + td, S + 3 * v + comp));
  }
  __syncthreads();
  const int warp = tid >> 5, lane = tid & 31, nwarps = nt >> 5;
  const Segment s0[2] = {{e.a_s, (const bf16*)w.lin20, Sc, bt_l20},
                         {e.a_xs, (const bf16*)w.sk0, S, bt_s0}};
  row_product<1>(s0, Sc, nd, warp, nwarps, lane, out);
  if (V > 0) {
    const Segment s1[2] = {{e.a_g, (const bf16*)w.lin21, Vg, bt_l21},
                           {e.a_xv, (const bf16*)w.sk1, V, bt_s1}};
    rows_product(s1, Vg, 3 * nd, warp, nwarps, lane,
                 [&](int r, int n, float v) { out(r / 3, Sc + 3 * n + r % 3, v); });
  } else {
    const Segment s1[1] = {{e.a_g, (const bf16*)w.lin21, Vg, bt_l21}};
    rows_product(s1, Vg, 3 * nd, warp, nwarps, lane,
                 [&](int r, int n, float v) { out(r / 3, Sc + 3 * n + r % 3, v); });
  }
}

}  // namespace mma
}  // namespace conv_block
