// Tile helpers shared by the flash-attention forward and backward kernels
// (flash_attention_fwd.cu, flash_attention_bwd.cu).
//
// Layout of the work.  Attention is GQA: query head h reads kv head
// h / G, G = Hq / Hkv.  A block works for one (batch, kv head) and takes the
// G query heads of that kv head together, as rows of one "row space":
// row r is query position r / G of query head hk * G + r % G.  A tile of
// BM rows therefore holds about BM / G positions of every head of the
// group, and each K/V tile a block loads serves all G heads.
//
// The kernels are instantiated for float32 inputs only (bf16 takes the
// tensor-core kernels, see hopper.cuh).  Tiles live in shared memory as
// float32, BM or BN rows of DH values with a row stride of DH + 4 floats, so
// that the float4 reads of eight neighbouring rows hit distinct banks.
// 256 threads form a 16 x 16 grid: thread (ty, tx) owns rows ty*4 .. ty*4+3
// of a 64 x 64 score tile and its columns tx, tx+16, tx+32, tx+48; in a
// (rows x DH) accumulator it owns the same four rows and DH / 16 columns.
// The 16 threads of one ty are adjacent lanes of one warp, so a row's
// max and sum reduce with four xor-shuffles.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>

namespace fa {

constexpr int BM = 64;           // rows per tile (row space above)
constexpr int BN = 64;           // keys per tile
constexpr int THREADS = 256;     // 16 x 16
constexpr int LDP = BN + 4;      // row stride of a BM x BN score tile
constexpr float NEG_INF = -1e30f;

template <int DH>
struct Tile {
  static constexpr int LD = DH + 4;                   // row stride of a tile
  static constexpr int NC = DH / 16;                  // columns per thread
  static constexpr int VW = NC < 4 ? NC : 4;          // their vector width
  static constexpr int NV = NC / VW;                  // vectors per thread
};

struct Strides {                 // element strides of a (B, S, H, dh) tensor
  long long b, s, h;             // (the dh stride is 1)
};

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
// v rounded to the input type and back: the JAX kernels cast p and ds to
// the input type before their products with v, do, k and q
__device__ __forceinline__ float round_as(float v, const float*) { return v; }

// Whether query position t sees key j (the mask of the JAX kernels).
__device__ __forceinline__ bool visible(int t, int j, int Skv, int causal,
                                        int window) {
  return j < Skv && (!causal || j <= t) && (window == 0 || j > t - window);
}

// The kv tiles a row tile [r0, r0 + BM) can see, as [lo, hi]: causal
// stops at the tile of the last position, a window starts at the tile of
// the first position's oldest key (the skip rule _block_visible).
struct Range {
  int lo, hi;
};
__device__ __forceinline__ Range kv_tiles(int r0, int rows, int G, int Skv,
                                          int causal, int window) {
  const int t_lo = r0 / G;
  const int t_hi = (min(r0 + BM, rows) - 1) / G;
  const int n_kv = (Skv + BN - 1) / BN;
  Range r;
  r.hi = causal ? min(n_kv - 1, t_hi / BN) : n_kv - 1;
  r.lo = window > 0 ? max(0, t_lo - window + 1) / BN : 0;
  return r;
}

// Rows r0 .. r0 + BM - 1 of the row space of kv head hk; rows past n_rows
// load as 0.
template <typename T, int DH>
__device__ __forceinline__ void load_rows(float* dst, const T* __restrict__ src,
                                          Strides st, int b, int hk, int G,
                                          int r0, int n_rows) {
  for (int i = threadIdx.x; i < BM * DH; i += THREADS) {
    const int rr = i / DH, d = i % DH, r = r0 + rr;
    float x = 0.f;
    if (r < n_rows) {
      x = to_float(src[b * st.b + (long long)(r / G) * st.s +
                       (long long)(hk * G + r % G) * st.h + d]);
    }
    dst[rr * Tile<DH>::LD + d] = x;
  }
}

// Keys k0 .. k0 + BN - 1 of kv head hk; keys past n_keys load as 0.
template <typename T, int DH>
__device__ __forceinline__ void load_keys(float* dst, const T* __restrict__ src,
                                          Strides st, int b, int hk, int k0,
                                          int n_keys) {
  for (int i = threadIdx.x; i < BN * DH; i += THREADS) {
    const int c = i / DH, d = i % DH, key = k0 + c;
    float x = 0.f;
    if (key < n_keys) {
      x = to_float(src[b * st.b + (long long)key * st.s + hk * st.h + d]);
    }
    dst[c * Tile<DH>::LD + d] = x;
  }
}

// acc[i][j] += sum_d A[ra + i][d] * B[rb + 16 j][d], i, j < 4: a 64 x 64
// product tile of two (64 x DH) tiles, the inner dimension read as float4.
template <int DH>
__device__ __forceinline__ void dot_tile(float (&acc)[4][4], const float* A,
                                         int ra, const float* B, int rb) {
  constexpr int LD = Tile<DH>::LD;
#pragma unroll 2
  for (int d = 0; d < DH; d += 4) {
    float4 a[4], c[4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
      a[i] = *reinterpret_cast<const float4*>(A + (ra + i) * LD + d);
#pragma unroll
    for (int j = 0; j < 4; ++j)
      c[j] = *reinterpret_cast<const float4*>(B + (rb + 16 * j) * LD + d);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        float s = acc[i][j];
        s = fmaf(a[i].x, c[j].x, s);
        s = fmaf(a[i].y, c[j].y, s);
        s = fmaf(a[i].z, c[j].z, s);
        s = fmaf(a[i].w, c[j].w, s);
        acc[i][j] = s;
      }
    }
  }
}

template <int VW>
__device__ __forceinline__ void load_vec(const float* src, float* dst) {
  if constexpr (VW == 4) {
    const float4 x = *reinterpret_cast<const float4*>(src);
    dst[0] = x.x; dst[1] = x.y; dst[2] = x.z; dst[3] = x.w;
  } else if constexpr (VW == 2) {
    const float2 x = *reinterpret_cast<const float2*>(src);
    dst[0] = x.x; dst[1] = x.y;
  } else {
    dst[0] = *src;
  }
}

// Column c < DH / 16 of a thread's accumulator row is
// d = VW * tx + 16 * VW * (c / VW) + c % VW.
template <int DH>
__device__ __forceinline__ int acc_col(int tx, int c) {
  constexpr int VW = Tile<DH>::VW;
  return VW * tx + 16 * VW * (c / VW) + c % VW;
}

// acc[i][c] += sum_k P[ra + i][k] * V[k][acc_col(tx, c)] over the BN keys
// (or rows) of a score tile P (stride LDP) and a (BN x DH) tile V.
template <int DH>
__device__ __forceinline__ void pv_tile(float (&acc)[4][DH / 16], const float* P,
                                        int ra, const float* V, int tx) {
  constexpr int LD = Tile<DH>::LD, NC = Tile<DH>::NC, VW = Tile<DH>::VW;
#pragma unroll 2
  for (int k = 0; k < BN; k += 4) {
    float p[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i) load_vec<4>(P + (ra + i) * LDP + k, p[i]);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      float vv[NC];
#pragma unroll
      for (int n = 0; n < NC / VW; ++n)
        load_vec<VW>(V + (k + e) * LD + VW * tx + 16 * VW * n, vv + n * VW);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
#pragma unroll
        for (int c = 0; c < NC; ++c) acc[i][c] = fmaf(p[i][e], vv[c], acc[i][c]);
      }
    }
  }
}

// --- column chunks (the dh 256 backward) ---------------------------------
//
// At dh 256 the backward's four (64 x dh) float32 tiles do not fit a block's
// 227 KB, so two of them are held DC = 128 columns at a time, with a row
// stride of DC + 4.  A chunk's thread columns follow the dh 128 layout: the
// accumulator column c of a (rows x 256) thread tile is chunk c / 8, local
// column acc_col<128>(tx, c % 8).

constexpr int DC = 128;          // columns of a chunk
constexpr int LDC = DC + 4;      // row stride of a chunk tile

// Columns [d0, d0 + WIDTH) of rows r0 .. r0 + BM - 1 of the row space of kv
// head hk, row stride LD; rows past n_rows load as 0.
template <typename T, int WIDTH, int LD>
__device__ __forceinline__ void load_rows_cols(float* dst,
                                               const T* __restrict__ src,
                                               Strides st, int b, int hk,
                                               int G, int r0, int n_rows,
                                               int d0) {
  for (int i = threadIdx.x; i < BM * WIDTH; i += THREADS) {
    const int rr = i / WIDTH, d = i % WIDTH, r = r0 + rr;
    float x = 0.f;
    if (r < n_rows) {
      x = to_float(src[b * st.b + (long long)(r / G) * st.s +
                       (long long)(hk * G + r % G) * st.h + d0 + d]);
    }
    dst[rr * LD + d] = x;
  }
}

// Columns [d0, d0 + WIDTH) of keys k0 .. k0 + BN - 1 of kv head hk, row
// stride LD; keys past n_keys load as 0.
template <typename T, int WIDTH, int LD>
__device__ __forceinline__ void load_keys_cols(float* dst,
                                               const T* __restrict__ src,
                                               Strides st, int b, int hk,
                                               int k0, int n_keys, int d0) {
  for (int i = threadIdx.x; i < BN * WIDTH; i += THREADS) {
    const int c = i / WIDTH, d = i % WIDTH, key = k0 + c;
    float x = 0.f;
    if (key < n_keys) {
      x = to_float(src[b * st.b + (long long)key * st.s + hk * st.h + d0 + d]);
    }
    dst[c * LD + d] = x;
  }
}

// dot_tile over LEN columns of A (row stride LDA) and B (row stride LDB),
// both already offset to their first column; the same order of sums as
// dot_tile, so a product taken chunk by chunk equals the whole one.
template <int LEN, int LDA, int LDB>
__device__ __forceinline__ void dot_cols(float (&acc)[4][4], const float* A,
                                         int ra, const float* B, int rb) {
#pragma unroll 2
  for (int d = 0; d < LEN; d += 4) {
    float4 a[4], c[4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
      a[i] = *reinterpret_cast<const float4*>(A + (ra + i) * LDA + d);
#pragma unroll
    for (int j = 0; j < 4; ++j)
      c[j] = *reinterpret_cast<const float4*>(B + (rb + 16 * j) * LDB + d);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        float s = acc[i][j];
        s = fmaf(a[i].x, c[j].x, s);
        s = fmaf(a[i].y, c[j].y, s);
        s = fmaf(a[i].z, c[j].z, s);
        s = fmaf(a[i].w, c[j].w, s);
        acc[i][j] = s;
      }
    }
  }
}

// pv_tile into the 8 accumulator columns C0 .. C0 + 7 of a (rows x NCT)
// thread tile, from a (BN x DC) chunk V of row stride LDC.
template <int NCT, int C0>
__device__ __forceinline__ void pv_cols(float (&acc)[4][NCT], const float* P,
                                        int ra, const float* V, int tx) {
#pragma unroll 2
  for (int k = 0; k < BN; k += 4) {
    float p[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i) load_vec<4>(P + (ra + i) * LDP + k, p[i]);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      float vv[8];
#pragma unroll
      for (int n = 0; n < 2; ++n)
        load_vec<4>(V + (k + e) * LDC + 4 * tx + 64 * n, vv + n * 4);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
#pragma unroll
        for (int c = 0; c < 8; ++c)
          acc[i][C0 + c] = fmaf(p[i][e], vv[c], acc[i][C0 + c]);
      }
    }
  }
}

// max and sum over the 16 lanes of one ty (adjacent lanes of one warp)
__device__ __forceinline__ float max16(float x) {
#pragma unroll
  for (int o = 1; o < 16; o <<= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}
__device__ __forceinline__ float sum16(float x) {
#pragma unroll
  for (int o = 1; o < 16; o <<= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// Let a kernel use more than 48 KB of dynamic shared memory.
template <typename K>
__host__ cudaError_t allow_smem(K kernel, size_t bytes) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

}  // namespace fa
