// Flash-attention backward for Hopper (sm_90a), plain C interface.
//
// Replaces the TPU kernel flash_attention_bwd
// (src/repro/kernels/flash_attention/kernel.py:367, bodies _dq_kernel and
// _dkv_kernel).  Two kernels, as in the JAX package:
//   * dq: one block per (batch, kv head, 64-row tile of its G query heads),
//     looping over the kv tiles its rows see;
//   * dk/dv: one block per (batch, kv head, 64-key tile), looping over the
//     row tiles (all G query heads) that see its keys, so the sum over the
//     group is the block's own loop.
// Every output element has one owner: no atomics, and the sums come out the
// same on every run.  Both recompute p = exp(s * scale - lse) under the mask
// from the forward's lse, and ds = p * (dp - delta) * scale, with
// delta = rowsum(out * do) computed outside the kernels (the JAX package
// does so too, kernel.py:377).  As in the TPU kernels, p is rounded to do's
// type before the product with do (dv), and ds to the input type before the
// products with k (dq) and q (dk).
//
// What bounds it on this card: operations.  At the training shape the
// least work is five products of 2 * dh flops per visible (query, key) pair
// (s recomputed, dp, dv, dq, dk): 64.5 GFLOP; the two-kernel split
// recomputes s and dp in both kernels, seven products.  Bytes (q, k, v, do,
// lse, delta in; dq, dk, dv out) are a small share.
//
// What the design does: the accumulators of a block (dq, or dk and dv for
// 64 keys x dh) live in registers spread over 256 threads (4 rows x dh/16
// columns each); q, do, k, v and the two score tiles sit in shared memory
// as float32.  The dq grid is issued longest-first, like the forward; the
// dk/dv grid is longest-first already (key tile 0 is seen by every row
// under causal masking).  The causal load is uneven across blocks.  FMA
// loops in float32 serve float32 inputs only: the JAX package's float32
// gradient tolerance (2e-4) is out of reach of TF32 tensor cores.  bf16
// inputs take the tensor-core kernels of flash_attention_bwd_wgmma.cu.
//
// Head dim 256 (recurrentgemma's local attention) takes its own pair of
// kernels: four (64 x 256) float32 tiles and the score tiles would need 284
// KB (dq) and 302 KB (dk/dv) of shared memory, and the dk/dv accumulators
// 128 registers a thread.  So:
//   * dq keeps q and do whole and holds k and v 128 columns at a time (218
//     KB): s and dp are summed over the two chunks in the order of dh, then
//     dq takes the chunk of k still held and reloads the other one;
//   * dk/dv runs twice per key tile (grid z = 2), each block owning one
//     128-column half of dk and dv (64 accumulators a thread, as at dh
//     128): it keeps k and v whole and holds q and do 128 columns at a time
//     (219 KB), recomputes s and dp over all 256 columns (so 1.5x the dk/dv
//     work of one block per tile), and passes p and then ds through one
//     shared score tile.
// Every sum runs in the same order as in the one-block layout, so the
// split changes no result.

#include "flash_tiles.cuh"

namespace {

using namespace fa;

template <int DH>
constexpr size_t dq_smem() {
  return sizeof(float) * (4 * BM * Tile<DH>::LD + BM * LDP);
}

template <int DH>
constexpr size_t dkv_smem() {
  return sizeof(float) * (4 * BM * Tile<DH>::LD + 2 * BN * LDP + 2 * BM);
}

template <typename T, int DH>
__global__ void __launch_bounds__(THREADS)
flash_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                const T* __restrict__ v, const T* __restrict__ dout,
                const float* __restrict__ lse, const float* __restrict__ delta,
                T* __restrict__ dq, Strides qs, Strides ks, Strides vs,
                Strides ds_, int Sq, int Skv, int Hq, int Hkv, int causal,
                int window, float scale) {
  constexpr int LD = Tile<DH>::LD, NC = Tile<DH>::NC;
  extern __shared__ float4 smem4[];
  float* Qs = reinterpret_cast<float*>(smem4);   // BM x LD
  float* dOs = Qs + BM * LD;                     // BM x LD
  float* Ks = dOs + BM * LD;                     // BN x LD
  float* Vs = Ks + BN * LD;                      // BN x LD
  float* dSs = Vs + BN * LD;                     // BM x LDP

  const int G = Hq / Hkv;
  const int rows = Sq * G;
  const int r0 = (gridDim.x - 1 - blockIdx.x) * BM;   // longest rows first
  const int b = blockIdx.y / Hkv, hk = blockIdx.y % Hkv;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;

  load_rows<T, DH>(Qs, q, qs, b, hk, G, r0, rows);
  load_rows<T, DH>(dOs, dout, ds_, b, hk, G, r0, rows);

  int qpos[4];
  bool rok[4];
  float lse_r[4], delta_r[4], acc[4][NC];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = r0 + ty * 4 + i;
    rok[i] = r < rows;
    qpos[i] = r / G;
    const size_t at = ((size_t)b * Hq + hk * G + r % G) * Sq + qpos[i];
    lse_r[i] = rok[i] ? lse[at] : 0.f;
    delta_r[i] = rok[i] ? delta[at] : 0.f;
#pragma unroll
    for (int c = 0; c < NC; ++c) acc[i][c] = 0.f;
  }

  const Range kr = kv_tiles(r0, rows, G, Skv, causal, window);
  for (int jt = kr.lo; jt <= kr.hi; ++jt) {
    const int k0 = jt * BN;
    __syncthreads();                   // the previous K tile is consumed
    load_keys<T, DH>(Ks, k, ks, b, hk, k0, Skv);
    load_keys<T, DH>(Vs, v, vs, b, hk, k0, Skv);
    __syncthreads();
    float s[4][4], dp[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = dp[i][j] = 0.f;
    dot_tile<DH>(s, Qs, ty * 4, Ks, tx);
    dot_tile<DH>(dp, dOs, ty * 4, Vs, tx);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const bool ok = rok[i] && visible(qpos[i], k0 + tx + 16 * j, Skv,
                                          causal, window);
        const float p = ok ? expf(s[i][j] * scale - lse_r[i]) : 0.f;
        dSs[(ty * 4 + i) * LDP + tx + 16 * j] =
            round_as(p * (dp[i][j] - delta_r[i]) * scale, k);
      }
    }
    __syncthreads();                   // dS is complete
    pv_tile<DH>(acc, dSs, ty * 4, Ks, tx);
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    if (!rok[i]) continue;
    const int r = r0 + ty * 4 + i, t = r / G, h = hk * G + r % G;
    T* o = dq + (((size_t)b * Sq + t) * Hq + h) * DH;
#pragma unroll
    for (int c = 0; c < NC; ++c) store(o + acc_col<DH>(tx, c), acc[i][c]);
  }
}

template <typename T, int DH>
__global__ void __launch_bounds__(THREADS)
flash_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, const T* __restrict__ dout,
                 const float* __restrict__ lse,
                 const float* __restrict__ delta, T* __restrict__ dk,
                 T* __restrict__ dv, Strides qs, Strides ks, Strides vs,
                 Strides ds_, int Sq, int Skv, int Hq, int Hkv, int causal,
                 int window, float scale) {
  constexpr int LD = Tile<DH>::LD, NC = Tile<DH>::NC;
  extern __shared__ float4 smem4[];
  float* Ks = reinterpret_cast<float*>(smem4);   // BN x LD
  float* Vs = Ks + BN * LD;                      // BN x LD
  float* Qs = Vs + BN * LD;                      // BM x LD
  float* dOs = Qs + BM * LD;                     // BM x LD
  float* Pt = dOs + BM * LD;                     // BN x LDP: p, key-major
  float* dSt = Pt + BN * LDP;                    // BN x LDP: ds, key-major
  float* Ls = dSt + BN * LDP;                    // BM: lse of the tile's rows
  float* Ds = Ls + BM;                           // BM: delta of the rows

  const int G = Hq / Hkv;
  const int rows = Sq * G;
  const int k0 = blockIdx.x * BN;
  const int b = blockIdx.y / Hkv, hk = blockIdx.y % Hkv;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;

  load_keys<T, DH>(Ks, k, ks, b, hk, k0, Skv);
  load_keys<T, DH>(Vs, v, vs, b, hk, k0, Skv);

  float acc_k[4][NC], acc_v[4][NC];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < NC; ++c) acc_k[i][c] = acc_v[i][c] = 0.f;

  // the positions that see some key of [k0, k_hi]: from k0 (causal) up to
  // the last key's window
  const int k_hi = min(k0 + BN, Skv) - 1;
  const int t_first = causal ? min(k0, Sq) : 0;
  const int t_end = window > 0 ? min(Sq, k_hi + window) : Sq;
  for (int r0 = t_first * G / BM * BM; r0 < t_end * G; r0 += BM) {
    __syncthreads();                   // the previous tiles are consumed
    load_rows<T, DH>(Qs, q, qs, b, hk, G, r0, rows);
    load_rows<T, DH>(dOs, dout, ds_, b, hk, G, r0, rows);
    if (threadIdx.x < BM) {
      const int r = r0 + threadIdx.x;
      const size_t at = ((size_t)b * Hq + hk * G + r % G) * Sq + r / G;
      Ls[threadIdx.x] = r < rows ? lse[at] : 0.f;
      Ds[threadIdx.x] = r < rows ? delta[at] : 0.f;
    }
    __syncthreads();
    float st[4][4], dpt[4][4];         // keys ty*4+i  x  rows tx+16j
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) st[i][j] = dpt[i][j] = 0.f;
    dot_tile<DH>(st, Ks, ty * 4, Qs, tx);
    dot_tile<DH>(dpt, Vs, ty * 4, dOs, tx);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int rl = tx + 16 * j, r = r0 + rl;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const bool ok = r < rows && visible(r / G, k0 + ty * 4 + i, Skv,
                                            causal, window);
        const float p = ok ? expf(st[i][j] * scale - Ls[rl]) : 0.f;
        Pt[(ty * 4 + i) * LDP + rl] = round_as(p, dout);
        dSt[(ty * 4 + i) * LDP + rl] =
            round_as(p * (dpt[i][j] - Ds[rl]) * scale, q);
      }
    }
    __syncthreads();                   // p and ds are complete
    pv_tile<DH>(acc_v, Pt, ty * 4, dOs, tx);
    pv_tile<DH>(acc_k, dSt, ty * 4, Qs, tx);
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int key = k0 + ty * 4 + i;
    if (key >= Skv) continue;
    const size_t at = (((size_t)b * Skv + key) * Hkv + hk) * DH;
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      store(dk + at + acc_col<DH>(tx, c), acc_k[i][c]);
      store(dv + at + acc_col<DH>(tx, c), acc_v[i][c]);
    }
  }
}

// dh 256: column-chunked dq (see the note at the top).
constexpr size_t dq256_smem() {
  return sizeof(float) * (2 * BM * Tile<256>::LD + 2 * BN * LDC + BM * LDP);
}

constexpr size_t dkv256_smem() {
  return sizeof(float) * (2 * BN * Tile<256>::LD + 2 * BM * LDC + BN * LDP +
                          2 * BM);
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
flash_dq256_kernel(const T* __restrict__ q, const T* __restrict__ k,
                   const T* __restrict__ v, const T* __restrict__ dout,
                   const float* __restrict__ lse,
                   const float* __restrict__ delta, T* __restrict__ dq,
                   Strides qs, Strides ks, Strides vs, Strides ds_, int Sq,
                   int Skv, int Hq, int Hkv, int causal, int window,
                   float scale) {
  constexpr int DH = 256, LD = Tile<DH>::LD, NC = Tile<DH>::NC;
  extern __shared__ float4 smem4[];
  float* Qs = reinterpret_cast<float*>(smem4);   // BM x LD
  float* dOs = Qs + BM * LD;                     // BM x LD
  float* Kc = dOs + BM * LD;                     // BN x LDC: a chunk of k
  float* Vc = Kc + BN * LDC;                     // BN x LDC: a chunk of v
  float* dSs = Vc + BN * LDC;                    // BM x LDP

  const int G = Hq / Hkv;
  const int rows = Sq * G;
  const int r0 = (gridDim.x - 1 - blockIdx.x) * BM;   // longest rows first
  const int b = blockIdx.y / Hkv, hk = blockIdx.y % Hkv;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;

  load_rows<T, DH>(Qs, q, qs, b, hk, G, r0, rows);
  load_rows<T, DH>(dOs, dout, ds_, b, hk, G, r0, rows);

  int qpos[4];
  bool rok[4];
  float lse_r[4], delta_r[4], acc[4][NC];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = r0 + ty * 4 + i;
    rok[i] = r < rows;
    qpos[i] = r / G;
    const size_t at = ((size_t)b * Hq + hk * G + r % G) * Sq + qpos[i];
    lse_r[i] = rok[i] ? lse[at] : 0.f;
    delta_r[i] = rok[i] ? delta[at] : 0.f;
#pragma unroll
    for (int c = 0; c < NC; ++c) acc[i][c] = 0.f;
  }

  const Range kr = kv_tiles(r0, rows, G, Skv, causal, window);
  for (int jt = kr.lo; jt <= kr.hi; ++jt) {
    const int k0 = jt * BN;
    float s[4][4], dp[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = dp[i][j] = 0.f;
    for (int c = 0; c < DH / DC; ++c) {
      __syncthreads();                 // the previous chunks are consumed
      load_keys_cols<T, DC, LDC>(Kc, k, ks, b, hk, k0, Skv, c * DC);
      load_keys_cols<T, DC, LDC>(Vc, v, vs, b, hk, k0, Skv, c * DC);
      __syncthreads();
      dot_cols<DC, LD, LDC>(s, Qs + c * DC, ty * 4, Kc, tx);
      dot_cols<DC, LD, LDC>(dp, dOs + c * DC, ty * 4, Vc, tx);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const bool ok = rok[i] && visible(qpos[i], k0 + tx + 16 * j, Skv,
                                          causal, window);
        const float p = ok ? expf(s[i][j] * scale - lse_r[i]) : 0.f;
        dSs[(ty * 4 + i) * LDP + tx + 16 * j] =
            round_as(p * (dp[i][j] - delta_r[i]) * scale, k);
      }
    }
    __syncthreads();                   // dS is complete; Kc holds chunk 1
    pv_cols<NC, 8>(acc, dSs, ty * 4, Kc, tx);
    __syncthreads();                   // chunk 1 is consumed
    load_keys_cols<T, DC, LDC>(Kc, k, ks, b, hk, k0, Skv, 0);
    __syncthreads();
    pv_cols<NC, 0>(acc, dSs, ty * 4, Kc, tx);
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    if (!rok[i]) continue;
    const int r = r0 + ty * 4 + i, t = r / G, h = hk * G + r % G;
    T* o = dq + (((size_t)b * Sq + t) * Hq + h) * DH;
#pragma unroll
    for (int c = 0; c < NC; ++c) store(o + acc_col<DH>(tx, c), acc[i][c]);
  }
}

// dh 256: dk and dv, one 128-column half of them per block (blockIdx.z).
template <typename T>
__global__ void __launch_bounds__(THREADS)
flash_dkv256_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const T* __restrict__ dout,
                    const float* __restrict__ lse,
                    const float* __restrict__ delta, T* __restrict__ dk,
                    T* __restrict__ dv, Strides qs, Strides ks, Strides vs,
                    Strides ds_, int Sq, int Skv, int Hq, int Hkv, int causal,
                    int window, float scale) {
  constexpr int DH = 256, LD = Tile<DH>::LD, NH = DC / 16;
  extern __shared__ float4 smem4[];
  float* Ks = reinterpret_cast<float*>(smem4);   // BN x LD
  float* Vs = Ks + BN * LD;                      // BN x LD
  float* Qc = Vs + BN * LD;                      // BM x LDC: a chunk of q
  float* dOc = Qc + BM * LDC;                    // BM x LDC: a chunk of do
  float* St = dOc + BM * LDC;                    // BN x LDP: p, then ds
  float* Ls = St + BN * LDP;                     // BM: lse of the tile's rows
  float* Ds = Ls + BM;                           // BM: delta of the rows

  const int G = Hq / Hkv;
  const int rows = Sq * G;
  const int k0 = blockIdx.x * BN;
  const int b = blockIdx.y / Hkv, hk = blockIdx.y % Hkv;
  const int half = blockIdx.z;                   // output columns half*DC ..
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;

  load_keys<T, DH>(Ks, k, ks, b, hk, k0, Skv);
  load_keys<T, DH>(Vs, v, vs, b, hk, k0, Skv);

  float acc_k[4][NH], acc_v[4][NH];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < NH; ++c) acc_k[i][c] = acc_v[i][c] = 0.f;

  const int k_hi = min(k0 + BN, Skv) - 1;
  const int t_first = causal ? min(k0, Sq) : 0;
  const int t_end = window > 0 ? min(Sq, k_hi + window) : Sq;
  for (int r0 = t_first * G / BM * BM; r0 < t_end * G; r0 += BM) {
    float st[4][4], dpt[4][4];         // keys ty*4+i  x  rows tx+16j
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) st[i][j] = dpt[i][j] = 0.f;
    for (int c = 0; c < DH / DC; ++c) {
      __syncthreads();                 // the previous tiles are consumed
      load_rows_cols<T, DC, LDC>(Qc, q, qs, b, hk, G, r0, rows, c * DC);
      load_rows_cols<T, DC, LDC>(dOc, dout, ds_, b, hk, G, r0, rows, c * DC);
      if (c == 0 && threadIdx.x < BM) {
        const int r = r0 + threadIdx.x;
        const size_t at = ((size_t)b * Hq + hk * G + r % G) * Sq + r / G;
        Ls[threadIdx.x] = r < rows ? lse[at] : 0.f;
        Ds[threadIdx.x] = r < rows ? delta[at] : 0.f;
      }
      __syncthreads();
      dot_cols<DC, LD, LDC>(st, Ks + c * DC, ty * 4, Qc, tx);
      dot_cols<DC, LD, LDC>(dpt, Vs + c * DC, ty * 4, dOc, tx);
    }
    if (half != DH / DC - 1) {         // the products need this half's chunk
      __syncthreads();
      load_rows_cols<T, DC, LDC>(Qc, q, qs, b, hk, G, r0, rows, half * DC);
      load_rows_cols<T, DC, LDC>(dOc, dout, ds_, b, hk, G, r0, rows,
                                 half * DC);
    }
    float dsr[4][4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int rl = tx + 16 * j, r = r0 + rl;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const bool ok = r < rows && visible(r / G, k0 + ty * 4 + i, Skv,
                                            causal, window);
        const float p = ok ? expf(st[i][j] * scale - Ls[rl]) : 0.f;
        St[(ty * 4 + i) * LDP + rl] = round_as(p, dout);
        dsr[i][j] = round_as(p * (dpt[i][j] - Ds[rl]) * scale, q);
      }
    }
    __syncthreads();                   // p and the half's chunk are ready
    pv_cols<NH, 0>(acc_v, St, ty * 4, dOc, tx);
    __syncthreads();                   // p is consumed
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int i = 0; i < 4; ++i) St[(ty * 4 + i) * LDP + tx + 16 * j] = dsr[i][j];
    __syncthreads();                   // ds is complete
    pv_cols<NH, 0>(acc_k, St, ty * 4, Qc, tx);
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int key = k0 + ty * 4 + i;
    if (key >= Skv) continue;
    const size_t at = (((size_t)b * Skv + key) * Hkv + hk) * DH + half * DC;
#pragma unroll
    for (int c = 0; c < NH; ++c) {
      store(dk + at + acc_col<DC>(tx, c), acc_k[i][c]);
      store(dv + at + acc_col<DC>(tx, c), acc_v[i][c]);
    }
  }
}

template <typename T>
cudaError_t launch256(const void* q, const void* k, const void* v,
                      const void* dout, const float* lse, const float* delta,
                      void* dq, void* dk, void* dv, Strides qs, Strides ks,
                      Strides vs, Strides dos, int B, int Sq, int Skv, int Hq,
                      int Hkv, int causal, int window, float scale,
                      cudaStream_t stream) {
  const T* qt = static_cast<const T*>(q);
  const T* kt = static_cast<const T*>(k);
  const T* vt = static_cast<const T*>(v);
  const T* dot = static_cast<const T*>(dout);
  auto dq_kernel = flash_dq256_kernel<T>;
  auto dkv_kernel = flash_dkv256_kernel<T>;
  constexpr size_t smem_q = dq256_smem(), smem_kv = dkv256_smem();
  cudaError_t err = allow_smem(dq_kernel, smem_q);
  if (err == cudaSuccess) err = allow_smem(dkv_kernel, smem_kv);
  if (err != cudaSuccess) return err;
  const dim3 grid_q((Sq * (Hq / Hkv) + BM - 1) / BM, B * Hkv);
  dq_kernel<<<grid_q, THREADS, smem_q, stream>>>(
      qt, kt, vt, dot, lse, delta, static_cast<T*>(dq), qs, ks, vs, dos, Sq,
      Skv, Hq, Hkv, causal, window, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const dim3 grid_kv((Skv + BN - 1) / BN, B * Hkv, 256 / DC);
  dkv_kernel<<<grid_kv, THREADS, smem_kv, stream>>>(
      qt, kt, vt, dot, lse, delta, static_cast<T*>(dk), static_cast<T*>(dv),
      qs, ks, vs, dos, Sq, Skv, Hq, Hkv, causal, window, scale);
  return cudaGetLastError();
}

template <typename T, int DH>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const void* dout, const float* lse, const float* delta,
                   void* dq, void* dk, void* dv, Strides qs, Strides ks,
                   Strides vs, Strides dos, int B, int Sq, int Skv, int Hq,
                   int Hkv, int causal, int window, float scale,
                   cudaStream_t stream) {
  const T* qt = static_cast<const T*>(q);
  const T* kt = static_cast<const T*>(k);
  const T* vt = static_cast<const T*>(v);
  const T* dot = static_cast<const T*>(dout);
  auto dq_kernel = flash_dq_kernel<T, DH>;
  auto dkv_kernel = flash_dkv_kernel<T, DH>;
  constexpr size_t smem_q = dq_smem<DH>(), smem_kv = dkv_smem<DH>();
  cudaError_t err = allow_smem(dq_kernel, smem_q);
  if (err == cudaSuccess) err = allow_smem(dkv_kernel, smem_kv);
  if (err != cudaSuccess) return err;
  const dim3 grid_q((Sq * (Hq / Hkv) + BM - 1) / BM, B * Hkv);
  dq_kernel<<<grid_q, THREADS, smem_q, stream>>>(
      qt, kt, vt, dot, lse, delta, static_cast<T*>(dq), qs, ks, vs, dos, Sq,
      Skv, Hq, Hkv, causal, window, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const dim3 grid_kv((Skv + BN - 1) / BN, B * Hkv);
  dkv_kernel<<<grid_kv, THREADS, smem_kv, stream>>>(
      qt, kt, vt, dot, lse, delta, static_cast<T*>(dk), static_cast<T*>(dv),
      qs, ks, vs, dos, Sq, Skv, Hq, Hkv, causal, window, scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_dh(int dh, const void* q, const void* k, const void* v,
                      const void* dout, const float* lse, const float* delta,
                      void* dq, void* dk, void* dv, Strides qs, Strides ks,
                      Strides vs, Strides dos, int B, int Sq, int Skv, int Hq,
                      int Hkv, int causal, int window, float scale,
                      cudaStream_t stream) {
  switch (dh) {
#define FA_CASE(D)                                                          \
  case D:                                                                   \
    return launch<T, D>(q, k, v, dout, lse, delta, dq, dk, dv, qs, ks, vs, \
                        dos, B, Sq, Skv, Hq, Hkv, causal, window, scale,    \
                        stream);
    FA_CASE(16)
    FA_CASE(32)
    FA_CASE(64)
    FA_CASE(128)
#undef FA_CASE
    case 256:
      return launch256<T>(q, k, v, dout, lse, delta, dq, dk, dv, qs, ks, vs,
                          dos, B, Sq, Skv, Hq, Hkv, causal, window, scale,
                          stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// q and do (B, Sq, Hq, dh), k and v (B, Skv, Hkv, dh), each with element
// strides (batch, sequence, head) and a unit dh stride; lse and delta
// (B, Hq, Sq) float32 contiguous; dq (B, Sq, Hq, dh), dk and dv
// (B, Skv, Hkv, dh) contiguous, written whole.  dtype 0 = float32 (q, k,
// v, do and the gradients); any other (bf16 goes to
// flash_attention_bwd_wgmma) is refused.  Launches the dq kernel,
// then the dk/dv kernel; returns the first CUDA error code (0 = launched).
extern "C" int flash_attention_bwd(
    const void* q, const void* k, const void* v, const void* dout,
    const void* lse, const void* delta, void* dq, void* dk, void* dv, int B,
    int Sq, int Skv, int Hq, int Hkv, int dh, long long qsb, long long qss,
    long long qsh, long long ksb, long long kss, long long ksh, long long vsb,
    long long vss, long long vsh, long long dsb, long long dss,
    long long dsh, int causal, int window, float scale, int dtype,
    void* stream) {
  if (B == 0 || Sq == 0 || Skv == 0) return 0;
  if (Hkv <= 0 || Hq % Hkv != 0) return cudaErrorInvalidValue;
  const Strides qs{qsb, qss, qsh}, ks{ksb, kss, ksh}, vs{vsb, vss, vsh},
      dos{dsb, dss, dsh};
  const float* l = static_cast<const float*>(lse);
  const float* d = static_cast<const float*>(delta);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (dtype == 0) {
    err = launch_dh<float>(dh, q, k, v, dout, l, d, dq, dk, dv, qs, ks, vs,
                           dos, B, Sq, Skv, Hq, Hkv, causal, window, scale, s);
  } else {
    err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}
