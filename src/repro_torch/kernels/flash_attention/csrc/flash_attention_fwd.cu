// Flash-attention forward for Hopper (sm_90a), plain C interface.
//
// Replaces the TPU kernel flash_attention_fwd
// (src/repro/kernels/flash_attention/kernel.py:101, body _fwd_kernel, skip
// rule _block_visible).  Causal or sliding-window GQA self-attention with an
// online softmax; returns out (B, Sq, Hq, dh) in the input type and
// lse = m + log(l) of the scaled scores as float32 (B, Hq, Sq).  The TPU
// kernel's 128-lane broadcast of lse is a TPU layout and is not kept; any Sq
// works (ragged tiles are masked, not asserted away).
//
// What bounds it on this card: operations.  At the training shape
// (B = 2, S = 2048, Hq = 24, Hkv = 8, dh = 128, causal, bf16) the visible
// (query, key) pairs cost 4 * dh flops each, 51.6 GFLOP, against 67.5 MB of
// q, k, v, out and lse: about 760 flops a byte, above the ~295 where the
// tensor cores rather than memory set the pace.
//
// What the design does:
//   * one block owns one (batch, kv head, 64-row tile) and loops over its
//     own kv tiles, with m and l in registers: the TPU grid's sequential kv
//     axis becomes that loop;
//   * the tile's rows are the G query heads of the kv head together (see
//     flash_tiles.cuh), so each K/V tile is read once for G heads;
//   * the loop walks only the kv tiles the rows can see (causal: up to the
//     last row's position; window: from the first row's oldest key), not
//     every tile with a skip;
//   * blocks are issued longest-first (the last row tiles walk the most kv
//     tiles under causal masking), which shortens the tail of the grid.
// It multiplies with FMA loops in float32 (register tiles of 4 x 4 scores
// a thread), far from the tensor cores' rate, and serves float32 inputs
// only: the JAX package's float32 forward tolerance (2e-5) is out of reach
// of TF32 tensor cores.  bf16 inputs take the tensor-core kernel of
// flash_attention_fwd_wgmma.cu.  Head dims 16 to 256: at dh 256
// (recurrentgemma's local attention, 16 query heads over one kv head, so a
// 64-row tile holds 4 positions of every head) the block takes 150.5 KB of
// shared memory and one block runs per SM.
//
// p is rounded to v's type before the product with v, as the TPU kernel's
// p.astype(v.dtype) does; l sums the unrounded p.  A row with no visible
// key would come out 0 with lse -1e30 (self-attention always sees itself).

#include "flash_tiles.cuh"

namespace {

using namespace fa;

template <int DH>
constexpr size_t fwd_smem() {
  return sizeof(float) * (BM * Tile<DH>::LD + BN * Tile<DH>::LD + BM * LDP);
}

template <typename T, int DH>
__global__ void __launch_bounds__(THREADS)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ out,
                 float* __restrict__ lse, Strides qs, Strides ks, Strides vs,
                 int Sq, int Skv, int Hq, int Hkv, int causal, int window,
                 float scale) {
  constexpr int LD = Tile<DH>::LD, NC = Tile<DH>::NC;
  extern __shared__ float4 smem4[];
  float* Qs = reinterpret_cast<float*>(smem4);   // BM x LD
  float* KVs = Qs + BM * LD;                     // BN x LD: K, then V
  float* Ps = KVs + BN * LD;                     // BM x LDP

  const int G = Hq / Hkv;
  const int rows = Sq * G;
  const int r0 = (gridDim.x - 1 - blockIdx.x) * BM;   // longest rows first
  const int b = blockIdx.y / Hkv, hk = blockIdx.y % Hkv;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;

  load_rows<T, DH>(Qs, q, qs, b, hk, G, r0, rows);

  int qpos[4];
  bool rok[4];
  float m[4], l[4], acc[4][NC];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = r0 + ty * 4 + i;
    rok[i] = r < rows;
    qpos[i] = r / G;
    m[i] = NEG_INF;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < NC; ++c) acc[i][c] = 0.f;
  }

  const Range kr = kv_tiles(r0, rows, G, Skv, causal, window);
  for (int jt = kr.lo; jt <= kr.hi; ++jt) {
    const int k0 = jt * BN;
    __syncthreads();                   // the previous V tile is consumed
    load_keys<T, DH>(KVs, k, ks, b, hk, k0, Skv);
    __syncthreads();
    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
    dot_tile<DH>(s, Qs, ty * 4, KVs, tx);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      bool ok[4];
      float mt = NEG_INF;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        ok[j] = rok[i] && visible(qpos[i], k0 + tx + 16 * j, Skv, causal,
                                  window);
        s[i][j] = ok[j] ? s[i][j] * scale : NEG_INF;
        mt = fmaxf(mt, s[i][j]);
      }
      const float m_new = fmaxf(m[i], max16(mt));
      const float alpha = expf(m[i] - m_new);
      float ls = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = ok[j] ? expf(s[i][j] - m_new) : 0.f;   // re-mask
        ls += p;
        Ps[(ty * 4 + i) * LDP + tx + 16 * j] = round_as(p, v);
      }
      l[i] = l[i] * alpha + sum16(ls);
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < NC; ++c) acc[i][c] *= alpha;
    }
    __syncthreads();                   // K is consumed, P is complete
    load_keys<T, DH>(KVs, v, vs, b, hk, k0, Skv);
    __syncthreads();
    pv_tile<DH>(acc, Ps, ty * 4, KVs, tx);
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    if (!rok[i]) continue;
    const int r = r0 + ty * 4 + i, t = r / G, h = hk * G + r % G;
    const float denom = l[i] > 0.f ? l[i] : 1.f;
    T* o = out + (((size_t)b * Sq + t) * Hq + h) * DH;
#pragma unroll
    for (int c = 0; c < NC; ++c) store(o + acc_col<DH>(tx, c), acc[i][c] / denom);
    if (tx == 0)
      lse[((size_t)b * Hq + h) * Sq + t] = m[i] + logf(fmaxf(l[i], 1e-30f));
  }
}

template <typename T, int DH>
cudaError_t launch(const void* q, const void* k, const void* v, void* out,
                   float* lse, Strides qs, Strides ks, Strides vs, int B,
                   int Sq, int Skv, int Hq, int Hkv, int causal, int window,
                   float scale, cudaStream_t stream) {
  auto kernel = flash_fwd_kernel<T, DH>;
  constexpr size_t smem = fwd_smem<DH>();
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((Sq * (Hq / Hkv) + BM - 1) / BM, B * Hkv);
  kernel<<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out), lse, qs, ks, vs, Sq,
      Skv, Hq, Hkv, causal, window, scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_dh(int dh, const void* q, const void* k, const void* v,
                      void* out, float* lse, Strides qs, Strides ks,
                      Strides vs, int B, int Sq, int Skv, int Hq, int Hkv,
                      int causal, int window, float scale,
                      cudaStream_t stream) {
  switch (dh) {
#define FA_CASE(D)                                                           \
  case D:                                                                    \
    return launch<T, D>(q, k, v, out, lse, qs, ks, vs, B, Sq, Skv, Hq, Hkv, \
                        causal, window, scale, stream);
    FA_CASE(16)
    FA_CASE(32)
    FA_CASE(64)
    FA_CASE(128)
    FA_CASE(256)
#undef FA_CASE
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// q (B, Sq, Hq, dh), k and v (B, Skv, Hkv, dh), each with element strides
// (batch, sequence, head) and a unit dh stride; out (B, Sq, Hq, dh) and lse
// (B, Hq, Sq) contiguous.  dtype 0 = float32 (q, k, v, out); any other
// (bf16 goes to flash_attention_fwd_wgmma) is refused.  Returns the launch's CUDA error code (0 = launched).
extern "C" int flash_attention_fwd(
    const void* q, const void* k, const void* v, void* out, void* lse, int B,
    int Sq, int Skv, int Hq, int Hkv, int dh, long long qsb, long long qss,
    long long qsh, long long ksb, long long kss, long long ksh, long long vsb,
    long long vss, long long vsh, int causal, int window, float scale,
    int dtype, void* stream) {
  if (B == 0 || Sq == 0) return 0;
  if (Hkv <= 0 || Hq % Hkv != 0 || Skv <= 0) return cudaErrorInvalidValue;
  const Strides qs{qsb, qss, qsh}, ks{ksb, kss, ksh}, vs{vsb, vss, vsh};
  float* l = static_cast<float*>(lse);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (dtype == 0) {
    err = launch_dh<float>(dh, q, k, v, out, l, qs, ks, vs, B, Sq, Skv, Hq,
                           Hkv, causal, window, scale, s);
  } else {
    err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}
