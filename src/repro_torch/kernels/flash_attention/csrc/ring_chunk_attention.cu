// Ring-chunk attention forward for Hopper (sm_90a), plain C interface.
//
// Replaces the TPU kernel ring_chunk_attention_fwd
// (src/repro/kernels/flash_attention/kernel.py:220, body _ring_fwd_kernel,
// skip rule _ring_block_visible).  It computes the contract of
// ops.ring_chunk_attention: C chunk queries of each stream attend, under one
// online softmax, over the stream's pre-write ring (W slots) and the chunk's
// own keys.  One band test on absolute positions does all the masking:
//   kp >= 0 && kp <= qp && kp > qp - W   (&& kp > qp - window when set),
// softcap is applied before the mask, GQA picks kv head h / (Hq / Hkv), and a
// row with no visible key is written as 0.
//
// What bounds it on this card: the K/V bytes.  At the serving shape (C = 16
// queries per stream, W = 1024, Hkv = 8, dh = 128, bf16) one call reads at
// most B*W*Hkv*dh*2*2 bytes of ring K/V (only the slots some query can see
// are needed) and does about 4*C*G flops per K/V element
// pair it reads — far below the ~295 flop/byte where the tensor cores would
// become the limit, so the kernel is memory-bound.
//
// What the design does about that:
//   * one thread block owns one (stream, kv head) group and a tile of BM query
//     rows drawn from all G = Hq/Hkv query heads of that group, so the ring of
//     a kv head is read once per (q tile, kv head group), not once per query
//     head;
//   * the block reads the ring and the chunk K/V from their own tensors and
//     computes every key position itself from pos and n_tokens: there is no
//     concatenation copy of the ring (the TPU wrapper's jnp.concatenate copied
//     the whole ring every layer);
//   * the online-softmax state (m, l) lives in registers, the accumulator in
//     registers, the K/V tile in shared memory;
//   * chunk tiles wholly above the causal diagonal of the block's rows, and
//     chunk tiles past n_tokens (all masked), are skipped;
//   * a block walks only the ring and chunk tiles that hold a key some row
//     of it can see, found from pos alone: the never-written slots of a
//     short history (pos < W) and the slots outside a window are neither
//     loaded nor multiplied.
// This first version computes with FMA loops in float32; wgmma and TMA are
// later work.
//
// Layouts (all contiguous): q, out (B, C, Hq, dh); k_new, v_new
// (B, C, Hkv, dh); k_cache, v_cache (B, W, Hkv, dh); pos, n_tokens (B,) int32.
// dtype 0 = float32, 1 = bfloat16 (inputs and output); accumulation float32.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>

namespace {

constexpr int BM = 32;                 // query rows per block
constexpr int BN = 16;                 // keys per tile
constexpr int THREADS = 128;
constexpr int TPR = THREADS / BM;      // threads per query row
constexpr int CPT = BN / TPR;          // tile columns per thread
constexpr int NEVER = -(1 << 30);      // position of a masked chunk key
constexpr float NEG_INF = -1e30f;

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}

template <typename T, int DH>
__global__ void __launch_bounds__(THREADS)
ring_chunk_attention_kernel(const T* __restrict__ q, const T* __restrict__ k_new,
                            const T* __restrict__ v_new,
                            const T* __restrict__ k_cache,
                            const T* __restrict__ v_cache,
                            const int* __restrict__ pos_p,
                            const int* __restrict__ ntok_p, T* __restrict__ out,
                            int C, int W, int Hq, int Hkv, int window,
                            float softcap, float scale) {
  __shared__ float Qs[BM][DH + 1];     // +1: rows of different threads hit
  __shared__ float Ks[BN][DH + 1];     // different banks at the same d
  __shared__ float Vs[BN][DH];
  __shared__ float Ps[BM][BN + 1];
  __shared__ int Kp[BN];

  const int G = Hq / Hkv;
  const int b = blockIdx.x / Hkv;
  const int hk = blockIdx.x % Hkv;
  const int rows = G * C;              // row = g * C + t
  const int r0 = blockIdx.y * BM;
  const int tid = threadIdx.x;
  const int r = tid / TPR;
  const int lane = tid % TPR;
  const int pos = pos_p[b];
  const int ntok = ntok_p[b];

  for (int i = tid; i < BM * DH; i += THREADS) {
    const int rr = i / DH, d = i % DH, row = r0 + rr;
    float x = 0.f;
    if (row < rows) {
      const int g = row / C, t = row % C;
      x = to_float(q[(((size_t)b * C + t) * Hq + hk * G + g) * DH + d]);
    }
    Qs[rr][d] = x;
  }

  const int row = r0 + r;
  const bool row_ok = row < rows;
  const int qp = pos + (row_ok ? row % C : 0);
  // lowest and highest chunk offsets among this block's rows
  const int last = min(r0 + BM, rows) - 1;
  const bool one_head = r0 / C == last / C;
  const int t_lo = one_head ? r0 % C : 0;
  const int t_hi = one_head ? last % C : C - 1;
  // A key at position kp is visible to some row of the block iff
  // kp >= 0 && kp <= pos + t_hi && kp > pos + t_lo - span.  From pos alone
  // that gives the block's key tiles, and only those are walked:
  //   ring: positions [ring_lo, pos - 1] (all held: ring_lo > pos - W), in
  //   slots ring_lo mod W onwards, cyclic, so one or two runs of tiles;
  //   chunk: keys [chunk_lo, min(t_hi + 1, ntok)).
  const int span = window > 0 ? min(W, window) : W;
  const int ring_lo = max(0, pos + t_lo - span + 1);
  const int ring_n = pos - ring_lo;            // visible ring keys, < W
  const int n_ring_tiles = (W + BN - 1) / BN;
  int ra0 = 0, ra_n = 0, rb_n = 0;   // tile runs [ra0, ra0+ra_n), [0, rb_n)
  if (ring_n > 0) {
    const int s0 = ring_lo % W, s1 = s0 + ring_n;   // slots [s0, s1), cyclic
    ra0 = s0 / BN;
    if (s1 <= W) {
      ra_n = (s1 - 1) / BN - ra0 + 1;
    } else {
      rb_n = (s1 - W - 1) / BN + 1;
      if (rb_n > ra0) {                        // the runs meet: every tile
        ra0 = 0;
        ra_n = n_ring_tiles;
        rb_n = 0;
      } else {
        ra_n = n_ring_tiles - ra0;
      }
    }
  }
  const int chunk_lo = max(0, t_lo - span + 1);
  const int chunk_hi = min(t_hi + 1, ntok);    // exclusive
  const int c0 = chunk_lo / BN;
  const int c_n = chunk_hi > chunk_lo ? (chunk_hi - 1) / BN - c0 + 1 : 0;

  float m = NEG_INF, l = 0.f;
  float acc[DH / TPR];
#pragma unroll
  for (int i = 0; i < DH / TPR; ++i) acc[i] = 0.f;

  // tiles in order: ring run a, ring run b, then the chunk's tiles
  const int n_tiles = ra_n + rb_n + c_n;
  for (int k = 0; k < n_tiles; ++k) {
    const int seg = k < ra_n + rb_n ? 0 : 1;  // 0: the ring, 1: the chunk
    const int j0 = BN * (k < ra_n ? ra0 + k
                         : k < ra_n + rb_n ? k - ra_n : c0 + k - ra_n - rb_n);
    const T* Kg = seg == 0 ? k_cache : k_new;
    const T* Vg = seg == 0 ? v_cache : v_new;
    const int n_keys = seg == 0 ? W : C;
    __syncthreads();                   // the previous tile is consumed
    for (int i = tid; i < BN * DH; i += THREADS) {
      const int c = i / DH, d = i % DH, key = j0 + c;
      float kx = 0.f, vx = 0.f;
      if (key < n_keys) {
        const size_t off = (((size_t)b * n_keys + key) * Hkv + hk) * DH + d;
        kx = to_float(Kg[off]);
        vx = to_float(Vg[off]);
      }
      Ks[c][d] = kx;
      Vs[c][d] = vx;
    }
    if (tid < BN) {
      const int key = j0 + tid;
      int kp = NEVER;
      if (seg == 0) {
        if (key < W) {
          const int lastp = pos - 1;
          kp = lastp - (((lastp - key) % W) + W) % W;
        }
      } else if (key < C && key < ntok) {
        kp = pos + key;
      }
      Kp[tid] = kp;
    }
    __syncthreads();

    float s[CPT];
    bool ok[CPT];
#pragma unroll
    for (int j = 0; j < CPT; ++j) s[j] = 0.f;
#pragma unroll 8
    for (int d = 0; d < DH; ++d) {
      const float qv = Qs[r][d];
#pragma unroll
      for (int j = 0; j < CPT; ++j) s[j] += qv * Ks[lane + TPR * j][d];
    }
    float mt = NEG_INF;
#pragma unroll
    for (int j = 0; j < CPT; ++j) {
      float x = s[j] * scale;
      if (softcap > 0.f) x = softcap * tanhf(x / softcap);
      const int kp = Kp[lane + TPR * j];
      ok[j] = row_ok && kp >= 0 && kp <= qp && kp > qp - W &&
              (window == 0 || kp > qp - window);
      s[j] = ok[j] ? x : NEG_INF;
      mt = fmaxf(mt, s[j]);
    }
    // the TPR threads of a row are adjacent lanes of one warp
    mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, 1));
    mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, 2));
    const float m_new = fmaxf(m, mt);
    const float alpha = expf(m - m_new);
    float ls = 0.f;
#pragma unroll
    for (int j = 0; j < CPT; ++j) {
      const float p = ok[j] ? expf(s[j] - m_new) : 0.f;   // re-mask
      Ps[r][lane + TPR * j] = p;
      ls += p;
    }
    ls += __shfl_xor_sync(0xffffffffu, ls, 1);
    ls += __shfl_xor_sync(0xffffffffu, ls, 2);
    l = l * alpha + ls;
    m = m_new;
    __syncwarp();
#pragma unroll
    for (int i = 0; i < DH / TPR; ++i) acc[i] *= alpha;
#pragma unroll
    for (int c = 0; c < BN; ++c) {
      const float p = Ps[r][c];
#pragma unroll
      for (int i = 0; i < DH / TPR; ++i) acc[i] += p * Vs[c][lane + TPR * i];
    }
  }

  if (row_ok) {
    const int g = row / C, t = row % C;
    const float denom = l > 0.f ? l : 1.f;
    T* o = out + (((size_t)b * C + t) * Hq + hk * G + g) * DH;
#pragma unroll
    for (int i = 0; i < DH / TPR; ++i) store(o + lane + TPR * i, acc[i] / denom);
  }
}

template <typename T>
cudaError_t launch_typed(const void* q, const void* kn, const void* vn,
                         const void* kc, const void* vc, const int* pos,
                         const int* ntok, void* out, int B, int C, int W,
                         int Hq, int Hkv, int dh, int window, float softcap,
                         float scale, cudaStream_t stream) {
  const dim3 grid(B * Hkv, (Hq / Hkv * C + BM - 1) / BM);
  const T* qt = static_cast<const T*>(q);
  const T* knt = static_cast<const T*>(kn);
  const T* vnt = static_cast<const T*>(vn);
  const T* kct = static_cast<const T*>(kc);
  const T* vct = static_cast<const T*>(vc);
  T* ot = static_cast<T*>(out);
#define RCA_LAUNCH(D)                                                        \
  ring_chunk_attention_kernel<T, D><<<grid, THREADS, 0, stream>>>(           \
      qt, knt, vnt, kct, vct, pos, ntok, ot, C, W, Hq, Hkv, window, softcap, \
      scale)
  switch (dh) {
    case 16: RCA_LAUNCH(16); break;
    case 32: RCA_LAUNCH(32); break;
    case 64: RCA_LAUNCH(64); break;
    case 128: RCA_LAUNCH(128); break;
    default: return cudaErrorInvalidValue;
  }
#undef RCA_LAUNCH
  return cudaGetLastError();
}

}  // namespace

extern "C" int ring_chunk_attention(const void* q, const void* k_new,
                                    const void* v_new, const void* k_cache,
                                    const void* v_cache, const void* pos,
                                    const void* n_tokens, void* out, int B,
                                    int C, int W, int Hq, int Hkv, int dh,
                                    int window, float softcap, float scale,
                                    int dtype, void* stream) {
  if (B == 0 || C == 0) return 0;
  if (Hkv <= 0 || Hq % Hkv != 0 || W <= 0) return cudaErrorInvalidValue;
  const int* p = static_cast<const int*>(pos);
  const int* n = static_cast<const int*>(n_tokens);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (dtype == 0) {
    err = launch_typed<float>(q, k_new, v_new, k_cache, v_cache, p, n, out, B,
                              C, W, Hq, Hkv, dh, window, softcap, scale, s);
  } else if (dtype == 1) {
    err = launch_typed<__nv_bfloat16>(q, k_new, v_new, k_cache, v_cache, p, n,
                                      out, B, C, W, Hq, Hkv, dh, window,
                                      softcap, scale, s);
  } else {
    err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}
