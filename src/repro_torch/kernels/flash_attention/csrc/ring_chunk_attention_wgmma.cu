// Ring-chunk attention on Hopper's tensor cores (sm_90a), bf16, plain C
// interface.
//
// Replaces the TPU kernel ring_chunk_attention_fwd
// (src/repro/kernels/flash_attention/kernel.py:220, body _ring_fwd_kernel)
// for bf16 inputs; float32 inputs take ring_chunk_attention.cu (FMA loops),
// since the float32 tolerance of the JAX package's tests (5e-5) is out of
// reach of TF32 tensor cores.  The contract is ops.ring_chunk_attention's:
// the C chunk queries of a stream attend, under one softmax, over the
// stream's pre-write ring (W slots) and the chunk's own keys.  One band test
// on absolute positions does all the masking:
//   kp >= 0 && kp <= qp && kp > qp - W   (&& kp > qp - window when set),
// softcap is applied before the mask, query head h reads kv head h / G
// (G = Hq / Hkv), and a row with no visible key is written as 0.
//
// What bounds it on this card: latency, not bytes or operations.  At the
// serving shape (B 8, C 16, W 1024, 32 query heads over 8, dh 128) the K/V
// bytes some query can see take 0.006 ms at 3.35 TB/s and the products less;
// the time goes to launches, TMA round trips and the serial walk of a ring.
//
// What the design does:
//   * the G query heads of a kv head times the chunk's C rows share one K/V
//     stream: row r = t * G + g, 64 rows to a wgmma M tile (G * C = 64 at
//     llama3-8b's shape; rows past G * C are zero and masked);
//   * the ring is split across blocks (flash-decoding): one block owns one
//     (stream, kv head, M tile, split).  A ring split is a range of
//     split_tiles tiles of 64 slots, so a TMA box never wraps; the chunk's
//     own keys form the last split.  The split count comes from shapes alone
//     (ops.ring_split), never from pos or n_tokens, which stay on the card.
//     A split walks at least 4 tiles: narrower splits pay for more blocks
//     and a longer merge, wider ones for a longer serial walk
//     (chip_smoke.py --ring-splits times both sides);
//   * a block walks only the tiles of its split that hold a key some row of
//     it can see, found from pos and n_tokens read on the card; a split with
//     none marks its partial empty and exits;
//   * a producer warp loads K and V tiles straight from k_cache / v_cache
//     (B, W, Hkv, dh) and k_new / v_new (B, C, Hkv, dh) by TMA into a ring of
//     two stages (hopper.cuh's maps: boxes past W or C read as zeros and are
//     masked); the consumer warpgroup loads its Q tile with 16-byte loads
//     into the same swizzled layout, then computes S = Q K^T (wgmma, both
//     operands in shared memory) and O += P V (wgmma, P from registers,
//     rounded to bf16 as _ring_fwd_kernel's p.astype(v.dtype) does);
//   * a key's position comes from its slot with one compare: no integer
//     division per key, which the softmax's critical path would wait on;
//   * each block writes its rows' normalised partial o (float32) and
//     log-sum-exp to a workspace the wrapper allocates; a second kernel
//     merges the splits of each row in split order (bit-identical reruns)
//     and writes the bf16 output; a row whose splits are all empty is 0.
// Layouts: q (B, C, Hq, dh) and the four K/V tensors with element strides
// (batch, sequence, head) and a unit dh stride, 16-byte-aligned bases and
// strides of whole 16-byte units (the wrapper checks it); pos, n_tokens (B,)
// int32; out (B, C, Hq, dh) bf16, contiguous.

#include "hopper.cuh"

namespace {

using namespace hk;

constexpr int BM = 64;         // query rows a block: one wgmma M tile
constexpr int BN = 64;         // slots or chunk keys a K/V tile (one TMA box)
constexpr int STAGES = 2;
constexpr int CONSUMERS = 128; // one warpgroup
constexpr int THREADS = CONSUMERS + 32;   // and a producer warp
constexpr int NEVER = -(1 << 30);         // position of a masked chunk key

template <int D>
struct RingSmem {
  static constexpr size_t Q = (size_t)BM * D * 2;
  static constexpr size_t KV = (size_t)BN * D * 2;   // one K or V tile
  static constexpr size_t TOTAL = 1024 + Q + 2 * STAGES * KV + 128;
};

struct Geo {
  int B, C, W, Hq, Hkv, G, n_mt, n_split, split_tiles, window;
  long long qsb, qss, qsh;
  float scale, softcap;
};

// The tiles [j0, j1) of a block's split, and which of them hold a key some
// row of the block can see.  Ring: the block sees the positions
// [ring_lo, pos - 1], held in the n slots from s0 onwards, cyclic.  Chunk:
// every tile of [j0, j1) holds one.
struct Walk {
  int j0, j1, s0, n;
  bool chunk;

  __device__ bool visible(int j, int W) const {
    if (chunk) return true;
    const int a = j * BN, len = min(BN, W - a);
    const int d = ((a - s0) % W + W) % W;
    return d < n || d + len > W;
  }
};

__device__ Walk make_walk(const Geo& g, int split, int pos, int ntok, int t_lo,
                          int t_hi) {
  const int span = g.window > 0 ? min(g.W, g.window) : g.W;
  Walk w;
  w.chunk = split == g.n_split - 1;
  if (!w.chunk) {
    const int ring_lo = max(0, pos + t_lo - span + 1);
    w.n = pos - ring_lo;                      // < W
    w.s0 = ring_lo % g.W;
    w.j0 = split * g.split_tiles;
    w.j1 = w.n > 0 ? min(w.j0 + g.split_tiles, (g.W + BN - 1) / BN) : w.j0;
  } else {
    const int lo = max(0, t_lo - span + 1);
    const int hi = min(t_hi + 1, ntok);       // exclusive
    w.n = 0;
    w.s0 = 0;
    w.j0 = lo / BN;
    w.j1 = hi > lo ? (hi - 1) / BN + 1 : w.j0;
  }
  return w;
}

__device__ __forceinline__ void fence_async_shared() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}
__device__ __forceinline__ void consumers_sync() {
  asm volatile("bar.sync 1, %0;\n" ::"n"(CONSUMERS) : "memory");
}

template <int D>
__global__ void __launch_bounds__(THREADS, 1)
ring_wgmma_kernel(const __grid_constant__ CUtensorMap kc_map,
                  const __grid_constant__ CUtensorMap vc_map,
                  const __grid_constant__ CUtensorMap kn_map,
                  const __grid_constant__ CUtensorMap vn_map,
                  const __nv_bfloat16* __restrict__ q,
                  const int* __restrict__ pos_p, const int* __restrict__ ntok_p,
                  float* __restrict__ part_o, float* __restrict__ part_lse,
                  Geo g) {
  using L = RingSmem<D>;
  extern __shared__ char smem_raw[];
  char* smem = reinterpret_cast<char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  char* Qs = smem;
  char* Ks = Qs + L::Q;                       // STAGES tiles
  char* Vs = Ks + STAGES * L::KV;             // STAGES tiles
  uint64_t* bars = reinterpret_cast<uint64_t*>(Vs + STAGES * L::KV);
  uint64_t* k_full = bars;
  uint64_t* v_full = k_full + STAGES;
  uint64_t* empty = v_full + STAGES;

  const int split = blockIdx.x;
  const int mt = blockIdx.y % g.n_mt, hk = blockIdx.y / g.n_mt;
  const int b = blockIdx.z;
  const int rows = g.G * g.C;
  const int r0 = mt * BM;
  const int t_lo = r0 / g.G, t_hi = (min(r0 + BM, rows) - 1) / g.G;
  const int pos = pos_p[b], ntok = ntok_p[b];
  const Walk wk = make_walk(g, split, pos, ntok, t_lo, t_hi);
  // this block's 64 partial rows
  const size_t part = (((size_t)b * g.Hkv + hk) * g.n_mt + mt) * g.n_split +
                      split;

  bool any = false;
  for (int j = wk.j0; j < wk.j1 && !any; ++j) any = wk.visible(j, g.W);
  if (!any) {                       // nothing to see: an empty partial
    if (threadIdx.x < BM) part_lse[part * BM + threadIdx.x] = NEG_INF;
    return;
  }

  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(k_full + s, 1);
      mbar_init(v_full + s, 1);
      mbar_init(empty + s, CONSUMERS);
    }
    fence_barrier_init();
  }
  __syncthreads();

  const CUtensorMap* kmap = wk.chunk ? &kn_map : &kc_map;
  const CUtensorMap* vmap = wk.chunk ? &vn_map : &vc_map;
  if (threadIdx.x >= CONSUMERS) {
    // ---- producer warp: one thread issues every TMA load ----
    if (threadIdx.x == CONSUMERS) {
      prefetch_map(kmap);
      prefetch_map(vmap);
      int it = 0;
      for (int j = wk.j0; j < wk.j1; ++j) {
        if (!wk.visible(j, g.W)) continue;
        const int s = it % STAGES;
        mbar_wait(empty + s, ((it / STAGES) & 1) ^ 1);
        mbar_expect_tx(k_full + s, (uint32_t)L::KV);
        tma_tile<D, BN>(Ks + s * L::KV, 0, kmap, k_full + s, hk, j * BN, b);
        mbar_expect_tx(v_full + s, (uint32_t)L::KV);
        tma_tile<D, BN>(Vs + s * L::KV, 0, vmap, v_full + s, hk, j * BN, b);
        ++it;
      }
    }
    return;
  }

  // ---- consumer warpgroup ----
  const int t = threadIdx.x;
  {
    // Q rows r0 .. r0 + 63 in the layout TMA would give them: column blocks
    // of CW columns, rows of WB bytes, 16-byte units swizzled by the address
    // bits 7.. (TMA's 128, 64 or 32-byte swizzle; hopper.cuh)
    constexpr int CW = D < 64 ? D : 64, WB = 2 * CW;
    constexpr uint32_t SWZ = WB == 128 ? 7 : WB == 64 ? 3 : 1;
    constexpr int UNITS = D / 8;              // 16-byte units a row
    for (int i = t; i < BM * UNITS; i += CONSUMERS) {
      const int r = i / UNITS, c = (i % UNITS) * 8, row = r0 + r;
      uint4 v = make_uint4(0u, 0u, 0u, 0u);
      if (row < rows) {
        const int tq = row / g.G, gq = row % g.G;
        v = *reinterpret_cast<const uint4*>(
            q + b * g.qsb + tq * g.qss + (hk * g.G + gq) * g.qsh + c);
      }
      const uint32_t off = (c / CW) * BM * WB + r * WB + (c % CW) * 2;
      *reinterpret_cast<uint4*>(Qs + (off ^ (((off >> 7) & SWZ) << 4))) = v;
    }
    fence_async_shared();             // generic-proxy writes -> wgmma reads
    consumers_sync();
  }

  // this thread's two rows of the tile, and their query positions
  const int ra = r0 + acc_row(t, 0), rb = ra + 8;
  const bool oka = ra < rows, okb = rb < rows;
  const int qa = pos + (oka ? ra / g.G : 0), qb = pos + (okb ? rb / g.G : 0);
  // slot s < W holds position lastp - ((lastp - s) mod W), lastp = pos - 1;
  // with lw = lastp mod W that is lastp - (lw - s), plus W where s > lw
  const int lastp = pos - 1;
  const int lw = (lastp % g.W + g.W) % g.W;
  float o[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
  float m[2] = {NEG_INF, NEG_INF}, l[2] = {0.f, 0.f};
  const uint32_t q_addr = smem_u32(Qs);

  int it = 0;
  for (int j = wk.j0; j < wk.j1; ++j) {
    if (!wk.visible(j, g.W)) continue;
    const int s = it % STAGES, ph = (it / STAGES) & 1;
    // positions of this thread's 16 key columns 8 n + 2 (t % 4) + e
    int kp[16];
#pragma unroll
    for (int n = 0; n < 8; ++n) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int key = j * BN + 8 * n + 2 * (t % 4) + e;
        int p = NEVER;
        if (wk.chunk) {
          if (key < g.C && key < ntok) p = pos + key;
        } else if (key < g.W) {
          p = lastp - (lw - key) - (key > lw ? g.W : 0);
        }
        kp[2 * n + e] = p;
      }
    }

    float sc[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) sc[i] = 0.f;
    mbar_wait(k_full + s, ph);
    const uint32_t k_addr = smem_u32(Ks + s * L::KV);
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      wgmma_ss_n64(sc, desc_k<D, BM>(q_addr, 0, kk),
                   desc_k<D, BN>(k_addr, 0, kk), 1);
    wg_commit();
    wg_wait<0>();
    fence_regs(sc);

    float mt_[2] = {NEG_INF, NEG_INF};
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const int r = (i >> 1) & 1;
      float x = sc[i] * g.scale;
      if (g.softcap > 0.f) x = g.softcap * tanhf(x / g.softcap);
      const int kpos = kp[2 * (i >> 2) + (i & 1)];
      const int qp = r ? qb : qa;
      const bool ok = (r ? okb : oka) && kpos >= 0 && kpos <= qp &&
                      kpos > qp - g.W &&
                      (g.window == 0 || kpos > qp - g.window);
      sc[i] = ok ? x * LOG2E : NEG_INF;
      mt_[r] = fmaxf(mt_[r], sc[i]);
    }
    float alpha[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mt_[r] = fmaxf(mt_[r], __shfl_xor_sync(0xffffffffu, mt_[r], 1));
      mt_[r] = fmaxf(mt_[r], __shfl_xor_sync(0xffffffffu, mt_[r], 2));
      const float m_new = fmaxf(m[r], mt_[r]);
      alpha[r] = exp2f(m[r] - m_new);
      m[r] = m_new;
      l[r] *= alpha[r];
    }
    uint32_t pa[4][4];
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const int r = (i >> 1) & 1;
      // a masked score stays masked (p = 0) even in a row with no visible
      // key yet, where m is still NEG_INF
      const float p = sc[i] > 0.5f * NEG_INF ? exp2f(sc[i] - m[r]) : 0.f;
      l[r] += p;
      sc[i] = p;
    }
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) acc_to_a(sc, kk, pa[kk]);
#pragma unroll
    for (int i = 0; i < D / 2; ++i) o[i] *= alpha[(i >> 1) & 1];

    mbar_wait(v_full + s, ph);
    const uint32_t v_addr = smem_u32(Vs + s * L::KV);
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      wgmma_rs<D>(o, pa[kk], desc_mn<D, BN>(v_addr, kk));
    wg_commit();
    wg_wait<0>();
    fence_regs(o);
    mbar_arrive(empty + s);
    ++it;
  }

  // the partial: o / l and lse = ln(sum of exp) per row; a row that saw no
  // key in this split has lse NEG_INF and no o
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = acc_row(t, 0) + 8 * r;
    const bool seen = (r ? okb : oka) && l[r] > 0.f;
    if (t % 4 == 0)
      part_lse[part * BM + row] = seen ? m[r] * LN2 + logf(l[r]) : NEG_INF;
    if (!seen) continue;
    const float inv = 1.f / l[r];
    float* orow = part_o + (part * BM + row) * D;
#pragma unroll
    for (int i = 2 * r; i < D / 2; i += 4) {
      // elements i, i + 1 of this row: columns acc_col(t, i), + 1
      *reinterpret_cast<float2*>(orow + acc_col(t, i)) =
          make_float2(o[i] * inv, o[i + 1] * inv);
    }
  }
}

// One warp an output row (b, t, h): the log-sum-exp merge of the row's
// partials, in split order.
template <int D>
__global__ void __launch_bounds__(256)
ring_combine_kernel(const float* __restrict__ part_o,
                    const float* __restrict__ part_lse,
                    __nv_bfloat16* __restrict__ out, Geo g) {
  constexpr int PER = D >= 32 ? D / 32 : 1;
  const int w = (blockIdx.x * 256 + threadIdx.x) / 32, lane = threadIdx.x % 32;
  if (w >= g.B * g.C * g.Hq) return;
  const int h = w % g.Hq, tq = (w / g.Hq) % g.C, b = w / (g.Hq * g.C);
  const int hk = h / g.G, row = tq * g.G + h % g.G;
  const size_t first = (((size_t)b * g.Hkv + hk) * g.n_mt + row / BM) *
                       g.n_split;
  const int r = row % BM;
  float mx = NEG_INF;
  for (int s = 0; s < g.n_split; ++s)
    mx = fmaxf(mx, part_lse[(first + s) * BM + r]);
  float acc[PER], den = 0.f;
#pragma unroll
  for (int k = 0; k < PER; ++k) acc[k] = 0.f;
  if (mx > 0.5f * NEG_INF) {
    for (int s = 0; s < g.n_split; ++s) {
      const float lse = part_lse[(first + s) * BM + r];
      if (lse <= 0.5f * NEG_INF) continue;
      const float wt = expf(lse - mx);
      den += wt;
      const float* o = part_o + ((first + s) * BM + r) * D;
#pragma unroll
      for (int k = 0; k < PER; ++k) {
        const int c = lane + 32 * k;
        if (c < D) acc[k] += wt * o[c];
      }
    }
  }
  const float inv = den > 0.f ? 1.f / den : 0.f;
  __nv_bfloat16* orow = out + (((size_t)b * g.C + tq) * g.Hq + h) * D;
#pragma unroll
  for (int k = 0; k < PER; ++k) {
    const int c = lane + 32 * k;
    if (c < D) orow[c] = __float2bfloat16(acc[k] * inv);
  }
}

template <int D>
cudaError_t launch(const CUtensorMap& kc, const CUtensorMap& vc,
                   const CUtensorMap& kn, const CUtensorMap& vn,
                   const void* q, const int* pos, const int* ntok,
                   float* part_o, float* part_lse, void* out, const Geo& g,
                   cudaStream_t stream) {
  auto kernel = ring_wgmma_kernel<D>;
  constexpr size_t smem = RingSmem<D>::TOTAL;
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(g.n_split, g.Hkv * g.n_mt, g.B);
  kernel<<<grid, THREADS, smem, stream>>>(
      kc, vc, kn, vn, static_cast<const __nv_bfloat16*>(q), pos, ntok, part_o,
      part_lse, g);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const long long warps = (long long)g.B * g.C * g.Hq;
  ring_combine_kernel<D><<<(unsigned)((warps + 7) / 8), 256, 0, stream>>>(
      part_o, part_lse, static_cast<__nv_bfloat16*>(out), g);
  return cudaGetLastError();
}

}  // namespace

// q (B, C, Hq, dh), k_new / v_new (B, C, Hkv, dh), k_cache / v_cache
// (B, W, Hkv, dh), bf16, each with element strides (batch, sequence, head);
// pos, n_tokens (B,) int32; part_o float32 of B * Hkv * n_mt * n_split * 64
// rows of dh and part_lse of as many values (n_mt = ceil(G * C / 64));
// out (B, C, Hq, dh) bf16, contiguous.  A ring split walks split_tiles tiles
// of 64 slots; n_split counts the ring splits and the chunk's.  Returns the
// CUDA error code of the launches (0 = launched).
extern "C" int ring_chunk_attention_wgmma(
    const void* q, const void* k_new, const void* v_new, const void* k_cache,
    const void* v_cache, const void* pos, const void* n_tokens, void* part_o,
    void* part_lse, void* out, int B, int C, int W, int Hq, int Hkv, int dh,
    long long qsb, long long qss, long long qsh, long long knsb,
    long long knss, long long knsh, long long vnsb, long long vnss,
    long long vnsh, long long kcsb, long long kcss, long long kcsh,
    long long vcsb, long long vcss, long long vcsh, int window,
    float softcap, float scale, int split_tiles, int n_split, void* stream) {
  if (B == 0 || C == 0) return 0;
  if (Hkv <= 0 || Hq % Hkv != 0 || W <= 0 || split_tiles <= 0)
    return cudaErrorInvalidValue;
  const int ring_tiles = (W + BN - 1) / BN;
  if (n_split != (ring_tiles + split_tiles - 1) / split_tiles + 1)
    return cudaErrorInvalidValue;
  CUtensorMap kc, vc, kn, vn;
  cudaError_t err = make_map(&kc, k_cache, B, W, Hkv, dh, kcsb, kcss, kcsh);
  if (err == cudaSuccess)
    err = make_map(&vc, v_cache, B, W, Hkv, dh, vcsb, vcss, vcsh);
  if (err == cudaSuccess)
    err = make_map(&kn, k_new, B, C, Hkv, dh, knsb, knss, knsh);
  if (err == cudaSuccess)
    err = make_map(&vn, v_new, B, C, Hkv, dh, vnsb, vnss, vnsh);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int G = Hq / Hkv;
  const Geo g{B,      C,          W,           Hq,          Hkv,
              G,      (G * C + BM - 1) / BM,   n_split,     split_tiles,
              window, qsb,        qss,         qsh,         scale,
              softcap};
  const int* p = static_cast<const int*>(pos);
  const int* n = static_cast<const int*>(n_tokens);
  float* po = static_cast<float*>(part_o);
  float* pl = static_cast<float*>(part_lse);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dh) {
    case 16: err = launch<16>(kc, vc, kn, vn, q, p, n, po, pl, out, g, s); break;
    case 32: err = launch<32>(kc, vc, kn, vn, q, p, n, po, pl, out, g, s); break;
    case 64: err = launch<64>(kc, vc, kn, vn, q, p, n, po, pl, out, g, s); break;
    case 128: err = launch<128>(kc, vc, kn, vn, q, p, n, po, pl, out, g, s); break;
    case 256: err = launch<256>(kc, vc, kn, vn, q, p, n, po, pl, out, g, s); break;
    default: err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}
