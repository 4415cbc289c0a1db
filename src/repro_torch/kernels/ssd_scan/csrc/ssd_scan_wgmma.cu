// Mamba2 SSD chunked scan on Hopper's tensor cores (sm_90a), bf16 B and C,
// plain C interface.
//
// Replaces the TPU kernel ssd_scan (src/repro/kernels/ssd_scan/kernel.py:72,
// body _ssd_kernel) for bf16 B and C; float32 B and C take ssd_scan.cu (FMA
// loops).  The contract is ssd_scan.cu's: in the head-major layout
//   xdt (BH, S, P) float32 dt-weighted inputs, a (BH, S) float32 log-decays,
//   B and C (BG, S, N) bf16, head b reading group b / G,
// it returns y (BH, S, P) float32 and the final state h (BH, N, P) float32,
// where per chunk of Q steps (a_cum the inclusive cumulative sum of a over
// the chunk)
//   y[q]   = sum_{k <= q} exp(a_cum[q] - a_cum[k]) (C[q] . B[k]) xdt[k]
//          + exp(a_cum[q]) C[q] @ h_prev
//   h_next = exp(a_cum[Q-1]) h_prev + sum_k exp(a_cum[Q-1] - a_cum[k]) B[k] xdt[k]^T
// with h_prev the state before the chunk (0 before the first).
//
// What bounds it on this card: bytes.  At the training shape (mamba2-780m,
// B 4, S 2048: BH 192, P 64, N 128, Q 256, one group of 48 heads a batch
// row) xdt, a, B, C, y and h are 213 MB, 0.064 ms at 3.35 TB/s; the
// tensor-core products below are about 45 GFLOP, 0.046 ms at 989 TFLOP/s.
//
// Precision.  B and C are exact bf16 operands.  Each float32 operand — xdt,
// the decay-weighted scores, the carried state — is split in two bf16
// parts, hi = bf16(v) and lo = bf16(v - hi), about 16 bits of mantissa.  A
// product of a float32 and a bf16 operand takes hi*b + lo*b, one of two
// float32 operands hi*hi + hi*lo + lo*hi (lo*lo is dropped); wgmma sums in
// float32.  ref.ssd_scan_split_ref is this arithmetic in plain PyTorch.
//
// What the design does:
//   * Three launches, as ssd_scan.cu: ssd_state_wgmma (each chunk's own state
//     contribution, and a_cum written for the other two), ssd_pass (the
//     short sequential pass over the chunks: the state before each chunk,
//     and the final state), ssd_scan_wgmma (the outputs).
//   * C B^T once for the heads of a group.  A block of ssd_scan_wgmma owns a
//     64-row tile r of a chunk of one group and a set of that group's heads.
//     It computes S_r = C_r B_j^T for the key tiles j <= r once (wgmma, bf16
//     operands in shared memory, float32 sums) and keeps it in shared
//     memory as float32, in the accumulator's register order, so each
//     thread reads back its own elements without a bank conflict.  The set
//     size comes from the shapes (ops.ssd_head_sets); at the training shape
//     sets of 12 heads give 512 blocks.  Blocks of the longest row tiles
//     come first in the grid: tile r visits r + 1 key tiles.
//   * Three warpgroups take the set's heads (and 64-column tiles of P) in
//     turn.  Per head, y starts as exp(a_cum) o (C_r h_prev): C_r from
//     shared memory (K-major), the state before the chunk split into hi/lo
//     tiles (MN-major).  Then P_h = S_r o exp(a_cum[q] - a_cum[k]) for
//     k <= q is formed in registers (the exponent only where k <= q: above
//     the diagonal it is positive and exp of it could be inf), split into
//     hi/lo register A operands (the accumulator layout of m64nN is the
//     register layout of the A operand) and multiplied into y by the keys'
//     xdt, split into hi/lo tiles in shared memory.  The state's and xdt's
//     float32 tiles stream through a double buffer, each loaded into
//     registers while the one before it is multiplied.
//   * ssd_state_wgmma: a block loads B's rows of a chunk once for a set of
//     heads; per head the chunk's contribution, transposed, is
//     (decay_end o xdt)^T B: xdt comes from device memory straight into the
//     A operand's registers, split into hi/lo, and B's tile is read
//     MN-major.
//   * B's and C's rows come in by TMA (maps through cudaGetDriverEntryPoint,
//     hopper.cuh) where N is 16, 32, 64, 128 or 256 and the bases are
//     16-byte aligned; otherwise by plain loads as wide as N and the bases
//     allow (N = 20: 8-byte loads), written into the same swizzled layout
//     by hand, zero-padded to the next of those sizes.  Rows past the
//     chunk are masked; rows past S read as 0.
//   * Hand-written tiles are followed by fence.proxy.async before wgmma
//     reads them.  The mbarrier wait has no trap.  No atomics: reruns are
//     bit-identical.
// Layouts: every tensor contiguous; states (BH, S / Q, N, P) and a_cum
// (BH, S) float32 are scratch the wrapper allocates.

#include <type_traits>

#include "hopper.cuh"

namespace {

using namespace hk;

constexpr int T = 64;              // rows, keys and P columns of a tile
constexpr int WG = 128;            // threads of a warpgroup
constexpr int XT = T * T * 2;      // one bf16 part of a 64 x 64 tile, bytes
constexpr int NWG = 3;             // warpgroups of a scan block
constexpr int MAX_SMEM = 232448;   // a block's shared memory on the H100

__host__ __device__ constexpr int imin(int a, int b) { return a < b ? a : b; }
__host__ __device__ constexpr int imax(int a, int b) { return a > b ? a : b; }

struct Geo {
  int BH, S, P, N, Q, nc, G, BG;
  int KT;          // 64-row tiles of a chunk
  int CT;          // 64-column tiles of P
  int heads1, sets1, heads3, sets3;
  int vec;         // 0: B and C by TMA; else plain loads of vec elements
};

__device__ __forceinline__ char* align1024(char* p) {
  return reinterpret_cast<char*>((reinterpret_cast<uintptr_t>(p) + 1023) &
                                 ~uintptr_t(1023));
}

__device__ __forceinline__ void fence_async_shared() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// The 128 threads of warpgroup w (barrier 1 + w; 0 is __syncthreads).
__device__ __forceinline__ void wg_sync(int w) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(1 + w), "n"(WG) : "memory");
}

// Byte offset of element (r, c) in a tile of R rows by D bf16 columns, in
// TMA's layout (hopper.cuh): column blocks of CW = min(D, 64) columns, rows
// of W = 2 CW bytes, 16-byte units swizzled by the address bits 7..
template <int D, int R>
__device__ __forceinline__ uint32_t tile_off(int r, int c) {
  constexpr int CW = D < 64 ? D : 64, W = 2 * CW;
  constexpr uint32_t SWZ = W == 128 ? 7 : W == 64 ? 3 : 1;
  const uint32_t off = (c / CW) * R * W + r * W + (c % CW) * 2;
  return off ^ (((off >> 7) & SWZ) << 4);
}

// Rows [0, 64) of a (rows x N) bf16 matrix from row0 on into a (64 x NP)
// tile by plain loads of vec elements; rows >= rows_left and columns >= N
// are 0.  N is a multiple of vec and the base is vec * 2-byte aligned.
template <int NP>
__device__ void load_rows(char* tile, const __nv_bfloat16* __restrict__ m,
                          int N, int vec, long long row0, int rows_left,
                          int tid, int nth) {
  const int units = NP / vec;
  for (int e = tid; e < T * units; e += nth) {
    const int r = e / units, c = (e % units) * vec;
    const bool ok = r < rows_left && c < N;
    const __nv_bfloat16* src = m + (row0 + r) * N + c;
    char* dst = tile + tile_off<NP, T>(r, c);
    if (vec == 8) {
      uint4 v = make_uint4(0u, 0u, 0u, 0u);
      if (ok) v = *reinterpret_cast<const uint4*>(src);
      *reinterpret_cast<uint4*>(dst) = v;
    } else if (vec == 4) {
      uint2 v = make_uint2(0u, 0u);
      if (ok) v = *reinterpret_cast<const uint2*>(src);
      *reinterpret_cast<uint2*>(dst) = v;
    } else if (vec == 2) {
      uint32_t v = 0u;
      if (ok) v = *reinterpret_cast<const uint32_t*>(src);
      *reinterpret_cast<uint32_t*>(dst) = v;
    } else {
      uint16_t v = 0;
      if (ok) v = *reinterpret_cast<const uint16_t*>(src);
      *reinterpret_cast<uint16_t*>(dst) = v;
    }
  }
}

// Rows [0, 64) of a float32 matrix (row stride P) at src, columns
// p0 .. p0 + 63, into registers: thread t holds the 16-byte units
// e = t + 128 u (u < 4), row e / 8, columns 8 (e % 8) .. + 7, as v[2u] and
// v[2u + 1].  Rows >= valid and columns >= P read as 0.  wide: P % 4 == 0
// and src 16-byte aligned (whole units by two float4 loads).
__device__ __forceinline__ void load_tile(float4 (&v)[8],
                                          const float* __restrict__ src,
                                          int P, int p0, int valid, bool wide,
                                          int t) {
#pragma unroll
  for (int u = 0; u < 4; ++u) {
    const int e = t + WG * u, row = e / 8, c = (e % 8) * 8;
    const float* s = src + (long long)row * P + p0 + c;
    if (row < valid && wide && p0 + c + 8 <= P) {
      v[2 * u] = *reinterpret_cast<const float4*>(s);
      v[2 * u + 1] = *reinterpret_cast<const float4*>(s + 4);
    } else {
      float w[8];
#pragma unroll
      for (int k = 0; k < 8; ++k)
        w[k] = row < valid && p0 + c + k < P ? s[k] : 0.f;
      v[2 * u] = make_float4(w[0], w[1], w[2], w[3]);
      v[2 * u + 1] = make_float4(w[4], w[5], w[6], w[7]);
    }
  }
}

__device__ __forceinline__ void split2(float a, float b, uint32_t& hi,
                                       uint32_t& lo) {
  const float ha = __bfloat162float(__float2bfloat16_rn(a));
  const float hb = __bfloat162float(__float2bfloat16_rn(b));
  hi = pack_bf16(ha, hb);
  lo = pack_bf16(a - ha, b - hb);
}

// The tile load_tile left in v, split into bf16 hi and lo parts: hi at dst,
// lo at dst + XT, each 64 rows of 128 bytes with TMA's 128-byte swizzle
// (dst on a 1024-byte boundary).
__device__ __forceinline__ void store_split(char* dst, const float4 (&v)[8],
                                            int t) {
#pragma unroll
  for (int u = 0; u < 4; ++u) {
    const int e = t + WG * u, row = e / 8, c = (e % 8) * 8;
    uint32_t hi[4], lo[4];
    split2(v[2 * u].x, v[2 * u].y, hi[0], lo[0]);
    split2(v[2 * u].z, v[2 * u].w, hi[1], lo[1]);
    split2(v[2 * u + 1].x, v[2 * u + 1].y, hi[2], lo[2]);
    split2(v[2 * u + 1].z, v[2 * u + 1].w, hi[3], lo[3]);
    const uint32_t off = (row * 128 + c * 2) ^ ((row & 7) << 4);
    *reinterpret_cast<uint4*>(dst + off) = make_uint4(hi[0], hi[1], hi[2], hi[3]);
    *reinterpret_cast<uint4*>(dst + XT + off) =
        make_uint4(lo[0], lo[1], lo[2], lo[3]);
  }
}

// The hi and lo A operands of k-step kk (columns 16 kk .. 16 kk + 15) of a
// 64 x 64 float32 tile held in the accumulator layout.
__device__ __forceinline__ void split_to_a(const float (&d)[32], int kk,
                                           uint32_t (&hi)[4],
                                           uint32_t (&lo)[4]) {
#pragma unroll
  for (int u = 0; u < 4; ++u)
    split2(d[8 * kk + 2 * u], d[8 * kk + 2 * u + 1], hi[u], lo[u]);
}

// Inclusive cumulative sum of a chunk's Q <= 256 log-decays, thread t
// holding steps 2t and 2t + 1 in v, into acum[0 .. 255] (steps past Q hold
// 0 in v): each thread's pair, a shuffle scan in each warp, the warps'
// totals through wsum.  Starts and ends in a __syncthreads.
__device__ void block_cumsum(const float (&v)[2], float* acum, float* wsum,
                             int t) {
  const int lane = t % 32, warp = t / 32;
  const float s = v[0] + v[1];
  float incl = s;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const float o = __shfl_up_sync(0xffffffffu, incl, d);
    if (lane >= d) incl += o;
  }
  __syncthreads();                    // earlier readers of acum and wsum
  if (lane == 31) wsum[warp] = incl;
  __syncthreads();
  float base = incl - s;
  for (int w = 0; w < warp; ++w) base += wsum[w];
  acum[2 * t] = base + v[0];
  acum[2 * t + 1] = base + v[0] + v[1];
  __syncthreads();
}

// 1. per (head set x column tile, chunk, group): for each head of the set,
//    a_cum of the chunk into acum_out, and the chunk's state contribution
//    contrib[n][p] = sum_k B[k][n] exp(a_tot - a_cum[k]) xdt[k][p] into
//    states (BH, nc, N, P), computed transposed: rows p (64 a column tile),
//    columns n.  The next tile's xdt and the next head's log-decays are
//    loaded into registers while the current tile's products run.
template <int NP>
__global__ void __launch_bounds__(WG)
ssd_state_wgmma(const __grid_constant__ CUtensorMap b_map,
                const float* __restrict__ x, const float* __restrict__ a,
                const __nv_bfloat16* __restrict__ Bm,
                float* __restrict__ states, float* __restrict__ acum_out,
                Geo g) {
  constexpr int TILE = T * NP * 2;
  extern __shared__ char smem_raw[];
  char* Bs = align1024(smem_raw);                       // KT tiles (64 x NP)
  float* acum = reinterpret_cast<float*>(Bs + g.KT * TILE);   // 256
  float* wsum = acum + 4 * T;                                 // 4
  uint64_t* bar = reinterpret_cast<uint64_t*>(wsum + 4);
  const int set = blockIdx.x % g.sets1, ct = blockIdx.x / g.sets1;
  const int c = blockIdx.y, bg = blockIdx.z;
  const int t = threadIdx.x;
  const int s0 = c * g.Q;
  const int h0 = set * g.heads1, h1 = min(g.G, h0 + g.heads1);
  const int p0 = ct * T;

  float av[2], xr[32];
  auto fetch_a = [&](int hl) {
    const float* ab = a + ((long long)bg * g.G + hl) * g.S + s0;
#pragma unroll
    for (int k = 0; k < 2; ++k) av[k] = 2 * t + k < g.Q ? ab[2 * t + k] : 0.f;
  };
  // tile j of head hl's xdt in the A operand's layout: rows p, columns k
  auto fetch_x = [&](int hl, int j) {
    const float* xb = x + (((long long)bg * g.G + hl) * g.S + s0) * g.P;
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const int p = p0 + acc_row(t, i), k = j * T + acc_col(t, i);
      xr[i] = p < g.P && k < g.Q ? xb[(long long)k * g.P + p] : 0.f;
    }
  };
  fetch_a(h0);
  fetch_x(h0, 0);

  if (g.vec == 0) {
    if (t == 0) {
      mbar_init(bar, 1);
      fence_barrier_init();
    }
    __syncthreads();
    if (t == 0) {
      prefetch_map(&b_map);
      mbar_expect_tx(bar, (uint32_t)(g.KT * TILE));
      for (int j = 0; j < g.KT; ++j)
        tma_tile<NP, T>(Bs + j * TILE, 0, &b_map, bar, 0, s0 + j * T, bg);
    }
    mbar_wait(bar, 0);
  } else {
    for (int j = 0; j < g.KT; ++j)
      load_rows<NP>(Bs + j * TILE, Bm, g.N, g.vec,
                    (long long)bg * g.S + s0 + j * T, g.S - s0 - j * T, t, WG);
    fence_async_shared();
    __syncthreads();
  }
  const uint32_t b_addr = smem_u32(Bs);

  for (int hl = h0; hl < h1; ++hl) {
    const long long bh = (long long)bg * g.G + hl;
    block_cumsum(av, acum, wsum, t);
    if (hl + 1 < h1) fetch_a(hl + 1);
    if (ct == 0)
      for (int i = t; i < g.Q; i += WG) acum_out[bh * g.S + s0 + i] = acum[i];
    const float a_tot = acum[g.Q - 1];

    float acc[NP / 2];
#pragma unroll
    for (int i = 0; i < NP / 2; ++i) acc[i] = 0.f;
    for (int j = 0; j < g.KT; ++j) {
      // this thread's 16 keys of the tile and their decays to the end
      float dec[16];
#pragma unroll
      for (int u = 0; u < 16; ++u) {
        const int k = j * T + 8 * (u >> 1) + 2 * (t % 4) + (u & 1);
        dec[u] = k < g.Q ? expf(a_tot - acum[k]) : 0.f;
      }
#pragma unroll
      for (int i = 0; i < 32; ++i) xr[i] *= dec[2 * (i >> 2) + (i & 1)];
      uint32_t hi[4][4], lo[4][4];
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) split_to_a(xr, kk, hi[kk], lo[kk]);
      if (j + 1 < g.KT) {
        fetch_x(hl, j + 1);
      } else if (hl + 1 < h1) {
        fetch_x(hl + 1, 0);
      }
      wg_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        const uint64_t db = desc_mn<NP, T>(b_addr + j * TILE, kk);
        wgmma_rs<NP>(acc, hi[kk], db);
        wgmma_rs<NP>(acc, lo[kk], db);
      }
      wg_commit();
      wg_wait<0>();
      fence_regs(acc);
    }
    float* out = states + (bh * g.nc + c) * g.N * g.P;
#pragma unroll
    for (int i = 0; i < NP / 2; ++i) {
      const int p = p0 + acc_row(t, i), n = acc_col(t, i);
      if (p < g.P && n < g.N) out[(long long)n * g.P + p] = acc[i];
    }
  }
}

// 2. per (1024 state entries, head): walk the chunks in order, eight
//    chunks' contributions loaded at a time, V entries a thread (4 where
//    N P is a multiple of 4); the state before chunk c overwrites its
//    contribution, the last state goes to h_final (BH, N, P).
template <int V>
__global__ void __launch_bounds__(256)
ssd_pass(float* __restrict__ states, const float* __restrict__ acum,
         float* __restrict__ h_final, Geo g) {
  using Vec = typename std::conditional<V == 4, float4, float>::type;
  const int NP = g.N * g.P / V;            // vectors of a state
  const int idx = blockIdx.x * 256 + threadIdx.x, bh = blockIdx.y;
  if (idx >= NP) return;
  Vec* s = reinterpret_cast<Vec*>(states) + (long long)bh * g.nc * NP + idx;
  const float* at = acum + (long long)bh * g.S + g.Q - 1;
  float h[V] = {};
  for (int c0 = 0; c0 < g.nc; c0 += 8) {
    Vec v[8];
    float e[8];
#pragma unroll
    for (int u = 0; u < 8; ++u) {
      const int c = c0 + u;
      if (c < g.nc) {
        v[u] = s[(long long)c * NP];
        e[u] = expf(at[(long long)c * g.Q]);
      }
    }
#pragma unroll
    for (int u = 0; u < 8; ++u) {
      const int c = c0 + u;
      if (c >= g.nc) break;
      const float* vf = reinterpret_cast<const float*>(&v[u]);
      Vec out;
      float* of = reinterpret_cast<float*>(&out);
#pragma unroll
      for (int k = 0; k < V; ++k) {
        of[k] = h[k];
        h[k] = h[k] * e[u] + vf[k];
      }
      s[(long long)c * NP] = out;
    }
  }
  Vec out;
  float* of = reinterpret_cast<float*>(&out);
#pragma unroll
  for (int k = 0; k < V; ++k) of[k] = h[k];
  reinterpret_cast<Vec*>(h_final)[(long long)bh * NP + idx] = out;
}

// Shared memory of ssd_scan_wgmma, bytes from a 1024-byte boundary: C_r's
// tile; S_r (64 x 64 KT float32); a union of B's tiles (KT of 64 x NP) and
// the warpgroups' regions (each two buffers of a 64 x 64 tile in hi and
// lo: 64 rows of the state before the chunk, or xdt's keys); each
// warpgroup's a_cum, two buffers; an mbarrier.
struct ScanSmem {
  int c_off, s_off, u_off, reg, a_off, bar_off, total;
  __host__ __device__ ScanSmem(int NP, int KT) {
    const int tile = T * NP * 2;
    reg = 4 * XT;
    c_off = 0;
    s_off = tile;
    u_off = s_off + KT * T * T * 4;
    a_off = u_off + imax(NWG * reg, KT * tile);
    bar_off = a_off + 2 * NWG * KT * T * 4;
    total = 1024 + bar_off + 8;
  }
};

// 3. per (row tile r, head set, chunk, group), longest row tiles first in
//    blockIdx.x: y for the 64 rows of tile r of the chunk, every head of the
//    set, every column.  Each of the NWG warpgroups walks its items (head,
//    column tile) as a stream of 64 x 64 float32 tiles — the state's rows
//    (after the first chunk), then xdt's keys 0 .. 64 r + 63 — split into a
//    double buffer, the next tile loaded into registers while the current
//    one's products run.  y starts as C_r h_prev, is scaled by exp(a_cum)
//    row by row, then takes the intra-chunk products.
template <int NP>
__global__ void __launch_bounds__(NWG * WG, 1)
ssd_scan_wgmma(const __grid_constant__ CUtensorMap b_map,
               const __grid_constant__ CUtensorMap c_map,
               const float* __restrict__ x, const float* __restrict__ acum_g,
               const __nv_bfloat16* __restrict__ Bm,
               const __nv_bfloat16* __restrict__ Cm,
               const float* __restrict__ states, float* __restrict__ y,
               Geo g) {
  constexpr int TILE = T * NP * 2;
  constexpr int ST = (NP + T - 1) / T;          // 64-row tiles of the state
  constexpr int KS = NP / 16 < 4 ? NP / 16 : 4; // k-steps of a state tile
  const ScanSmem L(NP, g.KT);
  extern __shared__ char smem_raw[];
  char* smem = align1024(smem_raw);
  char* Cs = smem + L.c_off;
  float4* Ss = reinterpret_cast<float4*>(smem + L.s_off);
  char* U = smem + L.u_off;
  uint64_t* bar = reinterpret_cast<uint64_t*>(smem + L.bar_off);

  const int per_r = g.BG * g.nc * g.sets3;
  const int r = g.KT - 1 - (int)(blockIdx.x / per_r);
  const int rem = blockIdx.x % per_r;
  const int set = rem % g.sets3, c = (rem / g.sets3) % g.nc,
            bg = rem / (g.sets3 * g.nc);
  const int tid = threadIdx.x, w = tid / WG, t = tid % WG;
  const int s0 = c * g.Q, q0 = r * T;
  const int h0 = set * g.heads3, h1 = min(g.G, h0 + g.heads3);
  const int items = (h1 - h0) * g.CT;
  const int ns = c > 0 ? ST : 0;                 // state tiles an item
  const int n_tiles = ns + r + 1;
  const bool wide_x =
      g.P % 4 == 0 && (reinterpret_cast<uintptr_t>(x) & 15) == 0;
  const bool wide_s =
      g.P % 4 == 0 && (reinterpret_cast<uintptr_t>(states) & 15) == 0;

  // tile `tile` of item `item` into raw; at tile 0 also the item's a_cum
  // entries t and t + 128 into av
  float4 raw[8];
  float av[2];
  auto fetch = [&](int item, int tile) {
    const long long bh = (long long)bg * g.G + h0 + item / g.CT;
    const int p0 = (item % g.CT) * T;
    if (tile == 0) {
#pragma unroll
      for (int k = 0; k < 2; ++k) {
        const int i = t + WG * k;
        av[k] = i < g.Q ? acum_g[bh * g.S + s0 + i] : 0.f;
      }
    }
    if (tile < ns) {
      load_tile(raw, states + ((bh * g.nc + c) * g.N + tile * T) * g.P, g.P,
                p0, g.N - tile * T, wide_s, t);
    } else {
      const int j = tile - ns;
      load_tile(raw, x + (bh * g.S + s0 + j * T) * g.P, g.P, p0,
                g.Q - j * T, wide_x, t);
    }
  };
  if (w < items) fetch(w, 0);

  // C's rows q0 .. q0 + 63 and B's rows 0 .. q0 + 63 of the chunk
  if (g.vec == 0) {
    if (tid == 0) {
      mbar_init(bar, 1);
      fence_barrier_init();
    }
    __syncthreads();
    if (tid == 0) {
      prefetch_map(&b_map);
      prefetch_map(&c_map);
      mbar_expect_tx(bar, (uint32_t)((r + 2) * TILE));
      tma_tile<NP, T>(Cs, 0, &c_map, bar, 0, s0 + q0, bg);
      for (int j = 0; j <= r; ++j)
        tma_tile<NP, T>(U + j * TILE, 0, &b_map, bar, 0, s0 + j * T, bg);
    }
    mbar_wait(bar, 0);
  } else {
    const long long row0 = (long long)bg * g.S + s0;
    load_rows<NP>(Cs, Cm, g.N, g.vec, row0 + q0, g.S - s0 - q0, tid,
                  NWG * WG);
    for (int j = 0; j <= r; ++j)
      load_rows<NP>(U + j * TILE, Bm, g.N, g.vec, row0 + j * T,
                    g.S - s0 - j * T, tid, NWG * WG);
    fence_async_shared();
    __syncthreads();
  }
  const uint32_t c_addr = smem_u32(Cs);

  // S_j = C_r B_j^T for j = w, w + NWG, ... <= r, stored as Ss[j][u][t] =
  // the accumulator's elements 4u .. 4u + 3 of thread t
  for (int j = w; j <= r; j += NWG) {
    float s[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) s[i] = 0.f;
    const uint32_t b_addr = smem_u32(U + j * TILE);
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < NP / 16; ++kk)
      wgmma_ss_n64(s, desc_k<NP, T>(c_addr, 0, kk), desc_k<NP, T>(b_addr, 0, kk),
                   1);
    wg_commit();
    wg_wait<0>();
    fence_regs(s);
#pragma unroll
    for (int u = 0; u < 8; ++u)
      Ss[(j * 8 + u) * WG + t] =
          make_float4(s[4 * u], s[4 * u + 1], s[4 * u + 2], s[4 * u + 3]);
  }
  __syncthreads();            // S_r is whole; B's tiles are no longer read

  char* R = U + w * L.reg;    // this warpgroup's two tile buffers
  float* acs = reinterpret_cast<float*>(smem + L.a_off) + 2 * w * g.KT * T;
  const int qa = q0 + acc_row(t, 0);     // this thread's rows qa, qa + 8
  int seq = 0;

  for (int it = w, ni = 0; it < items; it += NWG, ++ni) {
    const long long bh = (long long)bg * g.G + h0 + it / g.CT;
    const int p0 = (it % g.CT) * T;
    float* ac = acs + (ni & 1) * g.KT * T;
    float aq[2] = {0.f, 0.f};
    float yacc[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) yacc[i] = 0.f;
    for (int tl = 0; tl < n_tiles; ++tl, ++seq) {
      char* buf = R + (seq & 1) * 2 * XT;
      store_split(buf, raw, t);
      if (tl == 0) {
#pragma unroll
        for (int k = 0; k < 2; ++k)
          if (t + WG * k < (r + 1) * T) ac[t + WG * k] = av[k];
      }
      fence_async_shared();
      wg_sync(w);             // the tile is whole; the other buffer is free
      if (tl + 1 < n_tiles) {
        fetch(it, tl + 1);
      } else if (it + NWG < items) {
        fetch(it + NWG, 0);
      }
      if (tl == 0) {
        aq[0] = ac[min(qa, g.Q - 1)];
        aq[1] = ac[min(qa + 8, g.Q - 1)];
      }
      const uint32_t b_hi = smem_u32(buf), b_lo = b_hi + XT;
      if (tl < ns) {
        // C_r (K-major, columns 64 tl ..) times the state's rows 64 tl ..
        wg_fence();
#pragma unroll
        for (int kk = 0; kk < KS; ++kk) {
          const uint64_t da = desc_k<NP, T>(c_addr, 0, tl * 4 + kk);
          wgmma_ss_t_n64(yacc, da, desc_mn<T, T>(b_hi, kk));
          wgmma_ss_t_n64(yacc, da, desc_mn<T, T>(b_lo, kk));
        }
        wg_commit();
        wg_wait<0>();
        fence_regs(yacc);
        if (tl == ns - 1) {
          const float eq[2] = {expf(aq[0]), expf(aq[1])};
#pragma unroll
          for (int i = 0; i < 32; ++i) yacc[i] *= eq[(i >> 1) & 1];
        }
      } else {
        const int j = tl - ns;
        uint32_t hi[4][4], lo[4][4];
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          const float4 v0 = Ss[(j * 8 + 2 * kk) * WG + t];
          const float4 v1 = Ss[(j * 8 + 2 * kk + 1) * WG + t];
          float d[8] = {v0.x, v0.y, v0.z, v0.w, v1.x, v1.y, v1.z, v1.w};
#pragma unroll
          for (int e = 0; e < 8; ++e) {
            const int i = 8 * kk + e, hr = (i >> 1) & 1;
            const int q = qa + 8 * hr, k = j * T + acc_col(t, i);
            // mask first: above the diagonal the exponent is positive
            d[e] = k <= q && q < g.Q ? d[e] * expf(aq[hr] - ac[k]) : 0.f;
          }
#pragma unroll
          for (int u = 0; u < 4; ++u)
            split2(d[2 * u], d[2 * u + 1], hi[kk][u], lo[kk][u]);
        }
        wg_fence();
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          wgmma_rs_n64(yacc, hi[kk], desc_mn<T, T>(b_hi, kk));
          wgmma_rs_n64(yacc, hi[kk], desc_mn<T, T>(b_lo, kk));
          wgmma_rs_n64(yacc, lo[kk], desc_mn<T, T>(b_hi, kk));
        }
        wg_commit();
        wg_wait<0>();
        fence_regs(yacc);
      }
    }
    float* yb = y + (bh * g.S + s0) * g.P + p0;
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const int q = q0 + acc_row(t, i), p = acc_col(t, i);
      if (q < g.Q && p0 + p < g.P) yb[(long long)q * g.P + p] = yacc[i];
    }
  }
}

size_t state_smem(int NP, int KT) {
  return 1024 + (size_t)KT * T * NP * 2 + (4 * T + 4) * 4 + 8;
}

template <int NP>
cudaError_t launch(const CUtensorMap& bmap, const CUtensorMap& cmap,
                   const float* x, const float* a, const __nv_bfloat16* Bm,
                   const __nv_bfloat16* Cm, float* y, float* h_final,
                   float* states, float* acum, const Geo& g,
                   cudaStream_t stream) {
  const size_t smem1 = state_smem(NP, g.KT);
  const size_t smem3 = ScanSmem(NP, g.KT).total;
  if (smem1 > MAX_SMEM || smem3 > MAX_SMEM) return cudaErrorInvalidValue;
  cudaError_t err = allow_smem(ssd_state_wgmma<NP>, smem1);
  if (err != cudaSuccess) return err;
  ssd_state_wgmma<NP><<<dim3(g.sets1 * g.CT, g.nc, g.BG), WG, smem1, stream>>>(
      bmap, x, a, Bm, states, acum, g);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  if (g.N * g.P % 4 == 0) {
    ssd_pass<4><<<dim3((g.N * g.P / 4 + 255) / 256, g.BH), 256, 0, stream>>>(
        states, acum, h_final, g);
  } else {
    ssd_pass<1><<<dim3((g.N * g.P + 255) / 256, g.BH), 256, 0, stream>>>(
        states, acum, h_final, g);
  }
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  err = allow_smem(ssd_scan_wgmma<NP>, smem3);
  if (err != cudaSuccess) return err;
  const long long blocks = (long long)g.KT * g.BG * g.nc * g.sets3;
  ssd_scan_wgmma<NP><<<(unsigned)blocks, NWG * WG, smem3, stream>>>(
      bmap, cmap, x, acum, Bm, Cm, states, y, g);
  return cudaGetLastError();
}

}  // namespace

// xdt (BH, S, P) and a (BH, S) float32; B and C (BG, S, N) bf16, BH = BG * G;
// y (BH, S, P) and h_final (BH, N, P) float32; scratch: states
// (BH, S / Q, N, P) and acum (BH, S) float32.  All contiguous.  S must be a
// multiple of the chunk Q, Q at most 256 and N at most 256 (N above 128
// with Q above 192 does not fit a block's shared memory).  state_heads and
// scan_heads: heads of a group a block of the first and the third kernel
// takes (ops.ssd_head_sets).  vec: 0 to load B and C by TMA (N 16, 32, 64,
// 128 or 256, 16-byte-aligned bases), else the width of the plain loads
// (ops.ssd_bc_loads).  Returns the launches' CUDA error code (0 = launched).
extern "C" int ssd_scan_wgmma(const void* xdt, const void* a, const void* B,
                              const void* C, void* y, void* h_final,
                              void* states, void* acum, int BH, int S, int P,
                              int N, int G, int Q, int state_heads,
                              int scan_heads, int vec, void* stream) {
  if (BH == 0 || S == 0 || P == 0) return 0;
  if (Q <= 0 || Q > 4 * T || S % Q != 0 || N <= 0 || N > 256 || G <= 0 ||
      BH % G != 0 || state_heads <= 0 || scan_heads <= 0 ||
      !(vec == 0 || vec == 1 || vec == 2 || vec == 4 || vec == 8) ||
      (vec > 0 && N % vec != 0))
    return cudaErrorInvalidValue;
  Geo g;
  g.BH = BH; g.S = S; g.P = P; g.N = N; g.Q = Q; g.nc = S / Q; g.G = G;
  g.BG = BH / G; g.KT = (Q + T - 1) / T; g.CT = (P + T - 1) / T;
  g.heads1 = imin(state_heads, G); g.sets1 = (G + g.heads1 - 1) / g.heads1;
  g.heads3 = imin(scan_heads, G); g.sets3 = (G + g.heads3 - 1) / g.heads3;
  g.vec = vec;
  if (g.nc > 65535 || g.BG > 65535 || BH > 65535)
    return cudaErrorInvalidValue;
  const int NP = N <= 16 ? 16 : N <= 32 ? 32 : N <= 64 ? 64 : N <= 128 ? 128 : 256;
  if (vec == 0 && N != NP) return cudaErrorInvalidValue;
  CUtensorMap bmap = {}, cmap = {};
  if (vec == 0) {
    const long long sb = (long long)S * N;
    cudaError_t err = make_map(&bmap, B, g.BG, S, 1, N, sb, N, N);
    if (err == cudaSuccess) err = make_map(&cmap, C, g.BG, S, 1, N, sb, N, N);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const float* x = static_cast<const float*>(xdt);
  const float* av = static_cast<const float*>(a);
  const __nv_bfloat16* Bm = static_cast<const __nv_bfloat16*>(B);
  const __nv_bfloat16* Cm = static_cast<const __nv_bfloat16*>(C);
  float* yo = static_cast<float*>(y);
  float* h = static_cast<float*>(h_final);
  float* st = static_cast<float*>(states);
  float* ac = static_cast<float*>(acum);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  switch (NP) {
    case 16: err = launch<16>(bmap, cmap, x, av, Bm, Cm, yo, h, st, ac, g, s); break;
    case 32: err = launch<32>(bmap, cmap, x, av, Bm, Cm, yo, h, st, ac, g, s); break;
    case 64: err = launch<64>(bmap, cmap, x, av, Bm, Cm, yo, h, st, ac, g, s); break;
    case 128: err = launch<128>(bmap, cmap, x, av, Bm, Cm, yo, h, st, ac, g, s); break;
    default: err = launch<256>(bmap, cmap, x, av, Bm, Cm, yo, h, st, ac, g, s);
  }
  return static_cast<int>(err);
}
