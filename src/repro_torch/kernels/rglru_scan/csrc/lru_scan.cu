// RG-LRU linear-recurrence scan for Hopper (sm_90a), plain C interface.
//
// Replaces the TPU kernel lru_scan (src/repro/kernels/rglru_scan/kernel.py:57,
// pallas_call at :65, bodies _lru_kernel :42 and _chunk_scan :26): h_t =
// a_t h_{t-1} + b_t along the sequence for (B, S, W) float32 a and b, float32
// h out, any S and W (the TPU kernel's S % block_s == 0 is not carried over).
// Additions to the TPU contract: an optional carried state h0 (B, W) (h_{-1}
// = h0, zeros when absent), as the JAX oracle lru_scan_ref(a, b, h0) takes
// it; a reverse flag that scans from the end (h_t = a_t h_{t+1} + b_t, h_S =
// h0); h_final (B, W), the state after the last step of the scan order; and
// the custom VJP's two extra passes folded into the reverse scan (below).
//
// What bounds it on this card: bytes.  One multiply-add per element against
// 12 bytes (a and b read, h written): at the training shape (B 1, S 4096,
// W 4096) 201,342,976 bytes with h_final, 0.0601 ms at 3.35 TB/s.  The VJP
// reads a, g and the forward's h and writes db and da: 20 bytes an element,
// 335,544,320 bytes, 0.1002 ms.
//
// What the design does.  The TPU grid walks S in order with the carry in
// VMEM, reading (a, b) once and writing h once.  Hopper has no sequential
// grid, so the sequence is cut into chunks of T steps and the channels into
// tiles of Wt, one block per (batch, tile, chunk), all in one launch:
//   1. the block copies its tile of a and b (T x Wt floats each) into shared
//      memory with cp.async, 16 bytes a copy where W % 4 == 0 and every base
//      is 16-byte aligned, 4 bytes otherwise (ragged W, misaligned views);
//   2. Wt/4 threads, four channels each, walk the tile from a zero state and
//      get the chunk's aggregate P = prod a and E = its end state;
//   3. it publishes (P, E) to a workspace with a release flag, then finds
//      the carry into its chunk (the look-back below) and publishes the
//      carry out of its chunk, P * carry + E, with a second flag value;
//   4. it re-runs the recurrence from the carry over the tile it still
//      holds, writing h (and h_final from the last chunk of the scan).
// a and b are read from device memory once: 12 bytes an element, plus
// 12 bytes per (batch, chunk, channel) of workspace that stays in L2.
//
// Forward progress: a block takes its (batch, tile, chunk) from an atomic
// ticket, chunk-major in scan order, so it only ever waits on blocks that
// took a lower ticket, which are running or done and publish their
// aggregate without waiting on anything.  blockIdx is not used for this: the
// card may schedule a later chunk before an earlier one.  Flags and ticket
// are zeroed by a cudaMemsetAsync on the call's stream; counts come from the
// shapes alone, so a CUDA graph can hold the call.
//
// Why the fold order is fixed, and why reruns give the same bits.  The carry
// into chunk c is defined as the fold from h0 over the chunks in scan order,
// carry_{k+1} = fma(P_k, carry_k, E_k), and every block computes it with
// that one operation.  The look-back walks back from c-1 to the nearest
// chunk j whose carry out is published (that value is carry_{j+1}, made by
// the same fold), then applies the aggregates j+1 .. c-1 forwards, one fma
// each.  So however many aggregates timing makes it read, the operations on
// the carry are the same, in the same order: the bits do not depend on the
// schedule.  (A classic decoupled look-back combines the aggregates with
// each other before applying them, and rounds differently from run to run.)
// Two other fixed orders give the same bits and ran slower at the training
// shape (PERF.md): a chained scan, waiting for chunk c-1's carry out (64
// carries in a row), and folding every aggregate from h0.  Re-running from
// the carry, rather than adding prod(a) * carry to a kept local h, keeps
// the order inside a chunk sequential.
//
// Other designs measured at the training shape (PERF.md): persistent blocks
// that fetch their next chunk's tile while they wait for the current one's
// carry ran slower (each block takes its chunks' waits one after another);
// the TPU kernel's own walk, a block carrying one channel tile through the
// whole sequence with a cp.async ring, ran slower built to this contract,
// while a stripped build of it (no h0, h_final or VJP, the tile fixed at
// compile time) ran faster: an open lead (ROADMAP B4).
//
// One chunk (S <= T, the serving chunk step): one launch of its own kernel
// (lru_direct), no workspace, no flags, no ticket: a thread walks one
// channel from h0 with its loads unrolled ahead of the fmas.
//
// The VJP (ops._lru_vjp).  With h = lru(a, b) and cotangent g, db_t = g_t +
// a_{t+1} db_{t+1} and da_t = db_t h_{t-1}.  Given hin (the forward's h)
// and da, the kernel runs the VJP: scan index i uses the a of scan index
// i-1 (0 at i = 0), in reverse a_{t+1}, 0 past the last step; and the
// re-run writes da at scan index i as out_i * hin at scan index i+1 (0 past
// the end), in reverse db_t h_{t-1}, h_{-1} = 0.  hin's tile is copied beside a
// and g's.  So the backward is one launch reading a, g and h and writing db
// and da, with no shifted copy of a and no separate multiply.
//
// Layouts (all contiguous, float32): a, b, hin, h, da (B, S, W); h0, h_final
// (B, W).  Workspace (4-byte words, nc = ceil(S/T) > 1, Wp = ntiles * Wt):
// P, E, I (B, nc, Wp) float, then flags (B, ntiles, nc) int, then the ticket.

#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 128;        // loaders; the first Wt/4 also compute
constexpr int DIRECT_THREADS = 64;  // the one-chunk kernel's block
constexpr int MAX_WT = 4 * THREADS;
constexpr int SMEM_LIMIT = 232448;  // a block's shared memory on sm_90
constexpr int AGG = 1, INCL = 2;    // flag values: aggregate, carry out

struct Args {
  const float* a;
  const float* b;
  const float* h0;
  const float* hin;
  float* h;
  float* da;
  float* h_final;
  float* P;
  float* E;
  float* I;
  int* flags;
  int* ticket;
  int B, S, W, T, Wt, nc, ntiles, reverse, shift, vec;
};

__device__ __forceinline__ int ld_acquire(const int* p) {
  int v;
  asm volatile("ld.acquire.gpu.global.s32 %0, [%1];" : "=r"(v) : "l"(p)
               : "memory");
  return v;
}

__device__ __forceinline__ void st_release(int* p, int v) {
  asm volatile("st.release.gpu.global.s32 [%0], %1;" :: "l"(p), "r"(v)
               : "memory");
}

__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" :: "r"(d),
               "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;" :: "r"(d),
               "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;" :: "n"(N) : "memory");
}

__device__ __forceinline__ float4 fma4(float4 x, float4 y, float4 z) {
  return make_float4(__fmaf_rn(x.x, y.x, z.x), __fmaf_rn(x.y, y.y, z.y),
                     __fmaf_rn(x.z, y.z, z.z), __fmaf_rn(x.w, y.w, z.w));
}

__device__ __forceinline__ float4 mul4(float4 x, float4 y) {
  return make_float4(__fmul_rn(x.x, y.x), __fmul_rn(x.y, y.y),
                     __fmul_rn(x.z, y.z), __fmul_rn(x.w, y.w));
}

// Rows lo .. lo+n-1 of a (S, W) slab, channels w0 .. w0+Wt-1, into a row-
// major (n, Wt) tile; rows outside [0, S) and channels past W read as 0.
__device__ __forceinline__ void load_tile(float* tile, const float* src,
                                          int lo, int n, int w0,
                                          const Args& p) {
  if (p.vec) {
    const int q = p.Wt / 4;
    for (int i = threadIdx.x; i < n * q; i += THREADS) {
      const int r = i / q, col = 4 * (i - r * q);
      const int pos = lo + r, w = w0 + col;
      float* dst = tile + r * p.Wt + col;
      if (pos >= 0 && pos < p.S && w < p.W)
        cp_async16(dst, src + (size_t)pos * p.W + w);
      else
        *reinterpret_cast<float4*>(dst) = make_float4(0.f, 0.f, 0.f, 0.f);
    }
  } else {
    for (int i = threadIdx.x; i < n * p.Wt; i += THREADS) {
      const int r = i / p.Wt, col = i - r * p.Wt;
      const int pos = lo + r, w = w0 + col;
      float* dst = tile + r * p.Wt + col;
      if (pos >= 0 && pos < p.S && w < p.W)
        cp_async4(dst, src + (size_t)pos * p.W + w);
      else
        *dst = 0.f;
    }
  }
}

// Four channels w .. w+3 of a row, w < W (16-byte access on the vector
// path; the scalar path guards each channel against W).
__device__ __forceinline__ float4 load4(const float* row, int w,
                                        const Args& p) {
  if (p.vec) return *reinterpret_cast<const float4*>(row + w);
  float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
  if (w < p.W) v.x = row[w];
  if (w + 1 < p.W) v.y = row[w + 1];
  if (w + 2 < p.W) v.z = row[w + 2];
  if (w + 3 < p.W) v.w = row[w + 3];
  return v;
}

__device__ __forceinline__ void store4(float* row, int w, float4 v,
                                       const Args& p) {
  if (p.vec) {
    *reinterpret_cast<float4*>(row + w) = v;
    return;
  }
  if (w < p.W) row[w] = v.x;
  if (w + 1 < p.W) row[w + 1] = v.y;
  if (w + 2 < p.W) row[w + 2] = v.z;
  if (w + 3 < p.W) row[w + 3] = v.w;
}

__device__ __forceinline__ float4 ldcg4(const float* p) {
  return __ldcg(reinterpret_cast<const float4*>(p));
}

// Warp 0: the nearest chunk j < c whose carry out is published (-1: h0),
// waiting for each chunk in (j, c) to publish at least its aggregate.
__device__ int look_back(const int* flags, int c) {
  const int lane = threadIdx.x & 31;
  for (int top = c - 1;; top -= 32) {
    const int k = top - lane;
    int f = INCL;                       // before chunk 0: h0
    if (k >= 0)
      do f = ld_acquire(flags + k); while (f == 0);
    const unsigned incl = __ballot_sync(0xffffffffu, f == INCL);
    if (incl) return top - (__ffs(incl) - 1);   // the nearest one
  }
}

__global__ void __launch_bounds__(THREADS)
lru_single_pass(Args p) {
  extern __shared__ float4 smem4[];
  float* sa = reinterpret_cast<float*>(smem4);
  const int tile_floats = p.T * p.Wt;
  float* sb = sa + tile_floats;
  float* sh = sb + tile_floats;                 // hin's tile (VJP only)
  __shared__ int s_ticket, s_from;
  const int tid = threadIdx.x;

  if (tid == 0) s_ticket = atomicAdd(p.ticket, 1);
  __syncthreads();
  const int ticket = s_ticket;
  const int per_chunk = p.B * p.ntiles;
  const int c = ticket / per_chunk;
  const int rest = ticket - c * per_chunk;
  const int bb = rest / p.ntiles, tile = rest - bb * p.ntiles;
  const int i0 = c * p.T, n = min(p.T, p.S - i0);
  // tile row r holds sequence position lo + r; scan order runs the rows
  // up (forward) or down (reverse)
  const int lo = p.reverse ? p.S - i0 - n : i0;
  const int w0 = tile * p.Wt;
  const size_t slab = (size_t)bb * p.S * p.W;
  const int a_off = p.shift ? (p.reverse ? 1 : -1) : 0;

  load_tile(sa, p.a + slab, lo + a_off, n, w0, p);
  load_tile(sb, p.b + slab, lo, n, w0, p);
  cp_async_commit();
  if (p.hin) {
    load_tile(sh, p.hin + slab, lo + (p.reverse ? -1 : 1), n, w0, p);
    cp_async_commit();
    cp_async_wait<1>();
  } else {
    cp_async_wait<0>();
  }
  __syncthreads();

  // thread tid < Wt/4 computes channels w .. w+3 of the tile, those of
  // them under W (a vector path's w < W holds all four: W % 4 == 0)
  const int q = p.Wt / 4;
  const int w = w0 + 4 * tid;
  const bool computes = tid < q && w < p.W;
  const float4* sa4 = reinterpret_cast<const float4*>(sa);
  const float4* sb4 = reinterpret_cast<const float4*>(sb);
  const int step = p.reverse ? -1 : 1;
  const int r0 = p.reverse ? n - 1 : 0;

  // the carry into the chunk: h0 (zeros when absent) until the fold moves it
  float4 carry = make_float4(0.f, 0.f, 0.f, 0.f);
  if (computes && p.h0) carry = load4(p.h0 + (size_t)bb * p.W, w, p);

  {
    const size_t Wp = (size_t)p.ntiles * p.Wt;
    const size_t ws_row = (size_t)bb * p.nc * Wp + w;   // + k * Wp
    int* flags = p.flags + (size_t)(bb * p.ntiles + tile) * p.nc;
    // 2. the chunk's aggregate from a zero state
    float4 P = make_float4(1.f, 1.f, 1.f, 1.f);
    float4 E = make_float4(0.f, 0.f, 0.f, 0.f);
    if (computes) {
#pragma unroll 4
      for (int j = 0, r = r0; j < n; ++j, r += step) {
        const float4 x = sa4[r * q + tid];
        E = fma4(x, E, sb4[r * q + tid]);
        P = mul4(P, x);
      }
    }
    // 3. publish it (chunk 0's goes out with its carry out), find the
    // carry, publish the carry out; the last chunk has no successor
    if (computes && c < p.nc - 1) {
      *reinterpret_cast<float4*>(p.P + ws_row + c * Wp) = P;
      *reinterpret_cast<float4*>(p.E + ws_row + c * Wp) = E;
    }
    if (c > 0) {
      if (c < p.nc - 1) {
        __syncthreads();
        if (tid == 0) {
          __threadfence();
          st_release(flags + c, AGG);
        }
      }
      if (tid < 32) {
        const int from = look_back(flags, c);
        __threadfence();
        if (tid == 0) s_from = from;
      }
      __syncthreads();
      const int from = s_from;
      if (computes) {
        if (from >= 0) carry = ldcg4(p.I + ws_row + from * Wp);
#pragma unroll 4
        for (int k = from + 1; k < c; ++k)
          carry = fma4(ldcg4(p.P + ws_row + k * Wp), carry,
                       ldcg4(p.E + ws_row + k * Wp));
      }
    }
    if (c < p.nc - 1) {
      if (computes)
        *reinterpret_cast<float4*>(p.I + ws_row + c * Wp) =
            fma4(P, carry, E);
      __syncthreads();
      if (tid == 0) {
        __threadfence();
        st_release(flags + c, INCL);
      }
    }
  }
  if (p.hin) {                        // hin's tile, copied by every thread
    cp_async_wait<0>();
    __syncthreads();
  }
  if (!computes) return;

  // 4. re-run from the carry over the tile, writing h (and da)
  const float4* sh4 = reinterpret_cast<const float4*>(sh);
  float4 hv = carry;
#pragma unroll 4
  for (int j = 0, r = r0; j < n; ++j, r += step) {
    hv = fma4(sa4[r * q + tid], hv, sb4[r * q + tid]);
    const size_t row = slab + (size_t)(lo + r) * p.W;
    store4(p.h + row, w, hv, p);
    if (p.hin) store4(p.da + row, w, mul4(hv, sh4[r * q + tid]), p);
  }
  if (c == p.nc - 1 && p.h_final)
    store4(p.h_final + (size_t)bb * p.W, w, hv, p);
}

// One chunk (S <= T, the serving chunk step): nothing to wait for and
// nothing to overlap, so no tile, workspace or ticket; a thread takes one
// channel and walks it with its loads unrolled 16 steps ahead (coalesced
// 4-byte loads, a full line a warp).  The pointers come in as kernel
// parameters so that the compiler knows they address global memory and
// may move the loads ahead of the stores; the VJP is a build of its own
// (run-time branches in the unrolled loop made it slower).
template <bool VJP>
__global__ void __launch_bounds__(DIRECT_THREADS)
lru_direct(const float* __restrict__ a, const float* __restrict__ b,
           const float* __restrict__ h0, const float* __restrict__ hin,
           float* __restrict__ h, float* __restrict__ da,
           float* __restrict__ h_final, Args p) {
  const int w = blockIdx.x * DIRECT_THREADS + threadIdx.x, bb = blockIdx.y;
  if (w >= p.W) return;
  const size_t base = (size_t)bb * p.S * p.W + w;
  const ptrdiff_t step = (ptrdiff_t)(p.reverse ? -1 : 1) * p.W;
  float hv = h0 ? h0[(size_t)bb * p.W + w] : 0.f;
#pragma unroll 16
  for (int j = 0; j < p.S; ++j) {
    const size_t at = base + (size_t)(p.reverse ? p.S - 1 - j : j) * p.W;
    if (VJP) {
      // the a of the step before in scan order (0 at the first), and da
      // from hin of the step after (0 past the end)
      hv = __fmaf_rn(j > 0 ? a[at - step] : 0.f, hv, b[at]);
      h[at] = hv;
      da[at] = j + 1 < p.S ? __fmul_rn(hv, hin[at + step]) : 0.f;
    } else {
      hv = __fmaf_rn(a[at], hv, b[at]);
      h[at] = hv;
    }
  }
  if (h_final) h_final[(size_t)bb * p.W + w] = hv;
}

}  // namespace

// a, b (B, S, W); h0 (B, W) or null; h (B, S, W); h_final (B, W) or null;
// the VJP: hin (B, S, W) and da (B, S, W), both or neither.  T steps a
// chunk, Wt channels a tile (Wt % 4 == 0, Wt <= 512); vec: 16-byte copies
// (the caller checks W % 4 == 0 and 16-byte bases; refused otherwise).
// ws: ws_words 4-byte words (0 with one chunk).  Returns the first CUDA
// error code (0 = launched).
extern "C" int lru_scan(const void* a, const void* b, const void* h0,
                        const void* hin, void* h, void* da, void* h_final,
                        void* ws, long long ws_words, int B, int S, int W,
                        int T, int Wt, int reverse, int vec,
                        void* stream) {
  if (B == 0 || W == 0) return 0;
  if (B < 0 || S <= 0 || W < 0 || T <= 0 || Wt <= 0 || Wt % 4 != 0 ||
      Wt > MAX_WT || (hin != nullptr) != (da != nullptr))
    return cudaErrorInvalidValue;
  Args p;
  p.a = static_cast<const float*>(a);
  p.b = static_cast<const float*>(b);
  p.h0 = static_cast<const float*>(h0);
  p.hin = static_cast<const float*>(hin);
  p.h = static_cast<float*>(h);
  p.da = static_cast<float*>(da);
  p.h_final = static_cast<float*>(h_final);
  p.B = B;
  p.S = S;
  p.W = W;
  p.T = T;
  p.Wt = Wt;
  p.nc = (S + T - 1) / T;
  p.ntiles = (W + Wt - 1) / Wt;
  p.reverse = reverse != 0;
  p.shift = hin != nullptr;            // the VJP's a of the step before
  p.vec = vec != 0;
  if (p.vec) {
    const void* ptrs[] = {a, b, h0, hin, h, da, h_final};
    if (W % 4 != 0) return cudaErrorMisalignedAddress;
    for (const void* ptr : ptrs)
      if (reinterpret_cast<uintptr_t>(ptr) % 16 != 0)
        return cudaErrorMisalignedAddress;
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (p.nc == 1) {
    if (B > 65535) return cudaErrorInvalidValue;
    const dim3 grid((W + DIRECT_THREADS - 1) / DIRECT_THREADS, B);
    if (hin)
      lru_direct<true><<<grid, DIRECT_THREADS, 0, s>>>(
          p.a, p.b, p.h0, p.hin, p.h, p.da, p.h_final, p);
    else
      lru_direct<false><<<grid, DIRECT_THREADS, 0, s>>>(
          p.a, p.b, p.h0, p.hin, p.h, p.da, p.h_final, p);
    return static_cast<int>(cudaGetLastError());
  }
  const long long blocks = (long long)B * p.ntiles * p.nc;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  const size_t smem = (size_t)(hin ? 3 : 2) * T * Wt * sizeof(float);
  if (smem > (size_t)SMEM_LIMIT) return cudaErrorInvalidValue;
  const long long cells = (long long)B * p.nc * p.ntiles * Wt;
  const long long n_flags = (long long)B * p.ntiles * p.nc;
  if (ws_words < 3 * cells + n_flags + 1) return cudaErrorInvalidValue;
  p.P = static_cast<float*>(ws);
  p.E = p.P + cells;
  p.I = p.E + cells;
  p.flags = reinterpret_cast<int*>(p.I + cells);
  p.ticket = p.flags + n_flags;
  cudaError_t err = cudaMemsetAsync(p.flags, 0, (n_flags + 1) * sizeof(int),
                                    s);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (smem > 48 * 1024) {
    err = cudaFuncSetAttribute(lru_single_pass,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  lru_single_pass<<<(unsigned)blocks, THREADS, smem, s>>>(p);
  return static_cast<int>(cudaGetLastError());
}
