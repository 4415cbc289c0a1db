// Flash-attention backward on Hopper's tensor cores (sm_90a), bf16, plain C
// interface.
//
// Replaces the TPU kernel flash_attention_bwd
// (src/repro/kernels/flash_attention/kernel.py:367, bodies _dq_kernel and
// _dkv_kernel) for bf16 inputs; float32 inputs take flash_attention_bwd.cu
// (FMA loops), since the float32 tolerance of the JAX package's gradient
// tests (2e-4) is out of reach of TF32 tensor cores.  Three launches:
//   * delta: delta = rowsum(out * do) in float32, one warp a (batch,
//     position, head), out and do read once in bf16 (the JAX package
//     computes it outside its kernels, kernel.py:377);
//   * dq: a block owns 64 * NWG query rows of one (batch, query head) and
//     walks the kv tiles its rows see, as the forward does;
//   * dk/dv: a block owns 64 keys of one (batch, kv head) and walks the
//     position tiles that see them, for each of the G query heads of its kv
//     head, so the sum over the group is the block's own loop.
// Every output element has one owner: no atomics, and repeated runs give
// bit-identical gradients.  Both recompute p = exp(s * scale - lse) under
// the mask, and ds = p * (dp - delta) * scale.  As in the TPU kernels, p is
// rounded to do's type before the product with do (dv), and ds to the input
// type before the products with k (dq) and q (dk); dp is the bf16 x bf16
// product with a float32 sum, which is what the JAX code's float32 upcast
// of do and v gives.
//
// What bounds it on this card: operations.  The least work is five
// products of 2 * dh flops per visible (query, key) pair (s recomputed, dp,
// dv, dq, dk): at the training shape (B 2, S 2048, 24 query heads over 8,
// dh 128, causal) 64.5 GFLOP, 0.130 ms at 989 TFLOP/s.  The split does
// eight: s and dp in the dq kernel, and in the dk/dv kernel s twice (once in
// each warpgroup), dp, dv and dk, besides dq.
//
// What the design does:
//   * every product is wgmma (bf16 in, f32 accumulate) on bf16 tiles that
//     TMA brings into shared memory (swizzled, see hopper.cuh), in a ring of
//     two stages filled by a producer warp while the consumer warpgroups
//     compute;
//   * the transposed products need no transposed copy: the dk/dv kernel
//     computes s^T = K Q^T and dp^T = V dO^T, so p^T and ds^T come out of
//     the accumulators in the register layout of wgmma's A operand, and
//     dv += p^T dO, dk += ds^T Q (and dq += ds K) read dO, Q (and K) as
//     MN-major B operands;
//   * the dk/dv block has two consumer warpgroups on the same 64 keys: one
//     computes s^T and p^T and owns all dh columns of dv, the other
//     recomputes s^T, computes dp^T and ds^T and owns all dh columns of dk;
//     at dh 256 each holds one 64 x 256 float32 accumulator (128 registers
//     a thread), so one block owns its keys' whole dk and dv;
//   * lse and delta of a position tile ride with the tile: the producer
//     warp copies them into the stage beside Q and dO;
//   * at dh 256 the dq kernel has one consumer warpgroup (64 rows: Q and dO
//     64 KB, two K/V stages 128 KB); below, two (128 rows).

#include "hopper.cuh"

namespace {

using namespace hk;

constexpr int BN = 64;        // keys per kv tile, positions per row tile
constexpr int STAGES = 2;

struct Dims {
  int B, Sq, Skv, Hq, Hkv, causal, window;
  float scale, scale_log2;    // dh ** -0.5, and times log2(e)
};

struct Strides {              // element strides of a (B, S, H, dh) tensor
  long long b, s, h;
};

__device__ __forceinline__ bool visible(int t, int j, const Dims& dm) {
  return t < dm.Sq && j < dm.Skv && (!dm.causal || j <= t) &&
         (dm.window == 0 || j > t - dm.window);
}

// --- delta = rowsum(out * do) ----------------------------------------------

__global__ void __launch_bounds__(256)
flash_delta_kernel(const __nv_bfloat16* __restrict__ out,
                   const __nv_bfloat16* __restrict__ dout,
                   float* __restrict__ delta, Strides os, Strides ds, int B,
                   int Sq, int Hq, int D) {
  const long long row = (long long)blockIdx.x * 8 + threadIdx.x / 32;
  if (row >= (long long)B * Sq * Hq) return;
  const int lane = threadIdx.x % 32;
  const int h = row % Hq, t = (row / Hq) % Sq, b = row / ((long long)Hq * Sq);
  const __nv_bfloat16* o = out + b * os.b + t * os.s + h * os.h;
  const __nv_bfloat16* g = dout + b * ds.b + t * ds.s + h * ds.h;
  float acc = 0.f;
  for (int d = lane; d < D; d += 32)
    acc += __bfloat162float(o[d]) * __bfloat162float(g[d]);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (lane == 0) delta[((size_t)b * Hq + h) * Sq + t] = acc;
}

// --- dq ---------------------------------------------------------------------

template <int D>
constexpr int dq_nwg() { return D == 256 ? 1 : 2; }

template <int D, int NWG>
struct DqSmem {
  static constexpr int R = 64 * NWG;
  static constexpr size_t Q = (size_t)R * D * 2;      // Q or dO
  static constexpr size_t KV = (size_t)BN * D * 2;    // one K or V tile
  static constexpr size_t TOTAL = 1024 + 2 * Q + 2 * STAGES * KV + 1024;
};

template <int D, int NWG>
__global__ void __launch_bounds__(128 * (NWG + 1), 1)
flash_dq_wgmma_kernel(const __grid_constant__ CUtensorMap qmap,
                      const __grid_constant__ CUtensorMap kmap,
                      const __grid_constant__ CUtensorMap vmap,
                      const __grid_constant__ CUtensorMap dmap,
                      const float* __restrict__ lse,
                      const float* __restrict__ delta,
                      __nv_bfloat16* __restrict__ dq, Dims dm) {
  using L = DqSmem<D, NWG>;
  constexpr int R = L::R;
  extern __shared__ char smem_raw[];
  char* smem = reinterpret_cast<char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  char* Qs = smem;
  char* dOs = Qs + L::Q;
  char* Ks = dOs + L::Q;
  char* Vs = Ks + STAGES * L::KV;
  uint64_t* bars = reinterpret_cast<uint64_t*>(Vs + STAGES * L::KV);
  uint64_t* q_full = bars;
  uint64_t* k_full = bars + 1;
  uint64_t* v_full = k_full + STAGES;
  uint64_t* empty = v_full + STAGES;

  const int n_rt = (dm.Sq + R - 1) / R;
  const int r0 = (n_rt - 1 - (int)blockIdx.z) * R;    // longest rows first
  const int h = blockIdx.x, b = blockIdx.y;
  const int hk = h / (dm.Hq / dm.Hkv);
  const int n_kv = (dm.Skv + BN - 1) / BN;
  const int last = min(r0 + R, dm.Sq) - 1;
  const int hi = dm.causal ? min(n_kv - 1, last / BN) : n_kv - 1;
  const int lo = dm.window > 0 ? max(0, r0 - dm.window + 1) / BN : 0;

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(k_full + s, 1);
      mbar_init(v_full + s, 1);
      mbar_init(empty + s, 128 * NWG);
    }
    fence_barrier_init();
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == NWG) {
    if constexpr (NWG == 2) reg_dealloc<24>();
    if (threadIdx.x == 128 * NWG) {
      mbar_expect_tx(q_full, (uint32_t)(2 * L::Q));
      for (int part = 0; part < NWG; ++part) {
        tma_tile<D, R>(Qs, 64 * part, &qmap, q_full, h, r0 + 64 * part, b);
        tma_tile<D, R>(dOs, 64 * part, &dmap, q_full, h, r0 + 64 * part, b);
      }
      for (int jt = lo; jt <= hi; ++jt) {
        const int it = jt - lo, s = it % STAGES;
        mbar_wait(empty + s, ((it / STAGES) & 1) ^ 1);
        mbar_expect_tx(k_full + s, (uint32_t)L::KV);
        tma_tile<D, BN>(Ks + s * L::KV, 0, &kmap, k_full + s, hk, jt * BN, b);
        mbar_expect_tx(v_full + s, (uint32_t)L::KV);
        tma_tile<D, BN>(Vs + s * L::KV, 0, &vmap, v_full + s, hk, jt * BN, b);
      }
    }
  } else {
    if constexpr (NWG == 2) reg_alloc<240>();
    const int t = threadIdx.x % 128;
    const int row_lo = r0 + 64 * wg;
    const int tq[2] = {row_lo + acc_row(t, 0), row_lo + acc_row(t, 0) + 8};
    float lse2[2], dl[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const size_t at = ((size_t)b * dm.Hq + h) * dm.Sq + tq[r];
      lse2[r] = tq[r] < dm.Sq ? lse[at] * LOG2E : 0.f;
      dl[r] = tq[r] < dm.Sq ? delta[at] : 0.f;
    }
    float acc[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
    const uint32_t q_addr = smem_u32(Qs), do_addr = smem_u32(dOs);

    mbar_wait(q_full, 0);
    for (int jt = lo; jt <= hi; ++jt) {
      const int it = jt - lo, s = it % STAGES, ph = (it / STAGES) & 1;
      const int k0 = jt * BN;
      const uint32_t k_addr = smem_u32(Ks + s * L::KV);
      const uint32_t v_addr = smem_u32(Vs + s * L::KV);
      float sc[32], dp[32];
#pragma unroll
      for (int i = 0; i < 32; ++i) sc[i] = dp[i] = 0.f;
      mbar_wait(k_full + s, ph);
      wg_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        wgmma_ss_n64(sc, desc_k<D, R>(q_addr, 64 * wg, kk),
                     desc_k<D, BN>(k_addr, 0, kk), 1);
      wg_commit();
      mbar_wait(v_full + s, ph);
      wg_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        wgmma_ss_n64(dp, desc_k<D, R>(do_addr, 64 * wg, kk),
                     desc_k<D, BN>(v_addr, 0, kk), 1);
      wg_commit();
      wg_wait<0>();
      fence_regs(sc);
      fence_regs(dp);

      const bool masked =
          (dm.causal && k0 + BN - 1 > row_lo) ||
          (dm.window > 0 && k0 <= row_lo + 63 - dm.window) ||
          k0 + BN > dm.Skv || row_lo + 64 > dm.Sq;
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        const int r = (i >> 1) & 1;
        float p = exp2f(sc[i] * dm.scale_log2 - lse2[r]);
        if (masked && !visible(tq[r], k0 + acc_col(t, i), dm)) p = 0.f;
        sc[i] = p * (dp[i] - dl[r]) * dm.scale;     // ds
      }
      // every A fragment first: a fence between two products of one
      // accumulator would make the second wait for the first
      uint32_t a[4][4];
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) acc_to_a(sc, kk, a[kk]);
      wg_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        wgmma_rs<D>(acc, a[kk], desc_mn<D, BN>(k_addr, kk));
      wg_commit();
      wg_wait<0>();
      fence_regs(acc);
      mbar_arrive(empty + s);
    }

#pragma unroll
    for (int r = 0; r < 2; ++r) {
      if (tq[r] >= dm.Sq) continue;
      __nv_bfloat16* row = dq + (((size_t)b * dm.Sq + tq[r]) * dm.Hq + h) * D;
#pragma unroll
      for (int i = 2 * r; i < D / 2; i += 4)
        *reinterpret_cast<__nv_bfloat162*>(row + acc_col(t, i)) =
            __floats2bfloat162_rn(acc[i], acc[i + 1]);
    }
  }
}

// --- dk and dv --------------------------------------------------------------

template <int D>
struct DkvSmem {
  static constexpr size_t T = (size_t)BN * D * 2;     // one 64 x D tile
  // a stage: Q, dO, then lse and delta of its 64 positions
  static constexpr size_t STAGE = 2 * T + 2 * BN * sizeof(float);
  static constexpr size_t STAGE_AL = (STAGE + 1023) / 1024 * 1024;
  static constexpr size_t TOTAL = 1024 + 2 * T + STAGES * STAGE_AL + 1024;
};

template <int D>
__global__ void __launch_bounds__(384, 1)
flash_dkv_wgmma_kernel(const __grid_constant__ CUtensorMap qmap,
                       const __grid_constant__ CUtensorMap kmap,
                       const __grid_constant__ CUtensorMap vmap,
                       const __grid_constant__ CUtensorMap dmap,
                       const float* __restrict__ lse,
                       const float* __restrict__ delta,
                       __nv_bfloat16* __restrict__ dk,
                       __nv_bfloat16* __restrict__ dv, Dims dm) {
  using L = DkvSmem<D>;
  extern __shared__ char smem_raw[];
  char* smem = reinterpret_cast<char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  char* Kt = smem;
  char* Vt = Kt + L::T;
  char* stages = Vt + L::T;
  uint64_t* bars = reinterpret_cast<uint64_t*>(stages + STAGES * L::STAGE_AL);
  uint64_t* kv_full = bars;
  uint64_t* full = bars + 1;
  uint64_t* empty = full + STAGES;

  const int hk = blockIdx.x, b = blockIdx.y;
  const int k0 = blockIdx.z * BN;        // key tile 0 (seen most) first
  const int G = dm.Hq / dm.Hkv;
  // the positions that see some key of [k0, k_hi]: from k0 (causal) up to
  // the last key's window
  const int k_hi = min(k0 + BN, dm.Skv) - 1;
  const int t_first = dm.causal ? min(k0, dm.Sq) : 0;
  const int t_end = dm.window > 0 ? min(dm.Sq, k_hi + dm.window) : dm.Sq;
  const int p_lo = t_first / BN;
  const int n_pt = t_end > t_first ? (t_end - 1) / BN - p_lo + 1 : 0;
  const int steps = G * n_pt;

  if (threadIdx.x == 0) {
    mbar_init(kv_full, 1);
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full + s, 1);
      mbar_init(empty + s, 256);
    }
    fence_barrier_init();
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == 2) {
    // ---- producer: warp 8 copies lse and delta, its lane 0 issues TMA ----
    reg_dealloc<24>();
    if (threadIdx.x < 256 + 32) {
      const int lane = threadIdx.x % 32;
      if (lane == 0) {
        mbar_expect_tx(kv_full, (uint32_t)(2 * L::T));
        tma_tile<D, BN>(Kt, 0, &kmap, kv_full, hk, k0, b);
        tma_tile<D, BN>(Vt, 0, &vmap, kv_full, hk, k0, b);
      }
      for (int n = 0; n < steps; ++n) {
        const int s = n % STAGES;
        const int h = hk * G + n / n_pt, t0 = (p_lo + n % n_pt) * BN;
        char* st = stages + s * L::STAGE_AL;
        float* Ls = reinterpret_cast<float*>(st + 2 * L::T);
        float* Ds = Ls + BN;
        mbar_wait(empty + s, ((n / STAGES) & 1) ^ 1);
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int c = lane + 32 * e, tq = t0 + c;
          const size_t at = ((size_t)b * dm.Hq + h) * dm.Sq + tq;
          Ls[c] = tq < dm.Sq ? lse[at] * LOG2E : 0.f;
          Ds[c] = tq < dm.Sq ? delta[at] : 0.f;
        }
        __threadfence_block();          // lane 0's arrival publishes them
        __syncwarp();
        if (lane == 0) {
          mbar_expect_tx(full + s, (uint32_t)(2 * L::T));
          tma_tile<D, BN>(st, 0, &qmap, full + s, h, t0, b);
          tma_tile<D, BN>(st + L::T, 0, &dmap, full + s, h, t0, b);
        }
      }
    }
  } else {
    // ---- wg 0: p^T and dv; wg 1: p^T, dp^T, ds^T and dk ----
    reg_alloc<240>();
    const int t = threadIdx.x % 128;
    const int key[2] = {k0 + acc_row(t, 0), k0 + acc_row(t, 0) + 8};
    float acc[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
    const uint32_t k_addr = smem_u32(Kt), v_addr = smem_u32(Vt);

    mbar_wait(kv_full, 0);
    for (int n = 0; n < steps; ++n) {
      const int s = n % STAGES, ph = (n / STAGES) & 1;
      const int t0 = (p_lo + n % n_pt) * BN;
      char* st = stages + s * L::STAGE_AL;
      const uint32_t q_addr = smem_u32(st), do_addr = smem_u32(st + L::T);
      const float* Ls = reinterpret_cast<const float*>(st + 2 * L::T);
      const float* Ds = Ls + BN;
      float sc[32], dp[32];
#pragma unroll
      for (int i = 0; i < 32; ++i) sc[i] = dp[i] = 0.f;
      mbar_wait(full + s, ph);
      wg_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        wgmma_ss_n64(sc, desc_k<D, BN>(k_addr, 0, kk),
                     desc_k<D, BN>(q_addr, 0, kk), 1);
      if (wg == 1) {
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk)
          wgmma_ss_n64(dp, desc_k<D, BN>(v_addr, 0, kk),
                       desc_k<D, BN>(do_addr, 0, kk), 1);
      }
      wg_commit();
      wg_wait<0>();
      fence_regs(sc);
      fence_regs(dp);

      const bool masked =
          (dm.causal && k0 + BN - 1 > t0) ||
          (dm.window > 0 && k0 <= t0 + BN - 1 - dm.window) ||
          k0 + BN > dm.Skv || t0 + BN > dm.Sq;
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        const int c = acc_col(t, i);            // position t0 + c
        float p = exp2f(sc[i] * dm.scale_log2 - Ls[c]);
        if (masked && !visible(t0 + c, key[(i >> 1) & 1], dm)) p = 0.f;
        sc[i] = wg == 0 ? p : p * (dp[i] - Ds[c]) * dm.scale;
      }
      uint32_t a[4][4];
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) acc_to_a(sc, kk, a[kk]);
      const uint32_t b_addr = wg == 0 ? do_addr : q_addr;
      wg_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)   // wg 0: dv += p^T dO; wg 1: dk += ds^T Q
        wgmma_rs<D>(acc, a[kk], desc_mn<D, BN>(b_addr, kk));
      wg_commit();
      wg_wait<0>();
      fence_regs(acc);
      mbar_arrive(empty + s);
    }

    __nv_bfloat16* dst = wg == 0 ? dv : dk;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      if (key[r] >= dm.Skv) continue;
      __nv_bfloat16* row = dst + (((size_t)b * dm.Skv + key[r]) * dm.Hkv + hk) * D;
#pragma unroll
      for (int i = 2 * r; i < D / 2; i += 4)
        *reinterpret_cast<__nv_bfloat162*>(row + acc_col(t, i)) =
            __floats2bfloat162_rn(acc[i], acc[i + 1]);
    }
  }
}

template <int D>
cudaError_t launch(const CUtensorMap& qm, const CUtensorMap& km,
                   const CUtensorMap& vm, const CUtensorMap& dm_,
                   const float* lse, const float* delta, void* dq, void* dk,
                   void* dv, Dims dm, cudaStream_t stream) {
  constexpr int NWG = dq_nwg<D>();
  auto dq_kernel = flash_dq_wgmma_kernel<D, NWG>;
  auto dkv_kernel = flash_dkv_wgmma_kernel<D>;
  constexpr size_t smem_q = DqSmem<D, NWG>::TOTAL, smem_kv = DkvSmem<D>::TOTAL;
  cudaError_t err = allow_smem(dq_kernel, smem_q);
  if (err == cudaSuccess) err = allow_smem(dkv_kernel, smem_kv);
  if (err != cudaSuccess) return err;
  const int R = 64 * NWG;
  dq_kernel<<<dim3(dm.Hq, dm.B, (dm.Sq + R - 1) / R), 128 * (NWG + 1), smem_q,
              stream>>>(qm, km, vm, dm_, lse, delta,
                        static_cast<__nv_bfloat16*>(dq), dm);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  dkv_kernel<<<dim3(dm.Hkv, dm.B, (dm.Skv + BN - 1) / BN), 384, smem_kv,
               stream>>>(qm, km, vm, dm_, lse, delta,
                         static_cast<__nv_bfloat16*>(dk),
                         static_cast<__nv_bfloat16*>(dv), dm);
  return cudaGetLastError();
}

}  // namespace

// q, out and do (B, Sq, Hq, dh), k and v (B, Skv, Hkv, dh), bf16, each with
// element strides (batch, sequence, head) and a unit dh stride; q, k, v and
// do with a 16-byte-aligned base and strides of whole 16-byte units (TMA's
// rule: the wrapper checks it).  lse (B, Hq, Sq) float32 contiguous; delta
// (B, Hq, Sq) float32 scratch, written here; dq (B, Sq, Hq, dh), dk and dv
// (B, Skv, Hkv, dh) bf16 contiguous, written whole.  Launches delta, dq,
// then dk/dv; returns the first CUDA error code (0 = launched).
extern "C" int flash_attention_bwd_wgmma(
    const void* q, const void* k, const void* v, const void* out,
    const void* dout, const void* lse, void* delta, void* dq, void* dk,
    void* dv, int B, int Sq, int Skv, int Hq, int Hkv, int dh, long long qsb,
    long long qss, long long qsh, long long ksb, long long kss, long long ksh,
    long long vsb, long long vss, long long vsh, long long dsb, long long dss,
    long long dsh, long long osb, long long oss, long long osh, int causal,
    int window, float scale, void* stream) {
  if (B == 0 || Sq == 0 || Skv == 0) return 0;
  if (Hkv <= 0 || Hq % Hkv != 0) return cudaErrorInvalidValue;
  CUtensorMap qm, km, vm, dmap;
  cudaError_t err = make_map(&qm, q, B, Sq, Hq, dh, qsb, qss, qsh);
  if (err == cudaSuccess) err = make_map(&km, k, B, Skv, Hkv, dh, ksb, kss, ksh);
  if (err == cudaSuccess) err = make_map(&vm, v, B, Skv, Hkv, dh, vsb, vss, vsh);
  if (err == cudaSuccess) err = make_map(&dmap, dout, B, Sq, Hq, dh, dsb, dss, dsh);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* d = static_cast<float*>(delta);
  const long long rows = (long long)B * Sq * Hq;
  flash_delta_kernel<<<(unsigned)((rows + 7) / 8), 256, 0, s>>>(
      static_cast<const __nv_bfloat16*>(out),
      static_cast<const __nv_bfloat16*>(dout), d, Strides{osb, oss, osh},
      Strides{dsb, dss, dsh}, B, Sq, Hq, dh);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const Dims dm{B, Sq, Skv, Hq, Hkv, causal, window, scale, scale * LOG2E};
  const float* l = static_cast<const float*>(lse);
  switch (dh) {
#define FA_CASE(D)                                                           \
  case D:                                                                    \
    err = launch<D>(qm, km, vm, dmap, l, d, dq, dk, dv, dm, s);              \
    break;
    FA_CASE(16)
    FA_CASE(32)
    FA_CASE(64)
    FA_CASE(128)
    FA_CASE(256)
#undef FA_CASE
    default:
      err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}
