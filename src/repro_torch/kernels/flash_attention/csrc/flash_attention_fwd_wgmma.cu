// Flash-attention forward on Hopper's tensor cores (sm_90a), bf16, plain C
// interface.
//
// Replaces the TPU kernel flash_attention_fwd
// (src/repro/kernels/flash_attention/kernel.py:101, body _fwd_kernel) for
// bf16 inputs; float32 inputs take flash_attention_fwd.cu (FMA loops), since
// the float32 tolerance of the JAX package's tests (2e-5) is out of reach of
// TF32 tensor cores.  Causal and/or sliding-window GQA self-attention with an
// online softmax; out (B, Sq, Hq, dh) in bf16 and lse = m + log(l) of the
// scaled scores as float32 (B, Hq, Sq).
//
// What bounds it on this card: operations.  At the training shape (B 2,
// S 2048, 24 query heads over 8, dh 128, causal) the visible (query, key)
// pairs cost 4 * dh flops each, 51.6 GFLOP: 0.052 ms at 989 TFLOP/s against
// 0.020 ms for the 67.5 MB of q, k, v, out and lse at 3.35 TB/s.
//
// What the design does:
//   * a block owns 128 query rows of one (batch, query head) and walks
//     the kv tiles of 64 keys its rows can see (causal: up to its last row;
//     window: from its first row's oldest key); blocks of the longest rows
//     are issued first;
//   * a producer warp loads the block's Q once and K and V into a ring of
//     two stages by TMA (completion on mbarriers), while two consumer
//     warpgroups compute on the stage before: S = Q K^T and O += P V are
//     wgmma (bf16 in, f32 accumulate), each warpgroup 64 rows;
//   * tiles stay bf16 in shared memory in TMA's swizzled layout (see
//     hopper.cuh); P goes from the S accumulator to the A operand of the PV
//     product in registers, rounded to bf16 as _fwd_kernel's
//     p.astype(v.dtype) does; l sums the unrounded p;
//   * a query head re-reads its kv head's tiles (GQA) through the 50 MB L2,
//     so a TMA box is always 64 whole positions of one head.
// At dh 256 Q takes 64 KB and the two K/V stages 128 KB of shared memory,
// and the O accumulator 128 registers a thread: the consumer warpgroups
// take 240 registers from the producer's (setmaxnreg).  Masking (causal,
// window, keys past Skv) is applied inside the tiles that need it; TMA
// fills positions past the sequence with zeros.  A row with no visible key
// would come out 0 with lse -1e30 (self-attention always sees itself).

#include "hopper.cuh"

namespace {

using namespace hk;

constexpr int BN = 64;        // keys per kv tile
constexpr int STAGES = 2;
constexpr int NWG = 2;        // consumer warpgroups: 128 query rows a block

template <int D>
struct FwdSmem {
  static constexpr int R = 64 * NWG;                  // query rows
  static constexpr size_t Q = (size_t)R * D * 2;
  static constexpr size_t KV = (size_t)BN * D * 2;    // one K or V tile
  static constexpr size_t BARS = 1024;
  static constexpr size_t TOTAL = 1024 + Q + 2 * STAGES * KV + BARS;
};

struct Dims {
  int B, Sq, Skv, Hq, Hkv, causal, window;
  float scale_log2;        // dh ** -0.5 * log2(e)
};

template <int D>
__global__ void __launch_bounds__(128 * (NWG + 1), 1)
flash_fwd_wgmma_kernel(const __grid_constant__ CUtensorMap qmap,
                       const __grid_constant__ CUtensorMap kmap,
                       const __grid_constant__ CUtensorMap vmap,
                       __nv_bfloat16* __restrict__ out, float* __restrict__ lse,
                       Dims dm) {
  using L = FwdSmem<D>;
  constexpr int R = L::R;
  extern __shared__ char smem_raw[];
  char* smem = reinterpret_cast<char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  char* Qs = smem;
  char* Ks = Qs + L::Q;                       // STAGES tiles
  char* Vs = Ks + STAGES * L::KV;             // STAGES tiles
  uint64_t* bars = reinterpret_cast<uint64_t*>(Vs + STAGES * L::KV);
  uint64_t* q_full = bars;
  uint64_t* k_full = bars + 1;
  uint64_t* v_full = k_full + STAGES;
  uint64_t* empty = v_full + STAGES;

  const int n_rt = (dm.Sq + R - 1) / R;
  const int r0 = (n_rt - 1 - (int)blockIdx.z) * R;    // longest rows first
  const int h = blockIdx.x, b = blockIdx.y;
  const int G = dm.Hq / dm.Hkv, hk = h / G;

  // the kv tiles the block's rows [r0, r0 + R) can see
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
    // ---- producer warpgroup: one thread issues every TMA load ----
    reg_dealloc<24>();
    if (threadIdx.x == 128 * NWG) {
      prefetch_map(&qmap);
      prefetch_map(&kmap);
      prefetch_map(&vmap);
      mbar_expect_tx(q_full, (uint32_t)L::Q);
      for (int half = 0; half < NWG; ++half)
        tma_tile<D, R>(Qs, 64 * half, &qmap, q_full, h, r0 + 64 * half, b);
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
    // ---- consumer warpgroup wg: rows r0 + 64 wg .. + 63 ----
    reg_alloc<240>();
    const int t = threadIdx.x % 128;
    const int row_lo = r0 + 64 * wg;
    const int ta = row_lo + acc_row(t, 0), tb = ta + 8;   // its two rows
    float o[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
    float m[2] = {NEG_INF, NEG_INF}, l[2] = {0.f, 0.f};
    const uint32_t q_addr = smem_u32(Qs);

    mbar_wait(q_full, 0);
    for (int jt = lo; jt <= hi; ++jt) {
      const int it = jt - lo, s = it % STAGES, ph = (it / STAGES) & 1;
      const int k0 = jt * BN;
      float sc[32];
#pragma unroll
      for (int i = 0; i < 32; ++i) sc[i] = 0.f;
      mbar_wait(k_full + s, ph);
      const uint32_t k_addr = smem_u32(Ks + s * L::KV);
      wg_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        wgmma_ss_n64(sc, desc_k<D, R>(q_addr, 64 * wg, kk),
                     desc_k<D, BN>(k_addr, 0, kk), 1);
      wg_commit();
      wg_wait<0>();
      fence_regs(sc);

      // mask only the tiles that cross the causal diagonal, the window's
      // edge or the end of the keys
      const bool masked =
          (dm.causal && k0 + BN - 1 > row_lo) ||
          (dm.window > 0 && k0 <= row_lo + 63 - dm.window) || k0 + BN > dm.Skv;
      float mt[2] = {NEG_INF, NEG_INF};
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        float x = sc[i] * dm.scale_log2;
        if (masked) {
          const int tq = (i & 2) ? tb : ta, j = k0 + acc_col(t, i);
          const bool ok = j < dm.Skv && (!dm.causal || j <= tq) &&
                          (dm.window == 0 || j > tq - dm.window);
          x = ok ? x : NEG_INF;
        }
        sc[i] = x;
        mt[(i >> 1) & 1] = fmaxf(mt[(i >> 1) & 1], x);
      }
      float alpha[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        mt[r] = fmaxf(mt[r], __shfl_xor_sync(0xffffffffu, mt[r], 1));
        mt[r] = fmaxf(mt[r], __shfl_xor_sync(0xffffffffu, mt[r], 2));
        const float m_new = fmaxf(m[r], mt[r]);
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
    }

    // l: the four threads of a row each summed their own columns
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int tq = r ? tb : ta;
      if (tq >= dm.Sq) continue;
      const float inv = 1.f / (l[r] > 0.f ? l[r] : 1.f);
      __nv_bfloat16* orow =
          out + (((size_t)b * dm.Sq + tq) * dm.Hq + h) * D;
#pragma unroll
      for (int i = 2 * r; i < D / 2; i += 4) {
        // elements i, i + 1 of this row: columns acc_col(t, i), + 1
        *reinterpret_cast<__nv_bfloat162*>(orow + acc_col(t, i)) =
            __floats2bfloat162_rn(o[i] * inv, o[i + 1] * inv);
      }
      if (t % 4 == 0) {
        lse[((size_t)b * dm.Hq + h) * dm.Sq + tq] =
            l[r] > 0.f ? m[r] * LN2 + logf(l[r]) : NEG_INF;
      }
    }
  }
}

template <int D>
cudaError_t launch(const CUtensorMap& qm, const CUtensorMap& km,
                   const CUtensorMap& vm, void* out, float* lse, Dims dm,
                   cudaStream_t stream) {
  auto kernel = flash_fwd_wgmma_kernel<D>;
  constexpr size_t smem = FwdSmem<D>::TOTAL;
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  const int R = 64 * NWG;
  const dim3 grid(dm.Hq, dm.B, (dm.Sq + R - 1) / R);
  kernel<<<grid, 128 * (NWG + 1), smem, stream>>>(
      qm, km, vm, static_cast<__nv_bfloat16*>(out), lse, dm);
  return cudaGetLastError();
}

}  // namespace

// q (B, Sq, Hq, dh), k and v (B, Skv, Hkv, dh), bf16, each with element
// strides (batch, sequence, head), a unit dh stride, a 16-byte-aligned base
// and strides of whole 16-byte units (TMA's rule: the wrapper checks it);
// out (B, Sq, Hq, dh) bf16 and lse (B, Hq, Sq) float32, contiguous.
// Returns the CUDA error code of the launch (0 = launched).
extern "C" int flash_attention_fwd_wgmma(
    const void* q, const void* k, const void* v, void* out, void* lse, int B,
    int Sq, int Skv, int Hq, int Hkv, int dh, long long qsb, long long qss,
    long long qsh, long long ksb, long long kss, long long ksh, long long vsb,
    long long vss, long long vsh, int causal, int window, float scale,
    void* stream) {
  if (B == 0 || Sq == 0) return 0;
  if (Hkv <= 0 || Hq % Hkv != 0 || Skv <= 0) return cudaErrorInvalidValue;
  CUtensorMap qm, km, vm;
  cudaError_t err = make_map(&qm, q, B, Sq, Hq, dh, qsb, qss, qsh);
  if (err == cudaSuccess) err = make_map(&km, k, B, Skv, Hkv, dh, ksb, kss, ksh);
  if (err == cudaSuccess) err = make_map(&vm, v, B, Skv, Hkv, dh, vsb, vss, vsh);
  if (err != cudaSuccess) return static_cast<int>(err);
  const Dims dm{B, Sq, Skv, Hq, Hkv, causal, window, scale * LOG2E};
  float* l = static_cast<float*>(lse);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dh) {
    case 16: err = launch<16>(qm, km, vm, out, l, dm, s); break;
    case 32: err = launch<32>(qm, km, vm, out, l, dm, s); break;
    case 64: err = launch<64>(qm, km, vm, out, l, dm, s); break;
    case 128: err = launch<128>(qm, km, vm, out, l, dm, s); break;
    case 256: err = launch<256>(qm, km, vm, out, l, dm, s); break;
    default: err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}
