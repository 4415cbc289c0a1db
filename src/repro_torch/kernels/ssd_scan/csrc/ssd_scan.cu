// Mamba2 SSD chunked scan for Hopper (sm_90a), float32 B and C, plain C
// interface.
//
// Replaces the TPU kernel ssd_scan (src/repro/kernels/ssd_scan/kernel.py:72,
// body _ssd_kernel) for float32 B and C; bf16 B and C (the model path) take
// the tensor-core kernel ssd_scan_wgmma.cu.  In the kernel's head-major
// layout
//   xdt (BH, S, P) float32 dt-weighted inputs, a (BH, S) float32 log-decays,
//   B and C (BG, S, N) float32, head b reading group b / G,
// it returns y (BH, S, P) float32 and the final state h (BH, N, P) float32,
// where per chunk of Q steps (a_cum the inclusive cumulative sum of a over
// the chunk)
//   y[q]   = sum_{k <= q} exp(a_cum[q] - a_cum[k]) (C[q] . B[k]) xdt[k]
//          + exp(a_cum[q]) C[q] @ h_prev
//   h_next = exp(a_cum[Q-1]) h_prev + sum_k exp(a_cum[Q-1] - a_cum[k]) B[k] xdt[k]^T
// with h_prev the state before the chunk (0 before the first).  The chunk
// length is a blocking choice: the function equals the per-step recurrence
// up to rounding.
//
// What bounds it on this card: operations on the FMA path.  At the
// training shape (mamba2-780m, B = 4, S = 2048: BH = 192, P = 64, N = 128,
// Q = 256) the three products of a chunk cost about 21 MFLOP with the
// causal half of C B^T skipped, 32 GFLOP in all, against about 0.2 GB of
// inputs and outputs.  It multiplies in float32 with FMA loops: the float32
// tolerance of the JAX package's test (3e-4) is out of reach of TF32.
//
// What the design does:
//   * The TPU grid walks the chunks of a head in order and carries the
//     (N, P) state in VMEM scratch.  On 132 SMs that order would leave a
//     grid of BH blocks, fewer than one an SM at B = 2.  So the work is cut
//     in three launches that are parallel over (head, chunk) where they
//     can be:
//       1. ssd_chunk_state: per (head, chunk, 64-column tile) the chunk's
//          own state contribution sum_k decay_to_end[k] B[k] xdt[k]^T, and
//          the chunk's total log-decay;
//       2. ssd_state_pass: per (head, 256 state entries) the short
//          sequential pass over the chunks that turns the contributions
//          into the state before each chunk (written over them) and the
//          final state;
//       3. ssd_chunk_scan: per (head, chunk, 64-row tile, 64-column tile)
//          the output rows: the intra-chunk product over the key tiles at
//          or before the row tile (the mask is causal, later tiles are
//          never visited), then the inter-chunk term from the state before
//          the chunk.
//   * A 256 x 256 float32 score tile would be 256 KB, more than a block's
//     227 KB of shared memory, so scores are made 64 x 64 at a time.
//   * The decay exp(a_cum[q] - a_cum[k]) is taken only where k <= q: above
//     the diagonal the difference is positive and exp of it could be inf,
//     and inf * 0 is NaN.
//   * B and C of a group are read by every head of the group through
//     b / G.
//
// 256 threads form a 16 x 16 grid: thread (ty, tx) owns rows ty*4 .. ty*4+3
// and columns tx, tx+16, tx+32, tx+48 of a 64 x 64 tile.  Shared-memory
// tiles have odd row strides (64 + 1, N + 1) so that the transposed stores
// and the column reads fall in distinct banks.

#include <cuda_runtime.h>
#include <stddef.h>

namespace {

constexpr int T = 64;            // rows, keys and columns of a tile
constexpr int LT = T + 1;        // row stride of a T-wide tile
constexpr int THREADS = 256;     // 16 x 16
constexpr int MAX_N = 256;       // state size the kernels are built for

// Inclusive cumulative sum of a chunk's Q log-decays into acum[0 .. Q-1]:
// warp 0 does it, each lane a run of consecutive steps, the runs joined by
// a shuffle scan of their totals.  Ends in a __syncthreads.
__device__ void chunk_cumsum(const float* __restrict__ a, int Q,
                             float* acum) {
  if (threadIdx.x < 32) {
    const int lane = threadIdx.x;
    const int per = (Q + 31) / 32;
    const int lo = min(lane * per, Q), hi = min(lo + per, Q);
    float run = 0.f;
    for (int i = lo; i < hi; ++i) {
      run += a[i];
      acum[i] = run;
    }
    float incl = run;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const float v = __shfl_up_sync(0xffffffffu, incl, d);
      if (lane >= d) incl += v;
    }
    const float offset = incl - run;
    for (int i = lo; i < hi; ++i) acum[i] += offset;
  }
  __syncthreads();
}

struct Geo {
  int BH, S, P, N, Q, nc, G;
};

// 1. per (column tile, chunk, head): contrib[n][p] = sum_k B[k][n]
//    exp(a_tot - a_cum[k]) xdt[k][p] into states (BH, nc, N, P); a_tot
//    into atot (BH, nc).  Thread (ty, tx) owns state rows ty + 16 i.
template <int NI>
__global__ void __launch_bounds__(THREADS)
ssd_chunk_state(const float* __restrict__ x, const float* __restrict__ a,
                const float* __restrict__ Bm, float* __restrict__ states,
                float* __restrict__ atot, Geo g) {
  extern __shared__ float smem[];
  const int N = g.N, LN = N + 1;
  float* acum = smem;                       // Q
  float* Bs = acum + g.Q;                   // T x (N + 1): keys x n
  float* Xs = Bs + T * LN;                  // T x LT: keys x columns
  const int p0 = blockIdx.x * T, c = blockIdx.y, bh = blockIdx.z;
  const int np = min(T, g.P - p0);
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const long long s0 = (long long)c * g.Q;
  const float* xb = x + ((long long)bh * g.S + s0) * g.P + p0;
  const float* Bb = Bm + ((long long)(bh / g.G) * g.S + s0) * N;

  chunk_cumsum(a + (long long)bh * g.S + s0, g.Q, acum);
  const float a_tot = acum[g.Q - 1];
  if (blockIdx.x == 0 && threadIdx.x == 0) atot[bh * g.nc + c] = a_tot;

  float acc[NI][4];
#pragma unroll
  for (int i = 0; i < NI; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < g.Q; k0 += T) {
    const int nk = min(T, g.Q - k0);
    for (int e = threadIdx.x; e < T * N; e += THREADS) {
      const int k = e / N, n = e % N;
      Bs[k * LN + n] = k < nk ? (Bb[(long long)(k0 + k) * N + n]) : 0.f;
    }
    for (int e = threadIdx.x; e < T * T; e += THREADS) {
      const int k = e / T, p = e % T;
      Xs[k * LT + p] = (k < nk && p < np)
          ? xb[(long long)(k0 + k) * g.P + p] * expf(a_tot - acum[k0 + k])
          : 0.f;
    }
    __syncthreads();
    for (int k = 0; k < nk; ++k) {
      float xv[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) xv[j] = Xs[k * LT + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < NI; ++i) {
        const int n = ty + 16 * i;
        const float bv = n < N ? Bs[k * LN + n] : 0.f;
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] += bv * xv[j];
      }
    }
    __syncthreads();
  }
  float* out = states + ((long long)bh * g.nc + c) * N * g.P + p0;
#pragma unroll
  for (int i = 0; i < NI; ++i) {
    const int n = ty + 16 * i;
    if (n >= N) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int p = tx + 16 * j;
      if (p < np) out[(long long)n * g.P + p] = acc[i][j];
    }
  }
}

// 2. per (256 state entries, head): walk the chunks in order; the state
//    before chunk c overwrites its contribution, the last state goes to
//    h_final (BH, N, P).
__global__ void __launch_bounds__(THREADS)
ssd_state_pass(float* __restrict__ states, const float* __restrict__ atot,
               float* __restrict__ h_final, Geo g) {
  const int NP = g.N * g.P;
  const int idx = blockIdx.x * THREADS + threadIdx.x, bh = blockIdx.y;
  if (idx >= NP) return;
  float h = 0.f;
  float* s = states + (long long)bh * g.nc * NP + idx;
  for (int c = 0; c < g.nc; ++c) {
    const float contrib = s[(long long)c * NP];
    s[(long long)c * NP] = h;
    h = h * expf(atot[bh * g.nc + c]) + contrib;
  }
  h_final[(long long)bh * NP + idx] = h;
}

// 3. per (row tile x column tile, chunk, head): y for 64 rows and 64
//    columns of the chunk.
__global__ void __launch_bounds__(THREADS)
ssd_chunk_scan(const float* __restrict__ x, const float* __restrict__ a,
               const float* __restrict__ Bm, const float* __restrict__ Cm,
               const float* __restrict__ states, float* __restrict__ y,
               Geo g) {
  extern __shared__ float smem[];
  const int N = g.N, LN = N + 1;
  float* acum = smem;                       // Q
  float* Cs = acum + g.Q;                   // T x (N + 1): rows x n
  float* Bt = Cs + T * LN;                  // N x LT: n x keys; then the
                                            // state before the chunk, n x p
  float* Xs = Bt + N * LT;                  // T x LT: keys x columns
  float* Ws = Xs + T * LT;                  // T x LT: rows x keys
  const int row_tiles = (g.Q + T - 1) / T;
  const int rt = blockIdx.x % row_tiles, pt = blockIdx.x / row_tiles;
  const int q0 = rt * T, p0 = pt * T, c = blockIdx.y, bh = blockIdx.z;
  const int nq = min(T, g.Q - q0), np = min(T, g.P - p0);
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const long long s0 = (long long)c * g.Q;
  const float* xb = x + ((long long)bh * g.S + s0) * g.P + p0;
  const long long gb = ((long long)(bh / g.G) * g.S + s0) * N;
  const float* Bb = Bm + gb;
  const float* Cb = Cm + gb;

  for (int e = threadIdx.x; e < T * N; e += THREADS) {
    const int r = e / N, n = e % N;
    Cs[r * LN + n] = r < nq ? (Cb[(long long)(q0 + r) * N + n]) : 0.f;
  }
  chunk_cumsum(a + (long long)bh * g.S + s0, g.Q, acum);

  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 <= q0; k0 += T) {     // key tiles at or before the rows
    const int nk = min(T, g.Q - k0);
    for (int e = threadIdx.x; e < T * N; e += THREADS) {
      const int k = e / N, n = e % N;
      Bt[n * LT + k] = k < nk ? (Bb[(long long)(k0 + k) * N + n]) : 0.f;
    }
    for (int e = threadIdx.x; e < T * T; e += THREADS) {
      const int k = e / T, p = e % T;
      Xs[k * LT + p] = (k < nk && p < np) ? xb[(long long)(k0 + k) * g.P + p]
                                          : 0.f;
    }
    __syncthreads();
    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
    for (int n = 0; n < N; ++n) {
      float cv[4], bv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) cv[i] = Cs[(ty * 4 + i) * LN + n];
#pragma unroll
      for (int j = 0; j < 4; ++j) bv[j] = Bt[n * LT + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] += cv[i] * bv[j];
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int q = q0 + ty * 4 + i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int k = k0 + tx + 16 * j;
        // mask first: above the diagonal the exponent is positive
        const float w = (k <= q && q < g.Q) ? expf(acum[q] - acum[k]) : 0.f;
        Ws[(ty * 4 + i) * LT + tx + 16 * j] = s[i][j] * w;
      }
    }
    __syncthreads();
    for (int k = 0; k < nk; ++k) {
      float wv[4], xv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) wv[i] = Ws[(ty * 4 + i) * LT + k];
#pragma unroll
      for (int j = 0; j < 4; ++j) xv[j] = Xs[k * LT + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] += wv[i] * xv[j];
    }
    __syncthreads();
  }

  // inter-chunk: exp(a_cum[q]) C[q] @ h_prev, h_prev (N, P) of this chunk
  const float* hp = states + ((long long)bh * g.nc + c) * N * g.P + p0;
  for (int e = threadIdx.x; e < N * T; e += THREADS) {
    const int n = e / T, p = e % T;
    Bt[n * LT + p] = p < np ? hp[(long long)n * g.P + p] : 0.f;
  }
  __syncthreads();
  float inter[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) inter[i][j] = 0.f;
  for (int n = 0; n < N; ++n) {
    float cv[4], hv[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) cv[i] = Cs[(ty * 4 + i) * LN + n];
#pragma unroll
    for (int j = 0; j < 4; ++j) hv[j] = Bt[n * LT + tx + 16 * j];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) inter[i][j] += cv[i] * hv[j];
  }
  float* yb = y + ((long long)bh * g.S + s0) * g.P + p0;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty * 4 + i;
    if (r >= nq) continue;
    const float decay = expf(acum[q0 + r]);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int p = tx + 16 * j;
      if (p < np)
        yb[(long long)(q0 + r) * g.P + p] = acc[i][j] + decay * inter[i][j];
    }
  }
}

size_t state_smem(const Geo& g) {
  return sizeof(float) * (g.Q + T * (g.N + 1) + T * LT);
}

size_t scan_smem(const Geo& g) {
  return sizeof(float) * (g.Q + T * (g.N + 1) + g.N * LT + 2 * T * LT);
}

template <int NI>
cudaError_t launch_state(const float* x, const float* a, const float* Bm,
                         float* states, float* atot, const Geo& g,
                         cudaStream_t stream) {
  const size_t smem = state_smem(g);
  cudaError_t err = cudaFuncSetAttribute(
      ssd_chunk_state<NI>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((g.P + T - 1) / T, g.nc, g.BH);
  ssd_chunk_state<NI><<<grid, THREADS, smem, stream>>>(x, a, Bm, states,
                                                            atot, g);
  return cudaGetLastError();
}

cudaError_t launch(const float* x, const float* a, const float* Bm,
                   const float* Cm, float* y, float* h_final, float* states,
                   float* atot, const Geo& g, cudaStream_t stream) {
  cudaError_t err;
  if (g.N <= 16) {
    err = launch_state<1>(x, a, Bm, states, atot, g, stream);
  } else if (g.N <= 32) {
    err = launch_state<2>(x, a, Bm, states, atot, g, stream);
  } else if (g.N <= 64) {
    err = launch_state<4>(x, a, Bm, states, atot, g, stream);
  } else if (g.N <= 128) {
    err = launch_state<8>(x, a, Bm, states, atot, g, stream);
  } else {
    err = launch_state<16>(x, a, Bm, states, atot, g, stream);
  }
  if (err != cudaSuccess) return err;
  const dim3 pass_grid((g.N * g.P + THREADS - 1) / THREADS, g.BH);
  ssd_state_pass<<<pass_grid, THREADS, 0, stream>>>(states, atot, h_final, g);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const size_t smem = scan_smem(g);
  err = cudaFuncSetAttribute(ssd_chunk_scan,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
  if (err != cudaSuccess) return err;
  const int row_tiles = (g.Q + T - 1) / T, col_tiles = (g.P + T - 1) / T;
  const dim3 grid(row_tiles * col_tiles, g.nc, g.BH);
  ssd_chunk_scan<<<grid, THREADS, smem, stream>>>(x, a, Bm, Cm, states,
                                                       y, g);
  return cudaGetLastError();
}

}  // namespace

// xdt (BH, S, P) and a (BH, S) float32; B and C (BG, S, N) float32,
// BH = BG * G; y (BH, S, P) and h_final (BH, N, P) float32; scratch: states
// (BH, S / Q, N, P) and atot (BH, S / Q) float32.  All contiguous.  S must
// be a multiple of the chunk Q, and N at most 256.  Returns the launches'
// CUDA error code (0 = launched).
extern "C" int ssd_scan(const void* xdt, const void* a, const void* B,
                        const void* C, void* y, void* h_final, void* states,
                        void* atot, int BH, int S, int P, int N, int G, int Q,
                        void* stream) {
  if (BH == 0 || S == 0 || P == 0) return 0;
  if (Q <= 0 || S % Q != 0 || N <= 0 || N > MAX_N || G <= 0 || BH % G != 0)
    return cudaErrorInvalidValue;
  const Geo g{BH, S, P, N, Q, S / Q, G};
  if (g.nc > 65535 || BH > 65535) return cudaErrorInvalidValue;
  const cudaError_t err = launch(
      static_cast<const float*>(xdt), static_cast<const float*>(a),
      static_cast<const float*>(B), static_cast<const float*>(C),
      static_cast<float*>(y), static_cast<float*>(h_final),
      static_cast<float*>(states), static_cast<float*>(atot), g,
      static_cast<cudaStream_t>(stream));
  return static_cast<int>(err);
}
