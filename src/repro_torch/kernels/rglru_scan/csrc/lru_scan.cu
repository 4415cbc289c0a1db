// RG-LRU linear-recurrence scan for Hopper (sm_90a), plain C interface.
//
// Replaces the TPU kernel lru_scan (src/repro/kernels/rglru_scan/kernel.py:57,
// bodies _lru_kernel and _chunk_scan): h_t = a_t h_{t-1} + b_t along the
// sequence for (B, S, W) float32 a and b, float32 h out, any S and W (the TPU
// kernel's S % block_s == 0 is not carried over).  Two additions to the TPU
// contract: an optional carried state h0 (B, W) (h_{-1} = h0, zeros when
// absent), as the JAX oracle lru_scan_ref(a, b, h0) takes it, and a reverse
// flag that scans from the end (h_t = a_t h_{t+1} + b_t, h_S = h0), which the
// backward uses so it needs no flipped copies.  The final state (h at the
// last step of the scan order) is written to h_final (B, W).
//
// What bounds it on this card: bytes.  One multiply-add per element against
// 12 bytes (a and b read, h written): at the training shape (B 1, S 4096,
// W 4096) 201,326,592 bytes, 0.060 ms at 3.35 TB/s.
//
// What the design does.  The TPU grid walks S in order with the carry in
// VMEM, one program per channel block.  On 132 SMs a thread per (batch,
// channel) walking S is coalesced across channels but gives B*W/256 blocks
// (16 at the training shape), far too few to keep the memory system busy.
// So the sequence is cut into chunks of T = 64 steps and the scan runs in
// three launches:
//   1. local: one thread per (batch, chunk, channel) walks its chunk from a
//      zero state and writes the chunk's decay product P = prod a and its
//      local end state E;
//   2. carry: one thread per (batch, channel) walks the chunks in order,
//      carry_{c+1} = P_c carry_c + E_c from h0, and writes each chunk's
//      incoming state;
//   3. fix-up: one thread per (batch, chunk, channel) walks its chunk again
//      from its incoming state and writes h (and h_final from the last
//      chunk).
// Launches 1 and 3 have B * ceil(S/64) * W/256 blocks (1,024 at the training
// shape).  The trade-off: a and b are read twice, 20 bytes an element
// instead of 12 (plus 12 bytes per (batch, chunk, channel) of scratch), for
// full parallelism and no inter-block synchronisation; a single pass with a
// decoupled look-back would move 12.  With one chunk (S <= 64, the serving
// chunk step) only launch 3 runs, from h0.  Adjacent threads take adjacent
// channels, so every load and store of a warp is one 128-byte line.
//
// Layouts (all contiguous, float32): a, b, h (B, S, W); h0, h_final (B, W);
// scratch (3, B, ceil(S/64), W).

#include <cuda_runtime.h>
#include <stddef.h>

namespace {

constexpr int T = 64;          // steps per chunk
constexpr int THREADS = 256;   // channels per block

// sequence position of scan step i
__device__ __forceinline__ int step_pos(int i, int S, int reverse) {
  return reverse ? S - 1 - i : i;
}

__global__ void __launch_bounds__(THREADS)
lru_chunk_local(const float* __restrict__ a, const float* __restrict__ b,
                float* __restrict__ P, float* __restrict__ E, int S, int W,
                int nc, int reverse) {
  const int w = blockIdx.x * THREADS + threadIdx.x;
  if (w >= W) return;
  const int c = blockIdx.y, bb = blockIdx.z;
  const size_t base = (size_t)bb * S * W + w;
  const int i0 = c * T, n = min(T, S - i0);
  float p = 1.f, h = 0.f;
  if (n == T) {
#pragma unroll
    for (int j = 0; j < T; ++j) {
      const size_t at = base + (size_t)step_pos(i0 + j, S, reverse) * W;
      const float x = a[at];
      h = x * h + b[at];
      p *= x;
    }
  } else {
    for (int j = 0; j < n; ++j) {
      const size_t at = base + (size_t)step_pos(i0 + j, S, reverse) * W;
      const float x = a[at];
      h = x * h + b[at];
      p *= x;
    }
  }
  const size_t o = ((size_t)bb * nc + c) * W + w;
  P[o] = p;
  E[o] = h;
}

__global__ void __launch_bounds__(THREADS)
lru_carry(const float* __restrict__ P, const float* __restrict__ E,
          const float* __restrict__ h0, float* __restrict__ carry_in, int W,
          int nc) {
  const int w = blockIdx.x * THREADS + threadIdx.x;
  if (w >= W) return;
  const int bb = blockIdx.y;
  float h = h0 ? h0[(size_t)bb * W + w] : 0.f;
#pragma unroll 8
  for (int c = 0; c < nc; ++c) {
    const size_t o = ((size_t)bb * nc + c) * W + w;
    carry_in[o] = h;
    h = P[o] * h + E[o];
  }
}

// carry_in (B, nc, W), or nullptr with one chunk: the state then starts from
// h0 (or zero).
__global__ void __launch_bounds__(THREADS)
lru_fixup(const float* __restrict__ a, const float* __restrict__ b,
          const float* __restrict__ carry_in, const float* __restrict__ h0,
          float* __restrict__ h_out, float* __restrict__ h_final, int S,
          int W, int nc, int reverse) {
  const int w = blockIdx.x * THREADS + threadIdx.x;
  if (w >= W) return;
  const int c = blockIdx.y, bb = blockIdx.z;
  const size_t base = (size_t)bb * S * W + w;
  const int i0 = c * T, n = min(T, S - i0);
  float h = carry_in ? carry_in[((size_t)bb * nc + c) * W + w]
                     : (h0 ? h0[(size_t)bb * W + w] : 0.f);
  if (n == T) {
#pragma unroll
    for (int j = 0; j < T; ++j) {
      const size_t at = base + (size_t)step_pos(i0 + j, S, reverse) * W;
      h = a[at] * h + b[at];
      h_out[at] = h;
    }
  } else {
    for (int j = 0; j < n; ++j) {
      const size_t at = base + (size_t)step_pos(i0 + j, S, reverse) * W;
      h = a[at] * h + b[at];
      h_out[at] = h;
    }
  }
  if (c == nc - 1) h_final[(size_t)bb * W + w] = h;
}

}  // namespace

// a, b, h (B, S, W); h0 (B, W) or null; h_final (B, W); scratch of
// 3 * B * ceil(S / 64) * W floats (unused when S <= 64).  Returns the first
// CUDA error code of the launches (0 = launched).
extern "C" int lru_scan(const void* a, const void* b, const void* h0, void* h,
                        void* h_final, void* scratch, int B, int S, int W,
                        int reverse, void* stream) {
  if (B == 0 || W == 0) return 0;
  if (B < 0 || S <= 0 || W < 0 || B > 65535) return cudaErrorInvalidValue;
  const float* af = static_cast<const float*>(a);
  const float* bf = static_cast<const float*>(b);
  const float* h0f = static_cast<const float*>(h0);
  float* hf = static_cast<float*>(h);
  float* fin = static_cast<float*>(h_final);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int nc = (S + T - 1) / T;
  const int wb = (W + THREADS - 1) / THREADS;
  if (nc > 65535) return cudaErrorInvalidValue;
  if (nc == 1) {
    lru_fixup<<<dim3(wb, 1, B), THREADS, 0, s>>>(af, bf, nullptr, h0f, hf,
                                                 fin, S, W, 1, reverse);
    return static_cast<int>(cudaGetLastError());
  }
  const size_t n = (size_t)B * nc * W;
  float* P = static_cast<float*>(scratch);
  float* E = P + n;
  float* carry_in = E + n;
  lru_chunk_local<<<dim3(wb, nc, B), THREADS, 0, s>>>(af, bf, P, E, S, W, nc,
                                                      reverse);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  lru_carry<<<dim3(wb, B), THREADS, 0, s>>>(P, E, h0f, carry_in, W, nc);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  lru_fixup<<<dim3(wb, nc, B), THREADS, 0, s>>>(af, bf, carry_in, nullptr, hf,
                                                fin, S, W, nc, reverse);
  return static_cast<int>(cudaGetLastError());
}
