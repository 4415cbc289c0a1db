"""Wrappers of the SSD chunked-scan kernels.

* ``ssd_scan``: the kernel's contract in its head-major layout (the JAX
  package's ``kernels/ssd_scan/kernel.py:72``).  Two routes by B/C's
  dtype: bf16 (the model path) goes to the tensor-core kernel
  (``csrc/ssd_scan_wgmma.cu``: C Bᵀ once for a set of a group's heads,
  float32 operands split in two bf16 parts), float32 to the FMA kernel
  (``csrc/ssd_scan.cu``).  For tensors on the card it launches its
  route's kernel or raises; for tensors on the CPU it computes the plain
  version of ``ref.py``.  There is no other fallback.  Fake tensors (the
  dry run's, ``kernels/dry.py``) take the card's checks
  and route, launch nothing and note the needed work (``ssd_work``) as a
  dry launch, which ``launches`` does not count.
  ``ssd_scan.launches`` counts launches and ``ssd_scan.wgmma_launches``
  those of them on the tensor-core route; reset both together.
* ``ssd_with_state``: the model-layout wrapper with its gradient, a
  ``torch.autograd.Function`` — the custom VJP of the JAX package's
  ``kernels/ssd_scan/ops.py:41-67``.  The forward forms the dt-weighted
  input and the log-decays, goes head-major and runs ``ssd_scan``; the
  backward recomputes through ``models.ssd.ssd_chunked`` under autograd,
  as the JAX backward does through jnp.  Both outputs take cotangents.
* ``ssd``: the sequence output only.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import build, dry
from repro_torch.kernels.ssd_scan import ref

_DTYPES = (torch.float32, torch.bfloat16)
MAX_STATE = 256
MAX_WGMMA_CHUNK = 256   # S_r (64 x Q float32) must fit a block's smem


@functools.lru_cache(maxsize=None)
def _kernel(name: str):
    fn = getattr(build.load(name), name)
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    n_int = 9 if name == "ssd_scan_wgmma" else 6
    fn.argtypes = [ptr] * 8 + [i32] * n_int + [ptr]
    fn.restype = i32
    return fn


def ssd_route(B_) -> str:
    """The kernel a card call takes: "wgmma" for bf16 B/C, "fma" for
    float32."""
    return "wgmma" if B_.dtype == torch.bfloat16 else "fma"


SCAN_TILE = 64          # rows, keys and P columns of a tile of the bf16 kernel
# The bf16 kernel's two block kinds aim at four blocks for each of the
# H100's 132 SMs (chip_smoke.py --ssd-head-sets times the choice).
SSD_TARGET_BLOCKS = 4 * 132


def ssd_head_sets(BG: int, S: int, Q: int, P: int, G: int):
    """(heads a block of the state kernel takes, heads a block of the scan
    kernel takes) of the bf16 kernel, for BG groups of G heads, sequence
    S, chunk Q and head size P.  The scan kernel's block computes C_r Bᵀ
    once for its heads: fewer, larger sets redo less of it, more sets fill
    the card in more, shorter waves.  A function of the shapes alone."""
    nc = S // Q
    rows = -(-Q // SCAN_TILE)
    cols = -(-P // SCAN_TILE)

    def heads(units):
        sets = -(-G // min(G, max(1, -(-G * units // SSD_TARGET_BLOCKS))))
        return -(-G // sets)          # sets of equal size, but the last

    return heads(BG * nc * cols), heads(BG * nc * rows)


TMA_STATE_SIZES = (16, 32, 64, 128, 256)


def ssd_bc_loads(N: int, ptrs) -> int:
    """How the bf16 kernel brings B's and C's rows (N bf16 values each)
    into shared memory: 0 for TMA, which needs N one of
    ``TMA_STATE_SIZES`` (the kernel's padded state sizes) and
    16-byte-aligned bases; else the width in elements of its plain loads,
    the widest of 8, 4, 2, 1 that divides N and both bases' alignment
    (N = 20: 4, 8-byte loads)."""
    if N in TMA_STATE_SIZES and all(p % 16 == 0 for p in ptrs):
        return 0
    return next(v for v in (8, 4, 2, 1)
                if N % v == 0 and all(p % (2 * v) == 0 for p in ptrs))


def _check(xdt, a, B_, C_, Q, hq_per_group):
    BH, S, P = xdt.shape
    BG, _, N = B_.shape
    for name, t in (("a", a), ("B_", B_), ("C_", C_)):
        if t.device != xdt.device:
            raise ValueError(f"{name} is on {t.device}, xdt on {xdt.device}")
    for name, t in (("xdt", xdt), ("a", a), ("B_", B_), ("C_", C_)):
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if xdt.dtype != torch.float32 or a.dtype != torch.float32:
        raise TypeError("xdt and a must be float32")
    if B_.dtype not in _DTYPES or C_.dtype != B_.dtype:
        raise TypeError(f"B_/C_ are {B_.dtype}/{C_.dtype}: float32 or "
                        "bfloat16, both the same")
    if tuple(a.shape) != (BH, S):
        raise ValueError(f"a {tuple(a.shape)}, expected {(BH, S)}")
    if C_.shape != B_.shape or B_.shape[1] != S \
            or BG * hq_per_group != BH:
        raise ValueError(f"B_/C_ {tuple(B_.shape)} do not fit xdt "
                         f"{tuple(xdt.shape)} with {hq_per_group} heads a "
                         "group")
    if not 0 < N <= MAX_STATE:
        raise ValueError(f"state size {N} not in 1..{MAX_STATE}")
    if S % Q:
        raise ValueError(f"sequence {S} is not a multiple of the chunk {Q}")
    if ssd_route(B_) == "wgmma" and Q > MAX_WGMMA_CHUNK:
        raise ValueError(f"chunk {Q}: the bf16 kernel takes chunks of at "
                         f"most {MAX_WGMMA_CHUNK}")


def ssd_work(BH, S, P, N, BG, Q, itemsize):
    """(bytes, flops) ``ssd_scan`` needs — ``chip_smoke.py``'s bound:
    xdt, a, B and C read once, y and h_final written once; per (group,
    chunk) the Q(Q+1)/2 visible (query, key) pairs of C B^T (N products
    each), per (head, chunk) those pairs of the intra product (P each) and
    the inter-chunk and state products (Q N P each)."""
    nc = S // Q
    tri = nc * Q * (Q + 1) / 2
    n_bytes = (2 * BH * S * P * 4 + BH * S * 4 + 2 * BG * S * N * itemsize
               + BH * N * P * 4)
    return n_bytes, (2.0 * BG * tri * N + 2.0 * BH * tri * P
                     + 2 * 2.0 * BH * nc * Q * N * P)


def ssd_scan(xdt, a, B_, C_, *, chunk=128, hq_per_group=1):
    """xdt: (BH, S, P) float32 dt-weighted inputs; a: (BH, S) float32
    log-decays; B_/C_: (BG, S, N) with BH = BG * hq_per_group, head b
    reading group b // hq_per_group.  Returns (y (BH, S, P) float32,
    h_final (BH, N, P) float32).  The chunk Q = min(chunk, S) must divide
    S (and be at most ``MAX_WGMMA_CHUNK`` for bf16 B/C on the card)."""
    BH, S, P = xdt.shape
    Q = min(chunk, S)
    if xdt.device.type == "cpu":
        return ref.ssd_scan_plain(xdt, a, B_, C_, chunk=Q,
                                  hq_per_group=hq_per_group)
    if xdt.device.type != "cuda" and not dry.is_dry(xdt):
        raise ValueError(f"no ssd_scan kernel for {xdt.device}")
    _check(xdt, a, B_, C_, Q, hq_per_group)
    N = B_.shape[2]
    dev = xdt.device
    y = torch.empty((BH, S, P), dtype=torch.float32, device=dev)
    h = torch.empty((BH, N, P), dtype=torch.float32, device=dev)
    if y.numel() == 0:
        return y, h.zero_()
    route = ssd_route(B_)
    states = torch.empty((BH, S // Q, N, P), dtype=torch.float32, device=dev)
    if route == "wgmma":
        name = "ssd_scan_wgmma"
        # a_cum of every chunk, written by the first of the three kernels
        scratch = torch.empty((BH, S), dtype=torch.float32, device=dev)
        bases = (0, 0) if dry.is_dry(B_) else (B_.data_ptr(), C_.data_ptr())
        tail = (*ssd_head_sets(BH // hq_per_group, S, Q, P, hq_per_group),
                ssd_bc_loads(N, bases))
    else:
        name, tail = "ssd_scan", ()
        scratch = torch.empty((BH, S // Q), dtype=torch.float32, device=dev)
    if dry.is_dry(xdt):
        dry.note("ssd_scan", *ssd_work(BH, S, P, N, BH // hq_per_group, Q,
                                       B_.element_size()))
    else:
        with torch.cuda.device(dev):
            stream = torch.cuda.current_stream(dev).cuda_stream
            err = _kernel(name)(xdt.data_ptr(), a.data_ptr(), B_.data_ptr(),
                                C_.data_ptr(), y.data_ptr(), h.data_ptr(),
                                states.data_ptr(), scratch.data_ptr(), BH, S,
                                P, N, hq_per_group, Q, *tail, stream)
        if err:
            raise RuntimeError(f"{name} launch failed: CUDA error {err}")
        ssd_scan.launches += 1
        ssd_scan.wgmma_launches += route == "wgmma"
    return y, h


ssd_scan.launches = 0
ssd_scan.wgmma_launches = 0


def _head_major(t):
    """(B, S, H, K) -> (B*H, S, K), contiguous."""
    Bb, S, H, K = t.shape
    return t.transpose(1, 2).reshape(Bb * H, S, K).contiguous()


class _SSDWithState(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dt, A, B_, C_, chunk):
        Bb, S, H, P = x.shape
        G, N = B_.shape[2], B_.shape[3]
        dtf = dt.float()
        xdt = _head_major(x.float() * dtf[..., None])
        a = (dtf * A.float()[None, None, :]).transpose(1, 2) \
            .reshape(Bb * H, S).contiguous()
        y, h = ssd_scan(xdt, a, _head_major(B_), _head_major(C_),
                        chunk=chunk, hq_per_group=H // G)
        ctx.save_for_backward(x, dt, A, B_, C_)
        ctx.chunk = chunk
        y = y.reshape(Bb, H, S, P).transpose(1, 2).to(x.dtype)
        # (BH, N, P) -> (B, H, P, N), the model's state layout
        return y, h.reshape(Bb, H, N, P).transpose(2, 3)

    @staticmethod
    def backward(ctx, g_y, g_h):
        from repro_torch.models.ssd import ssd_chunked
        x, dt, A, B_, C_ = ctx.saved_tensors
        with torch.enable_grad():
            leaves = [t.detach().requires_grad_(True)
                      for t in (x, dt, A, B_, C_)]
            xl, dtl, Al, Bl, Cl = leaves
            y, h = ssd_chunked(xl.float(), dtl.float(), Al.float(), Bl, Cl,
                               chunk=min(ctx.chunk, x.shape[1]))
            grads = torch.autograd.grad((y, h), leaves,
                                        (g_y.float(), g_h.float()))
        return (*grads, None)


def ssd_with_state(x, dt, A, B_, C_, chunk=128):
    """x: (B, S, H, P); dt: (B, S, H); A: (H,); B_/C_: (B, S, G, N).
    Returns (y (B, S, H, P) in x's dtype, h_final (B, H, P, N) float32),
    differentiable in x, dt, A, B_ and C_ through both outputs.  The JAX
    wrapper's ``interpret`` flag (a TPU option) has no counterpart."""
    return _SSDWithState.apply(x, dt, A, B_, C_, int(chunk))


def ssd(x, dt, A, B_, C_, chunk=128):
    """Sequence output only."""
    return ssd_with_state(x, dt, A, B_, C_, chunk)[0]
