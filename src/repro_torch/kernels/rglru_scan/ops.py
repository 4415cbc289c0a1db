"""Wrappers of the RG-LRU scan kernel (``csrc/lru_scan.cu``).

* ``lru_scan``: the kernel's contract, ``h_t = a_t h_{t-1} + b_t`` over
  axis 1 of (B, S, W) float32 inputs, with an optional carried state and a
  reverse flag (the JAX package's ``kernels/rglru_scan/kernel.py:57`` plus
  the ``h0`` of its oracle).  For tensors on the card it launches the CUDA
  kernel or raises; for tensors on the CPU it computes the plain version
  of ``ref.py``.  There is no other fallback.  ``lru_scan.launches``
  counts launches, one per call of ``lru_scan`` or ``_lru_vjp``.
* ``lru``: the sequence output with its gradient, a
  ``torch.autograd.Function`` — the custom VJP of the JAX package's
  ``kernels/rglru_scan/ops.py:19-43``: with h_t = a_t h_{t-1} + b_t,
  ``db_t = g_t + a_{t+1} db_{t+1}`` and ``da_t = db_t h_{t-1}``, both from
  one reverse call of the kernel (``_lru_vjp``).

What bounds the kernel is bytes: 12 an element forward (a and b read once,
h written once), 20 in the VJP (a, g and h read; db and da written).  It
makes one pass: a block per (batch, tile of ``Wt`` channels, chunk of
``T`` steps) holds its tile in shared memory, publishes the chunk's
aggregate (prod a, end state from zero), folds the carry into its chunk
from its predecessors' published values and re-runs the chunk from it.
The carry is always the fold from ``h0`` in chunk order, one fma a chunk,
whichever published values a block finds, so reruns give the same bits
(the source note of ``csrc/lru_scan.cu``; ``ref.lru_scan_single_pass_ref``
is its arithmetic in plain PyTorch).  The tile (``LRU_TILE``), the
workspace (``lru_workspace``) and the order in which blocks take their
work (an atomic ticket, chunk-major in scan order) are functions of the
shapes alone, so the call needs no host synchronisation and a CUDA graph
can hold it.  A sequence of one chunk (S <= T, the serving chunk step)
takes a direct kernel with no workspace: a thread walks one channel from
``h0`` with its loads unrolled ahead.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import build
from repro_torch.kernels.rglru_scan import ref

# (T steps a chunk, Wt channels a tile): one of LRU_TILE_SWEEP, the tiles
# ``chip_smoke.py --lru-tiles`` times at the training shape (PERF.md).  A
# sequence of at most T steps is one chunk: the kernel's direct path, which
# takes no tile.
LRU_TILE_SWEEP = ((16, 256), (16, 512), (32, 128), (32, 256), (32, 512),
                  (64, 64), (64, 128), (64, 256), (128, 64), (128, 128))
LRU_TILE = (64, 128)
SMEM_BYTES = 232448         # a block's shared memory on sm_90
MAX_WT = 512                # 128 threads of four channels


@functools.lru_cache(maxsize=None)
def _kernel():
    fn = build.load("lru_scan").lru_scan
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = [ptr] * 8 + [ctypes.c_longlong] + [i32] * 7 + [ptr]
    fn.restype = i32
    return fn


def tile_fits(T: int, Wt: int, S: int, vjp: bool) -> bool:
    """Whether the kernel takes (T, Wt): Wt a multiple of 4 up to 512, and
    the tiles (a and b, and the forward's h in the VJP) in shared memory."""
    return (T > 0 and 0 < Wt <= MAX_WT and Wt % 4 == 0
            and (3 if vjp else 2) * min(T, S) * Wt * 4 <= SMEM_BYTES)


def lru_workspace(B: int, S: int, W: int, T: int, Wt: int) -> int:
    """4-byte words of the kernel's workspace: none with one chunk; else
    P, E and the carry out (B, nc, Wp) float32 (Wp = the channels rounded
    up to whole tiles), a flag per (batch, tile, chunk) and the ticket."""
    nc, ntiles = -(-S // T), -(-W // Wt)
    if nc <= 1:
        return 0
    return 3 * B * nc * ntiles * Wt + B * ntiles * nc + 1


def lru_vec_loads(W: int, ptrs) -> bool:
    """16-byte copies: W a multiple of 4 and every base 16-byte aligned
    (None, an absent tensor, counts as aligned); 4-byte copies else."""
    return W % 4 == 0 and all(p is None or p % 16 == 0 for p in ptrs)


def _check(pairs, shape, what):
    if len(shape) != 3:
        raise ValueError(f"{what}: expected (B, S, W) tensors, got "
                         f"{tuple(shape)}")
    device = pairs[0][1].device
    for name, t, want in pairs:
        if t.device != device:
            raise ValueError(f"{name} is on {t.device}, {pairs[0][0]} on "
                             f"{device}")
        if t.dtype != torch.float32:
            raise TypeError(f"{name} is {t.dtype}: the kernel takes float32")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if tuple(t.shape) != tuple(want):
            raise ValueError(f"{name} {tuple(t.shape)}, expected "
                             f"{tuple(want)}")


def _ptr(t):
    return None if t is None else t.data_ptr()


def _launch(a, b, h0, hin, h, da, h_final, reverse):
    B, S, W = a.shape
    T, Wt = LRU_TILE
    if not tile_fits(T, Wt, S, hin is not None):
        raise ValueError(f"lru_scan: tile (T {T}, Wt {Wt}) does not fit")
    words = lru_workspace(B, S, W, T, Wt)
    ws = (torch.empty((words,), dtype=torch.int32, device=a.device)
          if words else None)
    ptrs = (a.data_ptr(), b.data_ptr(), _ptr(h0), _ptr(hin), h.data_ptr(),
            _ptr(da), _ptr(h_final))
    dev = a.device.index
    args = ptrs + (_ptr(ws), words, B, S, W, T, Wt, int(bool(reverse)),
                   int(lru_vec_loads(W, ptrs)),
                   torch.cuda.current_stream(dev).cuda_stream)
    if dev == torch.cuda.current_device():
        err = _kernel()(*args)
    else:
        with torch.cuda.device(dev):
            err = _kernel()(*args)
    if err:
        raise RuntimeError(f"lru_scan launch failed: CUDA error {err}")
    lru_scan.launches += 1


def lru_scan(a, b, h0=None, reverse=False):
    """a, b: (B, S, W) float32; h0: (B, W) float32 or None (zeros).
    Returns (h (B, S, W), h_final (B, W)), float32.  ``reverse`` scans
    from the end: h_t = a_t h_{t+1} + b_t with h_S = h0, h_final = h_0."""
    if a.device.type == "cpu":
        return ref.lru_scan_plain(a, b, h0, reverse=reverse)
    if a.device.type != "cuda":
        raise ValueError(f"no lru_scan kernel for {a.device}")
    _check([("a", a, a.shape), ("b", b, a.shape)]
           + ([("h0", h0, (a.shape[0], a.shape[2]))] if h0 is not None
              else []), a.shape, "a / b")
    B, S, W = a.shape
    h = torch.empty_like(a)
    h_final = a.new_empty((B, W))
    if B == 0 or W == 0:
        return h, h_final
    if S == 0:
        return h, (h_final.zero_() if h0 is None else h_final.copy_(h0))
    _launch(a, b, h0, None, h, None, h_final, reverse)
    return h, h_final


lru_scan.launches = 0


def _lru_vjp(a, g, h):
    """(da, db) of h = lru(a, b) for the cotangent g, in one reverse call
    of the kernel: step t takes a_{t+1} (0 past the last step), and the
    re-run writes da_t = db_t h_{t-1} (h_{-1} = 0) beside db.  a, g, h:
    (B, S, W) float32.  On the CPU: ``ref.lru_vjp_plain``."""
    if a.device.type == "cpu":
        return ref.lru_vjp_plain(a, g, h)
    if a.device.type != "cuda":
        raise ValueError(f"no lru_scan kernel for {a.device}")
    _check([("a", a, a.shape), ("g", g, a.shape), ("h", h, a.shape)],
           a.shape, "a / g / h")
    db, da = torch.empty_like(a), torch.empty_like(a)
    if a.numel():
        _launch(a, g, None, h, db, da, None, reverse=True)
    return da, db


class _LRU(torch.autograd.Function):
    @staticmethod
    def forward(ctx, a, b):
        h, _ = lru_scan(a.contiguous(), b.contiguous())
        ctx.save_for_backward(a, h)
        return h

    @staticmethod
    def backward(ctx, g):
        a, h = ctx.saved_tensors
        da, db = _lru_vjp(a.contiguous(), g.float().contiguous(), h)
        return da.to(a.dtype), db.to(a.dtype)


def lru(a, b):
    """h_t = a_t h_{t-1} + b_t over axis 1 of (B, S, W) float32 a and b,
    from a zero state; differentiable in a and b.  The JAX wrapper's block
    sizes and ``interpret`` flag (TPU options) have no counterpart."""
    return _LRU.apply(a, b)
