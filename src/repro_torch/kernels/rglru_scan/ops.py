"""Wrappers of the RG-LRU scan kernel (``csrc/lru_scan.cu``).

* ``lru_scan``: the kernel's contract, ``h_t = a_t h_{t-1} + b_t`` over
  axis 1 of (B, S, W) float32 inputs, with an optional carried state and a
  reverse flag (the JAX package's ``kernels/rglru_scan/kernel.py:57`` plus
  the ``h0`` of its oracle).  For tensors on the card it launches the CUDA
  kernel or raises; for tensors on the CPU it computes the plain version
  of ``ref.py``.  There is no other fallback.  ``lru_scan.launches``
  counts launches (one per call: the kernel's one to three launches
  together).
* ``lru``: the sequence output with its gradient, a
  ``torch.autograd.Function`` — the custom VJP of the JAX package's
  ``kernels/rglru_scan/ops.py:19-43``: with h_t = a_t h_{t-1} + b_t,
  ``db_t = g_t + a_{t+1} db_{t+1}`` is the reverse scan of (a shifted one
  step, g) on the same kernel, and ``da_t = db_t h_{t-1}``.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import build
from repro_torch.kernels.rglru_scan import ref

CHUNK = 64          # steps per chunk of the kernel (csrc/lru_scan.cu: T)


@functools.lru_cache(maxsize=None)
def _kernel():
    fn = build.load("lru_scan").lru_scan
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = [ptr] * 6 + [i32] * 4 + [ptr]
    fn.restype = i32
    return fn


def _check(a, b, h0):
    if a.dim() != 3 or b.shape != a.shape:
        raise ValueError(f"a {tuple(a.shape)} / b {tuple(b.shape)}: expected "
                         "two (B, S, W) tensors of one shape")
    tensors = [("a", a), ("b", b)] + ([("h0", h0)] if h0 is not None else [])
    for name, t in tensors:
        if t.device != a.device:
            raise ValueError(f"{name} is on {t.device}, a on {a.device}")
        if t.dtype != torch.float32:
            raise TypeError(f"{name} is {t.dtype}: the kernel takes float32")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if h0 is not None and tuple(h0.shape) != (a.shape[0], a.shape[2]):
        raise ValueError(f"h0 {tuple(h0.shape)}, expected "
                         f"{(a.shape[0], a.shape[2])}")


def lru_scan(a, b, h0=None, reverse=False):
    """a, b: (B, S, W) float32; h0: (B, W) float32 or None (zeros).
    Returns (h (B, S, W), h_final (B, W)), float32.  ``reverse`` scans
    from the end: h_t = a_t h_{t+1} + b_t with h_S = h0, h_final = h_0."""
    if a.device.type == "cpu":
        return ref.lru_scan_plain(a, b, h0, reverse=reverse)
    if a.device.type != "cuda":
        raise ValueError(f"no lru_scan kernel for {a.device}")
    _check(a, b, h0)
    B, S, W = a.shape
    h = torch.empty((B, S, W), dtype=torch.float32, device=a.device)
    h_final = torch.empty((B, W), dtype=torch.float32, device=a.device)
    if B == 0 or W == 0:
        return h, h_final
    if S == 0:
        return h, (h_final.zero_() if h0 is None else h_final.copy_(h0))
    nc = -(-S // CHUNK)
    scratch = torch.empty((3 * B * nc * W if nc > 1 else 0,),
                          dtype=torch.float32, device=a.device)
    with torch.cuda.device(a.device):
        stream = torch.cuda.current_stream(a.device).cuda_stream
        err = _kernel()(a.data_ptr(), b.data_ptr(),
                        None if h0 is None else h0.data_ptr(), h.data_ptr(),
                        h_final.data_ptr(), scratch.data_ptr(), B, S, W,
                        int(bool(reverse)), stream)
    if err:
        raise RuntimeError(f"lru_scan launch failed: CUDA error {err}")
    lru_scan.launches += 1
    return h, h_final


lru_scan.launches = 0


class _LRU(torch.autograd.Function):
    @staticmethod
    def forward(ctx, a, b):
        h, _ = lru_scan(a.contiguous(), b.contiguous())
        ctx.save_for_backward(a, h)
        return h

    @staticmethod
    def backward(ctx, g):
        a, h = ctx.saved_tensors
        # a_{t+1}, with nothing after the last step
        a_next = torch.zeros_like(a, dtype=torch.float32)
        a_next[:, :-1] = a[:, 1:]
        db, _ = lru_scan(a_next, g.float().contiguous(), reverse=True)
        da = torch.empty_like(db)
        da[:, 0] = 0.0                              # h_{-1} = 0
        torch.mul(db[:, 1:], h[:, :-1], out=da[:, 1:])
        return da.to(a.dtype), db.to(a.dtype)


def lru(a, b):
    """h_t = a_t h_{t-1} + b_t over axis 1 of (B, S, W) float32 a and b,
    from a zero state; differentiable in a and b.  The JAX wrapper's block
    sizes and ``interpret`` flag (TPU options) have no counterpart."""
    return _LRU.apply(a, b)
