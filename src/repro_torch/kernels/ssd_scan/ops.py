"""Wrappers of the SSD chunked-scan kernel (``csrc/ssd_scan.cu``).

* ``ssd_scan``: the kernel's contract in its head-major layout (the JAX
  package's ``kernels/ssd_scan/kernel.py:72``).  For tensors on the card
  it launches the CUDA kernel or raises; for tensors on the CPU it
  computes the plain version of ``ref.py``.  There is no other fallback.
  ``ssd_scan.launches`` counts launches.
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

from repro_torch.kernels import build
from repro_torch.kernels.ssd_scan import ref

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
MAX_STATE = 256


@functools.lru_cache(maxsize=None)
def _kernel():
    fn = build.load("ssd_scan").ssd_scan
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = [ptr] * 8 + [i32] * 7 + [ptr]
    fn.restype = i32
    return fn


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


def ssd_scan(xdt, a, B_, C_, *, chunk=128, hq_per_group=1):
    """xdt: (BH, S, P) float32 dt-weighted inputs; a: (BH, S) float32
    log-decays; B_/C_: (BG, S, N) with BH = BG * hq_per_group, head b
    reading group b // hq_per_group.  Returns (y (BH, S, P) float32,
    h_final (BH, N, P) float32).  The chunk Q = min(chunk, S) must divide
    S."""
    BH, S, P = xdt.shape
    Q = min(chunk, S)
    if xdt.device.type == "cpu":
        return ref.ssd_scan_plain(xdt, a, B_, C_, chunk=Q,
                                  hq_per_group=hq_per_group)
    if xdt.device.type != "cuda":
        raise ValueError(f"no ssd_scan kernel for {xdt.device}")
    _check(xdt, a, B_, C_, Q, hq_per_group)
    N = B_.shape[2]
    dev = xdt.device
    y = torch.empty((BH, S, P), dtype=torch.float32, device=dev)
    h = torch.empty((BH, N, P), dtype=torch.float32, device=dev)
    if y.numel() == 0:
        return y, h.zero_()
    states = torch.empty((BH, S // Q, N, P), dtype=torch.float32, device=dev)
    atot = torch.empty((BH, S // Q), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = _kernel()(xdt.data_ptr(), a.data_ptr(), B_.data_ptr(),
                        C_.data_ptr(), y.data_ptr(), h.data_ptr(),
                        states.data_ptr(), atot.data_ptr(), BH, S, P, N,
                        hq_per_group, Q, _DTYPES[B_.dtype], stream)
    if err:
        raise RuntimeError(f"ssd_scan launch failed: CUDA error {err}")
    ssd_scan.launches += 1
    return y, h


ssd_scan.launches = 0


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
