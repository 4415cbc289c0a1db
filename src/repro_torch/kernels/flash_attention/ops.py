"""Wrapper of the ring-chunk attention kernel (the serving path's fused
prefill attention).

For tensors on the card ``ring_chunk_attention`` launches the hand-written
CUDA kernel (``csrc/ring_chunk_attention.cu``) or raises; for tensors on
the CPU it computes the plain version of ``ref.py``.  There is no other
fallback.  ``ring_chunk_attention.launches`` counts kernel launches.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import build
from repro_torch.kernels.flash_attention import ref

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_HEAD_DIMS = (16, 32, 64, 128)


@functools.lru_cache(maxsize=None)
def _kernel():
    fn = build.load("ring_chunk_attention").ring_chunk_attention
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = [ptr] * 8 + [i32] * 7 + [ctypes.c_float, ctypes.c_float,
                                           i32, ptr]
    fn.restype = i32
    return fn


def _check(q, k_new, v_new, k_cache, v_cache, pos, n_tokens):
    B, C, Hq, dh = q.shape
    W, Hkv = k_cache.shape[1], k_cache.shape[2]
    tensors = {"q": q, "k_new": k_new, "v_new": v_new, "k_cache": k_cache,
               "v_cache": v_cache, "pos": pos, "n_tokens": n_tokens}
    for name, t in tensors.items():
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, q on {q.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if q.dtype not in _DTYPES:
        raise TypeError(f"unsupported dtype {q.dtype}: float32 or bfloat16")
    for name in ("k_new", "v_new", "k_cache", "v_cache"):
        if tensors[name].dtype != q.dtype:
            raise TypeError(f"{name} is {tensors[name].dtype}, q {q.dtype}")
    for name in ("pos", "n_tokens"):
        if tensors[name].dtype != torch.int32 or tensors[name].shape != (B,):
            raise TypeError(f"{name} must be int32 of shape ({B},)")
    if dh not in _HEAD_DIMS:
        raise ValueError(f"head_dim {dh} not in {_HEAD_DIMS}")
    if Hkv == 0 or Hq % Hkv:
        raise ValueError(f"{Hq} query heads do not group over {Hkv} kv heads")
    if tuple(k_new.shape) != (B, C, Hkv, dh) or v_new.shape != k_new.shape:
        raise ValueError(f"chunk k/v {tuple(k_new.shape)}, expected "
                         f"{(B, C, Hkv, dh)}")
    if tuple(k_cache.shape) != (B, W, Hkv, dh) or v_cache.shape != k_cache.shape:
        raise ValueError(f"ring k/v {tuple(k_cache.shape)}, expected "
                         f"{(B, W, Hkv, dh)}")


def ring_chunk_attention(q, k_new, v_new, k_cache, v_cache, pos, n_tokens, *,
                         window=0, softcap=0.0):
    """Blocked (online-softmax) chunk attention over [pre-write ring,
    chunk keys] — the contract of ``layers.chunk_attention``.

    q/k_new/v_new: (B, C, H*, dh); k_cache/v_cache: (B, W, Hkv, dh) the
    ring before the chunk is written; pos: (B,) int32 absolute position of
    chunk token 0; n_tokens: (B,) int32 in [0, C].  Returns (B, C, Hq, dh)
    in q.dtype; a row with no visible key comes out 0."""
    if q.device.type == "cpu":
        return ref.ring_chunk_attention_ref(q, k_new, v_new, k_cache,
                                            v_cache, pos, n_tokens,
                                            window=window, softcap=softcap)
    if q.device.type != "cuda":
        raise ValueError(f"no ring_chunk_attention kernel for {q.device}")
    _check(q, k_new, v_new, k_cache, v_cache, pos, n_tokens)
    B, C, Hq, dh = q.shape
    W, Hkv = k_cache.shape[1], k_cache.shape[2]
    out = torch.empty_like(q)
    if out.numel() == 0:                # no stream or no query: no launch
        return out
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = _kernel()(q.data_ptr(), k_new.data_ptr(), v_new.data_ptr(),
                        k_cache.data_ptr(), v_cache.data_ptr(),
                        pos.data_ptr(), n_tokens.data_ptr(), out.data_ptr(),
                        B, C, W, Hq, Hkv, dh, int(window), float(softcap),
                        float(dh ** -0.5), _DTYPES[q.dtype], stream)
    if err:
        raise RuntimeError(f"ring_chunk_attention launch failed: CUDA error "
                           f"{err}")
    ring_chunk_attention.launches += 1
    return out


ring_chunk_attention.launches = 0
