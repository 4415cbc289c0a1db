"""Wrappers of the port's attention kernels.

* ``ring_chunk_attention``: the serving path's fused prefill attention.
  Two routes by dtype: bf16 goes to the tensor-core kernel
  (``csrc/ring_chunk_attention_wgmma.cu``: TMA and wgmma, the ring split
  across blocks, then a merge of the splits), float32 to the FMA kernel
  (``csrc/ring_chunk_attention.cu``).
* ``flash_attention``: full-sequence GQA attention with its gradient, the
  training path's, through a ``torch.autograd.Function`` whose forward
  calls ``flash_attention_fwd`` and whose backward calls
  ``flash_attention_bwd``.  Two routes by dtype: bf16 goes to the
  tensor-core kernels (``csrc/flash_attention_fwd_wgmma.cu``,
  ``csrc/flash_attention_bwd_wgmma.cu``: TMA and wgmma), float32 to the
  FMA kernels (``csrc/flash_attention_fwd.cu``,
  ``csrc/flash_attention_bwd.cu``).  The float32 kernels' float32 sums
  meet the JAX package's float32 tolerances, which TF32 cannot.

For tensors on the card each wrapper launches its hand-written CUDA kernel
or raises; for tensors on the CPU it computes the plain version of
``ref.py``.  There is no other fallback.  Fake tensors (the dry run's,
``kernels/dry.py``), which hold no data, take the card's checks and
route and launch nothing: the wrapper makes its outputs empty and notes
the kernel's needed work (``ring_work``, ``flash_work``) as one dry launch,
which ``launches`` does not count.  ``ring_chunk_attention.launches``
(one a call: the split kernel and its merge on the bf16 route),
``flash_attention.launches`` (forward kernel) and
``flash_attention_bwd.launches`` (one per backward: delta, dq and dk/dv on
the bf16 route, dq and dk/dv on the float32 one) count launches, and each
wrapper's ``wgmma_launches`` those of them that took the tensor-core route.
"""
from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from repro_torch.kernels import build, dry
from repro_torch.kernels.flash_attention import ref

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_HEAD_DIMS = (16, 32, 64, 128, 256)


@functools.lru_cache(maxsize=None)
def _ring_kernel(name: str):
    fn = getattr(build.load(name), name)
    ptr, i32, i64, f32 = (ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong,
                          ctypes.c_float)
    if name == "ring_chunk_attention":
        fn.argtypes = [ptr] * 8 + [i32] * 7 + [f32, f32, ptr]
    else:
        fn.argtypes = ([ptr] * 10 + [i32] * 6 + [i64] * 15
                       + [i32, f32, f32, i32, i32, ptr])
    fn.restype = i32
    return fn


RING_TILE = 64          # ring slots or chunk keys a tile of the bf16 kernel
RING_ROWS = 64          # query rows a block of the bf16 kernel
# The bf16 kernel splits the ring across blocks.  A split walks at least
# RING_SPLIT_TILES tiles (wide splits keep the float32 partials few) and
# the splits aim at two blocks for each of the H100's 132 SMs.
RING_SPLIT_TILES = 4
RING_TARGET_BLOCKS = 2 * 132


def ring_split(B: int, C: int, W: int, Hq: int, Hkv: int):
    """(tiles a ring split walks, splits) of the bf16 ring kernel: ring
    splits of that many 64-slot tiles and the chunk's own split.  A
    function of the shapes alone — never of ``pos`` or ``n_tokens``, which
    stay on the card (reading them would synchronise every layer)."""
    tiles = -(-W // RING_TILE)
    groups = B * Hkv * -(-(Hq // Hkv) * C // RING_ROWS)
    wanted = max(1, -(-RING_TARGET_BLOCKS // groups) - 1)
    per = min(tiles, max(RING_SPLIT_TILES, -(-tiles // wanted)))
    return per, -(-tiles // per) + 1


def _check(q, k_new, v_new, k_cache, v_cache, pos, n_tokens):
    B, C, Hq, dh = q.shape
    W, Hkv = k_cache.shape[1], k_cache.shape[2]
    tensors = {"q": q, "k_new": k_new, "v_new": v_new, "k_cache": k_cache,
               "v_cache": v_cache, "pos": pos, "n_tokens": n_tokens}
    for name, t in tensors.items():
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, q on {q.device}")
    if q.dtype not in _DTYPES:
        raise TypeError(f"unsupported dtype {q.dtype}: float32 or bfloat16")
    for name in ("k_new", "v_new", "k_cache", "v_cache"):
        if tensors[name].dtype != q.dtype:
            raise TypeError(f"{name} is {tensors[name].dtype}, q {q.dtype}")
    for name in ("pos", "n_tokens"):
        if tensors[name].dtype != torch.int32 or tensors[name].shape != (B,):
            raise TypeError(f"{name} must be int32 of shape ({B},)")
    # the bf16 kernel reads q, k and v through strides (TMA's rule,
    # ``tma_strides``); the float32 kernel reads contiguous tensors
    need = ("pos", "n_tokens") if q.dtype == torch.bfloat16 else tensors
    for name in need:
        if not tensors[name].is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if dh not in _HEAD_DIMS:
        raise ValueError(f"head_dim {dh} not in {_HEAD_DIMS}")
    if Hkv == 0 or Hq % Hkv:
        raise ValueError(f"{Hq} query heads do not group over {Hkv} kv heads")
    if tuple(k_new.shape) != (B, C, Hkv, dh) or v_new.shape != k_new.shape:
        raise ValueError(f"chunk k/v {tuple(k_new.shape)}, expected "
                         f"{(B, C, Hkv, dh)}")
    if tuple(k_cache.shape) != (B, W, Hkv, dh) \
            or v_cache.shape != k_cache.shape:
        raise ValueError(f"ring k/v {tuple(k_cache.shape)}, expected "
                         f"{(B, W, Hkv, dh)}")


def ring_chunk_attention(q, k_new, v_new, k_cache, v_cache, pos, n_tokens, *,
                         window=0, softcap=0.0):
    """Blocked (online-softmax) chunk attention over [pre-write ring,
    chunk keys] — the contract of ``layers.chunk_attention``.

    q/k_new/v_new: (B, C, H*, dh); k_cache/v_cache: (B, W, Hkv, dh) the
    ring before the chunk is written; pos: (B,) int32 absolute position of
    chunk token 0; n_tokens: (B,) int32 in [0, C].  Returns (B, C, Hq, dh)
    in q.dtype; a row with no visible key comes out 0.  On the card bf16
    launches ``csrc/ring_chunk_attention_wgmma.cu`` (q, k and v must meet
    TMA's alignment, see ``tma_strides``; its float32 partials go to a
    workspace allocated here, ``ring_split`` splits), float32
    ``csrc/ring_chunk_attention.cu`` (contiguous tensors)."""
    if q.device.type == "cpu":
        return ref.ring_chunk_attention_ref(q, k_new, v_new, k_cache,
                                            v_cache, pos, n_tokens,
                                            window=window, softcap=softcap)
    if q.device.type != "cuda" and not dry.is_dry(q):
        raise ValueError(f"no ring_chunk_attention kernel for {q.device}")
    _check(q, k_new, v_new, k_cache, v_cache, pos, n_tokens)
    B, C, Hq, dh = q.shape
    W, Hkv = k_cache.shape[1], k_cache.shape[2]
    out = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    if out.numel() == 0:                # no stream or no query: no launch
        return out
    route = "wgmma" if q.dtype == torch.bfloat16 else "fma"
    head = (q, k_new, v_new, k_cache, v_cache, pos, n_tokens)
    if route == "wgmma":
        name = "ring_chunk_attention_wgmma"
        tiles, n_split = ring_split(B, C, W, Hq, Hkv)
        # one float32 workspace: each split's partial rows of o, then their
        # log-sum-exp
        n_rows = B * Hkv * -(-(Hq // Hkv) * C // RING_ROWS) * n_split \
            * RING_ROWS
        part = torch.empty(n_rows * (dh + 1), dtype=torch.float32,
                           device=q.device)
        ptrs = head + (part, part[n_rows * dh:], out)
        strides = ring_tma_strides(*head[:5])
        tail = (int(window), float(softcap), float(dh ** -0.5), tiles,
                n_split)
    else:
        name, ptrs, strides = "ring_chunk_attention", head + (out,), ()
        tail = (int(window), float(softcap), float(dh ** -0.5))
    if dry.is_dry(q):
        dry.note("ring_chunk_attention", *ring_work(
            B, C, W, Hq, Hkv, dh, window, q.element_size()))
    else:
        with torch.cuda.device(q.device):
            stream = torch.cuda.current_stream(q.device).cuda_stream
            err = _ring_kernel(name)(*(t.data_ptr() for t in ptrs), B, C, W,
                                     Hq, Hkv, dh, *strides, *tail, stream)
        if err:
            raise RuntimeError(f"{name} launch failed: CUDA error {err}")
        ring_chunk_attention.launches += 1
        ring_chunk_attention.wgmma_launches += route == "wgmma"
    return out


ring_chunk_attention.launches = 0
ring_chunk_attention.wgmma_launches = 0


# ---------------------------------------------------------------------------
# Full-sequence flash attention
# ---------------------------------------------------------------------------

# C entry point -> (pointers, strided tensors, takes a dtype argument)
_FLASH_ARGS = {"flash_attention_fwd": (5, 3, True),
               "flash_attention_bwd": (9, 4, True),
               "flash_attention_fwd_wgmma": (5, 3, False),
               "flash_attention_bwd_wgmma": (10, 5, False)}


@functools.lru_cache(maxsize=None)
def _flash_kernel(name: str):
    fn = getattr(build.load(name), name)
    ptr, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    n_ptr, n_strided, dtype_arg = _FLASH_ARGS[name]
    fn.argtypes = ([ptr] * n_ptr + [i32] * 6 + [i64] * (3 * n_strided)
                   + [i32, i32, ctypes.c_float] + [i32] * dtype_arg + [ptr])
    fn.restype = i32
    return fn


def tma_strides(name, shape, strides, data_ptr, itemsize=2):
    """The element strides (batch, sequence, head) under which the
    tensor-core kernels' TMA maps read a (B, S, H, dh) tensor with a unit
    dh stride.  TMA needs a 16-byte-aligned base and every byte stride a
    positive multiple of 16; a dimension of size 1 is never stepped, so its
    stride is replaced by the contiguous one.  Raises ValueError, naming the
    tensor, where the layout breaks that rule (no silent copy)."""
    B, S, H, dh = shape
    sb, ss, sh, sd = strides
    if sd != 1 and dh > 1:
        raise ValueError(f"{name} must have a unit head_dim stride")
    if data_ptr % 16:
        raise ValueError(f"{name}: the bf16 attention kernels load by TMA, "
                         f"which needs a 16-byte-aligned base; {name}'s data "
                         f"pointer is {data_ptr % 16} bytes past one")
    out = []
    inner = dh
    for dim, size, stride in (("head", H, sh), ("sequence", S, ss),
                              ("batch", B, sb)):
        if size == 1:
            stride = inner
        elif stride <= 0 or (stride * itemsize) % 16:
            raise ValueError(
                f"{name}: the bf16 attention kernels load by TMA, which "
                "needs every stride a positive multiple of 16 bytes; "
                f"{name}'s {dim} stride is {stride} elements "
                f"({stride * itemsize} bytes)")
        out.append(stride)
        inner = stride * size
    sh, ss, sb = out
    return sb, ss, sh


def _tma(name, t):
    # a fake tensor has no address: its strides are checked, its base not
    return tma_strides(name, tuple(t.shape), t.stride(),
                       0 if dry.is_dry(t) else t.data_ptr(), t.element_size())


def ring_tma_strides(q, k_new, v_new, k_cache, v_cache):
    """The (batch, sequence, head) element strides of the bf16 ring
    kernel's five inputs, in that order: TMA loads the K/V tiles, and q's
    16-byte loads follow the same rule.  Raises ValueError naming the first
    tensor whose layout breaks it (``tma_strides``)."""
    names = ("q", "k_new", "v_new", "k_cache", "v_cache")
    return sum((_tma(n, t) for n, t in zip(
        names, (q, k_new, v_new, k_cache, v_cache))), ())


def _check_flash(q, k, v, extra=()):
    """Shapes, types and layouts the flash kernels take: q (B, Sq, Hq, dh)
    and k, v (B, Skv, Hkv, dh) of one dtype, unit dh stride (any other
    strides), GQA grouping, a head size the kernels are built for."""
    B, Sq, Hq, dh = q.shape
    if k.dim() != 4 or k.shape[0] != B or k.shape[3] != dh \
            or v.shape != k.shape:
        raise ValueError(f"k {tuple(k.shape)} / v {tuple(v.shape)} do not "
                         f"match q {tuple(q.shape)}")
    Hkv = k.shape[2]
    if Hkv == 0 or Hq % Hkv:
        raise ValueError(f"{Hq} query heads do not group over {Hkv} kv heads")
    if dh not in _HEAD_DIMS:
        raise ValueError(f"head_dim {dh} not in {_HEAD_DIMS}")
    if q.dtype not in _DTYPES:
        raise TypeError(f"unsupported dtype {q.dtype}: float32 or bfloat16")
    for name, t in (("k", k), ("v", v)) + tuple(extra):
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, q on {q.device}")
    for name, t in (("q", q), ("k", k), ("v", v)) + tuple(extra):
        if t.dtype != q.dtype:
            raise TypeError(f"{name} is {t.dtype}, q {q.dtype}")
        if t.stride(3) != 1:
            raise ValueError(f"{name} must have a unit head_dim stride")


def _strides(t):
    return t.stride(0), t.stride(1), t.stride(2)


def _flash_device(q, name):
    if q.device.type != "cuda" and not dry.is_dry(q):
        raise ValueError(f"no {name} kernel for {q.device}")


def flash_attention_fwd(q, k, v, *, causal=True, window=0):
    """Forward of ``flash_attention``: (out (B, Sq, Hq, dh) in q.dtype,
    lse (B, Hq, Sq) float32).  For tensors on the card launches
    ``csrc/flash_attention_fwd_wgmma.cu`` (bf16; q, k and v must meet
    TMA's alignment, see ``tma_strides``) or ``csrc/flash_attention_fwd.cu``
    (float32), counted in ``flash_attention.launches`` (and, bf16, in
    ``.wgmma_launches``); for tensors on the CPU the plain
    ``ref.flash_attention_fwd_ref``."""
    if q.device.type == "cpu":
        return ref.flash_attention_fwd_ref(q, k, v, causal=causal,
                                           window=window)
    _flash_device(q, "flash_attention_fwd")
    _check_flash(q, k, v)
    B, Sq, Hq, dh = q.shape
    Skv, Hkv = k.shape[1], k.shape[2]
    out = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    lse = torch.empty((B, Hq, Sq), dtype=torch.float32, device=q.device)
    if out.numel() == 0:
        return out, lse
    route = "wgmma" if q.dtype == torch.bfloat16 else "fma"
    if route == "wgmma":
        name, extra = "flash_attention_fwd_wgmma", ()
        strides = _tma("q", q) + _tma("k", k) + _tma("v", v)
    else:
        name, extra = "flash_attention_fwd", (_DTYPES[q.dtype],)
        strides = _strides(q) + _strides(k) + _strides(v)
    if dry.is_dry(q):
        dry.note("flash_attention_fwd", *flash_work(
            B, Sq, Skv, Hq, Hkv, dh, causal, window, q.element_size())["fwd"])
    else:
        with torch.cuda.device(q.device):
            stream = torch.cuda.current_stream(q.device).cuda_stream
            err = _flash_kernel(name)(
                q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                lse.data_ptr(), B, Sq, Skv, Hq, Hkv, dh, *strides,
                int(bool(causal)), int(window), float(dh ** -0.5), *extra,
                stream)
        if err:
            raise RuntimeError(f"{name} launch failed: CUDA error {err}")
        flash_attention.launches += 1
        flash_attention.wgmma_launches += route == "wgmma"
    return out, lse


def flash_attention_bwd(q, k, v, out, lse, do, *, causal=True, window=0):
    """Gradients (dq, dk, dv) of ``flash_attention`` for the upstream
    gradient ``do``, from the forward's ``out`` and ``lse``.  For tensors
    on the card, bf16 launches ``csrc/flash_attention_bwd_wgmma.cu`` (a
    pre-pass kernel for ``delta = rowsum(out * do)``, then the dq and dk/dv
    kernels; q, k, v and do must meet TMA's alignment, see
    ``tma_strides``); float32 computes delta with torch ops, as the JAX
    package computes it outside its kernels, and launches the dq and dk/dv
    kernels of ``csrc/flash_attention_bwd.cu``.  One count in
    ``flash_attention_bwd.launches`` a call (and, bf16, in
    ``.wgmma_launches``).  Tensors on the CPU take the plain
    ``ref.flash_attention_bwd_ref``."""
    if q.device.type == "cpu":
        return ref.flash_attention_bwd_ref(q, k, v, out, lse, do,
                                           causal=causal, window=window)
    _flash_device(q, "flash_attention_bwd")
    _check_flash(q, k, v, extra=(("do", do),))
    B, Sq, Hq, dh = q.shape
    Skv, Hkv = k.shape[1], k.shape[2]
    if do.shape != q.shape or out.shape != q.shape:
        raise ValueError(f"do {tuple(do.shape)} / out {tuple(out.shape)} do "
                         f"not match q {tuple(q.shape)}")
    if lse.shape != (B, Hq, Sq) or lse.dtype != torch.float32:
        raise ValueError(f"lse must be float32 of shape {(B, Hq, Sq)}")
    lse = lse.contiguous()
    dq = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    dk = torch.empty(k.shape, dtype=k.dtype, device=k.device)
    dv = torch.empty(v.shape, dtype=v.dtype, device=v.device)
    if dq.numel() == 0 or dk.numel() == 0:
        return dq.zero_(), dk.zero_(), dv.zero_()
    route = "wgmma" if q.dtype == torch.bfloat16 else "fma"
    if route == "wgmma":
        # the kernel's own pre-pass writes delta = rowsum(out * do)
        if out.dtype != q.dtype or out.stride(3) != 1:
            raise ValueError("out must be bf16 with a unit head_dim stride")
        name = "flash_attention_bwd_wgmma"
        delta = torch.empty((B, Hq, Sq), dtype=torch.float32,
                            device=q.device)
        ptrs = (q, k, v, out, do, lse, delta, dq, dk, dv)
        args = (_tma("q", q) + _tma("k", k) + _tma("v", v) + _tma("do", do)
                + _strides(out))
        extra = ()
    else:
        name = "flash_attention_bwd"
        delta = (out.float() * do.float()).sum(-1).transpose(1, 2) \
            .contiguous()
        ptrs = (q, k, v, do, lse, delta, dq, dk, dv)
        args = _strides(q) + _strides(k) + _strides(v) + _strides(do)
        extra = (_DTYPES[q.dtype],)
    if dry.is_dry(q):
        dry.note("flash_attention_bwd", *flash_work(
            B, Sq, Skv, Hq, Hkv, dh, causal, window, q.element_size())["bwd"])
    else:
        with torch.cuda.device(q.device):
            stream = torch.cuda.current_stream(q.device).cuda_stream
            err = _flash_kernel(name)(
                *(t.data_ptr() for t in ptrs), B, Sq, Skv, Hq, Hkv, dh,
                *args, int(bool(causal)), int(window), float(dh ** -0.5),
                *extra, stream)
        if err:
            raise RuntimeError(f"{name} launch failed: CUDA error {err}")
        flash_attention_bwd.launches += 1
        flash_attention_bwd.wgmma_launches += route == "wgmma"
    return dq, dk, dv


flash_attention_bwd.launches = 0
flash_attention_bwd.wgmma_launches = 0


def flash_pairs(Sq: int, Skv: int, causal: bool, window: int) -> int:
    """Visible (query, key) pairs of ``ref.attention_mask`` for one head
    of one sequence."""
    t = np.arange(Sq, dtype=np.int64)
    hi = np.minimum(t, Skv - 1) if causal else np.full_like(t, Skv - 1)
    lo = np.maximum(t - window + 1, 0) if window else np.zeros_like(t)
    return int(np.clip(hi - lo + 1, 0, None).sum())


def flash_work(B, Sq, Skv, Hq, Hkv, dh, causal, window, itemsize):
    """{"fwd", "bwd": (bytes, flops)} that the flash kernels need: every
    input read once and every output written once; 4 * dh flops per
    visible (query, key) pair forward and five products of 2 * dh backward
    (s recomputed, dp, dv, dq, dk) — ``chip_smoke.py``'s bounds."""
    pairs = float(flash_pairs(Sq, Skv, causal, window)) * B * Hq
    q_bytes = B * Sq * Hq * dh * itemsize
    kv_bytes = 2 * B * Skv * Hkv * dh * itemsize
    lse_bytes = B * Hq * Sq * 4
    return {"fwd": (2 * q_bytes + kv_bytes + lse_bytes, 4.0 * dh * pairs),
            "bwd": (4 * q_bytes + 2 * kv_bytes + lse_bytes,
                    10.0 * dh * pairs)}


def ring_work(B, C, W, Hq, Hkv, dh, window, itemsize):
    """(bytes, flops) the ring kernel can need at these shapes — every
    chunk token active and the ring full, the most ``chip_smoke.py``'s
    data-dependent count gives: q read and the output written, the ring's
    and the chunk's keys and values read once, ``pos`` and ``n_tokens``;
    4 * dh flops per visible pair, at most min(W, window) keys a row (the
    ring's band)."""
    keys = min(W, window) if window else W
    n_bytes = (2 * B * C * Hq * dh * itemsize
               + 2 * B * (W + C) * Hkv * dh * itemsize + 8 * B)
    return n_bytes, 4.0 * dh * Hq * B * C * keys


class _FlashAttention(torch.autograd.Function):
    """The custom VJP of the JAX package's ``flash_attention``
    (``ops.py:46-86``): the forward saves q, k, v, out and lse; the
    backward hands them to ``flash_attention_bwd``."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window):
        out, lse = flash_attention_fwd(q, k, v, causal=causal, window=window)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.causal, ctx.window = causal, window
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd(q, k, v, out, lse, do.contiguous(),
                                         causal=ctx.causal,
                                         window=ctx.window)
        return dq, dk, dv, None, None


def flash_attention(q, k, v, causal=True, window=0):
    """GQA flash attention in the model layout, differentiable.

    q: (B, S, Hq, dh); k/v: (B, S, Hkv, dh) -> (B, S, Hq, dh) in q.dtype,
    query head h reading kv head ``h // (Hq // Hkv)``; causal and/or a
    sliding window of ``window`` keys (0 = none).  The CUDA kernels take
    the model layout through strides (no head-major copy) and any S; the
    JAX wrapper's block sizes are TPU tile sizes and have no counterpart."""
    return _FlashAttention.apply(q, k, v, bool(causal), int(window))


flash_attention.launches = 0
flash_attention.wgmma_launches = 0
