"""The port's flash attention on the CPU (its plain forward and backward,
through the same ``torch.autograd.Function`` the CUDA kernels sit behind)
against the JAX package: the Pallas kernels in interpret mode with blocks
of 64 (as ``tests/test_kernels.py`` runs them), ``layers.blocked_attention``
and ``ref.attention_ref``, on the ``FA_SWEEP`` geometries and on head dim
256 over one kv head; and ragged sequence lengths against a dense masked
softmax written here in torch.

Inputs are made from a seed with numpy and handed to both packages.
Tolerances are the JAX kernel tests': forward 2e-5 in float32 and 2e-2 in
bfloat16, gradients 2e-4."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention.ops import flash_attention as jax_flash
from repro.kernels.flash_attention.ref import attention_ref, gqa_flatten
from repro.models.layers import blocked_attention
from repro_torch.kernels.flash_attention import ops, ref

FA_SWEEP = [
    # B, S, Hq, Hkv, dh, causal, window, dtype
    (2, 128, 4, 2, 64, True, 0, "float32"),
    (1, 256, 4, 4, 32, True, 64, "float32"),
    (2, 128, 8, 2, 64, False, 0, "float32"),
    (1, 128, 2, 1, 128, True, 32, "float32"),
    (2, 64, 4, 1, 64, True, 0, "bfloat16"),
    (1, 192, 6, 3, 32, True, 48, "float32"),
]
# head dim 256 over one kv head (recurrentgemma's local attention)
FA_256 = [
    (1, 128, 16, 1, 256, True, 32, "float32"),
    (1, 64, 4, 1, 256, True, 0, "bfloat16"),
]
FWD_TOL = {"float32": 2e-5, "bfloat16": 2e-2}
GRAD_TOL = 2e-4


def make(B, S, Hq, Hkv, dh, seed):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s).astype(np.float32)
            for s in ((B, S, Hq, dh), (B, S, Hkv, dh), (B, S, Hkv, dh))]


def to_jax(arrays, dtype):
    return [jnp.asarray(a).astype(getattr(jnp, dtype)) for a in arrays]


def to_torch(arrays, dtype, grad=False):
    return [torch.from_numpy(a).to(getattr(torch, dtype))
            .requires_grad_(grad) for a in arrays]


def f32(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x, np.float32)


def torch_grads(qkv, causal, window):
    out = ops.flash_attention(*qkv, causal, window)
    (out.float() ** 2).sum().backward()
    return out, [t.grad for t in qkv]


@pytest.mark.parametrize("B,S,Hq,Hkv,dh,causal,window,dtype",
                         FA_SWEEP + FA_256)
def test_forward_vs_pallas_interpret(B, S, Hq, Hkv, dh, causal, window,
                                     dtype):
    arrays = make(B, S, Hq, Hkv, dh, seed=S + dh)
    want = jax_flash(*to_jax(arrays, dtype), causal, window, 64, 64, True)
    got = ops.flash_attention(*to_torch(arrays, dtype), causal, window)
    assert got.dtype == getattr(torch, dtype)
    np.testing.assert_allclose(f32(got), f32(want), rtol=FWD_TOL[dtype],
                               atol=FWD_TOL[dtype])


@pytest.mark.parametrize("B,S,Hq,Hkv,dh,causal,window,dtype",
                         FA_SWEEP[:4] + FA_256[:1])
def test_grads_vs_pallas_interpret(B, S, Hq, Hkv, dh, causal, window,
                                   dtype):
    """The custom VJP's Pallas dq and dk/dv kernels against the port's
    backward, through each package's autograd."""
    arrays = make(B, S, Hq, Hkv, dh, seed=S + dh + 1)
    f = lambda q, k, v: (jax_flash(q, k, v, causal, window, 64, 64, True)
                         ** 2).sum()
    want = jax.grad(f, argnums=(0, 1, 2))(*to_jax(arrays, dtype))
    _, got = torch_grads(to_torch(arrays, dtype, grad=True), causal, window)
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        np.testing.assert_allclose(f32(g), f32(w), rtol=GRAD_TOL,
                                   atol=GRAD_TOL, err_msg=name)


@pytest.mark.parametrize("B,S,Hq,Hkv,dh,causal,window,dtype", FA_SWEEP)
def test_vs_blocked_attention(B, S, Hq, Hkv, dh, causal, window, dtype):
    """Forward (and, in float32, gradients) against the JAX package's
    online-softmax ``layers.blocked_attention``."""
    arrays = make(B, S, Hq, Hkv, dh, seed=S + dh + 2)
    blocked = lambda q, k, v: blocked_attention(
        q, k, v, causal=causal, window=window, block_q=64, block_kv=64)
    want = blocked(*to_jax(arrays, dtype))
    qkv = to_torch(arrays, dtype, grad=dtype == "float32")
    got = ops.flash_attention(*qkv, causal, window)
    np.testing.assert_allclose(f32(got), f32(want), rtol=FWD_TOL[dtype],
                               atol=FWD_TOL[dtype])
    if dtype != "float32":
        return
    want_g = jax.grad(lambda *a: (blocked(*a) ** 2).sum(),
                      argnums=(0, 1, 2))(*to_jax(arrays, dtype))
    (got ** 2).sum().backward()
    for name, t, w in zip(("dq", "dk", "dv"), qkv, want_g):
        np.testing.assert_allclose(f32(t.grad), f32(w), rtol=GRAD_TOL,
                                   atol=GRAD_TOL, err_msg=name)


@pytest.mark.parametrize("B,S,Hq,Hkv,dh,causal,window,dtype", FA_SWEEP)
def test_lse_vs_attention_ref(B, S, Hq, Hkv, dh, causal, window, dtype):
    """The plain forward's lse (B, Hq, S) against the JAX oracle's, over
    K/V repeated to every query head."""
    arrays = make(B, S, Hq, Hkv, dh, seed=S + dh + 3)
    qf, kf, vf = gqa_flatten(*to_jax(arrays, dtype))
    want_out, want_lse = attention_ref(qf, kf, vf, causal=causal,
                                       window=window)
    out, lse = ref.flash_attention_fwd_ref(*to_torch(arrays, dtype),
                                           causal=causal, window=window)
    assert lse.dtype == torch.float32 and lse.shape == (B, Hq, S)
    np.testing.assert_allclose(f32(lse), f32(want_lse).reshape(B, Hq, S),
                               rtol=FWD_TOL[dtype], atol=FWD_TOL[dtype])
    np.testing.assert_allclose(
        f32(out), f32(want_out).reshape(B, Hq, S, dh).transpose(0, 2, 1, 3),
        rtol=FWD_TOL[dtype], atol=FWD_TOL[dtype])


def dense_softmax(q, k, v, causal, window):
    """Masked softmax attention in torch, K/V repeated over each group."""
    G = q.shape[2] // k.shape[2]
    k, v = k.repeat_interleave(G, 2), v.repeat_interleave(G, 2)
    s = torch.einsum("bqhd,bkhd->bhqk", q, k) * q.shape[-1] ** -0.5
    S = q.shape[1]
    t = torch.arange(S)[:, None]
    j = torch.arange(S)[None, :]
    mask = torch.ones(S, S, dtype=torch.bool)
    if causal:
        mask &= j <= t
    if window:
        mask &= j > t - window
    s = s.masked_fill(~mask, float("-inf"))
    return torch.einsum("bhqk,bkhd->bqhd", torch.softmax(s, -1), v)


@pytest.mark.parametrize("S,Hq,Hkv,dh,causal,window", [
    (200, 6, 2, 16, True, 0),
    (200, 6, 3, 32, True, 37),
    (77, 4, 4, 64, False, 0),
    (131, 8, 1, 16, False, 20),
    (70, 16, 1, 256, True, 24),
])
def test_ragged_vs_dense_softmax(S, Hq, Hkv, dh, causal, window):
    """A sequence that no tile size divides: forward and gradients against
    a dense masked softmax (autograd) in float32."""
    arrays = make(2, S, Hq, Hkv, dh, seed=S)
    qkv = to_torch(arrays, "float32", grad=True)
    got, got_g = torch_grads(qkv, causal, window)
    qkv2 = to_torch(arrays, "float32", grad=True)
    want = dense_softmax(*qkv2, causal, window)
    (want ** 2).sum().backward()
    np.testing.assert_allclose(f32(got), f32(want), rtol=FWD_TOL["float32"],
                               atol=FWD_TOL["float32"])
    for name, g, t in zip(("dq", "dk", "dv"), got_g, qkv2):
        np.testing.assert_allclose(f32(g), f32(t.grad), rtol=GRAD_TOL,
                                   atol=GRAD_TOL, err_msg=name)


def test_cpu_route_launches_no_kernel():
    """On CPU tensors the wrapper runs the plain version: no kernel launch
    is counted, forward or backward."""
    arrays = make(1, 32, 2, 1, 16, seed=0)
    f0, b0 = ops.flash_attention.launches, ops.flash_attention_bwd.launches
    torch_grads(to_torch(arrays, "float32", grad=True), True, 0)
    assert (ops.flash_attention.launches,
            ops.flash_attention_bwd.launches) == (f0, b0)


def test_cpu_route_counts_no_route():
    """On CPU tensors neither route's count moves: the plain version is no
    kernel launch, bf16 or float32."""
    arrays = make(1, 32, 2, 1, 16, seed=1)
    fns = (ops.flash_attention, ops.flash_attention_bwd)
    before = [(fn.launches, fn.wgmma_launches) for fn in fns]
    for dtype in ("float32", "bfloat16"):
        torch_grads(to_torch(arrays, dtype, grad=True), True, 0)
    assert [(fn.launches, fn.wgmma_launches) for fn in fns] == before


# (B, S, H, dh), element strides, data pointer -> the TMA strides
# (batch, sequence, head), or None where the layout must be refused
TMA_CASES = [
    # contiguous model layout: llama3.2-3b's q
    ((2, 2048, 24, 128), (2048 * 24 * 128, 24 * 128, 128, 1), 4096,
     (2048 * 24 * 128, 24 * 128, 128)),
    # one kv head: its stride is never stepped, the contiguous one is used
    ((1, 4096, 1, 256), (4096 * 256, 256, 7, 1), 0, (4096 * 256, 256, 256)),
    # a head view of a fused qkv buffer: strided but aligned
    ((2, 150, 2, 64), (150 * 10 * 64, 10 * 64, 64, 1), 6 * 64 * 2,
     (150 * 10 * 64, 10 * 64, 64)),
    # batch of one with an odd batch stride: never stepped either
    ((1, 64, 2, 32), (3, 2 * 32, 32, 1), 32, (64 * 2 * 32, 2 * 32, 32)),
    # head stride 17 elements = 34 bytes: not whole 16-byte units
    ((2, 5, 3, 16), (5 * 3 * 17, 3 * 17, 17, 1), 0, None),
    # sequence stride 4 elements = 8 bytes
    ((1, 8, 1, 16), (128, 4, 16, 1), 0, None),
    # base 8 bytes past a 16-byte boundary
    ((2, 5, 3, 16), (240, 48, 16, 1), 8, None),
    # a broadcast (stride 0) sequence dim
    ((1, 8, 2, 16), (32, 0, 16, 1), 0, None),
]


@pytest.mark.parametrize("shape,strides,ptr,want", TMA_CASES)
def test_tma_strides(shape, strides, ptr, want):
    """The bf16 route's layout rule, as a pure function: TMA reads a
    16-byte-aligned base with strides of whole positive 16-byte units;
    what breaks the rule raises and names the tensor."""
    if want is None:
        with pytest.raises(ValueError, match="q.*TMA"):
            ops.tma_strides("q", shape, strides, ptr)
    else:
        assert ops.tma_strides("q", shape, strides, ptr) == want


def test_tma_strides_of_torch_views():
    """``_tma`` reads shape, strides and pointer off a tensor: a fused qkv
    buffer's head views pass, a view that slices the head dim raises."""
    qkv = torch.zeros(2, 150, 10, 64, dtype=torch.bfloat16)
    q, k, v = qkv.split([6, 2, 2], dim=2)
    for name, t in (("q", q), ("k", k), ("v", v)):
        assert ops._tma(name, t) == (150 * 10 * 64, 10 * 64, 64)
    wide = torch.zeros(2, 150, 6, 65, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="head stride is 65"):
        ops._tma("q", wide[..., :64])
