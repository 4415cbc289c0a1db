"""The flash-attention CUDA kernels (forward, and the dq + dk/dv backward)
against their plain PyTorch versions, on the card: the ``FA_SWEEP``
geometries of ``tests/test_kernels.py``, a ragged sequence length, the
dense training path's shape (llama3.2-3b: B=2, S=2048, 24 heads over 8,
dh=128), head dim 256 with one kv head and the hybrid training path's
shape (recurrentgemma-9b: B=1, S=4096, 16 heads over 1, dh=256, window
2048).  bf16 takes the tensor-core kernels (``*_wgmma.cu``), float32 the
FMA kernels: ``BF16`` covers every head dim, G of 1, 3 and 16, ragged S,
windows and no causal mask on the tensor-core route, and the tests below
it the stride contract, TMA's alignment rule, determinism and the route.

The kernels have no CPU mode, so the tests are marked ``gpu`` and skip
where no CUDA device is visible.  This file imports neither JAX nor the JAX
package, so it also runs on a machine that has only PyTorch:

    PYTHONPATH=src python3 -m pytest -q --noconftest -m gpu \\
        tests/test_torch_flash_kernel_gpu.py

``test_torch_flash_attention.py`` holds the plain versions against JAX on
the CPU."""
import numpy as np
import pytest
import torch

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
EXTRA = [
    (2, 200, 6, 2, 16, True, 0, "float32"),      # ragged S, reduced dh
    (2, 200, 6, 2, 64, True, 37, "bfloat16"),    # ragged S with a window
    (1, 77, 4, 4, 128, False, 0, "float32"),     # ragged, not causal
    (2, 2048, 24, 8, 128, True, 0, "bfloat16"),  # the training path's shape
    (1, 200, 16, 1, 256, True, 64, "float32"),   # dh 256, MQA, ragged S
    (2, 130, 4, 2, 256, False, 0, "float32"),    # dh 256, not causal
    (1, 1000, 16, 1, 256, True, 300, "bfloat16"),  # dh 256 MQA window
    (1, 4096, 16, 1, 256, True, 2048, "bfloat16"),  # the hybrid's shape
]
# the tensor-core route: every head dim the wrapper takes, G of 1, 3, 16
BF16 = [
    (2, 200, 6, 2, 16, True, 0, "bfloat16"),      # dh 16, G 3, ragged S
    (1, 190, 4, 4, 32, True, 48, "bfloat16"),     # dh 32, G 1, window
    (2, 130, 16, 1, 64, False, 0, "bfloat16"),    # dh 64, G 16, not causal
    (1, 77, 6, 2, 128, True, 20, "bfloat16"),     # dh 128, G 3, window
    (2, 100, 3, 1, 256, False, 0, "bfloat16"),    # dh 256, G 3, not causal
    (1, 257, 16, 1, 256, True, 0, "bfloat16"),    # dh 256, G 16, ragged S
    (1, 64, 2, 2, 16, False, 0, "bfloat16"),      # one tile, G 1
]
IDS = [f"B{b}_S{s}_H{hq}x{hkv}_dh{dh}_{'c' if c else 'nc'}_w{w}_{t}"
       for b, s, hq, hkv, dh, c, w, t in FA_SWEEP + EXTRA + BF16]
# the JAX package's kernel tests: forward 2e-5 (f32) / 2e-2 (bf16),
# gradients 2e-4 (f32)
TOL = {("fwd", "float32"): 2e-5, ("bwd", "float32"): 2e-4,
       ("fwd", "bfloat16"): 2e-2, ("bwd", "bfloat16"): 2e-2}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the flash-attention CUDA kernels "
                    "have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def inputs(B, S, Hq, Hkv, dh, dtype, device, seed):
    rng = np.random.default_rng(seed)
    shapes = [(B, S, Hq, dh), (B, S, Hkv, dh), (B, S, Hkv, dh),
              (B, S, Hq, dh)]
    return [torch.from_numpy(rng.standard_normal(s).astype(np.float32))
            .to(device=device, dtype=getattr(torch, dtype)) for s in shapes]


def close(got, want, tol, what):
    got, want = got.float(), want.float()
    err = (got - want).abs()
    bad = err > tol + tol * want.abs()
    assert not bool(bad.any()), (
        f"{what}: {int(bad.sum())} elements off, max abs err "
        f"{float(err.max()):.3e} (tol {tol})")


@pytest.mark.gpu
@pytest.mark.parametrize("B,S,Hq,Hkv,dh,causal,window,dtype",
                         FA_SWEEP + EXTRA + BF16, ids=IDS)
def test_flash_kernels_vs_plain(cuda, B, S, Hq, Hkv, dh, causal, window,
                                dtype):
    q, k, v, do = inputs(B, S, Hq, Hkv, dh, dtype, cuda, seed=S + dh)
    f0, b0 = ops.flash_attention.launches, ops.flash_attention_bwd.launches
    w0 = (ops.flash_attention.wgmma_launches,
          ops.flash_attention_bwd.wgmma_launches)
    out, lse = ops.flash_attention_fwd(q, k, v, causal=causal, window=window)
    torch.cuda.synchronize()
    assert ops.flash_attention.launches == f0 + 1
    want_out, want_lse = ref.flash_attention_fwd_ref(q, k, v, causal=causal,
                                                     window=window)
    assert out.dtype == q.dtype and lse.shape == (B, Hq, S)
    close(out, want_out, TOL["fwd", dtype], "out")
    close(lse, want_lse, TOL["fwd", dtype], "lse")
    # the backward kernels on the plain forward's out and lse
    grads = ops.flash_attention_bwd(q, k, v, want_out, want_lse, do,
                                    causal=causal, window=window)
    torch.cuda.synchronize()
    assert ops.flash_attention_bwd.launches == b0 + 1
    want = ref.flash_attention_bwd_ref(q, k, v, want_out, want_lse, do,
                                       causal=causal, window=window)
    for name, g, w in zip(("dq", "dk", "dv"), grads, want):
        assert g.dtype == w.dtype and g.shape == w.shape
        close(g, w, TOL["bwd", dtype], name)
    # bf16 on the tensor-core kernels, float32 on the FMA ones
    wgmma = int(dtype == "bfloat16")
    assert (ops.flash_attention.wgmma_launches,
            ops.flash_attention_bwd.wgmma_launches) == (w0[0] + wgmma,
                                                        w0[1] + wgmma)


@pytest.mark.gpu
def test_autograd_through_kernels(cuda):
    """``flash_attention`` on the card: forward and backward both go
    through the kernels, on strided (non-contiguous) q/k/v views."""
    B, S, Hq, Hkv, dh = 2, 150, 6, 3, 32
    q, k, v, do = inputs(B, S, Hq, Hkv, dh, "float32", cuda, seed=3)
    qkv = torch.cat([q, k, v], dim=2).requires_grad_()    # one buffer
    qv, kv_, vv = qkv.split([Hq, Hkv, Hkv], dim=2)        # strided views
    f0, b0 = ops.flash_attention.launches, ops.flash_attention_bwd.launches
    out = ops.flash_attention(qv, kv_, vv, True, 0)
    out.backward(do)
    torch.cuda.synchronize()
    assert (ops.flash_attention.launches, ops.flash_attention_bwd.launches) \
        == (f0 + 1, b0 + 1)
    want_out, want_lse = ref.flash_attention_fwd_ref(q, k, v)
    close(out, want_out, TOL["fwd", "float32"], "out")
    want = ref.flash_attention_bwd_ref(q, k, v, want_out, want_lse, do)
    got = qkv.grad.split([Hq, Hkv, Hkv], dim=2)
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        close(g, w, TOL["bwd", "float32"], name)


@pytest.mark.gpu
def test_bf16_autograd_through_strided_views(cuda):
    """bf16 ``flash_attention`` on q/k/v views of one fused buffer (the
    model layout's stride contract) goes through the tensor-core kernels
    and matches the plain versions."""
    B, S, Hq, Hkv, dh = 2, 150, 6, 2, 64
    q, k, v, do = inputs(B, S, Hq, Hkv, dh, "bfloat16", cuda, seed=5)
    qkv = torch.cat([q, k, v], dim=2).requires_grad_()
    qv, kv_, vv = qkv.split([Hq, Hkv, Hkv], dim=2)
    f0, b0 = (ops.flash_attention.wgmma_launches,
              ops.flash_attention_bwd.wgmma_launches)
    out = ops.flash_attention(qv, kv_, vv, True, 0)
    out.backward(do)
    torch.cuda.synchronize()
    assert (ops.flash_attention.wgmma_launches,
            ops.flash_attention_bwd.wgmma_launches) == (f0 + 1, b0 + 1)
    want_out, want_lse = ref.flash_attention_fwd_ref(q, k, v)
    close(out, want_out, TOL["fwd", "bfloat16"], "out")
    _, lse = ops.flash_attention_fwd(q, k, v)
    want = ref.flash_attention_bwd_ref(q, k, v, out.detach(), lse, do)
    for name, g, w in zip(("dq", "dk", "dv"),
                          qkv.grad.split([Hq, Hkv, Hkv], dim=2), want):
        close(g, w, TOL["bwd", "bfloat16"], name)


@pytest.mark.gpu
@pytest.mark.parametrize("what", ["head_stride", "base"])
def test_bf16_misaligned_view_raises(cuda, what):
    """TMA needs a 16-byte-aligned base and strides of whole 16-byte
    units: a bf16 view that breaks either raises, and nothing launches."""
    B, S, H, dh = 1, 64, 2, 32
    q, k, v, _ = inputs(B, S, H, H, dh, "bfloat16", cuda, seed=1)
    if what == "head_stride":
        bad = torch.zeros(B, S, H, dh + 1, dtype=torch.bfloat16,
                          device=cuda)[..., :dh]
    else:
        flat = torch.zeros(B * S * H * dh + 1, dtype=torch.bfloat16,
                           device=cuda)
        bad = flat[1:].view(B, S, H, dh)
    n = ops.flash_attention.launches
    with pytest.raises(ValueError, match="TMA"):
        ops.flash_attention_fwd(bad, k, v)
    with pytest.raises(ValueError, match="TMA"):
        ops.flash_attention_bwd(q, bad, v, q, torch.zeros(B, H, S,
                                                            device=cuda), q)
    assert ops.flash_attention.launches == n


@pytest.mark.gpu
@pytest.mark.parametrize("dh,Hq,Hkv,window", [(128, 24, 8, 0),
                                             (256, 16, 1, 100)])
def test_bf16_backward_is_deterministic(cuda, dh, Hq, Hkv, window):
    """Every gradient element has one owner (no atomics): two backward runs
    give bit-identical dq, dk and dv."""
    q, k, v, do = inputs(1, 300, Hq, Hkv, dh, "bfloat16", cuda, seed=9)
    out, lse = ops.flash_attention_fwd(q, k, v, window=window)
    first = ops.flash_attention_bwd(q, k, v, out, lse, do, window=window)
    second = ops.flash_attention_bwd(q, k, v, out, lse, do, window=window)
    torch.cuda.synchronize()
    for a, b in zip(first, second):
        assert torch.equal(a, b)
