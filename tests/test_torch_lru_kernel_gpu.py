"""The RG-LRU scan CUDA kernel against its plain PyTorch version, on the
card: the ``LRU_SWEEP`` geometries of ``tests/test_kernels.py``, ragged
sequence lengths and widths, one chunk and many, forward and reverse, with
and without a carried state, and the hybrid training path's shape
(recurrentgemma-9b: B=1, S=4096, W=4096); the autograd wrapper against
the plain route; and the serving chunk step's launch.

The kernel has no CPU mode, so the tests are marked ``gpu`` and skip where
no CUDA device is visible.  This file imports neither JAX nor the JAX
package, so it also runs on a machine that has only PyTorch:

    PYTHONPATH=src python3 -m pytest -q --noconftest -m gpu \\
        tests/test_torch_lru_kernel_gpu.py

``test_torch_rglru.py`` holds the plain version against JAX on the CPU."""
import numpy as np
import pytest
import torch

from repro_torch.kernels.rglru_scan import ops, ref

GEOS = [
    # B, S, W
    (2, 128, 64), (1, 64, 128), (3, 32, 16), (1, 256, 32),   # LRU_SWEEP
    (2, 100, 300),        # ragged chunks and channel blocks
    (3, 65, 33),          # one step past a chunk
    (8, 17, 4096),        # the serving chunk step's shape: one chunk
    (1, 1, 5),
    (1, 4096, 4096),      # the training path's shape
]
IDS = [f"B{b}_S{s}_W{w}" for b, s, w in GEOS]
# the JAX package's LRU tests: 1e-5 on h, 1e-4 on gradients
TOL, GRAD_TOL = 1e-5, 1e-4


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the RG-LRU scan CUDA kernel has no "
                    "CPU mode")
    return torch.device("cuda")


def inputs(B, S, W, device, seed):
    """a in (0, 1) (a sigmoid of a normal, as the JAX test draws it), b and
    a carried state."""
    rng = np.random.default_rng(seed)
    a = 1.0 / (1.0 + np.exp(-rng.standard_normal((B, S, W))))
    return [torch.from_numpy(x.astype(np.float32)).to(device)
            for x in (a, rng.standard_normal((B, S, W)),
                      rng.standard_normal((B, W)))]


def close(got, want, tol, what):
    err = (got.float() - want.float()).abs()
    bad = err > tol + tol * want.float().abs()
    assert not bool(bad.any()), (
        f"{what}: {int(bad.sum())} elements off, max abs err "
        f"{float(err.max()):.3e} (tol {tol})")


@pytest.mark.gpu
@pytest.mark.parametrize("reverse", [False, True], ids=["forward", "reverse"])
@pytest.mark.parametrize("carried", [False, True], ids=["zero", "h0"])
@pytest.mark.parametrize("B,S,W", GEOS, ids=IDS)
def test_lru_kernel_vs_plain(cuda, B, S, W, carried, reverse):
    a, b, h0 = inputs(B, S, W, cuda, seed=S + W)
    h0 = h0 if carried else None
    before = ops.lru_scan.launches
    h, fin = ops.lru_scan(a, b, h0, reverse=reverse)
    torch.cuda.synchronize()
    assert ops.lru_scan.launches == before + 1
    assert h.dtype == fin.dtype == torch.float32
    want_h, want_fin = ref.lru_scan_plain(a, b, h0, reverse=reverse)
    close(h, want_h, TOL, "h")
    close(fin, want_fin, TOL, "h_final")


@pytest.mark.gpu
@pytest.mark.parametrize("B,S,W", [(2, 130, 64), (1, 64, 128)])
def test_autograd_through_the_kernel(cuda, B, S, W):
    """``ops.lru`` on the card: forward and backward (the reverse scan)
    both launch the kernel; the gradients equal the CPU route's."""
    a, b, _ = inputs(B, S, W, cuda, seed=7)
    g = torch.randn(B, S, W, device=cuda)
    ta, tb = a.clone().requires_grad_(True), b.clone().requires_grad_(True)
    before = ops.lru_scan.launches
    h = ops.lru(ta, tb)
    h.backward(g)
    torch.cuda.synchronize()
    assert ops.lru_scan.launches == before + 2
    ca, cb = a.cpu().requires_grad_(True), b.cpu().requires_grad_(True)
    hc = ops.lru(ca, cb)
    hc.backward(g.cpu())
    close(h.cpu(), hc, TOL, "h")
    close(ta.grad.cpu(), ca.grad, GRAD_TOL, "da")
    close(tb.grad.cpu(), cb.grad, GRAD_TOL, "db")


@pytest.mark.gpu
def test_rejects_what_the_kernel_does_not_take(cuda):
    a = torch.rand(1, 8, 4, device=cuda)
    with pytest.raises(TypeError, match="float32"):
        ops.lru_scan(a.half(), a.half())
    with pytest.raises(ValueError, match="contiguous"):
        ops.lru_scan(a.transpose(1, 2), a.transpose(1, 2))
    with pytest.raises(ValueError, match="h0"):
        ops.lru_scan(a, a, torch.zeros(1, 5, device=cuda))


@pytest.mark.gpu
def test_chunk_step_launches_the_kernel(cuda):
    """The serving chunk step's scan from the carried state goes through
    the kernel on the card and agrees with the CPU's plain route."""
    from repro_torch.configs import REGISTRY, reduced_config
    from repro_torch.models import rglru
    from repro_torch.models.params import init_params
    cfg = reduced_config(REGISTRY["recurrentgemma-9b"])
    p = init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    lp = {k: v[0] for k, v in p["groups"]["b0_rec"]["rec"].items()}
    rng = np.random.default_rng(1)
    x = torch.from_numpy(rng.standard_normal((3, 12, cfg.d_model))
                         .astype(np.float32))
    st = {"h": torch.from_numpy(rng.standard_normal((3, cfg.lru_width))
                                .astype(np.float32)),
          "conv": torch.zeros(3, cfg.conv_width - 1, cfg.lru_width)}
    n = torch.tensor([12, 5, 0], dtype=torch.int32)
    want, want_st = rglru.rglru_chunk_step(x, lp, cfg, st, n)
    before = ops.lru_scan.launches
    got, got_st = rglru.rglru_chunk_step(
        x.to(cuda), {k: v.to(cuda) for k, v in lp.items()}, cfg,
        {k: v.to(cuda) for k, v in st.items()}, n.to(cuda))
    torch.cuda.synchronize()
    assert ops.lru_scan.launches == before + 1
    close(got.cpu(), want, 1e-4, "out")
    for k in want_st:
        close(got_st[k].cpu(), want_st[k], 1e-4, k)
