"""The SSD chunked-scan CUDA kernel against its plain PyTorch version, on
the card: the ``SSD_SWEEP`` geometries of ``tests/test_kernels.py``, more
than one group, ragged row and column tiles, and the training path's shape
(mamba2-780m: B=4, S=2048, 48 heads of 64, state 128, chunk 256), with
float32 and with bf16 B/C; the wrapper's autograd against the plain route;
and the card route of the float32-output projection that the output head
and the SSD block's dt use, against a float32 upcast.

The kernel has no CPU mode, so the tests are marked ``gpu`` and skip where
no CUDA device is visible.  This file imports neither JAX nor the JAX
package, so it also runs on a machine that has only PyTorch:

    PYTHONPATH=src python3 -m pytest -q --noconftest -m gpu \\
        tests/test_torch_ssd_kernel_gpu.py

``test_torch_ssd.py`` holds the plain versions against JAX on the CPU."""
import numpy as np
import pytest
import torch

from repro_torch.kernels.ssd_scan import ops, ref
from repro_torch.models import layers as L

SSD_SWEEP = [
    # B, S, H, P, G, N, chunk
    (2, 64, 4, 16, 1, 32, 16),
    (1, 32, 4, 8, 2, 16, 32),
    (2, 128, 2, 32, 1, 8, 64),
]
EXTRA = [
    (2, 512, 8, 64, 2, 128, 256),        # two groups, full-size heads
    (2, 300, 6, 80, 3, 20, 100),         # ragged row and column tiles
    (1, 96, 4, 16, 1, 256, 96),          # the largest state the kernel takes
    (4, 2048, 48, 64, 1, 128, 256),      # the training path's shape
]
GEOS = SSD_SWEEP + EXTRA
IDS = [f"B{b}_S{s}_H{h}_P{p}_G{g}_N{n}_Q{q}" for b, s, h, p, g, n, q in GEOS]
# the JAX package's ssd_scan test: 3e-4 in float32; 2e-2 with bf16 B/C
TOL = {"float32": 3e-4, "bfloat16": 2e-2}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the SSD scan CUDA kernel has no "
                    "CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def model_inputs(B, S, H, P, G, N, dtype, device, seed):
    """x, dt, A, B_, C_ as the JAX ssd_scan test draws them, x and B/C in
    ``dtype``."""
    rng = np.random.default_rng(seed)

    def t(a, dt=torch.float32):
        return torch.from_numpy(a.astype(np.float32)).to(device=device,
                                                          dtype=dt)

    dt_ = getattr(torch, dtype)
    return (t(rng.standard_normal((B, S, H, P)), dt_),
            t(np.log1p(np.exp(rng.standard_normal((B, S, H)) - 1.0))),
            t(-np.exp(rng.standard_normal(H) * 0.3)),
            t(rng.standard_normal((B, S, G, N)) * 0.5, dt_),
            t(rng.standard_normal((B, S, G, N)) * 0.5, dt_))


def head_major(x, dt, A, B_, C_):
    Bb, S, H, _ = x.shape
    xdt = ops._head_major(x.float() * dt[..., None])
    a = (dt * A).transpose(1, 2).reshape(Bb * H, S).contiguous()
    return xdt, a, ops._head_major(B_), ops._head_major(C_)


def assert_close(got, want, tol, what):
    got, want = got.float(), want.float()
    assert torch.isfinite(got).all(), what
    err = (got - want).abs()
    bad = err > tol + tol * want.abs()
    assert not bad.any(), f"{what}: max abs err {float(err.max()):.3e}"


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("geo", GEOS, ids=IDS)
def test_kernel_matches_plain(cuda, geo, dtype):
    B, S, H, P, G, N, chunk = geo
    ins = head_major(*model_inputs(B, S, H, P, G, N, dtype, cuda,
                                   seed=S + N))
    kw = dict(chunk=chunk, hq_per_group=H // G)
    n0 = ops.ssd_scan.launches
    y, h = ops.ssd_scan(*ins, **kw)
    torch.cuda.synchronize()
    assert ops.ssd_scan.launches == n0 + 1
    want_y, want_h = ref.ssd_scan_plain(*ins, **kw)
    assert y.shape == (B * H, S, P) and h.shape == (B * H, N, P)
    assert y.dtype == h.dtype == torch.float32
    assert_close(y, want_y, TOL[dtype], "y")
    assert_close(h, want_h, TOL[dtype], "h_final")


@pytest.mark.gpu
def test_kernel_matches_the_per_step_oracle(cuda):
    """The chunked kernel equals the per-step recurrence (the chunk is a
    blocking choice)."""
    x, dt, A, B_, C_ = model_inputs(2, 96, 4, 16, 2, 32, "float32", cuda, 5)
    y, h = ops.ssd_with_state(x, dt, A, B_, C_, 32)
    want_y, want_h = ref.ssd_scan_ref(x, dt, A, B_, C_)
    assert_close(y, want_y, 3e-4, "y")
    assert_close(h, want_h, 3e-4, "h_final")


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_autograd_matches_the_plain_route(cuda, dtype):
    """``ssd_with_state`` on the card (kernel forward, ``ssd_chunked``
    backward) against the same inputs on the CPU (plain forward): outputs
    and the gradients of x, dt, A, B_ and C_ under cotangents on both
    outputs."""
    args = model_inputs(2, 128, 4, 16, 2, 32, dtype, cuda, seed=11)
    rng = np.random.default_rng(12)
    gy = torch.from_numpy(rng.standard_normal((2, 128, 4, 16))
                          .astype(np.float32))
    gh = torch.from_numpy(rng.standard_normal((2, 4, 16, 32))
                          .astype(np.float32))
    out = {}
    for dev in (cuda, torch.device("cpu")):
        leaves = [a.detach().to(dev).requires_grad_(True) for a in args]
        y, h = ops.ssd_with_state(*leaves, 32)
        ((y.float() * gy.to(dev)).sum() + (h * gh.to(dev)).sum()).backward()
        out[dev.type] = [y, h] + [t.grad for t in leaves]
    tol = 2e-2 if dtype == "bfloat16" else 2e-4
    for name, got, want in zip(("y", "h", "dx", "ddt", "dA", "dB", "dC"),
                               out["cuda"], out["cpu"]):
        assert_close(got.cpu(), want, tol, name)


@pytest.mark.gpu
def test_wrapper_checks_its_inputs(cuda):
    x, dt, A, B_, C_ = model_inputs(1, 64, 2, 16, 1, 16, "float32", cuda, 1)
    xdt, a, Bh, Ch = head_major(x, dt, A, B_, C_)
    kw = dict(chunk=32, hq_per_group=2)
    with pytest.raises(ValueError, match="multiple of the chunk"):
        ops.ssd_scan(xdt[:, :60].contiguous(), a[:, :60].contiguous(),
                     Bh[:, :60].contiguous(), Ch[:, :60].contiguous(), **kw)
    with pytest.raises(TypeError, match="float32"):
        ops.ssd_scan(xdt.half(), a, Bh, Ch, **kw)
    with pytest.raises(ValueError, match="contiguous"):
        ops.ssd_scan(xdt.transpose(0, 1), a, Bh, Ch, **kw)
    with pytest.raises(ValueError, match="do not fit"):
        ops.ssd_scan(xdt, a, Bh, Ch, chunk=32, hq_per_group=1)


@pytest.mark.gpu
@pytest.mark.parametrize("shape", [(4096, 1536, 50432), (300, 64, 48)])
def test_matmul_f32_card_route(cuda, shape):
    """bf16 operands -> float32 output with no rounding to bf16 (cuBLAS's
    bf16 -> f32 GEMM), and its gradients (the float32 cotangent split in
    two bf16 parts), against a float32 upcast of the same operands."""
    M, K, N = shape
    rng = np.random.default_rng(3)
    x = torch.from_numpy(rng.standard_normal((M, K)).astype(np.float32)) \
        .to(cuda, torch.bfloat16).requires_grad_(True)
    w = (torch.from_numpy(rng.standard_normal((K, N)).astype(np.float32))
         * K ** -0.5).to(cuda, torch.bfloat16).requires_grad_(True)
    g = torch.from_numpy(rng.standard_normal((M, N)).astype(np.float32)) \
        .to(cuda)
    out = L.matmul_f32(x, w)
    assert out.dtype == torch.float32
    out.backward(g)
    x32 = x.detach().float().requires_grad_(True)
    w32 = w.detach().float().requires_grad_(True)
    want = x32 @ w32
    want.backward(g)
    # products of bf16 values are exact in float32: only the order of the
    # sums differs
    assert_close(out.detach(), want.detach(), 1e-4, "out")
    # the gradients are rounded to bf16 at the end, as the JAX package's
    assert_close(x.grad, x32.grad.to(torch.bfloat16), 1e-2, "dx")
    assert_close(w.grad, w32.grad.to(torch.bfloat16), 1e-2, "dw")
