"""The SSD chunked-scan CUDA kernels against their plain PyTorch version,
on the card: the ``SSD_SWEEP`` geometries of ``tests/test_kernels.py``,
more than one group, ragged row and column tiles, and the training path's
shape (mamba2-780m: B=4, S=2048, 48 heads of 64, state 128, chunk 256),
with float32 B/C (the FMA kernel ``ssd_scan.cu``) and with bf16 B/C (the
tensor-core kernel ``ssd_scan_wgmma.cu``, each call counted on its route);
the bf16 kernel within 2e-3 of the plain version at the training shape,
bit-identical on a rerun and under every head-set choice, and on B/C
views that TMA cannot load; the wrapper's autograd against the plain
route; and the card route of the float32-output projection that the
output head and the SSD block's dt use, against a float32 upcast.

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
# the bf16 kernel's bound at the training shape: float32 operands in two
# bf16 parts (test_torch_ssd_split.py checks that one part misses it)
SPLIT_TOL = 2e-3
TRAIN_GEO = (4, 2048, 48, 64, 1, 128, 256)


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
    fn = ops.ssd_scan
    n0, w0 = fn.launches, fn.wgmma_launches
    y, h = fn(*ins, **kw)
    torch.cuda.synchronize()
    assert fn.launches == n0 + 1
    # bf16 B/C on the tensor-core kernel, float32 on the FMA kernel
    assert fn.wgmma_launches == w0 + (dtype == "bfloat16")
    want_y, want_h = ref.ssd_scan_plain(*ins, **kw)
    assert y.shape == (B * H, S, P) and h.shape == (B * H, N, P)
    assert y.dtype == h.dtype == torch.float32
    assert_close(y, want_y, TOL[dtype], "y")
    assert_close(h, want_h, TOL[dtype], "h_final")


def train_inputs(device, seed=23):
    B, S, H, P, G, N, chunk = TRAIN_GEO
    ins = head_major(*model_inputs(B, S, H, P, G, N, "bfloat16", device,
                                   seed=seed))
    return ins, dict(chunk=chunk, hq_per_group=H // G)


@pytest.mark.gpu
def test_bf16_training_shape_within_the_split_bound(cuda):
    """The tensor-core kernel at mamba2-780m's training shape: y and
    h_final within 2e-3 of the plain version (absolute), every element."""
    ins, kw = train_inputs(cuda)
    w0 = ops.ssd_scan.wgmma_launches
    y, h = ops.ssd_scan(*ins, **kw)
    torch.cuda.synchronize()
    assert ops.ssd_scan.wgmma_launches == w0 + 1
    want_y, want_h = ref.ssd_scan_plain(*ins, **kw)
    assert torch.isfinite(y).all() and torch.isfinite(h).all()
    assert float((y - want_y).abs().max()) <= SPLIT_TOL
    assert float((h - want_h).abs().max()) <= SPLIT_TOL


@pytest.mark.gpu
def test_bf16_reruns_are_bit_identical(cuda):
    ins, kw = train_inputs(cuda, seed=29)
    first = ops.ssd_scan(*ins, **kw)
    again = ops.ssd_scan(*ins, **kw)
    assert torch.equal(first[0], again[0]) and torch.equal(first[1], again[1])


@pytest.mark.gpu
@pytest.mark.parametrize("geo", [(2, 512, 8, 64, 1, 128, 256),
                                 (2, 300, 6, 80, 1, 20, 100)],
                         ids=["tma", "plain_loads_ragged"])
def test_bf16_head_sets_give_the_same_bits(cuda, geo, monkeypatch):
    """C Bᵀ is the same product for every head of a set, whatever the
    sets: each head-set choice of either kernel gives the same bits."""
    B, S, H, P, G, N, chunk = geo
    ins = head_major(*model_inputs(B, S, H, P, G, N, "bfloat16", cuda,
                                   seed=31))
    kw = dict(chunk=chunk, hq_per_group=H // G)
    want = ops.ssd_scan(*ins, **kw)
    assert_close(want[0], ref.ssd_scan_plain(*ins, **kw)[0], TOL["bfloat16"],
                 "y")
    for heads in [(1, 1), (2, 3), (H, H), (3, 2), (H, 1)]:
        monkeypatch.setattr(ops, "ssd_head_sets", lambda *a, _h=heads: _h)
        got = ops.ssd_scan(*ins, **kw)
        assert torch.equal(got[0], want[0]), heads
        assert torch.equal(got[1], want[1]), heads


@pytest.mark.gpu
@pytest.mark.parametrize("offset", [1, 2, 4])
def test_bf16_views_tma_cannot_load(cuda, offset):
    """B and C as views ``offset`` elements into their buffers (2, 4 and
    8 bytes): plain loads of 1, 2 and 4 elements, the same bits as
    aligned copies loaded by TMA."""
    B, S, H, P, G, N, chunk = 1, 512, 4, 64, 1, 128, 256
    xdt, a, Bh, Ch = head_major(*model_inputs(B, S, H, P, G, N, "bfloat16",
                                              cuda, seed=37))
    views = []
    for m in (Bh, Ch):
        buf = torch.zeros(m.numel() + offset, dtype=m.dtype, device=cuda)
        buf[offset:] = m.flatten()
        views.append(buf[offset:].view(m.shape))
    assert ops.ssd_bc_loads(N, [v.data_ptr() for v in views]) == \
        offset
    kw = dict(chunk=chunk, hq_per_group=H // G)
    want = ops.ssd_scan(xdt, a, Bh, Ch, **kw)
    got = ops.ssd_scan(xdt, a, *views, **kw)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


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
    x, dt, A, B_, C_ = model_inputs(1, 512, 2, 16, 1, 16, "bfloat16", cuda, 1)
    with pytest.raises(ValueError, match="chunks of at most"):
        ops.ssd_scan(*head_major(x, dt, A, B_, C_), chunk=512, hq_per_group=2)


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
