"""The ring-chunk CUDA kernels against their plain PyTorch version, on the
card, on the ``RING_SWEEP`` geometries of ``tests/test_kernels.py`` and on
head dim 256 over one kv head (recurrentgemma's local attention).  Each
geometry runs at its own dtype and again in bf16: bf16 takes the
tensor-core kernel (``ring_chunk_attention_wgmma.cu``), float32 the FMA
kernel (``ring_chunk_attention.cu``); the tests below them hold the route
counts, TMA's alignment rule and bit-identical reruns.

The kernels have no CPU mode, so the tests are marked ``gpu`` and skip
where no CUDA device is visible.  This file imports neither JAX nor the JAX
package, so it also runs on a machine that has only PyTorch:

    PYTHONPATH=src python3 -m pytest -q --noconftest -m gpu \\
        tests/test_torch_ring_kernel_gpu.py

``test_torch_ring_attention.py`` holds the plain version against JAX on
the same geometries and inputs."""
import numpy as np
import pytest
import torch

from repro_torch.kernels.flash_attention import ops, ref

RING_SWEEP = [
    # B, C, W, Hq, Hkv, dh, pos, nt, window, softcap, bq, bkv, dtype
    (2, 4, 16, 4, 2, 32, (0, 3), (4, 2), 0, 0.0, 32, 32, "float32"),
    (2, 6, 8, 4, 4, 16, (13, 27), (6, 6), 0, 0.0, 4, 4, "float32"),
    (2, 10, 8, 4, 2, 16, (5, 21), (10, 7), 0, 0.0, 32, 32, "float32"),
    (3, 4, 8, 2, 1, 16, (0, 5, 9), (0, 0, 4), 0, 0.0, 32, 32, "float32"),
    (2, 8, 16, 4, 2, 32, (20, 3), (8, 5), 7, 30.0, 4, 8, "float32"),
    (1, 4, 8, 8, 1, 32, (11,), (4,), 0, 0.0, 32, 32, "float32"),
    (1, 5, 13, 2, 2, 16, (29,), (5,), 0, 0.0, 4, 8, "float32"),
    (2, 6, 12, 4, 2, 32, (9, 15), (6, 3), 0, 0.0, 8, 8, "bfloat16"),
    (2, 8, 16, 16, 1, 256, (20, 3), (8, 5), 12, 0.0, 8, 8, "float32"),
    (3, 6, 8, 16, 1, 256, (0, 13, 9), (0, 6, 4), 0, 0.0, 4, 8, "bfloat16"),
]
IDS = ["basic", "ring_wrap_tails", "chunk_wider_than_ring", "idle_rows",
       "window_softcap", "gqa_group8", "nondivisible_bkv", "bf16",
       "dh256_mqa_window", "dh256_mqa_bf16"]
# the tolerances of the JAX package's kernel tests
TOL = {"float32": 5e-5, "bfloat16": 2e-2}


def make_inputs(B, C, W, Hq, Hkv, dh, seed):
    """q, k_new, v_new, k_cache, v_cache as float32 numpy arrays."""
    rng = np.random.default_rng(seed)
    shapes = [(B, C, Hq, dh), (B, C, Hkv, dh), (B, C, Hkv, dh),
              (B, W, Hkv, dh), (B, W, Hkv, dh)]
    return [rng.standard_normal(s).astype(np.float32) for s in shapes]


def to_torch(arrays, pos, nt, dtype, device="cpu"):
    dt = getattr(torch, dtype)
    return [torch.from_numpy(a).to(device=device, dtype=dt) for a in arrays] \
        + [torch.tensor(pos, dtype=torch.int32, device=device),
           torch.tensor(nt, dtype=torch.int32, device=device)]


def active_close(got, want, nt, tol, what):
    """Rows t < n_tokens of every stream agree within ``tol``."""
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    for b, n in enumerate(nt):
        np.testing.assert_allclose(got[b, :n], want[b, :n], rtol=tol,
                                   atol=tol, err_msg=f"{what}: stream {b}")


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the ring-chunk CUDA kernel has no "
                    "CPU mode")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize(
    "B,C,W,Hq,Hkv,dh,pos,nt,window,softcap,bq,bkv,dtype", RING_SWEEP,
    ids=IDS)
def test_cuda_kernel_vs_plain(cuda, B, C, W, Hq, Hkv, dh, pos, nt, window,
                              softcap, bq, bkv, dtype):
    arrays = make_inputs(B, C, W, Hq, Hkv, dh, seed=B * 31 + C)
    args = to_torch(arrays, pos, nt, dtype, device=cuda)
    fn = ops.ring_chunk_attention
    before = (fn.launches, fn.wgmma_launches)
    got = fn(*args, window=window, softcap=softcap)
    torch.cuda.synchronize()
    assert (fn.launches, fn.wgmma_launches) == \
        (before[0] + 1, before[1] + (dtype == "bfloat16"))
    assert got.dtype == args[0].dtype and got.shape == args[0].shape
    want = ref.ring_chunk_attention_ref(*args, window=window, softcap=softcap)
    active_close(got.float().cpu(), want.float().cpu(), nt, TOL[dtype],
                 "CUDA kernel vs plain")
    for b in range(B):
        if pos[b] == 0 and nt[b] == 0:      # no visible key at all
            assert (got[b] == 0).all(), f"idle stream {b} is not 0"


# the serving paths' shapes (llama3-8b, and recurrentgemma-9b's local
# attention), a chunk wider than a 64-slot tile, and a ring of several
# splits seen only in part
WIDE = [
    (8, 16, 1024, 32, 8, 128, (0, 16, 208, 1008, 1024, 1500, 3000, 64),
     (16, 16, 16, 16, 16, 16, 9, 0), 0, 0.0),
    (8, 16, 1024, 16, 1, 256, (0, 16, 208, 1008, 1024, 1500, 3000, 64),
     (16, 16, 16, 16, 16, 16, 9, 0), 2048, 0.0),
    (2, 80, 100, 6, 2, 64, (30, 250), (80, 41), 0, 0.0),
    (3, 16, 1024, 8, 2, 128, (0, 37, 500), (16, 16, 7), 300, 20.0),
]
WIDE_IDS = ["main_path", "hybrid_path", "chunk_wider_than_tile",
            "short_history_window_softcap"]


def bf16_case(cuda, B, C, W, Hq, Hkv, dh, pos, nt, window, softcap, seed):
    """Runs the bf16 route once; returns (out, plain version's out)."""
    args = to_torch(make_inputs(B, C, W, Hq, Hkv, dh, seed=seed), pos, nt,
                    "bfloat16", device=cuda)
    fn = ops.ring_chunk_attention
    before = (fn.launches, fn.wgmma_launches)
    got = fn(*args, window=window, softcap=softcap)
    torch.cuda.synchronize()
    assert (fn.launches, fn.wgmma_launches) == (before[0] + 1, before[1] + 1)
    return got, ref.ring_chunk_attention_ref(*args, window=window,
                                             softcap=softcap)


@pytest.mark.gpu
@pytest.mark.parametrize(
    "B,C,W,Hq,Hkv,dh,pos,nt,window,softcap",
    [g[:10] for g in RING_SWEEP] + WIDE, ids=IDS + WIDE_IDS)
def test_bf16_route_vs_plain(cuda, B, C, W, Hq, Hkv, dh, pos, nt, window,
                             softcap):
    """Every geometry in bf16 on the tensor-core route, every row (active
    or not) against the plain version within 2e-2 plus 2e-2 of |plain|;
    a row with no visible key is exactly 0."""
    got, want = bf16_case(cuda, B, C, W, Hq, Hkv, dh, pos, nt, window,
                          softcap, seed=B * 31 + C)
    assert got.dtype == torch.bfloat16 and got.shape == want.shape
    assert torch.isfinite(got.float()).all()
    np.testing.assert_allclose(got.float().cpu().numpy(),
                               want.float().cpu().numpy(),
                               rtol=TOL["bfloat16"], atol=TOL["bfloat16"])
    for b in range(B):
        if pos[b] == 0 and nt[b] == 0:
            assert (got[b] == 0).all(), f"idle stream {b} is not 0"


@pytest.mark.gpu
def test_bf16_reruns_are_bit_identical(cuda):
    """The splits merge in a fixed order: two runs on the same input give
    the same bits."""
    args = to_torch(make_inputs(8, 16, 1024, 32, 8, 128, seed=3),
                    WIDE[0][6], WIDE[0][7], "bfloat16", device=cuda)
    a = ops.ring_chunk_attention(*args)
    b = ops.ring_chunk_attention(*args)
    torch.cuda.synchronize()
    assert torch.equal(a, b)


@pytest.mark.gpu
def test_bf16_takes_strided_views_and_refuses_misaligned_ones(cuda):
    """q, k_new and v_new as head views of one fused buffer run as they
    are; a ring view 8 bytes off a 16-byte boundary raises before any
    launch (no copy is made)."""
    B, C, W, Hq, Hkv, dh, pos, nt = 2, 6, 40, 8, 2, 64, (9, 50), (6, 3)
    rng = np.random.default_rng(4)
    qkv = torch.from_numpy(rng.standard_normal(
        (B, C, Hq + 2 * Hkv, dh)).astype(np.float32)).to(cuda, torch.bfloat16)
    q, k_new, v_new = qkv.split([Hq, Hkv, Hkv], dim=2)
    ring = torch.from_numpy(rng.standard_normal(
        (2, B, W, Hkv, dh)).astype(np.float32)).to(cuda, torch.bfloat16)
    p = torch.tensor(pos, dtype=torch.int32, device=cuda)
    n = torch.tensor(nt, dtype=torch.int32, device=cuda)
    got = ops.ring_chunk_attention(q, k_new, v_new, ring[0], ring[1], p, n)
    want = ref.ring_chunk_attention_ref(q, k_new, v_new, ring[0], ring[1],
                                        p, n)
    np.testing.assert_allclose(got.float().cpu().numpy(),
                               want.float().cpu().numpy(),
                               rtol=TOL["bfloat16"], atol=TOL["bfloat16"])
    flat = torch.zeros(ring[0].numel() + 4, dtype=torch.bfloat16,
                       device=cuda)
    bad = flat[4:].view(ring[0].shape)
    before = ops.ring_chunk_attention.launches
    with pytest.raises(ValueError, match="k_cache.*TMA"):
        ops.ring_chunk_attention(q, k_new, v_new, bad, ring[1], p, n)
    assert ops.ring_chunk_attention.launches == before
