"""The ring-chunk CUDA kernel against its plain PyTorch version, on the
card, on the ``RING_SWEEP`` geometries of ``tests/test_kernels.py`` and on
head dim 256 over one kv head (recurrentgemma's local attention).

The kernel has no CPU mode, so the test is marked ``gpu`` and skips where
no CUDA device is visible.  This file imports neither JAX nor the JAX
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
    before = ops.ring_chunk_attention.launches
    got = ops.ring_chunk_attention(*args, window=window, softcap=softcap)
    torch.cuda.synchronize()
    assert ops.ring_chunk_attention.launches == before + 1
    assert got.dtype == args[0].dtype and got.shape == args[0].shape
    want = ref.ring_chunk_attention_ref(*args, window=window, softcap=softcap)
    active_close(got.float().cpu(), want.float().cpu(), nt, TOL[dtype],
                 "CUDA kernel vs plain")
    for b in range(B):
        if pos[b] == 0 and nt[b] == 0:      # no visible key at all
            assert (got[b] == 0).all(), f"idle stream {b} is not 0"
