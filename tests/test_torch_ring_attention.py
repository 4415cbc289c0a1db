"""The port's ring-chunk attention (``repro_torch.kernels.flash_attention``)
against the JAX package, on the ``RING_SWEEP`` geometries of
``tests/test_kernels.py``.

On the CPU ``ops.ring_chunk_attention`` computes its plain version
(``ref.py``); it must match the JAX Pallas kernel in interpret mode and
the JAX dense ``chunk_attention`` on active rows (t < n_tokens), to 5e-5
in float32 and 2e-2 in bfloat16 (the tolerances of the JAX kernel tests).
A row with no visible key — an idle stream at position 0 — is exactly 0.

The CUDA kernel itself runs only on a card: its comparison with the plain
version on these geometries is ``test_torch_ring_kernel_gpu.py``."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention.ops import ring_chunk_attention as j_ring
from repro.models.layers import chunk_attention as j_chunk_attention
from repro_torch.kernels.flash_attention import ops
from test_torch_ring_kernel_gpu import IDS, RING_SWEEP, TOL, active_close, \
    make_inputs, to_torch


def _to_jax(arrays, pos, nt, dtype):
    dt = getattr(jnp, dtype)
    return [jnp.asarray(a, dt) for a in arrays] \
        + [jnp.asarray(pos, jnp.int32), jnp.asarray(nt, jnp.int32)]


@pytest.mark.parametrize(
    "B,C,W,Hq,Hkv,dh,pos,nt,window,softcap,bq,bkv,dtype", RING_SWEEP,
    ids=IDS)
def test_plain_matches_jax(B, C, W, Hq, Hkv, dh, pos, nt, window, softcap,
                           bq, bkv, dtype):
    arrays = make_inputs(B, C, W, Hq, Hkv, dh, seed=B * 31 + C)
    jin = _to_jax(arrays, pos, nt, dtype)
    got = ops.ring_chunk_attention(*to_torch(arrays, pos, nt, dtype),
                                   window=window, softcap=softcap)
    assert got.dtype == getattr(torch, dtype) and got.shape == (B, C, Hq, dh)
    got = got.float().numpy()
    tol = TOL[dtype]
    kernel = j_ring(*jin, window=window, softcap=softcap, block_q=bq,
                    block_kv=bkv, interpret=True)
    active_close(got, kernel, nt, tol, "vs JAX ring kernel (interpret)")
    dense = j_chunk_attention(*jin, window=window, softcap=softcap)
    active_close(got, dense, nt, tol, "vs JAX dense chunk_attention")
    assert np.isfinite(got).all()
    for b in range(B):
        if pos[b] == 0 and nt[b] == 0:      # no visible key at all
            assert (got[b] == 0).all(), f"idle stream {b} is not 0"


def test_dense_route_is_the_plain_version():
    """``layers.chunk_attention(kernel="dense")`` and the CPU route of
    ``kernel="blocked"`` are one function, bit for bit."""
    from repro_torch.models import layers
    arrays = make_inputs(2, 6, 8, 4, 2, 16, seed=3)
    args = to_torch(arrays, (13, 0), (6, 0), "float32")
    a = layers.chunk_attention(*args, kernel="dense", window=5, softcap=20.0)
    b = layers.chunk_attention(*args, kernel="blocked", window=5,
                               softcap=20.0)
    assert torch.equal(a, b)
    assert (b[1] == 0).all()


def test_cpu_route_launches_no_kernel():
    before = ops.ring_chunk_attention.launches
    arrays = make_inputs(1, 4, 8, 2, 1, 16, seed=4)
    ops.ring_chunk_attention(*to_torch(arrays, (5,), (4,), "float32"))
    assert ops.ring_chunk_attention.launches == before
