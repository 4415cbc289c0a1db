"""The host side of the one-pass RG-LRU scan kernel, on the CPU.

* ``ref.lru_scan_single_pass_ref`` computes the scan in the kernel's
  arithmetic — chunk-local aggregates, the carry folded from ``h0`` in
  chunk order, the re-run from the carry — and must agree with the JAX
  Pallas kernel ``lru_scan`` in interpret mode (tolerance 1e-5, the JAX
  package's ``test_lru_scan``) on ``LRU_SWEEP``, ragged S and W and one
  chunk, forward and reverse, from zero and from ``h0``, for every chunk
  length of the tiles ``ops.LRU_TILE_SWEEP`` holds.  The Pallas kernel
  takes neither ``h0`` nor ``reverse``: ``h0`` enters as a leading step
  (a 0, b h0) and reverse as flipped inputs.
* ``ref.lru_vjp_plain`` and ``ops.lru``'s CPU gradients against
  ``jax.vjp`` of the JAX ``lru`` (interpret mode), tolerance 1e-4.
* The tile (``ops.LRU_TILE``), ``ops.lru_workspace`` and
  ``ops.lru_vec_loads`` are functions of shapes and addresses alone.
* A CPU call counts no launch.

The kernel itself runs only on a card: ``test_torch_lru_kernel_gpu.py``."""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.rglru_scan.kernel import lru_scan as j_lru_scan
from repro.kernels.rglru_scan.ops import lru as j_lru
from repro_torch.kernels.rglru_scan import ops, ref

GEOS = [
    # B, S, W: tests/test_kernels.py's LRU_SWEEP
    (2, 128, 64), (1, 64, 128), (3, 32, 16), (1, 256, 32),
    (2, 100, 300), (3, 65, 33),       # ragged S and W
    (8, 16, 512),                     # one chunk: the serving chunk step
]
IDS = [f"B{b}_S{s}_W{w}" for b, s, w in GEOS]
CHUNKS = sorted({T for T, _ in ops.LRU_TILE_SWEEP})
TOL, GRAD_TOL = 1e-5, 1e-4


def inputs(B, S, W, seed):
    """a in (0, 1) (a sigmoid of a normal, as the JAX LRU test draws it),
    b and a carried state."""
    rng = np.random.default_rng(seed)
    a = 1.0 / (1.0 + np.exp(-rng.standard_normal((B, S, W))))
    return (a.astype(np.float32),
            rng.standard_normal((B, S, W)).astype(np.float32),
            rng.standard_normal((B, W)).astype(np.float32))


@functools.lru_cache(maxsize=None)
def pallas(geo, reverse, carried):
    """(h, h_final) of the JAX Pallas kernel in interpret mode, as numpy:
    h0 as a leading step (a 0, b h0), reverse as flipped inputs."""
    B, S, W = geo
    a, b, h0 = inputs(B, S, W, seed=S + W)
    if reverse:
        a, b = a[:, ::-1], b[:, ::-1]
    if carried:
        a = np.concatenate([np.zeros((B, 1, W), np.float32), a], 1)
        b = np.concatenate([h0[:, None], b], 1)
    h = np.asarray(j_lru_scan(jnp.asarray(a), jnp.asarray(b),
                              block_s=a.shape[1], block_w=W, interpret=True))
    h = h[:, 1:] if carried else h
    fin = h[:, -1]
    return (h[:, ::-1] if reverse else h), fin


@pytest.mark.parametrize("T", CHUNKS, ids=[f"T{t}" for t in CHUNKS])
@pytest.mark.parametrize("geo", GEOS, ids=IDS)
def test_single_pass_ref_matches_the_pallas_kernel(geo, T):
    B, S, W = geo
    a, b, h0 = (torch.from_numpy(x) for x in inputs(B, S, W, seed=S + W))
    for reverse in (False, True):
        for carried in (False, True):
            want_h, want_fin = pallas(geo, reverse, carried)
            h, fin = ref.lru_scan_single_pass_ref(
                a, b, h0 if carried else None, reverse=reverse, T=T)
            what = f"reverse={reverse} h0={carried}"
            np.testing.assert_allclose(h.numpy(), want_h, rtol=TOL,
                                       atol=TOL, err_msg="h, " + what)
            np.testing.assert_allclose(fin.numpy(), want_fin, rtol=TOL,
                                       atol=TOL, err_msg="h_final, " + what)


@pytest.mark.parametrize("T", CHUNKS, ids=[f"T{t}" for t in CHUNKS])
def test_single_pass_ref_over_many_chunks(T):
    """Many chunks (S 4096: 32 to 256 of them) against the step-by-step
    plain version, from h0, both ways."""
    a, b, h0 = (torch.from_numpy(x) for x in inputs(1, 4096, 8, seed=T))
    for reverse in (False, True):
        got = ref.lru_scan_single_pass_ref(a, b, h0, reverse=reverse, T=T)
        want = ref.lru_scan_plain(a, b, h0, reverse=reverse)
        for x, y in zip(got, want):
            np.testing.assert_allclose(x.numpy(), y.numpy(), rtol=TOL,
                                       atol=TOL)


@pytest.mark.parametrize("geo", [(2, 64, 32), (2, 128, 64), (3, 65, 33)],
                         ids=["B2_S64_W32", "B2_S128_W64", "B3_S65_W33"])
def test_vjp_matches_jax(geo):
    """``lru_vjp_plain`` (the CPU route of ``ops._lru_vjp``) and
    ``ops.lru``'s backward against ``jax.vjp`` of the JAX ``lru`` for a
    random cotangent, in a and in b."""
    B, S, W = geo
    a, b, _ = inputs(B, S, W, seed=2 * S + W)
    g = np.random.default_rng(S).standard_normal((B, S, W)).astype(
        np.float32)
    h, vjp = jax.vjp(lambda a, b: j_lru(a, b, S, W, True), jnp.asarray(a),
                     jnp.asarray(b))
    want_da, want_db = (np.asarray(x) for x in vjp(jnp.asarray(g)))
    da, db = ref.lru_vjp_plain(torch.from_numpy(a), torch.from_numpy(g),
                               torch.from_numpy(np.array(h)))
    ta = torch.from_numpy(a).requires_grad_(True)
    tb = torch.from_numpy(b).requires_grad_(True)
    ops.lru(ta, tb).backward(torch.from_numpy(g))
    for name, got, want in (("da", da, want_da), ("db", db, want_db),
                            ("ops.lru da", ta.grad, want_da),
                            ("ops.lru db", tb.grad, want_db)):
        np.testing.assert_allclose(got.numpy(), want, rtol=GRAD_TOL,
                                   atol=GRAD_TOL, err_msg=name)


@pytest.mark.parametrize("shape", [(1, 4096, 4096), (8, 16, 4096),
                                   (8, 1, 4096), (1, 32768, 64),
                                   (3, 65, 33), (2, 100, 300)],
                         ids=["training", "serving_chunk", "decode",
                              "many_chunks", "ragged", "ragged_wide"])
def test_tiles_and_workspace_from_shapes(shape):
    """The tile fits the kernel (for the VJP too); a sequence of at most T
    steps is one chunk (the direct path) with no workspace; else a
    workspace of P, E and carry per (batch, chunk, padded channel), a flag
    per block and the ticket."""
    B, S, W = shape
    T, Wt = ops.LRU_TILE
    assert ops.tile_fits(T, Wt, S, vjp=True)
    nc, ntiles = -(-S // T), -(-W // Wt)
    words = ops.lru_workspace(B, S, W, T, Wt)
    if S <= T:
        assert nc == 1 and words == 0
    else:
        assert words == 3 * B * nc * ntiles * Wt + B * ntiles * nc + 1
    if shape == (1, 4096, 4096):
        # P, E and the carry: 6 MiB of floats; a flag per item and the
        # ticket, which the call's memset zeroes
        assert words * 4 == 3 * nc * 4096 * 4 + (nc * ntiles + 1) * 4


def test_every_swept_tile_fits():
    assert ops.LRU_TILE in ops.LRU_TILE_SWEEP
    for T, Wt in ops.LRU_TILE_SWEEP:
        assert ops.tile_fits(T, Wt, 4096, vjp=True), (T, Wt)
    assert not ops.tile_fits(128, 512, 4096, vjp=False)   # 512 KiB
    assert not ops.tile_fits(32, 1024, 4096, vjp=False)   # > 128 threads
    assert not ops.tile_fits(32, 130, 4096, vjp=False)    # not 4-wide


def test_vec_loads_from_addresses():
    assert ops.lru_vec_loads(4096, [0, 256, 1 << 20, None])
    assert not ops.lru_vec_loads(4098, [0, 256])           # W % 4
    assert not ops.lru_vec_loads(4096, [0, 260])           # base + 4 bytes
    assert not ops.lru_vec_loads(33, [0, None])


def test_cpu_calls_count_no_launch():
    a, b, h0 = (torch.from_numpy(x) for x in inputs(2, 70, 12, seed=1))
    before = ops.lru_scan.launches
    h, _ = ops.lru_scan(a, b, h0, reverse=True)
    ops._lru_vjp(a, b, h)
    ta = a.clone().requires_grad_(True)
    ops.lru(ta, b).sum().backward()
    assert ops.lru_scan.launches == before
