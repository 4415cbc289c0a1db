"""The host side of the bf16 ring-chunk kernel, on the CPU.

* ``ref.ring_chunk_attention_split_ref`` computes the ring attention the
  way the kernel does — a partial per split of the keys, then a
  log-sum-exp merge in split order — and must equal the plain
  ``ring_chunk_attention_ref`` for every split width (ring split counts 1
  to W) on every ``RING_SWEEP`` geometry, in float32 to 1e-5 (the two
  differ only in the order of float32 sums).  All-empty splits and idle
  rows give 0, never NaN.
* ``ops.ring_split``, the kernel's split count, is a function of the
  shapes alone.
* ``ops.ring_tma_strides``: the wrapper's layout check on the five ring
  tensors passes aligned layouts and raises, naming the tensor, on a
  misaligned view.

The kernel itself runs only on a card: ``test_torch_ring_kernel_gpu.py``."""
import inspect

import numpy as np
import pytest
import torch

from repro_torch.kernels.flash_attention import ops, ref
from test_torch_ring_kernel_gpu import IDS, RING_SWEEP, make_inputs, to_torch

SPLIT_TOL = 1e-5


@pytest.mark.parametrize(
    "B,C,W,Hq,Hkv,dh,pos,nt,window,softcap,bq,bkv,dtype", RING_SWEEP,
    ids=IDS)
def test_split_merge_matches_plain(B, C, W, Hq, Hkv, dh, pos, nt, window,
                                   softcap, bq, bkv, dtype):
    args = to_torch(make_inputs(B, C, W, Hq, Hkv, dh, seed=B * 31 + C), pos,
                    nt, "float32")
    want = ref.ring_chunk_attention_ref(*args, window=window, softcap=softcap)
    for width in range(1, W + 1):            # W ring splits down to one
        got = ref.ring_chunk_attention_split_ref(
            *args, split_slots=width, window=window, softcap=softcap)
        assert torch.isfinite(got).all(), f"split width {width}"
        np.testing.assert_allclose(got.numpy(), want.numpy(),
                                   rtol=SPLIT_TOL, atol=SPLIT_TOL,
                                   err_msg=f"split width {width}")
        for b in range(B):
            if pos[b] == 0 and nt[b] == 0:   # every split empty
                assert (got[b] == 0).all(), f"idle stream {b} is not 0"


def test_split_merge_of_empty_splits_is_zero():
    """A short history in a wide ring: most ring splits see nothing, an
    idle stream sees nothing at all, and a stream with no chunk tokens
    sees only its ring; no NaN, and rows with no visible key are 0."""
    B, C, W, Hq, Hkv, dh = 3, 4, 64, 4, 2, 16
    args = to_torch(make_inputs(B, C, W, Hq, Hkv, dh, seed=5), (3, 0, 9),
                    (4, 0, 0), "float32")
    want = ref.ring_chunk_attention_ref(*args)
    got = ref.ring_chunk_attention_split_ref(*args, split_slots=8)
    assert torch.isfinite(got).all()
    assert (got[1] == 0).all()
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=SPLIT_TOL,
                               atol=SPLIT_TOL)


# B, C, W, Hq, Hkv -> (tiles a ring split walks, splits)
SPLITS = {
    "main_path": ((8, 16, 1024, 32, 8), (4, 5)),      # llama3-8b serving
    "hybrid_path": ((8, 16, 1024, 16, 1), (4, 5)),    # recurrentgemma-9b
    "one_stream": ((1, 16, 1024, 32, 8), (4, 5)),
    "small_ring": ((2, 6, 8, 4, 4), (1, 2)),
    "long_ring": ((1, 16, 8192, 8, 1), (4, 33)),   # two groups: many splits
}


def test_split_count_is_a_function_of_shapes_alone():
    """No argument of ``ring_split`` is data: pos and n_tokens stay on the
    card, so the split count never costs a host read."""
    assert list(inspect.signature(ops.ring_split).parameters) == \
        ["B", "C", "W", "Hq", "Hkv"]


@pytest.mark.parametrize("case", sorted(SPLITS))
def test_split_count(case):
    shape, want = SPLITS[case]
    assert ops.ring_split(*shape) == want


@pytest.mark.parametrize("W", [1, 8, 63, 64, 65, 200, 1024, 4096, 32768])
@pytest.mark.parametrize("B,C,Hq,Hkv", [(1, 1, 1, 1), (8, 16, 32, 8),
                                        (3, 10, 24, 8), (64, 64, 16, 1)])
def test_splits_cover_the_ring(W, B, C, Hq, Hkv):
    """The ring splits cover every tile of the ring once, none is empty of
    tiles, and a split walks at least ``RING_SPLIT_TILES`` tiles where the
    ring has them."""
    tiles = -(-W // ops.RING_TILE)
    per, n = ops.ring_split(B, C, W, Hq, Hkv)
    assert (n - 1) * per >= tiles > (n - 2) * per
    assert per >= min(ops.RING_SPLIT_TILES, tiles)


def ring_tensors(B=2, C=6, W=40, Hq=8, Hkv=2, dh=64):
    """The five ring tensors as bf16 views: q, k_new and v_new head views
    of one fused qkv buffer (aligned, strided), the ring contiguous."""
    qkv = torch.zeros(B, C, Hq + 2 * Hkv, dh, dtype=torch.bfloat16)
    q, k_new, v_new = qkv.split([Hq, Hkv, Hkv], dim=2)
    ring = torch.zeros(2, B, W, Hkv, dh, dtype=torch.bfloat16)
    return [q, k_new, v_new, ring[0], ring[1]]


def test_ring_tma_strides_pass_aligned_views():
    q, k_new, v_new, k_cache, v_cache = ring_tensors()
    fused = (6 * 12 * 64, 12 * 64, 64)
    assert ops.ring_tma_strides(q, k_new, v_new, k_cache, v_cache) == \
        fused * 3 + (40 * 2 * 64, 2 * 64, 64) * 2


@pytest.mark.parametrize("which", range(5))
def test_ring_tma_strides_refuse_a_misaligned_view(which):
    """A view 4 elements (8 bytes) into its buffer, and a head-dim slice of
    a wider buffer (a 65-element head stride), each raise naming the
    tensor: the wrapper copies nothing."""
    names = ("q", "k_new", "v_new", "k_cache", "v_cache")
    tensors = ring_tensors()
    t = tensors[which]
    flat = torch.zeros(t.numel() + 4, dtype=t.dtype)
    tensors[which] = flat[4:].view(t.shape)
    with pytest.raises(ValueError, match=f"{names[which]}.*TMA"):
        ops.ring_tma_strides(*tensors)
    tensors = ring_tensors()
    wide = torch.zeros(*t.shape[:3], t.shape[3] + 1, dtype=t.dtype)
    tensors[which] = wide[..., :t.shape[3]]
    with pytest.raises(ValueError, match=f"{names[which]}.*head stride"):
        ops.ring_tma_strides(*tensors)


def test_cpu_route_counts_no_launch():
    """On CPU tensors the wrapper runs the plain version: neither count
    moves, bf16 or float32."""
    fn = ops.ring_chunk_attention
    before = (fn.launches, fn.wgmma_launches)
    for dtype in ("float32", "bfloat16"):
        args = to_torch(make_inputs(2, 4, 8, 4, 2, 16, seed=1), (3, 9),
                        (4, 2), dtype)
        fn(*args)
    assert (fn.launches, fn.wgmma_launches) == before
