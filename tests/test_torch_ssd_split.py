"""The host side of the bf16 SSD scan kernel, on the CPU.

* ``ref.ssd_scan_split_ref`` computes the SSD scan in the kernel's
  arithmetic — B and C exact bf16, every float32 operand (the
  decay-weighted scores, xdt, the carried state) split in two bf16 parts,
  lo·lo dropped, float32 sums.  It must agree with the JAX Pallas kernel
  in interpret mode on the ``SSD_SWEEP`` geometries and on more groups
  and ragged tiles (3e-4, the JAX package's float32 ``ssd_scan``
  tolerance, on the same bf16 B/C), and with the plain version within
  2e-3 at a training-like shape (S 2048, P 64, N 128, chunk 256), where
  the same function with xdt rounded to one bf16 is off by more than
  2e-3: the bound can tell the two apart.
* ``ops.ssd_route``, ``ops.ssd_head_sets`` and ``ops.ssd_bc_loads``, the
  kernel's route, head sets and B/C load width, are functions of dtypes,
  shapes and addresses alone.

The kernel itself runs only on a card: ``test_torch_ssd_kernel_gpu.py``."""
import inspect

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.ssd_scan.kernel import ssd_scan as j_ssd_scan
from repro_torch.kernels.ssd_scan import ops, ref

# B, S, H, P, G, N, chunk: tests/test_kernels.py's SSD_SWEEP, then two
# groups at full head size and three groups with ragged row and column
# tiles
GEOS = [(2, 64, 4, 16, 1, 32, 16), (1, 32, 4, 8, 2, 16, 32),
        (2, 128, 2, 32, 1, 8, 64), (1, 512, 4, 64, 2, 128, 256),
        (2, 300, 6, 80, 3, 20, 100)]
IDS = [f"B{b}_S{s}_H{h}_P{p}_G{g}_N{n}_Q{q}" for b, s, h, p, g, n, q in GEOS]
JAX_TOL = 3e-4
# the bf16 route's bound against the plain version at the training shape
SPLIT_TOL = 2e-3


def head_major_inputs(B, S, H, P, G, N, seed):
    """xdt, a, B, C in the kernel's head-major layout, drawn as the JAX
    package's ssd_scan test draws x, dt, A, B, C; B and C rounded to bf16
    (the model path's dtype)."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, S, H, P)).astype(np.float32)
    dt = np.log1p(np.exp(rng.standard_normal((B, S, H)) - 1.0)) \
        .astype(np.float32)
    A = (-np.exp(rng.standard_normal(H) * 0.3)).astype(np.float32)
    Bm = (rng.standard_normal((B, S, G, N)) * 0.5).astype(np.float32)
    Cm = (rng.standard_normal((B, S, G, N)) * 0.5).astype(np.float32)
    xdt = (x * dt[..., None]).transpose(0, 2, 1, 3).reshape(B * H, S, P)
    a = (dt * A).transpose(0, 2, 1).reshape(B * H, S)

    def hm(m):
        return torch.from_numpy(np.ascontiguousarray(
            m.transpose(0, 2, 1, 3).reshape(B * G, S, N))).to(torch.bfloat16)

    return (torch.from_numpy(np.ascontiguousarray(xdt)),
            torch.from_numpy(np.ascontiguousarray(a)), hm(Bm), hm(Cm))


def max_err(got, want):
    return float((got - want).abs().max())


@pytest.mark.parametrize("geo", GEOS, ids=IDS)
def test_split_ref_matches_the_pallas_kernel(geo):
    B, S, H, P, G, N, chunk = geo
    xdt, a, Bh, Ch = head_major_inputs(B, S, H, P, G, N, seed=S + N)
    kw = dict(chunk=chunk, hq_per_group=H // G)
    jy, jh = j_ssd_scan(jnp.asarray(xdt.numpy()), jnp.asarray(a.numpy()),
                        jnp.asarray(Bh.float().numpy(), jnp.bfloat16),
                        jnp.asarray(Ch.float().numpy(), jnp.bfloat16),
                        interpret=True, **kw)
    y, h = ref.ssd_scan_split_ref(xdt, a, Bh, Ch, **kw)
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), rtol=JAX_TOL,
                               atol=JAX_TOL, err_msg="y")
    np.testing.assert_allclose(h.numpy(), np.asarray(jh), rtol=JAX_TOL,
                               atol=JAX_TOL, err_msg="h_final")


@pytest.fixture(scope="module")
def training_like():
    """B 1, S 2048, 8 heads of 64 over one group, N 128, chunk 256: the
    plain version and the inputs."""
    ins = head_major_inputs(1, 2048, 8, 64, 1, 128, seed=17)
    kw = dict(chunk=256, hq_per_group=8)
    return ins, kw, ref.ssd_scan_plain(*ins, **kw)


def test_split_ref_within_the_bound_of_plain(training_like):
    (xdt, a, Bh, Ch), kw, (want_y, want_h) = training_like
    y, h = ref.ssd_scan_split_ref(xdt, a, Bh, Ch, **kw)
    assert max_err(y, want_y) <= SPLIT_TOL
    assert max_err(h, want_h) <= SPLIT_TOL


def test_one_bf16_part_exceeds_the_bound(training_like):
    """The negative control: xdt rounded to one bf16 (its lo part 0) is
    off by more than the bound, so the bound checks the split."""
    (xdt, a, Bh, Ch), kw, (want_y, _) = training_like
    y, _ = ref.ssd_scan_split_ref(xdt.to(torch.bfloat16).float(), a, Bh, Ch,
                                  **kw)
    assert max_err(y, want_y) > SPLIT_TOL


def test_route_follows_the_dtype_of_b_and_c():
    assert ops.ssd_route(torch.zeros(1, 2, 16, dtype=torch.bfloat16)) == \
        "wgmma"
    assert ops.ssd_route(torch.zeros(1, 2, 16)) == "fma"


def test_head_sets_are_a_function_of_shapes_alone():
    assert list(inspect.signature(ops.ssd_head_sets).parameters) == \
        ["BG", "S", "Q", "P", "G"]


# BG, S, Q, P, G -> (state kernel's heads a block, scan kernel's)
HEAD_SETS = {
    "main_path": ((4, 2048, 256, 64, 48), (3, 12)),   # mamba2-780m, B 4
    "batch_1": ((1, 2048, 256, 64, 48), (1, 3)),
    "groups_2": ((4, 512, 256, 64, 4), (1, 1)),
    "long_sequence": ((4, 8192, 256, 64, 48), (12, 24)),
    "wide_heads": ((4, 2048, 256, 80, 48), (6, 12)),
}


@pytest.mark.parametrize("case", sorted(HEAD_SETS))
def test_head_sets(case):
    shape, want = HEAD_SETS[case]
    assert ops.ssd_head_sets(*shape) == want


@pytest.mark.parametrize("G", [1, 2, 7, 48, 96])
@pytest.mark.parametrize("BG,S,Q,P", [(1, 64, 64, 16), (4, 2048, 256, 64),
                                      (2, 300, 100, 80), (16, 4096, 128, 64)])
def test_head_sets_cover_every_head(BG, S, Q, P, G):
    """Every head of a group is in one set of each kernel, and the sets
    fill about ``SSD_TARGET_BLOCKS`` blocks where the heads allow."""
    for kind, heads in zip(("state", "scan"),
                           ops.ssd_head_sets(BG, S, Q, P, G)):
        assert 1 <= heads <= G, kind
        sets = -(-G // heads)
        assert (sets - 1) * heads < G <= sets * heads, kind
        tiles = -(-P // 64) if kind == "state" else -(-Q // 64)
        units = BG * (S // Q) * tiles
        assert units * sets >= min(ops.SSD_TARGET_BLOCKS, units * G) / 2, \
            kind


# N, byte offsets of B's and C's bases -> 0 (TMA) or the load width
BC_LOADS = [
    (128, (0, 0), 0), (16, (0, 256), 0), (256, (0, 0), 0),
    (20, (0, 0), 4),          # 40-byte rows: 8-byte loads
    (8, (0, 0), 8),           # 16-byte rows, but no padded size of 8
    (48, (0, 0), 8),
    (128, (0, 8), 4),         # a view 4 elements into its buffer
    (128, (2, 0), 1),         # 2 bytes off: single elements
    (20, (4, 0), 2),
    (7, (0, 0), 1),
]


@pytest.mark.parametrize("N,offsets,want", BC_LOADS)
def test_bc_loads(N, offsets, want):
    base = 1 << 20
    assert ops.ssd_bc_loads(N, tuple(base + o for o in offsets)) == want


def test_bc_loads_of_torch_views():
    """The load width of real tensors: a fresh contiguous (BG, S, N) bf16
    tensor goes by TMA at N 128; a view one row into it still does; a view
    one element into it falls back to plain loads of one element."""
    buf = torch.zeros(2 * 64 * 128 + 8, dtype=torch.bfloat16)
    whole = buf[:2 * 64 * 128].view(2, 64, 128)
    row = buf[128:128 + 64 * 128].view(1, 64, 128)
    elem = buf[1:1 + 64 * 128].view(1, 64, 128)
    for t, want in ((whole, 0), (row, 0), (elem, 1)):
        assert ops.ssd_bc_loads(128, (t.data_ptr(), t.data_ptr())) == want


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cpu_route_counts_no_launch(dtype):
    """On CPU tensors the wrapper runs the plain version: neither count
    moves."""
    fn = ops.ssd_scan
    before = (fn.launches, fn.wgmma_launches)
    xdt, a, Bh, Ch = head_major_inputs(1, 64, 2, 16, 1, 16, seed=3)
    if dtype == "float32":
        Bh, Ch = Bh.float(), Ch.float()
    y, h = fn(xdt, a, Bh, Ch, chunk=32, hq_per_group=2)
    want_y, want_h = ref.ssd_scan_plain(xdt, a, Bh, Ch, chunk=32,
                                        hq_per_group=2)
    assert torch.equal(y, want_y) and torch.equal(h, want_h)
    assert (fn.launches, fn.wgmma_launches) == before
