"""The port's launch tooling against the JAX package's, on the CPU.

``launch.inputs.input_specs`` (shapes, types and ``PartitionSpec``s of
every input leaf, the decode cache's included) and
``launch.analysis.analytic_hbm_bytes`` equal JAX's on every architecture,
applicable shape and production mesh; the JAX side runs in this process
on ``jax.sharding.AbstractMesh``es (no placeholder devices needed).  Then
the pieces of the dry run: the kernel wrappers' dry branch (shapes,
types, one noted launch, nothing built, ``launches`` untouched), the dry
``MeshComm``, the counting context ``trace_analysis.Trace``, the roofline
with the card's rates, the optimizer's step count on a dry state, and the
serving steps' ``gather_specs`` (on a one-rank mesh the same logits and
cache as without, and JAX's within ``test_torch_prefill.py``'s
tolerances)."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import AbstractMesh
from torch._subclasses.fake_tensor import FakeTensorMode

from repro.configs import REGISTRY as J_REGISTRY
from repro.configs import SHAPES as J_SHAPES
from repro.configs import reduced_config as j_reduced
from repro.configs import shape_applicable as j_applicable
from repro.launch import analysis as JA
from repro.launch import inputs as JI
from repro.launch import sharding as JSH
from repro.launch import steps as JS
from repro.models.params import init_params as j_init_params
from repro_torch.configs import ARCH_IDS, SHAPES
from repro_torch.configs import REGISTRY as T_REGISTRY
from repro_torch.configs import reduced_config as t_reduced
from repro_torch.kernels import build, dry
from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.kernels.rglru_scan import ops as lru_ops
from repro_torch.kernels.ssd_scan import ops as ssd_ops
from repro_torch.launch import analysis as TA
from repro_torch.launch import inputs as TI
from repro_torch.launch import sharding as TSH
from repro_torch.launch import steps as TS
from repro_torch.launch import trace_analysis as ta
from repro_torch.launch.mesh import Mesh, make_production_mesh
from repro_torch.models import decode as TD
from repro_torch.models.params import _leaves as t_param_leaves
from repro_torch.models.params import from_reference
from repro_torch.optim.adamw import step_count

LOGIT_TOL, CACHE_TOL = 1e-4, 2e-4      # test_torch_prefill.py's
DTYPES = {"int32": torch.int32, "float32": torch.float32,
          "bfloat16": torch.bfloat16}
J_MESHES = {"pod1": AbstractMesh((16, 16), ("data", "model")),
            "pod2": AbstractMesh((2, 16, 16), ("pod", "data", "model"))}


def _entry(e):
    """A spec entry as a comparable value: None, a name or a tuple."""
    if e is None or e == ():
        return None
    if isinstance(e, tuple):
        return e[0] if len(e) == 1 else tuple(e)
    return e


def _spec(spec):
    return None if spec is None else tuple(_entry(e) for e in spec)


def _j_leaves(tree):
    out = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
        key = tuple(getattr(p, "key", getattr(p, "idx", None)) for p in path)
        sharding = getattr(leaf, "sharding", None)
        out[key] = (tuple(leaf.shape), str(jnp.dtype(leaf.dtype)),
                    _spec(sharding.spec) if sharding is not None else None)
    return out


def _t_leaves(tree, prefix=()):
    out = {}
    if isinstance(tree, dict):
        for k, v in tree.items():
            out.update(_t_leaves(v, prefix + (k,)))
        return out
    return {prefix: (tree.shape, str(tree.dtype).replace("torch.", ""),
                     _spec(tree.spec))}


def _cells(arch):
    for name in SHAPES:
        ok, _ = j_applicable(J_REGISTRY[arch], J_SHAPES[name])
        if ok:
            yield name


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_input_specs_match_jax(arch):
    """Every leaf's shape, type and spec, the decode cache's included, on
    every applicable shape, without a mesh and on both production
    meshes."""
    jcfg, tcfg = J_REGISTRY[arch], T_REGISTRY[arch]
    meshes = {None: (None, None), **{k: (m, make_production_mesh(
        multi_pod=k == "pod2")) for k, m in J_MESHES.items()}}
    n = 0
    for name in _cells(arch):
        for _, (jm, tm) in meshes.items():
            want = _j_leaves(JI.input_specs(jcfg, J_SHAPES[name], jm))
            got = _t_leaves(TI.input_specs(tcfg, SHAPES[name], tm))
            assert got == want, (name, jm)
            n += len(got)
    assert n > 0


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_analytic_hbm_bytes_matches_jax(arch):
    jcfg, tcfg = J_REGISTRY[arch], T_REGISTRY[arch]
    for name in _cells(arch):
        for key, jm in J_MESHES.items():
            tm = make_production_mesh(multi_pod=key == "pod2")
            for mb in (1, 8):
                fsdp = TSH.needs_fsdp(tcfg, SHAPES[name], tm.size,
                                      tm.shape["model"])
                assert fsdp == JSH.needs_fsdp(jcfg, J_SHAPES[name], jm.size,
                                              jm.shape["model"])
                want = JA.analytic_hbm_bytes(jcfg, J_SHAPES[name], jm,
                                             fsdp=fsdp, microbatches=mb)
                got = TA.analytic_hbm_bytes(tcfg, SHAPES[name], tm,
                                            fsdp=fsdp, microbatches=mb)
                assert got == pytest.approx(want, rel=1e-12), (name, key)


def test_abstract_cache_is_init_caches_layout_without_memory():
    cfg = t_reduced(T_REGISTRY["recurrentgemma-9b"])
    a = TD.abstract_cache(cfg, 3, 40)
    z = TD.init_cache(cfg, 3, 40, device="cpu")
    spec = TD.cache_view_specs(cfg, 40)
    for x, y in zip(TD.tree_leaves(a, spec), TD.tree_leaves(z, spec)):
        assert x.device.type == "meta"
        assert (x.shape, x.dtype) == (y.shape, y.dtype)


# ---------------------------------------------------------------------------
# the kernel wrappers' dry branch
# ---------------------------------------------------------------------------

@pytest.fixture
def no_build(monkeypatch):
    """Any attempt to build or load a kernel library fails the test."""
    def refuse(*a, **k):
        raise AssertionError("a dry call reached kernels/build.py")
    monkeypatch.setattr(build, "build", refuse)
    monkeypatch.setattr(build, "load", refuse)


def _dry_calls():
    """(name, the wrapper call on dry tensors, expected output shapes and
    types) of every hand-written kernel's wrapper."""
    bf, f32, i32 = torch.bfloat16, torch.float32, torch.int32

    def e(shape, dtype, dev):
        return torch.empty(shape, dtype=dtype, device=dev)

    def ring(dev):
        return fa_ops.ring_chunk_attention(
            e((2, 16, 8, 128), bf, dev), e((2, 16, 2, 128), bf, dev),
            e((2, 16, 2, 128), bf, dev), e((2, 64, 2, 128), bf, dev),
            e((2, 64, 2, 128), bf, dev), e((2,), i32, dev),
            e((2,), i32, dev))

    def fwd(dev):
        return fa_ops.flash_attention_fwd(
            e((2, 96, 8, 64), bf, dev), e((2, 96, 2, 64), bf, dev),
            e((2, 96, 2, 64), bf, dev))

    def bwd(dev):
        q = e((2, 96, 8, 64), f32, dev)
        return fa_ops.flash_attention_bwd(
            q, e((2, 96, 2, 64), f32, dev), e((2, 96, 2, 64), f32, dev),
            q, e((2, 8, 96), f32, dev), q)

    def ssd(dev):
        return ssd_ops.ssd_scan(e((6, 64, 16), f32, dev), e((6, 64), f32, dev),
                                e((2, 64, 32), bf, dev),
                                e((2, 64, 32), bf, dev), chunk=32,
                                hq_per_group=3)

    def lru(dev):
        return lru_ops.lru_scan(e((2, 200, 64), f32, dev),
                                e((2, 200, 64), f32, dev))

    def vjp(dev):
        a = e((2, 200, 64), f32, dev)
        return lru_ops._lru_vjp(a, a, a)

    return [
        ("ring_chunk_attention", ring, fa_ops.ring_chunk_attention,
         [((2, 16, 8, 128), bf)]),
        ("flash_attention_fwd", fwd, fa_ops.flash_attention,
         [((2, 96, 8, 64), bf), ((2, 8, 96), f32)]),
        ("flash_attention_bwd", bwd, fa_ops.flash_attention_bwd,
         [((2, 96, 8, 64), f32), ((2, 96, 2, 64), f32),
          ((2, 96, 2, 64), f32)]),
        ("ssd_scan", ssd, ssd_ops.ssd_scan,
         [((6, 64, 16), f32), ((6, 32, 16), f32)]),
        ("lru_scan", lru, lru_ops.lru_scan,
         [((2, 200, 64), f32), ((2, 64), f32)]),
        ("lru_scan", vjp, lru_ops.lru_scan,
         [((2, 200, 64), f32), ((2, 200, 64), f32)]),
    ]


@pytest.mark.parametrize("case", range(6))
def test_wrapper_dry_branch(no_build, case):
    """On a fake tensor (on the device the dry run traces here: PyTorch
    without CUDA cannot index a fake ``cuda`` tensor, so ``trace_device``
    gives ``meta``; phase 16 of ``chip_smoke.py`` traces fake ``cuda``
    tensors on the card) each wrapper keeps its checks, launches nothing,
    returns empty outputs of the kernel's shapes and types and notes one
    launch with its needed work; its ``launches`` count (the card's) does
    not move."""
    name, call, wrapper, want = _dry_calls()[case]
    before = wrapper.launches
    seen = []
    with dry.sinks(lambda *a: seen.append(a)), FakeTensorMode():
        out = call(ta.trace_device("cuda"))
    outs = out if isinstance(out, tuple) else (out,)
    assert [(tuple(o.shape), o.dtype) for o in outs] == want
    assert all(dry.is_dry(o) for o in outs)
    assert [s[0] for s in seen] == [name]
    assert seen[0][1] > 0 and seen[0][2] > 0
    assert wrapper.launches == before


def test_dry_branch_keeps_the_checks(no_build):
    e = lambda *s, dt=torch.bfloat16: torch.empty(s, dtype=dt, device="meta")
    with FakeTensorMode():
        _dry_checks(e)


def _dry_checks(e):
    with pytest.raises(ValueError, match="head_dim"):
        fa_ops.flash_attention_fwd(e(1, 8, 2, 24), e(1, 8, 2, 24),
                                   e(1, 8, 2, 24))
    # TMA's stride rule holds on a dry tensor (its base is not checked)
    q = e(1, 8, 4, 64, 2)[..., 0]
    with pytest.raises(ValueError, match="unit head_dim stride"):
        fa_ops.flash_attention_fwd(q, q, q)
    with pytest.raises(TypeError, match="float32"):
        lru_ops.lru_scan(e(1, 4, 8), e(1, 4, 8))


def test_flash_work_pairs():
    """The closed-form visible pairs equal the plain mask's count."""
    from repro_torch.kernels.flash_attention import ref
    for Sq, Skv, causal, window in ((37, 37, True, 0), (37, 37, True, 8),
                                    (16, 40, False, 0), (40, 16, True, 5)):
        want = int(ref.attention_mask(Sq, Skv, causal, window, "cpu").sum())
        assert fa_ops.flash_pairs(Sq, Skv, causal, window) == want


# ---------------------------------------------------------------------------
# the dry mesh, the counting context, the roofline
# ---------------------------------------------------------------------------

def test_dry_mesh_counts_and_refuses_real_tensors():
    mesh = make_production_mesh()
    comm = mesh.dry(rank=17)
    assert comm.coords == {"data": 1, "model": 1}
    with FakeTensorMode():
        w = torch.empty((4, 8), dtype=torch.bfloat16, device="meta")
        g = comm.all_gather(w, ("model",), 1)
        assert g.shape == (4, 128) and dry.is_dry(g)
        comm.all_reduce(torch.empty(3, device="meta"), ("data",))
    assert comm.bytes == {"intra_group": 64.0, "intra_pod": 12.0}
    assert comm.op_bytes == {"all-gather": 64.0, "all-reduce": 12.0}
    assert comm.n_ops == 2
    for real in (torch.zeros(3), torch.empty(3, device="meta")):
        with pytest.raises(RuntimeError, match="dry mesh"):
            comm.all_reduce(real, ("data",))
    with pytest.raises(RuntimeError, match="already"):
        mesh.dry(0)
    stats = ta.collective_stats(comm)
    assert (stats.total_bytes, stats.remote_bytes) == (76.0, 12.0)


def test_trace_counts_flops_bytes_and_memory():
    with FakeTensorMode(), ta.Trace() as tr:
        a = torch.empty((256, 512), dtype=torch.bfloat16, device="meta")
        b = torch.empty((512, 128), dtype=torch.bfloat16, device="meta")
        tr.begin()
        c = torch.mm(a, b, out_dtype=torch.float32)       # 131072 B out
        d = c.t()                                          # a view
        e = (d * 2.0).sum()
        tr.end((c, a))
        del d, e
    assert tr.flops == 2 * 256 * 512 * 128
    assert tr.argument_bytes == 256 * 512 * 2 + 512 * 128 * 2
    assert tr.output_bytes == 256 * 128 * 4
    assert tr.alias_bytes == 256 * 512 * 2
    # mm: its operands and its output; mul: c and c * 2; sum: c*2 and 4 B
    assert tr.bytes_accessed == (256 * 512 * 2 + 512 * 128 * 2 + 131072
                                 + 2 * 131072 + 131072 + 4)
    assert tr.peak_bytes == tr.argument_bytes + 2 * 131072 + 512
    mem = tr.memory()
    assert mem["fits_hbm_80gb"] and mem["temp_bytes"] == 2 * 131072 + 512


def test_roofline_math():
    r = ta.roofline(flops_per_dev=ta.PEAK_FLOPS, bytes_per_dev=ta.HBM_BW,
                    coll_bytes_per_dev=0.0,
                    model_flops_total=ta.PEAK_FLOPS * 256, chips=256)
    assert r.compute_s == pytest.approx(1.0)
    assert r.memory_s == pytest.approx(1.0)
    assert r.dominant in ("compute", "memory")
    assert r.useful_ratio == pytest.approx(1.0)
    assert r.roofline_fraction == pytest.approx(1.0)
    assert (ta.PEAK_FLOPS, ta.HBM_BW, ta.LINK_BW) == (989e12, 3.35e12, 50e9)


def test_step_count_of_a_dry_state():
    assert step_count({"count": torch.tensor(4, dtype=torch.int32)}) == 5
    with FakeTensorMode():
        c = torch.zeros((), dtype=torch.int32, device="meta")
        assert step_count({"count": c}) == 1


# ---------------------------------------------------------------------------
# gather_specs in the serving steps
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ["llama3-8b", "recurrentgemma-9b"])
def test_serving_steps_gather_on_use(arch):
    """``make_prefill`` / ``make_serve_step`` with gather callables for
    every stacked leaf (on a one-rank mesh, ``gather_on_use`` and, to see
    them run, a copy) give the logits and cache they give without, and
    (llama3-8b; the hybrid's ungathered steps are held against JAX in
    ``test_torch_prefill.py``) JAX's."""
    jcfg = j_reduced(J_REGISTRY[arch])
    tcfg = t_reduced(T_REGISTRY[arch])
    jp = j_init_params(jcfg, jax.random.PRNGKey(3))
    tp = from_reference(jax.tree.map(np.asarray, jp), device="cpu")
    mesh = Mesh(np.arange(1).reshape(1, 1), ("data", "model"))
    pspecs = TSH.param_specs(tcfg, mesh)
    calls = []

    def gather(w, s):
        calls.append(1)
        return TSH.gather_on_use(w, TSH.NamedSharding(mesh, s)).clone()

    gspecs = {k: TSH.tree_map(lambda s: (lambda w, _s=TSH.P(*s[1:]):
                                         gather(w, _s)), pspecs[k])
              for k in ("layers", "groups") if k in pspecs}
    toks = np.random.default_rng(0).integers(2, tcfg.vocab, (2, 13)) \
        .astype(np.int32)
    max_len = 24
    out = {}
    for tag, gs in (("plain", None), ("gathered", gspecs)):
        logits, cache = TS.make_prefill(tcfg, max_len, gather_specs=gs)(
            tp, {"tokens": torch.from_numpy(toks)})
        nxt = logits.argmax(-1, keepdim=True).to(torch.int32)
        step_logits, cache = TS.make_serve_step(tcfg, gather_specs=gs)(
            tp, cache, nxt, torch.full((2,), 13, dtype=torch.int32))
        out[tag] = (logits, step_logits, cache)
    n_leaves = sum(1 for _ in t_param_leaves(
        pspecs["layers"] if "layers" in pspecs else pspecs["groups"]))
    stacks = tcfg.n_layers if "layers" in pspecs else \
        tcfg.n_layers // len(tcfg.block_pattern)
    assert len(calls) == 2 * n_leaves * stacks
    spec = TD.cache_view_specs(tcfg, max_len)
    for a, b in zip(out["plain"][:2], out["gathered"][:2]):
        assert torch.equal(a, b)
    for a, b in zip(TD.tree_leaves(out["plain"][2], spec),
                    TD.tree_leaves(out["gathered"][2], spec)):
        assert torch.equal(a, b)
    if arch != "llama3-8b":
        return
    jl, jc = JS.make_prefill(jcfg, max_len)(jp, {"tokens": jnp.asarray(toks)})
    np.testing.assert_allclose(out["gathered"][0].numpy(), np.asarray(jl),
                               rtol=LOGIT_TOL, atol=LOGIT_TOL)
    jnxt = jnp.asarray(out["gathered"][0].argmax(-1, keepdim=True).numpy())
    jsl, _ = JS.make_serve_step(jcfg)(jp, jc, jnxt,
                                      jnp.full((2,), 13, jnp.int32))
    np.testing.assert_allclose(out["gathered"][1].numpy(), np.asarray(jsl),
                               rtol=LOGIT_TOL, atol=LOGIT_TOL)
