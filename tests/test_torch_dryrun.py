"""The dry run (``launch/dryrun.py``) and its per-layer accounting
(``launch/analysis.py``) on the CPU.

* ``decomposed_cost`` on reduced configs of each family, on a (1, 1)
  mesh: each layer type's matmul flops (the trace's, without the kernels'
  noted work) equal a closed-form count of its projections, MLP or
  experts exactly, at a prefill shape; and every type's flops lie within
  a stated band of JAX's ``layer_cost`` / ``outer_cost`` (XLA's
  ``cost_analysis``) at prefill, train and decode shapes.
* ``run_cell`` traces a train step of six reduced families on both
  production meshes: status ok, the JAX record's keys (with the port's
  renames), no kernel built and no process group left behind; under
  ``--train-impl smap`` collective bytes by link class equal to a closed
  form from the specs; under ``gspmd`` (the default) the rank's flops
  and peak below the smap step's, the pod mesh's peak at most the single
  pod's, and the decomposition's flops equal to the full count.
* An MoE train step under FSDP adds less than a layer's gathered experts
  to the peak a layer, under both impls.
"""
import dataclasses
import math
from collections import defaultdict

import jax
import numpy as np
import pytest
import torch.distributed as dist

from repro.configs import REGISTRY as J_REGISTRY
from repro.configs import reduced_config as j_reduced
from repro.configs.base import ShapeConfig as JShape
from repro.launch import analysis as JA
from repro_torch.configs import REGISTRY as T_REGISTRY
from repro_torch.configs import reduced_config as t_reduced
from repro_torch.configs.base import ShapeConfig
from repro_torch.kernels import build
from repro_torch.launch import analysis as TA
from repro_torch.launch import dryrun
from repro_torch.launch import sharding as TSH
from repro_torch.launch.mesh import Mesh, make_production_mesh
from repro_torch.models.params import STACKED, _leaves, model_def

FAMILIES = ("llama3-8b", "mixtral-8x22b", "mamba2-780m", "recurrentgemma-9b",
            "seamless-m4t-large-v2", "qwen2-vl-2b")
S, B = 64, 2
# port / JAX flops of one layer, by type.  XLA's ``cost_analysis`` counts
# more than the port's trace: every elementwise op (norms, RoPE, softmax,
# activations, the MoE router's one-hot and cumsum, the SSD scan's decay
# masks) and, for attention, the whole S x S of its 2048-wide analysis
# block where the port's kernel notes the causal pairs it needs — so the
# port's count is lower, most where attention and routing weigh most
# (reduced mixtral: 0.74).  The decoder layer is the exception above 1:
# under remat "full" the port recomputes its matmuls in the backward,
# where JAX's decoder checkpoint keeps every dot.  ``outer`` is compared at
# train and decode only: at prefill the port's step takes the last
# position's logits, JAX's analysis the loss over every position; and not
# for the VLM at train, whose loss the port counts over all S positions
# (its targets are (B, S)), JAX's analysis over the text positions.
BANDS = {"attn": (0.70, 1.0), "ssd": (0.70, 1.0), "rec": (0.85, 1.0),
         "enc": (0.90, 1.0), "dec": (0.85, 1.25), "outer": (0.95, 1.0)}


def _glu(cfg):
    return cfg.activation in ("swiglu", "gelu_glu", "relu_glu")


def _mlp(cfg, T):
    D, F = cfg.d_model, cfg.d_ff
    return 2 * T * D * F * (2 if _glu(cfg) else 1) + 2 * T * F * D


def _moe(cfg, B, S):
    """Router and experts over ``moe_apply``'s blocks."""
    D, F, E, K = cfg.d_model, cfg.d_ff, cfg.n_experts, cfg.top_k
    blk = max(1, min(max(1, cfg.moe_block // B), S))
    n_blocks = -(-S // blk)
    rows, T = (B, blk) if cfg.moe_batched else (1, B * blk)
    C = min(T, int(max(1, (T * K * cfg.capacity_factor) // E)))
    per_slot = 2 * D * F * (2 if _glu(cfg) else 1) + 2 * F * D
    return n_blocks * (2 * B * blk * D * E + rows * E * C * per_slot)


def closed_form(cfg, lt, B, S, S_src=0):
    """Matmul flops of one layer's forward over B x S tokens."""
    T, D = B * S, cfg.d_model
    Hq, Hkv, dh = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    attn = 2 * T * D * (Hq + 2 * Hkv) * dh + 2 * T * Hq * dh * D
    if lt in ("attn", "enc"):
        return attn + (_moe(cfg, B, S) if cfg.n_experts else _mlp(cfg, T))
    if lt == "dec":
        cross = (2 * T * D * Hq * dh + 2 * B * S_src * D * 2 * Hkv * dh
                 + 2 * T * Hq * dh * D)
        return attn + cross + _mlp(cfg, T)
    if lt == "rec":
        W = cfg.lru_width
        return 2 * 2 * T * D * W + 2 * 2 * T * W * W + 2 * T * W * D \
            + _mlp(cfg, T)
    if lt == "ssd":
        di, GN, H = cfg.d_inner, cfg.ssm_groups * cfg.ssm_state, \
            cfg.ssm_heads
        return 2 * T * D * (2 * di + 2 * GN + H) + 2 * T * di * D
    if lt == "outer":               # the last position's logits
        return 2 * B * D * cfg.vocab_padded
    raise ValueError(lt)


@pytest.mark.parametrize("arch", FAMILIES)
def test_layer_flops_closed_form_and_jax(arch):
    jmesh = jax.sharding.Mesh(np.array(jax.devices()[:1]).reshape(1, 1),
                              ("data", "model"))
    tmesh = Mesh(np.arange(1).reshape(1, 1), ("data", "model"))
    for kind in ("prefill", "train", "decode"):
        remat = "full" if kind == "train" else "none"
        jcfg = dataclasses.replace(j_reduced(J_REGISTRY[arch]), remat=remat)
        tcfg = dataclasses.replace(t_reduced(T_REGISTRY[arch]), remat=remat)
        want = JA.decomposed_cost(jcfg, JShape("x", kind, S, B), jmesh,
                                  fsdp=False)["detail"]
        got = TA.decomposed_cost(tcfg, ShapeConfig("x", kind, S, B), tmesh,
                                 fsdp=False)["detail"]
        assert set(got) == set(want), kind
        for lt, d in got.items():
            assert d["flops"] == d["matmul_flops"] + d["kernel_flops"]
            if kind == "prefill":
                src = S // 2 if tcfg.family == "encdec" else 0
                s = S // 2 if tcfg.family in ("encdec",) else S
                assert d["matmul_flops"] == closed_form(tcfg, lt, B, s,
                                                        src), (lt, d)
                if lt == "outer":
                    continue
            if lt == "outer" and tcfg.family == "vlm" and kind == "train":
                continue
            lo, hi = BANDS[lt]
            ratio = d["flops"] / want[lt]["flops"]
            assert lo <= ratio <= hi, (kind, lt, ratio)


# ---------------------------------------------------------------------------
# run_cell on the production meshes
# ---------------------------------------------------------------------------

JAX_KEYS = {"arch", "shape", "multi_pod", "tag", "status", "chips", "fsdp",
            "remat", "memory", "collectives", "full_step_cost_analysis"}
RENAMED = {"trace_s"}                     # compile_s
MEMORY_KEYS = {"argument_bytes", "output_bytes", "temp_bytes", "alias_bytes",
               "peak_per_device", "fits_hbm_80gb"}     # fits_hbm_16gb
ANALYSIS_KEYS = {"decomposed", "roofline", "analysis_s"}
ROOFLINE_KEYS = {"compute_s", "memory_s", "collective_s", "flops_per_dev",
                 "bytes_per_dev", "coll_bytes_per_dev", "model_flops_total",
                 "chips", "dominant", "useful_ratio", "roofline_fraction",
                 "bytes_per_dev_hlo_upper", "memory_s_hlo_upper"}
MICRO = 2


def _cell_cfg(arch):
    """``test_dryrun.py::test_tiny_cell_compiles_on_fake_mesh``'s reduced
    config and train shape."""
    cfg = dataclasses.replace(
        t_reduced(T_REGISTRY[arch]), remat="full", d_model=64,
        param_dtype="bfloat16", compute_dtype="bfloat16")
    return cfg, ShapeConfig("t", "train", 8, 32)


def train_collectives(cfg, mesh, multi_pod):
    """Operand bytes a rank's smap train step moves, by class, from the
    specs: each sharded leaf gathered over "model" each time its layer
    runs (twice a microbatch under remat for the stacked leaves: forward
    and recompute; once for the others); each float32 gradient summed over
    the batch axes (two pods: over "data", then its max over "model" when
    model-sharded, and int8 over "pod"); loss, ce and aux over the batch
    axes; the gradient norm over the pod's plane; each ZeRO-1 slice of the
    updated parameters gathered over "data"."""
    pspecs = TSH.param_specs(cfg, mesh)
    ospecs = TSH.opt_specs(cfg, mesh, pspecs)
    n_data = mesh.shape["data"]
    out = defaultdict(float)
    batch_cls = "cross_pod" if multi_pod else "intra_pod"
    for (path, pd), (_, spec), (_, ospec) in zip(
            _leaves(model_def(cfg)), _leaves(pspecs), _leaves(ospecs["m"])):
        local = TSH.local_shape(pd.shape, spec, mesh)
        n = math.prod(local)
        sharded = TSH.spread_dims(spec, len(pd.shape), mesh)
        assert all(axes == ("model",) for _, axes in sharded)
        uses = MICRO * (2 if path[0] in STACKED else 1)
        out["intra_group"] += uses * len(sharded) * n * 2
        out["intra_pod"] += n * 4
        if multi_pod:
            out["intra_group"] += 4 * bool(sharded)
            out["cross_pod"] += n
        if any(i < len(ospec) and ospec[i] == "data" and
               (i >= len(spec) or spec[i] is None)
               for i in range(len(pd.shape))):
            out["intra_pod"] += n // n_data * 2
    out[batch_cls] += 3 * 4
    out["intra_pod"] += 4
    return dict(out)


@pytest.fixture
def no_build(monkeypatch):
    def refuse(*a, **k):
        raise AssertionError("the dry run reached kernels/build.py")
    monkeypatch.setattr(build, "build", refuse)
    monkeypatch.setattr(build, "load", refuse)


@pytest.mark.parametrize("arch", FAMILIES)
def test_run_cell_on_production_meshes(no_build, arch):
    assert not (dist.is_available() and dist.is_initialized())
    for multi_pod in (False, True):
        cfg, shape = _cell_cfg(arch)
        rec = dryrun.run_cell(arch, "t", multi_pod=multi_pod,
                              skip_analysis=multi_pod, microbatches=MICRO,
                              config=(cfg, shape), train_impl="smap")
        assert rec["status"] == "ok"
        assert JAX_KEYS | RENAMED <= set(rec)
        assert set(rec["memory"]) == MEMORY_KEYS
        assert rec["memory"]["peak_per_device"] > rec["memory"][
            "argument_bytes"] > 0
        assert rec["chips"] == (512 if multi_pod else 256)
        if not multi_pod:
            assert ANALYSIS_KEYS <= set(rec)
            assert set(rec["roofline"]) == ROOFLINE_KEYS
            # the per-type detail adds up to the full count (the step's
            # optimizer runs no matmul), but for the hybrid: its tail
            # layers run outside the recomputed groups, and the detail
            # traces each layer type under remat
            ratio = rec["decomposed"]["flops_ratio"]
            if cfg.block_pattern:
                assert 1.0 < ratio < 1.1
            else:
                assert ratio == pytest.approx(1.0, rel=1e-9)
        if cfg.family != "ssm":
            assert rec["launches"]["flash_attention_fwd"] > 0
        mesh = make_production_mesh(multi_pod=multi_pod)
        if multi_pod:
            cfg = dataclasses.replace(cfg, batch_axes=("pod", "data"))
        want = train_collectives(cfg, mesh, multi_pod)
        assert rec["collectives"]["per_class_bytes"] == want, arch
        assert rec["collectives"]["total_per_dev"] == sum(want.values())
    assert not (dist.is_available() and dist.is_initialized())


@pytest.mark.parametrize("arch", FAMILIES)
def test_run_cell_gspmd_on_production_meshes(no_build, arch):
    """The default train impl traces ``make_train_step_spmd``: the record
    is tagged ``gspmd``; a rank computes less than the smap step's rank
    on the same cell (its model shards, 1/(pod x data) of the batch) and
    holds no more at its peak, the pod mesh no more than the single pod;
    the per-type decomposition, traced the same way, adds up to the full
    count; the tensor-parallel sums stay in a data row (intra_group).  The
    batch is the smap cells' twice over, so that the pod mesh's 32 batch
    shards leave a rank a row for each of its microbatches."""
    assert not (dist.is_available() and dist.is_initialized())
    cfg, shape = _cell_cfg(arch)
    shape = dataclasses.replace(shape, global_batch=2 * shape.global_batch)
    recs = {}
    for impl in ("gspmd", "smap"):
        for multi_pod in (False, True):
            recs[impl, multi_pod] = dryrun.run_cell(
                arch, "t", multi_pod=multi_pod, skip_analysis=multi_pod,
                microbatches=MICRO, config=(cfg, shape), train_impl=impl)
    for multi_pod in (False, True):
        rec, smap = recs["gspmd", multi_pod], recs["smap", multi_pod]
        assert rec["status"] == "ok" and rec["tag"] == "gspmd"
        assert JAX_KEYS | RENAMED <= set(rec)
        flops = rec["full_step_cost_analysis"]["flops"]
        assert flops < smap["full_step_cost_analysis"]["flops"]
        assert rec["memory"]["peak_per_device"] <= \
            smap["memory"]["peak_per_device"]
        assert rec["collectives"]["per_class_bytes"]["intra_group"] > 0
        if cfg.family != "ssm":
            assert rec["launches"]["flash_attention_fwd"] > 0
    assert recs["gspmd", True]["memory"]["peak_per_device"] <= \
        recs["gspmd", False]["memory"]["peak_per_device"]
    ratio = recs["gspmd", False]["decomposed"]["flops_ratio"]
    if cfg.block_pattern:
        assert 1.0 < ratio < 1.1
    else:
        assert ratio == pytest.approx(1.0, rel=1e-9)
    assert not (dist.is_available() and dist.is_initialized())


def test_inapplicable_cell_is_skipped_with_jaxs_reason():
    rec = dryrun.run_cell("llama3-8b", "long_500k", multi_pod=False)
    assert rec["status"] == "skipped"
    assert "full quadratic attention" in rec["reason"]



@pytest.mark.parametrize("train_impl", dryrun.TRAIN_IMPLS)
def test_moe_fsdp_layer_growth_is_less_than_its_gathered_experts(
        no_build, train_impl):
    """An MoE train step under FSDP on the production mesh, traced at 1
    and 2 layers: the second layer adds less to the peak than one layer's
    gathered expert weights (``wi`` and ``wo`` whole along "data"; the
    spmd step keeps them cut along "model").  Each layer is recomputed
    under remat "full", so its token blocks take no checkpoint of their
    own; nested, the blocks' checkpoints kept every layer's gathered
    experts alive until its backward and the growth was above those
    bytes."""
    base = dataclasses.replace(
        t_reduced(T_REGISTRY["mixtral-8x22b"]), d_model=256, d_ff=4096,
        n_experts=8, capacity_factor=1.25, moe_block=16384, n_heads=16,
        n_kv_heads=16, remat="full", param_dtype="bfloat16",
        compute_dtype="bfloat16")
    # one token block a layer under either step (the spmd step's block
    # length comes from the global batch's 32 rows of a microbatch)
    shape = ShapeConfig("t", "train", 256, 512)
    mesh = make_production_mesh()
    peaks = []
    for n in (1, 2):
        cfg = dataclasses.replace(base, n_layers=n)
        tr, _, _ = dryrun.trace_step(cfg, shape, make_production_mesh(),
                                     fsdp=True, train_impl=train_impl)
        peaks.append(tr.memory()["peak_per_device"])
    moe = model_def(base)["layers"]["moe"]
    split = mesh.shape["model"] if train_impl == "gspmd" else 1
    gathered = sum(math.prod(moe[k].shape[1:]) for k in ("wi", "wo")) \
        * 2 / split
    growth = peaks[1] - peaks[0]
    assert 0 < growth < gathered, (growth, gathered)


@pytest.mark.parametrize("kind", ["prefill", "decode"])
def test_serving_cell_holds_its_cache_share(no_build, kind):
    """A serving cell of reduced llama3-8b (bf16) on a (data 2, model 4)
    dry mesh, traced as ``run_cell`` traces it (``make_prefill_spmd`` /
    ``make_serve_step_spmd``): the rank's decode cache — the prefill's
    output, the token step's input and output — holds exactly its
    ``cache_specs`` share, an eighth of the whole (the streams cut over
    "data", the window over "model"), and no tensor gathered over "model"
    has the local shape of a layer leaf (the layers compute on the rank's
    shards: only activations cross the axis).  The record's
    ``cache_bytes`` (``dryrun.cache_share_bytes``) is that share."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from repro_torch.launch import trace_analysis as ta
    from repro_torch.models import decode as dec

    cfg = dataclasses.replace(t_reduced(T_REGISTRY["llama3-8b"]),
                              param_dtype="bfloat16",
                              compute_dtype="bfloat16")
    shape = ShapeConfig("s", kind, 64, 8)
    mesh = Mesh(np.arange(8).reshape(2, 4), ("data", "model"))
    comm = mesh.dry(0)
    gathered, all_gather = [], comm.all_gather

    def spy(t, axes, dim):
        gathered.append((tuple(axes), tuple(t.shape)))
        return all_gather(t, axes, dim)
    comm.all_gather = spy
    step, make_args = dryrun._build_step(
        cfg, shape, mesh, fsdp=False, microbatches=1, opt_impl="adamw",
        compress_pod=False, device=ta.trace_device("cuda"))
    view = dec.cache_view_specs(cfg, shape.seq_len)
    with FakeTensorMode(), ta.Trace() as tr:
        args = make_args()
        tr.begin()
        out = step(*args)
        tr.end(out)
        caches = [out[1]] + ([args[1]] if kind == "decode" else [])
        held = [sum(leaf.numel() * leaf.element_size()
                    for leaf in dec.tree_leaves(c, view)) for c in caches]
    full = dec.abstract_cache(cfg, shape.global_batch, shape.seq_len)
    specs = TSH.cache_specs(cfg, mesh, full)
    share = sum(math.prod(TSH.local_shape(f.shape, s, mesh))
                * f.element_size() for f, s in zip(
                    dec.tree_leaves(full, view), dec.tree_leaves(specs, view)))
    whole = sum(f.numel() * f.element_size()
                for f in dec.tree_leaves(full, view))
    assert held == [share] * len(held) and share * 8 == whole
    assert dryrun.cache_share_bytes(cfg, shape, mesh) == share
    pspecs = TSH.param_specs(cfg, mesh)
    weights = {TSH.local_shape(d.shape, s, mesh)[1:] for (_, d), (_, s) in
               zip(_leaves(model_def(cfg)["layers"]),
                   _leaves(pspecs["layers"]))}
    over_model = [shp for axes, shp in gathered if "model" in axes]
    assert over_model and not set(over_model) & weights
