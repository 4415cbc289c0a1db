"""Per-layer-type FLOP and byte accounting, and the HBM-traffic bound.

The JAX package's ``launch/analysis.py`` decomposes the step because
XLA's ``cost_analysis()`` counts a while-loop body once: the scanned
full step under-reports layer work by about ``n_layers``, so it lowers
ONE layer of each block type and combines

    flops_dev = sum_type  count_type * flops_layer

The port's full-step trace (``launch/dryrun.py`` under
``trace_analysis.Trace``) already counts every layer as it runs, so here
the decomposition is the per-type detail — one layer of each type traced
at the rank's shape (its share of the batch, the whole sequence; decode:
one token against a ``seq_len``-deep cache), forward, or forward and
backward under the cell's remat for train, and the embedding, final norm
and head (train: the chunked loss, forward and backward) once — and a
consistency check on the full count: the dry run records their ratio.
Each layer runs as the cell's step runs it on the rank's rows: with its
weights whole, as the smap step computes after gathering, or — with
``tp`` (the spmd train step, ``--train-impl gspmd``, and the spmd
serving steps; decode on the rank's cache shard) — on the rank's model
shards of the layer types ``steps.tp_layer_types`` splits and of the
embedding and head, with the collectives of a dry mesh's comm;
``_local_weight_bytes`` gives the bytes the rank holds of them at rest,
exactly, from the specs.  Per type the
detail separates the matmuls' flops (``torch.utils.flop_counter``'s
formulas) from the hand-written kernels' needed work.

JAX's ``ANALYSIS_BLOCK`` (a 2048-wide attention tile resident in a v5e's
VMEM, so the byte term matched the Pallas kernel) is dropped: the port's
attention is its own kernels, whose wrappers note the work they need.

``analytic_hbm_bytes`` is the JAX package's arithmetic: bytes no
implementation avoids (weights streamed, optimizer state, saved
residuals, decode cache), the lower bound beside the trace's
"every unfused operand" upper bound.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, Optional, Tuple

import torch
from torch._subclasses.fake_tensor import FakeTensorMode

from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.launch import sharding as sh
from repro_torch.launch import trace_analysis as ta
from repro_torch.launch.inputs import ENCDEC_SRC_LEN, seq_split
from repro_torch.launch.steps import (cache_cuts, tensor_parallel,
                                      tp_layer_types)
from repro_torch.models import decode as dec
from repro_torch.models import layers as L
from repro_torch.models import transformer as T
from repro_torch.models.params import _leaves, layer_def, torch_dtype, tree_map


def _leaf_specs_for_layer(cfg, mesh, fsdp, ltype):
    """PartitionSpecs for ONE layer (no leading 'layer' axis), and its
    definition."""
    rules = sh.axis_rules(cfg, mesh, fsdp=fsdp)
    ldef = layer_def(cfg, ltype)
    return tree_map(lambda pd: sh.spec_of(pd.axes, rules), ldef), ldef


def _local_weight_bytes(cfg, mesh, specs, ldef) -> float:
    """Exact per-device bytes of one layer's weights under the specs."""
    itemsize = torch.empty((), dtype=torch_dtype(cfg.param_dtype),
                           device="meta").element_size()
    total = 0.0
    for (_, pd), (_, spec) in zip(_leaves(ldef), _leaves(specs)):
        shard = 1
        for ax in spec:
            for a in sh.entry_axes(ax):
                shard *= mesh.shape[a]
        total += math.prod(pd.shape) * itemsize / shard
    return total


def _batch_shards(mesh) -> int:
    n = mesh.shape["data"]
    if "pod" in mesh.axis_names:
        n *= mesh.shape["pod"]
    return n


def _rank_batch(mesh, B: int) -> int:
    """A rank's share of B: B over the batch shards, or B (replicated)
    when it does not divide — the inputs' ``_batch_tuple`` rule."""
    n = _batch_shards(mesh)
    return B // n if B % n == 0 and B >= n else B


@dataclasses.dataclass
class LayerCost:
    flops: float          # per device
    bytes: float          # per device
    matmul_flops: float = 0.0
    kernel_flops: float = 0.0


def _cost_of(fn, make_args, device) -> Tuple[float, float, float]:
    """(flops, bytes accessed, kernel flops) of ``fn(*make_args())`` on
    fake tensors; what ``make_args`` does is not counted."""
    with FakeTensorMode(), ta.Trace() as tr:
        args = make_args()
        tr.begin()
        fn(*args)
        del args
    return tr.flops, tr.bytes_accessed, sum(tr.kernel_flops.values())


def _fake(shape, dtype, device, grad=False):
    t = torch.empty(tuple(shape), dtype=dtype, device=device)
    return t.requires_grad_(grad)


def _layer_params(cfg, ltype, device, grad, shape_of=None):
    """One layer's fake weights: whole, or ``shape_of(ParamDef)``."""
    dt = torch_dtype(cfg.param_dtype)
    shape_of = shape_of or (lambda pd: pd.shape)
    return tree_map(lambda pd: _fake(shape_of(pd), dt, device, grad),
                    layer_def(cfg, ltype))


def _model_shard_shape(cfg, mesh):
    """``ParamDef`` -> the shape of the rank's shard of a layer leaf cut
    over "model" only (as the spmd step computes on it)."""
    rules = sh.axis_rules(cfg, mesh, fsdp=False)
    return lambda pd: sh.local_shape(pd.shape, sh.spec_of(pd.axes, rules),
                                     mesh)


def _rope(cfg, B, S, device):
    if cfg.rope_type == "none":
        return None
    pos = _fake((B, S), torch.int64, device)
    extras = {"position_ids": _fake((3, B, S), torch.int64, device)}
    return T.rope_for(cfg, pos, extras)


def _layer_cache(cfg, ltype, B, S, src, device, mesh=None):
    """One layer's decode cache of ``ltype`` (B streams, a ``S``-deep
    context), sliced from the model's cache; with ``mesh``, the rank's
    shard of it as ``cache_specs`` cuts the model's over "model" (B is
    the rank's already)."""
    cache = dec.abstract_cache(cfg, B, S, src)
    specs = sh.cache_specs(cfg, mesh, cache) if mesh is not None else None

    def fake(t, spec=None):
        shape = t.shape if spec is None else sh.local_shape(
            t.shape, sh.P(*(e if "model" in sh.entry_axes(e) else None
                            for e in spec)), mesh)
        return _fake(shape, t.dtype, device)
    cache = tree_map(fake, cache, *(() if specs is None else (specs,)))
    if cfg.family == "encdec":
        return {"k": cache["self"]["k"][0], "v": cache["self"]["v"][0],
                "ck": cache["cross_k"][0], "cv": cache["cross_v"][0]}
    if cfg.block_pattern:
        for name, lc in cache["groups"].items():
            if name.split("_", 1)[1] == ltype:
                return {k: v[0] for k, v in lc.items()}
        for name, lc in cache["tail"].items():
            if name.split("_", 1)[1] == ltype:
                return lc
    return {k: v[0] for k, v in cache["layers"].items()}


def _train_of(body):
    """fn(x, lp, ct, *rest): the forward of ``body`` and its backward
    into x, lp (and ``rest``'s leaves that take gradients)."""
    def fb(x, lp, ct, *rest):
        y = body(x, lp, *rest)
        y.backward(ct)
    return fb


def layer_cost(cfg: ModelConfig, shape: ShapeConfig, mesh, *, fsdp: bool,
               ltype: str, train: bool, hybrid: bool = False,
               seq_len: Optional[int] = None,
               device: str = "cuda", tp: bool = False) -> LayerCost:
    """Per-device cost of one block of ``ltype`` at the rank's shape;
    ``tp``: as the spmd train and serving steps compute it (see the
    module note; decode: on the rank's cache shard)."""
    dev = ta.trace_device(device)
    cdt = torch_dtype(cfg.compute_dtype)
    B = _rank_batch(mesh, shape.global_batch)
    S = seq_len if seq_len is not None else shape.seq_len
    window = T._window(cfg, ltype) if ltype == "attn" else 0
    specs, ldef = _leaf_specs_for_layer(cfg, mesh, fsdp, ltype)
    split, shape_of = None, None
    if tp:
        split = tensor_parallel(cfg, mesh, means=train)
        if ltype in tp_layer_types(cfg, mesh):
            shape_of = _model_shard_shape(cfg, mesh)

    if shape.is_decode:
        src = ENCDEC_SRC_LEN if cfg.family == "encdec" else 0
        cut = cache_cuts(cfg, mesh, S, src) if tp else None

        def args():
            pos = _fake((B,), torch.int32, dev)
            return (_fake((B, 1, cfg.d_model), cdt, dev),
                    _layer_params(cfg, ltype, dev, False, shape_of),
                    _layer_cache(cfg, ltype, B, S, src, dev,
                                 mesh if tp else None), pos,
                    dec._step_rope(cfg, pos[:, None], None))

        def f(x, lp, lc, pos, rope):
            dec._decode_layer(x, lp, lc, cfg, ltype, rope, pos, split, cut)
        flops, bts, kf = _cost_of(f, args, dev)
        return LayerCost(flops, bts, flops - kf, kf)

    if shape_of is None:
        split = None

    def body(x, lp):
        return T.apply_layer(x, lp, cfg, ltype, rope_of[0], window=window,
                             causal=ltype != "enc", tp=split)[0]

    rope_of = [None]

    def args():
        rope_of[0] = _rope(cfg, B, S, dev)
        return (_fake((B, S, cfg.d_model), cdt, dev, train),
                _layer_params(cfg, ltype, dev, train, shape_of),
                _fake((B, S, cfg.d_model), cdt, dev))

    if train:
        fn = _train_of(lambda x, lp: T._run(body, x, lp, cfg))
    else:
        def fn(x, lp, ct):
            with torch.no_grad():
                body(x, lp)
    flops, bts, kf = _cost_of(fn, args, dev)
    wl = _local_weight_bytes(cfg, mesh, specs, ldef)
    return LayerCost(flops, wl + max(bts - wl, 0.0), flops - kf, kf)


def _decoder_layer_cost(cfg, shape, mesh, *, fsdp, train,
                        device="cuda", tp=False) -> LayerCost:
    """Enc-dec decoder layer (self + cross + ffn); ``tp`` as
    ``layer_cost``'s."""
    if shape.is_decode:
        return layer_cost(cfg, shape, mesh, fsdp=fsdp, ltype="dec",
                          train=False, device=device, tp=tp)
    dev = ta.trace_device(device)
    cdt = torch_dtype(cfg.compute_dtype)
    B = _rank_batch(mesh, shape.global_batch)
    S_t, S_src = seq_split(cfg, shape.seq_len)
    specs, ldef = _leaf_specs_for_layer(cfg, mesh, fsdp, "dec")
    rope_of = [None]
    split, shape_of = None, None
    if tp:
        split, shape_of = tensor_parallel(cfg, mesh, means=train), \
            _model_shard_shape(cfg, mesh)

    def body(x, lp, enc_out):
        return T._dec_layer(x, lp, cfg, rope_of[0], enc_out, split)[0]

    def args():
        rope_of[0] = _rope(cfg, B, S_t, dev)
        return (_fake((B, S_t, cfg.d_model), cdt, dev, train),
                _layer_params(cfg, "dec", dev, train, shape_of),
                _fake((B, S_t, cfg.d_model), cdt, dev),
                _fake((B, S_src, cfg.d_model), cdt, dev, train))

    if train:
        fn = _train_of(lambda x, lp, e: T._run(
            lambda x_, p_: body(x_, p_, e), x, lp, cfg))
    else:
        def fn(x, lp, ct, e):
            with torch.no_grad():
                body(x, lp, e)
    flops, bts, kf = _cost_of(fn, args, dev)
    wl = _local_weight_bytes(cfg, mesh, specs, ldef)
    return LayerCost(flops, wl + max(bts - wl, 0.0), flops - kf, kf)


def outer_cost(cfg: ModelConfig, shape: ShapeConfig, mesh, *, fsdp: bool,
               train: bool, device: str = "cuda",
               tp: bool = False) -> LayerCost:
    """Embedding + final norm + head per device, as the port's steps run
    them: train the chunked loss forward and backward, prefill the last
    position's logits, decode the token's (``tp``: vocabulary parallel,
    as the spmd steps; the serving logits gathered)."""
    dev = ta.trace_device(device)
    cdt = torch_dtype(cfg.compute_dtype)
    pdt = torch_dtype(cfg.param_dtype)
    B = _rank_batch(mesh, shape.global_batch)
    # the loss's positions: a VLM's targets cover its whole sequence
    # (patches and text), an encoder-decoder's the target tokens
    S = 1 if shape.is_decode else (
        shape.seq_len if cfg.family == "vlm"
        else seq_split(cfg, shape.seq_len)[0])
    V, D = cfg.vocab_padded, cfg.d_model
    split = None
    shapes = {"embed": (V, D), "head": (D, V)}
    if tp:
        split = tensor_parallel(cfg, mesh, means=train)
        ps = sh.param_specs(cfg, mesh, fsdp=False)
        shapes = {k: sh.local_shape(v, ps[k], mesh)
                  for k, v in shapes.items() if k in ps}

    def args():
        p = {"embed": _fake(shapes["embed"], pdt, dev, train),
             "final_norm": _fake((D,), pdt, dev, train)}
        if not cfg.tie_embeddings:
            p["head"] = _fake(shapes["head"], pdt, dev, train)
        return (p, _fake((B, S), torch.int32, dev),
                _fake((B, S, D), cdt, dev, train),
                _fake((B, S), torch.int32, dev),
                _fake((B, S), torch.float32, dev))

    def fwd(p, tok, x, tgt, m):
        e = T.embed_tokens(p, cfg, tok, split)
        xn = L.rms_norm(x + e, p["final_norm"], cfg.norm_eps)
        if train:
            return T.chunked_ce_loss(p, cfg, xn, tgt, m, split)
        return dec._logits(p, cfg, xn[:, -1], split)

    if train:
        def fn(*a):
            fwd(*a).backward()
    else:
        def fn(*a):
            with torch.no_grad():
                fwd(*a)
    flops, bts, kf = _cost_of(fn, args, dev)
    # exact local weight bytes of embed/head
    itemsize = torch.empty((), dtype=pdt, device="meta").element_size()
    msize = mesh.shape["model"]
    dsize = mesh.shape["data"] if fsdp else 1
    wl = V * D * itemsize / (msize * dsize)
    if not cfg.tie_embeddings:
        wl += V * D * itemsize / (msize * dsize)
    return LayerCost(flops, wl + max(bts - wl, 0.0), flops - kf, kf)


def decomposed_cost(cfg: ModelConfig, shape: ShapeConfig, mesh, *,
                    fsdp: bool, device: str = "cuda",
                    tp: bool = False) -> Dict[str, float]:
    """Total per-device (flops, bytes) = sum over block types + outer,
    with each type's detail; ``tp``: as the spmd train or serving step
    computes them (a dry ``mesh``'s comm carries its collectives)."""
    train = shape.kind == "train"
    counts: Dict[Tuple[str, bool], int] = {}
    if cfg.family == "encdec":
        counts[("enc", False)] = cfg.enc_layers
        counts[("dec", False)] = cfg.dec_layers
    else:
        for lt in cfg.layer_types():
            key = (lt, cfg.family == "hybrid")
            counts[key] = counts.get(key, 0) + 1

    flops = bts = 0.0
    detail = {}
    for (lt, hybrid), n in counts.items():
        if lt == "dec":
            lc = _decoder_layer_cost(cfg, shape, mesh, fsdp=fsdp, train=train,
                                     device=device, tp=tp)
        elif lt == "enc" and not shape.is_decode:
            _, ss = seq_split(cfg, shape.seq_len)
            lc = layer_cost(cfg, shape, mesh, fsdp=fsdp, ltype="enc",
                            train=train, seq_len=ss, device=device,
                            tp=tp)
        elif lt == "enc" and shape.is_decode:
            continue  # encoder not run at decode
        else:
            lc = layer_cost(cfg, shape, mesh, fsdp=fsdp, ltype=lt,
                            train=train, hybrid=hybrid, device=device,
                            tp=tp)
        flops += n * lc.flops
        bts += n * lc.bytes
        detail[lt] = {"n": n, "flops": lc.flops, "bytes": lc.bytes,
                      "matmul_flops": lc.matmul_flops,
                      "kernel_flops": lc.kernel_flops}

    oc = outer_cost(cfg, shape, mesh, fsdp=fsdp, train=train, device=device,
                    tp=tp)
    flops += oc.flops
    bts += oc.bytes
    detail["outer"] = {"n": 1, "flops": oc.flops, "bytes": oc.bytes,
                       "matmul_flops": oc.matmul_flops,
                       "kernel_flops": oc.kernel_flops}
    return {"flops_per_dev": flops, "bytes_per_dev": bts, "detail": detail,
            "remat": cfg.remat}


def analytic_hbm_bytes(cfg: ModelConfig, shape: ShapeConfig, mesh, *,
                       fsdp: bool, microbatches: int = 1) -> float:
    """Per-device HBM-traffic LOWER BOUND (bytes no implementation avoids).

    Counts: weight streaming (fwd + bwd-recompute + grad pass per
    microbatch), optimizer state read/write, saved residual carries, one
    read+write of the layer I/O activations, decode KV/state streaming.
    Fusion cannot remove these; the trace's bytes accessed is the
    matching UPPER bound (every unfused operand).
    """
    from repro_torch.core.costmodel import kv_cache_bytes
    from repro_torch.models.params import param_bytes
    msize = mesh.shape["model"]
    dsize = mesh.shape["data"] * (mesh.shape.get("pod", 1))
    chips = mesh.size
    pb_local = param_bytes(cfg) / (msize * (dsize if fsdp else 1))
    n_par = param_bytes(cfg) / 2

    D = cfg.d_model
    act_bytes = 2  # bf16
    if shape.kind == "train":
        tokens_local = shape.global_batch * shape.seq_len / dsize
        # weights: fwd + bwd recompute (remat=full) + grad production
        w = pb_local * 3 * microbatches
        # optimizer: read m,v + params, write all (f32 moments)
        opt = (n_par * 8 / (msize * dsize)) * 2 + pb_local * 2
        # activations: residual carry saved+read per layer; layer I/O rw
        acts = tokens_local * D * act_bytes * cfg.n_layers * 4
        return w + opt + acts
    if shape.kind == "prefill":
        tokens_local = shape.global_batch * shape.seq_len / dsize
        return pb_local + tokens_local * D * act_bytes * cfg.n_layers * 2
    # decode: params once + full cache read+write
    cache_local = kv_cache_bytes(cfg, shape, shape.global_batch) / chips
    return pb_local + 2 * cache_local
