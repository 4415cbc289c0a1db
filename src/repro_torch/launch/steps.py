"""Step factories: the train and eval steps, and the serving engine's.

Each factory closes over the model config (and the cache layout or the
optimizer config) and returns a plain callable: the port runs eagerly, so
there is no ``jit`` and nothing to donate — the train step updates the
parameters and optimizer state in place, the storage-writing serving
steps update the pool in place, and each returns what it updated.
"""
from __future__ import annotations

import functools
import types

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.launch import sharding as sh
from repro_torch.models import decode as dec
from repro_torch.models import transformer as T
from repro_torch.models.params import (STACKED, hybrid_layer_names, model_def,
                                      tree_map)
from repro_torch.optim.adamw import (AdamWConfig, _leaves, _pieces,
                                     adamw_update)
from repro_torch.optim.quantized import adamw8bit_update


def _grad_tree(cfg: ModelConfig, params):
    """(tree to differentiate, gradient buffers).  Every leaf becomes a
    detached leaf view of its storage whose ``.grad`` is preset to a zero
    buffer, so backward accumulates straight into the buffer; the stacked
    layer (or hybrid group, or encoder and decoder layer) leaves become a
    list of per-layer dicts of views whose grads are the matching slices
    of one stacked buffer.
    (Slicing a stacked leaf that requires grad would instead make every
    layer's backward write a full-size zero tensor.)"""

    def walk(p, g):
        if isinstance(p, dict):
            return {k: walk(p[k], g[k]) for k in p}
        view = p.detach().requires_grad_(True)
        view.grad = g
        return view

    def stack_len(tree):
        while isinstance(tree, dict):
            tree = next(iter(tree.values()))
        return tree.shape[0]

    grads = tree_map(torch.zeros_like, params)
    tree = {}
    for k, v in params.items():
        if k in STACKED:
            tree[k] = [walk(T.layer_params(v, i),
                            T.layer_params(grads[k], i))
                       for i in range(stack_len(v))]
        else:
            tree[k] = walk(v, grads[k])
    return tree, grads


def _value_and_grad_of(cfg: ModelConfig, loss_of):
    """(params, batch) -> (loss, parts, grads) of ``loss_of(tree, batch)``
    on ``_grad_tree``'s views."""
    def vg(params, b):
        tree, grads = _grad_tree(cfg, params)
        loss, parts = loss_of(tree, b)
        loss.backward()
        return loss.detach(), {k: v.detach() for k, v in parts.items()}, \
            grads
    return vg


def value_and_grad(cfg: ModelConfig, params, batch, gather_specs=None):
    """``loss_fn``'s value and its gradient for every parameter leaf:
    (loss, {"ce", "aux"}, grads shaped like params, in the params'
    types)."""
    return _value_and_grad_of(cfg, lambda tree, b: T.loss_fn(
        tree, cfg, b, gather_specs=gather_specs))(params, batch)


UPDATES = {"adamw": adamw_update, "adamw8bit": adamw8bit_update}


def _update_fn(opt_impl: str):
    if opt_impl not in UPDATES:
        raise ValueError(f"unknown opt_impl {opt_impl!r}")
    return UPDATES[opt_impl]


def _grads(cfg: ModelConfig, params, batch, microbatches: int,
           value_and_grad_fn):
    """(loss, parts, grads) of the batch: ``value_and_grad_fn(params,
    batch)`` once, or over ``microbatches`` with the gradients summed in
    float32 and every result divided by their count."""
    if microbatches == 1:
        return value_and_grad_fn(params, batch)
    m = microbatches
    grads = tree_map(lambda p: torch.zeros(
        p.shape, dtype=torch.float32, device=p.device), params)
    loss = ce = aux = 0.0
    for j in range(m):
        l, p, g = value_and_grad_fn(params, _microbatch(batch, j, m))
        _tree_zip(lambda a, b: a.add_(b), grads, g)
        loss, ce, aux = loss + l, ce + p["ce"], aux + p["aux"]
        del g
    grads = tree_map(lambda x: x.div_(m), grads)
    return loss / m, {"ce": ce / m, "aux": aux / m}, grads


def make_train_step(cfg: ModelConfig, opt_cfg: AdamWConfig,
                    grad_transform=None, microbatches: int = 1,
                    opt_impl: str = "adamw", gather_specs=None,
                    ef_transform=None):
    """(params, opt_state, batch) -> (params', opt_state', metrics), the
    first two updated in place; metrics ``loss, ce, aux, grad_norm, lr``
    as 0-d tensors on the device.

    ``microbatches > 1`` splits the batch (microbatch j takes rows j,
    j + m, ..., as the JAX reshape does: ``_microbatch``) and accumulates
    the gradients in float32; the optimizer sees their mean.
    ``grad_transform`` hooks in a stateless gradient transform.
    ``opt_impl``: "adamw" (float32 moments, ``init_opt_state``) or
    "adamw8bit" (int8 / uint8 moments, ``init_opt_state_8bit``).
    ``gather_specs`` goes to ``loss_fn`` (the per-layer gather points;
    specs without callables do nothing).  ``ef_transform`` hooks in
    stateful gradient compression (``compression``): the step becomes
    (params, opt_state, batch, ef) -> (params', opt_state', metrics,
    ef')."""
    update = _update_fn(opt_impl)
    vg = _value_and_grad_of(cfg, lambda tree, b: T.loss_fn(
        tree, cfg, b, gather_specs=gather_specs))

    def train_step(params, opt_state, batch, ef=None):
        loss, parts, grads = _grads(cfg, params, batch, microbatches, vg)
        if ef_transform is not None:
            grads, ef = ef_transform(grads, ef)
        elif grad_transform is not None:
            grads = grad_transform(grads)
        params, opt_state, om = update(grads, opt_state, params, opt_cfg)
        metrics = {"loss": loss, "ce": parts["ce"], "aux": parts["aux"],
                   **om}
        if ef_transform is not None:
            return params, opt_state, metrics, ef
        return params, opt_state, metrics

    return _with_ef(train_step, ef_transform)


def _with_ef(train_step, ef_transform):
    """``train_step`` as the 3-argument step when there is no
    ``ef_transform`` (the signature for stateless callers, as in JAX)."""
    if ef_transform is not None:
        return train_step

    def stateless(params, opt_state, batch):
        return train_step(params, opt_state, batch)

    return stateless


def stacked_gathers(mesh, pspecs):
    """``gather_specs`` for ``loss_fn`` in the smap step: a gather on use
    (``sharding.gather_on_use``) for each leaf of the stacked subtrees
    (``layers``, ``groups``, ``enc_layers``, ``dec_layers``), under its
    spec without the layer axis."""
    return {key: tree_map(
        lambda s: functools.partial(
            sh.gather_on_use, sharding=sh.NamedSharding(mesh, sh.P(*s[1:]))),
        pspecs[key]) for key in STACKED if key in pspecs}


def _zero_dim(pspec, ospec, ndim: int):
    """The dim ZeRO-1 adds "data" to (a moment shard is a slice of the
    param shard along it), or None."""
    for i in range(ndim):
        pa = sh.entry_axes(pspec[i]) if i < len(pspec) else ()
        oa = sh.entry_axes(ospec[i]) if i < len(ospec) else ()
        if "data" in oa and "data" not in pa:
            return i
    return None


def _sharded_update(cfg: ModelConfig, opt_cfg: AdamWConfig, mesh, pspecs,
                    opt_impl: str, ef_transform=None):
    """The common tail of the mesh steps: (params, opt_state, grads, ef) ->
    (optimizer metrics, ef'), on this rank's synced gradient shards.
    ``ef_transform(grads, ef, rows=...)`` (the Trainer's cross-pod
    compression) runs first.  The gradient norm is the global gradient's:
    each leaf's squares are summed over the ranks of a pod that hold its
    distinct parts (the ranks that hold the same part hold the same
    values).  The update runs on each rank's moment shards: where ZeRO-1
    cut a moment along a dim the param shard keeps whole, the rank
    updates that slice and the slices are gathered over "data"; a row the
    mesh cuts reduces its 8-bit scale over the ranks that share it."""
    update = _update_fn(opt_impl)
    comm = mesh.comm()
    plane = tuple(a for a in mesh.axis_names if a != "pod")
    ospecs = (sh.opt_specs_8bit if opt_impl == "adamw8bit"
              else sh.opt_specs)(cfg, mesh, pspecs)
    qspecs = sh.q_specs(ospecs["m"])

    def norm(grads):
        total = None
        for g, spec in zip(_leaves(grads), _leaves(pspecs)):
            axes = {a for _, ax in sh.sharded_dims(spec, g.dim()) for a in ax}
            rep = comm.size([a for a in plane if a not in axes])
            sq = sum(p.float().square().sum() for p in _pieces(g)) / rep
            total = sq if total is None else total + sq
        return torch.sqrt(comm.all_reduce(total.reshape(1), plane))[0]

    ndims = tree_map(lambda d: len(d.shape), model_def(cfg))
    # the rows a mesh axis cuts: the 8-bit moments' and the compressed
    # gradients' row groups
    q_rows = sh.row_groups(qspecs, ndims, mesh)
    g_rows = sh.row_groups(pspecs, ndims, mesh)
    # ZeRO-1: each rank updates the slice of its param shard that its
    # moment shard covers, then the slices are gathered over "data" (on a
    # "data" axis of one rank the slice is the shard: nothing to gather)
    j, n_data = comm.index(("data",)), comm.size(("data",))
    cut = tree_map(lambda ps, os_, nd: _zero_dim(ps, os_, nd)
                   if n_data > 1 else None, pspecs, qspecs, ndims)

    def narrow(t, z):
        if z is None:
            return t
        n = t.shape[z] // n_data
        return t.narrow(z, j * n, n)

    def apply(params, opt_state, grads, ef):
        if ef_transform is not None:
            grads, ef = ef_transform(grads, ef, rows=g_rows)
        gnorm = norm(grads)
        pv = tree_map(narrow, params, cut)
        kw = {"rows": q_rows} if opt_impl == "adamw8bit" else {}
        _, _, om = update(tree_map(narrow, grads, cut), opt_state, pv,
                          opt_cfg, gnorm=gnorm, **kw)
        tree_map(lambda p, v, z: z is not None and p.copy_(
            comm.all_gather(v, ("data",), z)), params, pv, cut)
        return om, ef

    return apply


def make_train_step_smap(cfg: ModelConfig, opt_cfg: AdamWConfig, mesh,
                         pspecs, batch_specs, *, microbatches: int = 1,
                         opt_impl: str = "adamw", compress_pod: bool = False,
                         ef_transform=None):
    """Data-parallel train step with ONE gradient sync a step, on
    ``torch.distributed`` (the JAX package's ``make_train_step_smap``).

    (params, opt_state, batch) -> (params', opt_state', metrics): this
    rank's shards of the parameters (``pspecs``) and of the optimizer
    state (``sharding.opt_specs`` or, for "adamw8bit",
    ``sharding.opt_specs_8bit``: ZeRO-1), updated in place, and the
    GLOBAL batch, of
    which the rank takes its rows by ``batch_specs``.  Every rank of
    ``mesh`` calls it; ``mesh.comm()`` needs an initialized process group
    of at least ``mesh.size`` ranks (none for a mesh of one).

    The batch axes ("pod", "data") are manual: every rank computes the
    gradient of its rows' mean loss.  Each leaf its spec shards is
    gathered on use (``sharding.gather_on_use``: the stacked layers'
    leaves when their layer runs, through ``loss_fn``'s ``gather_specs``,
    the others at the top), so a data-sharded (FSDP) leaf's gradient comes
    back summed over "data" and sliced; a model-sharded leaf's is sliced
    only (the ranks of "model" see the same rows and repeat the same
    compute).  Then, as the JAX ``sync``: FSDP leaves are summed over
    "pod", the others over ("pod", "data") — or, with ``compress_pod``,
    over "data" and then sent as int8 over "pod" (each pod scales by the
    max |g| of its own sum, and every rank multiplies the pods' summed
    int8 values by its own pod's scale, as the JAX step's does) — and
    every sum is divided by the number of batch shards.  Loss and parts
    are averaged over the batch axes.  The rest is ``_sharded_update``'s:
    ``ef_transform``, the global gradient norm and the ZeRO-1 update."""
    comm = mesh.comm()
    manual = tuple(a for a in sh.BATCH_AXES if a in mesh.axis_names)
    nsh = comm.size(manual)
    pshard = sh.named(mesh, pspecs)
    # as the JAX step's ``manualize``: a batch entry that is one manual
    # axis is split over it; a tuple of axes — ("pod", "data") on a mesh
    # with a pod axis — is no manual axis, so every rank takes those rows
    # whole (ROADMAP C)
    bshard = {k: sh.NamedSharding(mesh, sh.P(*(
        e if isinstance(e, str) and e in manual else None for e in spec)))
        for k, spec in batch_specs.items()}

    # the other top-level leaves are gathered in loss_of
    gtree = stacked_gathers(mesh, pspecs)

    def loss_of(tree, b):
        tree = dict(tree)
        for k in tree:
            if k not in STACKED:
                tree[k] = tree_map(sh.gather_on_use, tree[k], pshard[k])
        return T.loss_fn(tree, cfg, b, gather_specs=gtree)

    vg = _value_and_grad_of(cfg, loss_of)

    def sync(g, spec):
        axes = {a for _, ax in sh.sharded_dims(spec, g.dim()) for a in ax}
        if "data" in axes:                       # FSDP: summed over data
            if "pod" in manual:
                comm.all_reduce(g, ("pod",))
            return g.div_(nsh)
        if compress_pod and "pod" in manual:
            comm.all_reduce(g, ("data",))
            amax = g.abs().amax().reshape(1)
            model = [a for a in sorted(axes) if a not in manual]
            if model:                            # the leaf's other parts
                comm.all_reduce(amax, model, "max")
            scale = amax / 127.0 + 1e-12
            q = torch.round(g / scale).clamp_(-127, 127).to(torch.int8)
            pods = comm.all_gather(q.reshape(1, -1), ("pod",), 0)
            total = pods[0].to(g.dtype)
            for row in pods[1:]:
                total = total + row.to(g.dtype)
            return total.reshape(g.shape).mul_(scale).div_(nsh)
        comm.all_reduce(g, manual)
        return g.div_(nsh)

    finish = _sharded_update(cfg, opt_cfg, mesh, pspecs, opt_impl,
                             ef_transform)

    def train_step(params, opt_state, batch, ef=None):
        lb = {k: sh.shard(v, bshard[k]) for k, v in batch.items()}
        loss, parts, grads = _grads(cfg, params, lb, microbatches, vg)
        grads = tree_map(sync, grads, pspecs)
        loss = comm.all_reduce(loss.reshape(1).clone(), manual)[0] / nsh
        parts = {k: comm.all_reduce(v.reshape(1).clone(), manual)[0] / nsh
                 for k, v in parts.items()}
        om, ef = finish(params, opt_state, grads, ef)
        metrics = {"loss": loss, "ce": parts["ce"], "aux": parts["aux"],
                   **om}
        if ef_transform is not None:
            return params, opt_state, metrics, ef
        return params, opt_state, metrics

    return _with_ef(train_step, ef_transform)


def tp_layer_types(cfg: ModelConfig, mesh):
    """The layer types ``make_train_step_spmd`` splits over "model" on
    ``mesh``: every type, each block cutting the axes that ``axis_rules``
    puts on "model" and computing the others whole — but an SSD layer
    only where its heads are cut (``d_inner`` and ``ssd_bc`` may divide
    where the heads do not: its leaves are then gathered on use and the
    block computes whole, as the smap step's)."""
    heads = sh.axis_rules(cfg, mesh, fsdp=False)["ssd_heads"] == "model"
    return ("attn", "rec", "enc", "dec") + (("ssd",) if heads else ())


def tensor_parallel(cfg: ModelConfig, mesh, means: bool = True):
    """The ``TensorParallel`` of ``make_train_step_spmd`` on ``mesh``'s
    comm: the logical axes ``axis_rules`` cuts over "model", the batch
    over the mesh's batch axes; ``means=False`` for the serving steps (no
    batch means)."""
    from repro_torch.models.tensor_parallel import TensorParallel
    rules = sh.axis_rules(cfg, mesh, fsdp=False)
    return TensorParallel(mesh.comm(), [k for k, v in rules.items()
                                        if k is not None and v == "model"],
                          [a for a in sh.BATCH_AXES if a in mesh.axis_names],
                          means=means)


def _by_split(cfg: ModelConfig, mesh, pspecs, fn):
    """A tree like ``pspecs``: ``fn(specs, split)`` of each layer's specs
    (a stacked subtree's without the layer axis) and of each other
    top-level entry, ``split`` whether ``make_train_step_spmd`` computes
    it on the rank's model shards — the embedding, the head and the
    layers of ``tp_layer_types``."""
    split = tp_layer_types(cfg, mesh)

    def unstack(tree):
        return tree_map(lambda s: sh.P(*s[1:]), tree)

    out = {}
    for key, sub in pspecs.items():
        if key == "layers":
            out[key] = fn(unstack(sub), cfg.layer_types()[0] in split)
        elif key in ("groups", "tail"):   # a hybrid's layers
            types = hybrid_layer_names(cfg)[key]
            out[key] = {n: fn(unstack(v) if key == "groups" else v,
                              types[n] in split)
                        for n, v in sub.items()}
        elif key in STACKED:              # the encoder's and decoder's
            out[key] = fn(unstack(sub), key[:3] in split)
        else:
            out[key] = fn(sub, key in ("embed", "head"))
    return out


def spmd_gathers(cfg: ModelConfig, mesh, pspecs):
    """``make_train_step_spmd``'s gather on use for every leaf: over its
    batch axes only ("data" under FSDP) where the rank computes on its
    model shard (``_by_split``), over all of its axes elsewhere, as the
    smap step's."""
    def gathers(specs, split):
        return tree_map(lambda s: functools.partial(
            sh.gather_on_use, sharding=sh.NamedSharding(
                mesh, sh.batch_only(s) if split else s)), specs)
    return _by_split(cfg, mesh, pspecs, gathers)


def _partial_over_model(cfg: ModelConfig, mesh, pspecs):
    """A tree of bools like ``pspecs``: the leaves whose gradient a rank of
    the spmd step holds only its part of, to be summed over "model" — a
    replicated ``wk`` / ``wv`` of a split attention layer's self- or
    cross-attention, of which the rank reads its query heads' kv heads."""
    rules = sh.axis_rules(cfg, mesh, fsdp=False)
    partial = rules["heads"] == "model" and rules["kv_heads"] is None

    def mark(specs, split):
        out = tree_map(lambda s: False, specs)
        for key in ("attn", "cross"):
            if split and partial and key in specs:
                out[key].update(wk=True, wv=True)
        return out
    return _by_split(cfg, mesh, pspecs, mark)


def make_train_step_spmd(cfg: ModelConfig, opt_cfg: AdamWConfig, mesh,
                         pspecs, batch_specs, *, microbatches: int = 1,
                         opt_impl: str = "adamw", ef_transform=None):
    """The port's counterpart of the JAX package's default train step on a
    mesh: ``make_train_step`` jitted with the ``param_specs`` /
    ``opt_specs_for`` / ``batch_specs`` shardings, which GSPMD partitions
    into one program for the whole mesh.  Here every rank of ``mesh``
    runs its part of it, on ``torch.distributed`` (``mesh.comm()``).

    (params, opt_state, batch) -> (params', opt_state', metrics), as
    ``make_train_step_smap``: this rank's parameter and ZeRO-1 moment
    shards, updated in place, and the GLOBAL batch.

    * The batch is cut over every batch axis: the rank takes its rows of
      ``batch_specs`` (``P(("pod", "data"), None)``, pod major), and
      every mean is the global batch's — the loss's token count and the
      MoE load-balance means are summed over the batch axes
      (``models/tensor_parallel.py``), so the ranks' losses add up to the
      global loss and their gradients to its gradient: the gradients are
      summed over the batch axes once a step, not averaged.
    * Tensor-parallel compute on "model" (``TensorParallel``): the
      embedding, the vocabulary-parallel head and loss, and the layers of
      ``tp_layer_types`` — every type — compute on the rank's model
      shards: attention heads (the encoder's, the decoder's self- and
      cross-attention), ``ff`` slices of the MLP and the experts, the
      SSD's heads (its B and C gathered), the RG-LRU's channels; a leaf
      the specs leave whole is computed with on every rank.  Only an SSD
      layer whose heads the axis does not divide gathers its leaves on
      use over "model", as the smap step does.
    * FSDP: a leaf sharded over "data" is gathered on use over "data"
      (``spmd_gathers``; the stacked layers' inside the recomputed
      region), its gradient summed over "data" and sliced by the gather's
      backward, then summed over "pod".  Every other gradient is summed
      over the batch axes, a replicated ``wk`` / ``wv`` of a split
      attention also over "model" (``_partial_over_model``); a
      model-sharded leaf's stays the rank's slice.
    * The rest is ``_sharded_update``'s (``ef_transform``, the global
      gradient norm, ZeRO-1 moments and the 8-bit row scales).

    Metrics are the global batch's.  ``microbatches`` splits the rank's
    rows as ``make_train_step`` splits the global batch (microbatch j
    takes rows j, j + m, ... of it, of which the rank holds its own)."""
    comm = mesh.comm()
    tp = tensor_parallel(cfg, mesh)
    batch_axes = tp.batch_axes
    bshard = sh.named(mesh, batch_specs)
    gat = spmd_gathers(cfg, mesh, pspecs)
    gtree = {k: v for k, v in gat.items() if k in STACKED}
    partial = _partial_over_model(cfg, mesh, pspecs)

    def loss_of(tree, b):
        tree = dict(tree)
        for k in tree:
            if k not in STACKED:
                tree[k] = tree_map(lambda w, f: f(w), tree[k], gat[k])
        return T.loss_fn(tree, cfg, b, gather_specs=gtree, tp=tp)

    vg = _value_and_grad_of(cfg, loss_of)

    def sync(g, spec, part):
        axes = {a for _, ax in sh.sharded_dims(spec, g.dim()) for a in ax}
        over = [a for a in batch_axes if a not in axes]
        if part:
            over.append("model")
        if over:
            comm.all_reduce(g, over)
        return g

    finish = _sharded_update(cfg, opt_cfg, mesh, pspecs, opt_impl,
                             ef_transform)

    def train_step(params, opt_state, batch, ef=None):
        lb = {k: sh.shard(v, bshard[k]) for k, v in batch.items()}
        rows = lb["tokens"].shape[0]
        if rows % microbatches:
            raise ValueError(f"a rank's {rows} rows of the batch do not "
                             f"split into {microbatches} microbatches")
        loss, parts, grads = _grads(cfg, params, lb, microbatches, vg)
        grads = tree_map(sync, grads, pspecs, partial)
        # the ranks' ce shares add up to the global ce; aux is global
        ce = comm.all_reduce(parts["ce"].reshape(1).clone(), batch_axes)[0]
        metrics = {"loss": ce + (loss - parts["ce"]), "ce": ce,
                   "aux": parts["aux"]}
        om, ef = finish(params, opt_state, grads, ef)
        metrics.update(om)
        if ef_transform is not None:
            return params, opt_state, metrics, ef
        return params, opt_state, metrics

    return _with_ef(train_step, ef_transform)


_LAYER_LEAF = {"cross_k": "ck", "cross_v": "cv"}


def cache_cuts(cfg: ModelConfig, mesh, max_len: int, src_len: int = 0):
    """The dims of the decode cache that ``sharding.cache_specs`` cuts over
    "model" on ``mesh``, for a context of ``max_len`` (and, for an
    encoder-decoder model, ``src_len`` source frames): {a layer's cache
    leaf name (``cross_k`` / ``cross_v`` as its ``ck`` / ``cv``): the dim,
    counted from the end} — the rings' window axis, the cross keys' and
    values' source axis, the states' heads or channels, each only where
    "model" divides it; none where "model" holds one rank."""
    if mesh.shape["model"] == 1:
        return {}
    spec = dec.cache_view_specs(cfg, max_len, src_len)
    specs = sh.cache_specs(cfg, mesh, dec.tree_from_leaves(
        spec, [types.SimpleNamespace(shape=shp) for shp in spec.shapes]))
    out = {}
    for path, shp, ps in zip(spec.paths, spec.shapes,
                             dec.tree_leaves(specs, spec)):
        for i, e in enumerate(ps):
            if "model" in sh.entry_axes(e):
                out[_LAYER_LEAF.get(path[-1], path[-1])] = i - len(shp)
    return out


def _serving_params(cfg: ModelConfig, mesh, pspecs):
    """(top, gather_specs) of the spmd serving steps: ``top(params)``
    gathers the top-level leaves on use and the stacked layers' are
    gathered as each layer runs — over their batch axes only ("data"
    under FSDP) where the rank computes on its model shards, over every
    axis elsewhere (``spmd_gathers``, the spmd train step's)."""
    gat = spmd_gathers(cfg, mesh, pspecs)

    def top(params):
        return {k: v if k in STACKED else tree_map(lambda w, f: f(w), v,
                                                    gat[k])
                for k, v in params.items()}
    return top, {k: v for k, v in gat.items() if k in STACKED}


def make_prefill_spmd(cfg: ModelConfig, mesh, pspecs, max_len: int):
    """The port's counterpart of the JAX package's ``make_prefill`` jitted
    with the ``param_specs`` and ``batch_specs`` shardings (GSPMD), the
    decode cache laid out by ``cache_specs``: every rank of ``mesh`` runs
    its part of it, on ``torch.distributed`` (``mesh.comm()``).

    (params, batch) -> (logits (B, V), cache): this rank's parameter
    shards (``pspecs``), its rows of the batch as ``batch_specs`` cuts it
    over the mesh's batch axes — the prompts ``tokens`` and the family's
    extras, as ``make_prefill`` takes them (an MoE block routes the
    global batch's rows jointly, as the spmd train step's) — the logits
    of its rows over the whole
    vocabulary on every rank of "model", and its shard of the decode cache
    of capacity ``max_len`` (``cache_cuts``): the attention rings' window
    axis cut over "model", every kv head in each slice; the cross keys
    and values' source axis; the states' heads or channels.

    The forward is the spmd train step's (``tensor_parallel``, with no
    batch means): the vocabulary-parallel embedding, every layer on the
    rank's heads, ``ff`` slice, SSD heads or LRU channels, through the
    flash, SSD and LRU kernels on the card; a leaf the specs put on
    "data" (FSDP) gathered along "data" as its layer runs, and a layer
    leaf gathered along "model" only for an SSD layer whose heads the
    axis does not divide (``tp_layer_types``).  Each attention layer's
    keys and values, computed for the rank's kv heads, are ring-arranged,
    gathered over "model" and cut to the rank's window slice as the layer
    finishes (``decode._kv_part``), so no (L, B, S, ...) is held."""
    tp = tensor_parallel(cfg, mesh, means=False)
    top, gtree = _serving_params(cfg, mesh, pspecs)
    cuts = {}

    @torch.no_grad()
    def serve_prefill(params, batch):
        extras = {k: v for k, v in batch.items() if k != "tokens"}
        src = extras["frame_embeds"].shape[1] if "frame_embeds" in extras \
            else 0
        if src not in cuts:
            cuts[src] = cache_cuts(cfg, mesh, max_len, src)
        return dec.prefill(top(params), cfg, batch["tokens"], extras,
                           max_len=max_len, gather_specs=gtree, tp=tp,
                           cut=cuts[src])

    return serve_prefill


def make_serve_step_spmd(cfg: ModelConfig, mesh, pspecs, max_len: int,
                         src_len: int = 0):
    """The port's counterpart of the JAX package's ``make_serve_step``
    jitted with the ``param_specs``, ``batch_specs`` and ``cache_specs``
    shardings: (params, cache, tokens, pos[, extras]) -> (logits (B, V),
    cache'), every rank of ``mesh`` on its parameter shards, its rows of
    ``tokens`` (B, 1), ``pos`` (B,) and a VLM's ``position_ids`` (3, B,
    1), and its shard of the decode cache of capacity ``max_len`` (and
    ``src_len`` source frames) as ``cache_specs`` cuts it, written in
    place; the logits of its rows over the whole vocabulary on every rank
    of "model".

    Every layer computes on the rank's model shards, as the spmd prefill's
    (``make_prefill_spmd``; the MoE experts dropless on the rank's ``ff``
    slice).  Attention (``decode._decode_attn_tp``): the token's q of the
    rank's heads and its k and v of every kv head (gathered where the
    specs cut ``wk`` / ``wv``, computed whole where they are replicated),
    written by the rank that holds slot ``pos % W``; q gathered over
    "model", each rank scores its own slots at their absolute positions
    and the ranks' softmax parts are combined over "model"
    (``layers.split_decode_attention``: an all-reduce of the maxima, then
    of the rescaled sums and outputs); each rank's heads then go through
    its ``wo`` rows, summed over "model".  The cross-attention does the
    same over its cut source frames.  Where "model" does not divide a
    cache leaf's axis, the rank holds it whole and nothing is combined.
    The SSD and RG-LRU layers update the rank's heads' and channels'
    state; an SSD layer computed whole gathers its cut state leaves and
    keeps its slices of the new ones."""
    tp = tensor_parallel(cfg, mesh, means=False)
    top, gtree = _serving_params(cfg, mesh, pspecs)
    cut = cache_cuts(cfg, mesh, max_len, src_len)

    @torch.no_grad()
    def serve_step(params, cache, tokens, pos, extras=None):
        return dec.decode_step(top(params), cfg, cache, tokens, pos, extras,
                               gather_specs=gtree, tp=tp, cut=cut)

    return serve_step


def _microbatch(batch, j: int, m: int):
    """Microbatch ``j`` of ``m``: rows j, j + m, ... of every batch tensor
    (the batch axis of M-RoPE's ``position_ids`` (3, B, S) is its
    second)."""
    return {k: v[:, j::m] if k == "position_ids" else v[j::m]
            for k, v in batch.items()}


def _tree_zip(fn, a, b):
    if isinstance(a, dict):
        for k in a:
            _tree_zip(fn, a[k], b[k])
    else:
        fn(a, b)


def make_eval_step(cfg: ModelConfig):
    """(params, batch) -> {"loss", "ce", "aux"}, without gradients."""

    @torch.no_grad()
    def eval_step(params, batch):
        loss, parts = T.loss_fn(params, cfg, batch)
        return {"loss": loss, **parts}

    return eval_step


def make_prefill(cfg: ModelConfig, max_len: int, gather_specs=None):
    """(params, batch) -> (last-token logits (B, V), cache): whole-prompt
    prefill of ``batch["tokens"]`` (B, S) into a decode cache of capacity
    ``max_len``; every other key of ``batch`` goes to ``decode.prefill``
    as its extras (a VLM's ``vision_embeds`` and ``position_ids``, an
    encoder-decoder model's ``frame_embeds``).  ``gather_specs``: the
    per-layer gather points, as ``make_train_step`` takes them (a leaf
    given a callable is replaced by its result when its layer runs — a
    rank's shards gathered on use; specs without callables do nothing)."""

    def serve_prefill(params, batch):
        extras = {k: v for k, v in batch.items() if k != "tokens"}
        return dec.prefill(params, cfg, batch["tokens"], extras,
                           max_len=max_len, gather_specs=gather_specs)

    return serve_prefill


def make_serve_step(cfg: ModelConfig, gather_specs=None):
    """(params, cache, tokens, pos[, extras]) -> (logits, cache').
    ``gather_specs``: as ``make_prefill``'s."""

    def serve_step(params, cache, tokens, pos, extras=None):
        return dec.decode_step(params, cfg, cache, tokens, pos, extras,
                               gather_specs=gather_specs)

    return serve_step


def _check_chunk_mode(mode: str, chunk_kernel: str):
    if mode not in ("scan", "parallel"):
        raise ValueError(f"unknown chunk-step mode {mode!r}")
    if chunk_kernel not in ("dense", "blocked"):
        raise ValueError(f"unknown chunk kernel {chunk_kernel!r}")


def make_serve_chunk_step(cfg: ModelConfig, spec, mode: str = "scan",
                          chunk_kernel: str = "dense"):
    """(params, cache, tokens (B, C), pos, n_tokens[, extras]) ->
    (last-active-token logits, cache').  The continuous-batching mixed
    step: prefill chunks and decode streams share one batched call with
    per-stream lengths.  ``mode="scan"`` (the default, as in the JAX
    package) is the per-token reference, C single-token steps
    (``chunk_decode_step``); ``mode="parallel"`` one fused multi-token
    forward per tick, whose attention ``chunk_kernel`` picks: "blocked"
    (the CUDA kernel on the card) or "dense" (the plain masked softmax).
    The scan path ignores ``chunk_kernel``."""
    _check_chunk_mode(mode, chunk_kernel)

    def serve_chunk_step(params, cache, tokens, pos, n_tokens, extras=None):
        if mode == "parallel":
            return dec.prefill_chunk_step(params, cfg, spec, cache, tokens,
                                          pos, n_tokens, extras,
                                          chunk_kernel=chunk_kernel)
        return dec.chunk_decode_step(params, cfg, spec, cache, tokens, pos,
                                     n_tokens, extras)

    return serve_chunk_step


def make_spec_verify_step(cfg: ModelConfig, spec, mode: str = "scan",
                          chunk_kernel: str = "dense"):
    """(params, cache, tokens (B, C), pos, n_tokens[, extras]) ->
    (per-position logits (B, C, V), cache').  The speculative-decode
    VERIFY step: the masked chunk step of ``make_serve_chunk_step`` (same
    ``mode`` and ``chunk_kernel``) returning the logits after EVERY fed
    token, so greedy acceptance can compare each draft token with the
    argmax one position earlier.  Positions at or past ``n_tokens`` come
    back NEG_INF."""
    _check_chunk_mode(mode, chunk_kernel)

    def spec_verify_step(params, cache, tokens, pos, n_tokens, extras=None):
        if mode == "parallel":
            return dec.prefill_chunk_step(params, cfg, spec, cache, tokens,
                                          pos, n_tokens, extras,
                                          chunk_kernel=chunk_kernel,
                                          all_logits=True)
        return dec.chunk_decode_step(params, cfg, spec, cache, tokens, pos,
                                     n_tokens, extras, all_logits=True)

    return spec_verify_step


def make_spill_gather_async(spec):
    """(storage, blocks, state_slot, out, stream) -> event: the issue half
    of an asynchronous spill.  The pages are snapshotted on the current
    stream and copied into the host tensors ``out`` on ``stream``; the
    returned event completes when they have landed (None on the CPU, where
    the copy is done on return)."""

    def spill_gather_async(storage, blocks, state_slot=None, *, out,
                           stream=None):
        return dec.extract_pool_entries_async(storage, spec, blocks,
                                              state_slot=state_slot,
                                              out=out, stream=stream)

    return spill_gather_async


def make_spill_scatter(spec):
    """(storage, blocks, host_leaves, state_slot) -> storage: writes
    spilled pages back into a fresh reservation's blocks."""

    def spill_scatter(storage, blocks, host_leaves, state_slot=None):
        return dec.insert_pool_entries(storage, spec, blocks, host_leaves,
                                       state_slot=state_slot)

    return spill_scatter


def make_rows_gather(spec):
    """(storage, blocks, state_slots) -> per-leaf device tensors: one
    batched gather of many streams' pages + state slots."""

    def rows_gather(storage, blocks, state_slots=()):
        return dec.gather_pool_rows(storage, spec, blocks,
                                    state_slots=state_slots)

    return rows_gather


def make_rows_scatter(spec):
    """(storage, blocks, leaves, state_slots) -> storage: inverse of
    ``make_rows_gather``."""

    def rows_scatter(storage, blocks, leaves, state_slots=()):
        return dec.scatter_pool_rows(storage, spec, blocks, leaves,
                                     state_slots=state_slots)

    return rows_scatter


def make_prefix_fork(spec):
    """(storage, src_blocks, dst_blocks[, src_state, dst_state]) ->
    storage: the copy behind prefix-sharing copy-on-write — duplicate a
    shared page into a private block, and/or fork (``src_state`` > 0) or
    scrub (``src_state == 0``) a carried-state slot."""

    def prefix_fork(storage, src_blocks, dst_blocks,
                    src_state=None, dst_state=None):
        if not src_blocks and src_state is not None:
            if src_state == 0:          # no donor: scrub to the init state
                return dec.zero_state_slot(storage, spec, dst_state)
            return dec.fork_state_slot(storage, spec, src_state, dst_state)
        return dec.copy_pool_entries(storage, spec, src_blocks, dst_blocks,
                                     src_state=src_state,
                                     dst_state=dst_state)

    return prefix_fork


def make_generate(cfg: ModelConfig, steps: int, temperature: float = 0.0):
    """(params, cache, tokens (B, 1), pos (B,), generator) -> (tokens (B,
    steps), cache', pos'): ``steps`` single-token steps from the last
    token, each feeding back its greedy token (``temperature == 0``) or
    one drawn from softmax(logits / temperature) with the
    ``torch.Generator`` ``generator`` (which may be None when greedy).
    The cache is written in place."""
    serve_step = make_serve_step(cfg)

    @torch.no_grad()
    def generate(params, cache, tokens, pos, generator=None):
        out = []
        tok, pos = tokens, pos
        for _ in range(steps):
            logits, cache = serve_step(params, cache, tok, pos)
            if temperature > 0:
                probs = torch.softmax(logits / temperature, dim=-1)
                nxt = torch.multinomial(probs, 1, generator=generator)
            else:
                nxt = logits.argmax(dim=-1, keepdim=True)
            tok = nxt.to(torch.int32)
            out.append(tok[:, 0])
            pos = pos + 1
        return torch.stack(out, dim=1), cache, pos

    return generate
