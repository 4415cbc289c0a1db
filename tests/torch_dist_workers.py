"""Worker side of the port's multi-rank CPU tests: ``run_ranks`` starts
one process per rank (``spawn``), each joins a gloo process group over a
``FileStore`` in the test's temporary directory, runs one scenario
function of this module and writes what it returns (a dict of numpy
arrays and numbers) to ``<out>/rank<r>.npz``.  Not a test file: the
tests import it."""
from __future__ import annotations

import multiprocessing
import os
import pickle
import traceback

import numpy as np


def _entry(rank, world, store_path, scenario, kwargs, out_dir):
    import torch
    import torch.distributed as dist
    torch.set_num_threads(1)
    try:
        store = dist.FileStore(store_path, world)
        dist.init_process_group("gloo", store=store, rank=rank,
                                world_size=world)
        try:
            result = globals()[scenario](rank, **kwargs)
        finally:
            dist.destroy_process_group()
        with open(os.path.join(out_dir, f"rank{rank}.pkl"), "wb") as f:
            pickle.dump(result, f)
    except BaseException:            # the parent reads the traceback
        with open(os.path.join(out_dir, f"rank{rank}.err"), "w") as f:
            f.write(traceback.format_exc())
        raise


def run_ranks(scenario: str, world: int, tmp, timeout: float, **kwargs):
    """``scenario(rank, **kwargs)`` on ``world`` gloo ranks; returns each
    rank's result, in rank order.  Raises on a rank's error or when the
    ranks are not done within ``timeout`` seconds (every process is then
    killed)."""
    out_dir = os.path.join(str(tmp), f"ranks_{scenario}")
    os.makedirs(out_dir, exist_ok=True)
    ctx = multiprocessing.get_context("spawn")
    procs = [ctx.Process(target=_entry, args=(
        r, world, os.path.join(out_dir, "store"), scenario, kwargs, out_dir))
        for r in range(world)]
    for p in procs:
        p.start()
    try:
        for p in procs:
            p.join(timeout)
            if p.is_alive():
                raise TimeoutError(f"{scenario}: a rank is still running "
                                   f"after {timeout} s")
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join()
    errors = [open(os.path.join(out_dir, f)).read()
              for f in sorted(os.listdir(out_dir)) if f.endswith(".err")]
    if errors:
        raise RuntimeError(f"{scenario} failed on a rank:\n{errors[0]}")
    out = []
    for r in range(world):
        with open(os.path.join(out_dir, f"rank{r}.pkl"), "rb") as f:
            out.append(pickle.load(f))
    return out


def _tree_np(tree):
    import torch
    if isinstance(tree, dict):
        return {k: _tree_np(v) for k, v in tree.items()}
    return tree.detach().cpu().numpy() if isinstance(tree, torch.Tensor) \
        else tree


def mesh_steps(rank, *, arch, params, batches, shape, axes, fsdp,
               microbatches, compress_pod, opt_impl, opt, impl="smap",
               over=None):
    """``make_train_step_smap`` (``impl="smap"``) or
    ``make_train_step_spmd`` ("spmd") for ``len(batches)`` steps from the
    whole parameters ``params`` (numpy), every rank on the same global
    batches; returns the losses, grad norms and this rank's gathered
    parameters.  ``over``: overrides of the reduced config."""
    import dataclasses
    import torch
    from repro_torch.configs import REGISTRY, reduced_config
    from repro_torch.launch import sharding as sh
    from repro_torch.launch.mesh import Mesh
    from repro_torch.launch.steps import (make_train_step_smap,
                                          make_train_step_spmd)
    from repro_torch.models.params import from_reference
    from repro_torch.optim.adamw import AdamWConfig, init_opt_state
    from repro_torch.optim.quantized import init_opt_state_8bit

    cfg = dataclasses.replace(reduced_config(REGISTRY[arch]), **(over or {}))
    mesh = Mesh(np.arange(int(np.prod(shape))).reshape(shape), axes)
    pspecs = sh.param_specs(cfg, mesh, fsdp=fsdp)
    psh = sh.named(mesh, pspecs)
    local = sh.shard_tree(from_reference(params, "cpu"), psh)
    init = init_opt_state_8bit if opt_impl == "adamw8bit" else init_opt_state
    ospecs = sh.opt_specs_for(cfg, mesh, pspecs, init({"x": torch.zeros(2)}))
    full_opt = init(from_reference(params, "cpu"))
    opt_state = {"m": sh.shard_tree(full_opt["m"], sh.named(mesh, ospecs["m"])),
                 "v": sh.shard_tree(full_opt["v"], sh.named(mesh, ospecs["v"])),
                 "count": full_opt["count"]}
    bspecs = sh.batch_specs(cfg, None, mesh)
    if impl == "spmd":
        step = make_train_step_spmd(
            cfg, AdamWConfig(**opt), mesh, pspecs, bspecs,
            microbatches=microbatches, opt_impl=opt_impl)
    else:
        step = make_train_step_smap(
            cfg, AdamWConfig(**opt), mesh, pspecs, bspecs,
            microbatches=microbatches, opt_impl=opt_impl,
            compress_pod=compress_pod)
    losses, norms = [], []
    for b in batches:
        local, opt_state, m = step(
            local, opt_state, {k: torch.from_numpy(np.array(v))
                               for k, v in b.items()})
        losses.append(float(m["loss"]))
        norms.append(float(m["grad_norm"]))
    full = sh.gather_tree(local, psh)
    return {"losses": losses, "norms": norms, "params": _tree_np(full),
            "bytes": dict(mesh.comm().bytes)}


def tp_pieces(rank, *, arch, seed):
    """The tensor-parallel pieces on a (data 2, model 4) mesh, each against
    the unsharded computation on the same rank: the vocabulary-parallel
    ``chunked_ce_loss`` (the rank's share of the global batch's mean, its
    input gradient and its head slice's gradient, float32) and the
    row-parallel MLP (output, input gradient, the ``wi`` / ``wo`` slices'
    gradients).  Returns both sides as numpy."""
    import dataclasses
    import torch
    from repro_torch.configs import REGISTRY, reduced_config
    from repro_torch.launch import sharding as sh
    from repro_torch.launch.mesh import Mesh
    from repro_torch.models import layers as L
    from repro_torch.models import transformer as T
    from repro_torch.models.params import init_params
    from repro_torch.models.tensor_parallel import TensorParallel

    # two loss chunks a row, and pad columns in the last vocabulary slice
    cfg = dataclasses.replace(reduced_config(REGISTRY[arch]), vocab=500)
    mesh = Mesh(np.arange(8).reshape(2, 4), ("data", "model"))
    comm = mesh.comm()
    pspecs = sh.param_specs(cfg, mesh)
    rules = sh.axis_rules(cfg, mesh, fsdp=False)
    tp = TensorParallel(comm, [k for k, v in rules.items()
                               if k is not None and v == "model"], ("data",))
    full = init_params(cfg, torch.Generator().manual_seed(seed), device="cpu")
    g = torch.Generator().manual_seed(seed + 1)
    B, S, D = 4, 2 * T.LOSS_CHUNK, cfg.d_model
    x = torch.randn(B, S, D, generator=g)
    tgt = torch.randint(0, cfg.vocab, (B, S), generator=g)
    mask = (torch.rand(B, S, generator=g) < 0.8).float()
    rows = slice(comm.index(("data",)) * 2, comm.index(("data",)) * 2 + 2)
    out = {}

    # the loss: whole on the global batch, against the rank's share
    head = full["head"].clone().requires_grad_(True)
    xf = x.clone().requires_grad_(True)
    ref = T.chunked_ce_loss({"embed": full["embed"], "head": head}, cfg, xf,
                            tgt, mask)
    ref.backward()
    hl = sh.shard(full["head"], sh.NamedSharding(mesh, pspecs["head"]))
    hl.requires_grad_(True)
    xr = x[rows].clone().requires_grad_(True)
    share = T.chunked_ce_loss({"embed": full["embed"], "head": hl}, cfg, xr,
                              tgt[rows], mask[rows], tp)
    share.backward()
    j = comm.index(("model",))
    n = hl.shape[1]
    out["ce"] = (float(ref), float(comm.all_reduce(share.detach().reshape(1),
                                                   ("data",))[0]))
    out["ce_dx"] = (xf.grad[rows].numpy(), xr.grad.numpy())
    out["ce_dhead"] = (head.grad[:, j * n:(j + 1) * n].numpy(),
                       comm.all_reduce(hl.grad.clone(), ("data",)).numpy())

    # the MLP: whole against row-parallel, on the rank's rows
    lp = {k: v[0] for k, v in full["layers"]["mlp"].items()}
    wf = {k: v.clone().requires_grad_(True) for k, v in lp.items()}
    xf = x[rows].clone().requires_grad_(True)
    yf = L.mlp_apply(xf, wf, cfg.activation)
    ct = torch.randn(yf.shape, generator=g)
    (yf * ct).sum().backward()
    spec = {k: sh.P(*v[1:]) for k, v in pspecs["layers"]["mlp"].items()}
    wl = {k: sh.shard(v, sh.NamedSharding(mesh, spec[k])).requires_grad_(True)
          for k, v in lp.items()}
    xr = x[rows].clone().requires_grad_(True)
    yr = L.mlp_apply(xr, wl, cfg.activation, tp=tp)
    (yr * ct).sum().backward()
    f = wl["wo"].shape[0]
    out["mlp_y"] = (yf.detach().numpy(), yr.detach().numpy())
    out["mlp_dx"] = (xf.grad.numpy(), xr.grad.numpy())
    out["mlp_dwi"] = (wf["wi"].grad[..., j * f:(j + 1) * f].numpy(),
                      wl["wi"].grad.numpy())
    out["mlp_dwo"] = (wf["wo"].grad[j * f:(j + 1) * f].numpy(),
                      wl["wo"].grad.numpy())
    out.update(_split_blocks(mesh, seed + 2))
    out["bytes"] = dict(comm.bytes)
    return out


def _split_pair(mesh, tp, run, inputs, lp, specs, g, partial=()):
    """``run(inputs, p, tp)`` whole (``tp`` None, the whole weights) and
    on the rank's shards of ``lp`` under ``specs`` (``tp``), the same
    cotangent into both: (output, input gradients, weight gradients),
    each as (whole, rank's) numpy pairs, the whole weights' gradients cut
    to the rank's shards.  The leaves named in ``partial`` (paths) hold
    the rank's part of their gradient: summed over "model" first."""
    import torch
    from repro_torch.launch import sharding as sh
    from repro_torch.models.params import _leaves, tree_map

    with torch.no_grad():
        ct = torch.randn(run(inputs, lp, None).shape, generator=g)

    def go(p, t):
        xs = [x.clone().requires_grad_(True) for x in inputs]
        y = run(xs, p, t)
        (y * ct).sum().backward()
        return y.detach(), [x.grad for x in xs]

    wf = tree_map(lambda v: v.clone().requires_grad_(True), lp)
    yf, dxf = go(wf, None)
    wl = tree_map(lambda v, s: sh.shard(v, sh.NamedSharding(mesh, s))
                  .requires_grad_(True), lp, specs)
    yl, dxl = go(wl, tp)
    comm = mesh.comm()
    dw = {}
    for (path, a), (_, b), (_, s) in zip(_leaves(wf), _leaves(wl),
                                         _leaves(specs)):
        got = b.grad.clone()
        if path in partial:
            got = comm.all_reduce(got, ("model",))
        dw["/".join(path)] = (
            sh.shard(a.grad, sh.NamedSharding(mesh, s)).numpy(),
            got.numpy())
    return {"y": (yf.numpy(), yl.numpy()),
            "dx": [(a.numpy(), b.numpy()) for a, b in zip(dxf, dxl)],
            "dw": dw}


def _split_blocks(mesh, seed):
    """The split SSD, RG-LRU and decoder layers (self-, cross-attention,
    MLP) against the unsharded ones (``_split_pair``, float32), each also
    with the axis it reads through a sum cut out of the split (replicated
    B/C weights; replicated kv weights, whose gradients are partial); the
    two new collectives on their own; and the guard: the RG-LRU block
    with ``u`` gathered by the plain ``gather``, whose input gradient
    drops the other ranks' parts."""
    import torch
    from repro_torch.configs import REGISTRY, reduced_config
    from repro_torch.launch import sharding as sh
    from repro_torch.models import rglru, ssd
    from repro_torch.models import transformer as T
    from repro_torch.models.params import init_params, layer_def, tree_map
    from repro_torch.models.tensor_parallel import TensorParallel

    comm = mesh.comm()
    g = torch.Generator().manual_seed(seed)
    j, m = comm.index(("model",)), comm.size(("model",))
    out = {}

    def tp_of(cfg, drop=()):
        rules = dict(sh.axis_rules(cfg, mesh, fsdp=False))
        rules.update({k: None for k in drop})
        split = [k for k, v in rules.items()
                 if k is not None and v == "model"]
        return rules, TensorParallel(comm, split, ("data",))

    def layer(cfg, key, sub=None):
        full = init_params(cfg, torch.Generator().manual_seed(seed),
                           device="cpu")
        lp = T.layer_params(full[key], 0) if key != "tail" else full[key]
        return lp[sub] if sub else lp

    def specs_of(cfg, ltype, rules, sub=None):
        d = layer_def(cfg, ltype)
        return tree_map(lambda pd: sh.spec_of(pd.axes, rules),
                        d[sub] if sub else d)

    # the collectives: a gather whose backward sums, then slices; a sum
    # summed both ways (the gated norm's mean square)
    _, tp = tp_of(reduced_config(REGISTRY["mamba2-780m"]))
    X = torch.randn(2, 8, 4 * m, generator=g)
    W = torch.randn(4 * m, 3 * m, generator=g)
    ct = torch.randn(2, 8, 3 * m, generator=g)
    Xf = X.clone().requires_grad_(True)
    ((Xf @ W) * ct).sum().backward()
    xl = X[..., 4 * j:4 * j + 4].clone().requires_grad_(True)
    cols = slice(3 * j, 3 * j + 3)
    ((tp.gather_summed(xl, -1) @ W[:, cols]) * ct[..., cols]).sum() \
        .backward()
    out["gather_summed_dx"] = (Xf.grad[..., 4 * j:4 * j + 4].numpy(),
                               xl.grad.numpy())
    Xf = X.clone().requires_grad_(True)
    yf = Xf * torch.rsqrt(Xf.square().sum(-1, keepdim=True))
    ct = torch.randn(yf.shape, generator=g)
    (yf * ct).sum().backward()
    xl = X[..., 4 * j:4 * j + 4].clone().requires_grad_(True)
    yl = xl * torch.rsqrt(tp.psum(xl.square().sum(-1, keepdim=True)))
    (yl * ct[..., 4 * j:4 * j + 4]).sum().backward()
    out["psum_y"] = (yf[..., 4 * j:4 * j + 4].detach().numpy(),
                     yl.detach().numpy())
    out["psum_dx"] = (Xf.grad[..., 4 * j:4 * j + 4].numpy(),
                      xl.grad.numpy())

    def record(name, pair):
        out[name + "_y"] = pair["y"]
        out[name + "_dx"] = pair["dx"]
        out[name + "_dw"] = pair["dw"]

    # the SSD block: heads, d_inner and G·N cut (B and C gathered), then
    # G·N whole (B and C computed whole, their gradients summed)
    cfg = reduced_config(REGISTRY["mamba2-780m"])
    x = torch.randn(2, 2 * cfg.ssd_chunk, cfg.d_model, generator=g)
    lp = layer(cfg, "layers", "ssd")
    for name, drop in (("ssd", ()), ("ssd_bc_whole", ("ssd_bc",))):
        rules, tp = tp_of(cfg, drop)
        record(name, _split_pair(
            mesh, tp, lambda xs, p, t: ssd.ssd_block_apply(xs[0], p, cfg,
                                                          t)[0],
            [x], lp, specs_of(cfg, "ssd", rules, "ssd"), g))

    # the RG-LRU block: its channels cut, u gathered
    cfg = reduced_config(REGISTRY["recurrentgemma-9b"])
    x = torch.randn(2, 16, cfg.d_model, generator=g)
    lp = layer(cfg, "groups", "b0_rec")["rec"]
    rules, tp = tp_of(cfg)
    specs = specs_of(cfg, "rec", rules, "rec")

    def rec(xs, p, t):
        return rglru.rglru_block_apply(xs[0], p, cfg, t)[0]
    record("rec", _split_pair(mesh, tp, rec, [x], lp, specs, g))
    # the guard: the plain gather's backward only slices
    tp.gather_summed = tp.gather
    out["rec_dx_plain_gather"] = _split_pair(mesh, tp, rec, [x], lp, specs,
                                             g)["dx"][0]

    # the decoder layer: self-attention, cross-attention over the
    # encoder's output (through tp.copy, as decoder_forward), the MLP;
    # then with the kv heads replicated (the rank's query heads read
    # theirs: wk / wv gradients partial)
    cfg = reduced_config(REGISTRY["seamless-m4t-large-v2"])
    x = torch.randn(2, 16, cfg.d_model, generator=g)
    e = torch.randn(2, 24, cfg.d_model, generator=g)
    rope = T.rope_for(cfg, torch.arange(16)[None].expand(2, 16))
    lp = layer(cfg, "dec_layers")

    def dec(xs, p, t):
        enc = t.copy(xs[1]) if t is not None else xs[1]
        return T._dec_layer(xs[0], p, cfg, rope, enc, t)[0]
    for name, drop in (("xattn", ()), ("xattn_kv_whole", ("kv_heads",))):
        rules, tp = tp_of(cfg, drop)
        partial = {(a, w) for a in ("attn", "cross") for w in ("wk", "wv")} \
            if drop else ()
        record(name, _split_pair(mesh, tp, dec, [x, e], lp,
                                 specs_of(cfg, "dec", rules), g, partial))
    return out


def trainer_relayout(rank, *, arch, params, files, ckpt_dir, steps, seq,
                     batch, opt):
    """The port's Trainer on Layout(ChipletTopology(1, 4, 2), 1)'s mesh
    (data 4, model 2) from the whole parameters ``params``, the adaptive
    controller at threshold 0 (every evaluation spreads: s walks 1 -> 2 ->
    4, real mesh swaps on 8 ranks), then a second Trainer on the first mesh
    that resumes from the checkpoint the first wrote on the last mesh.
    Returns the losses, counters, final mesh, whether every local shape
    follows the final specs, and both trainers' gathered states."""
    from repro_torch.configs import REGISTRY, reduced_config
    from repro_torch.core.controller import ControllerConfig
    from repro_torch.core.layout import Layout
    from repro_torch.core.topology import ChipletTopology
    from repro_torch.data.pipeline import ShardedLoader
    from repro_torch.launch import sharding as sh
    from repro_torch.models.params import from_reference, model_def
    from repro_torch.optim.adamw import AdamWConfig
    from repro_torch.runtime.trainer import Trainer, TrainerConfig

    cfg = reduced_config(REGISTRY[arch])
    topo = ChipletTopology(n_pods=1, groups_per_pod=4, chips_per_group=2)
    mesh0 = Layout(topo, 1).make_mesh()

    def trainer(scheduled):
        tcfg = TrainerConfig(steps=steps, ckpt_every=100, log_every=100,
                             ckpt_dir=ckpt_dir, opt=AdamWConfig(**opt))
        kw = dict(topology=topo, controller_cfg=ControllerConfig(
            scheduler_timer=2, threshold=0.0, min_dwell=0)) \
            if scheduled else {}
        return Trainer(cfg, ShardedLoader(files, seq_len=seq, batch=batch),
                       tcfg, mesh=mesh0, log=lambda s: None,
                       params=from_reference(params, "cpu"), device="cpu",
                       **kw)

    t = trainer(True)
    out = t.run()
    defs = model_def(cfg)
    shapes_ok = all(
        tuple(p.shape) == sh.local_shape(d.shape, s.spec, t.mesh)
        for p, d, s in zip(_leaves(t.params), _leaves(defs, stop=_is_def),
                           _leaves(t.psh)))
    shapes_ok &= all(
        tuple(m.shape) == sh.local_shape(d.shape, s.spec, t.mesh)
        for m, d, s in zip(_leaves(t.opt_state["m"]),
                           _leaves(defs, stop=_is_def),
                           _leaves(t.osh["m"])))
    final = {"params": _tree_np(sh.gather_tree(t.params, t.psh)),
             "m": _tree_np(sh.gather_tree(t.opt_state["m"], t.osh["m"]))}
    # reshard-on-load: the checkpoint of the (1, 8) mesh onto (4, 2)
    r = trainer(False)
    resumed = r.resume_if_possible()
    back = {"params": _tree_np(sh.gather_tree(r.params, r.psh)),
            "m": _tree_np(sh.gather_tree(r.opt_state["m"], r.osh["m"]))}
    return {"losses": out["losses"], "counters": out["counters"],
            "mesh": (t.mesh.shape["data"], t.mesh.shape["model"]),
            "shapes_ok": shapes_ok, "final": final, "resumed": resumed,
            "resumed_step": r.step, "restored": back,
            "restored_mesh": (r.mesh.shape["data"], r.mesh.shape["model"])}


def _is_def(x):
    from repro_torch.models.params import ParamDef
    return isinstance(x, ParamDef)


def _leaves(tree, stop=None):
    if isinstance(tree, dict) and not (stop and stop(tree)):
        for k in sorted(tree):
            yield from _leaves(tree[k], stop)
    else:
        yield tree


def trainer_rows(rank, *, arch, params, files, ckpt_dir, seq, batch,
                 opt):
    """The port's Trainer on a (pod 2, data 2, model 2) mesh for two
    steps, with the int8 error feedback over the pod hop
    (``compress_cross_pod``): the rows of the batch that each ``loss_fn``
    call of this rank saw, and the losses."""
    from repro_torch.configs import REGISTRY, reduced_config
    from repro_torch.data.pipeline import ShardedLoader
    from repro_torch.launch.mesh import Mesh
    from repro_torch.models import transformer as T
    from repro_torch.models.params import from_reference
    from repro_torch.optim.adamw import AdamWConfig
    from repro_torch.runtime.trainer import Trainer, TrainerConfig

    cfg = reduced_config(REGISTRY[arch])
    seen = []
    loss_fn = T.loss_fn

    def spy(params, cfg, b, **kw):
        seen.append(int(b["tokens"].shape[0]))
        return loss_fn(params, cfg, b, **kw)

    T.loss_fn = spy
    try:
        mesh = Mesh(np.arange(8).reshape(2, 2, 2), ("pod", "data", "model"))
        tcfg = TrainerConfig(steps=2, ckpt_every=100, log_every=100,
                             ckpt_dir=ckpt_dir, opt=AdamWConfig(**opt),
                             compress_cross_pod=True)
        out = Trainer(cfg, ShardedLoader(files, seq_len=seq, batch=batch),
                      tcfg, mesh=mesh, log=lambda s: None,
                      params=from_reference(params, "cpu"),
                      device="cpu").run()
    finally:
        T.loss_fn = loss_fn
    return {"rows": seen, "losses": out["losses"]}


def dist_scenarios(rank, *, arch, params, batches, cases, opt, trainer,
                   spmd_cases, spmd_params, spmd_batches, pod_trainer):
    """Every scenario of ``test_torch_distributed.py`` in one spawn: each
    smap case of ``cases`` and each spmd case of ``spmd_cases`` (keyed by
    its name; ``spmd_params`` by architecture), the tensor-parallel
    pieces, then the Trainers'."""
    out = {}
    for name, shape, axes, fsdp, mb, comp, impl in cases:
        out[name] = mesh_steps(rank, arch=arch, params=params,
                               batches=batches, shape=shape, axes=axes,
                               fsdp=fsdp, microbatches=mb,
                               compress_pod=comp, opt_impl=impl, opt=opt)
    for name, a, shape, axes, fsdp, mb, impl, over in spmd_cases:
        out[name] = mesh_steps(rank, arch=a, params=spmd_params[a],
                               batches=spmd_batches[a], shape=shape,
                               axes=axes, fsdp=fsdp, microbatches=mb,
                               compress_pod=False, opt_impl=impl, opt=opt,
                               impl="spmd", over=over)
    out["tp_pieces"] = tp_pieces(rank, arch=arch, seed=11)
    out["trainer"] = trainer_relayout(rank, arch=arch, params=params,
                                      **trainer)
    out["pod_trainer"] = trainer_rows(rank, arch=arch, params=params,
                                      **pod_trainer)
    return out


def _layer_shard_shapes(cfg, mesh, pspecs):
    """The local shapes of the layer leaves (stacked leaves without their
    layer axis) under ``pspecs`` that "model" cuts — what a gather of a
    layer weight's shard over "model" would take: (those of the layers
    the spmd steps compute on their shards, those of the layers they
    compute whole: an SSD layer whose heads "model" does not divide)."""
    from repro_torch.launch import sharding as sh
    from repro_torch.launch.steps import _by_split
    from repro_torch.models.params import STACKED, model_def, tree_map
    defs = model_def(cfg)
    split = _by_split(cfg, mesh, pspecs,
                      lambda specs, on: tree_map(lambda s: on, specs))
    out = (set(), set())
    for key in ("layers", "groups", "tail", "enc_layers", "dec_layers"):
        if key not in defs:
            continue
        for d, s, on in zip(_leaves(defs[key], stop=_is_def),
                            _leaves(pspecs[key]), _leaves(split[key])):
            if "model" in {a for e in s for a in sh.entry_axes(e)}:
                shp = sh.local_shape(d.shape, s, mesh)
                out[0 if on else 1].add(shp[1:] if key in STACKED else shp)
    return out


def serve_spmd_case(rank, *, arch, params, shape, axes, fsdp, over, prompt,
                    extras, steps_extras, max_len, steps, start):
    """``make_prefill_spmd`` and ``steps`` greedy ``make_serve_step_spmd``
    steps (the first at position ``start``: the prompt's length, a VLM's
    patches included; ``steps_extras`` each step's extras) on this rank of
    a ``shape`` mesh, from the whole weights ``params`` and the global
    prompt batch (numpy), every rank on its rows: its rows' logits of each call, its rows' greedy tokens, its
    cache shard after the prefill and after the last step, whether each
    cache leaf has ``cache_specs``' local shape, and the shapes of the
    tensors it gathered over "model" beside the local shapes of the layer
    leaves."""
    import dataclasses
    import torch
    from repro_torch.configs import REGISTRY, reduced_config
    from repro_torch.launch import sharding as sh
    from repro_torch.launch.mesh import Mesh
    from repro_torch.launch.steps import make_prefill_spmd, make_serve_step_spmd
    from repro_torch.models import decode as dec
    from repro_torch.models.params import from_reference

    cfg = dataclasses.replace(reduced_config(REGISTRY[arch]), **(over or {}))
    mesh = Mesh(np.arange(int(np.prod(shape))).reshape(shape), axes)
    comm = mesh.comm()
    gathered = []
    all_gather = comm.all_gather

    def spy(t, ax, dim):
        if "model" in ax:
            gathered.append(tuple(t.shape))
        return all_gather(t, ax, dim)
    comm.all_gather = spy
    pspecs = sh.param_specs(cfg, mesh, fsdp=fsdp)
    local = sh.shard_tree(from_reference(params, "cpu"), sh.named(mesh, pspecs))
    bspecs = sh.named(mesh, sh.batch_specs(cfg, None, mesh))

    def rows(name, a):
        return sh.shard(torch.from_numpy(np.ascontiguousarray(a)),
                        bspecs[name])

    batch = {"tokens": rows("tokens", prompt),
             **{k: rows(k, v) for k, v in extras.items()}}
    B = prompt.shape[0]
    src = extras["frame_embeds"].shape[1] if "frame_embeds" in extras else 0
    logits, cache = make_prefill_spmd(cfg, mesh, pspecs, max_len)(local,
                                                                  batch)
    view = dec.cache_view_specs(cfg, max_len, src)
    full = dec.abstract_cache(cfg, B, max_len, src)
    cspecs = sh.cache_specs(cfg, mesh, full)
    shapes_ok = all(
        tuple(a.shape) == sh.local_shape(f.shape, s, mesh)
        for a, f, s in zip(dec.tree_leaves(cache, view),
                           dec.tree_leaves(full, view),
                           dec.tree_leaves(cspecs, view)))
    out = {"logits": [logits.numpy()],
           "prefill_cache": [a.numpy().copy()
                             for a in dec.tree_leaves(cache, view)]}
    step = make_serve_step_spmd(cfg, mesh, pspecs, max_len, src)
    rspec = sh.NamedSharding(mesh, sh.batch_specs(cfg, None, mesh)["tokens"])
    pos = sh.shard(torch.full((B, 1), start, dtype=torch.int32),
                   rspec)[:, 0]
    toks = []
    for i in range(steps):
        tok = logits.argmax(-1, keepdim=True).to(torch.int32)
        toks.append(tok[:, 0].numpy())
        ex = {k: sh.shard(torch.from_numpy(v[i]), sh.NamedSharding(
            mesh, sh.P(None, sh.batch_specs(cfg, None, mesh)["tokens"][0],
                       None))) for k, v in steps_extras.items()} or None
        logits, cache = step(local, cache, tok, pos, ex)
        out["logits"].append(logits.numpy())
        pos = pos + 1
    out["tokens"] = np.stack(toks, 1)
    out["cache"] = [a.numpy() for a in dec.tree_leaves(cache, view)]
    out["shapes_ok"] = shapes_ok
    out["gathered"] = sorted(set(gathered))
    split, whole = _layer_shard_shapes(cfg, mesh, pspecs)
    out["layer_shards"], out["whole_layer_shards"] = sorted(split), \
        sorted(whole)
    return out


def split_window_pieces(rank, *, seed):
    """``layers.split_decode_attention`` on the (data 2, model 4) mesh's
    model axis, each rank on its quarter of a ring's slots, against
    ``decode_attention`` on the whole ring (float32): a ring half written,
    so that some rank's slots are all empty; a wrapped ring under a
    window; and a ring read through a softcap.  Returns (whole, split)
    pairs."""
    import torch
    from repro_torch.launch.mesh import Mesh
    from repro_torch.launch.steps import tensor_parallel
    from repro_torch.configs import REGISTRY, reduced_config
    from repro_torch.models import layers as L

    mesh = Mesh(np.arange(8).reshape(2, 4), ("data", "model"))
    tp = tensor_parallel(reduced_config(REGISTRY["llama3-8b"]), mesh,
                         means=False)
    g = torch.Generator().manual_seed(seed)
    B, W, Hq, Hkv, dh = 3, 16, 4, 2, 8
    out = {}
    for name, pos, kw in (("empty_slice", [5, 7, 2], {}),
                          ("window", [21, 40, 16], {"window": 6}),
                          ("softcap", [30, 9, 15], {"softcap": 2.0})):
        q = torch.randn(B, 1, Hq, dh, generator=g)
        k = torch.randn(B, W, Hkv, dh, generator=g) * 3
        v = torch.randn(B, W, Hkv, dh, generator=g)
        pos = torch.tensor(pos)
        kv_pos = L.cache_positions(pos, W)
        want = L.decode_attention(q, k, v, kv_pos, pos, **kw)
        n = W // tp.size
        part = slice(tp.rank * n, (tp.rank + 1) * n)
        got = L.split_decode_attention(q, k[:, part], v[:, part],
                                       kv_pos[:, part], pos, tp, **kw)
        out[name] = (want.numpy(), got.numpy(),
                     bool(((kv_pos[:, part] < 0).all(-1)).any()))
    return out


def serve_spmd_scenarios(rank, *, cases, params):
    """Every scenario of ``test_torch_serve_spmd.py`` in one spawn: each
    case of ``cases`` (keyed by its name, as ``params`` is), then the
    split-window pieces."""
    out = {}
    for c in cases:
        kw = dict(c)
        name = kw.pop("name")
        out[name] = serve_spmd_case(rank, params=params[name], **kw)
    out["split_window"] = split_window_pieces(rank, seed=3)
    return out
