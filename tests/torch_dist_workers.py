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


def smap_steps(rank, *, arch, params, batches, shape, axes, fsdp,
               microbatches, compress_pod, opt_impl, opt):
    """``make_train_step_smap`` for ``len(batches)`` steps from the whole
    parameters ``params`` (numpy), every rank on the same global batches;
    returns the losses, grad norms and this rank's gathered parameters."""
    import torch
    from repro_torch.configs import REGISTRY, reduced_config
    from repro_torch.launch import sharding as sh
    from repro_torch.launch.mesh import Mesh
    from repro_torch.launch.steps import make_train_step_smap
    from repro_torch.models.params import from_reference
    from repro_torch.optim.adamw import AdamWConfig, init_opt_state
    from repro_torch.optim.quantized import init_opt_state_8bit

    cfg = reduced_config(REGISTRY[arch])
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
    step = make_train_step_smap(
        cfg, AdamWConfig(**opt), mesh, pspecs,
        sh.batch_specs(cfg, None, mesh), microbatches=microbatches,
        opt_impl=opt_impl, compress_pod=compress_pod)
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


def dist_scenarios(rank, *, arch, params, batches, cases, opt, trainer):
    """Every scenario of ``test_torch_distributed.py`` in one spawn: each
    smap case of ``cases`` (keyed by its name), then the Trainer's."""
    out = {}
    for name, shape, axes, fsdp, mb, comp, impl in cases:
        out[name] = smap_steps(rank, arch=arch, params=params,
                               batches=batches, shape=shape, axes=axes,
                               fsdp=fsdp, microbatches=mb,
                               compress_pod=comp, opt_impl=impl, opt=opt)
    out["trainer"] = trainer_relayout(rank, arch=arch, params=params,
                                      **trainer)
    return out
