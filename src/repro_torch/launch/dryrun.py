"""Dry run: one rank's train, prefill or decode step of every production
cell, traced on tensors that hold no data.

    PYTHONPATH=src python -m repro_torch.launch.dryrun --all
    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch llama3-8b \\
        --shape train_4k

The JAX package's ``launch/dryrun.py`` lowers and compiles each (arch x
shape x mesh) cell on 512 placeholder CPU devices.  The port has no
compiler that lowers a step without running it, so it runs the step of
ONE rank of the production mesh (``make_production_mesh``: (16, 16), or
(2, 16, 16) with ``--multi-pod``) on ``FakeTensorMode`` tensors under
``trace_analysis.Trace``: every op runs for its shapes only, the
hand-written kernels' wrappers count their launches and note their needed
work without launching (``kernels/dry.py``), and the mesh's collectives
count their operand bytes by link class without moving data
(``Mesh.dry``).  It needs no card and no process group.

* train: the rank's part of the train step on its parameter and
  optimizer shards (ZeRO-1), with the global batch, remat "full", 8
  microbatches and the 8-bit AdamW under FSDP (``cell_config``, as
  JAX's).  ``--train-impl gspmd`` (the default, as JAX's) traces
  ``steps.make_train_step_spmd``, the port's counterpart of the GSPMD
  program JAX compiles for the whole mesh: tensor-parallel compute on
  "model", the batch over every batch axis.  ``--train-impl smap``
  traces ``steps.make_train_step_smap`` (every weight gathered on use,
  and on a mesh with a pod axis the whole global batch on every rank: the
  JAX smap step's ``manualize`` caveat, mirrored; its cells compress the
  pod hop to int8, as JAX's).
* prefill / decode: ``steps.make_prefill_spmd`` / ``make_serve_step_spmd``,
  the port's counterparts of the GSPMD serving programs JAX compiles, on
  the rank's share of the batch (the input's ``PartitionSpec``, batch
  replicated when it does not divide), its parameter shards
  (``param_specs``) and, for decode, its shard of the decode cache as
  ``cache_specs`` cuts it (the prefill returns its shard in that
  layout): tensor-parallel compute on "model" — every layer on the
  rank's heads, ``ff`` slice, SSD heads or LRU channels, attention over
  the rank's slots of a ring whose window axis "model" cuts — and a leaf
  that FSDP puts on "data" gathered along "data" as its layer runs.

The run's device is ``cuda`` (``--device``): fake tensors on the card's
routes; where PyTorch was built without CUDA, ``meta``
(``trace_analysis.trace_device``), which every wrapper and
``layers.matmul_f32`` route as the card's;
``--device cpu`` traces the CPU routes (the kernels' plain versions).

Each cell writes one JSON record to ``experiments/dryrun_torch/`` with the
JAX record's keys, renamed where the port measures something else:
``compile_s`` -> ``trace_s``; ``memory.fits_hbm_16gb`` ->
``memory.fits_hbm_80gb`` (the peak against ``trace_analysis.CARD_BYTES``,
79.18 GiB); ``full_step_cost_analysis.note`` says what the trace counts.
``launches`` (kernel -> launches a step), ``trace_device`` and ``rank``
are added, and for a serving cell ``cache_bytes``, the rank's share of
the decode cache (``cache_share_bytes``).  A cell ``shape_applicable`` rejects is ``"skipped"`` with its
reason.  Multi-pod cells skip the analysis (decomposition and roofline),
as JAX's do.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import math
import os
import signal
import sys
import time
import traceback
from pathlib import Path

import torch
from torch._subclasses.fake_tensor import FakeTensorMode

from repro_torch.configs import ARCH_IDS, SHAPES, get_config, shape_applicable
from repro_torch.core.costmodel import model_flops
from repro_torch.launch import analysis as an
from repro_torch.launch import sharding as sh
from repro_torch.launch import trace_analysis as ta
from repro_torch.launch.inputs import ENCDEC_SRC_LEN, input_specs, seq_split
from repro_torch.launch.mesh import Mesh, make_production_mesh
from repro_torch.launch.steps import (make_prefill_spmd, make_serve_step_spmd,
                                      make_train_step_smap,
                                      make_train_step_spmd)
from repro_torch.models import decode as dec
from repro_torch.models.params import _leaves as _param_leaves
from repro_torch.models.params import model_def, torch_dtype, tree_map
from repro_torch.optim.adamw import AdamWConfig

OUT_DIR = Path(__file__).resolve().parents[3] / "experiments" / "dryrun_torch"


def cell_config(arch: str, shape_name: str):
    """The JAX package's: queries padded to 16 head groups; for train,
    "full" remat (only each layer's input is saved) and no sequence
    sharding of the carry."""
    cfg = dataclasses.replace(get_config(arch), head_pad_to=16)
    shape = SHAPES[shape_name]
    if shape.kind == "train":
        cfg = dataclasses.replace(cfg, remat="full", seq_shard=False)
    return cfg, shape


def _fake(shape, dtype, device):
    return torch.empty(tuple(shape), dtype=dtype, device=device)


def _local_params(cfg, mesh, pspecs, device):
    dt = torch_dtype(cfg.param_dtype)
    return tree_map(lambda pd, s: _fake(sh.local_shape(pd.shape, s, mesh),
                                        dt, device),
                    model_def(cfg), pspecs)


def _local_opt(cfg, mesh, ospecs, opt_impl, device):
    """The rank's optimizer state: each moment's ZeRO-1 shard (float32
    moments, or the 8-bit {"q", "scale"} pairs)."""
    def moment(pd, spec, qtype):
        if opt_impl != "adamw8bit":
            return _fake(sh.local_shape(pd.shape, spec, mesh),
                         torch.float32, device)
        scale = pd.shape[:-1] + (1,)
        return {"q": _fake(sh.local_shape(pd.shape, spec["q"], mesh),
                           qtype, device),
                "scale": _fake(sh.local_shape(scale, spec["scale"], mesh),
                               torch.float32, device)}

    defs = model_def(cfg)
    return {"m": tree_map(lambda pd, s: moment(pd, s, torch.int8), defs,
                          ospecs["m"]),
            "v": tree_map(lambda pd, s: moment(pd, s, torch.uint8), defs,
                          ospecs["v"]),
            "count": _fake((), torch.int32, device)}


TRAIN_IMPLS = ("gspmd", "smap")


def _build_step(cfg, shape, mesh, *, fsdp, microbatches, opt_impl,
                compress_pod, device, train_impl="gspmd"):
    """(step, argument maker) of the cell's per-rank program."""
    pspecs = sh.param_specs(cfg, mesh, fsdp=fsdp)
    batch = input_specs(cfg, shape, mesh)
    if shape.kind == "train":
        bsp = sh.batch_specs(cfg, shape, mesh)
        bsp = {k: v for k, v in bsp.items() if k in batch}
        if train_impl == "gspmd":
            step = make_train_step_spmd(cfg, AdamWConfig(), mesh, pspecs,
                                        bsp, microbatches=microbatches,
                                        opt_impl=opt_impl)
        elif train_impl == "smap":
            step = make_train_step_smap(cfg, AdamWConfig(), mesh, pspecs,
                                        bsp, microbatches=microbatches,
                                        opt_impl=opt_impl,
                                        compress_pod=compress_pod)
        else:
            raise ValueError(f"unknown train_impl {train_impl!r}: expected "
                             f"one of {TRAIN_IMPLS}")
        ospecs = (sh.opt_specs_8bit if opt_impl == "adamw8bit"
                  else sh.opt_specs)(cfg, mesh, pspecs)

        def args():
            params = _local_params(cfg, mesh, pspecs, device)
            opt = _local_opt(cfg, mesh, ospecs, opt_impl, device)
            glob = {k: _fake(v.shape, v.dtype, device)
                    for k, v in batch.items()}
            return (params, opt, glob)
        return step, args

    def local(stand):
        return _fake(sh.local_shape(stand.shape, stand.spec, mesh),
                     stand.dtype, device)

    if shape.kind == "prefill":
        step = make_prefill_spmd(cfg, mesh, pspecs, shape.seq_len)

        def args():
            return (_local_params(cfg, mesh, pspecs, device),
                    {k: local(v) for k, v in batch.items()})
        return step, args

    step = make_serve_step_spmd(
        cfg, mesh, pspecs, shape.seq_len,
        ENCDEC_SRC_LEN if cfg.family == "encdec" else 0)

    def args():
        out = (_local_params(cfg, mesh, pspecs, device),
               tree_map(local, batch["cache"]), local(batch["tokens"]),
               local(batch["pos"]))
        if "extras" in batch:
            out += ({k: local(v) for k, v in batch["extras"].items()},)
        return out
    return step, args


def cache_share_bytes(cfg, shape, mesh: Mesh) -> int:
    """The bytes of a rank's shard of a serving cell's decode cache, as
    ``cache_specs`` cuts it: the prefill's output, the token step's input
    and output (a ``seq_len``-deep context; an encoder-decoder model's
    source frames as the cell's inputs hold them)."""
    src = 0
    if cfg.family == "encdec":
        src = ENCDEC_SRC_LEN if shape.is_decode else \
            seq_split(cfg, shape.seq_len)[1]
    full = dec.abstract_cache(cfg, shape.global_batch, shape.seq_len, src)
    specs = sh.cache_specs(cfg, mesh, full)
    return sum(math.prod(sh.local_shape(t.shape, s, mesh)) * t.element_size()
               for (_, t), (_, s) in zip(_param_leaves(full),
                                         _param_leaves(specs)))


def trace_step(cfg, shape, mesh: Mesh, *, fsdp: bool, microbatches: int = 8,
               opt_impl: str = "adamw", compress_pod: bool = False,
               device: str = "cuda", train_impl: str = "gspmd"):
    """Trace rank 0's step of one cell on a fresh dry ``mesh`` (every
    rank of a production mesh runs the same shapes).  Returns
    (``Trace``, the mesh's dry comm, seconds)."""
    t0 = time.time()
    comm = mesh.dry(0)
    dev = ta.trace_device(device)
    step, make_args = _build_step(cfg, shape, mesh, fsdp=fsdp,
                                  microbatches=microbatches,
                                  opt_impl=opt_impl,
                                  compress_pod=compress_pod, device=dev,
                                  train_impl=train_impl)
    with FakeTensorMode(), ta.Trace() as tr:
        args = make_args()
        tr.begin()
        out = step(*args)
        tr.end(out)
        del args, out
    return tr, comm, time.time() - t0


def run_cell(arch: str, shape_name: str, *, multi_pod: bool,
             skip_analysis: bool = False, tag: str = "",
             train_impl: str = "gspmd", microbatches: int = 8,
             device: str = "cuda", config=None, layers: int = 0) -> dict:
    """Trace one (arch x shape x mesh) cell; return the record.
    ``config``: a (cfg, shape) pair in place of ``cell_config``'s (a
    reduced model, a smaller shape); ``layers``: the depth cut to that
    many layers (0: the config's), the whole model's FSDP decision and
    optimizer kept.  ``tag`` defaults to the train impl."""
    cfg, shape = config or cell_config(arch, shape_name)
    mesh = make_production_mesh(multi_pod=multi_pod)
    chips = mesh.size
    fsdp = sh.needs_fsdp(cfg, shape, chips, mesh.shape["model"])
    if layers:
        cfg = dataclasses.replace(cfg, n_layers=layers)
    if multi_pod:
        cfg = dataclasses.replace(cfg, batch_axes=("pod", "data"))
    ok, why = shape_applicable(cfg, shape)
    if not ok:
        return {"arch": arch, "shape": shape_name, "multi_pod": multi_pod,
                "status": "skipped", "reason": why}

    # FSDP-scale models (grok-1): 8-bit moments, as JAX's run_cell
    opt_impl = "adamw8bit" if fsdp else "adamw"
    tr, comm, t_trace = trace_step(
        cfg, shape, mesh, fsdp=fsdp, microbatches=microbatches,
        opt_impl=opt_impl, compress_pod=multi_pod, device=device,
        train_impl=train_impl)
    colls = ta.collective_stats(comm)
    rec = {
        "arch": arch, "shape": shape_name, "multi_pod": multi_pod,
        "tag": tag or train_impl, "status": "ok",
        "chips": chips, "fsdp": fsdp, "remat": cfg.remat,
        "n_layers": cfg.n_layers,
        "trace_s": round(t_trace, 1),
        "trace_device": ta.trace_device(device), "rank": 0,
        "memory": tr.memory(),
        "collectives": {
            "per_class_bytes": colls.per_class_bytes,
            "per_op_bytes": colls.per_op_bytes,
            "n_ops": colls.n_ops,
            "total_per_dev": colls.total_bytes,
            "remote_per_dev": colls.remote_bytes,
        },
        "full_step_cost_analysis": {
            "flops": tr.flops,
            "bytes_accessed": tr.bytes_accessed,
            "note": "every op of the rank's step counted as it ran (each "
                    "layer, microbatch and recomputation); flops of the "
                    "matmuls and the kernels' needed work, bytes of every "
                    "unfused operand and the kernels' needed bytes",
        },
        "launches": dict(tr.launches),
    }
    if shape.kind != "train":
        rec["cache_bytes"] = cache_share_bytes(cfg, shape, mesh)

    if not skip_analysis:
        t1 = time.time()
        dc = an.decomposed_cost(cfg, shape, mesh, fsdp=fsdp, device=device,
                                tp=train_impl == "gspmd"
                                or shape.kind != "train")
        mf = model_flops(cfg, shape)
        hbm_lb = an.analytic_hbm_bytes(
            cfg, shape, mesh, fsdp=fsdp,
            microbatches=microbatches if shape.kind == "train" else 1)
        rl = ta.roofline(
            flops_per_dev=tr.flops, bytes_per_dev=hbm_lb,
            coll_bytes_per_dev=colls.total_bytes,
            model_flops_total=mf, chips=chips)
        rec["decomposed"] = {k: v for k, v in dc.items() if k != "detail"}
        rec["decomposed"]["full_step_flops"] = tr.flops
        rec["decomposed"]["flops_ratio"] = dc["flops_per_dev"] / max(
            tr.flops, 1.0)
        rec["decomposed"]["detail"] = dc["detail"]
        rec["roofline"] = rl.to_dict()
        rec["roofline"]["bytes_per_dev_hlo_upper"] = tr.bytes_accessed
        rec["roofline"]["memory_s_hlo_upper"] = tr.bytes_accessed / ta.HBM_BW
        rec["analysis_s"] = round(time.time() - t1, 1)
    return rec


def summary(name: str, rec: dict) -> str:
    """The JAX run's ``[dryrun]`` line."""
    status = rec["status"]
    extra = ""
    if status == "ok":
        extra = (f" trace={rec['trace_s']}s "
                 f"mem/dev={rec['memory']['peak_per_device']/1e9:.2f}GB "
                 f"coll/dev={rec['collectives']['total_per_dev']/1e9:.3f}GB")
        if "roofline" in rec:
            r = rec["roofline"]
            extra += (f" dom={r['dominant']}"
                      f" frac={r['roofline_fraction']:.3f}")
    return f"[dryrun] {name}: {status}{extra}"


def record_name(arch: str, shape: str, multi_pod: bool, layers: int = 0,
                suffix: str = "") -> str:
    """A cell's record name (its file, without ``.json``): ``--layers``
    and ``--suffix`` append to it."""
    return (f"{arch}__{shape}__{'pod2' if multi_pod else 'pod1'}"
            + (f"__{layers}layers" if layers else "") + suffix)


class CellTimeLimit(Exception):
    """A cell's trace ran past ``--time-limit``."""


def _cut(signum, frame):
    raise CellTimeLimit


def main(argv=None):
    ap = argparse.ArgumentParser(description="per-rank dry run")
    ap.add_argument("--arch", default=None, help="architecture id (or all)")
    ap.add_argument("--shape", default=None, help="shape name (or all)")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--skip-analysis", action="store_true",
                    help="trace + memory + collectives only")
    ap.add_argument("--train-impl", default="gspmd", choices=TRAIN_IMPLS,
                    help="gspmd (make_train_step_spmd: tensor-parallel "
                         "compute, the batch over every batch axis) or "
                         "smap (make_train_step_smap)")
    ap.add_argument("--microbatches", type=int, default=8)
    ap.add_argument("--layers", type=int, default=0,
                    help="cut the depth to this many layers (0: whole)")
    ap.add_argument("--time-limit", type=float, default=0.0,
                    help="seconds a cell may take (0: no limit); a cell "
                         "cut by it is recorded with status 'timeout'")
    ap.add_argument("--suffix", default="")
    ap.add_argument("--out", default=str(OUT_DIR))
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="the routes traced (no card is used)")
    args = ap.parse_args(argv)

    archs = list(ARCH_IDS) if (args.all or not args.arch) else [args.arch]
    shapes = list(SHAPES) if (args.all or not args.shape) else [args.shape]
    meshes = [False, True] if (args.both_meshes or args.all) else \
        [args.multi_pod]

    os.makedirs(args.out, exist_ok=True)
    failures = 0
    if args.time_limit:
        signal.signal(signal.SIGALRM, _cut)
    for arch in archs:
        for shape in shapes:
            for mp in meshes:
                name = record_name(arch, shape, mp, args.layers,
                                   args.suffix)
                path = os.path.join(args.out, name + ".json")
                try:
                    if args.time_limit:
                        signal.setitimer(signal.ITIMER_REAL, args.time_limit)
                    # the roofline decomposition is a single-pod
                    # deliverable; multi-pod cells give trace + memory +
                    # collectives
                    rec = run_cell(arch, shape, multi_pod=mp,
                                   skip_analysis=args.skip_analysis or mp,
                                   train_impl=args.train_impl,
                                   microbatches=args.microbatches,
                                   tag=args.train_impl, device=args.device,
                                   layers=args.layers)
                except CellTimeLimit:
                    rec = {"arch": arch, "shape": shape, "multi_pod": mp,
                           "tag": args.train_impl, "status": "timeout",
                           "time_limit_s": args.time_limit,
                           "note": "the trace did not finish within the "
                                   "time limit; no numbers"}
                    failures += 1
                except Exception as e:  # noqa: BLE001
                    traceback.print_exc()
                    rec = {"arch": arch, "shape": shape, "multi_pod": mp,
                           "status": "error", "error": repr(e)}
                    failures += 1
                finally:
                    if args.time_limit:
                        signal.setitimer(signal.ITIMER_REAL, 0)
                with open(path, "w") as f:
                    json.dump(rec, f, indent=1, default=float)
                print(summary(name, rec), flush=True)
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
