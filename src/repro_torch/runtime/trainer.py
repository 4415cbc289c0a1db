"""Training loop integrating every substrate:

  data -> batch onto the device -> train_step (forward, backward through
  the flash-attention kernels, AdamW in place) -> ARCAS scheduler
  (counters + Algorithm 1 + migration) -> checkpoint (atomic/async) ->
  failure injection / straggler detection.

The counterpart of the JAX package's ``runtime/trainer.py``.  Without a
``mesh`` it trains on one card: no collective moves a byte (the JAX
Trainer's HLO feed on one device is zero too, so the counters of the two
agree) and a relayout is logical — recorded, the state left on its card.

With ``mesh`` (a ``launch.mesh.Mesh``; every rank of an initialized
``torch.distributed`` process group runs its own Trainer) the parameters
and moments are placed by ``param_specs`` / ``opt_specs`` (no FSDP;
ZeRO-1 moments): each rank holds its parts, takes its rows of the global
batch by ``batch_specs`` (1/(pod x data) of it), and steps with
``make_train_step_spmd`` — as the JAX Trainer jits ``make_train_step``
under the mesh's shardings, which GSPMD partitions: tensor-parallel
compute on "model", the batch over every batch axis.
Checkpoints gather the parts and the mesh's first rank writes them; a
resume reads each rank's slice (reshard-on-load).  When the process
group has at least the layout's chips, ``_on_relayout`` swaps the mesh
for real: new specs, the parameters, moments and error-feedback state
migrated (gathered over the old mesh, sliced for the new), the step
rebuilt.  The per-step collective feed is the bytes this rank's own
collectives moved in the step, by the class of their group (``Mesh.
classify``: ``intra_group`` local, ``intra_pod`` and ``cross_pod``
remote) — not the JAX HLO parse's, whose collectives are the ones XLA
chose for its program (ROADMAP C).

``compress_cross_pod`` threads the int8 error-feedback state
(``compression.int8_compress_transform``) through the step.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Dict, Optional

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.compression.grad_compress import (init_compression,
                                                   int8_compress_transform)
from repro_torch.configs.base import ModelConfig
from repro_torch.core.controller import ControllerConfig
from repro_torch.core.counters import PerfCounters
from repro_torch.core.layout import Layout
from repro_torch.core.scheduler import GlobalScheduler, migrate_pytree
from repro_torch.core.topology import ChipletTopology
from repro_torch.data.pipeline import make_batch
from repro_torch.launch import sharding as shlib
from repro_torch.launch.steps import make_train_step, make_train_step_spmd
from repro_torch.models.params import init_params, model_def, tree_map
from repro_torch.optim.adamw import AdamWConfig, init_opt_state
from repro_torch.runtime.failure import FailureInjector, StragglerDetector


@dataclasses.dataclass
class TrainerConfig:
    steps: int = 100
    ckpt_every: int = 50
    ckpt_dir: str = "/tmp/repro_ckpt"
    keep: int = 3
    microbatches: int = 1
    seed: int = 0
    opt: AdamWConfig = dataclasses.field(default_factory=AdamWConfig)
    compress_cross_pod: bool = False
    arcas: bool = True
    log_every: int = 10
    async_ckpt: bool = False


class Trainer:
    """``Trainer(cfg, loader, tcfg, *, mesh=None, topology=None,
    controller_cfg=None, failure=None, log=print, params=None,
    device="cuda")``.

    Runs on ``device`` — CUDA unless the caller asks for the CPU.  The
    weights are ``params`` when given (a dict of whole tensors on
    ``device``, e.g. ``from_reference`` of the JAX Trainer's weights),
    else random from a ``torch.Generator`` seeded with ``tcfg.seed``.
    With ``mesh``, ``self.params``, ``self.opt_state`` and the
    error-feedback state hold this rank's parts."""

    def __init__(self, cfg: ModelConfig, loader, tcfg: TrainerConfig, *,
                 mesh=None, topology: Optional[ChipletTopology] = None,
                 controller_cfg: Optional[ControllerConfig] = None,
                 failure: Optional[FailureInjector] = None,
                 log: Callable[[str], None] = print, params=None,
                 device="cuda"):
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("Trainer runs on CUDA by default and no CUDA "
                               "device is available; pass device='cpu' to "
                               "run on the CPU")
        self.cfg = cfg
        self.mesh = mesh
        self.loader = loader
        self.tcfg = tcfg
        self.failure = failure
        self.log = log
        self.counters = PerfCounters()
        self.straggler = StragglerDetector()
        self.ckpt = CheckpointManager(tcfg.ckpt_dir, keep=tcfg.keep)
        self.scheduler = None
        if tcfg.arcas and topology is not None:
            self.scheduler = GlobalScheduler(
                topology, controller_cfg, counters=self.counters)
            self.scheduler.register_relayout(self._on_relayout)
        self.step = 0
        if params is None:
            gen = torch.Generator(device=self.device).manual_seed(tcfg.seed)
            params = init_params(cfg, gen, device=self.device)
        if mesh is None:
            self.params = params
            self.opt_state = init_opt_state(self.params)
            self.psh = self.osh = None
        else:
            self._place(mesh)
            self.params = shlib.shard_tree(params, self.psh)
            self.opt_state = self._zero_opt_state()
        self._ef = init_compression(self.params)["ef"] \
            if tcfg.compress_cross_pod else None
        self._build_step()

    # -- placement on a mesh --------------------------------------------
    def _place(self, mesh) -> None:
        """The param and ZeRO-1 moment shardings of ``mesh`` (no FSDP, as
        the JAX Trainer)."""
        self.mesh = mesh
        self.pspecs = shlib.param_specs(self.cfg, mesh, fsdp=False)
        self.psh = shlib.named(mesh, self.pspecs)
        self.osh = shlib.named(mesh, shlib.opt_specs(self.cfg, mesh,
                                                     self.pspecs))

    def _zero_opt_state(self):
        def zeros(pdef, shd):
            return torch.zeros(shlib.local_shape(pdef.shape, shd.spec,
                                                 self.mesh),
                               dtype=torch.float32, device=self.device)

        defs = model_def(self.cfg)
        return {"m": tree_map(zeros, defs, self.osh["m"]),
                "v": tree_map(zeros, defs, self.osh["v"]),
                "count": torch.zeros((), dtype=torch.int32,
                                     device=self.device)}

    def _build_step(self) -> None:
        compress = int8_compress_transform \
            if self.tcfg.compress_cross_pod else None
        if self.mesh is None:
            self._step_fn = make_train_step(
                self.cfg, self.tcfg.opt, microbatches=self.tcfg.microbatches,
                ef_transform=compress)
            return
        self._step_fn = make_train_step_spmd(
            self.cfg, self.tcfg.opt, self.mesh, self.pspecs,
            shlib.batch_specs(self.cfg, None, self.mesh),
            microbatches=self.tcfg.microbatches, ef_transform=compress)

    # -- relayout handler: migrate live training state to the new layout ----
    def _on_relayout(self, new_layout: Layout, decision) -> None:
        """Invoked by the GlobalScheduler control loop on a spread change.

        With a mesh and a process group of at least the layout's chips
        this swaps the mesh and migrates the live parameters, moments and
        error-feedback state onto it (``migrate_pytree``); otherwise (one
        card, or fewer ranks than chips, as the JAX Trainer on hosts with
        fewer devices) the relayout is logical: recorded and logged, the
        state stays put."""
        self.counters.add("relayouts", 1)
        self.log(f"[trainer] relayout s={decision.old_spread}->"
                 f"{decision.new_spread} ({decision.reason})")
        world = dist.get_world_size() if dist.is_initialized() else 1
        if self.mesh is None or world < new_layout.topology.total_chips:
            return
        old_psh, old_osh = self.psh, self.osh
        self._place(new_layout.make_mesh())
        self.params = migrate_pytree(self.params, self.psh, src=old_psh)
        self.opt_state = migrate_pytree(self.opt_state, self.osh,
                                        src=old_osh)
        if self._ef is not None:
            self._ef = migrate_pytree(self._ef, self.psh, src=old_psh)
        self._build_step()

    def _put_batch(self, np_batch: Dict[str, np.ndarray]):
        return {k: torch.from_numpy(v).to(self.device)
                for k, v in np_batch.items()}

    # ------------------------------------------------------------------
    def resume_if_possible(self) -> bool:
        latest = self.ckpt.latest()
        if latest is None:
            return False
        state = {"params": self.params, "opt": self.opt_state}
        restored, meta = self.ckpt.restore(state, shardings=self._shardings())
        self.params = restored["params"]
        self.opt_state = restored["opt"]
        self.step = int(meta["step"])
        if "loader" in meta:
            self.loader.load_state_dict(meta["loader"])
        self.log(f"[trainer] resumed from step {self.step}")
        return True

    def _shardings(self):
        if self.mesh is None:
            return None
        return {"params": self.psh, "opt": self.osh}

    def _collective_bytes(self) -> Dict[str, float]:
        return dict(self.mesh.comm().bytes) if self.mesh is not None else {}

    # ------------------------------------------------------------------
    def run(self, steps: Optional[int] = None) -> Dict[str, Any]:
        steps = steps or self.tcfg.steps
        losses, step_times = [], []
        t_train0 = time.monotonic()
        while self.step < steps:
            if self.failure is not None:
                self.failure.check(self.step)
            block = self.loader.next()
            batch = self._put_batch(make_batch(self.cfg, block))
            before = self._collective_bytes()
            t0 = time.monotonic()
            if self._ef is not None:
                self.params, self.opt_state, metrics, self._ef = \
                    self._step_fn(self.params, self.opt_state, batch,
                                  self._ef)
            else:
                self.params, self.opt_state, metrics = self._step_fn(
                    self.params, self.opt_state, batch)
            loss = float(metrics["loss"])     # waits for the step
            dt = time.monotonic() - t0
            losses.append(loss)
            step_times.append(dt)
            self.step += 1

            moved = {k: v - before.get(k, 0.0)
                     for k, v in self._collective_bytes().items()}
            remote = moved.get("intra_pod", 0.0) + moved.get("cross_pod", 0.0)
            slow = self.straggler.observe(dt)
            # the bytes this rank's collectives moved in the step (none on
            # one card); a straggler step doubles the remote ones, as the
            # JAX Trainer's feed does
            self.counters.record_step(
                step_time=dt, remote_bytes=remote * (2 if slow else 1),
                local_bytes=moved.get("intra_group", 0.0))
            if self.scheduler is not None:
                # the unified control loop: advance host-side coroutines one
                # round, evaluate Algorithm 1, fire relayout handlers
                self.scheduler.tick()

            if self.step % self.tcfg.log_every == 0:
                self.log(f"[trainer] step {self.step} loss {loss:.4f} "
                         f"({dt*1e3:.0f} ms)")
            if self.step % self.tcfg.ckpt_every == 0 or self.step == steps:
                self.ckpt.save(
                    self.step,
                    {"params": self.params, "opt": self.opt_state},
                    metadata={"loader": self.loader.state_dict()},
                    blocking=not self.tcfg.async_ckpt,
                    shardings=self._shardings())
        self.ckpt.wait()
        # step_times: each step's seconds, from its launch to its loss on
        # the host (the port's own key; the JAX Trainer has none)
        return {"losses": losses, "steps": self.step,
                "wall": time.monotonic() - t_train0, "step_times": step_times,
                "straggler_events": list(self.straggler.events),
                "counters": self.counters.snapshot()}
