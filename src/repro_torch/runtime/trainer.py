"""Training loop integrating every substrate:

  data -> batch onto the device -> train_step (forward, backward through
  the flash-attention kernels, AdamW in place) -> ARCAS scheduler
  (counters + Algorithm 1 + migration) -> checkpoint (atomic/async) ->
  failure injection / straggler detection.

The counterpart of the JAX package's ``runtime/trainer.py`` on one card.
There is no device mesh yet (ROADMAP A item 10): the ``mesh`` argument is
gone, the per-step collective feed — parsed from the compiled step's HLO in
JAX — is zero remote and zero local bytes, which is what a single device
gives the JAX Trainer too, so the counters of the two agree, and a
relayout is logical: recorded, with the state left on its card.
``compress_cross_pod`` raises (ROADMAP A item 10).
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Dict, Optional

import numpy as np
import torch

from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.configs.base import ModelConfig
from repro_torch.core.controller import ControllerConfig
from repro_torch.core.counters import PerfCounters
from repro_torch.core.layout import Layout
from repro_torch.core.scheduler import GlobalScheduler
from repro_torch.core.topology import ChipletTopology
from repro_torch.data.pipeline import make_batch
from repro_torch.launch.steps import make_train_step
from repro_torch.models.params import init_params
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
    """``Trainer(cfg, loader, tcfg, *, topology=None, controller_cfg=None,
    failure=None, log=print, params=None, device="cuda")``.

    Runs on ``device`` — CUDA unless the caller asks for the CPU.  The
    weights are ``params`` when given (a dict of tensors on ``device``,
    e.g. ``from_reference`` of the JAX Trainer's weights), else random from
    a ``torch.Generator`` seeded with ``tcfg.seed``."""

    def __init__(self, cfg: ModelConfig, loader, tcfg: TrainerConfig, *,
                 topology: Optional[ChipletTopology] = None,
                 controller_cfg: Optional[ControllerConfig] = None,
                 failure: Optional[FailureInjector] = None,
                 log: Callable[[str], None] = print, params=None,
                 device="cuda"):
        if tcfg.compress_cross_pod:
            raise NotImplementedError("cross-pod gradient compression "
                                      "(compression/) is not ported yet "
                                      "(ROADMAP A item 10)")
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("Trainer runs on CUDA by default and no CUDA "
                               "device is available; pass device='cpu' to "
                               "run on the CPU")
        self.cfg = cfg
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
        self.params = params
        self.opt_state = init_opt_state(self.params)
        self._step_fn = make_train_step(cfg, tcfg.opt,
                                        microbatches=tcfg.microbatches)

    # -- relayout handler ---------------------------------------------------
    def _on_relayout(self, new_layout: Layout, decision) -> None:
        """Invoked by the GlobalScheduler control loop on a spread change.

        Logical on one card, as the JAX Trainer's is on hosts with fewer
        devices than the layout's chips: recorded and logged, the state
        stays put.  Resharding across cards waits for a device mesh
        (ROADMAP A item 10)."""
        self.counters.add("relayouts", 1)
        self.log(f"[trainer] relayout s={decision.old_spread}->"
                 f"{decision.new_spread} ({decision.reason})")

    def _put_batch(self, np_batch: Dict[str, np.ndarray]):
        return {k: torch.from_numpy(v).to(self.device)
                for k, v in np_batch.items()}

    # ------------------------------------------------------------------
    def resume_if_possible(self) -> bool:
        latest = self.ckpt.latest()
        if latest is None:
            return False
        state = {"params": self.params, "opt": self.opt_state}
        restored, meta = self.ckpt.restore(state)
        self.params = restored["params"]
        self.opt_state = restored["opt"]
        self.step = int(meta["step"])
        if "loader" in meta:
            self.loader.load_state_dict(meta["loader"])
        self.log(f"[trainer] resumed from step {self.step}")
        return True

    # ------------------------------------------------------------------
    def run(self, steps: Optional[int] = None) -> Dict[str, Any]:
        steps = steps or self.tcfg.steps
        losses = []
        t_train0 = time.monotonic()
        while self.step < steps:
            if self.failure is not None:
                self.failure.check(self.step)
            block = self.loader.next()
            batch = self._put_batch(make_batch(self.cfg, block))
            t0 = time.monotonic()
            self.params, self.opt_state, metrics = self._step_fn(
                self.params, self.opt_state, batch)
            loss = float(metrics["loss"])     # waits for the step
            dt = time.monotonic() - t0
            losses.append(loss)
            self.step += 1

            self.straggler.observe(dt)
            # one device moves no collective bytes, remote or local: the
            # JAX Trainer's HLO feed doubles zero on a straggler step too
            self.counters.record_step(step_time=dt)
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
                    blocking=not self.tcfg.async_ckpt)
        self.ckpt.wait()
        return {"losses": losses, "steps": self.step,
                "wall": time.monotonic() - t_train0,
                "straggler_events": list(self.straggler.events),
                "counters": self.counters.snapshot()}
