"""ARCAS core of the port: the paper's runtime on GPU devices.

topology   — chiplet-group model of the fleet (Fig. 2/3), H100 constants
counters   — §4.5 profiler
controller — Algorithm 1 + approaches/policies (§4.1-4.3)
layout     — Algorithm 2 + device-grid synthesis
costmodel  — three-term roofline objective
tasks      — §4.4 coroutines + chiplet-first work stealing
scheduler  — global scheduler (migration by ``Tensor.to`` or onto shardings)
"""
from repro_torch.core.topology import ChipletTopology, HardwareSpec, production_topology
from repro_torch.core.counters import PerfCounters
from repro_torch.core.layout import Layout, layout_family, update_location
from repro_torch.core.controller import AdaptiveController, ControllerConfig
from repro_torch.core.costmodel import estimate, best_layout, StepCost
from repro_torch.core.tasks import BLOCK, Task, TaskRuntime
from repro_torch.core.scheduler import (GlobalScheduler, MigrationEvent,
                                        RelayoutHandler, TieredQueues,
                                        migrate_pytree)
