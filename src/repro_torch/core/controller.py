"""Algorithm 1 (Chiplet Scheduling Policy) — faithful port — plus the
approach->policy machinery of §4.1 and a beyond-paper cost-model-guided
variant.

Faithful control law (per SCHEDULER_TIMER interval):
    rate = event_counter * SCHEDULER_TIMER / elapsed
    rate >= RMT_CHIP_ACCESS_RATE  ->  spread_rate += 1   (spread)
    else                          ->  spread_rate -= 1   (compact)
bounded to [1, CHIPLETS], followed by updateLocation().

Approaches (paper §4.1): an *approach* is the guiding principle, a *policy*
the concrete action rule the scheduler executes.
  location_centric — minimize cross-group traffic: always compact (s -> 1)
  cache_centric    — maximize aggregate capacity: always spread (s -> max)
  adaptive         — the Algorithm-1 feedback loop between the two
  model_guided     — (beyond paper) jump straight to argmin of the roofline
                     cost model instead of +-1 steps
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable, List, Optional

from repro_torch.core.counters import PerfCounters
from repro_torch.core.layout import Layout, layout_family
from repro_torch.core.topology import ChipletTopology

# Paper §4.6: sensitivity analysis picked 300 events / interval; our events
# are bytes, so the threshold is expressed in bytes per interval and set per
# workload by the same kind of calibration (see benchmarks/fig5).
RMT_CHIP_ACCESS_RATE = 300.0
SCHEDULER_TIMER = 1.0


@dataclasses.dataclass
class ControllerConfig:
    approach: str = "adaptive"       # location_centric|cache_centric|adaptive|model_guided
    scheduler_timer: float = SCHEDULER_TIMER      # seconds (or steps if step_mode)
    threshold: float = RMT_CHIP_ACCESS_RATE       # events per interval
    step_mode: bool = True           # interval measured in steps, not wall time
    min_dwell: int = 1               # intervals to wait between moves


@dataclasses.dataclass
class Decision:
    step: int
    old_spread: int
    new_spread: int
    rate: float
    reason: str


class AdaptiveController:
    """The paper's adaptive controller (2) driving spread/compact moves."""

    def __init__(self, topology: ChipletTopology, cfg: ControllerConfig,
                 *, spread_rate: int = 1, pod_axis: bool = False,
                 cost_fn: Optional[Callable[[Layout], float]] = None,
                 working_set_fn: Optional[Callable[[], float]] = None):
        self.topology = topology
        self.cfg = cfg
        self.pod_axis = pod_axis
        self.cost_fn = cost_fn
        self.working_set_fn = working_set_fn
        self._legal = sorted(s.spread_rate for s in layout_family(topology))
        if spread_rate not in self._legal:
            spread_rate = self._legal[0]
        self.spread_rate = spread_rate
        self._last_check = 0.0
        self._steps = 0
        self._dwell = 0
        self.decisions: List[Decision] = []

    # ------------------------------------------------------------------
    def layout(self) -> Layout:
        return Layout(self.topology, self.spread_rate, self.pod_axis)

    def _bump(self, direction: int) -> int:
        """Next legal spread rate in +-1 'steps' over the divisor ladder."""
        i = self._legal.index(self.spread_rate)
        j = min(max(i + direction, 0), len(self._legal) - 1)
        return self._legal[j]

    # -- Algorithm 1 ------------------------------------------------------
    def maybe_reschedule(self, counters: PerfCounters,
                         now: Optional[float] = None) -> Optional[Decision]:
        """Run one Algorithm-1 evaluation; returns a Decision on change."""
        self._steps += 1
        elapsed = (self._steps - self._last_check if self.cfg.step_mode
                   else (now or counters.elapsed()) - self._last_check)
        if elapsed < self.cfg.scheduler_timer:
            return None

        counter = counters.event_counter("remote_bytes")      # cache-fill events
        rate = counter * self.cfg.scheduler_timer / max(elapsed, 1e-9)
        old = self.spread_rate

        if self.cfg.approach == "location_centric":
            new, reason = self._legal[0], "location_centric: compact"
        elif self.cfg.approach == "cache_centric":
            new, reason = self._legal[-1], "cache_centric: spread"
        elif self.cfg.approach == "model_guided" and self.cost_fn is not None:
            cand = min((Layout(self.topology, s, self.pod_axis)
                        for s in self._legal), key=self.cost_fn)
            new, reason = cand.spread_rate, "model_guided: argmin cost"
        else:  # adaptive — the faithful Algorithm 1 body
            if rate >= self.cfg.threshold:
                new = self._bump(+1)
                reason = f"rate {rate:.3g} >= {self.cfg.threshold:.3g}: spread"
            else:
                new = self._bump(-1)
                reason = f"rate {rate:.3g} < {self.cfg.threshold:.3g}: compact"

        # capacity guard (the hard device-memory fit constraint)
        if self.working_set_fn is not None:
            ws = self.working_set_fn()
            while not Layout(self.topology, new, self.pod_axis).fits(ws):
                i = self._legal.index(new)
                if i == len(self._legal) - 1:
                    break
                new = self._legal[i + 1]
                reason += " +capacity_guard"

        self._last_check = self._steps if self.cfg.step_mode else (
            now or counters.elapsed())
        counters.reset_events("remote_bytes")

        if new == old or self._dwell > 0:
            self._dwell = max(0, self._dwell - 1)
            return None
        self.spread_rate = new
        self._dwell = self.cfg.min_dwell
        d = Decision(self._steps, old, new, rate, reason)
        self.decisions.append(d)
        return d
