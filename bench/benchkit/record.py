"""What a run hands to the metric readers (``bench/metrics/<name>.py``).

A reader is ``read(run: Run) -> Optional[float]``; it returns None where
the run holds nothing for it to read, and the harness then leaves the
metric out of the result line.  Everything here was taken by the
benchmark: the host clock around the window, the requests' own
timestamps and counts, the program's counters, graph replays and kernel
names, and the profiler's device trace.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, List, Optional, Tuple


@dataclasses.dataclass
class Snap:
    """The engine between two ticks: host time, every counter's total,
    replays of each captured graph, and each submitted request's
    processed positions and served tokens (by request id)."""
    t: float
    counters: Dict[str, float]
    replays: Dict[Tuple, int]
    positions: Dict[int, int]
    served: Dict[int, int]


@dataclasses.dataclass
class Req:
    """One submitted request: when it was due and submitted, its first
    token and completion (host clock; None if it never came), its sizes,
    the prompt tokens a shared prefix supplied, and its phase."""
    rid: int
    phase: str
    due: float
    submitted: float
    t_first: Optional[float]
    t_done: Optional[float]
    prompt_len: int
    max_new: int
    served: int
    prefix_tokens: int


@dataclasses.dataclass
class Trace:
    """The profiled stretch of the window: device activity intervals (s,
    profiler time base) with names, the host ops (name, start, end), and
    the host clock's length of the stretch."""
    device: List[Tuple[float, float, str]]
    host: List[Tuple[float, float, str]]
    window_s: float
    start: Snap
    stop: Snap


@dataclasses.dataclass
class Run:
    """One run of a cell, as the readers see it."""
    arch: Dict                       # the configuration file
    cell: Dict                       # the cell file
    workload: str
    seconds: float
    t_start: float                   # process start (host clock)
    t_stop: float                    # the engine stopped
    open: Snap                       # the window opened
    close: Snap                      # the window closed
    reqs: List[Req]
    chunk: int                       # prompt tokens a prefill chunk
    memory_peak_bytes: int
    trace: Optional[Trace] = None
    extra: Dict[str, Any] = dataclasses.field(default_factory=dict)

    def window(self) -> List[Req]:
        """The requests measured: the open loop's requests due in the
        window."""
        return [r for r in self.reqs if r.phase == "window"]

    def delta(self, name: str, a: Snap = None, b: Snap = None) -> float:
        a, b = a or self.open, b or self.close
        return b.counters.get(name, 0.0) - a.counters.get(name, 0.0)


def percentile(values, q: float) -> float:
    """Nearest-rank percentile: the smallest value with at least q% of
    the values at or below it."""
    v = sorted(values)
    if not v:
        return math.nan
    return float(v[max(0, math.ceil(q / 100.0 * len(v)) - 1)])


def ttft(r: Req, t_stop: float) -> float:
    """First token minus due; a request with no first token by the stop
    counts as missing, at the stop minus due (a lower bound)."""
    return (r.t_first if r.t_first is not None else t_stop) - r.due


def tpot(r: Req, t_stop: float) -> float:
    """(done - first) / (served - 1); an unfinished request counts at what
    it had reached by the stop (a lower bound), and one with no first
    token by the stop as missing: infinite, at the tail's far end."""
    if r.t_first is None:
        return math.inf
    end = r.t_done if r.t_done is not None else t_stop
    return (end - r.t_first) / max(1, r.served - 1)


def busy_intervals(device: List[Tuple[float, float, str]]
                   ) -> List[Tuple[float, float]]:
    """The union of the device's activity intervals, merged, in order."""
    out: List[List[float]] = []
    for a, b, _ in sorted(device):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [(a, b) for a, b in out]
