"""The traced run's device trace: ``torch.profiler`` over a stretch of the
window, reduced to device activity intervals and host ops, the device's
busy seconds, and the breakdown the result line carries.

Kernels inside replayed CUDA graphs are traced one by one (CUPTI), so
the intervals cover the graph-captured steps too.
"""
from __future__ import annotations

import collections
import re
from typing import Dict, List

import numpy as np

from benchkit.record import Trace, busy_intervals

NAME_MAX = 120
GAP_MIN = 50e-6          # seconds: shorter gaps are summed unnamed
GAP_NAMED = 500         # the longest gaps named by their host op
RING = re.compile(r"(^|[\s:])ring_\w+")


def profiler(torch, cuda: bool):
    acts = [torch.profiler.ProfilerActivity.CPU]
    if cuda:
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    return torch.profiler.profile(activities=acts)


def short(name: str) -> str:
    name = re.sub(r"^void ", "", name)
    return name[:NAME_MAX]


def reduce(torch, prof, window_s: float, start, stop) -> Trace:
    """The profiler's events as a ``Trace`` (seconds, profiler time
    base)."""
    device, host = [], []
    cuda = torch.autograd.DeviceType.CUDA
    for e in prof.events():
        a, b = e.time_range.start * 1e-6, e.time_range.end * 1e-6
        if e.device_type == cuda:
            device.append((a, b, short(e.name)))
        else:
            host.append((a, b, short(e.name)))
    return Trace(device, host, window_s, start, stop)


def busy_s(tr: Trace) -> float:
    return sum(b - a for a, b in busy_intervals(tr.device))


def breakdown(tr: Trace) -> Dict[str, List]:
    """The 10 device operations that took most time, and idle seconds by
    what the host was doing: each gap of at least ``GAP_MIN`` seconds
    named by the innermost host op spanning its middle (the ``GAP_NAMED``
    longest such gaps; the rest, and the shorter gaps, in two sums), 10
    at most each."""
    ops: Dict[str, float] = collections.Counter()
    for a, b, n in tr.device:
        ops[n] += b - a
    idle: Dict[str, float] = collections.Counter()
    if tr.host:
        lo = min(a for a, _, _ in tr.host)
        hi = max(b for _, b, _ in tr.host)
        edges = [lo] + [x for iv in busy_intervals(tr.device) for x in iv] \
            + [hi]
        gaps = sorted(((edges[i + 1] - edges[i], edges[i])
                       for i in range(0, len(edges) - 1, 2)
                       if edges[i + 1] > edges[i]), reverse=True)
        starts = np.array([a for a, _, _ in tr.host])
        ends = np.array([b for _, b, _ in tr.host])
        names = [n for _, _, n in tr.host]
        for k, (g, g0) in enumerate(gaps):
            if g < GAP_MIN:
                idle[f"gaps under {GAP_MIN * 1e6:.0f} us"] += g
                continue
            if k >= GAP_NAMED:
                idle["shorter gaps, not named"] += g
                continue
            mid = g0 + 0.5 * g
            over = np.nonzero((starts <= mid) & (ends >= mid))[0]
            name = (names[over[np.argmin(ends[over] - starts[over])]]
                    if over.size else "host (no traced op)")
            idle[name] += g

    def top(d):
        return [[n, s] for n, s in sorted(d.items(), key=lambda x: -x[1])[:10]]
    return {"device_ops": top(ops), "idle_gaps": top(idle)}


def ring_seconds(tr: Trace) -> float:
    """Device seconds of the ring-chunk attention kernels: the split
    kernel and its merge, named ``ring_*`` (in an anonymous namespace)."""
    return sum(b - a for a, b, n in tr.device if RING.search(n))
