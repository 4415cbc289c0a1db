"""Arithmetic that several metric readers share."""
from __future__ import annotations

from benchkit import trace, work
from benchkit.record import percentile


def window_percentile(run, fn, q: float):
    """The q-th percentile (nearest rank) of ``fn(request, stop)`` over
    the requests due in the window; None where no request was due."""
    window = run.window()
    if not window:
        return None
    return percentile([fn(r, run.t_stop) for r in window], q)


def submit_lag(r, _t_stop):
    """Submitted minus due: how long the client kept an arrival waiting
    (it submits between the engine's ticks)."""
    return r.submitted - r.due


def graph_share(run):
    """Graph replays over paged step calls in the window (chunk ticks plus
    decode step calls; speculative decoding is off), in %."""
    calls = run.delta("chunk_ticks") + run.delta("decode_forwards")
    if calls <= 0:
        return None
    replays = sum(n - run.open.replays.get(k, 0)
                  for k, n in run.close.replays.items())
    return 100.0 * replays / calls


def idle_share(run):
    """1 - the union of the device's activity intervals over the traced
    stretch's length, in %."""
    tr = run.trace
    if tr is None or tr.window_s <= 0:
        return None
    return 100.0 * (1.0 - trace.busy_s(tr) / tr.window_s)


def busy_mfu(run):
    """The operations the traced stretch's tokens need (work.py: 2 a
    weight a token uses, attention pairs, the head where logits are used)
    over the device's busy seconds in the trace times the bf16 peak, in
    %."""
    tr = run.trace
    if tr is None:
        return None
    busy = trace.busy_s(tr)
    if busy <= 0:
        return None
    flops = work.window_flops(run.arch, run.reqs, tr.start, tr.stop)
    return 100.0 * flops / (busy * work.PEAK_FLOPS)


def ring_share(run):
    """The needed-work bound of the traced stretch's ring-chunk attention
    launches (work.py: each input byte once, only visible keys, summed
    over the chunks the requests ran, the larger of bytes and operations
    against the peaks) over the device time of the kernels named ring_*,
    in %; None where no ring kernel ran in the stretch."""
    tr = run.trace
    if tr is None:
        return None
    t = trace.ring_seconds(tr)
    if t <= 0:
        return None
    nb, nf = work.window_ring(run.arch, run.reqs, tr.start, tr.stop,
                              run.chunk)
    bound = max(nb / work.PEAK_BYTES, nf / work.PEAK_FLOPS)
    return 100.0 * bound / t
