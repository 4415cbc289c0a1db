"""Performance counters — the paper's §4.5 profiler, libpfm replaced by
compiler-derived traffic classes + wall-clock step timing.

Counter names mirror Tab. 1/2 of the paper:
  local_bytes   — HBM traffic served within the replica's own chiplet groups
  remote_bytes  — collective bytes crossing group boundaries within a pod
                  (the "remote NUMA chiplet" / cache-fill event analogue;
                  this is what Algorithm 1 thresholds on)
  dcn_bytes     — cross-pod traffic (the "main memory" analogue)

Counters are cheap (plain floats), support scoped segments (the paper's
"profile only specific code segments"), and keep a ring buffer of recent
step samples for rate estimation.
"""
from __future__ import annotations

import collections
import contextlib
import dataclasses
import time
from typing import Deque, Dict, Optional


@dataclasses.dataclass
class StepSample:
    t: float
    step_time: float
    local_bytes: float
    remote_bytes: float
    dcn_bytes: float
    flops: float
    # KV block-pool health (serving): fraction of pool blocks in use, parks
    # (allocation failures) since the previous sample, and blocks copied
    # between chiplet-group domains since the previous sample.
    kv_occupancy: float = 0.0
    kv_parks: float = 0.0
    kv_blocks_migrated: float = 0.0
    # Continuous-batching loop health: pages committed lazily as streams
    # crossed a page boundary, streams parked MID-DECODE on domain
    # exhaustion, and prefill chunks processed — all deltas since the
    # previous sample.
    kv_lazy_grows: float = 0.0
    kv_mid_decode_parks: float = 0.0
    prefill_chunks: float = 0.0
    # Swap-tier eviction health: pages spilled to the host tier, spilled
    # streams restored mid-decode, and tokens thrown away by restart
    # evictions (the wasted-recompute metric the swap tier drives to 0) —
    # deltas since the previous sample.
    kv_spilled_pages: float = 0.0
    kv_restores: float = 0.0
    recompute_tokens: float = 0.0
    # Split mixed ticks: masked prefill-query rows decode streams did NOT
    # execute because the tick ran as a compacted chunk step + a single-
    # token step ((C-1) x decode streams per split tick) — delta since the
    # previous sample.
    mixed_tick_decode_rows_saved: float = 0.0
    # Prefix sharing: admissions that attached shared prompt pages and
    # prompt tokens whose prefill chunks were skipped entirely (deltas),
    # plus the pool's current shared-page footprint — pages with refcount
    # > 1 and the HBM bytes deduplication is saving right now (gauges).
    kv_prefix_hits: float = 0.0
    prefill_tokens_skipped: float = 0.0
    kv_shared_pages: float = 0.0
    kv_shared_bytes: float = 0.0
    # Speculative decoding: draft tokens proposed / accepted by greedy
    # verification and partial-accept rollbacks (deltas since the previous
    # sample), plus the engine's running acceptance-rate gauge
    # (accepted / drafted over the whole run so far).
    spec_tokens_drafted: float = 0.0
    spec_tokens_accepted: float = 0.0
    spec_rollbacks: float = 0.0
    spec_accept_rate: float = 0.0
    # SLO-tiered admission: requests granted PAST a blocked line head
    # (size-aware bypass, provably without delaying the head) and rounds
    # the wait line spent non-empty — deltas since the previous sample.
    kv_bypass_grants: float = 0.0
    kv_head_wait_ticks: float = 0.0
    # Async swap tier: pages/bytes with a D2H spill issued but not yet
    # fenced (gauges at sample time), decode ticks that ran with at least
    # one transfer outstanding, and fences that actually had to wait
    # (deltas) — the overlap-efficiency surface of the transfer engine.
    kv_spill_inflight_pages: float = 0.0
    kv_spill_inflight_bytes: float = 0.0
    kv_ticks_while_inflight: float = 0.0
    kv_fence_waits: float = 0.0


class PerfCounters:
    def __init__(self, window: int = 64, clock=time.monotonic):
        self._clock = clock
        self._window = window
        self.reset()

    # -- event API ----------------------------------------------------------
    def reset(self):
        self.totals: Dict[str, float] = collections.defaultdict(float)
        self.samples: Deque[StepSample] = collections.deque(maxlen=self._window)
        self._epoch = self._clock()
        self._last_reset = self._clock()

    def add(self, name: str, value: float):
        self.totals[name] += value

    def set(self, name: str, value: float):
        """Gauge semantics: overwrite instead of accumulate (e.g. pool
        occupancy)."""
        self.totals[name] = value

    def record_step(self, *, step_time: float, local_bytes: float = 0.0,
                    remote_bytes: float = 0.0, dcn_bytes: float = 0.0,
                    flops: float = 0.0, kv_occupancy: float = 0.0,
                    kv_parks: float = 0.0, kv_blocks_migrated: float = 0.0,
                    kv_lazy_grows: float = 0.0,
                    kv_mid_decode_parks: float = 0.0,
                    prefill_chunks: float = 0.0,
                    kv_spilled_pages: float = 0.0,
                    kv_restores: float = 0.0,
                    recompute_tokens: float = 0.0,
                    mixed_tick_decode_rows_saved: float = 0.0,
                    kv_prefix_hits: float = 0.0,
                    prefill_tokens_skipped: float = 0.0,
                    kv_shared_pages: float = 0.0,
                    kv_shared_bytes: float = 0.0,
                    spec_tokens_drafted: float = 0.0,
                    spec_tokens_accepted: float = 0.0,
                    spec_rollbacks: float = 0.0,
                    spec_accept_rate: float = 0.0,
                    kv_bypass_grants: float = 0.0,
                    kv_head_wait_ticks: float = 0.0,
                    kv_spill_inflight_pages: float = 0.0,
                    kv_spill_inflight_bytes: float = 0.0,
                    kv_ticks_while_inflight: float = 0.0,
                    kv_fence_waits: float = 0.0):
        self.add("steps", 1)
        self.add("local_bytes", local_bytes)
        self.add("remote_bytes", remote_bytes)
        self.add("dcn_bytes", dcn_bytes)
        self.add("flops", flops)
        self.samples.append(StepSample(self._clock(), step_time, local_bytes,
                                       remote_bytes, dcn_bytes, flops,
                                       kv_occupancy, kv_parks,
                                       kv_blocks_migrated, kv_lazy_grows,
                                       kv_mid_decode_parks, prefill_chunks,
                                       kv_spilled_pages, kv_restores,
                                       recompute_tokens,
                                       mixed_tick_decode_rows_saved,
                                       kv_prefix_hits,
                                       prefill_tokens_skipped,
                                       kv_shared_pages, kv_shared_bytes,
                                       spec_tokens_drafted,
                                       spec_tokens_accepted,
                                       spec_rollbacks, spec_accept_rate,
                                       kv_bypass_grants,
                                       kv_head_wait_ticks,
                                       kv_spill_inflight_pages,
                                       kv_spill_inflight_bytes,
                                       kv_ticks_while_inflight,
                                       kv_fence_waits))

    # -- Algorithm 1 inputs ---------------------------------------------------
    def event_counter(self, name: str = "remote_bytes") -> float:
        """Value accumulated since the last ``reset_events`` (Alg.1 line 5)."""
        return self.totals[name] - self.totals.get(name + "__mark", 0.0)

    def reset_events(self, name: str = "remote_bytes"):
        self.totals[name + "__mark"] = self.totals[name]

    def elapsed(self) -> float:
        return self._clock() - self._last_reset

    def mark_time(self):
        self._last_reset = self._clock()

    # -- derived metrics ------------------------------------------------------
    def ema_step_time(self, alpha: float = 0.25) -> Optional[float]:
        if not self.samples:
            return None
        ema = self.samples[0].step_time
        for s in self.samples:
            ema = alpha * s.step_time + (1 - alpha) * ema
        return ema

    def rates(self) -> Dict[str, float]:
        if len(self.samples) < 2:
            return {}
        dt = max(self.samples[-1].t - self.samples[0].t, 1e-9)
        n = len(self.samples)
        return {
            "steps_per_s": n / dt,
            "remote_bytes_per_s": sum(s.remote_bytes for s in self.samples) / dt,
            "local_bytes_per_s": sum(s.local_bytes for s in self.samples) / dt,
            "dcn_bytes_per_s": sum(s.dcn_bytes for s in self.samples) / dt,
        }

    # -- scoped segment profiling (paper: "monitor only specific segments") ---
    @contextlib.contextmanager
    def segment(self, name: str):
        t0 = self._clock()
        try:
            yield
        finally:
            self.add(f"segment/{name}/time", self._clock() - t0)
            self.add(f"segment/{name}/calls", 1)

    def snapshot(self) -> Dict[str, float]:
        return dict(self.totals)
