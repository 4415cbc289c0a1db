"""Global scheduler (paper §4.1 component 4) — the single owner of the
adaptive controller, the coroutine task runtime and the current Layout.

Both the Trainer and the ServeEngine run on this substrate.  The control
loop is ``tick()``-driven: each tick advances the task runtime one round (a
yield-point boundary for every running coroutine) and then evaluates
Algorithm 1.  When the controller moves the spread rate, every registered
``RelayoutHandler`` is invoked with the new Layout — handlers perform the
actual state movement (``Tensor.to(device)`` of param / optimizer / KV-cache
trees onto the new devices for training, replica-group merge/split with KV
slot migration for serving: the accelerator analogue of moving threads and
rebinding memory).

``TieredQueues`` exposes the §4.4 tier-ordered steal path for
*request-level* objects (serving requests, IO work items), not just
coroutines: pop drains the local queue first, then steals oldest-first from
same-pod queues, then cross-pod — feeding the same remote-traffic counters
Algorithm 1 thresholds on.
"""
from __future__ import annotations

import collections
import dataclasses
import time
from typing import Any, Callable, Deque, Dict, List, Optional, Sequence, \
    Tuple

import torch

from repro_torch.core.controller import AdaptiveController, ControllerConfig, Decision
from repro_torch.core.counters import PerfCounters
from repro_torch.core.layout import Layout
from repro_torch.core.tasks import TaskRuntime
from repro_torch.core.topology import ChipletTopology

# Called with (new_layout, decision) when Algorithm 1 moves the spread rate.
RelayoutHandler = Callable[[Layout, Decision], None]


@dataclasses.dataclass
class MigrationEvent:
    step: int
    decision: Decision
    seconds: float


class GlobalScheduler:
    def __init__(self, topology: ChipletTopology,
                 controller_cfg: Optional[ControllerConfig] = None,
                 *, spread_rate: int = 1, pod_axis: bool = False,
                 cost_fn=None, working_set_fn=None,
                 counters: Optional[PerfCounters] = None, seed: int = 0,
                 control_enabled: bool = True):
        self.topology = topology
        self.counters = counters or PerfCounters()
        self.controller = AdaptiveController(
            topology, controller_cfg or ControllerConfig(),
            spread_rate=spread_rate, pod_axis=pod_axis,
            cost_fn=cost_fn, working_set_fn=working_set_fn)
        self.tasks = TaskRuntime(
            n_pods=topology.n_pods, groups_per_pod=topology.groups_per_pod,
            seed=seed, counters=self.counters)
        self.control_enabled = control_enabled
        self.migrations: List[MigrationEvent] = []
        self.last_active = 0            # tasks advanced by the latest tick
        self._handlers: List[RelayoutHandler] = []
        self._step = 0

    # ------------------------------------------------------------------
    def layout(self) -> Layout:
        return self.controller.layout()

    def spawn(self, gen, **kw):
        """Spawn a coroutine on the shared task runtime."""
        return self.tasks.spawn(gen, **kw)

    def pending(self) -> bool:
        return self.tasks.pending()

    def register_relayout(self, handler: RelayoutHandler) -> RelayoutHandler:
        """Register a handler invoked (new_layout, decision) on relayout."""
        self._handlers.append(handler)
        return handler

    # ------------------------------------------------------------------
    def tick(self, *, step_metrics: Optional[Dict[str, float]] = None,
             run_tasks: bool = True) -> Optional[Decision]:
        """One beat of the unified control loop.

        Records step metrics, advances every runnable coroutine to its next
        yield point, then runs one Algorithm-1 evaluation; on a spread-rate
        change the registered RelayoutHandlers migrate live state.
        """
        self._step += 1
        if step_metrics:
            self.counters.record_step(
                step_time=step_metrics.get("step_time", 0.0),
                local_bytes=step_metrics.get("local_bytes", 0.0),
                remote_bytes=step_metrics.get("remote_bytes", 0.0),
                dcn_bytes=step_metrics.get("dcn_bytes", 0.0),
                flops=step_metrics.get("flops", 0.0),
                kv_occupancy=step_metrics.get("kv_occupancy", 0.0),
                kv_parks=step_metrics.get("kv_parks", 0.0),
                kv_blocks_migrated=step_metrics.get("kv_blocks_migrated",
                                                    0.0),
                kv_lazy_grows=step_metrics.get("kv_lazy_grows", 0.0),
                kv_mid_decode_parks=step_metrics.get("kv_mid_decode_parks",
                                                     0.0),
                prefill_chunks=step_metrics.get("prefill_chunks", 0.0),
                kv_spilled_pages=step_metrics.get("kv_spilled_pages", 0.0),
                kv_restores=step_metrics.get("kv_restores", 0.0),
                recompute_tokens=step_metrics.get("recompute_tokens", 0.0),
                mixed_tick_decode_rows_saved=step_metrics.get(
                    "mixed_tick_decode_rows_saved", 0.0),
                kv_prefix_hits=step_metrics.get("kv_prefix_hits", 0.0),
                prefill_tokens_skipped=step_metrics.get(
                    "prefill_tokens_skipped", 0.0),
                kv_shared_pages=step_metrics.get("kv_shared_pages", 0.0),
                kv_shared_bytes=step_metrics.get("kv_shared_bytes", 0.0),
                spec_tokens_drafted=step_metrics.get("spec_tokens_drafted",
                                                     0.0),
                spec_tokens_accepted=step_metrics.get(
                    "spec_tokens_accepted", 0.0),
                spec_rollbacks=step_metrics.get("spec_rollbacks", 0.0),
                spec_accept_rate=step_metrics.get("spec_accept_rate", 0.0),
                kv_bypass_grants=step_metrics.get("kv_bypass_grants", 0.0),
                kv_head_wait_ticks=step_metrics.get("kv_head_wait_ticks",
                                                    0.0))
        self.last_active = (self.tasks.tick()
                            if run_tasks and self.tasks.pending() else 0)
        return self._control()

    def _control(self) -> Optional[Decision]:
        if not self.control_enabled:
            return None
        decision = self.controller.maybe_reschedule(self.counters)
        if decision is not None:
            t0 = time.monotonic()
            new_layout = self.layout()
            for h in self._handlers:
                h(new_layout, decision)
            self.migrations.append(
                MigrationEvent(self._step, decision, time.monotonic() - t0))
        return decision

    def run_until_done(self, *, max_rounds: int = 10_000_000,
                       concurrency_trace: Optional[List[int]] = None,
                       metrics_fn: Optional[Callable[[], Dict[str, float]]]
                       = None,
                       round_hook: Optional[Callable[[], None]] = None) -> int:
        """Tick until the task runtime drains; returns rounds used.

        Unlike ``TaskRuntime.run``, the controller fires *during* the run,
        so relayout handlers may migrate state (and spawn replacement
        coroutines) mid-flight.  ``metrics_fn`` — when given — supplies the
        per-round ``step_metrics`` dict fed to the profiler (e.g. the
        serving engine's KV-pool gauges).  ``round_hook`` — when given — is
        called after every tick, at a point where all coroutines sit at
        yield boundaries; the serving engine uses it to watch for
        allocation stalls (every stream BLOCK-parked on pool growth) and
        break them, something no single coroutine can observe from inside.
        """
        rounds = 0
        while self.tasks.pending() and rounds < max_rounds:
            self.tick(step_metrics=metrics_fn() if metrics_fn else None)
            if concurrency_trace is not None:
                concurrency_trace.append(self.last_active)
            if round_hook is not None:
                round_hook()
            rounds += 1
        if self.tasks.pending():
            raise RuntimeError("GlobalScheduler.run_until_done exceeded "
                               "max_rounds")
        return rounds

    # -- legacy single-shot entry (pre-tick API), kept for compatibility ---
    def after_step(self, *, step_metrics: Optional[Dict[str, float]] = None,
                   migrate_fn: Optional[Callable[[Layout], None]] = None
                   ) -> Optional[Decision]:
        """Deprecated: one control evaluation without driving tasks.
        Prefer ``tick()`` with a registered RelayoutHandler."""
        if migrate_fn is None:
            return self.tick(step_metrics=step_metrics, run_tasks=False)
        handler: RelayoutHandler = lambda layout, _d: migrate_fn(layout)
        self._handlers.append(handler)
        try:
            return self.tick(step_metrics=step_metrics, run_tasks=False)
        finally:
            self._handlers.remove(handler)


class TieredQueues:
    """§4.4 tier-ordered work stealing for request-level objects.

    Queue ``i`` belongs to pod ``pods[i]`` (for serving: one queue per
    replica group, pod derived from the Layout).  ``pop(i)`` drains the
    local queue first; otherwise it steals the oldest item from the fullest
    victim queue, walking the tiers outward — counting ``steals_<tier>`` and
    feeding ``remote_bytes`` (plus ``dcn_bytes`` for cross-pod moves) so
    Algorithm 1 sees request migration traffic exactly like coroutine-steal
    traffic.

    With ``neighborhoods`` given (one id per queue), queues sharing a
    neighborhood form a third, cheaper *group* tier searched before the pod
    tier — replicas whose chiplet-group spans are 1-hop ICI neighbors (used
    by the engine when ``spread_rate < groups_per_pod``).  Steal order is
    then: own queue -> same neighborhood ("group") -> same pod ("pod") ->
    anywhere ("fleet").
    """

    def __init__(self, pods: Sequence[int], *,
                 neighborhoods: Optional[Sequence[Any]] = None,
                 counters: Optional[PerfCounters] = None,
                 bytes_fn: Optional[Callable[[Any], float]] = None):
        self._pods = list(pods)
        self._qs: List[Deque[Any]] = [collections.deque() for _ in pods]
        self.counters = counters or PerfCounters()
        self._bytes_fn = bytes_fn or (lambda _item: 1.0)
        by_pod: Dict[int, List[int]] = collections.defaultdict(list)
        for qid, pod in enumerate(self._pods):
            by_pod[pod].append(qid)
        hoods = list(neighborhoods) if neighborhoods is not None else None
        if hoods is not None and len(hoods) != len(self._pods):
            raise ValueError("neighborhoods must give one id per queue")
        # precomputed steal tiers per queue: neighborhood peers (optional),
        # then remaining same-pod peers, then the rest
        self._tiers: List[Tuple[Tuple[str, List[int]], ...]] = []
        for qid, pod in enumerate(self._pods):
            same = [j for j in by_pod[pod] if j != qid]
            rest = [j for j in range(len(self._pods)) if self._pods[j] != pod]
            tiers: List[Tuple[str, List[int]]] = []
            if hoods is not None:
                near = [j for j in same if hoods[j] == hoods[qid]]
                if near:
                    tiers.append(("group", near))
                same = [j for j in same if hoods[j] != hoods[qid]]
            tiers.append(("pod", same))
            tiers.append(("fleet", rest))
            self._tiers.append(tuple(tiers))

    def __len__(self) -> int:
        return sum(len(q) for q in self._qs)

    def pending(self) -> bool:
        return any(self._qs)

    def queue(self, qid: int) -> Deque[Any]:
        """The underlying deque (read/len; prefer push/pop to mutate)."""
        return self._qs[qid]

    def push(self, qid: int, item: Any):
        self._qs[qid].append(item)

    def pop(self, qid: int,
            accept: Optional[Callable[[Any, str], bool]] = None
            ) -> Tuple[Optional[Any], Optional[str]]:
        """-> (item, tier) with tier in {"local", "group", "pod", "fleet"},
        or (None, None) when no queue can serve.

        ``accept(item, tier)`` — when given — is consulted before a steal is
        committed; returning False leaves the item on its victim queue and
        the steal uncounted (the serving engine uses this to refuse steals
        whose KV reservation cannot move into the thief's memory domain).
        """
        q = self._qs[qid]
        if q:
            return q.popleft(), "local"
        for tier, cand in self._tiers[qid]:
            victims = sorted((j for j in cand if self._qs[j]),
                             key=lambda v: (-len(self._qs[v]), v))  # balance
            for j in victims:
                item = self._qs[j][0]
                if accept is not None and not accept(item, tier):
                    continue
                self._qs[j].popleft()
                moved = float(self._bytes_fn(item))
                self.counters.add(f"steals_{tier}", 1)
                self.counters.add("remote_bytes", moved)
                if tier == "fleet":
                    self.counters.add("dcn_bytes", moved)
                return item, tier
        return None, None


def migrate_pytree(tree: Any, target: Any, *, src: Any = None) -> Any:
    """Move a nested dict/list/tuple of tensors (task migration).

    ``target`` a device: every tensor moves there.  ``target`` a tree of
    ``launch.sharding.NamedSharding`` (or one for every leaf): each leaf —
    this rank's part under ``src``, a matching tree of the old shardings
    (None: the leaf is whole) — is gathered over the old mesh and sliced
    for the new one; every rank of both meshes takes part.  Non-tensor
    leaves pass through."""
    from repro_torch.launch import sharding as sh

    def sub(t, k):
        return t[k] if isinstance(t, (dict, list, tuple)) else t

    if isinstance(tree, torch.Tensor):
        if isinstance(target, sh.NamedSharding):
            full = sh.gather(tree, src) if src is not None else tree
            return sh.shard(full, target)
        return tree.to(target)
    if isinstance(tree, dict):
        return {k: migrate_pytree(v, sub(target, k), src=sub(src, k))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(migrate_pytree(v, sub(target, i), src=sub(src, i))
                          for i, v in enumerate(tree))
    return tree
