"""Lightweight concurrency (paper §4.4): coroutine tasks + chiplet-first
work stealing.

Tasks are Python generators (user-level continuations with developer-defined
yield points — the coroutine model of the paper).  Each *worker* owns a
priority deque; a worker whose deque is empty steals: first from workers in
the SAME chiplet group, then same pod, then anywhere — the
locality-preserving steal order of §4.4.

The steal path is tiered and O(#nonempty): victim tiers are *precomputed*
per worker at construction (group members, pod members) and the runtime
maintains occupancy indexes (which workers currently have work, per group /
per pod / fleet-wide), so an idle worker never rebuilds group/pod/fleet
candidate lists with full worker scans.  The seed's scan-based steal is kept
as ``steal_impl="scan"`` so ``benchmarks/sched_micro.py`` can measure the
win.

The runtime is cooperative and deterministic (seeded steal order) so
schedulers built on it are testable; at yield points the integrated profiler
hook fires (§4.4: "when a coroutine yields, ARCAS's profiling system
activates").  ``run()`` drives everything to completion; ``tick()`` advances
exactly one round so an outer control loop (the GlobalScheduler) can
evaluate Algorithm 1 at yield-point boundaries.

Tasks may park themselves by yielding the ``BLOCK`` sentinel (e.g. a request
waiting on KV-cache space); ``TaskRuntime.unblock`` re-enqueues them on
their home worker.  Higher ``priority`` tasks run before lower ones within a
worker.

The "work" scheduled here is host-side: serving requests,
prefill/decode micro-steps, data prefetch, checkpoint IO.  Device compute
stays in the steps these tasks launch on the card.
"""
from __future__ import annotations

import bisect
import collections
import dataclasses
import itertools
import random
import time
from typing import Any, Callable, Deque, Dict, FrozenSet, Generator, List, \
    Optional, Tuple

from repro_torch.core.counters import PerfCounters

# Yield this sentinel to park the task until TaskRuntime.unblock(task).
BLOCK = object()

_EMPTY: FrozenSet[int] = frozenset()


@dataclasses.dataclass
class TaskStats:
    spawned_at: float = 0.0
    yields: int = 0
    steals: int = 0
    finished_at: Optional[float] = None


class Task:
    _ids = itertools.count()

    def __init__(self, gen: Generator, *, group: Optional[int] = None,
                 name: str = "", priority: int = 0):
        if not isinstance(gen, Generator):
            raise TypeError("Task wraps a generator (coroutine with yields)")
        self.id = next(Task._ids)
        self.gen = gen
        self.group = group              # preferred chiplet group (affinity)
        self.name = name or f"task{self.id}"
        self.priority = priority        # higher runs first within a worker
        self.state = "ready"            # ready | blocked | done
        self.last_yield: Any = None     # value of the most recent yield
        self.stats = TaskStats(spawned_at=time.monotonic())
        self.result: Any = None
        self.done = False

    def step(self) -> bool:
        """Advance to the next yield point.  True if finished."""
        try:
            self.last_yield = next(self.gen)
            self.stats.yields += 1
            return False
        except StopIteration as e:
            self.result = getattr(e, "value", None)
            self.done = True
            self.state = "done"
            self.stats.finished_at = time.monotonic()
            return True


class Worker:
    """Owns per-priority deques; notifies the runtime on empty<->nonempty
    transitions so the tiered steal path can keep its occupancy indexes."""

    def __init__(self, wid: int, group: int, pod: int,
                 runtime: Optional["TaskRuntime"] = None):
        self.wid = wid
        self.group = group
        self.pod = pod
        self._runtime = runtime
        self._deques: Dict[int, Deque[Task]] = {}
        self._prios: List[int] = []     # ascending; scanned from the back
        self._size = 0
        self.executed_steps = 0
        self.stolen = 0

    def __len__(self) -> int:
        return self._size

    @property
    def deque(self) -> Tuple[Task, ...]:
        """Read-only snapshot (legacy view), highest priority first."""
        out: List[Task] = []
        for p in reversed(self._prios):
            out.extend(self._deques[p])
        return tuple(out)

    def push(self, task: Task):
        was_empty = self._size == 0
        dq = self._deques.get(task.priority)
        if dq is None:
            dq = self._deques[task.priority] = collections.deque()
            bisect.insort(self._prios, task.priority)
        dq.append(task)
        self._size += 1
        if was_empty and self._runtime is not None:
            self._runtime._mark_nonempty(self)

    def _take(self, *, newest: bool) -> Optional[Task]:
        if not self._size:
            return None
        for p in reversed(self._prios):
            dq = self._deques[p]
            if dq:
                task = dq.pop() if newest else dq.popleft()
                self._size -= 1
                if self._size == 0 and self._runtime is not None:
                    self._runtime._mark_empty(self)
                return task
        return None

    def pop_local(self) -> Optional[Task]:
        return self._take(newest=True)      # LIFO own end

    def steal_from(self) -> Optional[Task]:
        return self._take(newest=False)     # FIFO victim end


class WaitQueue:
    """Deterministic FIFO of BLOCK-parked tasks (§4.4 wakeup plumbing).

    A resource owner (e.g. the serving KV block pool) parks tasks that could
    not acquire the resource and wakes them when capacity frees up.  The
    protocol is cooperative and race-free: the task calls ``park(self_task)``
    and immediately ``yield BLOCK``; because the runtime is single-threaded,
    any ``wake`` (triggered by another task's step) can only run after the
    yield has been processed and the task really is blocked.  ``wake``
    re-enqueues parked tasks via ``TaskRuntime.unblock`` in FIFO order.

    The line is ordered by an explicit per-entry SEQ (a monotonic counter
    drawn at park time by default).  ``park(task, seq=...)`` lets a caller
    re-insert a task at a position it held earlier: the serving engine's
    size-aware bypass removes grantees from the MIDDLE of the line, and a
    bypassed stream that later parks mid-decode re-enters at its original
    arrival seq — not the back — so bypass never costs a stream its
    arrival-order claim.  ``to_back`` still draws a fresh (maximal) seq:
    spill victims consumed their turn.
    """

    def __init__(self, runtime: "TaskRuntime", clock=time.monotonic):
        self._rt = runtime
        self._clock = clock
        self._next_seq = 0
        self._q: Dict[int, Task] = {}
        self._order: Dict[int, int] = {}    # task.id -> line seq
        self._parked_at: Dict[int, float] = {}

    def __len__(self) -> int:
        return len(self._q)

    def __contains__(self, task: Task) -> bool:
        return task.id in self._q

    def _line(self) -> List[Task]:
        return sorted(self._q.values(), key=lambda t: self._order[t.id])

    def park(self, task: Task, seq: Optional[int] = None) -> int:
        """Join the wait line (idempotent: re-parking a task already in the
        line keeps its position, so a woken task that fails its retry and
        parks again has not lost its turn).  ``seq`` pins the line position
        (see class docstring); default is a fresh counter value — the back
        of the line.  Returns the seq the task holds."""
        if task.id in self._q:
            return self._order[task.id]
        self._parked_at[task.id] = self._clock()
        self._q[task.id] = task
        s = self._draw() if seq is None else seq
        # keep the counter strictly past any pinned seq, so a later
        # default park or ``to_back`` is genuinely the back of the line
        self._next_seq = max(self._next_seq, s + 1)
        self._order[task.id] = s
        return s

    def _draw(self) -> int:
        s = self._next_seq
        self._next_seq += 1
        return s

    def seq_of(self, task: Task) -> Optional[int]:
        """The line seq ``task`` holds, or None if it is not in the line."""
        return self._order.get(task.id)

    def remove(self, task: Task):
        """Leave the line — called by the task itself once its resource
        grant succeeds.  Membership until *grant* (not until wake) is what
        keeps grants FIFO: new arrivals check ``len(queue)`` and a
        woken-but-not-yet-granted head still counts."""
        self._q.pop(task.id, None)
        self._order.pop(task.id, None)
        self._parked_at.pop(task.id, None)

    def to_back(self, task: Task) -> Optional[int]:
        """Re-queue a parked task at the BACK of the line — the regrant
        path for a stream whose resources were reclaimed mid-wait (e.g. a
        KV table spilled to the swap tier): it consumed its turn, so every
        waiter currently in line now goes first.  Resets its parked-since
        clock (the new wait starts now); a no-op for tasks not in line.
        Returns the fresh seq (None for the no-op) so the caller can
        retire any arrival-position claim the task held."""
        if task.id not in self._q:
            return None
        s = self._draw()
        self._order[task.id] = s
        self._parked_at[task.id] = self._clock()
        return s

    def parked_since(self, task: Task) -> Optional[float]:
        """Clock time at which ``task`` first joined the line (survives
        wake/re-park cycles), or None if it is not in the line."""
        return self._parked_at.get(task.id)

    def oldest(self) -> Optional[Task]:
        """The lowest-seq task — the one a free is granted to first."""
        line = self._line()
        return line[0] if line else None

    def youngest(self) -> Optional[Task]:
        """The highest-seq task — the back of the line.  (Note: the
        serving engine's eviction watchdog picks its victim from its own
        mid-decode park records, NOT from this line, which also holds
        admission tasks that hold no resources worth reclaiming.)"""
        line = self._line()
        return line[-1] if line else None

    def tasks(self) -> List[Task]:
        """The whole line, front (lowest seq) first — the bypass safety
        scan walks this to apply the aging backstop."""
        return self._line()

    def wake(self, n: Optional[int] = None) -> int:
        """Wake the first ``n`` parked tasks (all when n is None) without
        removing them; returns the number woken.  Waking a task that is
        already runnable is a no-op (``unblock`` ignores it)."""
        woken = 0
        for task in self._line():
            if n is not None and woken >= n:
                break
            self._rt.unblock(task)
            woken += 1
        return woken


class TaskRuntime:
    """Cooperative scheduler over per-group workers with locality stealing."""

    def __init__(self, *, n_pods: int = 1, groups_per_pod: int = 16,
                 workers_per_group: int = 1, seed: int = 0,
                 counters: Optional[PerfCounters] = None,
                 profile_hook: Optional[Callable[[Task], None]] = None,
                 steal_impl: str = "tiered"):
        self.counters = counters or PerfCounters()
        self.profile_hook = profile_hook
        self.workers: List[Worker] = []
        for pod in range(n_pods):
            for g in range(groups_per_pod):
                for _ in range(workers_per_group):
                    gid = pod * groups_per_pod + g
                    self.workers.append(
                        Worker(len(self.workers), gid, pod, runtime=self))
        # precomputed victim tiers: static membership per group / per pod
        self._group_members: Dict[int, FrozenSet[int]] = {}
        self._pod_members: Dict[int, FrozenSet[int]] = {}
        by_g: Dict[int, set] = collections.defaultdict(set)
        by_p: Dict[int, set] = collections.defaultdict(set)
        for w in self.workers:
            by_g[w.group].add(w.wid)
            by_p[w.pod].add(w.wid)
        self._group_members = {g: frozenset(s) for g, s in by_g.items()}
        self._pod_members = {p: frozenset(s) for p, s in by_p.items()}
        # occupancy indexes: wids that currently have queued work
        self._ne_group: Dict[int, set] = collections.defaultdict(set)
        self._ne_pod: Dict[int, set] = collections.defaultdict(set)
        self._ne_all: set = set()
        self._blocked: Dict[int, Task] = {}
        if steal_impl not in ("tiered", "scan"):
            raise ValueError(f"unknown steal_impl {steal_impl!r}")
        self._steal = (self._steal_tiered if steal_impl == "tiered"
                       else self._steal_scan)
        self._rng = random.Random(seed)
        self._rr = 0
        self.rounds = 0
        self.steal_log: List[Dict] = []

    # -- occupancy bookkeeping (called by Worker on transitions) -----------
    def _mark_nonempty(self, w: Worker):
        self._ne_group[w.group].add(w.wid)
        self._ne_pod[w.pod].add(w.wid)
        self._ne_all.add(w.wid)

    def _mark_empty(self, w: Worker):
        self._ne_group[w.group].discard(w.wid)
        self._ne_pod[w.pod].discard(w.wid)
        self._ne_all.discard(w.wid)

    def pending(self) -> bool:
        """Any runnable (non-blocked) work queued anywhere?"""
        return bool(self._ne_all)

    def blocked(self) -> List[Task]:
        return list(self._blocked.values())

    # ------------------------------------------------------------------
    def spawn(self, gen: Generator, *, group: Optional[int] = None,
              name: str = "", priority: int = 0,
              worker: Optional[int] = None) -> Task:
        task = Task(gen, group=group, name=name, priority=priority)
        w = (self.workers[worker] if worker is not None
             else self._home_worker(task))
        w.push(task)
        self.counters.add("tasks_spawned", 1)
        return task

    def _home_worker(self, task: Task) -> Worker:
        if task.group is not None:
            members = self._group_members.get(task.group)
            if members:
                return min((self.workers[i] for i in members),
                           key=lambda w: (len(w), w.wid))
        self._rr = (self._rr + 1) % len(self.workers)
        return self.workers[self._rr]

    def unblock(self, task: Task):
        """Re-enqueue a task previously parked via ``yield BLOCK``."""
        t = self._blocked.pop(task.id, None)
        if t is None or t.done:
            return
        t.state = "ready"
        self.counters.add("tasks_unblocked", 1)
        self._home_worker(t).push(t)

    # -- §4.4 steal order: same group, then same pod, then anywhere --------
    def _steal_tiered(self, thief: Worker) -> Optional[Task]:
        """Occupancy-indexed steal: cost scales with the number of workers
        that *have* work, not the fleet size."""
        g_ne = self._ne_group.get(thief.group, _EMPTY)
        cands: Any = g_ne - {thief.wid} if g_ne else _EMPTY
        tier = "group"
        if not cands:
            p_ne = self._ne_pod.get(thief.pod, _EMPTY)
            cands, tier = p_ne - g_ne if p_ne else _EMPTY, "pod"
        if not cands:
            p_ne = self._ne_pod.get(thief.pod, _EMPTY)
            cands, tier = self._ne_all - p_ne, "fleet"
        if not cands:
            return None
        victim = self.workers[self._rng.choice(sorted(cands))]
        return self._finish_steal(thief, victim, tier)

    def _steal_scan(self, thief: Worker) -> Optional[Task]:
        """The seed's scan-based steal (O(W) per idle call) — kept as the
        baseline for benchmarks/sched_micro.py."""
        tiers = (
            [w for w in self.workers
             if w is not thief and w.group == thief.group],
            [w for w in self.workers
             if w.group != thief.group and w.pod == thief.pod],
            [w for w in self.workers if w.pod != thief.pod],
        )
        for tier_name, tier in zip(("group", "pod", "fleet"), tiers):
            victims = [w for w in tier if len(w)]
            if victims:
                victim = self._rng.choice(victims)
                return self._finish_steal(thief, victim, tier_name)
        return None

    def _finish_steal(self, thief: Worker, victim: Worker,
                      tier: str) -> Optional[Task]:
        task = victim.steal_from()
        if task is None:
            return None
        thief.stolen += 1
        task.stats.steals += 1
        self.counters.add(f"steals_{tier}", 1)
        # cross-group steal = remote traffic (counter feed for Algorithm 1)
        if tier != "group":
            self.counters.add("remote_bytes", 1.0)
        self.steal_log.append(
            {"thief": thief.wid, "victim": victim.wid,
             "tier": tier, "task": task.id})
        return task

    # ------------------------------------------------------------------
    def tick(self) -> int:
        """One cooperative round over all workers (a yield-point boundary
        for every running task).  Returns the number of tasks advanced."""
        active = 0
        for w in self.workers:
            task = w.pop_local() or self._steal(w)
            if task is None:
                continue
            active += 1
            finished = task.step()
            w.executed_steps += 1
            if self.profile_hook is not None:
                self.profile_hook(task)           # yield-point profiling
            if finished:
                continue
            if task.last_yield is BLOCK:
                task.state = "blocked"
                self._blocked[task.id] = task
                self.counters.add("tasks_blocked", 1)
            else:
                w.push(task)
        self.rounds += 1
        return active

    def run(self, *, max_rounds: int = 10_000_000,
            concurrency_trace: Optional[List[int]] = None) -> int:
        """Drive all runnable tasks to completion; returns rounds used.
        Tasks parked via BLOCK stay parked (see ``unblock``)."""
        rounds = 0
        while self.pending() and rounds < max_rounds:
            active = self.tick()
            rounds += 1
            if concurrency_trace is not None:
                concurrency_trace.append(active)
        if self.pending():
            raise RuntimeError("TaskRuntime.run exceeded max_rounds")
        return rounds

    def barrier(self):
        """Paper API: run everything currently queued to completion."""
        self.run()
