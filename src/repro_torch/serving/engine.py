"""Serving engine of the port: a continuous-batching TOKEN loop over
chiplet-group replicas, on the GlobalScheduler substrate, with the elastic
paged KV pool — the JAX package's ``serving/engine.py`` on PyTorch.

The default configuration is the path this module runs:

  * every request is a COROUTINE: an admission task that reserves the KV
    pages of its first prefill chunk from a replica's chiplet-group memory
    domain, parking via ``yield BLOCK`` when the pool is exhausted and
    woken by the pool's free callback;
  * every engine tick runs the group's streams as prefill CHUNKS (page-
    sized slices of prompts) and single-token decode streams.  A tick with
    chunks is SPLIT into two steps over compacted batches: the fused
    multi-token forward for the prefill streams (its attention is the
    hand-written ring-chunk CUDA kernel on the card) and the single-token
    step for the decode streams;
  * tables GROW lazily as ``pos`` crosses page boundaries; a stream whose
    domain is exhausted mid-decode PARKS in the FIFO wait line and resumes
    when pages free;
  * prompt PREFIX SHARING attaches already-resident prompt pages
    refcounted (copy-on-write at ring wrap) and skips their prefill;
  * the stall watchdog breaks the incremental-allocation deadlock by
    SPILLING the youngest parked stream's pages to the host swap tier
    (``evict_mode="swap"``) and restoring them when pages free — zero
    recomputed tokens; ``evict_mode="restart"`` recomputes from scratch;
  * the adaptive controller runs LIVE: a spread-rate change rebuilds the
    replica groups mid-run (``_relayout``), tables re-point at their
    domain's new owner and only rebalanced streams copy their used pages;
  * SLO classes with the size-aware admission bypass and the proactive
    watermark spill rung, as in the JAX package.

Steps run eagerly: where the JAX package jits a step and donates the pool
storage, the port writes the storage in place.  The dense, SSM and hybrid
families are served; an SSM model's streams hold a state slot and no
ring pages, so they take the pool's state-slot paths and never share a
prompt prefix (the JAX engine shares prefixes only for models with ring
pages).  A hybrid model's streams hold ring pages for its local-attention
layers and a state slot for its recurrent layers: a prompt prefix is
shared through the state checkpoints the pool snaps at page boundaries,
and a spill carries the state leaves with the pages.

Not ported yet (each raises ``NotImplementedError`` naming its ROADMAP
item): speculative decoding, the asynchronous swap tier, the slot monolith
(``paged=False``), the eager allocator (``lazy=False``), the per-token
scan chunk path (``prefill_mode="scan"``), ``measured_model_steps`` and
``warm_steps``.
"""
from __future__ import annotations

import dataclasses
import itertools
import math
import time
from typing import Any, Callable, Dict, Iterable, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.controller import ControllerConfig, Decision
from repro_torch.core.costmodel import kv_bypass_floor_bytes, \
    kv_transfer_seconds, prefill_chunk_bytes, prefill_chunk_score_bytes
from repro_torch.core.layout import Layout
from repro_torch.core.scheduler import GlobalScheduler, TieredQueues
from repro_torch.core.tasks import BLOCK, WaitQueue
from repro_torch.core.topology import ChipletTopology
from repro_torch.launch.steps import make_serve_chunk_step, make_serve_step
from repro_torch.models import decode as dec
from repro_torch.models.params import PORTED_FAMILIES, init_params
from repro_torch.serving.kvpool import KVBlockPool, KVTable, kv_bytes_exact


@dataclasses.dataclass(frozen=True)
class ClassSLO:
    """Per-request-class service targets + scheduling privileges.

    ``ttft_target``/``tpot_target`` are reporting targets (seconds to
    first token / seconds per output token after the first); ``bypass``
    marks the class eligible for the size-aware admission bypass."""
    ttft_target: float = math.inf
    tpot_target: float = math.inf
    bypass: bool = False


#: ``interactive`` requests may bypass a blocked line head; ``batch`` —
#: the submit() default — never does.
DEFAULT_SLO_CLASSES: Dict[str, ClassSLO] = {
    "interactive": ClassSLO(ttft_target=0.5, tpot_target=0.05, bypass=True),
    "batch": ClassSLO(),
}


@dataclasses.dataclass
class Request:
    rid: int
    prompt: np.ndarray                  # (S,) int32
    max_new: int
    arrived: float = 0.0
    group: Optional[int] = None
    generated: List[int] = dataclasses.field(default_factory=list)
    t_first: Optional[float] = None
    t_done: Optional[float] = None
    migrations: int = 0                 # relayouts survived while in flight
    table: Optional[KVTable] = None     # KV pages + state slot
    prefix_tokens: int = 0              # prompt tokens served from shared
                                        # prefix pages (prefill starts here)
    cls: str = "batch"                  # SLO class (EngineConfig.slo_classes)
    bypassed: bool = False              # granted past a blocked line head
    wq_seq: Optional[int] = None        # wait-line seq drawn at submit
    grant_rounds: List[int] = dataclasses.field(default_factory=list)
                                        # engine round of every page grant
    arrive_round: int = 0               # engine round at submit
    page_keys: Optional[List[bytes]] = dataclasses.field(
        default=None, repr=False, compare=False)  # prompt hash chain
    _kv_fn: Optional[Callable[[int], float]] = dataclasses.field(
        default=None, repr=False, compare=False)

    @property
    def done(self) -> bool:
        return self.t_done is not None

    def kv_bytes(self) -> float:
        """KV footprint moved when this request changes groups (exact,
        from the cost model through the engine's calculator)."""
        return self._kv_fn(len(self.prompt) + len(self.generated))


@dataclasses.dataclass
class EngineConfig:
    max_batch: int = 8                 # decode slots per replica group
    max_len: int = 256
    adaptive: bool = True
    paged: bool = True                 # paged KV block pool
    lazy: bool = True                  # elastic reservations + chunked prefill
    block_tokens: int = 16             # ring tokens per KV page
    prefill_chunk: Optional[int] = None  # prompt tokens per prefill chunk;
                                         # default: one KV page
    prefill_mode: str = "parallel"     # fused multi-token chunk forward
    chunk_kernel: str = "blocked"      # fused-path attention: "blocked" is
                                       # the ring-chunk CUDA kernel on the
                                       # card, "dense" the plain softmax
    split_ticks: bool = True           # mixed ticks run the chunk step over
                                       # prefill streams and the single-token
                                       # step over decode streams
    pool_streams: Optional[int] = None  # per-DOMAIN budget in full-length
                                        # streams; default max_batch
    stall_evict_rounds: int = 6        # allocation-stall rounds before the
                                       # deadlock breaker spills / evicts
    evict_mode: str = "swap"           # "swap" spills to the host tier and
                                       # resumes; "restart" recomputes
    headroom: int = 0                  # blocks a lazy admission keeps free
                                       # after its first chunk
    prefix_share: bool = True          # hash-matched prefix caching
    spec_decode: str = "off"           # speculative decoding (not ported)
    cached_retention: str = "access"   # cached prefix-page reclaim order
    slo_classes: Dict[str, ClassSLO] = dataclasses.field(
        default_factory=lambda: dict(DEFAULT_SLO_CLASSES))
    slo_bypass: bool = True            # size-aware bypass of a parked head
    slo_aging_rounds: int = 200        # bypass fairness backstop
    spill_watermarks: Optional[Tuple[float, float]] = None
                                       # (high, low) occupancy marks for
                                       # proactive spill; None = watchdog only
    async_swap: bool = False           # overlapped spills (not ported)
    controller: ControllerConfig = dataclasses.field(
        default_factory=lambda: ControllerConfig(
            scheduler_timer=8, threshold=4.0, min_dwell=2))


def _unported(ecfg: EngineConfig) -> Optional[str]:
    """The first option of ``ecfg`` that selects a path not ported yet,
    with its ROADMAP item."""
    if not ecfg.paged:
        return "paged=False (the slot-monolith cache): ROADMAP A6"
    if not ecfg.lazy:
        return "lazy=False (the eager make_prefill path): ROADMAP A6"
    if ecfg.prefill_mode == "scan":
        return "prefill_mode='scan' (chunk_decode_step): ROADMAP A3"
    if ecfg.spec_decode != "off":
        return f"spec_decode={ecfg.spec_decode!r} (serving/spec.py): " \
               "ROADMAP A6"
    if ecfg.async_swap:
        return "async_swap=True (the overlapped swap tier): ROADMAP A6"
    return None


@dataclasses.dataclass
class _InFlight:
    """A mid-generation stream harvested from a retired replica group (or
    a mid-decode park); its KV stays in the pool, only the table pointer
    moves.  ``pos`` < len(prompt) means it was harvested mid-PREFILL."""
    req: Request
    pos: int
    token: int


@dataclasses.dataclass
class _Parked:
    """A stream suspended MID-DECODE because its domain could not grow its
    table.  It holds its pages (and its place in the FIFO wait line) but
    not a decode slot; ``_regrow_task`` resumes it."""
    req: Request
    pos: int
    token: int
    seq: int                            # park order (eviction prefers max)
    cell: Dict[str, Any] = dataclasses.field(default_factory=dict)
    evicted: bool = False


class _Group:
    """One replica group: decode slots over the engine's KV pool.

    ``queue`` is the group's deque inside the engine's TieredQueues;
    ``resume`` holds migrated in-flight streams awaiting a free slot;
    ``retired`` marks groups dissolved by a relayout.  ``pos_h``/``tok_h``
    are every slot's stream cursor: absolute position of the next token to
    process and the last emitted token."""

    def __init__(self, gid: int, pod: int, ecfg: EngineConfig, queue,
                 domains: List[int]):
        self.gid = gid
        self.pod = pod
        self.queue = queue
        self.domains = domains          # chiplet-group pool domains owned
        self.resume: List[_InFlight] = []
        self.retired = False
        self.slots: List[Optional[Request]] = [None] * ecfg.max_batch
        self.pos_h = np.zeros((ecfg.max_batch,), np.int32)
        self.tok_h = np.zeros((ecfg.max_batch,), np.int32)

    def free_slots(self) -> List[int]:
        return [i for i, s in enumerate(self.slots) if s is None]

    def busy(self) -> bool:
        return (bool(self.queue) or bool(self.resume)
                or any(s is not None for s in self.slots))

    def kv_pressure(self) -> float:
        used = sum(1 for s in self.slots if s is not None)
        return used / max(1, len(self.slots))


def _bucket(n: int, cap: int) -> int:
    """Smallest power of two >= n, capped: the compacted batch size of a
    split-tick half (the JAX package's compiled-shape buckets; kept so the
    two engines run the same rows)."""
    b = 1
    while b < n:
        b *= 2
    return min(b, cap)


class ServeEngine:
    """``ServeEngine(cfg, topology, ecfg, seed=0, device="cuda")``.

    Runs on ``device`` — CUDA unless the caller asks for the CPU.  The
    weights are ``params`` when given (a dict of tensors on ``device``,
    e.g. ``from_reference`` of the JAX engine's weights), else random from
    a ``torch.Generator`` seeded with ``seed``."""

    def __init__(self, cfg: ModelConfig, topology: ChipletTopology,
                 ecfg: EngineConfig = EngineConfig(), *, seed: int = 0,
                 spread_rate: int = 1, params=None, device="cuda"):
        unported = _unported(ecfg)
        if unported:
            raise NotImplementedError(f"not ported yet: {unported}")
        if cfg.family not in PORTED_FAMILIES:
            raise NotImplementedError(f"{cfg.name}: the {cfg.family!r} family "
                                      "is not ported yet (ROADMAP A8)")
        if ecfg.evict_mode not in ("swap", "restart"):
            raise ValueError(f"unknown evict_mode {ecfg.evict_mode!r}")
        if ecfg.prefill_mode != "parallel":
            raise ValueError(f"unknown prefill_mode {ecfg.prefill_mode!r}")
        if ecfg.chunk_kernel not in ("blocked", "dense"):
            raise ValueError(f"unknown chunk_kernel {ecfg.chunk_kernel!r}")
        if not ecfg.slo_classes:
            raise ValueError("slo_classes must name at least one class")
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("ServeEngine runs on CUDA by default and no "
                               "CUDA device is available; pass device='cpu' "
                               "to run on the CPU")
        self.cfg = cfg
        self.topology = topology
        self.ecfg = ecfg
        self.sched = GlobalScheduler(
            topology, ecfg.controller, spread_rate=spread_rate,
            control_enabled=ecfg.adaptive)
        self.counters = self.sched.counters
        self.controller = self.sched.controller
        self.runtime = self.sched.tasks
        if params is None:
            gen = torch.Generator(device=self.device).manual_seed(seed)
            params = init_params(cfg, gen, device=self.device)
        self.params = params
        self._rid = itertools.count()
        self._clock = time.monotonic
        self._running = False
        self._inflight = 0              # submitted, not yet done
        self._clients = 0               # active open-loop client coroutines
        self.submitted: List[Request] = []
        self.relayouts: List[Dict] = []
        self._chunk_kernel = ecfg.chunk_kernel
        self._parked: Dict[int, _Parked] = {}
        self._park_seq = itertools.count()
        self._progress_mark = -1.0
        self._stall_rounds = 0
        self._round = 0                 # scheduler rounds seen (_stall_hook)
        self._head_id: Optional[int] = None   # current line-head task id and
        self._head_wait = 0                   # rounds it has sat blocked there
        # bypass-class waiters are woken on frees and grants; _bypass_on
        # gates the grants themselves
        self._bypass_wake = any(c.bypass for c in ecfg.slo_classes.values())
        self._bypass_on = self._bypass_wake and ecfg.slo_bypass
        self._wait_round: Dict[int, int] = {}
        self._bypass_cells: Dict[int, Dict[str, Any]] = {}
        # every bypass grant as (round, granted rid, jumped head rid)
        self.bypass_log: List[Tuple[int, int, int]] = []
        streams = ecfg.pool_streams or ecfg.max_batch
        budget = KVBlockPool.blocks_for_streams(
            cfg, ecfg.max_len, streams, ecfg.block_tokens)
        self.pool = KVBlockPool(
            cfg, n_domains=topology.total_groups, max_len=ecfg.max_len,
            block_tokens=ecfg.block_tokens, counters=self.counters,
            retention=ecfg.cached_retention, topology=topology,
            device=self.device, **budget)
        self.waiters = WaitQueue(self.runtime)
        # wake ONE waiter per free: grants stay FIFO (a successful
        # admission cascades the wake to the next waiter itself)
        self.pool.on_free(self._on_pool_free)
        if ecfg.spill_watermarks is not None:
            self.pool.set_watermarks(*ecfg.spill_watermarks)
        self._decode_step = make_serve_step(cfg)
        self._chunk_step = make_serve_chunk_step(
            cfg, self.pool.spec, mode="parallel",
            chunk_kernel=self._chunk_kernel)
        ml = ecfg.max_len
        self._kv_fn = lambda n: kv_bytes_exact(cfg, n, ml)
        self._share = ecfg.prefix_share and self.pool.pages_per_stream > 0
        # prefill chunk: one KV page by default (ring models), the
        # configured page size for pure-state models (no ring pages).  No
        # C <= W clamp: the fused forward handles chunks wider than the ring
        self._chunk = ecfg.prefill_chunk or (
            self.pool.block_tokens if self.pool.pages_per_stream
            else ecfg.block_tokens)
        self._build_groups()
        self.sched.register_relayout(self._relayout)

    # ------------------------------------------------------------------
    def _domains_of(self, gid: int, lay: Layout) -> List[int]:
        """Chiplet-group pool domains a replica group spans (Algorithm 2's
        contiguous-group affinity)."""
        rpp = lay.replicas_per_pod
        pod, local = divmod(gid, rpp)
        s = lay.spread_rate
        base = pod * self.topology.groups_per_pod + local * s
        return list(range(base, base + s))

    def _build_groups(self):
        lay = self.sched.layout()
        rpp = lay.replicas_per_pod
        pods = [g // rpp for g in range(lay.replicas)]
        hoods = ([(p, (g % rpp) // 2) for g, p in enumerate(pods)]
                 if rpp > 1 else None)
        self.queues = TieredQueues(pods, neighborhoods=hoods,
                                   counters=self.counters,
                                   bytes_fn=Request.kv_bytes)
        self.groups = [_Group(g, pods[g], self.ecfg, self.queues.queue(g),
                              self._domains_of(g, lay))
                       for g in range(lay.replicas)]

    def _owner_group(self, domain: int) -> _Group:
        for g in self.groups:
            if domain in g.domains:
                return g
        raise KeyError(domain)

    def _domain_order(self, g: _Group) -> List[int]:
        """A group's domains, most-capacity first."""
        return sorted(g.domains,
                      key=lambda d: (-self.pool.free_blocks(d),
                                     -self.pool.free_states(d), d))

    def _candidates(self, keys: Optional[List[bytes]], prompt_len: int):
        """(group, domain) pairs, least-pressured group first; with the
        prompt's page hash chain ``keys``, longest resident prefix match
        first (stable: pressure order inside ties).  Returns the pairs and
        each domain's match."""
        cands = [(g, d)
                 for g in sorted(self.groups,
                                 key=lambda gr: (gr.kv_pressure(),
                                                 len(gr.queue), gr.gid))
                 for d in self._domain_order(g)]
        matches: Dict[int, Tuple[List[int], int]] = {}
        if keys:
            matches = {d: self.pool.match_prefix(d, keys,
                                                 prompt_len=prompt_len)
                       for _, d in cands}
            cands.sort(key=lambda gd: -len(matches[gd[1]][0]))
        return cands, matches

    def _try_admit(self, total_tokens: int, first_tokens: int,
                   keys: Optional[List[bytes]] = None, prompt_len: int = 0
                   ) -> Tuple[Optional[_Group], Optional[KVTable]]:
        """Sweep every candidate domain; one logical alloc failure only
        when the whole pool is dry.  A domain already holding the prompt's
        pages admits onto shared refcounted pages and charges only the
        unshared tail."""
        cands, matches = self._candidates(keys, prompt_len)
        for g, d in cands:
            shared, ckpt = matches.get(d, ((), 0))
            first = first_tokens
            if shared:
                # the skip moves the first chunk past the shared pages
                skip = len(shared) * self.pool.block_tokens
                first = skip + min(self._chunk, max(1, prompt_len - skip))
            table = self.pool.reserve(d, total_tokens,
                                      first_tokens=first,
                                      headroom=self.ecfg.headroom,
                                      count_failure=False,
                                      prefix_blocks=shared,
                                      prefix_state=ckpt)
            if table is not None:
                return g, table
        self.counters.add("kv_alloc_failures", 1)
        return None, None

    def _migrate_into(self, table: KVTable, g: _Group) -> bool:
        """Move a reservation into any of the group's domains."""
        if table.domain in g.domains:
            return True
        return any(self.pool.migrate(table, d) for d in self._domain_order(g))

    # -- size-aware bypass: grant past a blocked head, provably free --------
    def _head_rec(self) -> Optional[_Parked]:
        """The line head's park record — None when the head is an
        admission task (bypass only ever jumps a PARKED head)."""
        head = self.waiters.oldest()
        if head is None:
            return None
        for rec in self._parked.values():
            if rec.cell.get("task") is head:
                return rec
        return None

    def _head_need_in(self, rec: _Parked, d: int) -> Tuple[int, bool]:
        """``(pages, needs_state)``: the blocked head's provable need from
        domain ``d``.  A spilled head restores anywhere; a parked grower
        owes its own domain the next-chunk pages, its group's other
        domains a whole-table migrate, and other domains nothing."""
        t = rec.req.table
        if t.spill is not None:
            n, _ = self._next_chunk_need(rec.req, rec.pos)
            grow = max(0, self.pool.pages_needed(rec.pos + n)
                       - t.spill.pages)
            return t.spill.pages + grow, t.spill.had_state
        n, need = self._next_chunk_need(rec.req, rec.pos)
        need = max(need, 0)
        if d == t.domain:
            return need, False
        g = self._owner_group(t.domain)
        if d in g.domains:
            return len(t.blocks) + need, False
        return 0, False

    def _aging_clear(self, task) -> bool:
        """True when no waiter AHEAD of ``task`` has been blocked longer
        than ``slo_aging_rounds`` (the bypass fairness backstop)."""
        limit = self.ecfg.slo_aging_rounds
        my = self.waiters.seq_of(task)
        if my is None:
            return False
        for t in self.waiters.tasks():
            if self.waiters.seq_of(t) >= my:
                return True
            if self._round - self._wait_round.get(t.id, self._round) > limit:
                return False
        return True

    def _try_bypass(self, req: Request, total_tokens: int
                    ) -> Tuple[Optional[_Group], Optional[KVTable]]:
        """A size-aware bypass grant for a non-head waiter: an EAGER
        reservation (it never grows) in a domain where the grant leaves
        the head's whole need free."""
        rec = self._head_rec()
        if rec is None or rec.req.table is None:
            return None, None
        cands, matches = self._candidates(req.page_keys, len(req.prompt))
        for g, d in cands:
            hn, head_state = self._head_need_in(rec, d)
            if (head_state and self.pool.has_state
                    and self.pool.free_states(d) < 2):
                continue                # the head's restore slot is not ours
            shared, ckpt = matches.get(d, ((), 0))
            table = self.pool.reserve(d, total_tokens,
                                      first_tokens=None,  # eager: no growth
                                      headroom=self.ecfg.headroom,
                                      min_free=hn,
                                      count_failure=False,
                                      prefix_blocks=shared,
                                      prefix_state=ckpt)
            if table is not None:
                self.counters.add("kv_bypass_floor_pages", hn)
                self.bypass_log.append((self._round, req.rid, rec.req.rid))
                return g, table
        return None, None

    # -- submission ---------------------------------------------------------
    def submit(self, prompt: np.ndarray, max_new: int,
               cls: str = "batch") -> Request:
        if cls not in self.ecfg.slo_classes:
            raise ValueError(
                f"unknown SLO class {cls!r}: configured classes are "
                f"{sorted(self.ecfg.slo_classes)}")
        req = Request(next(self._rid), np.asarray(prompt, np.int32), max_new,
                      arrived=self._clock(), cls=cls,
                      arrive_round=self._round)
        req._kv_fn = self._kv_fn
        self._inflight += 1
        self.submitted.append(req)
        self.counters.add(f"kv_class_submits/{cls}", 1)
        self._spawn_admission(req, name=f"admit{req.rid}")
        return req

    def _spawn_admission(self, req: Request, name: str):
        cell: Dict[str, Any] = {"req": req}
        cell["task"] = self.sched.spawn(self._admission_task(req, cell),
                                        name=name, priority=1)
        # join the FIFO wait line NOW: grant order is submission order,
        # not coroutine execution order
        req.wq_seq = self._join_line(cell["task"])
        if self._bypass_wake and self.ecfg.slo_classes[req.cls].bypass:
            self._bypass_cells[cell["task"].id] = cell

    # -- wait-line bookkeeping ----------------------------------------------
    def _join_line(self, task, seq: Optional[int] = None) -> int:
        s = self.waiters.park(task, seq=seq)
        self._wait_round.setdefault(task.id, self._round)
        return s

    def _leave_line(self, task):
        """Grant-time cleanup + wake cascade."""
        self.waiters.remove(task)
        self._wait_round.pop(task.id, None)
        self._bypass_cells.pop(task.id, None)
        self.waiters.wake(1)            # maybe the next waiter fits too
        self._wake_bypassers()

    def _on_pool_free(self):
        self.waiters.wake(1)
        self._wake_bypassers()

    def _wake_bypassers(self):
        for cell in self._bypass_cells.values():
            self.runtime.unblock(cell["task"])

    def _admission_task(self, req: Request, cell: Dict[str, Any]):
        """Per-request coroutine: reserve the first chunk's pages when at
        the head of the wait line (or by a size-aware bypass), park on
        pool exhaustion until a free wakes us."""
        total = len(req.prompt) + req.max_new
        first = min(self._chunk, max(1, len(req.prompt)))
        if self._share and req.page_keys is None:
            req.page_keys = self.pool.prefix_keys(req.prompt)
        while True:
            if self.waiters.oldest() is cell["task"]:
                g, table = self._try_admit(total, first, req.page_keys,
                                           len(req.prompt))
                if table is not None:
                    break
            elif (self._bypass_on
                    and cell["task"].id in self._bypass_cells
                    and self._aging_clear(cell["task"])):
                g, table = self._try_bypass(req, total)
                if table is not None:
                    req.bypassed = True
                    self.counters.add("kv_bypass_grants", 1)
                    self.counters.add(f"kv_class_bypass/{req.cls}", 1)
                    break
            yield BLOCK                 # woken by a free or a grant
        self._leave_line(cell["task"])
        req.grant_rounds.append(self._round)
        self.counters.add(f"kv_class_admits/{req.cls}", 1)
        req.table = table
        # shared prefix pages are already filled: prefill resumes at the
        # first unmatched chunk boundary
        req.prefix_tokens = table.used_pages * self.pool.block_tokens
        req.group = g.gid
        self.queues.push(g.gid, req)

    def open_loop_client(self, schedule: Iterable[Tuple[int, np.ndarray, int]]
                         ) -> Any:
        """Spawn an open-loop client on the shared TaskRuntime: for each
        ``(gap_rounds, prompt, max_new[, cls])`` it sleeps ``gap_rounds``
        engine rounds, then submits."""
        self._clients += 1

        def client():
            try:
                for item in schedule:
                    gap, prompt, max_new = item[0], item[1], item[2]
                    cls = item[3] if len(item) > 3 else "batch"
                    for _ in range(int(gap)):
                        yield
                    self.submit(prompt, max_new, cls=cls)
            finally:
                self._clients -= 1

        return self.sched.spawn(client(), name="client", priority=2)

    # -- live relayout: merge/split replica groups mid-run -------------------
    def _relayout(self, new_layout: Layout, decision: Decision):
        old_groups = self.groups
        if new_layout.replicas == len(old_groups):
            return
        # harvest in-flight streams and queued requests from the dissolving
        # groups; KV stays in the pool (tables move, data does not — except
        # the used pages of rebalanced streams).  Parked streams need no
        # harvesting: their regrow task re-resolves the owner group.
        inflight: List[_InFlight] = []
        queued: List[Request] = []
        mig0 = self.counters.totals.get("kv_blocks_migrated", 0.0)
        for g in old_groups:
            g.retired = True
            for slot, req in enumerate(g.slots):
                if req is None:
                    continue
                inflight.append(_InFlight(req, int(g.pos_h[slot]),
                                          int(g.tok_h[slot])))
                g.slots[slot] = None
                self.counters.add("kv_slots_migrated", 1)
                self.counters.add("migration_bytes", req.kv_bytes())
            inflight.extend(g.resume)
            g.resume = []
            while g.queue:
                queued.append(g.queue.popleft())
        self._build_groups()
        n = len(self.groups)
        # tables follow their domain's new owner; only streams rebalanced
        # off the owner copy their used pages cross-domain
        cap = max(1, math.ceil(len(inflight) / n))
        load = {g.gid: 0 for g in self.groups}
        for fl in inflight:
            tgt = self._owner_group(fl.req.table.domain)
            if load[tgt.gid] >= cap:
                alt = min(self.groups, key=lambda gr: (load[gr.gid], gr.gid))
                if alt is not tgt and self._migrate_into(fl.req.table, alt):
                    tgt = alt
            fl.req.group = tgt.gid
            fl.req.migrations += 1
            load[tgt.gid] += 1
            tgt.resume.append(fl)
        for req in queued:
            tgt = self._owner_group(req.table.domain)
            req.group = tgt.gid
            self.queues.push(tgt.gid, req)
        self.relayouts.append({
            "step": decision.step, "old_groups": len(old_groups),
            "new_groups": n, "moved_slots": len(inflight),
            "requeued": len(queued), "reason": decision.reason,
            "blocks_migrated": self.counters.totals.get(
                "kv_blocks_migrated", 0.0) - mig0})
        if self._running:
            for g in self.groups:
                self._spawn_group(g)

    # -- paged steps: gather -> model step -> scatter ------------------------
    def _tensor(self, a) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(a)).to(self.device)

    def _indices(self, reqs: List[Optional[Request]]
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Null-padded (B, P) page tables and (B,) state slots on the
        device.  Partially-grown tables pad their unallocated tail with
        the null block — those ring positions are past ``pos`` and never
        read."""
        P = self.pool.pages_per_stream
        tables = np.zeros((len(reqs), P), np.int32)
        slots = np.zeros((len(reqs),), np.int32)
        for i, req in enumerate(reqs):
            if req is not None and req.table is not None:
                t = req.table
                tables[i, :len(t.blocks)] = t.blocks
                slots[i] = t.state_slot
        return self._tensor(tables), self._tensor(slots)

    def _paged_decode(self, reqs, tokens, pos) -> np.ndarray:
        """Single-token step over ``reqs``' pages (None rows point at the
        null page); returns the greedy token per row."""
        spec = self.pool.spec
        tables, slots = self._indices(reqs)
        view = dec.gather_cache_view(self.pool.storage, spec, tables, slots)
        logits, view = self._decode_step(self.params, view,
                                         self._tensor(tokens),
                                         self._tensor(pos))
        dec.scatter_cache_view(self.pool.storage, spec, tables, slots, view)
        n = (np.asarray([r is not None for r in reqs], np.int32))
        return dec.next_token_ids(logits, self._tensor(n)).cpu().numpy()

    def _paged_chunk(self, reqs, tokens, pos, n_tokens) -> np.ndarray:
        """Fused multi-token chunk step over ``reqs``' pages; returns the
        greedy token per row (-1 for rows with ``n_tokens == 0``)."""
        spec = self.pool.spec
        tables, slots = self._indices(reqs)
        view = dec.gather_cache_view(self.pool.storage, spec, tables, slots)
        n = self._tensor(n_tokens)
        logits, view = self._chunk_step(self.params, view,
                                        self._tensor(tokens),
                                        self._tensor(pos), n)
        dec.scatter_cache_view(self.pool.storage, spec, tables, slots, view)
        return dec.next_token_ids(logits, n).cpu().numpy()

    # -- elastic growth / mid-decode parking ---------------------------------
    def _next_chunk_need(self, req: Request, pos: int) -> Tuple[int, int]:
        """(tokens the stream consumes next tick, pages its table is short
        by) — shared by the tick's growth phase and a parked stream's
        regrow retry."""
        S = len(req.prompt)
        n = min(self._chunk, S - pos) if pos < S else 1
        need = self.pool.pages_needed(pos + n) - len(req.table.blocks)
        return n, need

    def _grow_stream(self, req: Request, g: _Group, need: int,
                     forks: Tuple[int, ...] = ()) -> bool:
        """Commit ``need`` more pages for a stream — and privatize (CoW)
        any shared pages its next write touches — in its own domain first,
        then any domain its replica group owns (a migration copies every
        page, so the moved table is private and pending forks dissolve)."""
        t = req.table
        if (all(self.pool.cow_fork(t, p) for p in forks)
                and self.pool.grow(t, need)):
            return True
        for d in self._domain_order(g):
            if d == t.domain:
                continue
            if self.pool.free_blocks(d) < len(t.blocks) + need:
                continue
            if self.pool.migrate(t, d) and self.pool.grow(t, need):
                return True
        return False

    def _park_stream(self, g: _Group, slot: int):
        """Suspend a stream MID-DECODE: it keeps its pages, releases its
        slot, joins the FIFO wait line (a bypassed stream at its arrival
        seq) and resumes via the pool free callback."""
        req = g.slots[slot]
        g.slots[slot] = None
        rec = _Parked(req, int(g.pos_h[slot]), int(g.tok_h[slot]),
                      next(self._park_seq))
        self._parked[req.rid] = rec
        self.counters.add("kv_mid_decode_parks", 1)
        rec.cell["task"] = self.sched.spawn(
            self._regrow_task(rec), name=f"regrow{req.rid}", priority=1)
        req.wq_seq = self._join_line(
            rec.cell["task"], seq=req.wq_seq if req.bypassed else None)

    def _regrow_task(self, rec: _Parked):
        """Waiter coroutine of a parked stream: at the head of the line,
        retry growth — or, if the watchdog spilled it, restore it — then
        hand the stream back to the owner group of its domain."""
        req = rec.req
        while True:
            if rec.evicted:
                return
            if self.waiters.oldest() is not rec.cell["task"]:
                yield BLOCK             # not our turn
                continue
            if req.table.spill is not None:
                g = self._restore_stream(rec)
                if g is not None:
                    break
            else:
                g = self._owner_group(req.table.domain)
                n, need = self._next_chunk_need(req, rec.pos)
                forks = (self.pool.fork_pages(req.table, rec.pos, n)
                         if self._share else [])
                if self._grow_stream(req, g, max(need, 0), tuple(forks)):
                    break
            yield BLOCK                 # woken by KVBlockPool.free
        self._leave_line(rec.cell["task"])
        req.grant_rounds.append(self._round)
        self._parked.pop(req.rid, None)
        req.group = g.gid
        g.resume.append(_InFlight(req, rec.pos, rec.token))

    def _restore_stream(self, rec: _Parked) -> Optional[_Group]:
        """Re-grant a SPILLED stream in ONE atomic ``restore_into`` leg
        (its pages + next-chunk growth + state slot), own domain first;
        None when no domain can take it yet."""
        t = rec.req.table
        n, _ = self._next_chunk_need(rec.req, rec.pos)
        grow_by = max(0, self.pool.pages_needed(rec.pos + n) - t.spill.pages)
        order = [t.domain] + [
            d for g in sorted(self.groups,
                              key=lambda gr: (gr.kv_pressure(), gr.gid))
            for d in self._domain_order(g) if d != t.domain]
        for d in order:
            if self.pool.restore_into(t, d, grow_by=grow_by):
                return self._owner_group(t.domain)
        return None

    # -- allocation-stall watchdog (the incremental-allocation deadlock) -----
    def _progress_signature(self) -> float:
        t = self.counters.totals
        return (t.get("tokens_processed", 0.0)
                + t.get("kv_reservations", 0.0)
                + t.get("kv_lazy_grows", 0.0)
                + t.get("kv_blocks_freed", 0.0)
                + t.get("kv_spill_issues", 0.0))

    def _stall_hook(self):
        """Called by the scheduler after every round: the proactive
        watermark rung, then — if nothing progressed for
        ``stall_evict_rounds`` rounds while streams sit parked — the
        watchdog spills (or evicts) the most-recently-parked stream."""
        self._round += 1
        if len(self.waiters):
            self.counters.add("kv_head_wait_ticks", 1)
        head = self.waiters.oldest()
        hid = head.id if head is not None else None
        if hid != self._head_id:
            self._head_id, self._head_wait = hid, 0
        elif hid is not None:
            self._head_wait += 1
        if self._parked:
            for d in self.pool.watermark_domains():
                if self._spill_parked(domain=d):
                    self.pool.watermark_arm(d)
                    self.counters.add("kv_proactive_spills", 1)
        sig = self._progress_signature()
        if sig != self._progress_mark:
            self._progress_mark = sig
            self._stall_rounds = 0
        else:
            self._stall_rounds += 1
        stalled = self._stall_rounds >= self.ecfg.stall_evict_rounds
        # once any bypass grant exists, the head's own wait drives the
        # watchdog too: the head is never unblocked later than without
        # bypass
        head_stalled = (not stalled
                        and self.counters.totals.get("kv_bypass_grants",
                                                     0.0) > 0
                        and self._head_wait >= self.ecfg.stall_evict_rounds)
        if stalled and self._parked:
            if self.ecfg.evict_mode == "swap" and self._spill_youngest():
                self.counters.add("kv_watchdog_spills", 1)
            else:
                self._evict_youngest()
            self._stall_rounds = 0
            self._head_wait = 0
        elif head_stalled and self._parked:
            # free pages the head can USE: a parked grower regrows only in
            # its own domain; never spill the head itself
            hr = self._head_rec()
            dom = None
            if hr is not None and hr.req.table is not None \
                    and hr.req.table.spill is None:
                dom = hr.req.table.domain
            ex = hr.req.rid if hr is not None else None
            if self.ecfg.evict_mode == "swap" and (
                    self._spill_parked(domain=dom, exclude_rid=ex)
                    or (dom is not None
                        and self._spill_parked(domain=None, exclude_rid=ex))):
                self.counters.add("kv_watchdog_spills", 1)
            self._head_wait = 0

    def _spill_youngest(self) -> bool:
        """Swap-tier deadlock breaker: spill the most-recently-parked
        stream's used pages to the host tier; False when every parked
        stream is already host-resident."""
        return self._spill_parked(domain=None)

    def _spill_parked(self, domain: Optional[int],
                      exclude_rid: Optional[int] = None) -> bool:
        """Spill the most-recently-parked spillable stream — pool-wide, or
        restricted to ``domain`` — after demoting it to the back of the
        wait line (it had its turn).  False when nothing in scope is left
        to spill."""
        cands = [r for r in self._parked.values()
                 if r.req.table is not None and r.req.table.spill is None
                 and r.req.table.blocks
                 and r.req.rid != exclude_rid
                 and (domain is None or r.req.table.domain == domain)]
        if not cands:
            return False
        rec = max(cands, key=lambda r: r.seq)
        task = rec.cell.get("task")
        if task is not None:
            # demote BEFORE spilling: the spill's free callback wakes the
            # line head, which must be the next waiter — not the victim
            ns = self.waiters.to_back(task)
            if ns is not None:
                rec.req.wq_seq = ns
                self._wait_round[task.id] = self._round
        self.pool.spill(rec.req.table)  # frees pages -> wakes the head
        rec.seq = next(self._park_seq)  # its park is "fresh" again
        return True

    def _evict_youngest(self):
        """Restart-eviction deadlock breaker: free the most-recently-parked
        stream's pages and restart it from scratch (greedy decoding
        regenerates the identical tokens at ``recompute_tokens`` cost)."""
        rec = max(self._parked.values(), key=lambda r: r.seq)
        rec.evicted = True
        self._parked.pop(rec.req.rid, None)
        task = rec.cell.get("task")
        if task is not None:
            self.waiters.remove(task)
            self._wait_round.pop(task.id, None)
            self.runtime.unblock(task)  # let the generator observe .evicted
        req = rec.req
        self.pool.free(req.table)       # wakes the longest-parked waiter
        req.table = None
        req.generated = []
        req.t_first = None
        req.bypassed = False            # the restart is a fresh admission
        self.counters.add("kv_evictions", 1)
        self.counters.add("recompute_tokens", rec.pos)
        self._spawn_admission(req, name=f"readmit{req.rid}")

    # -- one engine tick: admit + mixed chunk/decode token step ---------------
    def _install(self, g: _Group, slot: int, fl: _InFlight):
        """Re-slot a migrated stream: pure bookkeeping, the KV never left
        the pool."""
        g.slots[slot] = fl.req
        g.pos_h[slot] = fl.pos
        g.tok_h[slot] = fl.token
        self.counters.add("kv_slots_restored", 1)

    def _accept_steal(self, g: _Group):
        """TieredQueues accept hook: a stolen request's reservation moves
        into the thief's memory domain (memory follows work)."""
        def accept(req: Request, _tier: str) -> bool:
            if req.table is None:
                return True
            return self._migrate_into(req.table, g)
        return accept

    def _admit(self, g: _Group):
        for slot in g.free_slots():
            if g.resume:                       # migrated streams first
                self._install(g, slot, g.resume.pop(0))
                continue
            req, tier = self.queues.pop(g.gid, accept=self._accept_steal(g))
            if req is None:
                break
            if tier != "local":
                req.group = g.gid
            # the token loop prefills this stream chunk by chunk from the
            # first unmatched prompt position
            g.slots[slot] = req
            g.pos_h[slot] = req.prefix_tokens
            g.tok_h[slot] = 0

    def _split_tick(self, g: _Group, n_h, toks, C: int,
                    deco_rows: List[int]) -> np.ndarray:
        """A mixed tick as TWO steps over compacted batches padded to a
        power-of-two bucket: the fused chunk forward over the prefill
        streams, the single-token step over the decode streams.  Padding
        rows point at the null page and state slot.  The two steps touch
        disjoint real pages, so running them back to back is exact."""
        B = self.ecfg.max_batch
        chunk_rows = [i for i in range(B) if n_h[i] > 1]
        Bc = _bucket(len(chunk_rows), B)
        toks_c = np.zeros((Bc, C), np.int32)
        pos_c = np.zeros((Bc,), np.int32)
        n_c = np.zeros((Bc,), np.int32)
        for j, i in enumerate(chunk_rows):
            toks_c[j] = toks[i]
            pos_c[j] = g.pos_h[i]
            n_c[j] = n_h[i]
        reqs_c = [g.slots[i] for i in chunk_rows] \
            + [None] * (Bc - len(chunk_rows))
        nxt_c = self._paged_chunk(reqs_c, toks_c, pos_c, n_c)
        Bd = _bucket(len(deco_rows), B)
        toks_d = np.zeros((Bd, 1), np.int32)
        pos_d = np.zeros((Bd,), np.int32)
        for j, i in enumerate(deco_rows):
            toks_d[j, 0] = toks[i, 0]
            pos_d[j] = g.pos_h[i]
        reqs_d = [g.slots[i] for i in deco_rows] \
            + [None] * (Bd - len(deco_rows))
        nxt_d = self._paged_decode(reqs_d, toks_d, pos_d)
        nxt = np.full((B,), -1, np.int32)   # idle rows keep the sentinel
        for j, i in enumerate(deco_rows):
            nxt[i] = nxt_d[j]
        for j, i in enumerate(chunk_rows):
            nxt[i] = nxt_c[j]
        self.counters.add("split_ticks", 1)
        self.counters.add("mixed_tick_decode_rows_saved",
                          (C - 1) * len(deco_rows))
        self.counters.add("decode_gather_rows_saved", B - Bd)
        self.counters.add("decode_gather_null_rows", Bd - len(deco_rows))
        return nxt

    def _decode_tick(self, g: _Group):
        """ONE engine tick for the group: every occupied slot consumes its
        next tokens — a page-sized prompt chunk for streams still in
        prefill, the last generated token for decode streams.  Tables grow
        (or park their stream) before the step writes any bytes."""
        B = self.ecfg.max_batch
        n_h = np.zeros((B,), np.int32)
        chunked = False
        for i in range(B):
            req = g.slots[i]
            if req is None:
                continue
            pos = int(g.pos_h[i])
            n, need = self._next_chunk_need(req, pos)
            forks = (self.pool.fork_pages(req.table, pos, n)
                     if self._share else [])
            grown = not (self.pool.pages_per_stream and (need > 0 or forks)) \
                or self._grow_stream(req, g, max(need, 0), tuple(forks))
            if not grown:
                self._park_stream(g, i)
                continue
            if self._share:
                # writing into a published page forks the page's index
                # entry off it (the OLD block keeps its entry)
                self.pool.note_writes(req.table, pos, n)
            n_h[i] = n
            chunked = chunked or n > 1
        if not n_h.any():
            return
        # per-stream token feed: the next prompt slice for streams still in
        # prefill (a final chunk may hold a single token), the last emitted
        # token for decode streams
        C = self._chunk if chunked else 1
        toks = np.zeros((B, C), np.int32)
        for i in range(B):
            req = g.slots[i]
            if req is None or not n_h[i]:
                continue
            pos = int(g.pos_h[i])
            if pos < len(req.prompt):
                toks[i, :n_h[i]] = req.prompt[pos:pos + n_h[i]]
            else:
                toks[i, 0] = g.tok_h[i]
        deco_rows = [i for i in range(B) if n_h[i] == 1]
        if chunked:
            self.counters.add("chunk_ticks", 1)
            self.counters.add("prefill_model_steps", 1)
            if self.ecfg.split_ticks and deco_rows:
                nxt = self._split_tick(g, n_h, toks, C, deco_rows)
            else:
                if deco_rows:
                    # single-token streams ride the C-wide step: C-1 of
                    # their query rows are masked waste
                    self.counters.add("decode_masked_query_rows",
                                      (C - 1) * len(deco_rows))
                nxt = self._paged_chunk(list(g.slots), toks, g.pos_h, n_h)
        else:
            nxt = self._paged_decode(
                [g.slots[i] if n_h[i] else None for i in range(B)],
                toks[:, :1], g.pos_h)
        if deco_rows:
            self.counters.add("decode_row_forwards", sum(
                1 for i in deco_rows
                if int(g.pos_h[i]) >= len(g.slots[i].prompt)))
            if not chunked or self.ecfg.split_ticks:
                self.counters.add("decode_forwards", 1)
        now = self._clock()
        for i in range(B):
            req = g.slots[i]
            if req is None or not n_h[i]:
                continue
            S = len(req.prompt)
            pos0 = int(g.pos_h[i])
            new_pos = pos0 + int(n_h[i])
            g.pos_h[i] = new_pos
            self.counters.add("tokens_processed", int(n_h[i]))
            if pos0 >= S:
                self.counters.add("decode_committed_tokens", 1)
            if pos0 < S:
                self.counters.add("prefill_chunks", 1)
                req.table.used_pages = min(len(req.table.blocks),
                                           self.pool.pages_needed(new_pos))
                if self._share and req.page_keys:
                    # publish the prompt pages this chunk completed
                    self.pool.register_prefix(req.table, req.page_keys,
                                              pos0, new_pos, S)
                if new_pos < S:
                    continue            # mid-prompt: no token emitted yet
                req.t_first = now
                self.counters.add("prefills", 1)
            tok = int(nxt[i])
            assert tok >= 0, f"idle slot {i} emitted a token"
            req.generated.append(tok)
            g.tok_h[i] = tok
            req.table.used_pages = min(len(req.table.blocks),
                                       self.pool.pages_needed(new_pos))
            if len(req.generated) >= req.max_new:
                req.t_done = now
                g.slots[i] = None
                self._inflight -= 1
                self.pool.free(req.table)  # wakes parked streams
        self.counters.add("decode_steps", 1)
        self.counters.add("decode_tokens",
                          sum(1 for s in g.slots if s is not None))

    # -- engine task (coroutine per group, scheduled by the task runtime) ----
    def _group_task(self, g: _Group):
        while not g.retired:
            outstanding = self._inflight > 0 or self._clients > 0
            if not g.busy() and not outstanding:
                return
            self._admit(g)
            self._decode_tick(g)
            yield   # yield point: profiler + Algorithm 1 + possible relayout

    def _spawn_group(self, g: _Group):
        self.sched.spawn(self._group_task(g), group=g.gid,
                         name=f"group{g.gid}")

    def _round_metrics(self) -> Callable[[], Dict[str, float]]:
        """Per-round profiler feed: KV-pool gauges + deltas since the
        previous round."""
        names = ("kv_alloc_failures", "kv_blocks_migrated", "kv_lazy_grows",
                 "kv_mid_decode_parks", "prefill_chunks",
                 "kv_spilled_pages", "kv_restores", "recompute_tokens",
                 "mixed_tick_decode_rows_saved",
                 "kv_prefix_hits", "prefill_tokens_skipped",
                 "kv_bypass_grants", "kv_head_wait_ticks")
        state = {"t": self._clock()}
        state.update({n: self.counters.totals.get(n, 0.0) for n in names})

        def metrics() -> Dict[str, float]:
            t1 = self._clock()
            cur = {n: self.counters.totals.get(n, 0.0) for n in names}
            out = {"step_time": t1 - state["t"],
                   "kv_occupancy": self.pool.occupancy(),
                   "kv_parks": cur["kv_alloc_failures"]
                   - state["kv_alloc_failures"],
                   "kv_shared_pages": float(self.pool.shared_pages()),
                   "kv_shared_bytes": self.pool.shared_bytes()}
            for n in names[1:]:
                out[n] = cur[n] - state[n]
            state.update(t=t1, **cur)
            return out

        return metrics

    def run_until_done(self, *, max_rounds: int = 100000) -> Dict:
        trace: List[int] = []
        self._running = True
        try:
            for g in self.groups:
                self._spawn_group(g)
            self.sched.run_until_done(max_rounds=max_rounds,
                                      concurrency_trace=trace,
                                      metrics_fn=self._round_metrics(),
                                      round_hook=self._stall_hook)
        finally:
            self._running = False
        return {"concurrency": trace, "counters": self.counters.snapshot(),
                "relayouts": list(self.relayouts),
                "decisions": [dataclasses.asdict(x)
                              for x in self.controller.decisions],
                "kv": self.kv_stats()}

    def measured_model_steps(self, *args, **kwargs) -> float:
        raise NotImplementedError("measured_model_steps reads compiled HLO; "
                                  "its port is ROADMAP A6")

    def warm_steps(self, *args, **kwargs) -> int:
        raise NotImplementedError("warm_steps pre-pays jit compiles; its "
                                  "port is ROADMAP A6")

    # -- latency / pool stats --------------------------------------------------
    def kv_stats(self) -> Dict[str, float]:
        """KV-pool health: occupancy, parks, growth, spills, prefix
        sharing, bypass, per-class latency."""
        s = self.pool.stats()
        s["prefill_chunk_bytes"] = prefill_chunk_bytes(
            self.cfg, self._chunk, self.ecfg.max_len, mode="parallel",
            kernel=self._chunk_kernel)
        s["prefill_score_bytes"] = prefill_chunk_score_bytes(
            self.cfg, self._chunk, self.ecfg.max_len,
            kernel=self._chunk_kernel)
        s["chunk_kernel"] = self._chunk_kernel
        tot = self.counters.totals
        for k in ("mixed_tick_decode_rows_saved", "decode_gather_rows_saved",
                  "decode_masked_query_rows", "prefill_model_steps",
                  "chunk_ticks", "decode_forwards", "decode_row_forwards",
                  "decode_committed_tokens"):
            s[k] = tot.get(k, 0.0)
        s["evictions"] = tot.get("kv_evictions", 0.0)
        s["recompute_tokens"] = tot.get("recompute_tokens", 0.0)
        s["blocks_per_relayout"] = [r.get("blocks_migrated", 0.0)
                                    for r in self.relayouts]
        s["bypass_grants"] = tot.get("kv_bypass_grants", 0.0)
        s["bypass_floor_pages"] = tot.get("kv_bypass_floor_pages", 0.0)
        s["bypass_floor_bytes"] = kv_bypass_floor_bytes(
            self.cfg, int(s["bypass_floor_pages"]), self.pool.block_tokens)
        s["head_wait_ticks"] = tot.get("kv_head_wait_ticks", 0.0)
        s["proactive_spills"] = tot.get("kv_proactive_spills", 0.0)
        s["watchdog_spills"] = tot.get("kv_watchdog_spills", 0.0)
        s["d2h_seconds"] = kv_transfer_seconds(
            tot.get("kv_d2h_bytes", 0.0), self.topology.hw.d2h_bw)
        s["h2d_seconds"] = kv_transfer_seconds(
            tot.get("kv_h2d_bytes", 0.0), self.topology.hw.h2d_bw)
        s["class_submits"] = {c: tot.get(f"kv_class_submits/{c}", 0.0)
                              for c in self.ecfg.slo_classes}
        s["class_admits"] = {c: tot.get(f"kv_class_admits/{c}", 0.0)
                             for c in self.ecfg.slo_classes}
        s["class_bypass_grants"] = {c: tot.get(f"kv_class_bypass/{c}", 0.0)
                                    for c in self.ecfg.slo_classes}
        s["per_class"] = self.class_stats(self.submitted,
                                          self.ecfg.slo_classes)
        return s

    @staticmethod
    def class_stats(reqs: List[Request],
                    slo_classes: Optional[Dict[str, ClassSLO]] = None
                    ) -> Dict[str, Dict[str, float]]:
        """Per-SLO-class latency stats over the samples :meth:`stats`
        reports, annotated with each class's targets."""
        classes = sorted({r.cls for r in reqs} | set(slo_classes or ()))
        out: Dict[str, Dict[str, float]] = {}
        for c in classes:
            sub = ServeEngine.stats([r for r in reqs if r.cls == c])
            if not sub:
                sub = {"n": 0}
            if slo_classes and c in slo_classes:
                slo = slo_classes[c]
                sub["ttft_target"] = slo.ttft_target
                sub["tpot_target"] = slo.tpot_target
                if sub["n"]:
                    sub["ttft_slo_met"] = bool(
                        sub["ttft_p99"] <= slo.ttft_target)
                    sub["tpot_slo_met"] = bool(
                        sub["tpot_p99"] <= slo.tpot_target)
            out[c] = sub
        return out

    @staticmethod
    def stats(reqs: List[Request]) -> Dict[str, float]:
        done = [r for r in reqs if r.done]
        if not done:
            return {}
        ttft = np.array([r.t_first - r.arrived for r in done])
        total = np.array([r.t_done - r.arrived for r in done])
        tpot = np.array([(r.t_done - r.t_first)
                         / max(1, len(r.generated) - 1) for r in done])
        return {
            "n": len(done),
            "ttft_mean": float(ttft.mean()),
            "ttft_p50": float(np.percentile(ttft, 50)),
            "ttft_p99": float(np.percentile(ttft, 99)),
            "tpot_p50": float(np.percentile(tpot, 50)),
            "tpot_p99": float(np.percentile(tpot, 99)),
            "latency_mean": float(total.mean()),
            "latency_p95": float(np.percentile(total, 95)),
            "tokens": sum(len(r.generated) for r in done),
        }
