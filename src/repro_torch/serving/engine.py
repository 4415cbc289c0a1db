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
    watermark spill rung, as in the JAX package;
  * SPECULATIVE decoding (``spec_decode="ngram"``): a decode stream's
    drafted tokens are verified in one all-position-logits chunk forward
    over the drafted rows, in their own batch bucket at width
    ``min(spec_k + 1, chunk)``; greedy acceptance keeps the longest
    matching prefix, and rejected suffixes roll back from device-resident
    checkpoints of the touched pages and state slots;
  * the ASYNCHRONOUS swap tier (``async_swap=True``): the pressure ladder
    issues a spill's device-to-host copy on a side stream and keeps
    ticking; a per-round poll lands it (an event query) and only then
    re-grants the victim's pages.

Steps run eagerly: where the JAX package jits a step and donates the pool
storage, the port writes the storage in place.  ``warm_steps`` is the
port's counterpart of the JAX package's compile warm-up: on the card it
captures each paged step — gather, model step, scatter, greedy token — as
a CUDA graph per (kind, width, batch bucket), and the steps replay a
graph when one was captured for their shape.  The dense, MoE, SSM and
hybrid families are served in every mode, and a VLM text-only on the lazy
paged path (its steps broadcast each token's position to the three M-RoPE
components), as the JAX engine serves them; the construction raises for a
VLM with ``lazy=False`` or ``paged=False`` (their whole-prompt prefill has
no vision extras) and for an encoder-decoder model (no serving path takes
source frames), where the JAX engine fails later.  An SSM model's streams
hold a state slot and no ring pages, so they take the pool's state-slot
paths and never share a prompt prefix (the JAX engine shares prefixes only
for models with ring pages).  A hybrid model's streams hold ring pages for
its local-attention layers and a state slot for its recurrent layers: a
prompt prefix is shared through the state checkpoints the pool snaps at
page boundaries, and a spill carries the state leaves with the pages.

The JAX package's other modes ride the same token loop:

  * ``prefill_mode="scan"`` runs chunk ticks (and speculative verifies) as
    the per-token reference, C single-token steps a chunk
    (``decode.chunk_decode_step``), bit-identical to single-token stepping;
    the fused path matches it to tolerance;
  * ``lazy=False`` keeps the EAGER allocator: admission reserves the full
    capped length and prefills the whole prompt in one forward
    (``decode.prefill``: the flash-attention, SSD-scan and RG-LRU-scan
    kernels on the card), whose cache is scattered into the pool; tables
    never grow, chunk ticks never happen, and the chunk path is the scan;
  * ``paged=False`` keeps the SLOT MONOLITH: each replica group owns a
    ``(max_batch, max_len)`` cache, requests route straight to the
    least-pressured group, a whole-prompt prefill is copied into a slot,
    and a relayout carries each stream's cache slice to its new group.
    There is no pool: ``kv_stats()`` is empty, ``warm_steps()`` does
    nothing and ``measured_model_steps`` refuses.
"""
from __future__ import annotations

import dataclasses
import gc
import itertools
import math
import time
from typing import Any, Callable, Dict, Iterable, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.controller import ControllerConfig, Decision
from repro_torch.core.costmodel import kv_bypass_floor_bytes, \
    kv_transfer_seconds, prefill_chunk_bytes, prefill_chunk_score_bytes, \
    spec_rejected_bytes, spec_rollback_bytes
from repro_torch.core.layout import Layout
from repro_torch.core.scheduler import GlobalScheduler, TieredQueues
from repro_torch.core.tasks import BLOCK, WaitQueue
from repro_torch.core.topology import ChipletTopology
from repro_torch.launch.steps import make_prefill, make_serve_chunk_step, \
    make_serve_step, make_spec_verify_step
from repro_torch.models import decode as dec
from repro_torch.models.params import init_params
from repro_torch.serving.kvpool import KVBlockPool, KVTable, kv_bytes_exact
from repro_torch.serving.spec import make_drafter


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
        """KV footprint moved when this request changes groups: exact,
        from the cost model, when the engine installed its calculator (the
        paged engines); 2 bytes a token otherwise, as in the JAX
        package."""
        tokens = len(self.prompt) + len(self.generated)
        if self._kv_fn is not None:
            return self._kv_fn(tokens)
        return float(tokens * 2)


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
    prefill_mode: str = "parallel"     # chunk-tick path: "parallel" is
                                       # the fused multi-token forward,
                                       # "scan" the per-token reference
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
    spec_decode: str = "off"           # speculative decoding: "ngram"
                                       # drafts up to spec_k tokens a
                                       # decode tick from the stream's own
                                       # committed tokens and verifies them
                                       # in ONE fused chunk forward (greedy
                                       # acceptance: token-identical to
                                       # "off" by construction)
    spec_k: int = 4                    # max draft tokens per tick
    spec_ngram: int = 3                # longest n-gram the prompt-lookup
                                       # drafter matches on
    cached_retention: str = "access"   # cached prefix-page reclaim order
    slo_classes: Dict[str, ClassSLO] = dataclasses.field(
        default_factory=lambda: dict(DEFAULT_SLO_CLASSES))
    slo_bypass: bool = True            # size-aware bypass of a parked head
    slo_aging_rounds: int = 200        # bypass fairness backstop
    spill_watermarks: Optional[Tuple[float, float]] = None
                                       # (high, low) occupancy marks for
                                       # proactive spill; None = watchdog only
    async_swap: bool = False           # overlap spills behind the token
                                       # loop: the pressure ladder ISSUES
                                       # the D2H copy and keeps ticking,
                                       # landing it (and re-granting the
                                       # victim's pages) at a later poll;
                                       # False = issue + immediate fence
    controller: ControllerConfig = dataclasses.field(
        default_factory=lambda: ControllerConfig(
            scheduler_timer=8, threshold=4.0, min_dwell=2))


@dataclasses.dataclass
class _InFlight:
    """A mid-generation stream harvested from a retired replica group (or
    a mid-decode park).  Paged: its KV stays in the pool, only the table
    pointer moves (``cache`` None).  Slot monolith: ``cache`` carries its
    slice of every cache leaf.  ``pos`` < len(prompt) means it was
    harvested mid-PREFILL."""
    req: Request
    cache: Optional[List[torch.Tensor]]
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
    process and the last emitted token.  ``cache`` is the group's own
    ``(max_batch, max_len)`` cache in the slot monolith, None when paged."""

    def __init__(self, gid: int, pod: int, ecfg: EngineConfig, queue,
                 domains: List[int], cache=None):
        self.gid = gid
        self.pod = pod
        self.queue = queue
        self.domains = domains          # chiplet-group pool domains owned
        self.resume: List[_InFlight] = []
        self.retired = False
        self.slots: List[Optional[Request]] = [None] * ecfg.max_batch
        self.cache = cache
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


class _StepGraph:
    """A paged step captured as a CUDA graph at one (kind, width, batch
    bucket).  The step's five int32 inputs are static device buffers the
    replay copies the host arrays into; the graph reads the pool storage
    and the weights at the addresses they had at capture, which ``replay``
    checks."""

    def __init__(self, run, shapes, device, pool, leaves):
        self.inputs = [torch.zeros(shape, dtype=torch.int32, device=device)
                       for shape in shapes]
        # the first call runs eagerly (lazy library and kernel set-up stays
        # out of the capture), on the current stream: a side stream of its
        # own would get a cuBLAS workspace of its own, kept for the process
        run(*self.inputs)
        # collect dead engines now: a collection during the capture would
        # destroy their graphs, which CUDA forbids while a stream captures
        gc.collect()
        self.graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(self.graph, pool=pool):
            self.out = run(*self.inputs)
        self.ptrs = [t.data_ptr() for t in leaves]
        self.replays = 0

    def replay(self, arrays, leaves) -> np.ndarray:
        ptrs = [t.data_ptr() for t in leaves]
        if ptrs != self.ptrs:
            moved = sum(a != b for a, b in zip(ptrs, self.ptrs))
            raise RuntimeError(f"{moved} pool storage or weight tensors "
                               "moved since the step's CUDA graph was "
                               "captured")
        for buf, a in zip(self.inputs, arrays):
            buf.copy_(torch.from_numpy(a))
        self.graph.replay()
        self.replays += 1
        return self.out.cpu().numpy()


def _tree_tensors(tree) -> List[torch.Tensor]:
    if isinstance(tree, dict):
        return [t for k in sorted(tree) for t in _tree_tensors(tree[k])]
    return [tree]


class ServeEngine:
    """``ServeEngine(cfg, topology, ecfg, seed=0, device="cuda")``.

    Runs on ``device`` — CUDA unless the caller asks for the CPU.  The
    weights are ``params`` when given (a dict of tensors on ``device``,
    e.g. ``from_reference`` of the JAX engine's weights), else random from
    a ``torch.Generator`` seeded with ``seed``."""

    def __init__(self, cfg: ModelConfig, topology: ChipletTopology,
                 ecfg: EngineConfig = EngineConfig(), *, seed: int = 0,
                 spread_rate: int = 1, params=None, device="cuda"):
        if cfg.family == "encdec":
            raise ValueError(f"{cfg.name}: the engine has no encoder-decoder "
                             "serving path (its steps take no source "
                             "frames); serve it at model level with "
                             "launch.steps.make_prefill and make_generate")
        if cfg.family == "vlm" and not (ecfg.paged and ecfg.lazy):
            raise ValueError(f"{cfg.name}: the engine serves a VLM text-only "
                             "on the lazy paged path; the whole-prompt "
                             "prefill of lazy=False and paged=False has no "
                             "vision extras (vision_embeds, position_ids)")
        if ecfg.evict_mode not in ("swap", "restart"):
            raise ValueError(f"unknown evict_mode {ecfg.evict_mode!r}")
        if ecfg.prefill_mode not in ("parallel", "scan"):
            raise ValueError(f"unknown prefill_mode {ecfg.prefill_mode!r}")
        if ecfg.chunk_kernel not in ("blocked", "dense"):
            raise ValueError(f"unknown chunk_kernel {ecfg.chunk_kernel!r}")
        if ecfg.spec_decode not in ("off", "ngram"):
            raise ValueError(f"unknown spec_decode {ecfg.spec_decode!r}")
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
        self.pool: Optional[KVBlockPool] = None
        self._lazy = ecfg.paged and ecfg.lazy
        self._async = ecfg.paged and ecfg.async_swap
        # the eager and monolith paths have no chunk ticks: their chunk
        # path is the per-token reference, which reads no chunk kernel
        self._prefill_mode = ecfg.prefill_mode if self._lazy else "scan"
        self._chunk_kernel = (ecfg.chunk_kernel
                              if self._prefill_mode == "parallel" else "dense")
        self._prefill = make_prefill(cfg, max_len=ecfg.max_len)
        self._decode = make_serve_step(cfg)
        self._parked: Dict[int, _Parked] = {}
        self._park_seq = itertools.count()
        self._progress_mark = -1.0
        self._stall_rounds = 0
        self._round = 0                 # scheduler rounds seen (_stall_hook)
        self._head_id: Optional[int] = None   # current line-head task id and
        self._head_wait = 0                   # rounds it has sat blocked there
        # bypass-class waiters are woken on frees and grants; _bypass_on
        # gates the grants themselves
        self._bypass_wake = ecfg.paged and any(
            c.bypass for c in ecfg.slo_classes.values())
        self._bypass_on = self._bypass_wake and ecfg.slo_bypass
        self._wait_round: Dict[int, int] = {}
        self._bypass_cells: Dict[int, Dict[str, Any]] = {}
        # every bypass grant as (round, granted rid, jumped head rid)
        self.bypass_log: List[Tuple[int, int, int]] = []
        # CUDA graphs of the paged steps, by (kind, width, batch bucket),
        # captured by warm_steps into one memory pool
        self._graphs: Dict[Tuple[str, int, int], _StepGraph] = {}
        self._graph_pool = None
        self._steps: Dict[str, Callable] = {}
        if ecfg.paged:
            self._init_pool()
        else:
            # the slot monolith: each group's own cache, one token a tick
            self._cache_spec = dec.cache_view_specs(cfg, ecfg.max_len)
            self._kv_fn = None
            self._chunk = 1
            self._share = False
            self._spec = False
            self._spec_w = 0
            self.drafter = None
        self._build_groups()
        self.sched.register_relayout(self._relayout)

    def _init_pool(self):
        """The paged engines' KV pool, wait line and paged steps."""
        cfg, ecfg, topology = self.cfg, self.ecfg, self.topology
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
        ml = ecfg.max_len
        self._kv_fn = lambda n: kv_bytes_exact(cfg, n, ml)
        # prefix sharing needs elastic tables (the skip resumes at a chunk
        # boundary like a restored park) and ring pages to share
        self._share = (self._lazy and ecfg.prefix_share
                       and self.pool.pages_per_stream > 0)
        # prefill chunk: one KV page by default (ring models), the
        # configured page size for pure-state models (no ring pages).  No
        # C <= W clamp: the fused forward handles chunks wider than the ring
        self._chunk = ecfg.prefill_chunk or (
            self.pool.block_tokens if self.pool.pages_per_stream
            else ecfg.block_tokens)
        # speculative decoding rides the lazy chunk path: drafted decode
        # streams become small-chunk rows verified through an
        # all-position-logits variant of the same chunk step, at this
        # narrow width
        self._spec = (self._lazy and ecfg.spec_decode != "off"
                      and ecfg.spec_k > 0 and self._chunk > 1)
        self.drafter = (make_drafter(ecfg.spec_decode, ngram=ecfg.spec_ngram)
                        if self._spec else None)
        self._spec_w = min(ecfg.spec_k + 1, self._chunk) if self._spec \
            else 0
        mode, kernel = self._prefill_mode, self._chunk_kernel
        self._steps["decode"] = self._paged_step("decode", self._decode)
        if self._lazy:
            self._steps["chunk"] = self._paged_step(
                "chunk", make_serve_chunk_step(cfg, self.pool.spec, mode=mode,
                                               chunk_kernel=kernel))
        if self._spec:
            self._steps["spec"] = self._paged_step(
                "spec", make_spec_verify_step(cfg, self.pool.spec, mode=mode,
                                              chunk_kernel=kernel))

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
                              self._domains_of(g, lay),
                              cache=None if self.ecfg.paged
                              else dec.init_cache(self.cfg,
                                                  self.ecfg.max_batch,
                                                  self.ecfg.max_len,
                                                  device=self.device))
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
        unshared tail.  Lazy admissions keep ``headroom`` blocks free in
        the granting domain; eager ones reserve their whole length and
        keep none."""
        headroom = self.ecfg.headroom if self._lazy else 0
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
                                      headroom=headroom,
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
        headroom = self.ecfg.headroom if self._lazy else 0
        for g, d in cands:
            hn, head_state = self._head_need_in(rec, d)
            if (head_state and self.pool.has_state
                    and self.pool.free_states(d) < 2):
                continue                # the head's restore slot is not ours
            shared, ckpt = matches.get(d, ((), 0))
            table = self.pool.reserve(d, total_tokens,
                                      first_tokens=None,  # eager: no growth
                                      headroom=headroom,
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
        if not self.ecfg.paged:
            # the slot monolith: straight to the least-pressured group
            g = min(self.groups,
                    key=lambda gr: (gr.kv_pressure(), len(gr.queue)))
            req.group = g.gid
            self.queues.push(g.gid, req)
            return req
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
        """Per-request coroutine: reserve the first chunk's pages (the
        eager engine: the whole capped length) when at the head of the
        wait line (or by a size-aware bypass), park on pool exhaustion
        until a free wakes us."""
        total = len(req.prompt) + req.max_new
        first = (min(self._chunk, max(1, len(req.prompt)))
                 if self._lazy else None)
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
        if self.ecfg.paged:
            # quiesce the transfer engine: tables must not be harvested or
            # re-pointed with a D2H copy still on the wire
            self.pool.drain()
        # harvest in-flight streams and queued requests from the dissolving
        # groups.  Paged: KV stays in the pool (tables move, data does not
        # — except the used pages of rebalanced streams), and parked
        # streams need no harvesting: their regrow task re-resolves the
        # owner group.  Slot monolith: each stream carries its cache slice.
        inflight: List[_InFlight] = []
        queued: List[Request] = []
        mig0 = self.counters.totals.get("kv_blocks_migrated", 0.0)
        for g in old_groups:
            g.retired = True
            for slot, req in enumerate(g.slots):
                if req is None:
                    continue
                one = None if self.ecfg.paged else self._slot_slice(g, slot)
                inflight.append(_InFlight(req, one, int(g.pos_h[slot]),
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
        if self.ecfg.paged:
            # tables follow their domain's new owner; only streams
            # rebalanced off the owner copy their used pages cross-domain
            cap = max(1, math.ceil(len(inflight) / n))
            load = {g.gid: 0 for g in self.groups}
            for fl in inflight:
                tgt = self._owner_group(fl.req.table.domain)
                if load[tgt.gid] >= cap:
                    alt = min(self.groups,
                              key=lambda gr: (load[gr.gid], gr.gid))
                    if alt is not tgt and self._migrate_into(fl.req.table,
                                                            alt):
                        tgt = alt
                fl.req.group = tgt.gid
                fl.req.migrations += 1
                load[tgt.gid] += 1
                tgt.resume.append(fl)
            for req in queued:
                tgt = self._owner_group(req.table.domain)
                req.group = tgt.gid
                self.queues.push(tgt.gid, req)
        else:
            # the slot monolith deals streams and queued requests out
            # round-robin
            for i, fl in enumerate(inflight):
                tgt = self.groups[i % n]
                fl.req.group = tgt.gid
                fl.req.migrations += 1
                tgt.resume.append(fl)
            for i, req in enumerate(queued):
                tgt = self.groups[i % n]
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

    def _paged_step(self, kind: str, step):
        """Paged step ``kind`` ("decode", "chunk" or "spec") as a function
        of its five int32 device inputs — tables (B, P), state slots (B,),
        tokens (B, W), pos (B,), n_tokens (B,) — returning the greedy token
        per row (-1 for rows with ``n_tokens == 0``), or for "spec" the
        argmax after every fed token (B, W).  Reads nothing on the host,
        so a CUDA graph can hold it."""
        spec = self.pool.spec

        def run(tables, slots, tokens, pos, n):
            view = dec.gather_cache_view(self.pool.storage, spec, tables,
                                         slots)
            if kind == "decode":
                logits, view = step(self.params, view, tokens, pos)
            else:
                logits, view = step(self.params, view, tokens, pos, n)
            dec.scatter_cache_view(self.pool.storage, spec, tables, slots,
                                   view)
            if kind == "spec":
                return logits.argmax(dim=-1).to(torch.int32)
            return dec.next_token_ids(logits, n)

        return run

    def _indices(self, reqs: List[Optional[Request]]
                 ) -> Tuple[np.ndarray, np.ndarray]:
        """Null-padded (B, P) page tables and (B,) state slots.
        Partially-grown tables pad their unallocated tail with the null
        block — those ring positions are past ``pos`` and never read."""
        P = self.pool.pages_per_stream
        tables = np.zeros((len(reqs), P), np.int32)
        slots = np.zeros((len(reqs),), np.int32)
        for i, req in enumerate(reqs):
            if req is not None and req.table is not None:
                t = req.table
                tables[i, :len(t.blocks)] = t.blocks
                slots[i] = t.state_slot
        return tables, slots

    def _run_step(self, kind: str, reqs, tokens, pos, n) -> np.ndarray:
        """Run step ``kind`` over ``reqs``' pages (None rows point at the
        null page and state slot): the CUDA graph captured for its shape
        when there is one, else eagerly."""
        tables, slots = self._indices(reqs)
        args = (tables, slots, np.ascontiguousarray(tokens, np.int32),
                np.ascontiguousarray(pos, np.int32),
                np.ascontiguousarray(n, np.int32))
        graph = self._graphs.get((kind, args[2].shape[1], len(reqs)))
        if graph is not None:
            return graph.replay(args, self._graph_leaves())
        return self._steps[kind](*map(self._tensor, args)).cpu().numpy()

    def _monolith_decode(self, g: _Group, tokens, n) -> np.ndarray:
        """The slot monolith's single-token step over every slot of the
        group's own cache (idle slots compute into their own slot, which
        admission overwrites); the greedy token per slot, -1 where ``n``
        is 0."""
        logits, g.cache = self._decode(self.params, g.cache,
                                       self._tensor(tokens),
                                       self._tensor(g.pos_h))
        return dec.next_token_ids(logits, self._tensor(n)).cpu().numpy()

    def _paged_decode(self, reqs, tokens, pos) -> np.ndarray:
        """Single-token step over ``reqs``' pages; returns the greedy
        token per row (-1 for None rows)."""
        n = np.asarray([r is not None for r in reqs], np.int32)
        return self._run_step("decode", reqs, tokens, pos, n)

    def _paged_chunk(self, reqs, tokens, pos, n_tokens) -> np.ndarray:
        """Fused multi-token chunk step over ``reqs``' pages; returns the
        greedy token per row (-1 for rows with ``n_tokens == 0``)."""
        return self._run_step("chunk", reqs, tokens, pos, n_tokens)

    def _paged_spec(self, reqs, tokens, pos, n_tokens) -> np.ndarray:
        """The speculative VERIFY step: the chunk step's gather -> masked
        forward -> scatter, returning the greedy token after EVERY fed
        token (B, W).  The cache commits optimistically; rejected suffixes
        roll back from the pool's checkpoints."""
        return self._run_step("spec", reqs, tokens, pos, n_tokens)

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
            if req.table is not None and req.table.inflight:
                # our own spill is still on the wire: the fence-before-
                # regrant invariant freezes the table until it lands (the
                # landing's free callback wakes the line head)
                yield BLOCK
                continue
            if self.waiters.oldest() is not rec.cell["task"]:
                if self._async and req.table.spill is not None:
                    # not our turn yet: stage the H2D upload behind the
                    # ticks ahead of us
                    self.pool.restore_prefetch(req.table)
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
        g.resume.append(_InFlight(req, None, rec.pos, rec.token))

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
        watchdog spills (or evicts) the most-recently-parked stream.  The
        slot monolith has no pool and does nothing here."""
        if not self.ecfg.paged:
            return
        self._round += 1
        if self._async:
            # poll phase of the ladder: land every transfer whose copy has
            # completed — landings fire the free callback, so re-grants
            # happen here, not at issue
            self.pool.spill_poll()
        if len(self.waiters):
            self.counters.add("kv_head_wait_ticks", 1)
        head = self.waiters.oldest()
        hid = head.id if head is not None else None
        if hid != self._head_id:
            self._head_id, self._head_wait = hid, 0
        elif hid is not None:
            self._head_wait += 1
        if self._parked:
            infl = self.pool.inflight_domains() if self._async else set()
            for d in self.pool.watermark_domains():
                if d in infl:
                    continue            # its frees are already in the pipe
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
            if self._async and self.pool.inflight_tables():
                # a spill is already on the wire: fence it instead of
                # issuing another — the landing re-grants the victim's
                # pages, which is the progress the watchdog wants
                self.pool.spill_fence()
            elif self.ecfg.evict_mode == "swap" and self._spill_youngest():
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
            if self._async and self.pool.inflight_tables():
                self.pool.spill_fence()     # land the pipe before adding
                self._head_wait = 0         # to it
                return
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
                 and not r.req.table.inflight
                 and r.req.table.blocks
                 and r.req.rid != exclude_rid
                 and (domain is None or r.req.table.domain == domain)]
        if not cands:
            return False
        if self._async and domain is not None:
            # async ladder, domain-scoped rungs: the §4.5 access counters
            # pick the victim — min ``last_touch`` is the parked stream
            # whose pages have gone longest without a decode tick
            rec = min(cands, key=lambda r: (r.req.table.last_touch, r.seq))
        else:
            rec = max(cands, key=lambda r: r.seq)
        task = rec.cell.get("task")
        if task is not None:
            # demote BEFORE spilling: the spill's free callback wakes the
            # line head, which must be the next waiter — not the victim
            ns = self.waiters.to_back(task)
            if ns is not None:
                rec.req.wq_seq = ns
                self._wait_round[task.id] = self._round
        if self._async:
            # issue only: the D2H copy drains behind the token loop and the
            # victim's pages re-grant at the poll that lands it
            self.pool.spill_issue(rec.req.table)
        else:
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

    # -- the slot monolith's cache slices ------------------------------------
    def _slot_slice(self, g: _Group, slot: int) -> List[torch.Tensor]:
        """A copy of one slot's slice of every leaf of a monolith group's
        cache (a view would alias the dissolving group's cache)."""
        return [leaf.select(s.batch_axis, slot).clone()
                for leaf, s in zip(dec.tree_leaves(g.cache, self._cache_spec),
                                   self._cache_spec.leaves)]

    def _write_slot(self, g: _Group, slot: int, one: List[torch.Tensor]):
        """Write a stream's slice of every cache leaf into ``slot``."""
        for leaf, s, v in zip(dec.tree_leaves(g.cache, self._cache_spec),
                              self._cache_spec.leaves, one):
            leaf.select(s.batch_axis, slot).copy_(v)

    # -- one engine tick: admit + mixed chunk/decode token step ---------------
    def _install(self, g: _Group, slot: int, fl: _InFlight):
        """Re-slot a migrated stream.  Paged: pure bookkeeping, the KV
        never left the pool.  Slot monolith: writes the carried slice."""
        if not self.ecfg.paged:
            self._write_slot(g, slot, fl.cache)
        g.slots[slot] = fl.req
        g.pos_h[slot] = fl.pos
        g.tok_h[slot] = fl.token
        self.counters.add("kv_slots_restored", 1)

    def _accept_steal(self, g: _Group):
        """TieredQueues accept hook: a stolen request's reservation moves
        into the thief's memory domain (memory follows work)."""
        def accept(req: Request, _tier: str) -> bool:
            if not self.ecfg.paged or req.table is None:
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
            if self._lazy:
                # the token loop prefills this stream chunk by chunk from
                # the first unmatched prompt position
                g.slots[slot] = req
                g.pos_h[slot] = req.prefix_tokens
                g.tok_h[slot] = 0
                continue
            nxt = self._prefill_whole(g, slot, req)
            if nxt is None:
                continue
            g.slots[slot] = req
            g.pos_h[slot] = len(req.prompt)
            g.tok_h[slot] = nxt

    def _prefill_whole(self, g: _Group, slot: int,
                       req: Request) -> Optional[int]:
        """The eager and monolith engines' admission: prefill the whole
        prompt in one forward and commit its cache — into the stream's
        pages (eager) or the group's ``slot`` (monolith).  Returns the
        first token, or None when that token met the budget (``max_new ==
        1``): the request finishes without a slot, and its pages free."""
        prompt = torch.from_numpy(
            np.ascontiguousarray(req.prompt[None, :])).to(self.device)
        logits, cache1 = self._prefill(self.params, {"tokens": prompt})
        nxt = int(logits[0].argmax())
        req.generated.append(nxt)
        req.t_first = self._clock()
        self.counters.add("prefills", 1)
        self.counters.add("tokens_processed", len(req.prompt))
        if len(req.generated) >= req.max_new:
            req.t_done = req.t_first
            self._inflight -= 1
            if self.ecfg.paged:
                self.pool.free(req.table)
            return None
        if self.ecfg.paged:
            tables, slots = self._indices([req])
            dec.scatter_cache_view(self.pool.storage, self.pool.spec,
                                   self._tensor(tables), self._tensor(slots),
                                   cache1)
            req.table.used_pages = self.pool.pages_needed(len(req.prompt))
        else:
            self._write_slot(g, slot, [
                leaf.select(s.batch_axis, 0) for leaf, s in zip(
                    dec.tree_leaves(cache1, self._cache_spec),
                    self._cache_spec.leaves)])
        return nxt

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

    def _draft_for(self, req: Request, pos: int) -> List[int]:
        """Up to spec_k draft tokens for a DECODE stream — empty during
        prefill, near max_new (the verify chunk's free boundary token must
        never overrun the budget), or when the drafter has nothing.
        Proposals are sanitized (in-vocab prefix) but never trusted: the
        verify forward is the only thing that commits tokens."""
        if pos < len(req.prompt):
            return []
        k = min(self.ecfg.spec_k, self._spec_w - 1,
                req.max_new - len(req.generated) - 1)
        if k <= 0:
            return []
        out: List[int] = []
        for t in self.drafter.draft(req, k)[:k]:
            t = int(t)
            if not 0 <= t < self.cfg.vocab:
                break
            out.append(t)
        return out

    def _spec_rows(self, g: _Group, toks, rows: List[Tuple[int, int]]):
        """(requests, tokens, pos, n_tokens) of ``rows`` — (slot, tokens
        it feeds) — compacted into a pow-2 bucket at the spec width."""
        W = self._spec_w
        Bs = _bucket(len(rows), self.ecfg.max_batch)
        toks_s = np.zeros((Bs, W), np.int32)
        pos_s = np.zeros((Bs,), np.int32)
        n_s = np.zeros((Bs,), np.int32)
        for j, (i, n) in enumerate(rows):
            toks_s[j, :n] = toks[i, :n]
            pos_s[j] = g.pos_h[i]
            n_s[j] = n
        reqs = [g.slots[i] for i, _ in rows] + [None] * (Bs - len(rows))
        return reqs, toks_s, pos_s, n_s

    def _spec_verify(self, g: _Group, toks, n_h,
                     drafts: Dict[int, List[int]]) -> Dict[int, np.ndarray]:
        """The verify half: ONE all-position-logits fused chunk forward
        over the drafted rows, compacted into their own pow-2 bucket at
        the narrow spec width (drafted rows never share a step with
        prefill chunks or plain decode rows, so those paths stay exactly
        the spec-off engine's).  The cache commits optimistically.
        Returns row -> the greedy token after each of its n_i fed
        tokens."""
        rows = [(i, int(n_h[i])) for i in sorted(drafts)]
        am = self._paged_spec(*self._spec_rows(g, toks, rows))
        self.counters.add("spec_verify_forwards", 1)
        self.counters.add("spec_row_forwards", len(rows))
        return {i: am[j, :n] for j, (i, n) in enumerate(rows)}

    def _spec_reapply(self, g: _Group, toks, rows: List[Tuple[int, int]]):
        """Re-apply the ACCEPTED prefix of each rolled-back draft row with
        one masked chunk forward from the restored pre-verify state (its
        tokens discarded — the verify pass already fixed the committed
        tokens).  Causal masking makes this equivalent to having fed only
        those tokens in the first place."""
        self._paged_chunk(*self._spec_rows(g, toks, rows))
        self.counters.add("spec_reapply_forwards", 1)
        self.counters.add("spec_row_reapplies", len(rows))

    def _verify_drafts(self, g: _Group, toks, n_h,
                       drafts: Dict[int, List[int]]) -> Dict[int, List[int]]:
        """The speculative half of a tick: checkpoint, verify, greedy
        acceptance, rollback and re-apply.  Returns row -> committed
        tokens (the accepted draft prefix plus the free boundary token).

        Rollback needs, per row.  While the write window stays below the
        ring width, rejected-suffix page writes are dead weight, never
        wrong: they sit at or past the committed cursor and every read is
        cursor-masked.  Once ``pos + n`` crosses the ring width a rejected
        write at position p lands on slot p % W and destroys the live
        position p - W, so the touched pages are snapshotted.  Recurrent
        state always needs its snapshot: the slot holds the reduction over
        all n fed tokens."""
        self.counters.add("spec_ticks", 1)
        ring_w = self.pool.spec.width if self.pool.pages_per_stream else 0
        snap_rows: List[Tuple[KVTable, int, int, bool]] = []
        snap_idx: List[int] = []
        for i in sorted(drafts):
            p0, nn = int(g.pos_h[i]), int(n_h[i])
            wraps = bool(ring_w) and p0 + nn > ring_w
            if self.pool.has_state or wraps:
                snap_rows.append((g.slots[i].table, p0, nn, wraps))
                snap_idx.append(i)
        # one device gather snapshots every drafted row; a full accept
        # drops the snapshot without any host copy
        snaps = dict(zip(snap_idx, self.pool.checkpoint_rows(snap_rows))) \
            if snap_rows else {}
        am_rows = self._spec_verify(g, toks, n_h, drafts)
        commits: Dict[int, List[int]] = {}
        reapply: List[Tuple[int, int]] = []
        rolled: List[dict] = []
        for i in sorted(drafts):
            n = int(n_h[i])
            am = am_rows[i]
            # accept the longest prefix where each draft token matches the
            # verified argmax one position earlier; the token at the accept
            # boundary comes free (full accept: k+1 tokens)
            m = 0
            while m < n - 1 and int(toks[i, m + 1]) == int(am[m]):
                m += 1
            commits[i] = [int(x) for x in am[:m + 1]]
            self.counters.add("spec_tokens_drafted", n - 1)
            self.counters.add("spec_tokens_accepted", m)
            if m + 1 < n:
                self.counters.add("spec_rollbacks", 1)
                if m == 0:
                    self.counters.add("spec_full_rejects", 1)
                if i in snaps:
                    rolled.append(snaps[i])
                    reapply.append((i, m + 1))
        if rolled:
            self.pool.rollback_rows(rolled)     # one batched scatter
        if reapply:
            self._spec_reapply(g, toks, reapply)
        drafted = self.counters.totals.get("spec_tokens_drafted", 0.0)
        if drafted:
            self.counters.set(
                "spec_accept_rate",
                self.counters.totals.get("spec_tokens_accepted", 0.0)
                / drafted)
        return commits

    def _decode_tick(self, g: _Group):
        """ONE engine tick for the group: every occupied slot consumes its
        next tokens — a page-sized prompt chunk for streams still in
        prefill, the last generated token (plus up to spec_k drafted
        tokens when speculative decoding is on) for decode streams.
        Tables grow (or park their stream) before the step writes any
        bytes."""
        B = self.ecfg.max_batch
        n_h = np.zeros((B,), np.int32)
        chunked = False
        drafts: Dict[int, List[int]] = {}
        for i in range(B):
            req = g.slots[i]
            if req is None:
                continue
            pos = int(g.pos_h[i])
            if not self.ecfg.paged:
                # the slot monolith: no pages to grow, one token a tick
                n_h[i] = 1
                continue
            assert req.table is not None, f"request {req.rid} has no table"
            self.pool.touch_table(req.table)
            n, need = self._next_chunk_need(req, pos)
            d = self._draft_for(req, pos) if self._spec else []
            if d:
                # a drafted decode stream writes 1 + k positions this tick:
                # growth and CoW cover the full draft width BEFORE the
                # optimistic verify forward touches pages
                n = 1 + len(d)
                need = self.pool.pages_needed(pos + n) - len(req.table.blocks)
            forks = (self.pool.fork_pages(req.table, pos, n)
                     if self._share else [])
            # eager tables hold their whole length: they never grow
            grown = not (self._lazy and self.pool.pages_per_stream
                         and (need > 0 or forks)) \
                or self._grow_stream(req, g, max(need, 0), tuple(forks))
            if not grown and d:
                # speculation is opportunistic: under memory pressure drop
                # the draft and retry as a plain decode, so spec never
                # parks a stream the non-speculative engine would have run
                d = []
                n, need = self._next_chunk_need(req, pos)
                forks = (self.pool.fork_pages(req.table, pos, n)
                         if self._share else [])
                grown = not (need > 0 or forks) or self._grow_stream(
                    req, g, max(need, 0), tuple(forks))
            if not grown:
                self._park_stream(g, i)
                continue
            if self._share:
                # writing into a published page forks the page's index
                # entry off it (the OLD block keeps its entry)
                self.pool.note_writes(req.table, pos, n)
            if d:
                drafts[i] = d
            n_h[i] = n
            # drafted rows run their OWN verify half; "chunked" tracks only
            # real prefill chunks, so the spec-off paths stay unchanged
            chunked = chunked or (n > 1 and i not in drafts)
        if not n_h.any():
            return
        if self.ecfg.paged and self.pool.inflight_tables():
            # the overlap clock: a model tick ran with at least one D2H
            # transfer on the wire
            self.counters.add("kv_ticks_while_inflight", 1)
        # per-stream token feed: the next prompt slice for streams still in
        # prefill (a final chunk may hold a single token), the last emitted
        # token — plus its draft continuation — for decode streams
        C = self._chunk if chunked else (self._spec_w if drafts else 1)
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
                d = drafts.get(i)
                if d:
                    toks[i, 1:1 + len(d)] = d
        # drafted rows are carved out of the regular steps (n_eff = 0:
        # their rows point at the null page or feed no token) — they run
        # through the verify half below, so prefill chunks and plain decode
        # rows run exactly the steps the spec-off engine runs
        n_eff = n_h.copy()
        for i in drafts:
            n_eff[i] = 0
        deco_rows = [i for i in range(B) if n_eff[i] == 1]
        if chunked:
            # model steps by construction of the path: the fused forward
            # is one a tick, the scan C (``measured_model_steps`` counts
            # them)
            self.counters.add("chunk_ticks", 1)
            self.counters.add("prefill_model_steps",
                              1 if self._prefill_mode == "parallel" else C)
            if self.ecfg.split_ticks and deco_rows:
                nxt = self._split_tick(g, n_eff, toks, C, deco_rows)
            else:
                if deco_rows:
                    # single-token streams ride the C-wide step: C-1 of
                    # their query rows are masked waste
                    self.counters.add("decode_masked_query_rows",
                                      (C - 1) * len(deco_rows))
                nxt = self._paged_chunk(list(g.slots), toks, g.pos_h, n_eff)
        elif deco_rows and not self.ecfg.paged:
            nxt = self._monolith_decode(g, toks[:, :1], n_eff)
        elif deco_rows:
            # the single-token step has no per-row length mask: drafted and
            # idle rows point at the null page and state slot
            nxt = self._paged_decode(
                [g.slots[i] if n_eff[i] else None for i in range(B)],
                toks[:, :1], g.pos_h)
        else:
            nxt = np.full((B,), -1, np.int32)   # pure-spec tick
        if deco_rows:
            self.counters.add("decode_row_forwards", sum(
                1 for i in deco_rows
                if int(g.pos_h[i]) >= len(g.slots[i].prompt)))
            if not chunked or self.ecfg.split_ticks:
                self.counters.add("decode_forwards", 1)
        commits = self._verify_drafts(g, toks, n_h, drafts) if drafts \
            else {}
        now = self._clock()
        for i in range(B):
            req = g.slots[i]
            if req is None or not n_h[i]:
                continue
            S = len(req.prompt)
            pos0 = int(g.pos_h[i])
            if i in commits:
                # a drafted decode row commits its verified tokens; the
                # cursor lands on the last ACCEPTED position, so a park or
                # spill next tick saves exactly this state
                out = commits[i]
                new_pos = pos0 + len(out)
                g.pos_h[i] = new_pos
                self.counters.add("tokens_processed", len(out))
                self.counters.add("decode_committed_tokens", len(out))
                for tok in out:
                    assert tok >= 0, f"spec slot {i} emitted a sentinel"
                    req.generated.append(tok)
            else:
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
            g.tok_h[i] = req.generated[-1]
            if self.ecfg.paged:
                req.table.used_pages = min(len(req.table.blocks),
                                           self.pool.pages_needed(new_pos))
            if len(req.generated) >= req.max_new:
                req.t_done = now
                g.slots[i] = None
                self._inflight -= 1
                if self.ecfg.paged:
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

    def _round_metrics(self) -> Optional[Callable[[], Dict[str, float]]]:
        """Per-round profiler feed: KV-pool gauges + deltas since the
        previous round (None in the slot monolith)."""
        if not self.ecfg.paged:
            return None
        names = ("kv_alloc_failures", "kv_blocks_migrated", "kv_lazy_grows",
                 "kv_mid_decode_parks", "prefill_chunks",
                 "kv_spilled_pages", "kv_restores", "recompute_tokens",
                 "mixed_tick_decode_rows_saved",
                 "kv_prefix_hits", "prefill_tokens_skipped",
                 "spec_tokens_drafted", "spec_tokens_accepted",
                 "spec_rollbacks", "kv_bypass_grants", "kv_head_wait_ticks",
                 "kv_ticks_while_inflight", "kv_fence_waits")
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
                   "kv_shared_bytes": self.pool.shared_bytes(),
                   "spec_accept_rate": self.counters.totals.get(
                       "spec_accept_rate", 0.0),
                   # transfer-engine gauges at sample time, not deltas
                   "kv_spill_inflight_pages": float(
                       self.pool.inflight_pages()),
                   "kv_spill_inflight_bytes": float(
                       self.pool.inflight_bytes())}
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
            if self.ecfg.paged:
                self.pool.drain()       # no transfer outlives the run
        out = {"concurrency": trace, "counters": self.counters.snapshot(),
               "relayouts": list(self.relayouts),
               "decisions": [dataclasses.asdict(x)
                             for x in self.controller.decisions]}
        if self.ecfg.paged:
            out["kv"] = self.kv_stats()
        return out

    # -- measured model steps and the CUDA-graph warm-up ----------------------
    def _null_args(self, B: int, W: int) -> Tuple[np.ndarray, ...]:
        """Step inputs of ``B`` null rows at width ``W``: tables at block
        0, state slot 0, ``n_tokens = 0`` — written but never read, so
        live caches pass through unchanged."""
        z = np.zeros((B,), np.int32)
        return (np.zeros((B, self.pool.pages_per_stream), np.int32), z,
                np.zeros((B, W), np.int32), z, z)

    def _kind_width(self, kind: str, C: Optional[int]) -> int:
        if not self.ecfg.paged:
            raise ValueError("measured_model_steps needs the paged path")
        if kind == "decode":
            return 1
        if kind == "spec" and not self._spec:
            raise ValueError("spec step not built: spec_decode is off")
        if kind not in ("chunk", "spec"):
            raise ValueError(f"unknown step kind {kind!r}")
        if kind not in self._steps:
            raise ValueError("chunk step not built: the eager engine "
                             "(lazy=False) has no chunk ticks")
        return C or (self._chunk if kind == "chunk" else self._spec_w)

    def measured_model_steps(self, kind: str = "chunk", *,
                             C: Optional[int] = None, B: int = 1) -> float:
        """Sequential model steps ONE call of a paged step runs, counted
        rather than assumed: the walks the call makes through the layer
        stack (``decode.layer_walks``), in one eager call on null rows.
        ``kind`` is "decode", "chunk" or "spec" (the verify step); ``C``
        the width (default: the engine's own for the kind).  The JAX
        package counts the layer scan's trips in the compiled HLO.  One
        walk for every kind on the fused path; the scan path walks once a
        fed token (C for a chunk, the verify width for "spec")."""
        args = self._null_args(B, self._kind_width(kind, C))
        walks = dec.layer_walks()
        self._steps[kind](*map(self._tensor, args))
        return float(dec.layer_walks() - walks)

    def warm_steps(self, chunks: Tuple[int, ...] = (4, 8, 16)) -> int:
        """Prepare the paged steps on the JAX package's grid — decode, the
        chunk widths in ``chunks`` (clamped to the engine's chunk size)
        and, when speculative decoding is on, the verify width — at every
        pow-2 batch bucket up to ``max_batch``, on null rows.  On the card
        each (kind, width, bucket) the serve loop dispatches (``_dispatches``)
        is captured once as a CUDA graph (one eager call first, then the
        capture; all graphs share one memory pool), and the steps replay
        it from then on; the grid's other shapes, and on the CPU every
        shape, run one eager call.  Returns the number of step calls, as
        the JAX package's ``warm_steps`` (which compiles the whole grid)
        does.  The slot monolith has no paged steps: 0.  The eager engine
        builds no chunk step, and refuses (the JAX package's raises
        AttributeError there)."""
        if not self.ecfg.paged:
            return 0
        if not self._lazy:
            raise ValueError("warm_steps needs the lazy paged engine: the "
                             "eager engine (lazy=False) builds no chunk "
                             "step to warm")
        calls = 0
        widths = sorted({min(c, self._chunk) for c in chunks}
                        | ({self._spec_w} if self._spec else set()))
        B = 1
        while B <= self.ecfg.max_batch:
            keys = [("decode", 1, B)]
            for W in widths:
                keys.append(("chunk", W, B))
                if self._spec and W == self._spec_w:
                    keys.append(("spec", W, B))
            for key in keys:
                self._warm(*key)
                calls += 1
            B *= 2
        # the pow-2 page-copy buckets behind migrations and prefix forks
        # (the JAX package compiles them too): null-block self-copies
        b = 1
        while b <= self.pool.pages_per_stream:
            dec.copy_pool_entries(self.pool.storage, self.pool.spec,
                                  [0] * b, [0] * b)
            calls += 1
            b *= 2
        return calls

    def _dispatches(self, kind: str, W: int) -> bool:
        """Whether the serve loop runs step ``kind`` at width ``W``: decode
        at 1, the chunk step at the chunk size and (the reapply) at the
        verify width, the verify step at its width."""
        if kind == "decode":
            return W == 1
        widths = {self._spec_w} if self._spec else set()
        if kind == "chunk":
            widths.add(self._chunk)
        return W in widths

    def _warm(self, kind: str, W: int, B: int):
        args = self._null_args(B, W)
        if self.device.type != "cuda" or not self._dispatches(kind, W):
            self._steps[kind](*map(self._tensor, args))
            return
        graph = self._graphs.get((kind, W, B))
        if graph is None:
            if self._graph_pool is None:
                self._graph_pool = torch.cuda.graph_pool_handle()
            self._graphs[(kind, W, B)] = _StepGraph(
                self._steps[kind], [a.shape for a in args], self.device,
                self._graph_pool, self._graph_leaves())
        else:
            graph.replay(args, self._graph_leaves())

    def _graph_leaves(self) -> List[torch.Tensor]:
        """The tensors a captured step reads by address: the pool storage
        and the weights."""
        return _tree_tensors(self.pool.storage) + _tree_tensors(self.params)

    def graph_replays(self) -> Dict[Tuple[str, int, int], int]:
        """Replays of each captured graph, by (kind, width, batch
        bucket)."""
        return {k: g.replays for k, g in self._graphs.items()}

    # -- latency / pool stats --------------------------------------------------
    def kv_stats(self) -> Dict[str, float]:
        """KV-pool health: occupancy, parks, growth, spills, prefix
        sharing, bypass, per-class latency ({} in the slot monolith)."""
        if not self.ecfg.paged:
            return {}
        s = self.pool.stats()
        s["prefill_chunk_bytes"] = prefill_chunk_bytes(
            self.cfg, self._chunk, self.ecfg.max_len,
            mode=self._prefill_mode, kernel=self._chunk_kernel)
        s["prefill_score_bytes"] = (
            prefill_chunk_score_bytes(self.cfg, self._chunk,
                                      self.ecfg.max_len,
                                      kernel=self._chunk_kernel)
            if self._prefill_mode == "parallel" else 0.0)
        s["chunk_kernel"] = self._chunk_kernel
        tot = self.counters.totals
        for k in ("mixed_tick_decode_rows_saved", "decode_gather_rows_saved",
                  "decode_masked_query_rows", "prefill_model_steps",
                  "chunk_ticks"):
            s[k] = tot.get(k, 0.0)
        s["evictions"] = tot.get("kv_evictions", 0.0)
        s["recompute_tokens"] = tot.get("recompute_tokens", 0.0)
        s["blocks_per_relayout"] = [r.get("blocks_migrated", 0.0)
                                    for r in self.relayouts]
        # speculative decoding: acceptance totals, forward participations
        # (the denominators of accepted tokens per model step) and the
        # costmodel-priced bytes optimism wasted
        s["spec_decode"] = self.ecfg.spec_decode if self._spec else "off"
        for k in ("spec_ticks", "spec_verify_forwards",
                  "spec_reapply_forwards", "spec_row_forwards",
                  "spec_row_reapplies", "spec_tokens_drafted",
                  "spec_tokens_accepted", "spec_rollbacks",
                  "spec_full_rejects", "spec_accept_rate",
                  "decode_forwards", "decode_row_forwards",
                  "decode_committed_tokens"):
            s[k] = tot.get(k, 0.0)
        s["spec_rejected_bytes"] = spec_rejected_bytes(
            self.cfg, int(s["spec_tokens_drafted"] - s["spec_tokens_accepted"]))
        s["spec_rollback_bytes"] = spec_rollback_bytes(
            self.cfg, int(tot.get("kv_spec_ckpt_pages", 0.0)),
            int(tot.get("kv_spec_rollback_pages", 0.0)),
            self.pool.block_tokens,
            ckpts=int(tot.get("kv_spec_ckpts", 0.0)),
            rollbacks=int(s["spec_rollbacks"]))
        s["bypass_grants"] = tot.get("kv_bypass_grants", 0.0)
        s["bypass_floor_pages"] = tot.get("kv_bypass_floor_pages", 0.0)
        s["bypass_floor_bytes"] = kv_bypass_floor_bytes(
            self.cfg, int(s["bypass_floor_pages"]), self.pool.block_tokens)
        s["head_wait_ticks"] = tot.get("kv_head_wait_ticks", 0.0)
        s["proactive_spills"] = tot.get("kv_proactive_spills", 0.0)
        s["watchdog_spills"] = tot.get("kv_watchdog_spills", 0.0)
        # async swap tier: decode ticks that ran with a transfer on the
        # wire, rounds each landed spill hid behind, fences that waited
        s["async_swap"] = bool(self._async)
        s["ticks_while_inflight"] = tot.get("kv_ticks_while_inflight", 0.0)
        s["overlap_rounds_per_spill"] = (
            tot.get("kv_spill_overlap_rounds", 0.0)
            / max(1.0, s.get("spills", 0.0)))
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
