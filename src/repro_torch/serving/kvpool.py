"""Paged KV-block allocator partitioned per chiplet-group memory domain —
the second ARCAS pillar (hardware-aware memory allocation) applied to
serving.

The pool owns ONE physical storage tree (``models/decode.py`` block-pool
layout) whose block-id space is partitioned into per-chiplet-group *domains*
(the NUMA-bind analogue: on a multi-card fleet each domain's id range
belongs in that group's device memory).  A request holds a :class:`KVTable` — its ring pages as physical block
ids inside exactly one domain, plus one per-stream state slot — instead of a
slot in a monolithic per-replica cache array:

  * admission reserves ``ceil(min(prompt+max_new, W) / block_tokens)`` pages
    (short requests reserve less than the ring width, which is where the
    capacity win over the slot monolith comes from);
  * reservation failure is the serving back-pressure signal: the admission
    coroutine parks on the pool's :class:`~repro_torch.core.tasks.WaitQueue` via
    ``yield BLOCK`` and is woken by ``free``;
  * a relayout re-points block *tables* at the new owner replica of their
    domain; only streams rebalanced onto a replica that does not own their
    domain copy their **used** pages (``migrate``) — never whole cache
    slices;
  * under memory pressure a parked stream's used pages can be SPILLED to a
    host-side swap tier (``spill``/``restore``): its device pages are freed
    to the wait-line head and the table turns host-resident — migrating for
    free (pure domain re-point) — until it is re-granted pages and the
    stream resumes mid-decode, instead of the restart-from-scratch eviction
    that recomputes every token.

Block id 0 and state slot 0 are reserved null entries: empty decode slots
and the unreserved tail of short tables point at them, so every gather and
scatter has the same shape while null contents are never read (ring
positions past a stream's last token are masked by ``cache_positions``).

PREFIX SHARING (copy-on-write pages).  Physical pages are REFCOUNTED: a
page frees only when its last table releases it, so several tables may
point at the same block.  Completed prompt pages are published into a
prefix index keyed by the running token-hash chain (one blake2b digest per
page, chained, seeded per model config — the prefill chunk size equals the
page size, so chunk boundaries ARE page boundaries); a new request whose
prompt hash-matches a resident chain attaches those pages at admission
(``match_prefix`` + ``reserve(prefix_blocks=)``) and starts prefill at the
match boundary — skipping both the allocation and the fused forward for
every shared page.  Writes never touch a shared page: the engine calls
``fork_pages``/``cow_fork`` before any tick whose ring writes would land
on a refcount>1 page (the divergence write at a full-ring match and
ordinary ring wrap-around are the two triggers), and ``note_writes``
drops the index entry of any registered page about to be overwritten —
pages older than the ring width W are dead and can never be matched.
For models with carried state (rgLRU/SSD), the state slot is position-
dependent: registration snapshots the donor's slot into a checkpoint slot
at the page boundary and a match FORKS that checkpoint into the new
stream's slot (``copy_pool_entries`` state copy).  Freed pages with a
live index entry stay CACHED: they sit on the free list (reclaimable —
allocation prefers uncached blocks and invalidates on reuse) but keep
their entry, so a later identical prompt still hits after its donor
finished.

Budgets are expressed in *bytes* via ``costmodel.kv_cache_bytes`` and
converted to blocks/state slots, so a pool can be sized to exactly the HBM
footprint the old slot-monolith allocator used — or to a fraction of
``ChipletTopology.group_hbm()`` on a real fleet.

The storage is one dict of tensors on one device (all domains share the
card); the storage ops write it in place.  A spill runs in three phases
(``spill_issue`` / ``spill_poll`` / ``spill_fence``): the issue snapshots
the victim's pages on the compute stream and copies them to the pinned
host tier on a side stream, the decode ticks go on, and the victim's
pages are re-granted only when the copy has landed.  The synchronous
``spill`` is issue + immediate fence.
"""
from __future__ import annotations

import collections
import dataclasses
import hashlib
import math
from typing import Any, Callable, Dict, Iterable, List, Optional, Sequence, \
    Tuple

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.core.costmodel import kv_cache_bytes, kv_dedup_bytes, \
    kv_spill_bytes, prefill_chunk_bytes
from repro_torch.core.counters import PerfCounters
from repro_torch.launch.steps import make_prefix_fork, make_rows_gather, \
    make_rows_scatter, make_spill_gather_async, make_spill_scatter
from repro_torch.models import decode as dec
from repro_torch.serving.swap import InFlightSpill, SwapTier


def kv_bytes_exact(cfg: ModelConfig, n_tokens: int, max_len: int) -> float:
    """Exact decode-state bytes of ONE stream holding ``n_tokens`` of
    context (ring-capped at ``max_len``) — replaces the old
    ``(prompt+generated)*2`` napkin estimate in migration accounting."""
    s = ShapeConfig("kv", "decode", max(1, min(n_tokens, max_len)), 1)
    return kv_cache_bytes(cfg, s, 1)


@dataclasses.dataclass
class SpillEntry:
    """Host-side payload of a spilled table: its used pages (+ state) as
    host tensors in cache-spec leaf order, waiting in the swap tier until
    the stream is re-granted device pages."""
    pages: int                      # used pages held host-side
    data: List[Any]                 # host leaves from extract_pool_entries
    had_state: bool = False         # a state slot rides in ``data``
    tier: Optional[Any] = None      # SwapTier handle backing ``data`` views
    staged: Optional[List[Any]] = None  # H2D-prefetched device leaves
    staged_event: Optional[Any] = None  # completes with the prefetch copy


@dataclasses.dataclass
class PrefixEntry:
    """One published prompt page in the prefix index: the resident block
    holding tokens ``[o*bt, (o+1)*bt)`` of some prompt whose hash chain
    ends at this entry's key, plus — for models with carried rgLRU/SSD
    state — an optional checkpoint slot holding the donor's state at the
    page boundary (0 = none; the entry then cannot END a match for a
    state model, but can still sit in the middle of a longer chain).

    The entry does NOT hold a refcount of its own: while some table holds
    the block it is pinned anyway, and once the last holder releases it
    the block goes back on the free list *still carrying the entry*
    (cached) until allocation reuses it."""
    block: int
    domain: int
    state_ckpt: int = 0


@dataclasses.dataclass
class KVTable:
    """One stream's view into the pool: ring pages + state slot, resident
    in a single chiplet-group domain.

    Reservations are ELASTIC: a lazily-admitted table starts with the pages
    of its first prefill chunk and :meth:`KVBlockPool.grow` appends pages
    in ring order as the stream's ``pos`` crosses page boundaries, up to
    ``cap_pages`` (the eager reservation the PR-2 allocator made up
    front).  ``cap_pages == 0`` means fully reserved at admission.

    A table can be SPILLED to the host swap tier under memory pressure
    (:meth:`KVBlockPool.spill`): its used pages live in ``spill`` and it
    holds no device resources until :meth:`KVBlockPool.restore` — while
    host-resident it migrates between domains by re-pointing ``domain``
    alone (zero device copies)."""
    domain: int
    blocks: List[int]               # reserved physical pages, ring order
    state_slot: int                 # 0 = none (model has no state leaves)
    used_pages: int = 0             # pages actually written (prefill/decode)
    cap_pages: int = 0              # lazy mode: max pages this stream needs
    spill: Optional[SpillEntry] = None   # host payload while spilled
    inflight: bool = False          # D2H spill issued, not landed: the
    #                                 table still HOLDS its pages (regrant
    #                                 happens only at the landing) and the
    #                                 stream must not advance
    last_touch: int = 0             # pool touch-clock at last decode tick
    #                                 (§4.5 access counter: watermark
    #                                 victims are the coldest-parked)

    @property
    def n_blocks(self) -> int:
        return len(self.blocks)

    @property
    def spilled(self) -> bool:
        return self.spill is not None


class KVBlockPool:
    """Block pool over ``n_domains`` chiplet-group memory domains.

    Pure host-side bookkeeping (free lists, tables, counters) plus the
    device-side storage pytree; gather/scatter/copy of actual pages happens
    through ``models/decode.py`` view helpers.
    """

    def __init__(self, cfg: ModelConfig, *, n_domains: int, max_len: int,
                 blocks_per_domain: int, states_per_domain: int,
                 block_tokens: int = 16,
                 counters: Optional[PerfCounters] = None,
                 retention: str = "access",
                 topology=None, device="cuda"):
        if retention not in ("access", "blind"):
            raise ValueError(f"unknown retention policy {retention!r}")
        self.cfg = cfg
        self.max_len = max_len
        self.n_domains = n_domains
        # cached-tier retention: "access" reclaims the coldest published
        # page by last-hit recency; "blind" keeps the old free-list order
        self.retention = retention
        self._touch_clock = 0
        self._touch: Dict[int, int] = {}
        self.counters = counters or PerfCounters()
        self.spec = dec.cache_view_specs(cfg, max_len)
        W = self.spec.width
        if W:
            bt = self._aligned_block_tokens(W, block_tokens)
            self.block_tokens = bt
            self.pages_per_stream = W // bt
        else:                       # pure-state model (SSM): no ring pages
            self.block_tokens = 1
            self.pages_per_stream = 0
        self.has_state = any(s.token_axis is None for s in self.spec.leaves)
        self.blocks_per_domain = blocks_per_domain if W else 0
        self.states_per_domain = states_per_domain if self.has_state else 0
        # id 0 is the shared null entry; domain d owns
        # [1 + d*per_domain, 1 + (d+1)*per_domain)
        self._free_blocks: List[List[int]] = [
            list(range(1 + d * self.blocks_per_domain,
                       1 + (d + 1) * self.blocks_per_domain))
            for d in range(n_domains)]
        self._free_states: List[List[int]] = [
            list(range(1 + d * self.states_per_domain,
                       1 + (d + 1) * self.states_per_domain))
            for d in range(n_domains)]
        self.storage = dec.init_block_pool(
            cfg, self.spec,
            n_blocks=1 + n_domains * self.blocks_per_domain,
            n_states=1 + n_domains * self.states_per_domain,
            block_tokens=self.block_tokens, device=device)
        # ``topology`` is advisory: every domain lives on the one device
        self.topology = topology
        self._on_free: List[Callable[[], None]] = []
        # swap tier: D2H/H2D copies of a table's used pages + state slot,
        # landing in preallocated (pinned on CUDA) host buffers.  The tier
        # is sized to a multiple of the device pool: under oversubscription
        # the AGGREGATE spilled footprint exceeds device capacity (that is
        # the point of the second tier), so a 1x sizing overflows as soon
        # as two pool-sized victims are parked at once.
        self._spill_gather_async = make_spill_gather_async(self.spec)
        self._spill_scatter = make_spill_scatter(self.spec)
        self._rows_gather = make_rows_gather(self.spec)
        self._rows_scatter = make_rows_scatter(self.spec)
        # the transfer engine's side stream (None on the CPU, where every
        # copy is synchronous) and its issued-but-unlanded spills; an
        # entry means its table still holds pages and its stream is
        # frozen at its park cursor
        self.device = torch.device(device)
        self._copy_stream = (torch.cuda.Stream(self.device)
                             if self.device.type == "cuda" else None)
        self._inflight: List[InFlightSpill] = []
        self._poll_clock = 0
        self.swap = SwapTier(
            dec.tree_leaves(self.storage, self.spec), self.spec,
            capacity_pages=4 * n_domains * self.blocks_per_domain,
            capacity_states=4 * n_domains * self.states_per_domain)
        # prefix sharing: per-block refcounts (a block frees only when the
        # last table releases it), the hash-chain index of published
        # prompt pages, and its block -> key reverse map for invalidation.
        # The chain seed folds the model config in, so two pools with
        # different families/shapes can never alias a digest.
        self._ref: Dict[int, int] = {}
        self._prefix: Dict[bytes, PrefixEntry] = {}
        self._entry_of_block: Dict[int, bytes] = {}
        self._prefix_seed = hashlib.blake2b(
            repr((cfg, self.block_tokens, max_len)).encode(),
            digest_size=16).digest()
        self._prefix_fork = make_prefix_fork(self.spec)
        self.spilled_tables = 0         # tables currently host-resident
        self.spilled_bytes = 0.0        # swap-tier footprint right now
        self.peak_spilled_bytes = 0.0
        self.peak_used_blocks = 0
        # per-domain high-water marks (blocks in use), so chunked prefill /
        # lazy growth can report byte-accurate per-domain footprints
        self.peak_used_per_domain = [0] * n_domains
        self.active_tables = 0          # reservations currently live
        self.peak_active_tables = 0     # max concurrently admitted streams
        # proactive-spill occupancy watermarks (None = disabled): a domain
        # crossing HIGH is a candidate for ONE early spill; it re-arms only
        # after dipping back under LOW (hysteresis against spill thrash)
        self.wm_high: Optional[float] = None
        self.wm_low: Optional[float] = None
        self._wm_hot = [False] * n_domains

    # -- sizing helpers ----------------------------------------------------
    @staticmethod
    def _aligned_block_tokens(W: int, block_tokens: int) -> int:
        """Largest page size <= block_tokens dividing the ring width."""
        bt = min(block_tokens, W)
        while W % bt:
            bt -= 1
        return bt

    @classmethod
    def blocks_for_streams(cls, cfg: ModelConfig, max_len: int,
                           streams: int, block_tokens: int = 16) -> Dict:
        """Per-domain budget equivalent to a slot monolith of ``streams``
        full-length streams: the byte-for-byte capacity the old allocator
        reserved per replica group."""
        spec = dec.cache_view_specs(cfg, max_len)
        W = spec.width
        # same page-size alignment as __init__, so the budget always covers
        # exactly `streams` full tables regardless of W % block_tokens
        pages = W // cls._aligned_block_tokens(W, block_tokens) if W else 0
        return {"blocks_per_domain": streams * pages,
                "states_per_domain": streams}

    def bytes_per_block(self) -> float:
        """Token-page bytes from the cost model (state slots excluded)."""
        if not self.pages_per_stream:
            return 0.0
        per2 = kv_bytes_exact(self.cfg, 2 * self.block_tokens, self.max_len)
        per1 = kv_bytes_exact(self.cfg, self.block_tokens, self.max_len)
        return max(per2 - per1, 0.0)

    def domain_bytes(self) -> float:
        state_b = (kv_bytes_exact(self.cfg, 1, self.max_len)
                   - self.bytes_per_block() / max(1, self.block_tokens))
        return (self.blocks_per_domain * self.bytes_per_block()
                + self.states_per_domain * max(state_b, 0.0))

    # -- accounting --------------------------------------------------------
    def pages_needed(self, total_tokens: int) -> int:
        if not self.pages_per_stream:
            return 0
        W = self.spec.width
        bt = self.block_tokens
        return min(self.pages_per_stream,
                   max(1, math.ceil(min(total_tokens, W) / bt)))

    def free_blocks(self, domain: int) -> int:
        return len(self._free_blocks[domain])

    def free_states(self, domain: int) -> int:
        return len(self._free_states[domain])

    def used_blocks(self) -> int:
        total = self.n_domains * self.blocks_per_domain
        return total - sum(len(f) for f in self._free_blocks)

    def used_blocks_in(self, domain: int) -> int:
        return self.blocks_per_domain - len(self._free_blocks[domain])

    def total_blocks(self) -> int:
        return self.n_domains * self.blocks_per_domain

    def occupancy(self) -> float:
        """Fraction of pool capacity in use (blocks, or state slots for
        pure-state models)."""
        total = self.total_blocks()
        if not total:
            total = self.n_domains * self.states_per_domain
            used = total - sum(len(f) for f in self._free_states)
            return used / total if total else 0.0
        return self.used_blocks() / total

    def domain_occupancy(self, domain: int) -> float:
        """Fraction of ONE domain's capacity in use (blocks, or state
        slots for pure-state models) — the watermark ladder's input."""
        if self.blocks_per_domain:
            return self.used_blocks_in(domain) / self.blocks_per_domain
        if self.states_per_domain:
            return ((self.states_per_domain
                     - len(self._free_states[domain]))
                    / self.states_per_domain)
        return 0.0

    # -- proactive-spill watermarks ----------------------------------------
    def set_watermarks(self, high: Optional[float],
                       low: Optional[float] = None):
        """Arm per-domain occupancy watermarks for PROACTIVE spill (the
        ladder rung between park and the stall watchdog): a domain whose
        occupancy reaches ``high`` reports itself via
        :meth:`watermark_domains` so the engine can spill one cold parked
        stream BEFORE the allocation stall closes into a deadlock; the
        domain then stays latched (no further proactive spills) until it
        dips back to ``low`` — the hysteresis that prevents spill/restore
        thrash when freed pages are regranted immediately.  ``high=None``
        disables (the watchdog-only default)."""
        if high is None:
            self.wm_high = self.wm_low = None
            self._wm_hot = [False] * self.n_domains
            return
        low = high if low is None else low
        if not (0.0 < low <= high <= 1.0):
            raise ValueError(
                f"watermarks need 0 < low <= high <= 1, got "
                f"high={high} low={low}")
        self.wm_high, self.wm_low = float(high), float(low)
        self._wm_hot = [False] * self.n_domains

    def watermark_domains(self) -> List[int]:
        """Domains whose occupancy has crossed the HIGH mark since last
        dipping under LOW — each is a candidate for one proactive spill.
        Crossing does NOT latch by itself: the caller confirms an actual
        spill with :meth:`watermark_arm` (a hot domain with nothing left
        to spill must stay eligible for the next round)."""
        out: List[int] = []
        if self.wm_high is None:
            return out
        for d in range(self.n_domains):
            occ = self.domain_occupancy(d)
            if self._wm_hot[d]:
                if occ <= self.wm_low:
                    self._wm_hot[d] = False
            elif occ >= self.wm_high:
                out.append(d)
        return out

    def watermark_arm(self, domain: int):
        """Latch a domain after a proactive spill: no further proactive
        spills there until occupancy dips under the LOW mark."""
        self._wm_hot[domain] = True

    def can_reserve(self, domain: int, pages: int) -> bool:
        if not self.state_available(domain):
            return False
        return len(self._free_blocks[domain]) >= pages

    def state_available(self, domain: int) -> bool:
        """A state slot can be produced in ``domain``: one is free, or a
        prefix checkpoint is resident there to reclaim (cached state beats
        a starving admission)."""
        if not self.has_state:
            return True
        if self._free_states[domain]:
            return True
        return any(e.state_ckpt
                   and self._state_domain(e.state_ckpt) == domain
                   for e in self._prefix.values())

    # -- refcounted physical blocks ----------------------------------------
    def ref(self, block: int) -> int:
        return self._ref.get(block, 0)

    def _block_domain(self, b: int) -> int:
        return (b - 1) // self.blocks_per_domain

    def _state_domain(self, s: int) -> int:
        return (s - 1) // self.states_per_domain

    def _touch_block(self, b: int):
        """Record an access to a published page: ``match_prefix`` hits,
        publication, and cached re-attachment all count.  Drives the
        "access" retention order — colder pages are reclaimed first, per
        the measured-access-behavior tiering argument of "Workload
        Behavior Driven Memory Subsystem Design" (PAPERS.md)."""
        self._touch_clock += 1
        self._touch[b] = self._touch_clock

    def _pop_block(self, domain: int) -> int:
        """Take a free block at refcount 1, preferring blocks that do NOT
        cache a published prefix page; when only cached blocks remain,
        retention="access" reclaims the COLDEST one (least recently hit /
        published) and "blind" the oldest-freed, dropping its index
        entry either way."""
        free = self._free_blocks[domain]
        idx = len(free) - 1
        if self._entry_of_block:
            uncached = next((i for i in range(len(free) - 1, -1, -1)
                             if free[i] not in self._entry_of_block), None)
            if uncached is not None:
                idx = uncached
            else:
                if self.retention == "access":
                    idx = min(range(len(free)),
                              key=lambda i: self._touch.get(free[i], 0))
                else:
                    idx = 0
                self.counters.add("kv_cached_reclaims", 1)
        b = free.pop(idx)
        if b in self._entry_of_block:
            self._invalidate_block(b)
        self._touch.pop(b, None)    # content is about to be replaced
        self._ref[b] = 1
        return b

    def _release_block(self, b: int):
        """Drop one reference; the block returns to ITS OWN domain's free
        list only when the last holder lets go — a live index entry rides
        along (cached) until :meth:`_pop_block` reuses the block."""
        r = self._ref.get(b, 0) - 1
        assert r >= 0, f"refcount underflow on block {b}"
        if r > 0:
            self._ref[b] = r
        else:
            self._ref.pop(b, None)
            self._free_blocks[self._block_domain(b)].append(b)

    def _invalidate_block(self, b: int):
        """Drop the prefix entry published on ``b`` (its content is about
        to change, or the cached block is being reallocated), returning
        the entry's state checkpoint to the free list."""
        key = self._entry_of_block.pop(b, None)
        if key is None:
            return
        e = self._prefix.pop(key)
        if e.state_ckpt:
            self._free_states[self._state_domain(e.state_ckpt)].append(
                e.state_ckpt)

    def _take_state(self, domain: int) -> int:
        """Pop a free state slot, reclaiming the oldest-registered prefix
        checkpoint in the domain when none is free (admissions must never
        starve behind cached state)."""
        if self._free_states[domain]:
            return self._free_states[domain].pop()
        for e in self._prefix.values():
            if e.state_ckpt and self._state_domain(e.state_ckpt) == domain:
                s, e.state_ckpt = e.state_ckpt, 0
                self.counters.add("kv_ckpt_reclaims", 1)
                return s
        raise IndexError(f"domain {domain}: no state slots available")

    # -- prefix index: hash-chain keys, match, publish, invalidate ---------
    def prefix_keys(self, tokens) -> List[bytes]:
        """Running hash chain over the prompt's full pages: ``keys[o]``
        digests tokens ``[0, (o+1)*bt)``, so equal keys mean equal whole
        prefixes (not just equal pages).  Capped at the ring width — a
        page past W can never survive to be shared."""
        if not self.pages_per_stream:
            return []
        bt = self.block_tokens
        arr = np.ascontiguousarray(np.asarray(tokens, np.int64))
        n = min(arr.shape[0] // bt, self.pages_per_stream)
        keys, h = [], self._prefix_seed
        for o in range(n):
            h = hashlib.blake2b(h + arr[o * bt:(o + 1) * bt].tobytes(),
                                digest_size=16).digest()
            keys.append(h)
        return keys

    def match_prefix(self, domain: int, keys: Sequence[bytes], *,
                     prompt_len: int) -> Tuple[List[int], int]:
        """Longest run of resident prefix pages in ``domain`` matching the
        prompt's hash chain -> (their blocks, the donor state checkpoint
        at the match boundary; 0 for stateless models).

        The match is capped at ``(prompt_len-1)//bt`` pages so at least
        the prompt's final token is always recomputed — its logits seed
        generation.  For models with carried state the match ends at the
        deepest entry that HAS a checkpoint (the state at the boundary is
        as necessary as the pages)."""
        if not keys or not self.pages_per_stream:
            return [], 0
        limit = min(len(keys), (max(prompt_len, 1) - 1) // self.block_tokens,
                    self.pages_per_stream)
        blocks: List[int] = []
        best, ckpt = 0, 0
        for o in range(limit):
            e = self._prefix.get(keys[o])
            if e is None or e.domain != domain:
                break
            blocks.append(e.block)
            if not self.has_state:
                best = o + 1
            elif e.state_ckpt:
                best, ckpt = o + 1, e.state_ckpt
        for b in blocks[:best]:
            self._touch_block(b)
        return blocks[:best], ckpt

    def register_prefix(self, table: KVTable, keys: Sequence[bytes],
                        pos0: int, new_pos: int, prompt_len: int):
        """Publish the prompt pages a prefill tick just completed (the
        stream advanced ``pos0 -> new_pos``) into the prefix index.

        A page is published only while its content is exactly prompt
        tokens ``[o*bt, (o+1)*bt)``: fully inside the prompt, ordinal
        below the ring width, and not already re-written by ring wrap
        within this same tick.  For models with carried state a
        checkpoint of the stream's slot is snapped when the tick ended
        exactly at the page boundary and a free slot exists (purely
        opportunistic — checkpoints never compete with admissions)."""
        if not self.pages_per_stream or not keys:
            return
        bt, W = self.block_tokens, self.spec.width
        for o in range(max(pos0 // bt, 0),
                       min(new_pos, prompt_len) // bt):
            if o >= min(len(keys), self.pages_per_stream,
                        len(table.blocks)):
                break
            if new_pos > o * bt + W:
                continue        # wrapped inside this very tick: dead page
            key = keys[o]
            b = table.blocks[o]
            if key in self._prefix or b in self._entry_of_block:
                continue        # already published (or block backs a key)
            ckpt = 0
            if self.has_state and new_pos == (o + 1) * bt \
                    and self._free_states[table.domain]:
                ckpt = self._free_states[table.domain].pop()
                self.storage = self._prefix_fork(
                    self.storage, [], [],
                    src_state=table.state_slot, dst_state=ckpt)
            self._prefix[key] = PrefixEntry(b, table.domain, ckpt)
            self._entry_of_block[b] = key
            self._touch_block(b)
            self.counters.add("kv_prefix_pages_published", 1)

    def _write_pages(self, pos: int, n: int, n_blocks: int) -> List[int]:
        """Ring-page indices the next ``n``-token write at ``pos``
        touches (a chunk wider than the ring touches every page)."""
        W = self.spec.width
        bt = self.block_tokens
        if n >= W:
            return list(range(min(self.pages_per_stream, n_blocks)))
        pages = sorted({(p % W) // bt for p in range(pos, pos + n)})
        return [j for j in pages if j < n_blocks]

    def fork_pages(self, table: KVTable, pos: int, n: int) -> List[int]:
        """Ring pages the next tick writes that are SHARED (refcount > 1)
        and must be copied first — the CoW trigger set.  Covers both the
        divergence write of a full-ring match (which wraps straight into
        shared page 0) and ordinary ring wrap-around during decode."""
        if not self.pages_per_stream or table.spill is not None \
                or not table.blocks:
            return []
        return [j for j in self._write_pages(pos, n, len(table.blocks))
                if self._ref.get(table.blocks[j], 0) > 1]

    def cow_fork(self, table: KVTable, page: int) -> bool:
        """Copy-on-write: give ``table`` a private copy of shared ring
        page ``page`` before it is written.  False (no block taken) when
        the table's domain has no free block — the caller parks the
        stream, exactly like a failed grow."""
        old = table.blocks[page]
        if self._ref.get(old, 0) <= 1:
            return True
        if not self._free_blocks[table.domain]:
            self.counters.add("kv_grow_failures", 1)
            return False
        new = self._pop_block(table.domain)
        self.storage = self._prefix_fork(self.storage, [old], [new])
        self._release_block(old)    # other holders keep the original
        table.blocks[page] = new
        self.counters.add("kv_blocks_allocated", 1)
        self.counters.add("kv_cow_forks", 1)
        self._note_usage(table.domain)
        return True

    def note_writes(self, table: KVTable, pos: int, n: int):
        """A write makes a page's content diverge from what the prefix
        index published: drop the entry of every page the next tick
        writes.  (CoW-forked pages already moved the table onto a private
        block, so the OLD block's entry — whose content is untouched —
        survives for its other holders and future matches.)"""
        if not self._entry_of_block or not self.pages_per_stream \
                or table.spill is not None:
            return
        for j in self._write_pages(pos, n, len(table.blocks)):
            b = table.blocks[j]
            if b in self._entry_of_block:
                self._invalidate_block(b)

    # -- shared-page gauges ------------------------------------------------
    def shared_pages(self) -> int:
        """Physical pages currently held by more than one table."""
        return sum(1 for r in self._ref.values() if r > 1)

    def shared_extra_refs(self) -> int:
        """Table->page references served WITHOUT a resident copy of their
        own — the dedup win in pages."""
        return sum(r - 1 for r in self._ref.values() if r > 1)

    def cached_pages(self) -> int:
        """Free-list blocks still carrying a published prefix page."""
        return sum(1 for b in self._entry_of_block
                   if self._ref.get(b, 0) == 0)

    def shared_bytes(self) -> float:
        """Bytes NOT resident thanks to page dedup (costmodel-priced)."""
        return kv_dedup_bytes(self.cfg, self.shared_extra_refs(),
                              self.block_tokens)

    # -- alloc / free ------------------------------------------------------
    def reserve(self, domain: int, total_tokens: int, *,
                first_tokens: Optional[int] = None,
                headroom: int = 0,
                min_free: int = 0,
                count_failure: bool = True,
                prefix_blocks: Optional[Sequence[int]] = None,
                prefix_state: int = 0) -> Optional[KVTable]:
        """Reserve a table for a stream of ``total_tokens`` context in
        ``domain``; None when the domain cannot serve it right now.

        With ``first_tokens`` the reservation is ELASTIC: only the pages
        covering the first ``first_tokens`` positions are taken now (one
        prefill chunk) and the table records ``cap_pages`` — the eager
        footprint — as its growth bound for :meth:`grow`.  The budget check
        still uses the CAP: a stream whose full ring cannot fit a domain
        can never complete, lazily or not.

        ``headroom`` is the admission-control knob for elastic mode: grant
        only when the domain would keep ``headroom`` free blocks AFTER the
        reservation, so lazy growth of already-admitted streams is less
        likely to close the incremental-allocation deadlock in the first
        place.  ``headroom=0`` is exactly the unguarded grant; the knob is
        clamped so an EMPTY domain can always admit (a too-large k must
        throttle, never livelock).

        ``min_free`` is a HARD free-block floor the grant must leave
        behind — the size-aware bypass safety bound: a request granted
        past a blocked line head passes the head's provable restore/grow
        need here, so the grant can never consume a page the head is
        waiting for.  Unlike ``headroom`` it is NEVER clamped: a floor
        that cannot be kept refuses the grant outright.

        ``count_failure=False`` lets a caller probing several domains count
        one logical failure instead of one per domain.

        ``prefix_blocks`` (from :meth:`match_prefix`, same domain) are
        ALREADY-RESIDENT pages the new table attaches by reference — the
        budget charges only the unshared tail, so a fully-cached prompt
        admits even at high occupancy (its pages are free by definition).
        ``prefix_state`` forks the donor's carried-state checkpoint at the
        match boundary into the fresh slot."""
        cap = self.pages_needed(total_tokens)
        if cap > max(self.blocks_per_domain, 0) and cap:
            raise ValueError(
                f"request needs {cap} pages but a domain only has "
                f"{self.blocks_per_domain}: raise the pool budget")
        if self.has_state and self.states_per_domain == 0:
            raise ValueError("pool has no state slots but model needs them")
        shared = list(prefix_blocks or ())
        pages = cap if first_tokens is None else \
            min(cap, self.pages_needed(first_tokens))
        # prefix hits are already resident: charge only the unshared tail.
        # CACHED hits (refcount 0) do sit on the free list though — the
        # attach below pulls them off, so they count against it here or
        # _pop_block would run the list dry.
        pages = max(pages - len(shared), 0)
        cached = sum(1 for b in shared if self._ref.get(b, 0) == 0)
        headroom = min(headroom if pages else 0,
                       max(0, self.blocks_per_domain - pages))
        if not self.can_reserve(domain, pages + cached + headroom
                                + max(min_free, 0)):
            if count_failure:
                self.counters.add("kv_alloc_failures", 1)
            return None
        for b in shared:        # attach AFTER the capacity check
            r = self._ref.get(b, 0)
            if r == 0:          # cached page comes back off the free list
                self._free_blocks[domain].remove(b)
                self.counters.add("kv_cached_page_hits", 1)
            self._ref[b] = r + 1
            self._touch_block(b)
        blocks = shared + [self._pop_block(domain) for _ in range(pages)]
        slot = self._take_state(domain) if self.has_state else 0
        if self.has_state:
            # the slot is position-dependent: fork the donor's rgLRU/SSD
            # checkpoint at the match boundary — or, with no donor, SCRUB
            # the slot (a recycled slot still holds its dead stream's
            # final state, which the recurrence would read at token 0)
            self.storage = self._prefix_fork(
                self.storage, [], [],
                src_state=prefix_state, dst_state=slot)
        self.counters.add("kv_blocks_allocated", pages)
        self.counters.add("kv_reservations", 1)
        if shared:
            self.counters.add("kv_prefix_hits", 1)
            self.counters.add("kv_prefix_pages", len(shared))
            self.counters.add("prefill_tokens_skipped",
                              len(shared) * self.block_tokens)
        self.active_tables += 1
        self.peak_active_tables = max(self.peak_active_tables,
                                      self.active_tables)
        self._note_usage(domain)
        table = KVTable(domain, blocks, slot,
                        cap_pages=cap if first_tokens is not None else 0)
        table.used_pages = len(shared)   # matched pages are valid content
        return table

    def grow(self, table: KVTable, n_pages: int) -> bool:
        """Append ``n_pages`` ring pages to an elastic table (same domain),
        committing bytes only when the stream's ``pos`` actually crosses a
        page boundary.  False (no side effects) when the domain lacks free
        pages — the caller parks its stream mid-decode and retries on the
        pool's free callback."""
        if n_pages <= 0:
            return True
        cap = table.cap_pages or self.pages_per_stream
        if len(table.blocks) + n_pages > cap:
            raise ValueError(
                f"growing past the table's cap ({len(table.blocks)}+"
                f"{n_pages} > {cap} pages)")
        if table.inflight:
            # the victim is frozen until its D2H lands (fence-before-
            # regrant): growing would advance a stream whose landed
            # payload no longer matches.  Parks like a full domain; the
            # landing's free callback retries.
            self.counters.add("kv_grow_failures", 1)
            return False
        if len(self._free_blocks[table.domain]) < n_pages:
            self.counters.add("kv_grow_failures", 1)
            return False
        table.blocks.extend(self._pop_block(table.domain)
                            for _ in range(n_pages))
        self.counters.add("kv_blocks_allocated", n_pages)
        self.counters.add("kv_lazy_grows", 1)
        self._note_usage(table.domain)
        return True

    def free(self, table: KVTable):
        """Return a table's pages + state slot and fire the free callbacks
        (which unblock BLOCK-parked admission coroutines).  Freeing a
        SPILLED table drops its host payload too (the restart-eviction
        fallback path).  Shared pages only DECREF — they stay resident for
        their other holders (and for future prefix matches: a page whose
        last holder lets go parks on the free list still cached).  A table
        with a spill IN FLIGHT is fenced first — its payload lands, then
        drops — so the transfer engine never references a dead table."""
        if table.inflight:
            self.spill_fence(table, count_wait=False)
        for b in sorted(table.blocks):
            self._release_block(b)
        if self.has_state and table.state_slot:
            self._free_states[table.domain].append(table.state_slot)
        self.counters.add("kv_blocks_freed", len(table.blocks))
        if table.spill is not None:
            self._drop_spill(table)
        table.blocks = []
        table.state_slot = 0
        table.used_pages = 0
        self.active_tables -= 1
        self._gauges()
        for cb in self._on_free:
            cb()

    def on_free(self, cb: Callable[[], None]):
        self._on_free.append(cb)

    # -- swap tier: spill parked pages to host instead of discarding them --
    #
    # The transfer engine splits a spill into ISSUE / POLL / FENCE phases:
    # ``spill_issue`` snapshots the victim's pages on the compute stream,
    # starts their copy into the pinned host tier on the side stream and
    # returns — the decode ticks keep running while it drains;
    # ``spill_poll`` lands every transfer whose event has completed;
    # ``spill_fence`` blocks until specific (or all) transfers land.  The
    # victim's pages are RE-GRANTED ONLY AT THE LANDING (fence-before-
    # regrant): until then the table keeps its blocks and the free
    # callbacks stay silent, so nobody can allocate a page whose bytes are
    # still in motion.  The victim stream itself is frozen at its park
    # cursor.  The synchronous ``spill`` is issue + immediate fence.
    def touch_table(self, table: KVTable):
        """§4.5 access counter: stamp a table at every decode tick it ran
        in.  Parked tables stop accumulating, so the coldest-parked victim
        (min ``last_touch``) is the one whose pages have gone longest
        without an access."""
        self._touch_clock += 1
        table.last_touch = self._touch_clock

    def spill_issue(self, table: KVTable) -> int:
        """Issue the D2H copy of a table's used pages (+ state slot) and
        return at once — the copy drains behind the token loop.  Returns
        the pages now in flight (0 = already spilled or already in
        flight)."""
        if table.spill is not None or table.inflight:
            return 0
        used = min(table.used_pages, len(table.blocks))
        had_state = bool(self.has_state and table.state_slot)
        handle = self.swap.reserve(used, had_state)
        event = self._spill_gather_async(
            self.storage, table.blocks[:used],
            state_slot=table.state_slot if had_state else None,
            out=handle.raw, stream=self._copy_stream)
        rec = InFlightSpill(
            table=table, pages=used, had_state=had_state, handle=handle,
            event=event, issue_clock=self._poll_clock,
            n_bytes=kv_spill_bytes(self.cfg, used, self.block_tokens,
                                   had_state))
        table.inflight = True
        self._inflight.append(rec)
        self.counters.add("kv_spill_issues", 1)
        self.counters.add("kv_d2h_bytes", rec.n_bytes)
        self._gauges()
        return used

    def _land_spill(self, rec: InFlightSpill):
        """Completion half of a spill: the payload is home in the tier, so
        free the victim's device pages to the wait-line head and fire the
        free callbacks."""
        table = rec.table
        table.spill = SpillEntry(pages=rec.pages, data=rec.handle.views,
                                 had_state=rec.had_state, tier=rec.handle)
        # the payload COPIED every used page (shared ones included), so
        # releasing shared pages here is safe: the other holders keep the
        # device copy, this table restores a private one
        for b in sorted(table.blocks):
            self._release_block(b)
        if rec.had_state:
            self._free_states[table.domain].append(table.state_slot)
        self.counters.add("kv_blocks_freed", len(table.blocks))
        self.counters.add("kv_spills", 1)
        self.counters.add("kv_spilled_pages", rec.pages)
        self.counters.add("kv_spill_overlap_rounds",
                          self._poll_clock - rec.issue_clock)
        table.blocks = []
        table.state_slot = 0
        table.inflight = False
        self.spilled_tables += 1
        self.spilled_bytes += rec.n_bytes
        self.peak_spilled_bytes = max(self.peak_spilled_bytes,
                                      self.spilled_bytes)
        self._gauges()
        for cb in self._on_free:
            cb()

    def spill_poll(self) -> int:
        """Land every in-flight spill whose copy has completed; never
        blocks.  One call per engine round is the poll phase of the
        pressure ladder (and the overlap clock: rounds between issue and
        landing are decode rounds the transfer hid behind)."""
        self._poll_clock += 1
        done = [r for r in self._inflight if r.ready()]
        for r in done:
            self._inflight.remove(r)
            self._land_spill(r)
        return len(done)

    def spill_fence(self, table: Optional[KVTable] = None, *,
                    count_wait: bool = True) -> int:
        """Block until the given table's transfer (or ALL transfers with
        ``table=None``) lands — the drain path for shutdown, relayout,
        eviction and the watchdog's stalled rung.  ``count_wait`` records
        a ``kv_fence_waits`` event when the fence actually had to wait
        (synchronous ``spill`` fences unconditionally and doesn't count)."""
        recs = [r for r in self._inflight
                if table is None or r.table is table]
        waited = any(not r.ready() for r in recs)
        for r in recs:
            r.wait()
            self._inflight.remove(r)
            self._land_spill(r)
        if recs and waited and count_wait:
            self.counters.add("kv_fence_waits", 1)
        return len(recs)

    def drain(self) -> int:
        """Fence every outstanding transfer (shutdown/relayout path)."""
        return self.spill_fence(None, count_wait=False)

    def inflight_tables(self) -> int:
        return len(self._inflight)

    def inflight_pages(self) -> int:
        return sum(r.pages for r in self._inflight)

    def inflight_bytes(self) -> float:
        return sum(r.n_bytes for r in self._inflight)

    def inflight_domains(self) -> set:
        """Domains with a spill in flight — their frees are already in
        the pipe, so the watermark rung must not double-spill them."""
        return {r.table.domain for r in self._inflight}

    def spill(self, table: KVTable) -> int:
        """Move a table's USED pages (+ state slot) into the host swap
        tier and free its device resources to the wait-line head.

        The table stays live (``active_tables`` unchanged — the stream is
        still admitted, just host-resident) but holds zero device blocks
        until :meth:`restore`; its saved decode cursor makes the
        spill/restore cycle invisible in the token output.  Returns the
        number of pages spilled (0 = already spilled, nothing to do).
        This is the SYNCHRONOUS path: issue + immediate fence."""
        if table.inflight:
            self.spill_fence(table, count_wait=False)
            return 0
        used = self.spill_issue(table)
        if table.inflight:
            self.spill_fence(table, count_wait=False)
        return used

    def restore(self, table: KVTable) -> bool:
        """Re-grant device pages to a spilled table in its CURRENT domain
        (re-point ``migrate`` first to restore somewhere else) and scatter
        the host payload back; False (no side effects) when the domain
        lacks pages or a state slot.  The stream resumes mid-decode at its
        saved cursor — zero recomputed tokens."""
        if table.inflight:
            self.spill_fence(table, count_wait=False)
        sp = table.spill
        if sp is None:
            return True
        d = table.domain
        if (len(self._free_blocks[d]) < sp.pages
                or not self.state_available(d)):
            self.counters.add("kv_restore_failures", 1)
            return False
        blocks = [self._pop_block(d) for _ in range(sp.pages)]
        slot = self._take_state(d) if self.has_state else 0
        self.storage = self._spill_scatter(
            self.storage, blocks, self._payload(sp),
            state_slot=slot if sp.had_state else None)
        table.blocks = blocks
        table.state_slot = slot
        table.used_pages = sp.pages
        n_bytes = kv_spill_bytes(self.cfg, sp.pages, self.block_tokens,
                                 sp.had_state)
        self._drop_spill(table)
        self.counters.add("kv_blocks_allocated", sp.pages)
        self.counters.add("kv_restores", 1)
        self.counters.add("kv_h2d_bytes", n_bytes)
        self._note_usage(d)
        return True

    def restore_into(self, table: KVTable, domain: int,
                     grow_by: int = 0) -> bool:
        """One ATOMIC restore-sweep leg: land a spilled table in
        ``domain`` with ``grow_by`` extra ring pages, reserving pages +
        grow + state slot all-or-nothing.  False leaves ZERO side effects
        — no re-point, no popped page, no consumed state checkpoint — so
        a failed leg of the engine's domain sweep can never strand the
        stream half-restored or leak a slot (the PR-10 bugfix: the old
        sweep re-pointed, restored, then grew in separate steps and a
        late grow failure left a restored-but-unready stream holding a
        reclaimed checkpoint)."""
        if table.inflight:
            self.spill_fence(table, count_wait=False)
        sp = table.spill
        if sp is None:
            return False
        cap = table.cap_pages or self.pages_per_stream
        grow_by = min(max(0, grow_by), max(0, cap - sp.pages))
        if (len(self._free_blocks[domain]) < sp.pages + grow_by
                or not self.state_available(domain)):
            return False
        if not self.migrate(table, domain):     # spilled: pure re-point
            return False
        blocks = [self._pop_block(domain)
                  for _ in range(sp.pages + grow_by)]
        slot = self._take_state(domain) if self.has_state else 0
        self.storage = self._spill_scatter(
            self.storage, blocks[:sp.pages], self._payload(sp),
            state_slot=slot if sp.had_state else None)
        table.blocks = blocks
        table.state_slot = slot
        table.used_pages = sp.pages
        n_bytes = kv_spill_bytes(self.cfg, sp.pages, self.block_tokens,
                                 sp.had_state)
        self._drop_spill(table)
        self.counters.add("kv_blocks_allocated", sp.pages + grow_by)
        self.counters.add("kv_restores", 1)
        self.counters.add("kv_h2d_bytes", n_bytes)
        if grow_by:
            self.counters.add("kv_lazy_grows", 1)
        self._note_usage(domain)
        return True

    def restore_prefetch(self, table: KVTable) -> bool:
        """Stage a spilled table's payload H2D on the side stream ahead of
        the re-grant — called while the stream waits in line, so the
        upload drains behind the ticks ahead of it and the eventual
        restore scatter reads device tensors.  Idempotent; False when
        there is nothing to stage."""
        sp = table.spill
        if sp is None or sp.staged is not None:
            return False
        raw, axes = sp.tier.raw, sp.tier.axes
        if self._copy_stream is None:
            staged = [r.clone() if r is not None else None for r in raw]
        else:
            # the side stream also carries the D2H copies: a tier extent
            # released after this restore is rewritten only after the
            # upload has read it
            with torch.cuda.stream(self._copy_stream):
                staged = [r.to(self.device, non_blocking=True)
                          if r is not None else None for r in raw]
                sp.staged_event = torch.cuda.Event()
                sp.staged_event.record(self._copy_stream)
        sp.staged = [None if t is None else t.movedim(0, ax)
                     for t, ax in zip(staged, axes)]
        self.counters.add("kv_restore_prefetches", 1)
        return True

    def _payload(self, sp: SpillEntry) -> List[Any]:
        """The leaves a restore scatters: the prefetched device copy when
        there is one (the compute stream waits for its upload), else the
        host views."""
        if sp.staged is None:
            return sp.data
        if sp.staged_event is not None:
            cur = torch.cuda.current_stream(self.device)
            cur.wait_event(sp.staged_event)
            for t in sp.staged:
                if t is not None:
                    t.record_stream(cur)
        return sp.staged

    def _drop_spill(self, table: KVTable):
        sp = table.spill
        self.spilled_tables -= 1
        self.spilled_bytes -= kv_spill_bytes(self.cfg, sp.pages,
                                             self.block_tokens, sp.had_state)
        self.swap.release(sp.tier)
        table.spill = None

    # -- migration ---------------------------------------------------------
    def migrate(self, table: KVTable, new_domain: int) -> bool:
        """Move a table into ``new_domain``: re-reserve there, copy only the
        **used** pages (+ state slot) on device, free the old reservation.
        Returns False (no side effects) when the target domain lacks space.
        """
        if table.domain == new_domain:
            return True
        if table.inflight:
            # a relayout/steal hitting an in-flight victim: fence — the
            # payload lands, the table turns host-resident, and the move
            # below becomes the free re-point
            self.spill_fence(table, count_wait=False)
        if table.spill is not None:
            # host-resident: the table holds no device resources, so a
            # migration (relayout rebalance, steal into the thief's domain)
            # is a pure re-point — zero device copies, can never fail
            table.domain = new_domain
            self.counters.add("kv_spill_repoints", 1)
            return True
        pages = len(table.blocks)
        if (len(self._free_blocks[new_domain]) < pages
                or not self.state_available(new_domain)):
            return False
        new_blocks = [self._pop_block(new_domain) for _ in range(pages)]
        new_slot = self._take_state(new_domain) if self.has_state else 0
        used = table.used_pages
        if used or (self.has_state and table.state_slot):
            self.storage = dec.copy_pool_entries(
                self.storage, self.spec,
                table.blocks[:used], new_blocks[:used],
                src_state=table.state_slot if self.has_state else None,
                dst_state=new_slot if self.has_state else None)
        # migration COPIES used pages into the new domain, so the moved
        # table's copies are private; shared originals decref and remain
        # with their other holders (relayout of a refcount>1 table works
        # without ever re-pointing someone else's pages)
        for b in sorted(table.blocks):
            self._release_block(b)
        if self.has_state and table.state_slot:
            self._free_states[table.domain].append(table.state_slot)
        self.counters.add("kv_blocks_migrated", used)
        self.counters.add("kv_tables_migrated", 1)
        table.domain = new_domain
        table.blocks = new_blocks
        table.state_slot = new_slot
        self._note_usage(new_domain)
        for cb in self._on_free:      # the old domain gained capacity
            cb()
        return True

    # -- speculative checkpoint / rollback ---------------------------------
    def checkpoint_rows(self, rows: Sequence[Tuple[KVTable, int, int, bool]]
                        ) -> List[dict]:
        """Snapshot, BEFORE a speculative verify forward commits
        optimistically, every drafted row's write-touched pages (``pages``
        true: the window wraps the ring) and carried-state slot — ONE
        device gather over all rows, kept on the device (most checkpoints
        are dropped untouched when the draft fully accepts).  Must run
        after the tick's growth/CoW phase, so the touched blocks are
        private and :meth:`rollback_rows` can restore them in place.
        ``rows`` entries are ``(table, pos, n, pages)``."""
        metas = []
        all_blocks: List[int] = []
        slots: List[int] = []
        for table, pos, n, pages in rows:
            idx = self._write_pages(pos, n, len(table.blocks)) if pages \
                else []
            blocks = [table.blocks[j] for j in idx]
            slot = table.state_slot if (self.has_state and table.state_slot) \
                else None
            metas.append((blocks, slot, len(all_blocks),
                          len(slots) if slot is not None else -1))
            all_blocks.extend(blocks)
            if slot is not None:
                slots.append(slot)
            self.counters.add("kv_spec_ckpts", 1)
            self.counters.add("kv_spec_ckpt_pages", len(blocks))
        leaves = self._rows_gather(self.storage, all_blocks,
                                   state_slots=slots) \
            if (all_blocks or slots) else None
        return [{"blocks": blocks, "slot": slot, "rows": leaves,
                 "off": off, "soff": soff}
                for blocks, slot, off, soff in metas]

    def rollback_rows(self, ckpts: Sequence[dict]):
        """Restore the rows that REJECTED: one device scatter puts every
        rolled-back row's pages + state slot back from the shared
        :meth:`checkpoint_rows` gather.  The accepted prefix is then
        re-applied by a masked chunk forward, so the restored state
        advances by exactly the accepted tokens."""
        live = [c for c in ckpts if c["blocks"] or c["slot"] is not None]
        if not live:
            return
        groups: Dict[int, List[dict]] = {}
        for c in live:          # rows from distinct ticks scatter apart
            groups.setdefault(id(c["rows"]), []).append(c)
        for group in groups.values():
            leaves = group[0]["rows"]
            blk_src: List[int] = []     # indices into the shared gather
            dst_blocks: List[int] = []
            st_src: List[int] = []
            dst_slots: List[int] = []
            for c in group:
                blk_src.extend(range(c["off"], c["off"] + len(c["blocks"])))
                dst_blocks.extend(c["blocks"])
                if c["slot"] is not None and c["soff"] >= 0:
                    st_src.append(c["soff"])
                    dst_slots.append(c["slot"])
                self.counters.add("kv_spec_rollback_pages",
                                  len(c["blocks"]))
            vals = []
            for leaf, s in zip(leaves, self.spec.leaves):
                src = blk_src if s.token_axis is not None else st_src
                vals.append(leaf.index_select(
                    s.batch_axis, torch.tensor(src, device=leaf.device))
                    if leaf is not None and src else None)
            self.storage = self._rows_scatter(self.storage, dst_blocks,
                                              vals, state_slots=dst_slots)

    def _note_usage(self, domain: int):
        self.peak_used_blocks = max(self.peak_used_blocks, self.used_blocks())
        self.peak_used_per_domain[domain] = max(
            self.peak_used_per_domain[domain], self.used_blocks_in(domain))
        self._gauges()

    def _gauges(self):
        self.counters.set("kv_pool_used_blocks", float(self.used_blocks()))
        self.counters.set("kv_pool_total_blocks", float(self.total_blocks()))
        self.counters.set("kv_pool_occupancy", self.occupancy())
        self.counters.set("kv_active_tables", float(self.active_tables))
        self.counters.set("kv_spilled_tables", float(self.spilled_tables))
        self.counters.set("kv_spilled_bytes", self.spilled_bytes)
        self.counters.set("kv_shared_pages", float(self.shared_pages()))
        self.counters.set("kv_shared_bytes", self.shared_bytes())
        self.counters.set("kv_cached_pages", float(self.cached_pages()))
        self.counters.set("kv_spill_inflight_pages",
                          float(self.inflight_pages()))
        self.counters.set("kv_spill_inflight_bytes", self.inflight_bytes())

    # -- consistency -------------------------------------------------------
    def audit(self, tables: Iterable[KVTable] = ()):
        """Assert exact free-list AND refcount accounting: free lists hold
        unique ids inside their domain's range at refcount 0, every held
        block's refcount equals EXACTLY the number of live tables pointing
        at it (sharing is legal only through the refcount), unique held
        blocks + free covers the pool EXACTLY, and the prefix index is
        consistent — every entry's block is resident (held or cached on
        the free list), the block->key reverse map is a bijection, and
        state checkpoints are disjoint from held/free slots with
        held + free + checkpoints covering all slots.  ``tables`` must be
        every live table (a block in neither a table nor a free list is a
        leak).  The stress suites call this after every
        spill/restore/migrate/free/fork; raises AssertionError on any
        leak."""
        held = collections.Counter()
        held_states: List[int] = []
        for t in tables:
            if t.spill is not None:
                assert not t.blocks and not t.state_slot, \
                    f"spilled table holds device resources: {t}"
                assert not t.inflight, \
                    "table both landed-spilled and in flight"
            held.update(t.blocks)
            if self.has_state and t.state_slot:
                held_states.append(t.state_slot)
        # refcounts are exact: one count per live table holding the block
        for b, c in held.items():
            assert self._ref.get(b, 0) == c, \
                f"block {b}: refcount {self._ref.get(b, 0)} != {c} holders"
        assert set(self._ref) == set(held), \
            f"refcount on unheld blocks: {set(self._ref) - set(held)}"
        # in-flight transfers: fence-before-regrant means the victim still
        # HOLDS its pages (counted above like any live table) and its
        # payload is not yet in the swap tier; pages in flight must match
        # the records exactly
        for r in self._inflight:
            assert r.table.inflight, \
                "in-flight record on a table not marked inflight"
            assert r.table.spill is None, \
                "in-flight record on an already-landed table"
            assert r.pages == min(r.table.used_pages,
                                  len(r.table.blocks)), \
                f"in-flight pages {r.pages} drifted from table " \
                f"{min(r.table.used_pages, len(r.table.blocks))}"
        assert len(held_states) == len(set(held_states)), \
            "live tables share a state slot"
        for d in range(self.n_domains):
            lo = 1 + d * self.blocks_per_domain
            free = self._free_blocks[d]
            assert len(free) == len(set(free)), f"domain {d}: dup free ids"
            assert all(lo <= b < lo + self.blocks_per_domain for b in free), \
                f"domain {d}: free id outside range"
            slo = 1 + d * self.states_per_domain
            sfree = self._free_states[d]
            assert len(sfree) == len(set(sfree)), f"domain {d}: dup states"
            assert all(slo <= s < slo + self.states_per_domain
                       for s in sfree), f"domain {d}: state outside range"
        all_free = [b for f in self._free_blocks for b in f]
        assert not set(held) & set(all_free), "block is both free and held"
        all_sfree = [s for f in self._free_states for s in f]
        assert not set(held_states) & set(all_sfree), \
            "state slot is both free and held"
        assert len(set(held)) + len(all_free) == self.total_blocks(), \
            f"block leak: {len(set(held))} held + {len(all_free)} free " \
            f"!= {self.total_blocks()} total"
        # prefix index: entries point at resident blocks, reverse map is a
        # bijection, checkpoints account exactly
        free_set = set(all_free)
        for key, e in self._prefix.items():
            assert self._entry_of_block.get(e.block) == key, \
                f"prefix entry {key.hex()} reverse map broken"
            assert e.block in held or e.block in free_set, \
                f"prefix entry points at non-resident block {e.block}"
            assert self._block_domain(e.block) == e.domain, \
                f"prefix entry domain mismatch on block {e.block}"
        assert len(self._entry_of_block) == len(self._prefix), \
            "block->key map out of sync with the prefix index"
        ckpts = [e.state_ckpt for e in self._prefix.values()
                 if e.state_ckpt]
        assert len(ckpts) == len(set(ckpts)), "duplicate state checkpoints"
        assert not set(ckpts) & set(all_sfree), \
            "state checkpoint is also free"
        assert not set(ckpts) & set(held_states), \
            "state checkpoint is also held by a table"
        total_states = self.n_domains * self.states_per_domain
        assert len(held_states) + len(all_sfree) + len(ckpts) \
            == total_states, \
            f"state-slot leak: {len(held_states)} held + " \
            f"{len(all_sfree)} free + {len(ckpts)} ckpt " \
            f"!= {total_states} total"

    # -- stats -------------------------------------------------------------
    def stats(self) -> Dict[str, float]:
        snap = self.counters.totals
        fails = snap.get("kv_alloc_failures", 0.0)
        grants = snap.get("kv_reservations", 0.0)
        return {
            "occupancy": self.occupancy(),
            "peak_used_blocks": float(self.peak_used_blocks),
            "peak_used_per_domain": [float(x)
                                     for x in self.peak_used_per_domain],
            "peak_active_tables": float(self.peak_active_tables),
            "total_blocks": float(self.total_blocks()),
            "alloc_failures": fails,
            "park_rate": fails / max(1.0, fails + grants),
            "blocks_migrated": snap.get("kv_blocks_migrated", 0.0),
            "tables_migrated": snap.get("kv_tables_migrated", 0.0),
            "lazy_grows": snap.get("kv_lazy_grows", 0.0),
            "grow_failures": snap.get("kv_grow_failures", 0.0),
            "mid_decode_parks": snap.get("kv_mid_decode_parks", 0.0),
            "prefill_chunks": snap.get("prefill_chunks", 0.0),
            "spills": snap.get("kv_spills", 0.0),
            "spilled_pages": snap.get("kv_spilled_pages", 0.0),
            "restores": snap.get("kv_restores", 0.0),
            "restore_failures": snap.get("kv_restore_failures", 0.0),
            "spill_repoints": snap.get("kv_spill_repoints", 0.0),
            "spilled_tables": float(self.spilled_tables),
            "peak_spilled_bytes": self.peak_spilled_bytes,
            # async transfer engine: issue/poll/fence overlap surface
            "spill_issues": snap.get("kv_spill_issues", 0.0),
            "spill_inflight_pages": float(self.inflight_pages()),
            "spill_inflight_bytes": self.inflight_bytes(),
            "spill_overlap_rounds": snap.get("kv_spill_overlap_rounds",
                                             0.0),
            "fence_waits": snap.get("kv_fence_waits", 0.0),
            "d2h_bytes": snap.get("kv_d2h_bytes", 0.0),
            "h2d_bytes": snap.get("kv_h2d_bytes", 0.0),
            "restore_prefetches": snap.get("kv_restore_prefetches", 0.0),
            "swap_tier": self.swap.stats(),
            "bytes_per_domain": self.domain_bytes(),
            "prefill_chunk_bytes": prefill_chunk_bytes(
                self.cfg, self.block_tokens, self.max_len),
            # prefix sharing: hits/pages are totals, shared/cached are
            # right-now gauges; resident bytes are PHYSICAL (each shared
            # page counted once) vs the logical sum over tables
            "prefix_hits": snap.get("kv_prefix_hits", 0.0),
            "prefix_pages": snap.get("kv_prefix_pages", 0.0),
            "prefill_tokens_skipped": snap.get("prefill_tokens_skipped",
                                               0.0),
            "prefix_pages_published": snap.get("kv_prefix_pages_published",
                                               0.0),
            "cow_forks": snap.get("kv_cow_forks", 0.0),
            "ckpt_reclaims": snap.get("kv_ckpt_reclaims", 0.0),
            "shared_pages": float(self.shared_pages()),
            "shared_extra_refs": float(self.shared_extra_refs()),
            "cached_pages": float(self.cached_pages()),
            # cached-tier retention (access-ordered vs blind)
            "retention": self.retention,
            "cached_page_hits": snap.get("kv_cached_page_hits", 0.0),
            "cached_reclaims": snap.get("kv_cached_reclaims", 0.0),
            # speculative decode rollback traffic (engine-side accept
            # counters live in kv_stats; these are the pool's halves)
            "spec_ckpts": snap.get("kv_spec_ckpts", 0.0),
            "spec_ckpt_pages": snap.get("kv_spec_ckpt_pages", 0.0),
            "spec_rollback_pages": snap.get("kv_spec_rollback_pages", 0.0),
            "shared_bytes": self.shared_bytes(),
            "resident_kv_bytes": self.used_blocks() * self.bytes_per_block(),
            "logical_kv_bytes": (self.used_blocks()
                                 + self.shared_extra_refs())
            * self.bytes_per_block(),
        }
