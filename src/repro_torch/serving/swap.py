"""Host swap tier of the KV pool and the records of its transfers.

``SwapTier``
    Spilled payloads land in PREALLOCATED per-leaf host buffers — pinned
    (page-locked) when the pool lives on a CUDA device, so the device-to-
    host copy is a straight DMA that can run on a side stream — instead
    of a fresh allocation per spill.  A first-fit extent allocator keeps
    each spill's pages contiguous: each buffer holds its leaf with the
    page (or state-slot) axis moved to the front, so a spill's home is one
    contiguous slice a leaf — what an asynchronous copy needs.  When the
    preallocation is full the payload gets host tensors of its own
    (``overflow_allocs`` counts how often: sizing feedback, not an
    error).

``InFlightSpill``
    One issued-but-unlanded device-to-host copy.  ``KVBlockPool.spill_issue``
    snapshots the victim's pages on the compute stream, starts the copy
    into the tier on a side stream and parks one of these in the pool's
    in-flight list; decode ticks keep running while it drains.  The
    victim's pages are re-granted only when the copy has landed — the
    fence-before-regrant invariant.  ``ready()`` is the poll (the copy's
    CUDA event); the pool's ``spill_fence`` is the blocking fence.
"""
from __future__ import annotations

import dataclasses
from typing import Any, List, Optional, Tuple

import torch


@dataclasses.dataclass
class TierHandle:
    """One spill's home in the tier: a contiguous page extent + optional
    state slot, or an overflow allocation."""
    start: int                    # first page of the extent (-1: overflow)
    pages: int
    state_idx: int                # tier state slot (-1: none/overflow)
    raw: List[Any]                # per-leaf contiguous host slices, the
                                  # page axis first (None: leaf unused)
    axes: List[int]               # each leaf's page axis in the pool
    overflow: bool = False

    @property
    def views(self) -> List[Any]:
        """The bytes in the pool's leaf layout (``extract_pool_entries``'s),
        as views of ``raw``."""
        return [None if r is None else r.movedim(0, ax)
                for r, ax in zip(self.raw, self.axes)]


@dataclasses.dataclass
class InFlightSpill:
    """An issued, unlanded spill: the victim table, the tier home its
    bytes are landing in, the event that completes with the copy (None
    on the CPU: the copy was synchronous), and overlap bookkeeping."""
    table: Any
    pages: int
    had_state: bool
    handle: TierHandle
    event: Optional[Any]
    issue_clock: int              # pool poll-clock at issue
    n_bytes: float

    def ready(self) -> bool:
        return self.event is None or self.event.query()

    def wait(self):
        if self.event is not None:
            self.event.synchronize()


class SwapTier:
    """Preallocated host storage for spilled pages + state slots, one
    buffer per pool leaf (``capacity_pages`` pages for token leaves,
    ``capacity_states`` slots for state leaves), the leaf's page or slot
    axis first."""

    def __init__(self, leaves, spec, capacity_pages: int,
                 capacity_states: int):
        self.spec = spec
        self.capacity_pages = int(capacity_pages)
        self.capacity_states = int(capacity_states)
        self.pinned = any(leaf.is_cuda for leaf in leaves)
        self.overflow_allocs = 0
        self._bufs: List[torch.Tensor] = []
        for leaf, s in zip(leaves, spec.leaves):
            ax = s.batch_axis
            n = self.capacity_pages if s.token_axis is not None \
                else self.capacity_states
            shape = (n,) + tuple(leaf.shape[:ax]) + tuple(leaf.shape[ax + 1:])
            self._bufs.append(torch.empty(shape, dtype=leaf.dtype,
                                          pin_memory=self.pinned))
        self._axes = [s.batch_axis for s in spec.leaves]
        self._extents: List[Tuple[int, int]] = [(0, self.capacity_pages)]
        self._free_states: List[int] = list(range(self.capacity_states))

    # -- extent allocator --------------------------------------------------
    def _alloc_extent(self, pages: int) -> int:
        for i, (start, length) in enumerate(self._extents):
            if length >= pages:
                if length == pages:
                    self._extents.pop(i)
                else:
                    self._extents[i] = (start + pages, length - pages)
                return start
        return -1

    def _free_extent(self, start: int, pages: int):
        self._extents.append((start, pages))
        # coalesce neighbours so long runs stay allocatable
        self._extents.sort()
        merged: List[Tuple[int, int]] = []
        for s, n in self._extents:
            if merged and merged[-1][0] + merged[-1][1] == s:
                merged[-1] = (merged[-1][0], merged[-1][1] + n)
            else:
                merged.append((s, n))
        self._extents = merged

    # -- reserve / release ---------------------------------------------------
    def reserve(self, pages: int, had_state: bool) -> TierHandle:
        """A home for a payload of ``pages`` pages (and a state slot with
        ``had_state``): per-leaf contiguous host slices to copy it into,
        None for the leaves it does not carry (token leaves without pages,
        state leaves without a slot)."""
        start = self._alloc_extent(pages) if pages else 0
        state_idx = -1
        if had_state and self._free_states:
            state_idx = self._free_states.pop()
        overflow = (pages and start < 0) or (had_state and state_idx < 0)
        if overflow:
            if start >= 0 and pages:
                self._free_extent(start, pages)
            if state_idx >= 0:
                self._free_states.append(state_idx)
            self.overflow_allocs += 1
            start, state_idx = -1, -1
        raw: List[Any] = []
        for buf, s in zip(self._bufs, self.spec.leaves):
            lo, n = (start, pages) if s.token_axis is not None \
                else (state_idx, 1 if had_state else 0)
            if not n:
                raw.append(None)
            elif overflow:
                raw.append(torch.empty((n,) + tuple(buf.shape[1:]),
                                       dtype=buf.dtype,
                                       pin_memory=self.pinned))
            else:
                raw.append(buf[lo:lo + n])
        return TierHandle(start, pages, state_idx, raw, self._axes,
                          overflow=overflow)

    def release(self, handle: Optional[TierHandle]):
        if handle is None or handle.overflow:
            return
        if handle.pages:
            self._free_extent(handle.start, handle.pages)
        if handle.state_idx >= 0:
            self._free_states.append(handle.state_idx)

    # -- introspection -----------------------------------------------------
    def free_pages(self) -> int:
        return sum(n for _, n in self._extents)

    def stats(self) -> dict:
        return {"capacity_pages": self.capacity_pages,
                "capacity_states": self.capacity_states,
                "free_pages": self.free_pages(),
                "pinned_host": self.pinned,
                "overflow_allocs": self.overflow_allocs}
