"""Host swap tier of the KV pool: preallocated host buffers for spilled
pages (the synchronous path).

Spilled payloads land in PREALLOCATED per-leaf host buffers — pinned
(page-locked) when the pool lives on a CUDA device, so the device-to-host
copy is a straight DMA — instead of a fresh allocation per spill.  A
first-fit extent allocator keeps each spill's pages contiguous, so a
landed spill is one slice view per leaf; when the preallocation is full
the payload keeps a plain host copy (``overflow_allocs`` counts how
often: sizing feedback, not an error).
"""
from __future__ import annotations

import dataclasses
from typing import Any, List, Optional, Tuple

import torch


@dataclasses.dataclass
class TierHandle:
    """One landed spill's home in the tier: a contiguous page extent +
    optional state slot, or an overflow allocation."""
    start: int                    # first page of the extent (-1: overflow)
    pages: int
    state_idx: int                # tier state slot (-1: none/overflow)
    views: List[Any]              # per-leaf host tensors holding the bytes
    overflow: bool = False


class SwapTier:
    """Preallocated host storage for spilled pages + state slots, one
    buffer per pool leaf (``capacity_pages`` pages for token leaves,
    ``capacity_states`` slots for state leaves)."""

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
            shape = tuple(leaf.shape[:ax]) + (n,) + tuple(leaf.shape[ax + 1:])
            self._bufs.append(torch.empty(shape, dtype=leaf.dtype,
                                          pin_memory=self.pinned))
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

    # -- store / release ---------------------------------------------------
    def store(self, leaves: List[Any], pages: int,
              had_state: bool) -> TierHandle:
        """Copy a gathered payload (device or host tensors, one per leaf,
        None where a leaf carries nothing) into the tier and wait for the
        copy; returns the handle whose ``views`` hold the bytes."""
        start = self._alloc_extent(pages) if pages else 0
        state_idx = -1
        if had_state and self._free_states:
            state_idx = self._free_states.pop()
        if (pages and start < 0) or (had_state and state_idx < 0):
            if start >= 0 and pages:
                self._free_extent(start, pages)
            if state_idx >= 0:
                self._free_states.append(state_idx)
            self.overflow_allocs += 1
            views = [x.to("cpu") if x is not None else None for x in leaves]
            return TierHandle(-1, pages, -1, views, overflow=True)
        views: List[Any] = []
        for buf, x, s in zip(self._bufs, leaves, self.spec.leaves):
            if x is None:
                views.append(None)
                continue
            lo, n = (start, pages) if s.token_axis is not None \
                else (state_idx, 1)
            view = buf.narrow(s.batch_axis, lo, n)
            view.copy_(x)           # blocking: the bytes are home on return
            views.append(view)
        return TierHandle(start, pages, state_idx, views)

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
