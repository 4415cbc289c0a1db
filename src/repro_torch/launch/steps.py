"""Step factories for the serving engine.

Each factory closes over the model config (and the cache layout) and
returns a plain callable: the port runs eagerly, so there is no ``jit``
and nothing to donate — the storage-writing steps update the pool in place
and return it.
"""
from __future__ import annotations

from repro_torch.configs.base import ModelConfig
from repro_torch.models import decode as dec


def make_serve_step(cfg: ModelConfig):
    """(params, cache, tokens, pos) -> (logits, cache')."""

    def serve_step(params, cache, tokens, pos):
        return dec.decode_step(params, cfg, cache, tokens, pos)

    return serve_step


def make_serve_chunk_step(cfg: ModelConfig, spec, mode: str = "parallel",
                          chunk_kernel: str = "blocked"):
    """(params, cache, tokens (B, C), pos, n_tokens) -> (last-active-token
    logits, cache').  The continuous-batching mixed step: prefill chunks
    and decode streams share one batched call with per-stream lengths.
    ``mode="parallel"`` is one fused multi-token forward per tick;
    ``chunk_kernel`` picks its attention: "blocked" (the CUDA kernel on
    the card) or "dense" (the plain masked softmax)."""
    if mode == "scan":
        raise NotImplementedError("the per-token scan chunk step "
                                  "(chunk_decode_step) is not ported yet "
                                  "(ROADMAP A3)")
    if mode != "parallel":
        raise ValueError(f"unknown chunk-step mode {mode!r}")
    if chunk_kernel not in ("dense", "blocked"):
        raise ValueError(f"unknown chunk kernel {chunk_kernel!r}")

    def serve_chunk_step(params, cache, tokens, pos, n_tokens):
        return dec.prefill_chunk_step(params, cfg, spec, cache, tokens, pos,
                                      n_tokens, chunk_kernel=chunk_kernel)

    return serve_chunk_step


def make_spill_gather(spec):
    """(storage, blocks, state_slot) -> per-leaf device tensors: a stream's
    used pages (and state slot), the device half of a swap-tier spill."""

    def spill_gather(storage, blocks, state_slot=None):
        return dec.extract_pool_entries(storage, spec, blocks,
                                        state_slot=state_slot)

    return spill_gather


def make_spill_scatter(spec):
    """(storage, blocks, host_leaves, state_slot) -> storage: writes
    spilled pages back into a fresh reservation's blocks."""

    def spill_scatter(storage, blocks, host_leaves, state_slot=None):
        return dec.insert_pool_entries(storage, spec, blocks, host_leaves,
                                       state_slot=state_slot)

    return spill_scatter


def make_rows_gather(spec):
    """(storage, blocks, state_slots) -> per-leaf device tensors: one
    batched gather of many streams' pages + state slots."""

    def rows_gather(storage, blocks, state_slots=()):
        return dec.gather_pool_rows(storage, spec, blocks,
                                    state_slots=state_slots)

    return rows_gather


def make_rows_scatter(spec):
    """(storage, blocks, leaves, state_slots) -> storage: inverse of
    ``make_rows_gather``."""

    def rows_scatter(storage, blocks, leaves, state_slots=()):
        return dec.scatter_pool_rows(storage, spec, blocks, leaves,
                                     state_slots=state_slots)

    return rows_scatter


def make_prefix_fork(spec):
    """(storage, src_blocks, dst_blocks[, src_state, dst_state]) ->
    storage: the copy behind prefix-sharing copy-on-write — duplicate a
    shared page into a private block, and/or fork (``src_state`` > 0) or
    scrub (``src_state == 0``) a carried-state slot."""

    def prefix_fork(storage, src_blocks, dst_blocks,
                    src_state=None, dst_state=None):
        if not src_blocks and src_state is not None:
            if src_state == 0:          # no donor: scrub to the init state
                return dec.zero_state_slot(storage, spec, dst_state)
            return dec.fork_state_slot(storage, spec, src_state, dst_state)
        return dec.copy_pool_entries(storage, spec, src_blocks, dst_blocks,
                                     src_state=src_state,
                                     dst_state=dst_state)

    return prefix_fork
