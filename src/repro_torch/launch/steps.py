"""Step factories: the train and eval steps, and the serving engine's.

Each factory closes over the model config (and the cache layout or the
optimizer config) and returns a plain callable: the port runs eagerly, so
there is no ``jit`` and nothing to donate — the train step updates the
parameters and optimizer state in place, the storage-writing serving
steps update the pool in place, and each returns what it updated.
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import decode as dec
from repro_torch.models import transformer as T
from repro_torch.models.params import STACKED, tree_map
from repro_torch.optim.adamw import AdamWConfig, adamw_update


def _grad_tree(cfg: ModelConfig, params):
    """(tree to differentiate, gradient buffers).  Every leaf becomes a
    detached leaf view of its storage whose ``.grad`` is preset to a zero
    buffer, so backward accumulates straight into the buffer; the stacked
    layer (or hybrid group, or encoder and decoder layer) leaves become a
    list of per-layer dicts of views whose grads are the matching slices
    of one stacked buffer.
    (Slicing a stacked leaf that requires grad would instead make every
    layer's backward write a full-size zero tensor.)"""

    def walk(p, g):
        if isinstance(p, dict):
            return {k: walk(p[k], g[k]) for k in p}
        view = p.detach().requires_grad_(True)
        view.grad = g
        return view

    def stack_len(tree):
        while isinstance(tree, dict):
            tree = next(iter(tree.values()))
        return tree.shape[0]

    grads = tree_map(torch.zeros_like, params)
    tree = {}
    for k, v in params.items():
        if k in STACKED:
            tree[k] = [walk(T.layer_params(v, i),
                            T.layer_params(grads[k], i))
                       for i in range(stack_len(v))]
        else:
            tree[k] = walk(v, grads[k])
    return tree, grads


def value_and_grad(cfg: ModelConfig, params, batch):
    """``loss_fn``'s value and its gradient for every parameter leaf:
    (loss, {"ce", "aux"}, grads shaped like params, in the params'
    types)."""
    tree, grads = _grad_tree(cfg, params)
    loss, parts = T.loss_fn(tree, cfg, batch)
    loss.backward()
    return loss.detach(), {k: v.detach() for k, v in parts.items()}, grads


def make_train_step(cfg: ModelConfig, opt_cfg: AdamWConfig,
                    grad_transform=None, microbatches: int = 1,
                    opt_impl: str = "adamw", ef_transform=None):
    """(params, opt_state, batch) -> (params', opt_state', metrics), the
    first two updated in place; metrics ``loss, ce, aux, grad_norm, lr``
    as 0-d tensors on the device.

    ``microbatches > 1`` splits the batch (microbatch j takes rows j,
    j + m, ..., as the JAX reshape does: ``_microbatch``) and accumulates
    the gradients in float32; the optimizer sees their mean.
    ``grad_transform`` hooks in a stateless gradient transform."""
    if opt_impl == "adamw8bit":
        raise NotImplementedError("the 8-bit AdamW (optim/quantized.py) is "
                                  "not ported yet (ROADMAP A item 10)")
    if opt_impl != "adamw":
        raise ValueError(f"unknown opt_impl {opt_impl!r}")
    if ef_transform is not None:
        raise NotImplementedError("error-feedback gradient compression "
                                  "(compression/) is not ported yet "
                                  "(ROADMAP A item 10)")

    def train_step(params, opt_state, batch):
        if microbatches == 1:
            loss, parts, grads = value_and_grad(cfg, params, batch)
        else:
            m = microbatches
            grads = tree_map(lambda p: torch.zeros(
                p.shape, dtype=torch.float32, device=p.device), params)
            loss = ce = aux = 0.0
            for j in range(m):
                l, p, g = value_and_grad(cfg, params,
                                         _microbatch(batch, j, m))
                _tree_zip(lambda a, b: a.add_(b), grads, g)
                loss, ce, aux = loss + l, ce + p["ce"], aux + p["aux"]
                del g
            grads = tree_map(lambda x: x.div_(m), grads)
            loss, parts = loss / m, {"ce": ce / m, "aux": aux / m}
        if grad_transform is not None:
            grads = grad_transform(grads)
        params, opt_state, om = adamw_update(grads, opt_state, params,
                                             opt_cfg)
        metrics = {"loss": loss, "ce": parts["ce"], "aux": parts["aux"],
                   **om}
        return params, opt_state, metrics

    return train_step


def _microbatch(batch, j: int, m: int):
    """Microbatch ``j`` of ``m``: rows j, j + m, ... of every batch tensor
    (the batch axis of M-RoPE's ``position_ids`` (3, B, S) is its
    second)."""
    return {k: v[:, j::m] if k == "position_ids" else v[j::m]
            for k, v in batch.items()}


def _tree_zip(fn, a, b):
    if isinstance(a, dict):
        for k in a:
            _tree_zip(fn, a[k], b[k])
    else:
        fn(a, b)


def make_eval_step(cfg: ModelConfig):
    """(params, batch) -> {"loss", "ce", "aux"}, without gradients."""

    @torch.no_grad()
    def eval_step(params, batch):
        loss, parts = T.loss_fn(params, cfg, batch)
        return {"loss": loss, **parts}

    return eval_step


def make_prefill(cfg: ModelConfig, max_len: int):
    """(params, batch) -> (last-token logits (B, V), cache): whole-prompt
    prefill of ``batch["tokens"]`` (B, S) into a decode cache of capacity
    ``max_len``; every other key of ``batch`` goes to ``decode.prefill``
    as its extras (a VLM's ``vision_embeds`` and ``position_ids``, an
    encoder-decoder model's ``frame_embeds``)."""

    def serve_prefill(params, batch):
        extras = {k: v for k, v in batch.items() if k != "tokens"}
        return dec.prefill(params, cfg, batch["tokens"], extras,
                           max_len=max_len)

    return serve_prefill


def make_serve_step(cfg: ModelConfig):
    """(params, cache, tokens, pos[, extras]) -> (logits, cache')."""

    def serve_step(params, cache, tokens, pos, extras=None):
        return dec.decode_step(params, cfg, cache, tokens, pos, extras)

    return serve_step


def _check_chunk_mode(mode: str, chunk_kernel: str):
    if mode not in ("scan", "parallel"):
        raise ValueError(f"unknown chunk-step mode {mode!r}")
    if chunk_kernel not in ("dense", "blocked"):
        raise ValueError(f"unknown chunk kernel {chunk_kernel!r}")


def make_serve_chunk_step(cfg: ModelConfig, spec, mode: str = "scan",
                          chunk_kernel: str = "dense"):
    """(params, cache, tokens (B, C), pos, n_tokens[, extras]) ->
    (last-active-token logits, cache').  The continuous-batching mixed
    step: prefill chunks and decode streams share one batched call with
    per-stream lengths.  ``mode="scan"`` (the default, as in the JAX
    package) is the per-token reference, C single-token steps
    (``chunk_decode_step``); ``mode="parallel"`` one fused multi-token
    forward per tick, whose attention ``chunk_kernel`` picks: "blocked"
    (the CUDA kernel on the card) or "dense" (the plain masked softmax).
    The scan path ignores ``chunk_kernel``."""
    _check_chunk_mode(mode, chunk_kernel)

    def serve_chunk_step(params, cache, tokens, pos, n_tokens, extras=None):
        if mode == "parallel":
            return dec.prefill_chunk_step(params, cfg, spec, cache, tokens,
                                          pos, n_tokens, extras,
                                          chunk_kernel=chunk_kernel)
        return dec.chunk_decode_step(params, cfg, spec, cache, tokens, pos,
                                     n_tokens, extras)

    return serve_chunk_step


def make_spec_verify_step(cfg: ModelConfig, spec, mode: str = "scan",
                          chunk_kernel: str = "dense"):
    """(params, cache, tokens (B, C), pos, n_tokens[, extras]) ->
    (per-position logits (B, C, V), cache').  The speculative-decode
    VERIFY step: the masked chunk step of ``make_serve_chunk_step`` (same
    ``mode`` and ``chunk_kernel``) returning the logits after EVERY fed
    token, so greedy acceptance can compare each draft token with the
    argmax one position earlier.  Positions at or past ``n_tokens`` come
    back NEG_INF."""
    _check_chunk_mode(mode, chunk_kernel)

    def spec_verify_step(params, cache, tokens, pos, n_tokens, extras=None):
        if mode == "parallel":
            return dec.prefill_chunk_step(params, cfg, spec, cache, tokens,
                                          pos, n_tokens, extras,
                                          chunk_kernel=chunk_kernel,
                                          all_logits=True)
        return dec.chunk_decode_step(params, cfg, spec, cache, tokens, pos,
                                     n_tokens, extras, all_logits=True)

    return spec_verify_step


def make_spill_gather_async(spec):
    """(storage, blocks, state_slot, out, stream) -> event: the issue half
    of an asynchronous spill.  The pages are snapshotted on the current
    stream and copied into the host tensors ``out`` on ``stream``; the
    returned event completes when they have landed (None on the CPU, where
    the copy is done on return)."""

    def spill_gather_async(storage, blocks, state_slot=None, *, out,
                           stream=None):
        return dec.extract_pool_entries_async(storage, spec, blocks,
                                              state_slot=state_slot,
                                              out=out, stream=stream)

    return spill_gather_async


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


def make_generate(cfg: ModelConfig, steps: int, temperature: float = 0.0):
    """(params, cache, tokens (B, 1), pos (B,), generator) -> (tokens (B,
    steps), cache', pos'): ``steps`` single-token steps from the last
    token, each feeding back its greedy token (``temperature == 0``) or
    one drawn from softmax(logits / temperature) with the
    ``torch.Generator`` ``generator`` (which may be None when greedy).
    The cache is written in place."""
    serve_step = make_serve_step(cfg)

    @torch.no_grad()
    def generate(params, cache, tokens, pos, generator=None):
        out = []
        tok, pos = tokens, pos
        for _ in range(steps):
            logits, cache = serve_step(params, cache, tok, pos)
            if temperature > 0:
                probs = torch.softmax(logits / temperature, dim=-1)
                nxt = torch.multinomial(probs, 1, generator=generator)
            else:
                nxt = logits.argmax(dim=-1, keepdim=True)
            tok = nxt.to(torch.int32)
            out.append(tok[:, 0])
            pos = pos + 1
        return torch.stack(out, dim=1), cache, pos

    return generate
