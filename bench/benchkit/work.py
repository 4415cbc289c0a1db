"""The yardstick's arithmetic: the card's peaks, the work a model's tokens
need, and the needed work of the ring-chunk attention kernel.

Frozen copies, so that a later change to the program cannot move the
yardstick:

- ``PEAK_BYTES`` / ``PEAK_FLOPS``: ``chip_smoke.py`` (NVIDIA's data sheet,
  H100 SXM: 3.35 TB/s of HBM3, 989 TFLOP/s dense bf16).
- ``ring_work``: ``chip_smoke.ring_work``, in its corrected form: each
  input byte counted once, only the ring slots
  that some active query row can see, QK^T and PV over the visible
  (active row, key) pairs.
- ``decode_bound_s``: ``chip_smoke.decode_bound_s``: every weight but the
  embedding table read once a decode step.

Everything else here counts from the configuration file's published
sizes (``arch``), never from the program.
"""
from __future__ import annotations

from typing import Dict, Iterable, Tuple

import numpy as np

PEAK_BYTES = 3.35e12        # H100 SXM HBM3, data sheet
PEAK_FLOPS = 989e12         # H100 SXM dense bf16 tensor cores, data sheet


def ring_work(torch, ins, mask):
    """Bytes and flops this input needs: q and pos/n_tokens read and the
    output written in full; of the ring and chunk K/V only the slots that
    some active query row (t < n_tokens) can see; QK^T and PV over the
    visible (active row, key) pairs.  ``ins`` is the kernel's argument
    tuple (q, k_new, v_new, k_cache, v_cache, pos, n_tokens); ``mask`` the
    (B, C, W + C) band of visible keys."""
    q, k_new = ins[0], ins[1]
    B, C, Hq, dh = q.shape
    Hkv = k_new.shape[2]
    active = torch.arange(C, device=q.device)[None, :] < ins[6][:, None]
    seen = mask & active[:, :, None]                        # (B, C, W+C)
    n_keys = int(seen.any(dim=1).sum())                     # (stream, slot)
    kv_bytes = 2 * n_keys * Hkv * dh * k_new.element_size()
    n_bytes = (2 * q.numel() * q.element_size() + kv_bytes
               + ins[5].numel() * 4 + ins[6].numel() * 4)
    return n_bytes, 4.0 * dh * Hq * float(seen.sum())


def param_bytes(arch: Dict, itemsize: int = 2) -> int:
    """Bytes of every weight as served (bf16), the output head untied and
    the vocabulary padded to 256 as the program stores it."""
    D, V = arch["hidden_size"], padded_vocab(arch["vocab_size"])
    L = arch["num_hidden_layers"]
    per_layer = attn_params(arch) + ffn_params(arch, held=True) + 2 * D
    return itemsize * (L * per_layer + 2 * V * D + D)


def decode_bound_s(arch: Dict) -> float:
    """Seconds a decode step cannot go below: every weight but the
    embedding table (of which a step gathers a row a stream) read once,
    against the card's memory rate."""
    D = arch["hidden_size"]
    return (param_bytes(arch) - padded_vocab(arch["vocab_size"]) * D * 2) \
        / PEAK_BYTES


def padded_vocab(v: int) -> int:
    return -(-v // 256) * 256


def head_dim(arch: Dict) -> int:
    return arch.get("head_dim") or \
        arch["hidden_size"] // arch["num_attention_heads"]


def attn_params(arch: Dict) -> int:
    D, Hq = arch["hidden_size"], arch["num_attention_heads"]
    Hkv, dh = arch["num_key_value_heads"], head_dim(arch)
    return 2 * D * Hq * dh + 2 * D * Hkv * dh


def ffn_params(arch: Dict, held: bool = False) -> int:
    """Feed-forward weights a token uses (``held``: that the layer holds).
    An MoE token uses its top-k experts and the router; a GLU expert has
    gate, up and down projections."""
    D, F = arch["hidden_size"], arch["intermediate_size"]
    glu = arch["reference"]["activation"] == "swiglu"
    one = (3 if glu else 2) * D * F
    E = arch.get("num_local_experts", 0)
    if not E:
        return one
    return (E if held else arch["num_experts_per_tok"]) * one + D * E


def attended_keys(pos: int, arch: Dict) -> int:
    """Keys the query at absolute position ``pos`` sees (itself included):
    causal, within the sliding window where the model has one."""
    window = arch["reference"].get("window", 0)
    return min(pos + 1, window) if window else pos + 1


def token_flops(pos: int, arch: Dict, logits: bool) -> float:
    """Operations the token at position ``pos`` needs: 2 a weight it uses
    in the layers (never the embedding gather), attention at 4 dh Hq a
    visible (query, key) pair a layer, and the output head when its
    logits are used (the last prompt token and every decode token)."""
    L, D = arch["num_hidden_layers"], arch["hidden_size"]
    Hq, dh = arch["num_attention_heads"], head_dim(arch)
    f = 2.0 * L * (attn_params(arch) + ffn_params(arch))
    f += 4.0 * dh * Hq * L * attended_keys(pos, arch)
    if logits:
        f += 2.0 * D * arch["vocab_size"]
    return f


def span_flops(arch: Dict, prompt_len: int, a: int, b: int) -> float:
    """Operations needed to process positions [a, b) of a stream whose
    prompt has ``prompt_len`` tokens (``token_flops`` summed); positions
    from ``prompt_len - 1`` on produce a token, so their logits count."""
    if b <= a:
        return 0.0
    L, D = arch["num_hidden_layers"], arch["hidden_size"]
    Hq, dh = arch["num_attention_heads"], head_dim(arch)
    window = arch["reference"].get("window", 0)
    keys = np.arange(a + 1, b + 1, dtype=np.float64)
    if window:
        keys = np.minimum(keys, window)
    f = (b - a) * 2.0 * L * (attn_params(arch) + ffn_params(arch))
    f += 4.0 * dh * Hq * L * float(keys.sum())
    f += max(0, b - max(a, prompt_len - 1)) * 2.0 * D * arch["vocab_size"]
    return f


def window_flops(arch: Dict, reqs, a, b) -> float:
    """Operations the tokens processed between snapshots ``a`` and ``b``
    need: each request's positions from where it stood at ``a`` (or its
    shared prefix's end) to where it stood at ``b``."""
    total = 0.0
    for r in reqs:
        end = b.positions.get(r.rid, 0)
        start = max(a.positions.get(r.rid, 0), r.prefix_tokens)
        total += span_flops(arch, r.prompt_len, start, end)
    return total


def window_ring(arch: Dict, reqs, a, b, chunk: int) -> Tuple[float, float]:
    """(bytes, flops) the ring-chunk attention needs for the prefill
    chunks run between snapshots ``a`` and ``b``, over every layer."""
    nb = nf = 0.0
    for r in reqs:
        end = b.positions.get(r.rid, 0)
        start = a.positions.get(r.rid, 0)
        for p, n in prefill_chunks(r.prefix_tokens, start, end,
                                   r.prompt_len, chunk):
            cb, cf = chunk_ring_work(arch, p, n)
            nb += cb
            nf += cf
    L = arch["num_hidden_layers"]
    return nb * L, nf * L


def chunk_ring_work(arch: Dict, p: int, n: int, itemsize: int = 2
                    ) -> Tuple[float, float]:
    """(bytes, flops) one layer's ring-chunk attention needs for one
    stream's chunk of ``n`` active tokens from position ``p``: q read and
    the output written for the active rows, K and V of every key some row
    sees (the ``p`` earlier positions within the window and the chunk's
    own), pos and n_tokens, and 4 dh Hq a visible (row, key) pair.  Equal
    to ``ring_work`` of a one-row launch whose rows are all active."""
    Hq, Hkv, dh = (arch["num_attention_heads"], arch["num_key_value_heads"],
                   head_dim(arch))
    window = arch["reference"].get("window", 0)
    lo = max(0, p - window + 1) if window else 0    # oldest key row 0 sees
    n_keys = p + n - lo
    pairs = sum(attended_keys(p + t, arch) for t in range(n))
    n_bytes = 2 * n * Hq * dh * itemsize + 2 * n_keys * Hkv * dh * itemsize \
        + 8
    return float(n_bytes), 4.0 * dh * Hq * pairs


def prefill_chunks(prefix: int, a: int, b: int, prompt_len: int,
                   chunk: int) -> Iterable[Tuple[int, int]]:
    """The (position, tokens) chunks of prompt positions [a, b) that a
    stream runs, its chunks cut every ``chunk`` tokens from ``prefix``
    (the positions its shared prefix supplied)."""
    a = max(a, prefix)
    b = min(b, prompt_len)
    p = prefix + -(-(a - prefix) // chunk) * chunk if a > prefix else prefix
    while p < b:
        n = min(chunk, prompt_len - p)
        yield p, n
        p += n
