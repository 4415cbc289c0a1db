"""Draft-token proposers for speculative decoding.

The engine's speculative path is drafter-agnostic: anything with a
``draft(req, k) -> list[int]`` method can propose up to k tokens for a
decode stream, and the verify-in-one-forward + greedy-acceptance machinery
guarantees token identity with non-speculative decoding regardless of
what the drafter returns (a bad drafter only wastes work, never changes
output).  The default is a prompt-lookup n-gram drafter over the stream's
OWN committed tokens — zero extra model state, surprisingly effective on
repetitive continuations — structured so a small draft model from
``configs/`` can slot in behind the same protocol later (a model drafter
would carry per-stream cache state keyed off ``req``, which is why the
protocol takes the request rather than a bare token list).
"""
from __future__ import annotations

from typing import List, Protocol


class Drafter(Protocol):
    def draft(self, req, k: int) -> List[int]:
        """Propose up to k tokens to follow ``req.prompt + req.generated``.

        May return fewer than k (or none).  Proposals are suggestions
        only — the engine verifies every one through the fused chunk
        forward and keeps just the greedy-matching prefix."""
        ...


class NGramDrafter:
    """Prompt-lookup drafting: find the most recent earlier occurrence of
    the committed stream's trailing n-gram and propose the tokens that
    followed it.  Tries the longest configured n-gram first (longer
    matches are more trustworthy), falling back to shorter ones; no match
    means no draft, and the tick decays to a plain single-token decode.
    """

    def __init__(self, max_ngram: int = 3, min_ngram: int = 1):
        if not 1 <= min_ngram <= max_ngram:
            raise ValueError("need 1 <= min_ngram <= max_ngram")
        self.max_ngram = max_ngram
        self.min_ngram = min_ngram

    def draft(self, req, k: int) -> List[int]:
        committed = list(req.prompt) + list(req.generated)
        n_c = len(committed)
        for n in range(min(self.max_ngram, n_c - 1), self.min_ngram - 1, -1):
            tail = committed[n_c - n:]
            # most recent prior occurrence: scan right-to-left, excluding
            # the trailing match itself
            for s in range(n_c - n - 1, -1, -1):
                if committed[s:s + n] == tail:
                    return committed[s + n:s + n + k]
        return []


def make_drafter(kind: str, *, ngram: int = 3) -> Drafter:
    """Drafter registry.  "ngram" is the only built-in today; a "model"
    kind backed by a small config from ``configs/`` is the intended next
    entry (same protocol, per-stream KV state)."""
    if kind == "ngram":
        return NGramDrafter(max_ngram=ngram)
    raise ValueError(f"unknown drafter kind {kind!r}")
