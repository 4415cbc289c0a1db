"""The one traffic generator: a cell file's parameters and a seed -> the
requests of a run.

Every seed gets the same multiset of prompt lengths, output lengths and
gaps between arrivals, in another order: N draws are the distribution's
quantiles at (i + 1/2) / N, shuffled by the seed.  So two seeds differ in
which request is long and in the tokens, not in how much work a run
holds, and a run's spread is the system's and not the sample's.  Token
ids are uniform over the vocabulary; a shared prefix is one of
``count`` seeded prefixes, chosen with Zipf weights (largest-remainder
counts, shuffled).

Open loop: arrivals in three phases, each with a fixed number of requests
(the rate times its length) spread over exactly its length: ``warm``
before the window, ``window`` (the requests measured) and ``cool`` after
it, which keeps the load on while the window's requests drain.
Closed loop: a stream of requests for ``clients`` clients; the first
wave's outputs come from ``first_output``, so that completions are
spread out from the start.
"""
from __future__ import annotations

import dataclasses
import statistics
from typing import Dict, List, Optional

import numpy as np

_NORMAL = statistics.NormalDist()


@dataclasses.dataclass
class Item:
    """One request to submit: ``due`` seconds after the schedule's
    origin (the window's start; open loop only), its prompt and output
    length, and its phase."""
    due: float
    prompt: np.ndarray
    max_new: int
    phase: str
    prefix: int = -1            # shared prefix index, -1 for none


def rng_for(seed: int, stream: int) -> np.random.Generator:
    """Independent generators of one seed (any non-negative integer)."""
    return np.random.Generator(np.random.PCG64([int(seed), int(stream)]))


def quantiles(dist: Dict, n: int) -> np.ndarray:
    """The n stratified draws of ``dist`` (integers), in ascending order."""
    u = (np.arange(n) + 0.5) / n
    kind = dist["dist"]
    if kind == "lognormal":
        z = np.array([_NORMAL.inv_cdf(x) for x in u])
        x = dist["median"] * np.exp(dist["sigma"] * z)
        x = np.rint(x)
    elif kind == "uniform":
        x = dist["min"] + np.floor(u * (dist["max"] - dist["min"] + 1))
    else:
        raise ValueError(f"unknown distribution {kind!r}")
    return np.clip(x, dist["min"], dist["max"]).astype(np.int64)


def draws(dist: Dict, n: int, rng: np.random.Generator) -> np.ndarray:
    return rng.permutation(quantiles(dist, n))


def arrivals(n: int, length: float, rng: np.random.Generator) -> np.ndarray:
    """n Poisson-like arrival offsets in [0, length): stratified
    exponential gaps, shuffled, scaled to sum to ``length``."""
    if n == 0:
        return np.zeros(0)
    u = (np.arange(n) + 0.5) / n
    gaps = rng.permutation(-np.log1p(-u))
    t = np.concatenate([[0.0], np.cumsum(gaps)[:-1]])
    return t * (length / gaps.sum())


def zipf_counts(n: int, k: int, s: float) -> np.ndarray:
    """How many of n requests use each of k items under Zipf(s) weights:
    largest-remainder rounding of n * p."""
    w = 1.0 / np.arange(1, k + 1) ** s
    exact = n * w / w.sum()
    c = np.floor(exact).astype(np.int64)
    for i in np.argsort(-(exact - c), kind="stable")[:n - c.sum()]:
        c[i] += 1
    return c


class Traffic:
    """Requests of one run of a cell: ``open_items(seconds)`` or
    ``next_closed()``."""

    def __init__(self, cell: Dict, seed: int, vocab: int):
        self.cell, self.seed, self.vocab = cell, int(seed), int(vocab)
        self._tok = rng_for(seed, 1)
        sp = cell.get("shared_prefix")
        self.prefixes: List[np.ndarray] = []
        if sp:
            self.prefixes = [self._tokens(sp["tokens"])
                             for _ in range(sp["count"])]
        self._closed_n = 0

    def _tokens(self, n: int) -> np.ndarray:
        return self._tok.integers(0, self.vocab, size=int(n),
                                  dtype=np.int64).astype(np.int32)

    def _phase(self, n: int, start: float, length: float, phase: str,
               stream: int, output: Optional[Dict] = None) -> List[Item]:
        rng = rng_for(self.seed, stream)
        cell = self.cell
        t = start + arrivals(n, length, rng)
        plen = draws(cell["prompt"], n, rng)
        olen = draws(output or cell["output"], n, rng)
        pre = np.full(n, -1)
        sp = cell.get("shared_prefix")
        if sp and n:
            pre = rng.permutation(np.repeat(
                np.arange(sp["count"]),
                zipf_counts(n, sp["count"], sp["zipf_s"])))
        items = []
        for i in range(n):
            body = self._tokens(plen[i])
            prompt = (np.concatenate([self.prefixes[pre[i]], body])
                      if pre[i] >= 0 else body)
            items.append(Item(float(t[i]), prompt, int(olen[i]), phase,
                              int(pre[i])))
        return items

    def open_items(self, seconds: float) -> List[Item]:
        """warm, window and cool requests in due order; the window is
        [0, seconds)."""
        rate, cell = self.cell["rate_per_s"], self.cell
        warm, cool = cell["warmup_s"], cell["drain_s"]
        out = (self._phase(round(rate * warm), -warm, warm, "warm", 2)
               + self._phase(round(rate * seconds), 0.0, seconds, "window",
                             3)
               + self._phase(round(rate * cool), seconds, cool, "cool", 4))
        return sorted(out, key=lambda it: it.due)

    def first_wave(self) -> List[Item]:
        """The closed loop's first request of each client."""
        n = self.cell["clients"]
        return self._phase(n, 0.0, 0.0, "warm", 5,
                           output=self.cell.get("first_output"))

    def next_closed(self) -> Item:
        """The closed loop's next request, drawn from blocks of 256 of the
        stratified mix (a fresh shuffle a block)."""
        k, i = divmod(self._closed_n, 256)
        if i == 0:
            self._block = self._phase(256, 0.0, 0.0, "closed", 100 + k)
        self._closed_n += 1
        return self._block[i]

