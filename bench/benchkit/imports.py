"""The check that nothing of JAX, or the JAX package, is loaded.

Module names are compared by their top-level name whole (the part before
the first dot): ``repro_torch`` is the port and passes; ``repro`` (the
JAX package), ``jax``, ``jaxlib`` and ``flax`` fail.
"""
from __future__ import annotations

from typing import Iterable, List

FORBIDDEN = frozenset({"jax", "jaxlib", "flax", "repro"})


def top(name: str) -> str:
    return name.split(".", 1)[0]


def forbidden(names: Iterable[str]) -> List[str]:
    """The module names among ``names`` whose top-level name is
    forbidden."""
    return sorted(n for n in names if top(n) in FORBIDDEN)
