"""The kernel wrappers' dry branch: fake tensors, which hold no data.

A ``FakeTensor`` (``torch._subclasses.fake_tensor``) has a shape, a type
and a device but no memory.  The dry run (``launch/dryrun.py``) traces
the port's step functions on such tensors to count their work and memory
without a card.  Each wrapper of a hand-written kernel checks its inputs
as for a launch, takes the route a real tensor of that type would take on
the card (a fake tensor on ``meta``, where PyTorch has no CUDA, counts as
the card's), makes its outputs and workspaces empty and hands the
kernel's needed work to ``note`` in place of the call into its library:
no pointer is read, no stream is touched and nothing is built.  A dry
launch is counted by the sinks, never in the wrapper's ``launches``,
which counts the card's launches only.  A real tensor on ``meta`` (or any
device but the CPU and ``cuda``) is no dry tensor: the wrappers raise.

``note(name, n_bytes, flops)`` passes one launch's needed work to every
sink registered with ``sinks`` (the dry run's counting context,
``launch.trace_analysis.Trace``); with none registered it does nothing.
"""
from __future__ import annotations

import contextlib
from typing import Callable, List

import torch
from torch._subclasses.fake_tensor import FakeTensor

_SINKS: List[Callable[[str, float, float], None]] = []   # (name, bytes, flops)


def is_dry(t: torch.Tensor) -> bool:
    """Whether ``t`` is a fake tensor (the dry run's)."""
    return isinstance(t, FakeTensor)


def on_card(t: torch.Tensor) -> bool:
    """Whether ``t`` takes the card's routes: on ``cuda``, or on ``meta``
    (the dry run's trace of the card's routes where PyTorch has no
    CUDA)."""
    return t.device.type in ("cuda", "meta")


def note(name: str, n_bytes: float, flops: float):
    """One dry launch of kernel ``name`` that moves ``n_bytes`` bytes and
    needs ``flops`` operations."""
    for sink in _SINKS:
        sink(name, float(n_bytes), float(flops))


@contextlib.contextmanager
def sinks(fn: Callable[[str, float, float], None]):
    """Registers ``fn`` to receive every ``note`` while the block runs."""
    _SINKS.append(fn)
    try:
        yield fn
    finally:
        _SINKS.remove(fn)
