"""The ARCAS developer API (paper §4.6), faithful surface:

    ARCAS_Init() / ARCAS_Finalize()
    run(fn)              — spawn a coroutine task
    all_do(fn)           — execute a task on every worker ("all cores")
    call(group, fn)      — remote procedure call to a chiplet group
                           (sync or async)
    barrier()            — coordinate task completion across groups

Backed by the port's coroutine runtime (``repro_torch.core.tasks``, whose
``TaskRuntime`` keeps the counters) on a ``repro_torch.core.topology``
fleet: the JAX package's ``core/api.py`` on the port's own modules.
"""
from __future__ import annotations

import types
from typing import Any, Callable, Generator, List, Optional

from repro_torch.core.tasks import Task, TaskRuntime
from repro_torch.core.topology import ChipletTopology, production_topology

_RUNTIME: Optional[TaskRuntime] = None
_TOPOLOGY: Optional[ChipletTopology] = None


def _as_gen(fn: Callable) -> Generator:
    """Wrap a plain callable into a single-yield coroutine."""
    if isinstance(fn, types.GeneratorType):
        return fn
    def gen():
        yield
        return fn()
    return gen()


def ARCAS_Init(topology: Optional[ChipletTopology] = None,
               workers_per_group: int = 1, seed: int = 0) -> TaskRuntime:
    global _RUNTIME, _TOPOLOGY
    _TOPOLOGY = topology or production_topology()
    _RUNTIME = TaskRuntime(
        n_pods=_TOPOLOGY.n_pods, groups_per_pod=_TOPOLOGY.groups_per_pod,
        workers_per_group=workers_per_group, seed=seed)
    return _RUNTIME


def ARCAS_Finalize():
    global _RUNTIME, _TOPOLOGY
    if _RUNTIME is not None:
        _RUNTIME.barrier()
    _RUNTIME, _TOPOLOGY = None, None


def _rt() -> TaskRuntime:
    if _RUNTIME is None:
        raise RuntimeError("call ARCAS_Init() first")
    return _RUNTIME


def run(fn: Callable | Generator, *, group: Optional[int] = None,
        name: str = "") -> Task:
    return _rt().spawn(_as_gen(fn), group=group, name=name)


def all_do(fn: Callable[[int], Any]) -> List[Task]:
    """Execute ``fn(worker_group)`` on every worker."""
    return [_rt().spawn(_as_gen(lambda g=w.group: fn(g)), group=w.group)
            for w in _rt().workers]


def call(group: int, fn: Callable, *, sync: bool = True) -> Any:
    """RPC to a chiplet group; sync returns the result."""
    task = _rt().spawn(_as_gen(fn), group=group)
    if sync:
        _rt().barrier()
        return task.result
    return task


def barrier():
    _rt().barrier()
