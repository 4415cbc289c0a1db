"""Fault tolerance primitives: heartbeats, failure injection, stragglers.

On a real fleet each host runs a ``HeartbeatMonitor`` against the job
coordinator; a missed beat triggers checkpoint-restart on the survivors
(see ``runtime.elastic``).  In this single-process repo the same objects are
driven by tests/benchmarks with injected failures and injected slowness.

A copy of the JAX package's ``runtime/failure.py`` (plain Python).
"""
from __future__ import annotations

import dataclasses
import threading
import time
from typing import Callable, Dict, List, Optional


class SimulatedFailure(RuntimeError):
    """Raised by FailureInjector at the configured step (host crash)."""


class FailureInjector:
    def __init__(self, fail_at_step: Optional[int] = None,
                 fail_host: int = 0):
        self.fail_at_step = fail_at_step
        self.fail_host = fail_host
        self.fired = False

    def check(self, step: int, host: int = 0):
        if (self.fail_at_step is not None and not self.fired
                and step >= self.fail_at_step and host == self.fail_host):
            self.fired = True
            raise SimulatedFailure(
                f"injected failure: host {host} died at step {step}")


class HeartbeatMonitor:
    """Tracks per-host beats; calls ``on_dead(host)`` after ``timeout``."""

    def __init__(self, hosts: List[int], timeout: float = 5.0,
                 on_dead: Optional[Callable[[int], None]] = None,
                 clock=time.monotonic):
        self._clock = clock
        self.timeout = timeout
        self.on_dead = on_dead
        self.last_beat: Dict[int, float] = {h: clock() for h in hosts}
        self.dead: List[int] = []
        self._lock = threading.Lock()

    def beat(self, host: int):
        with self._lock:
            self.last_beat[host] = self._clock()

    def check(self) -> List[int]:
        now = self._clock()
        newly_dead = []
        with self._lock:
            for h, t in self.last_beat.items():
                if h not in self.dead and now - t > self.timeout:
                    self.dead.append(h)
                    newly_dead.append(h)
        for h in newly_dead:
            if self.on_dead:
                self.on_dead(h)
        return newly_dead


@dataclasses.dataclass
class StragglerDetector:
    """Flags steps slower than ``factor`` x running median.

    The ARCAS controller treats a persistent straggler group like a
    high-remote-access condition: migrate work off it (relayout /
    elastic downscale).
    """
    factor: float = 2.0
    window: int = 32
    min_samples: int = 5

    def __post_init__(self):
        self.samples: List[float] = []
        self.events: List[int] = []
        self._step = 0

    def observe(self, step_time: float) -> bool:
        self._step += 1
        self.samples.append(step_time)
        if len(self.samples) > self.window:
            self.samples.pop(0)
        if len(self.samples) < self.min_samples:
            return False
        med = sorted(self.samples)[len(self.samples) // 2]
        if step_time > self.factor * med:
            self.events.append(self._step)
            return True
        return False
