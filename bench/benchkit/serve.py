"""One run of a serving cell: the port's ``ServeEngine`` built from the
configuration file, warmed, driven by the cell's traffic, and read
between ticks.

The client.  Requests are submitted by the host clock, so a request's
latency runs from when it was due, and the client's lateness (submitted
minus due) is recorded.  The client runs at the engine scheduler's yield
points, as the task runtime's ``profile_hook`` (called after every task
step): it submits every request that is due and takes the run's
snapshots there, between the engine's ticks, which are synchronous.  A
task of its own would not do: a worker runs its highest-priority task
each round and the engine's group tasks never park, so a client task
either starves a group or never runs.  When the engine runs out of work,
``run_until_done`` returns; the client sleeps until its next request is
due, submits it and starts the engine again.  When the window has closed
and its requests are done (the open loop: or the drain limit has passed),
the client raises ``StopRun`` out of the engine's run: nothing in flight
outlives it but host bookkeeping.
"""
from __future__ import annotations

import dataclasses
import gc
import time
from typing import Dict, List

from benchkit import work
from benchkit.record import Req, Snap

TRACE_S = 3.0       # the traced stretch, at the window's end (--trace 1)


class StopRun(Exception):
    """Raised by the client to end the engine's run."""


def port_config(arch: Dict):
    """The port's ModelConfig for the configuration file, checked against
    the file's published sizes."""
    from repro_torch.configs import REGISTRY
    port = arch["port"]
    cfg = dataclasses.replace(REGISTRY[port["arch"]], **port["overrides"])
    want = {"d_model": arch["hidden_size"], "d_ff": arch["intermediate_size"],
            "n_heads": arch["num_attention_heads"],
            "n_kv_heads": arch["num_key_value_heads"],
            "n_layers": arch["num_hidden_layers"],
            "vocab": arch["vocab_size"], "head_dim": work.head_dim(arch),
            "rope_theta": float(arch["rope_theta"]),
            "n_experts": arch.get("num_local_experts", 0),
            "top_k": arch.get("num_experts_per_tok", 0),
            "norm_eps": arch["reference"]["norm_eps"],
            "window": arch["reference"].get("window", 0)}
    got = {k: getattr(cfg, k) for k in want}
    if got != want:
        bad = {k: (got[k], want[k]) for k in want if got[k] != want[k]}
        raise ValueError(f"{arch['name']}: the port's config differs from "
                         f"the configuration file (port, file): {bad}")
    act = {"gelu_tanh": "gelu", "swiglu": "swiglu"}[
        arch["reference"]["activation"]]
    if cfg.activation != act or cfg.tie_embeddings:
        raise ValueError(f"{arch['name']}: the port runs activation "
                         f"{cfg.activation!r}, tied {cfg.tie_embeddings}")
    return cfg


def build_engine(torch, arch: Dict, params, device):
    from repro_torch.core.topology import ChipletTopology
    from repro_torch.models.params import param_shapes
    from repro_torch.serving.engine import EngineConfig, ServeEngine
    from benchkit import weights
    cfg = port_config(arch)
    mine = {p: tuple(t.shape) for p, t in weights.leaves(params)}
    if mine != dict(param_shapes(cfg)):
        raise ValueError(f"{arch['name']}: the benchmark's weight tree is "
                         "not the port's layout")
    e = dict(arch["engine"])
    topo = ChipletTopology(n_pods=1, groups_per_pod=e.pop("groups"),
                           chips_per_group=1)
    return ServeEngine(cfg, topo, EngineConfig(**e), params=params,
                       device=device)


def progress(req, block: int) -> int:
    """Positions of ``req`` whose keys and values are in the cache: the
    prompt pages written while it is in prefill (a chunk is one page of
    ``block`` tokens), then the prompt and every served token but the
    last."""
    if req.t_first is None:
        return 0 if req.table is None else req.table.used_pages * block
    return len(req.prompt) + len(req.generated) - 1


class Client:
    """Submits the cell's traffic and takes the snapshots of a run."""

    def __init__(self, eng, cell: Dict, traffic, seconds: float,
                 trace: bool, profiler_factory=None):
        self.eng, self.cell = eng, cell
        self.traffic, self.seconds = traffic, seconds
        self.clock = time.monotonic
        self.open_loop = cell["loop"] == "open"
        self.items: List = []
        self.reqs: List = []            # (Request, Item, due)
        self.t0 = self.t1 = None
        self.snaps: Dict[str, Snap] = {}
        self.trace = trace
        self.profiler_factory = profiler_factory
        self.prof = None
        self.t_stop = None
        self.block = eng.pool.block_tokens

    def start(self):
        now = self.clock()
        self.base = now + self.cell["warmup_s"]
        if self.open_loop:
            self.items = self.traffic.open_items(self.seconds)
            self.next = 0
        else:
            self.clients = [self._submit(it, now)
                            for it in self.traffic.first_wave()]
        self.trace_at = self.base + max(
            0.0, self.seconds - TRACE_S)
        self.eng.runtime.profile_hook = self.hook

    def hook(self, _task):
        self._round()

    def idle(self):
        """The engine has no work: wait for the next request and submit
        it (the open loop), or stop."""
        if self.open_loop and self.next < len(self.items):
            wait = self.base + self.items[self.next].due - self.clock()
            if wait > 0:
                time.sleep(wait)
        self._round()

    # -- one round ---------------------------------------------------------
    def _submit(self, item, due: float):
        req = self.eng.submit(item.prompt, item.max_new)
        self.reqs.append((req, item, due))
        return req

    def snap(self) -> Snap:
        eng = self.eng
        return Snap(self.clock(), dict(eng.counters.totals),
                    dict(eng.graph_replays()),
                    {r.rid: progress(r, self.block) for r, _, _ in self.reqs},
                    {r.rid: len(r.generated) for r, _, _ in self.reqs})

    def _round(self):
        now = self.clock()
        if self.open_loop:
            while (self.next < len(self.items)
                   and self.base + self.items[self.next].due <= now):
                it = self.items[self.next]
                self._submit(it, self.base + it.due)
                self.next += 1
        elif self.t1 is None:
            for k, r in enumerate(self.clients):
                if r.done:
                    self.clients[k] = self._submit(
                        self.traffic.next_closed(), now)
        if self.t0 is None and now >= self.base:
            self.t0 = now
            self.snaps["open"] = self.snap()
        # the traced stretch runs from after the profiler's start to
        # before its stop (which parses the trace), at the window's end
        if self.trace and self.prof is None and now >= self.trace_at:
            self.prof = self.profiler_factory()
            self.prof.start()
            self.snaps["trace_start"] = self.snap()
        elif (self.prof is not None and "trace_stop" not in self.snaps
                and now >= self.trace_at + TRACE_S):
            self._stop_trace()
        if self.t0 is not None and self.t1 is None \
                and now >= self.t0 + self.seconds:
            self.t1 = now
            self.snaps["close"] = self.snap()
        if self.t1 is not None and self._finished(now):
            if self.prof is not None and "trace_stop" not in self.snaps:
                self._stop_trace()
            self.t_stop = now
            raise StopRun

    def _stop_trace(self):
        self.snaps["trace_stop"] = self.snap()
        self.prof.stop()

    def _finished(self, now: float) -> bool:
        if not self.open_loop:
            return True
        window = [r for r, it, _ in self.reqs if it.phase == "window"]
        return all(r.done for r in window) or \
            now >= self.t1 + self.cell["drain_s"]

    def records(self) -> List[Req]:
        return [Req(r.rid, it.phase, due, r.arrived, r.t_first, r.t_done,
                    len(r.prompt), r.max_new, len(r.generated),
                    r.prefix_tokens)
                for r, it, due in self.reqs]


def drive(eng, cell: Dict, traffic, seconds: float, trace: bool,
          profiler_factory=None) -> Client:
    """Run the engine under the cell's traffic until the client stops it."""
    client = Client(eng, cell, traffic, seconds, trace, profiler_factory)
    client.start()
    try:
        while True:
            eng.run_until_done(max_rounds=10 ** 12)
            client.idle()
    except StopRun:
        pass
    finally:
        eng.runtime.profile_hook = None
    return client


def release(torch):
    """Return the device memory of a dropped engine (pool, graphs,
    workspaces): its last reference gone, collect its cycles."""
    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.synchronize()
        torch.cuda.empty_cache()


def finished(client: Client) -> List:
    """Requests that served every token, window requests first."""
    done = [(r, it) for r, it, _ in client.reqs if r.done]
    return [r for r, it in done if it.phase == "window"] or \
        [r for r, _ in done]
