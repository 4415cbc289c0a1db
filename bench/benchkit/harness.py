"""One run of a cell, from ``BENCHMARK.json`` to the result line.

Set-up (counted in ``setup_s``): the weights from the seed on the device,
the engine, ``warm_steps`` (the kernels' build on a checkout's first run,
the CUDA graphs of every step shape the loop dispatches), and the cell's
warm-up traffic.  Then the window of ``--seconds``; then the drain.  Once
the engine has stopped, the peak memory is read, the engine's state is
freed, and the reference judges a sample of the served requests.
"""
from __future__ import annotations

import subprocess
import sys
import time
from pathlib import Path
from typing import Dict, Optional

from benchkit import check, record, serve, spec as spec_mod, traffic, weights
from benchkit import trace as trace_mod


class NoCard(RuntimeError):
    """Fewer CUDA devices than the cell asks for."""


def card_info(torch) -> Dict:
    info = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": 1}
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip().splitlines()
        info["power_limit"] = out[0].split(",")[-1].strip() if out else None
    except (OSError, subprocess.SubprocessError):
        info["power_limit"] = None
    return info


def serve_cell(torch, sp, seed: int, seconds: float, trace: bool,
               t_start: float, dev):
    """Set-up and the window: (the weights, the stopped client, the peak
    of allocated device memory)."""
    cuda = dev.type == "cuda"
    arch, cell = sp.arch, sp.cell
    params = weights.make(torch, arch, seed, dev)
    log(t_start, f"weights made ({mem(torch, cuda)})")
    eng = serve.build_engine(torch, arch, params, dev)
    log(t_start, f"engine built ({mem(torch, cuda)})")
    calls = eng.warm_steps()
    log(t_start, f"warm_steps: {calls} step calls ({mem(torch, cuda)})")
    if trace:       # the profiler's own first start stays out of the window
        warm = trace_mod.profiler(torch, cuda)
        warm.start()
        warm.stop()
    mix = traffic.Traffic(cell, seed, arch["vocab_size"])
    client = serve.drive(eng, cell, mix, seconds, trace,
                         lambda: trace_mod.profiler(torch, cuda))
    if cuda:
        torch.cuda.synchronize(dev)
    peak = int(torch.cuda.max_memory_allocated(dev)) if cuda else 0
    c = client.snaps["close"].counters
    log(t_start, f"engine stopped: {len(client.reqs)} requests submitted, "
        f"{sum(r.done for r, _, _ in client.reqs)} done; chunk ticks "
        f"{c.get('chunk_ticks', 0):.0f}, decode steps "
        f"{c.get('decode_forwards', 0):.0f}, parks "
        f"{c.get('kv_alloc_failures', 0):.0f}; peak "
        f"{peak / 2 ** 30:.2f} GiB")
    return params, client, peak


def run(root: Path, workload: str, seed: int, seconds: float, trace: bool,
        t_start: float, device: str = "cuda") -> Dict:
    """The result of one run of ``workload``, as a dict for the result
    line.  ``device="cpu"`` is for the CPU tests only: it skips the look
    for a card."""
    import torch
    sp = spec_mod.load(root, workload, trace)
    cuda = device == "cuda"
    if cuda:
        if not torch.cuda.is_available() or \
                torch.cuda.device_count() < sp.workload["chips"]:
            raise NoCard(f"{workload} needs {sp.workload['chips']} CUDA "
                         f"device(s); found "
                         f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}")
        torch.set_num_threads(4)
        info = card_info(torch)
        dev = torch.device("cuda", 0)
        torch.cuda.reset_peak_memory_stats(dev)
    else:
        info = {"platform": "cpu", "kind": "cpu", "count": 1}
        dev = torch.device("cpu")
    arch, cell = sp.arch, sp.cell

    params, client, peak = serve_cell(torch, sp, seed, seconds, trace,
                                      t_start, dev)
    reqs = client.records()
    sample = check.sample(serve.finished(client), seed)
    snaps = client.snaps
    tr: Optional[record.Trace] = None
    if trace:
        tr = trace_mod.reduce(
            torch, client.prof,
            snaps["trace_stop"].t - snaps["trace_start"].t,
            snaps["trace_start"], snaps["trace_stop"])
    run_rec = record.Run(arch=arch, cell=cell, workload=workload,
                         seconds=seconds, t_start=t_start,
                         t_stop=client.t_stop, open=snaps["open"],
                         close=snaps["close"], reqs=reqs,
                         chunk=client.block, memory_peak_bytes=peak,
                         trace=tr)
    del client
    serve.release(torch)

    gaps = check.compare(torch, params, arch, sample)
    checks = check.judge(gaps, cell["check"]["limits"])
    log(t_start, f"reference compared {gaps.size} served tokens of "
        f"{len(sample)} requests: {check.describe(gaps)}")

    metrics = {}
    for m in sp.metrics:
        v = m.read(run_rec)
        if v is not None:
            metrics[m.name] = {"value": v, "unit": m.unit}
    if cell["loop"] == "open":
        window = run_rec.window()
        attempted = len(window)
        failed = sum(1 for r in window if r.t_done is None)
    else:
        attempted = sum(1 for r in reqs if r.t_done is not None
                        and run_rec.open.t <= r.t_done <= run_rec.close.t)
        failed = 0
    info["memory_peak_bytes"] = peak
    out = {"correct": check.passed(checks), "attempted": attempted,
           "failed": failed, "metrics": metrics, "device": info}
    if tr is not None:
        info["busy_s"] = trace_mod.busy_s(tr)
        info["window_s"] = tr.window_s
        out["breakdown"] = trace_mod.breakdown(tr)
    out["checks"] = checks
    return out


def log(t_start: float, msg: str):
    print(f"[bench {time.monotonic() - t_start:8.2f} s] {msg}",
          file=sys.stderr, flush=True)


def mem(torch, cuda: bool) -> str:
    """Device memory, after the device has finished what was queued."""
    if not cuda:
        return "cpu"
    torch.cuda.synchronize()
    free, total = torch.cuda.mem_get_info()
    return (f"allocated {torch.cuda.memory_allocated() / 2 ** 30:.2f} GiB, "
            f"reserved {torch.cuda.memory_reserved() / 2 ** 30:.2f} GiB, "
            f"free {free / 2 ** 30:.2f} of {total / 2 ** 30:.2f} GiB")


def print_checks(result: Dict, stream=sys.stderr):
    for name, c in result["checks"].items():
        bound = "limit" if "limit" in c else "min"
        print(f"check {name} {c['value']!r} {bound} {c[bound]!r}",
              file=stream, flush=True)
