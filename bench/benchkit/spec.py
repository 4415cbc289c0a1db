"""Finds everything a run needs by name, from ``BENCHMARK.json`` at the
checkout's root:

- the cell's entry in ``workloads`` and its file ``bench/cells/<cell>.json``
  (traffic parameters, ``why``, the comparison's limit);
- the configuration's file, named in ``configs``;
- each metric the cell reports: an ``end_to_end`` metric with ``--trace
  0``, a ``per_layer`` one with ``--trace 1``, where the metric lists the
  cell under ``workloads`` or lists no cells; its reader is
  ``bench/metrics/<metric>.py``;
- the reference, ``bench/reference/<family>.py``.

So a configuration, a traffic mix or a metric is added as new files and
entries, and no file here is edited.
"""
from __future__ import annotations

import dataclasses
import importlib.util
import json
from pathlib import Path
from typing import Callable, Dict, List

BENCH = Path(__file__).resolve().parents[1]


@dataclasses.dataclass
class Metric:
    name: str
    unit: str
    entry: Dict
    read: Callable


@dataclasses.dataclass
class Spec:
    root: Path
    workload: Dict
    cell: Dict
    arch: Dict
    metrics: List[Metric]


def load_reader(bench: Path, name: str) -> Callable:
    path = bench / "metrics" / f"{name}.py"
    if not path.exists():
        raise FileNotFoundError(f"metric {name!r} has no reader at {path}")
    mod_spec = importlib.util.spec_from_file_location(
        f"bench_metric_{name.replace('.', '_').replace('-', '_')}", path)
    mod = importlib.util.module_from_spec(mod_spec)
    mod_spec.loader.exec_module(mod)
    return mod.read


def load(root: Path, workload: str, trace: bool) -> Spec:
    """The spec of cell ``workload`` in the checkout at ``root``."""
    bench = root / "bench"
    bm = json.loads((root / "BENCHMARK.json").read_text())
    cells = {w["name"]: w for w in bm["workloads"]}
    if workload not in cells:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json "
                       f"(cells: {sorted(cells)})")
    w = cells[workload]
    conf = {c["name"]: c for c in bm["configs"]}[w["config"]]
    arch = json.loads((root / conf["file"]).read_text())
    cell = json.loads((bench / "cells" / f"{workload}.json").read_text())
    if cell["traffic"] != w["traffic"]:
        raise ValueError(f"{workload}: BENCHMARK.json names traffic "
                         f"{w['traffic']!r}, its cell file {cell['traffic']!r}")
    group = bm["per_layer"] if trace else bm["end_to_end"]
    metrics = [Metric(m["name"], m["unit"], m,
                      load_reader(bench, m["name"]))
               for m in group
               if "workloads" not in m or workload in m["workloads"]]
    return Spec(root, w, cell, arch, metrics)
