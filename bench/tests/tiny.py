"""A tiny configuration and cell, added as new files to a copy of the
benchmark, for the CPU tests: a two-layer model of the starcoder2 family
at widths a CPU runs in seconds."""
from __future__ import annotations

import json
import shutil
import sys
from pathlib import Path

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent
for p in (str(ROOT / "src"), str(BENCH)):
    if p not in sys.path:
        sys.path.insert(0, p)

CONFIG = {
    "name": "tiny-dense", "source": "test", "hidden_size": 64,
    "intermediate_size": 128, "num_attention_heads": 4,
    "num_key_value_heads": 2, "num_hidden_layers": 2, "vocab_size": 512,
    "rope_theta": 100000.0, "reduced": [],
    "port": {"arch": "starcoder2-15b",
             "overrides": {"d_model": 64, "d_ff": 128, "n_heads": 4,
                           "n_kv_heads": 2, "n_layers": 2, "vocab": 512,
                           "head_dim": 16}},
    "engine": {"groups": 2, "max_batch": 4, "max_len": 128,
               "pool_streams": 4},
    "reference": {"family": "dense", "activation": "gelu_tanh",
                  "norm_eps": 1e-6, "window": 0},
}

CELL = {
    "traffic": "code", "why": "test", "loop": "open", "rate_per_s": 8.0,
    "warmup_s": 0.3, "drain_s": 10.0,
    "prompt": {"dist": "lognormal", "median": 30, "sigma": 0.6, "min": 8,
               "max": 60},
    "output": {"dist": "lognormal", "median": 6, "sigma": 0.5, "min": 2,
               "max": 12},
    "shared_prefix": None,
    "check": {"limits": {"gap_max": 0.05, "gap_p90": 0.01}},
}

NAME = "tiny-dense.code"


def make_root(tmp: Path, extra_metric: str = "") -> Path:
    """A checkout at ``tmp``: this benchmark's files, the program's
    sources, and the tiny configuration and cell as new files with their
    entries; ``extra_metric`` names one more per-layer metric whose
    reader the caller adds."""
    root = tmp / "checkout"
    shutil.copytree(BENCH, root / "bench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    (root / "src").symlink_to(ROOT / "src")
    (root / "bench/configs/tiny-dense.json").write_text(json.dumps(CONFIG))
    (root / f"bench/cells/{NAME}.json").write_text(json.dumps(CELL))
    bm = json.loads((ROOT / "BENCHMARK.json").read_text())
    bm["configs"].append({"name": "tiny-dense", "source": "test",
                          "file": "bench/configs/tiny-dense.json",
                          "reduced": [], "why": "test"})
    bm["workloads"].append({"name": NAME, "config": "tiny-dense",
                            "traffic": "code", "chips": 1, "why": "test"})
    for m in bm["end_to_end"] + bm["per_layer"]:
        if "workloads" in m and m["name"] != "output_tokens_per_s":
            m["workloads"].append(NAME)
    if extra_metric:
        bm["per_layer"].append({
            "name": extra_metric, "unit": "requests", "better": "higher",
            "source": "program_counter", "layer": "engine loop",
            "moves": "ttft_p90_s", "workloads": [NAME]})
    (root / "BENCHMARK.json").write_text(json.dumps(bm))
    return root


def run(root: Path, seed: int = 123456789012, seconds: float = 1.5,
        trace: bool = False):
    import time
    from benchkit import harness
    return harness.run(root, NAME, seed, seconds, trace, time.monotonic(),
                       device="cpu")
