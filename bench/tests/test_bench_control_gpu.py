"""On the card: the float8 control fails each cell's comparison, and the
program passes it, on three seeds at the cell's own size and load (a
20 s window: a run's sample of finished requests).

    python3 -m pytest -q -m gpu bench/tests/test_bench_control_gpu.py
"""
import json

import pytest

import tiny

SEEDS = (2147483911, 2147483912, 2147483913)
CELLS = [w["name"] for w in
         json.loads((tiny.ROOT / "BENCHMARK.json").read_text())["workloads"]]


@pytest.mark.gpu
@pytest.mark.parametrize("workload", CELLS)
def test_control_fails_and_program_passes(workload):
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    import control
    limits = json.loads((tiny.BENCH / "cells" / f"{workload}.json")
                        .read_text())["check"]["limits"]
    for seed in SEEDS:
        r = control.readings(workload, seed, 20.0)
        print(json.dumps(r))
        assert all(r["program"][n] <= lim for n, lim in limits.items()), r
        assert any(r["control"][n] > lim for n, lim in limits.items()), r
