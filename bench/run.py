"""The benchmark of the port (``repro_torch``) on one H100.

    python3 bench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

run from the root of a checkout.  Runs the cell named in ``BENCHMARK.json``
and prints, as the last line of standard output, one JSON object:
``correct``, ``attempted``, ``failed``, ``metrics`` (the cell's end-to-end
metrics, or with ``--trace 1`` its per-layer metrics), ``device`` and,
traced, ``breakdown``; last, ``checks``: each number compared beside its
limit, which also close standard error.  Exits non-zero, with no result,
where CUDA has fewer devices than the cell asks for, or where a module of
JAX or of the JAX package is loaded once the window has closed.
"""
import time

T_START = time.monotonic()          # process start, for setup_s

import argparse
import json
import os
import sys
from pathlib import Path

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    # every cache the port and PyTorch keep goes inside the checkout, at a
    # fixed path (the kernels' build: build/kernels)
    for var, sub in (("TRITON_CACHE_DIR", "triton"),
                     ("TORCH_EXTENSIONS_DIR", "torch_extensions")):
        os.environ[var] = str(ROOT / "build" / sub)
    sys.path[:0] = [str(BENCH), str(ROOT / "src")]
    from benchkit import harness, imports
    try:
        result = harness.run(ROOT, args.workload, args.seed, args.seconds,
                             bool(args.trace), T_START)
    except harness.NoCard as e:
        print(f"bench: {e}", file=sys.stderr)
        return 2
    bad = imports.forbidden(sys.modules)
    if bad:
        print("bench: modules of JAX or the JAX package are loaded: "
              + ", ".join(bad), file=sys.stderr)
        return 3
    harness.print_checks(result)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
