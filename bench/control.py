"""The comparison's two readings on the card, for setting a cell's limit:

    python3 bench/control.py --workload <cell> --seeds <n,n,...> --seconds <s>

For each seed: the cell served at its own load for a short window, then,
on the sample a run compares, the numbers a run compares (``check.describe``)
of the program's served tokens (the lower reading, as a run reads it), of
the tokens that the reference computed in float8 puts first (the
control), and of those the reference rounded to bf16 puts first (a
witness; ``check.control_gaps``).  Prints one JSON line a seed; the benchmark's
own runs never run this.
"""
import argparse
import json
import sys
import time
from pathlib import Path

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent


def readings(workload, seed, seconds, root=ROOT, device="cuda"):
    """{"seed", "program", "control", "tokens"} of one seed."""
    import torch
    from benchkit import check, harness, serve, spec
    sp = spec.load(root, workload, False)
    dev = torch.device(device)
    t = time.monotonic()
    params, client, _ = harness.serve_cell(torch, sp, seed, seconds, False,
                                           t, dev)
    sample = check.sample(serve.finished(client), seed)
    del client
    serve.release(torch)
    gaps = check.control_gaps(torch, params, sp.arch, sample)
    out = {"workload": workload, "seed": seed,
           "tokens": int(gaps["program"].size)}
    out.update({k: check.describe(g) for k, g in gaps.items()})
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=10.0)
    args = ap.parse_args(argv)
    sys.path[:0] = [str(BENCH), str(ROOT / "src")]
    for s in args.seeds.split(","):
        print(json.dumps(readings(args.workload, int(s), args.seconds)),
              flush=True)


if __name__ == "__main__":
    main()
