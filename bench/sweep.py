"""The rate sweep that finds an open-loop cell's knee, once, when the cell
is defined:

    python3 bench/sweep.py --workload <cell> --seed <n> --rates 1,2,3 --seconds 30

One engine, warmed once; each rate in ascending order runs the cell's
traffic at that rate (warm-up, window, drain) on it, and prints one JSON
line: requests due in the window and finished, the TTFT and TPOT p50 and
p90, the median TTFT of the window's first and last thirds (a backlog
that grows shows as the last third's rising), and tokens served a second.
A rate is sustained where every window request finished within the drain
and the last third's median TTFT is under twice the first third's.  The
sweep stops after the first rate that is not sustained.  The cell's rate
is then 0.8 of the highest sustained rate, written into its file.
"""
import argparse
import json
import statistics
import sys
import time
from pathlib import Path

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--rates", required=True)
    ap.add_argument("--seconds", type=float, default=30.0)
    args = ap.parse_args(argv)
    sys.path[:0] = [str(BENCH), str(ROOT / "src")]
    import torch
    from benchkit import harness, record, serve, spec, traffic, weights
    sp = spec.load(ROOT, args.workload, False)
    dev = torch.device("cuda", 0)
    t = time.monotonic()
    params = weights.make(torch, sp.arch, args.seed, dev)
    eng = serve.build_engine(torch, sp.arch, params, dev)
    eng.warm_steps()
    harness.log(t, "engine warmed")
    for i, rate in enumerate(float(r) for r in args.rates.split(",")):
        cell = dict(sp.cell, rate_per_s=rate)
        mix = traffic.Traffic(cell, args.seed + i, sp.arch["vocab_size"])
        client = serve.drive(eng, cell, mix, args.seconds, False)
        reqs = client.records()
        window = sorted((r for r in reqs if r.phase == "window"),
                        key=lambda r: r.due)
        stop = client.t_stop
        ttfts = [record.ttft(r, stop) for r in window]
        third = max(1, len(window) // 3)
        first = statistics.median(ttfts[:third])
        last = statistics.median(ttfts[-third:])
        done = sum(r.t_done is not None for r in window)
        o, c = client.snaps["open"], client.snaps["close"]
        out = {"rate": rate, "window": len(window), "done": done,
               "ttft_p50": record.percentile(ttfts, 50),
               "ttft_p90": record.percentile(ttfts, 90),
               "tpot_p90": record.percentile(
                   [record.tpot(r, stop) for r in window], 90),
               "ttft_first_third": first, "ttft_last_third": last,
               "tokens_per_s": (sum(c.served.values())
                                - sum(o.served.values())) / (c.t - o.t),
               "sustained": done == len(window) and last < 2 * first}
        print(json.dumps(out), flush=True)
        if not out["sustained"]:
            break


if __name__ == "__main__":
    main()
