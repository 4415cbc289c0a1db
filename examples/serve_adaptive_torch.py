"""Serving demo on the PyTorch/CUDA port: continuous batching with ARCAS
adaptive replica layout and the paged chiplet-aware KV allocator.  The
twin of ``serve_adaptive.py``: the same model, topology, engine options,
prompts and schedule, on one card.

Two phases of load hit the engine:
  1. many small requests  -> compact layout (many replicas) serves best;
  2. long-context requests -> KV pressure + steals push the controller
     toward spread (fewer, larger replica groups).

KV lives in a block pool partitioned per chiplet-group domain: requests
hold block tables, relayouts move tables (not cache slices), and admission
parks on pool exhaustion instead of queueing blindly.

    PYTHONPATH=src python examples/serve_adaptive_torch.py
    PYTHONPATH=src python examples/serve_adaptive_torch.py --device cpu
"""
import argparse
import sys

import numpy as np
import torch

from repro_torch.configs import REGISTRY, reduced_config
from repro_torch.core.topology import ChipletTopology
from repro_torch.serving.engine import EngineConfig, ServeEngine


def main(argv=None, *, device="cuda", params=None):
    """Serves both phases; returns what it printed (``lines``) and the
    values behind it, the engine among them.  ``params``: the model's
    weights (a dict of tensors on ``device``), else the engine's seeded
    ones."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default=device)
    args = ap.parse_args(argv or [])
    lines = []

    def say(text):
        print(text, flush=True)
        lines.append(text)

    cfg = reduced_config(REGISTRY["mixtral-8x22b"])
    topo = ChipletTopology(n_pods=1, groups_per_pod=4, chips_per_group=2)
    eng = ServeEngine(cfg, topo, EngineConfig(max_batch=2, max_len=96,
                                              pool_streams=2),
                      spread_rate=1, params=params,
                      device=torch.device(args.device))
    rng = np.random.default_rng(0)

    say(f"groups={len(eng.groups)} (spread_rate="
        f"{eng.controller.spread_rate}), KV pool: "
        f"{eng.pool.total_blocks()} blocks of "
        f"{eng.pool.block_tokens} tokens over "
        f"{eng.pool.n_domains} chiplet-group domains")
    # phase 1: short interactive requests
    short = [eng.submit(rng.integers(2, cfg.vocab, size=6), max_new=4)
             for _ in range(10)]
    eng.run_until_done()
    short_stats = ServeEngine.stats(short)
    say(f"phase1 (short): {short_stats}")

    # phase 2: long-context analytical requests, arriving over time
    # (open-loop client on the shared task runtime)
    sched = [(2, rng.integers(2, cfg.vocab, size=48), 8) for _ in range(6)]
    eng.open_loop_client(sched)
    eng.run_until_done()
    long = eng.submitted[len(short):]
    long_stats = ServeEngine.stats(long)
    say(f"phase2 (long, open-loop): {long_stats}")
    decisions = [(d.step, d.old_spread, "->", d.new_spread, d.reason)
                 for d in eng.controller.decisions]
    say(f"controller decisions: {decisions}")
    say("live relayouts (mid-run group rebuilds):")
    for r in eng.relayouts:
        say(f"  step {r['step']}: {r['old_groups']} -> {r['new_groups']} "
            f"groups, {r['moved_slots']} streams re-pointed, "
            f"{r['blocks_migrated']:.0f} KV blocks copied, "
            f"{r['requeued']} requests requeued")
    kv = {k: round(v, 3) if isinstance(v, (int, float)) else v
          for k, v in eng.kv_stats().items() if not isinstance(v, list)}
    say(f"kv pool: {kv}")
    counters = {k: round(v, 1) for k, v in eng.counters.snapshot().items()
                if "steal" in k or k in ("prefills", "decode_steps",
                                         "kv_alloc_failures",
                                         "tasks_unblocked")}
    say(f"counters: {counters}")
    return {"short": short_stats, "long": long_stats,
            "generated": [list(r.generated) for r in eng.submitted],
            "decisions": decisions, "relayouts": list(eng.relayouts),
            "kv": kv, "counters": counters, "engine": eng, "lines": lines}


if __name__ == "__main__":
    main(sys.argv[1:])
