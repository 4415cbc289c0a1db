"""Fault-tolerance demo on the PyTorch/CUDA port: a host dies mid-training;
the job checkpoint-restarts on a degraded fleet with a re-fitted batch,
resuming bit-exact from the last atomic checkpoint.  The twin of
``elastic_restart.py``: the same config, corpus, failure and schedule.

    PYTHONPATH=src python examples/elastic_restart_torch.py
    PYTHONPATH=src python examples/elastic_restart_torch.py --device cpu
"""
import argparse
import os
import shutil
import sys
import tempfile

import torch

from repro_torch.configs import REGISTRY, reduced_config
from repro_torch.core.topology import ChipletTopology
from repro_torch.data.pipeline import (ShardedLoader, SyntheticCorpus,
                                       write_corpus_shards)
from repro_torch.models.params import tree_map
from repro_torch.runtime.elastic import rebatch_for
from repro_torch.runtime.failure import FailureInjector, SimulatedFailure
from repro_torch.runtime.trainer import Trainer, TrainerConfig


def build(workdir, loader_batch, steps, device, params, log, failure=None):
    cfg = reduced_config(REGISTRY["llama3-8b"])
    corpus = SyntheticCorpus(cfg.vocab, seed=7)
    files = write_corpus_shards(f"{workdir}/data", corpus, n_shards=4,
                                tokens_per_shard=100_000)
    loader = ShardedLoader(files, seq_len=64, batch=loader_batch)
    topo = ChipletTopology(n_pods=1, groups_per_pod=4, chips_per_group=4)
    tcfg = TrainerConfig(steps=steps, ckpt_every=10, log_every=10,
                         ckpt_dir=f"{workdir}/ckpt")
    # the JAX example's 1x1 (data, model) mesh is one card: mesh=None.
    # Each run starts from its own copy (a step updates its weights in
    # place), as each JAX Trainer draws its own
    if params is not None:
        params = tree_map(torch.clone, params)
    return Trainer(cfg, loader, tcfg, topology=topo, failure=failure,
                   log=log, params=params, device=device)


def main(argv=None, *, device="cuda", steps=30, workdir=None, params=None):
    """Runs the demo; returns what it printed (``lines``) and the values
    behind it.  ``params``: initial weights of both runs (a dict of
    tensors on ``device``), else the Trainer's seeded ones."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default=device)
    args = ap.parse_args(argv or [])
    dev = torch.device(args.device)
    workdir = workdir or os.path.join(tempfile.gettempdir(),
                                      "repro_torch_elastic")
    lines = []

    def say(text):
        print(text, flush=True)
        lines.append(text)

    shutil.rmtree(workdir, ignore_errors=True)

    # --- run 1: dies at step 17 (after the step-10 checkpoint) ------------
    t1 = build(workdir, 8, steps, dev, params, say,
               failure=FailureInjector(fail_at_step=17))
    failure = None
    try:
        t1.run()
    except SimulatedFailure as e:
        failure = str(e)
        say(f"!! {e}")

    # --- run 2: restart on a DEGRADED fleet (one group lost) --------------
    # survivors re-fit the global batch to the remaining data shards
    new_batch = rebatch_for(8, 4)   # e.g. 4 surviving data shards
    say(f"restarting with batch {new_batch} on the degraded fleet")
    t2 = build(workdir, new_batch, steps, dev, params, say)
    assert t2.resume_if_possible(), "checkpoint must exist"
    assert t2.step == 10
    resumed_at = t2.step
    out = t2.run()
    say(f"recovered: resumed@10 -> finished step {out['steps']}, "
        f"final loss {out['losses'][-1]:.3f}")
    return {"failure": failure, "new_batch": new_batch,
            "resumed_at": resumed_at, "steps": out["steps"],
            "losses": out["losses"], "lines": lines}


if __name__ == "__main__":
    main(sys.argv[1:])
