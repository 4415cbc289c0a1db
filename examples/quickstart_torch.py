"""Quickstart on the PyTorch/CUDA port: train a tiny llama-family model for
20 steps with the ARCAS runtime (counters + Algorithm-1 controller) and
generate a few tokens.  The twin of ``quickstart.py``: the same config,
corpus, trainer settings and prompt, on one card.

    PYTHONPATH=src python examples/quickstart_torch.py
    PYTHONPATH=src python examples/quickstart_torch.py --device cpu
"""
import argparse
import os
import shutil
import sys
import tempfile

import numpy as np
import torch

from repro_torch.configs import REGISTRY, reduced_config
from repro_torch.core.topology import ChipletTopology
from repro_torch.data.pipeline import (ShardedLoader, SyntheticCorpus,
                                       write_corpus_shards)
from repro_torch.launch.steps import make_generate, make_prefill
from repro_torch.runtime.trainer import Trainer, TrainerConfig


def main(argv=None, *, device="cuda", steps=20, workdir=None, params=None):
    """Runs the quickstart; returns what it printed (``lines``) and the
    values behind it.  ``params``: initial weights (a dict of tensors on
    ``device``), else the Trainer's seeded ones."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default=device)
    args = ap.parse_args(argv or [])
    dev = torch.device(args.device)
    workdir = workdir or os.path.join(tempfile.gettempdir(),
                                      "repro_torch_quickstart")
    lines = []

    def say(text):
        print(text, flush=True)
        lines.append(text)

    cfg = reduced_config(REGISTRY["llama3-8b"])
    say(f"model: {cfg.name} ({cfg.n_layers}L d={cfg.d_model})")

    # --- data + trainer ---------------------------------------------------
    shutil.rmtree(workdir, ignore_errors=True)
    corpus = SyntheticCorpus(cfg.vocab, seed=0)
    files = write_corpus_shards(f"{workdir}/data", corpus,
                                n_shards=2, tokens_per_shard=50_000)
    loader = ShardedLoader(files, seq_len=64, batch=4)
    topo = ChipletTopology(n_pods=1, groups_per_pod=4, chips_per_group=4)
    # the JAX example's 1x1 (data, model) mesh is one card: mesh=None
    trainer = Trainer(cfg, loader,
                      TrainerConfig(steps=steps, ckpt_every=10, log_every=5,
                                    ckpt_dir=f"{workdir}/ckpt"),
                      topology=topo, log=say, params=params, device=dev)
    out = trainer.run()
    say(f"trained {out['steps']} steps; "
        f"loss {out['losses'][0]:.3f} -> {out['losses'][-1]:.3f}")

    # --- generate ----------------------------------------------------------
    prompt = torch.tensor([[5, 17, 42, 99]], dtype=torch.int32, device=dev)
    with torch.no_grad():
        logits, cache = make_prefill(cfg, max_len=64)(
            trainer.params, {"tokens": prompt})
        first = logits.argmax(-1)[:, None].to(torch.int32)
        pos = torch.full((1,), prompt.shape[1], dtype=torch.int32,
                         device=dev)
        toks, _, _ = make_generate(cfg, steps=12)(trainer.params, cache,
                                                  first, pos)
    generated = toks[0].cpu().numpy().astype(np.int64).tolist()
    say(f"generated tokens: {generated}")
    counters = {k: round(v, 1) for k, v in trainer.counters.snapshot().items()
                if not k.startswith("segment")}
    say(f"ARCAS counters: {counters}")
    return {"model": cfg.name, "steps": out["steps"], "losses": out["losses"],
            "generated": generated, "counters": counters, "lines": lines}


if __name__ == "__main__":
    main(sys.argv[1:])
