"""End-to-end driver on the PyTorch/CUDA port: train a ~100M-parameter
llama-family model for a few hundred steps with the full stack — sharded
data pipeline, AdamW, atomic checkpoints, ARCAS controller, straggler
detection.  The twin of ``train_e2e.py``: the same model, corpus, flags and
trainer settings, on one card.

    PYTHONPATH=src python examples/train_e2e_torch.py --steps 300
    PYTHONPATH=src python examples/train_e2e_torch.py --steps 300 --resume
    PYTHONPATH=src python examples/train_e2e_torch.py --device cpu \
        --steps 12 --seq 32 --batch 2

~100M config: 12L x d768 (12H, kv=4) x ff2048, vocab 32768 ->
  params = 32768*768*2 + 12*(768*12*64*2 + 768*4*64*2 + 3*768*2048)
         = 125.8M (with the norms 125,848,320; printed as 126M)
"""
import argparse
import dataclasses
import os
import shutil
import sys
import tempfile

import numpy as np
import torch

from repro_torch.configs import REGISTRY
from repro_torch.core.topology import ChipletTopology
from repro_torch.data.pipeline import (ShardedLoader, SyntheticCorpus,
                                       write_corpus_shards)
from repro_torch.models.params import n_params
from repro_torch.optim.adamw import AdamWConfig
from repro_torch.runtime.trainer import Trainer, TrainerConfig


def model_100m():
    return dataclasses.replace(
        REGISTRY["llama3-8b"],
        name="llama-100m", n_layers=12, d_model=768, n_heads=12,
        n_kv_heads=4, head_dim=64, d_ff=2048, vocab=32768,
        param_dtype="float32", compute_dtype="float32",
        attn_block_q=128, attn_block_kv=128)


def main(argv=None, *, device="cuda", steps=300, workdir=None, params=None):
    """Trains; returns what it printed (``lines``) and the values behind
    it, among them each step's seconds (``step_times``).  ``params``:
    initial weights (a dict of tensors on ``device``), else the Trainer's
    seeded ones."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--steps", type=int, default=steps)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--workdir", default=workdir or os.path.join(
        tempfile.gettempdir(), "repro_torch_train_e2e"))
    ap.add_argument("--device", default=device)
    args = ap.parse_args(argv or [])
    lines = []

    def say(text):
        print(text, flush=True)
        lines.append(text)

    cfg = model_100m()
    say(f"model: {cfg.name}, {n_params(cfg)/1e6:.0f}M params")

    if not args.resume:
        shutil.rmtree(args.workdir, ignore_errors=True)
    corpus = SyntheticCorpus(cfg.vocab, seed=1234)
    files = write_corpus_shards(f"{args.workdir}/data", corpus,
                                n_shards=8, tokens_per_shard=2_000_000)
    loader = ShardedLoader(files, seq_len=args.seq, batch=args.batch)
    topo = ChipletTopology()
    tcfg = TrainerConfig(
        steps=args.steps, ckpt_every=50, ckpt_dir=f"{args.workdir}/ckpt",
        log_every=10, async_ckpt=True,
        opt=AdamWConfig(peak_lr=3e-4, warmup_steps=30,
                        total_steps=args.steps))
    # the JAX example's 1x1 (data, model) mesh is one card: mesh=None
    trainer = Trainer(cfg, loader, tcfg, topology=topo, log=say,
                      params=params, device=torch.device(args.device))
    if args.resume:
        trainer.resume_if_possible()
    out = trainer.run()
    lo = np.mean(out["losses"][:10])
    hi = np.mean(out["losses"][-10:])
    tput = args.batch * args.seq * len(out["losses"]) / out["wall"]
    say(f"done: steps={out['steps']} loss {lo:.3f} -> {hi:.3f} "
        f"({tput:.0f} tok/s, stragglers={len(out['straggler_events'])})")
    assert hi < lo, "loss must decrease over a few hundred steps"
    return {"model": cfg.name, "n_params": n_params(cfg),
            "steps": out["steps"], "losses": out["losses"],
            "loss_first10": float(lo), "loss_last10": float(hi),
            "tok_per_s": tput, "wall": out["wall"],
            "step_times": out["step_times"],
            "stragglers": len(out["straggler_events"]), "lines": lines}


if __name__ == "__main__":
    main(sys.argv[1:])
