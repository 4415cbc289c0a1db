"""Data substrate: deterministic synthetic corpus + sharded loader.

* ``SyntheticCorpus`` — seeded Zipf-ish token stream with document structure
  (EOS-delimited docs of geometric length), reproducible per (seed, shard).
* ``write_corpus_shards`` / memmap readers — on-disk int32 shards so the
  loader exercises a real file path (checkpoint/restart resumes mid-shard).
* ``ShardedLoader`` — per-host sharding (host h of H reads shards h::H),
  sequence packing, and background prefetch driven by the ARCAS coroutine
  runtime (a prefetch task yields between shard reads, so the profiler sees
  data-stall time).

A copy of the JAX package's ``data/pipeline.py`` (it is numpy only), with
the prefetch coroutine on the port's ``core.tasks.TaskRuntime``: the same
seeds give the same files and the same blocks.  Batches are host-local
numpy; the trainer moves them to its device.
"""
from __future__ import annotations

import dataclasses
import os
from typing import Dict, Iterator, List, Optional

import numpy as np

from repro_torch.configs.base import ModelConfig
from repro_torch.core.tasks import TaskRuntime


class SyntheticCorpus:
    """Deterministic Zipf token documents."""

    def __init__(self, vocab: int, seed: int = 0, *, eos: int = 1,
                 mean_doc_len: int = 512, zipf_a: float = 1.2):
        self.vocab = vocab
        self.seed = seed
        self.eos = eos
        self.mean_doc_len = mean_doc_len
        self.zipf_a = zipf_a

    def shard_tokens(self, shard: int, n_tokens: int) -> np.ndarray:
        rng = np.random.default_rng((self.seed, shard))
        toks = rng.zipf(self.zipf_a, size=int(n_tokens * 1.05)) % self.vocab
        toks = np.clip(toks, 2, self.vocab - 1).astype(np.int32)
        # insert EOS at geometric document boundaries
        p = 1.0 / self.mean_doc_len
        eos_mask = rng.random(toks.shape[0]) < p
        toks[eos_mask] = self.eos
        return toks[:n_tokens]


def write_corpus_shards(path: str, corpus: SyntheticCorpus, *,
                        n_shards: int, tokens_per_shard: int) -> List[str]:
    os.makedirs(path, exist_ok=True)
    files = []
    for s in range(n_shards):
        f = os.path.join(path, f"shard_{s:05d}.npy")
        if not os.path.exists(f):
            np.save(f, corpus.shard_tokens(s, tokens_per_shard))
        files.append(f)
    return files


@dataclasses.dataclass
class LoaderState:
    shard_idx: int = 0
    offset: int = 0
    step: int = 0


class ShardedLoader:
    """Packing loader over memmap shards with coroutine prefetch."""

    def __init__(self, files: List[str], *, host: int = 0, n_hosts: int = 1,
                 seq_len: int, batch: int, runtime: Optional[TaskRuntime] = None,
                 prefetch: int = 2):
        self.files = files[host::n_hosts]
        if not self.files:
            raise ValueError("no shards for this host")
        self.seq_len = seq_len
        self.batch = batch
        self.state = LoaderState()
        self.runtime = runtime
        self._queue: List[np.ndarray] = []
        self._prefetch = prefetch

    # -- core read ---------------------------------------------------------
    def _read_block(self) -> np.ndarray:
        need = self.batch * (self.seq_len + 1)
        out = np.empty(need, np.int32)
        got = 0
        st = self.state
        while got < need:
            arr = np.load(self.files[st.shard_idx % len(self.files)],
                          mmap_mode="r")
            take = min(need - got, arr.shape[0] - st.offset)
            out[got:got + take] = arr[st.offset:st.offset + take]
            got += take
            st.offset += take
            if st.offset >= arr.shape[0]:
                st.shard_idx += 1
                st.offset = 0
        st.step += 1
        return out.reshape(self.batch, self.seq_len + 1)

    # -- coroutine prefetch (§4.4: tasks with yield points) -----------------
    def _prefetch_task(self):
        while len(self._queue) < self._prefetch:
            self._queue.append(self._read_block())
            yield  # yield point: profiler hook runs, task may migrate

    def next(self) -> np.ndarray:
        if self.runtime is not None:
            self.runtime.spawn(self._prefetch_task(), name="prefetch")
            self.runtime.barrier()
        if self._queue:
            return self._queue.pop(0)
        return self._read_block()

    # -- checkpointable position --------------------------------------------
    def state_dict(self) -> Dict:
        return dataclasses.asdict(self.state)

    def load_state_dict(self, d: Dict):
        self.state = LoaderState(**d)


def make_batch(cfg: ModelConfig, block: np.ndarray, *, pad_id: int = 0
               ) -> Dict[str, np.ndarray]:
    """block: (B, S+1) int32 -> model batch dict (numpy, host-local)."""
    B, S1 = block.shape
    S = S1 - 1
    tokens = block[:, :-1]
    targets = block[:, 1:].astype(np.int32)
    mask = np.ones((B, S), np.float32)
    if cfg.family == "vlm":
        # the stub frontend's patch embeddings fill the first vision_frac
        # of the sequence; text-only M-RoPE ids (all three components
        # equal)
        sv = int(S * cfg.vision_frac)
        rng = np.random.default_rng(int(block[0, 0]) + 17)
        return {
            "tokens": tokens[:, :S - sv].astype(np.int32),
            "vision_embeds": (rng.standard_normal((B, sv, cfg.d_model))
                              * 0.02).astype(np.float32),
            "position_ids": np.broadcast_to(np.arange(S, dtype=np.int32),
                                            (3, B, S)).copy(),
            "targets": targets, "mask": mask,
        }
    if cfg.family == "encdec":
        # S // 2 source frames from the stub frontend, S // 2 target
        # tokens
        st = S // 2
        rng = np.random.default_rng(int(block[0, 0]) + 29)
        return {
            "frame_embeds": (rng.standard_normal((B, st, cfg.d_model))
                             * 0.02).astype(np.float32),
            "tokens": tokens[:, :st].astype(np.int32),
            "targets": targets[:, :st], "mask": mask[:, :st],
        }
    return {"tokens": tokens.astype(np.int32), "targets": targets,
            "mask": mask}
