#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

    python3 chip_smoke.py              # all phases, one card
    python3 chip_smoke.py --profile    # + where phases 3-8 spend their time
    python3 chip_smoke.py --ring-splits  # the bf16 ring kernel by split width
    python3 chip_smoke.py --ssd-head-sets  # the bf16 SSD kernel by head set
    python3 chip_smoke.py --lru-tiles  # the RG-LRU scan kernel by tile
    python3 chip_smoke.py --training-state  # phase 15 alone
    python3 chip_smoke.py --dry-run    # phases 1, 4 and 16
    python3 chip_smoke.py --entry-points  # phases 1 and 17

Phases (any error fails the run with a non-zero exit):

1. Build every kernel from the sources in this checkout, print each
   kernel's registers and spills from the compiler's log, and the card's
   name and power limit.  TF32 is switched off for float32 matmuls
   and convolutions, so float32 references are full float32.
2. Hold the ring-chunk kernels against their plain PyTorch version on the
   card, at the serving path's shape and at the edge geometries (ring
   wrap, a chunk wider than the ring, idle rows and an idle stream, GQA
   8:1, window with softcap, a short history in a wide ring), at phase
   8's dh 256 shape (16 query heads over one kv head) and at phase 9's
   verify width (C = 5, batch buckets 1 and 8, both models), every geometry in
   bf16 (the tensor-core kernel, the ring split across blocks) and the
   float32 ones in float32 too (the FMA kernel): tolerance 2e-2 and 5e-5,
   every row, each launch on its dtype's route, bf16 reruns at both
   serving shapes bit-identical.  Time the bf16 kernel at both shapes
   (the device time of its two kernels from torch.profiler, and CUDA
   events over 30 calls), the plain version and one PyTorch library call
   computing the same function (the same two ways), beside the least time
   the card could take for the bytes and operations this input needs.
3. Serve requests through the port's ``ServeEngine`` on llama3-8b at full
   width and depth (bf16, random weights from a seeded generator): every
   request must complete with its token budget, the ring kernel must have
   launched, every launch on the tensor-core route, prefix sharing must
   have hit, and the pool's audit must pass.
   Then, on a reduced llama3-8b in float32, the engine with the kernel
   must give the same tokens as the engine with the plain attention.
   ``--profile`` also times the two step kinds of the run and replays it
   on a fresh engine under torch.profiler and cProfile.
2b. Hold the flash-attention forward and backward kernels against their
   plain versions (out, lse, dq, dk, dv, every element) at the training
   paths' shapes (phase 4's, and phase 7's dh 256 with one kv head and a
   2048 window), on the ``FA_SWEEP`` geometries, on ragged sequences,
   every head dim, G of 1, 3 and 16, a window and no causal mask, in
   float32 (the FMA kernels) and bf16 (the tensor-core kernels), and on
   q/k/v as strided views of one buffer; a misaligned bf16 view must
   raise, two bf16 backward runs must give bit-identical gradients, and
   every bf16 call must have gone through the tensor-core route.  Time
   both kernels at both training shapes (with the TFLOP/s of needed work
   they reach), their plain versions and
   ``scaled_dot_product_attention`` (forward, and forward + backward; the
   backend it took is printed) beside the least time the card could take.
4. Train llama3.2-3b at full width and depth (bf16, random weights from
   a seeded generator) for 4 steps of the port's ``make_train_step`` at
   B=2, S=2048, on batches a ``SyntheticCorpus`` wrote to a temporary
   directory and the port's ``ShardedLoader`` read back: losses, grad
   norms and the aux loss finite, parameters changed, and both flash
   kernels launched once per layer and step (the forward twice under
   remat).  ``--profile`` adds one more step under torch.profiler.
4b. The port's ``Trainer`` on a reduced llama3.2-3b in float32 on the card:
   6 steps with a checkpoint every 3; a fresh Trainer resumed from step 3
   repeats steps 4-6; the same 6 steps on the CPU (the plain attention)
   give the same losses to 1e-4.
2c. Hold the SSD chunked-scan kernels against their plain version (y and
   h_final, every element) at phase 5's training shape, on the JAX
   ``SSD_SWEEP`` geometries, on two groups and on three groups with
   ragged tiles, each in float32 (the FMA kernel) and with bf16 B/C (the
   tensor-core kernel), every call on its dtype's route (tol 3e-4 and
   2e-2, plus the same share of |plain|; the bf16 kernel at the training
   shape within 2e-3 absolute); time both kernels at the training shape
   (the FMA kernel with float32 B/C), the plain version and the port's
   ``ssd_chunked`` (no single PyTorch call computes an SSD scan: the
   library column stays empty) beside the least time the card could take
   on each route.
5. Train mamba2-780m at full width and depth (48 layers, d_model 1536, 48
   SSD heads of 64, state 128, vocab 50280; bf16, random weights from a
   seeded generator) for 4 steps at B=4, S=2048, remat "none", as phase 4:
   losses and grad norms finite, parameters changed, and the SSD kernel
   launched once per layer and step, every launch on the tensor-core
   route.
5b. The port's ``Trainer`` on a reduced mamba2-780m, as phase 4b.
6. Serve phase 3's requests on mamba2-780m at full width and depth: every
   request completes with its budget, each stream takes a state slot
   (no ring pages, so no prefix sharing, as in the JAX engine), the
   pool's audit passes.  Then, on a reduced mamba2-780m in float32, the
   card's tokens equal the CPU's.
2d. Hold the RG-LRU scan kernel (one pass, one launch) against its plain
   version (h and h_final, every element, tol 1e-5 plus the same share of
   |plain|) forward and in reverse, from zero and from a carried state, at
   phase 7's shape (B=1, S=4096, W=4096), on the JAX ``LRU_SWEEP``
   geometries, ragged S and W, the serving chunk's shape and phase 9's
   verify chunk (S = 5 at batch buckets 1 and 8); the fused
   VJP (one reverse call writing db and da) against its plain version at
   the training shape (tol 1e-4) and, bit for bit, against the unfused
   backward on the same kernel; two runs forward and backward
   bit-identical, and the forward equal bit for bit to the kernel's
   arithmetic in plain PyTorch (``lru_scan_single_pass_ref``), at the
   training shape and at a many-chunk shape (more blocks than the card
   holds at once); the autograd wrapper's gradients against the CPU
   route to 1e-4; time the forward, the fused VJP beside the unfused
   backward (a shifted copy of a, the reverse scan, a multiply) and the
   serving chunk call, by CUDA events and replays of a CUDA graph,
   beside their byte bounds, and the plain version (no
   single PyTorch call computes a linear recurrence: the library column
   stays empty, ``torch.mul`` over the same bytes is printed as a
   yardstick).
7. Train recurrentgemma-9b at full width and 14 layers (four (rec, rec,
   attn) groups and the two-layer tail; bf16, random weights from a
   seeded generator) for 4 steps at B=1, S=4096, remat "none", as phase 4:
   losses and grad norms finite, parameters changed, the scan launched
   forward and in reverse in each rec layer and each flash kernel once in
   each attn layer, every step.
7b. The port's ``Trainer`` on a reduced recurrentgemma-9b, as phase 4b.
8. Serve phase 3's requests on recurrentgemma-9b at full width and depth
   (38 layers): every request completes with its budget, the ring kernel
   (on the tensor-core route) runs in each of the 12 attn layers and the
   scan in each of the 26 rec
   layers every chunk tick, a prompt prefix is shared through the state
   checkpoints, each stream holds ring pages and a state slot, the pool's
   audit passes.  Then, on a reduced recurrentgemma-9b in float32, the
   card's tokens equal the CPU's.
9. Speculative decoding (``spec_k=4``) from phase 3's weights on phase
   3's requests, once with the engine's n-gram drafter and once with a
   partial drafter built from phase 3's tokens (one right token, then
   wrong ones): the partial run must draft, roll back and verify, every
   ring launch on the tensor-core route, the pool's audit passing.  The
   acceptance, the tokens accepted a verify forward, the agreement with
   phase 3's tokens and the latencies of both runs are printed.  After
   phase 8, the same on recurrentgemma-9b at full width and depth from
   phase 8's weights, which must also take state checkpoints and launch
   the RG-LRU kernel.
10. The asynchronous swap tier on phase 3's weights and requests over an
   oversubscribed pool (``ASYNC_ECFG``: one replica group, one domain of
   two 512-token streams), against the synchronous tier: the
   asynchronous run must issue spills, land them rounds later (overlap
   rounds > 0) and recompute nothing, with the pool's audit after every
   transfer transition.
11. Phase 3's requests on an engine warmed by ``warm_steps`` (each paged
   step the serve loop dispatches a CUDA graph): tokens bit-identical to
   phase 3's, graphs replayed (each graph's replays printed).  Then a
   cold and a warmed serve on fresh engines under torch.profiler: the
   ring and RG-LRU kernels the card ran (graph replays included) are the
   same in both, and the cold serve's ring split kernel ran once for each
   launch its wrapper counted.  The capture's seconds and memory, and
   cold against warm tokens/s, TTFT, TPOT and device idle share (the
   profiled serves against the unprofiled walls) are printed.
12. The engine's other modes, right after phase 3, from its weights and
   on its requests (llama3-8b, full width and depth, bf16): (a) the eager
   engine (``lazy=False``: whole-prompt prefill through the flash forward
   kernel, 32 launches a prompt on the tensor-core route, no ring launch,
   9 prefills and no chunk tick, the pool's audit); (b) the slot monolith
   (``paged=False``, two groups: the same counts, ``kv_stats() == {}``,
   the group caches' bytes); (c) the scan chunk path
   (``prefill_mode="scan"``: C model steps a chunk tick, no ring launch),
   then a fresh scan engine warmed by ``warm_steps`` whose tokens are the
   cold scan run's bit for bit, graphs replayed; (d) ``make_prefill`` and
   ``make_generate`` (B=1, greedy) on the first request's prompt.  Each
   run's tokens/s, TTFT and TPOT p50 print beside phase 3's, with the
   share of tokens that agree (printed, not gated: bf16 whole-prompt and
   chunked prefill agree only to tolerance).  (e) After phases 6 and 8,
   the eager engine on mamba2-780m (the SSD kernel, 48 launches a prompt,
   tensor-core route) and recurrentgemma-9b (26 RG-LRU and 12 flash
   forward launches a prompt) from their weights and requests: every
   request completes with its budget.  Phases 2b, 2c and 2d hold the
   three kernels against their plain versions at the shapes this phase
   gives them (one prompt, B=1, at lengths of 96 to 400; the SSD scan's
   one-chunk and front-padded forms), bf16 and float32, with their
   phases' tolerances (``eager_prefill_max_abs_err`` in the kernels line).
13. The MoE family on mixtral-8x22b at full width (d_model 6144, 48/8
   heads, d_ff 16384, 8 experts top-2, window 4096, vocab 32768), cut
   in depth to 8 of its 56 layers (20,435,146,752 parameters, 38.1 GiB
   in bf16: all 56 layers do not fit one card), bf16, random weights
   from seed 0.  (a) Phase 3's requests and ``EngineConfig``: every
   request completes with its budget, 8 ring launches a chunk tick on
   the tensor-core route, a prefix hit, the pool's audit, no claim
   dropped in a serving step (they run the experts dropless); then the
   same requests on a fresh engine warmed by ``warm_steps``, whose
   tokens must be the cold run's bit for bit with graphs replayed.
   Tokens/s, TTFT and TPOT p50 of both print beside the decode step's
   byte bound (every weight but the embedding read once).  (b) The eager
   engine on the same weights and requests: 8 flash forward launches a
   prompt on the tensor-core route, no ring launch; its prefills keep
   capacity factor 1.25 and drop claims (the share printed), so its
   agreement with (a) is printed, not gated.  (c) One layer at B=1,
   S=8192 for 4 steps (remat "none", AdamW with float32 moments):
   losses, grad norms and ``aux`` finite, ``dropped`` in [0, 1), the
   router, an expert's ``wi`` and ``wq`` changed, each flash kernel once
   a step; the window masks half the causal band.  (d) The reduced
   float32 reference runs of mixtral-8x22b (with every card variant of
   the dense model) and grok-1-314b (gelu experts, the 30.0 softcap),
   and reduced mixtral-8x22b at capacity factor 1.0 through
   ``make_prefill`` + ``make_generate``: the card drops claims and gives
   the CPU's logits (1e-4) and tokens.  Phases 2 and 2b hold the ring
   and flash kernels at this phase's shapes (G = 6 at dh 128: the chunk,
   the verify widths, a 4096-token ring with the window acting; the
   eager prompts and the training shape), bf16 and float32
   (``moe_max_abs_err`` and ``moe_eager_prefill_max_abs_err`` in the
   kernels line).  The phase prints its seconds.
14. The VLM and encoder-decoder families at full width and depth, bf16,
   random weights from a seeded generator.  (a) Phase 3's requests on
   qwen2-vl-2b served text-only, cold (28 ring launches a chunk tick on
   the tensor-core route, a prefix hit, the pool's audit) and after
   ``warm_steps`` (tokens bit-identical).  (b) Its vision frontend:
   ``make_prefill`` on a ``make_batch`` batch (B=2, S=2048, 512 patch
   embeddings) with M-RoPE ids that differ over the vision span (28
   flash launches, finite logits that the ids move), 32 ``make_generate``
   steps, then 4 training steps at B=2, S=2048.  (c) seamless-m4t-large-
   v2 trained 4 steps at B=2, S=2048 (1024 frames, 1024 target tokens):
   24 encoder, 24 decoder and 24 cross-attention blocks a step, each one
   flash forward and backward.  (d) Its model-level serving: 4 streams
   of 4096 frames and 32-token prefixes through ``make_prefill`` (72
   flash launches) and 32 ``make_generate`` steps; the chunked twin
   (``prefill_chunk_step``, blocked: the ring kernel at G = 1, dh 64 and
   cross flash at Sq = 16, Skv = 4096), its tokens' agreement printed;
   a scan verify of 4 drafted tokens equal to 4 decode steps (the scan
   identity only), then the fused verify (ring at C = 4, cross flash at
   Sq = 4), its launches gated and its agreement printed.  (e) The
   reduced float32 VLM engine variants, both reduced Trainers and the
   reduced seamless prefill and chunk paths, card against CPU.  Phases 2
   and 2b hold the ring and flash kernels at these shapes (``vlm_*``,
   ``encdec_*`` and ``ragged_sq_over_skv`` rows, bf16 and float32).  The
   phase prints its seconds.
15. The rest of the training path.  (a) recurrentgemma-9b at full width
   and all 38 layers, bf16, random weights from seed 0, B=1, S=4096
   (2048 if 4096 runs out of memory: both attempts' peaks print), remat
   "full", ``make_train_step(opt_impl="adamw8bit")``, 4 steps: losses
   and grad norms finite, parameters changed, moments int8 / uint8, a
   step's launches gated (the scan forward and its VJP in each of the 26
   rec layers, the 24 in groups forward twice: 76; flash forward twice
   and backward once in each of the 12 attn layers); seconds a step,
   tokens/s, peak GiB and the 8-bit update's own seconds (a spy
   synchronises around it).  (b) Phase 7's 14 layers and shape with the
   8-bit AdamW: peak and seconds a step beside phase 7's.  (c)
   mamba2-780m at phase 5's shape with int8 error-feedback compression
   (``ef_transform``): the SSD kernel's launches, finite losses, non-zero
   buffers after step 1, seconds a step beside phase 5's; the reduced
   float32 ``Trainer(compress_cross_pod=True)`` on the card against the
   CPU (1e-4).  (d) An NCCL process group of one rank and a (1, 1) mesh:
   ``make_train_step_smap`` against ``make_train_step`` on reduced
   float32 llama3-8b with both optimizers (parameters after 3 steps
   within 1e-5), the Trainer on the mesh against the one-card Trainer,
   the 8-bit state through a sharded save and restore; (e) the spmd
   train step against ``make_train_step`` at full width (phase 4's cell
   and ``SPMD_FAMILY_CELLS``); (f) the spmd serving steps
   (``make_prefill_spmd``, ``make_serve_step_spmd``) against
   ``make_prefill`` / ``make_serve_step`` on the same mesh at full width
   (``SPMD_SERVE_CELLS``: a prefill and 32 greedy steps each): tokens,
   logits and the final cache equal bit for bit, each kernel's prefill
   launches as its layers call it; and the split-window attention and
   cut cache write of a ring over 16 ranks, emulated on the batch axis
   (``split_window_check``).  The phase prints its seconds.
16. The dry run against the card (``repro_torch.launch.dryrun``: a
   rank's step traced on fake ``cuda`` tensors, nothing launched).  (a)
   Phase 4's own cell at world 1 (llama3.2-3b, B=2, S=2048, remat
   "none", float32 AdamW, one microbatch, a (1, 1) mesh): each kernel's
   dry launches a step must equal phase 4's launches a step, and the
   dry run's peak bytes must lie within 10% of phase 4's
   ``max_memory_allocated``; its flops beside ``model_flops`` and the
   roofline's bound beside phase 4's seconds a step are printed.  (b)
   llama3-8b's three single-pod production cells (``train_4k``,
   ``prefill_32k``, ``decode_32k`` on the (16, 16) mesh), each in a
   process of its own, started together: each must end "ok"; their
   ``[dryrun]`` lines print.  The phase prints its seconds.
17. The user entry points, last: the port's twins of the four examples
   (``examples/{quickstart,elastic_restart,train_e2e,serve_adaptive}
   _torch.py``), each ``main()`` on the card at its JAX example's own
   size, ``train_e2e_torch.py`` at its 300 steps of ``model_100m()``
   (125.8M parameters, float32) at B 8, S 256.  All four models are
   float32: every attention launch must take the FMA route, with the
   flash kernels' launches a forward and a backward a layer and step
   (and a forward a layer in quickstart's prefill) and the ring's one a
   layer and chunk tick; every geometry a twin gave a kernel must be a
   row of ``RING_GEOMETRIES`` / ``FLASH_GEOMETRIES`` (their ``entry_*``
   rows), which phases 2 and 2b hold.  Fails if train_e2e's mean loss of
   the last 10 steps is not below the first 10's, if elastic_restart does
   not resume at step 10, or if serve_adaptive leaves a request
   unfinished or fails the pool's audit.  Prints each twin's seconds and
   peak, train_e2e's seconds a step (steps 2-300), tokens/s, peak GiB and
   loss, serve_adaptive's decisions and relayouts, and the phase's
   seconds.
The reduced float32 reference runs of phases 3, 6 and 8 include card runs
with speculative decoding (a partial drafter), warmed steps and (phase
12 (f)) the eager engine, the slot monolith and the scan chunk path, and
on the dense and hybrid models the asynchronous swap tier (dense: a pool
of one stream a domain; hybrid: a park forced mid-decode, spilled with
its state slot); their tokens must equal the CPU run's, and after the
card's monolith run ``make_prefill`` + ``make_generate`` must give the
monolith's tokens for the first prompt.

The last line is ``{"ok": true, "device": {...}}``; the line before it
lists every kernel with its launches (counted over its main path: phase
3 for the ring kernel, phase 4 for the flash kernels, phase 5 for the SSD
kernel, phase 7 for the RG-LRU scan; ``hybrid_*`` and
``serving_launches`` give the numbers on the hybrid's paths, phases 7
and 8; ``eager_prefill_launches`` and ``hybrid_eager_prefill_launches``
phase 12's, over the eager engine's 9 prefills; ``moe_launches`` phase
13's serving (ring) and training (flash), ``moe_eager_prefill_launches``
its eager prefills; ``vlm_*`` and ``encdec_*`` phase 14's launches and
errors; ``hybrid38_launches`` and ``ef_launches`` phase 15's,
``spmd_*`` its (e) and ``spmd_serve_*`` its (f) launches; ``tp_prefill_*``
the flash forward at the spmd prefill's rank shape, phase 2b;
``starcoder_*`` the errors at starcoder2-15b's G = 12; ``entry_launches``
phase 17's by twin, ``entry_*max_abs_err`` the errors at its rows), error
and times.
"""
from __future__ import annotations

import argparse
import gc
import io
import json
import math
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"

# bf16 and f32 tolerances of the JAX package's kernel tests
TOL = {"bfloat16": 2e-2, "float32": 5e-5}
# the JAX package's flash-attention tests: forward 2e-5 in float32,
# gradients 2e-4; 2e-2 in bf16
FLASH_TOL = {("fwd", "float32"): 2e-5, ("bwd", "float32"): 2e-4,
             ("fwd", "bfloat16"): 2e-2, ("bwd", "bfloat16"): 2e-2}
PEAK_BYTES = 3.35e12        # H100 SXM HBM3, data sheet
PEAK_FLOPS = 989e12         # H100 SXM dense bf16 tensor cores, data sheet


def log(*a):
    print(*a, flush=True)


# ---------------------------------------------------------------------------
# phase 1
# ---------------------------------------------------------------------------

def phase_build(torch):
    from repro_torch.kernels import build
    t0 = time.perf_counter()
    libs = build.build()
    log(f"[build] {len(libs)} kernel(s) in {time.perf_counter() - t0:.1f} s")
    for name, lib in libs.items():
        log(f"[build] {name}: {lib.relative_to(ROOT)}")
        for line in lib.with_suffix(".log").read_text().splitlines():
            if any(key in line for key in ("entry function", ": Used ",
                                           "spill stores")):
                log(f"[build]   {line.strip()}")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60)
    card = smi.stdout.strip().splitlines()[0]
    log(card)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log("[build] TF32 off: torch.backends.cuda.matmul.allow_tf32 = False, "
        "torch.backends.cudnn.allow_tf32 = False")
    return card


# ---------------------------------------------------------------------------
# phase 2
# ---------------------------------------------------------------------------

# name, B, C, W, Hq, Hkv, dh, pos, n_tokens, window, softcap, dtype
RING_GEOMETRIES = [
    ("main_path", 8, 16, 1024, 32, 8, 128,
     (0, 16, 208, 1008, 1024, 1500, 3000, 64),
     (16, 16, 16, 16, 16, 16, 9, 0), 0, 0.0, "bfloat16"),
    ("ring_wrap", 2, 6, 8, 4, 4, 16, (13, 27), (6, 6), 0, 0.0, "float32"),
    ("chunk_wider_than_ring", 2, 10, 8, 4, 2, 16, (5, 21), (10, 7), 0, 0.0,
     "float32"),
    ("idle_rows", 3, 4, 8, 2, 1, 16, (0, 5, 9), (0, 0, 4), 0, 0.0,
     "float32"),
    ("gqa_8_to_1", 1, 4, 8, 8, 1, 32, (11,), (4,), 0, 0.0, "float32"),
    ("window_softcap", 2, 8, 16, 4, 2, 32, (20, 3), (8, 5), 7, 30.0,
     "float32"),
    ("main_path_f32_window", 2, 16, 1024, 32, 8, 128, (700, 2100),
     (16, 11), 256, 0.0, "float32"),
    ("short_history", 3, 16, 1024, 8, 2, 128, (0, 37, 500), (16, 16, 7), 0,
     0.0, "float32"),
    # recurrentgemma-9b's local attention in phase 8's chunk step: dh 256,
    # 16 query heads over one kv head, ring 1024 (= max_len, under the
    # 2048 window)
    ("hybrid_path", 8, 16, 1024, 16, 1, 256,
     (0, 16, 208, 1008, 1024, 1500, 3000, 64),
     (16, 16, 16, 16, 16, 16, 9, 0), 2048, 0.0, "bfloat16"),
    ("hybrid_path_f32", 2, 16, 1024, 16, 1, 256, (700, 2100), (16, 11),
     2048, 0.0, "float32"),
    ("dh256_wrap_window", 2, 10, 8, 16, 1, 256, (5, 21), (10, 7), 5, 0.0,
     "float32"),
    # phase 9's verify and reapply calls: C = spec_w = 5 at the batch
    # buckets 1 and 8, a row's n_tokens its draft plus one (an idle
    # padding row at pos 0), positions under the 1024-token max_len.
    # llama3-8b (G 4: 20 query rows), recurrentgemma-9b (G 16: 80 query
    # rows over two 64-row wgmma tiles, window 2048)
    ("verify_dense_b1", 1, 5, 1024, 32, 8, 128, (411,), (5,), 0, 0.0,
     "bfloat16"),
    ("verify_dense_b8", 8, 5, 1024, 32, 8, 128,
     (37, 120, 263, 511, 700, 905, 1019, 0), (5, 5, 4, 5, 2, 5, 5, 0), 0,
     0.0, "bfloat16"),
    ("verify_hybrid_b1", 1, 5, 1024, 16, 1, 256, (411,), (5,), 2048, 0.0,
     "bfloat16"),
    ("verify_hybrid_b8", 8, 5, 1024, 16, 1, 256,
     (37, 120, 263, 511, 700, 905, 1019, 0), (5, 5, 4, 5, 2, 5, 5, 0), 2048,
     0.0, "bfloat16"),
    # phase 13's mixtral-8x22b: G = 6 (48 query heads over 8 kv heads) at
    # dh 128, window 4096.  The serving chunk (96 query rows a kv head:
    # query 10's six heads straddle the 64-row wgmma tile), its float32
    # twin, the verify step's C = 5 at buckets 1 and 8 (30 rows), and a
    # 4096-token ring with the window acting, positions past 4096 wrapped
    ("moe_path", 8, 16, 1024, 48, 8, 128,
     (0, 16, 208, 1008, 1024, 1500, 3000, 64),
     (16, 16, 16, 16, 16, 16, 9, 0), 4096, 0.0, "bfloat16"),
    ("moe_path_f32", 2, 16, 1024, 48, 8, 128, (700, 2100), (16, 11), 4096,
     0.0, "float32"),
    ("verify_moe_b1", 1, 5, 1024, 48, 8, 128, (411,), (5,), 4096, 0.0,
     "bfloat16"),
    ("verify_moe_b8", 8, 5, 1024, 48, 8, 128,
     (37, 120, 263, 511, 700, 905, 1019, 0), (5, 5, 4, 5, 2, 5, 5, 0), 4096,
     0.0, "bfloat16"),
    ("moe_window_4096", 3, 16, 4096, 48, 8, 128, (4100, 5000, 9007),
     (16, 11, 16), 4096, 0.0, "float32"),
    # phase 14: qwen2-vl-2b's chunk tick (G 6 over 2 kv heads at dh 128:
    # 96 query rows a kv head) and its float32 twin; seamless-m4t-large-
    # v2's chunk step (MHA, G 1 at dh 64) over a 256-slot ring, in bf16
    # and float32.  Each has a wrapped ring, a decode row (n_tokens 1) and
    # an idle row.  Last, seamless's fused verify step (C = 4) over the
    # same ring, with a partial and an idle row
    ("vlm_chunk", 8, 16, 1024, 12, 2, 128,
     (0, 16, 208, 1008, 1024, 1500, 3000, 64),
     (16, 16, 16, 16, 1, 16, 9, 0), 0, 0.0, "bfloat16"),
    ("vlm_chunk_f32", 3, 16, 1024, 12, 2, 128, (700, 2100, 64), (16, 1, 0),
     0, 0.0, "float32"),
    ("encdec_chunk", 4, 16, 256, 16, 16, 64, (0, 300, 600, 32),
     (16, 16, 1, 0), 0, 0.0, "float32"),
    ("encdec_verify", 4, 4, 256, 16, 16, 64, (32, 120, 300, 0),
     (4, 3, 4, 0), 0, 0.0, "float32"),
    # starcoder2-15b: G = 12 (48 query heads over 4 kv heads) at dh 128,
    # no window — 192 query rows a kv head at C = 16, three 64-row wgmma
    # tiles — a chunk tick and its float32 twin
    ("starcoder_chunk", 8, 16, 1024, 48, 4, 128,
     (0, 16, 208, 1008, 1024, 1500, 3000, 64),
     (16, 16, 16, 16, 1, 16, 9, 0), 0, 0.0, "bfloat16"),
    ("starcoder_chunk_f32", 2, 16, 1024, 48, 4, 128, (700, 2100), (16, 11),
     0, 0.0, "float32"),
    # phase 17's serve_adaptive: reduced mixtral-8x22b (float32, 4 query
    # heads over one kv head, dh 16) chunk ticks of 16 over its 64-slot
    # ring (window 64, max_len 96) at one and two streams a group; a
    # prompt's first chunk, a wrapped ring and a partial chunk
    ("entry_serve_b1", 1, 16, 64, 4, 1, 16, (32,), (16,), 64, 0.0,
     "float32"),
    ("entry_serve_b2", 2, 16, 64, 4, 1, 16, (48, 80), (16, 11), 64, 0.0,
     "float32"),
]


def ring_inputs(torch, B, C, W, Hq, Hkv, dh, pos, nt, dtype, seed):
    g = torch.Generator(device="cuda").manual_seed(seed)
    dt = getattr(torch, dtype)

    def rnd(*shape):
        return torch.randn(shape, generator=g, device="cuda").to(dt)

    return (rnd(B, C, Hq, dh), rnd(B, C, Hkv, dh), rnd(B, C, Hkv, dh),
            rnd(B, W, Hkv, dh), rnd(B, W, Hkv, dh),
            torch.tensor(pos, dtype=torch.int32, device="cuda"),
            torch.tensor(nt, dtype=torch.int32, device="cuda"))


def time_ms(torch, fn, sets, iters=30, warmup=3):
    """Mean device time of ``fn(*inputs)`` over ``iters`` launches, cycling
    through several input sets so repeated launches do not find the K/V
    bytes in the 50 MB L2."""
    for i in range(warmup):
        fn(*sets[i % len(sets)])
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for i in range(iters):
        fn(*sets[i % len(sets)])
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def graph_ms(torch, fn, sets, iters=30, replays=3):
    """Mean time of a call of ``fn(*inputs)`` when ``iters`` calls
    (cycling the input sets) are captured in one CUDA graph and replayed:
    the card's time for the calls without the host's between them.  A
    call that cannot be captured (a host synchronisation in it) raises."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for i in range(3):
            fn(*sets[i % len(sets)])
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for i in range(iters):
            fn(*sets[i % len(sets)])
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    del graph
    return start.elapsed_time(end) / (replays * iters)


def device_ms(torch, fn, sets, symbols, iters=30):
    """Mean device time a call of ``fn(*inputs)`` spends in the kernels
    whose names contain one of ``symbols``, from torch.profiler's kernel
    events over ``iters`` calls (cycling the input sets): symbol -> ms.
    Unlike ``time_ms`` it leaves out host time between launches."""
    fn(*sets[0])
    torch.cuda.synchronize()
    prof = torch.profiler.profile(activities=[
        torch.profiler.ProfilerActivity.CPU,
        torch.profiler.ProfilerActivity.CUDA])
    with prof:
        for i in range(iters):
            fn(*sets[i % len(sets)])
        torch.cuda.synchronize()
    spent = dict.fromkeys(symbols, 0.0)
    for e in prof.key_averages():
        if not str(getattr(e, "device_type", "")).endswith("CUDA"):
            continue
        dev = getattr(e, "self_device_time_total",
                      getattr(e, "self_cuda_time_total", 0.0))
        for sym in symbols:
            if sym in e.key:
                spent[sym] += dev / 1e3 / iters
    return spent


def phase_ring_kernel(torch):
    from repro_torch.kernels.flash_attention import ops, ref

    # the main path is bf16: its source is the tensor-core kernel; float32
    # calls take the FMA kernel of ``f32_source``
    row = {"name": "ring_chunk_attention", "route": "cuda",
           "source": FLASH_SOURCE + "ring_chunk_attention_wgmma.cu",
           "replaces": "src/repro/kernels/flash_attention/kernel.py:220",
           "f32_source": FLASH_SOURCE + "ring_chunk_attention.cu",
           "design": "wgmma+tma, ring split across blocks"}
    fn = ops.ring_chunk_attention
    before = (fn.launches, fn.wgmma_launches)
    calls = {"bfloat16": 0, "float32": 0}
    for (name, B, C, W, Hq, Hkv, dh, pos, nt, window, softcap,
         dtype) in RING_GEOMETRIES:
        # every geometry in bf16 (the tensor-core route), and the float32
        # ones in float32 too (the FMA route)
        for dt in dict.fromkeys((dtype, "bfloat16")):
            ins = ring_inputs(torch, B, C, W, Hq, Hkv, dh, pos, nt, dt,
                              seed=len(name))
            out = fn(*ins, window=window, softcap=softcap)
            torch.cuda.synchronize()
            calls[dt] += 1
            want = ref.ring_chunk_attention_ref(*ins, window=window,
                                                softcap=softcap)
            # every row, active or not: the kernel's tile skip must leave
            # even the rows past n_tokens as the plain version has them
            o, w = out.float(), want.float()
            err = (o - w).abs()
            tol = TOL[dt]
            max_err = float(err.max())
            bad = bool((err > tol + tol * w.abs()).any())
            if not torch.isfinite(o).all():
                raise AssertionError(f"{name} {dt}: kernel output not "
                                     "finite")
            # a row with no visible key (stream idle at pos 0) is exactly 0
            for b in range(B):
                if pos[b] == 0 and nt[b] == 0 and o[b].abs().max() != 0:
                    raise AssertionError(f"{name} {dt}: idle row of stream "
                                         f"{b} not 0")
            extra = ""
            if dt == "bfloat16" and name in ("main_path", "hybrid_path"):
                # the splits merge in a fixed order: a rerun is identical
                again = fn(*ins, window=window, softcap=softcap)
                calls[dt] += 1
                if not torch.equal(out, again):
                    raise AssertionError(f"{name}: two bf16 runs differ")
                extra = "; a second run is bit-identical"
            log(f"[ring] {name}: {dt} B={B} C={C} W={W} Hq={Hq} Hkv={Hkv} "
                f"dh={dh} max_abs_err={max_err:.3e} (tol {tol})" + extra)
            if bad:
                raise AssertionError(f"{name} {dt}: kernel disagrees with the "
                                     f"plain version beyond {tol}")
            if name == "main_path":
                row["max_abs_err"] = max_err
            elif name == "hybrid_path":
                row["hybrid_max_abs_err"] = max_err
            elif name.startswith(("moe_", "verify_moe")) and dt == "bfloat16":
                row["moe_max_abs_err"] = max(row.get("moe_max_abs_err", 0.0),
                                             max_err)
            elif name.startswith(("vlm_", "encdec_", "starcoder_",
                                  "entry_")):
                key = name.split("_")[0] + ("_max_abs_err" if dt == "bfloat16"
                                            else "_f32_max_abs_err")
                row[key] = max(row.get(key, 0.0), max_err)
    routes = {"wgmma": fn.wgmma_launches - before[1],
              "fma": fn.launches - before[0] - (fn.wgmma_launches - before[1])}
    want_routes = {"wgmma": calls["bfloat16"], "fma": calls["float32"]}
    log(f"[ring] launches by route: {routes} for {calls['bfloat16']} bf16 and "
        f"{calls['float32']} float32 calls")
    if routes != want_routes:
        raise AssertionError(f"ring launches by route {routes}, expected "
                             f"{want_routes}: a bf16 call did not take the "
                             "tensor-core kernel")
    for name, prefix in (("main_path", ""), ("hybrid_path", "hybrid_")):
        row.update({prefix + k: v
                    for k, v in ring_timing(torch, name).items()})
    return row


def ring_split_sweep(torch):
    """``--ring-splits``: the bf16 ring kernel at both serving shapes with
    ring splits of 1, 2, 4, 8 and 16 tiles (``ops.ring_split``, which picks
    the width from the shapes, is replaced for the sweep): device time of
    the split kernel and the merge, CUDA-event time, and the error against
    the plain version."""
    from repro_torch.kernels.flash_attention import ops
    chosen = ops.ring_split
    try:
        for name in ("main_path", "hybrid_path"):
            sets, kernel, plain, _, _ = ring_case(torch, name)
            want = plain(*sets[0]).float()
            B, C, Hq, _ = sets[0][0].shape
            W, Hkv = sets[0][3].shape[1], sets[0][3].shape[2]
            tiles = -(-W // ops.RING_TILE)
            tol = TOL["bfloat16"]
            for per in (1, 2, 4, 8, 16):
                split = (per, -(-tiles // per) + 1)
                ops.ring_split = lambda *shape, _s=split: _s
                err = (kernel(*sets[0]).float() - want).abs()
                if bool((err > tol + tol * want.abs()).any()):
                    raise AssertionError(f"{name}, splits of {per} tiles: "
                                         f"kernel disagrees beyond {tol}")
                parts = device_ms(torch, kernel, sets, ("ring_wgmma_kernel",
                                                        "ring_combine_kernel"))
                ms = time_ms(torch, kernel, sets)
                log(f"[ring-splits] {name}: {split[1]} splits (ring splits "
                    f"of {per} tiles): split kernel "
                    f"{parts['ring_wgmma_kernel']:.4f} ms, merge "
                    f"{parts['ring_combine_kernel']:.4f} ms, events "
                    f"{ms:.4f} ms, max_abs_err {float(err.max()):.3e}"
                    + (" (ring_split's choice)"
                       if split == chosen(B, C, W, Hq, Hkv) else ""))
    finally:
        ops.ring_split = chosen


def ring_work(torch, ins, mask):
    """Bytes and flops this input needs: q and pos/n_tokens read and the
    output written in full; of the ring and chunk K/V only the slots that
    some active query row (t < n_tokens) can see; QK^T and PV over the
    visible (active row, key) pairs."""
    q, k_new = ins[0], ins[1]
    B, C, Hq, dh = q.shape
    Hkv = k_new.shape[2]
    active = torch.arange(C, device=q.device)[None, :] < ins[6][:, None]
    seen = mask & active[:, :, None]                        # (B, C, W+C)
    n_keys = int(seen.any(dim=1).sum())                     # (stream, slot)
    kv_bytes = 2 * n_keys * Hkv * dh * k_new.element_size()
    n_bytes = (2 * q.numel() * q.element_size() + kv_bytes
               + ins[5].numel() * 4 + ins[6].numel() * 4)
    return n_bytes, 4.0 * dh * Hq * float(seen.sum())


def ring_case(torch, name):
    """The bf16 kernel, its plain version and the SDPA yardstick at the
    serving shape ``name`` of ``RING_GEOMETRIES``, on four input sets
    (cycled past the 50 MB L2), and the band mask of the first."""
    import functools
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention import ops, ref
    geo = next(g for g in RING_GEOMETRIES if g[0] == name)
    B, C, W, Hq, Hkv, dh, pos, nt, window, _, dtype = geo[1:]
    sets = [ring_inputs(torch, B, C, W, Hq, Hkv, dh, pos, nt, dtype,
                        seed=100 + i) for i in range(4)]
    mask = ref.visible(sets[0][5], sets[0][6], W, C, window)  # (B,C,W+C)
    G = Hq // Hkv

    def sdpa(q, kn, vn, kc, vc, p, n, _mask=mask[:, None]):
        # yardstick only: the port never calls it
        k = torch.cat([kc, kn], 1).transpose(1, 2)
        v = torch.cat([vc, vn], 1).transpose(1, 2)
        return F.scaled_dot_product_attention(
            q.transpose(1, 2), k, v, attn_mask=_mask, enable_gqa=G > 1)

    return (sets, functools.partial(ops.ring_chunk_attention, window=window),
            functools.partial(ref.ring_chunk_attention_ref, window=window),
            sdpa, mask)


def ring_timing(torch, name):
    """CUDA-event times of 30 back-to-back calls at one serving shape: the
    bf16 kernel (``events_ms``, the host's gaps between calls included),
    its plain version and the yardstick (``library_events_ms``), beside the
    bound.  ``ring_device_times`` adds the device times."""
    from repro_torch.kernels.flash_attention import ops
    sets, kernel, plain, sdpa, mask = ring_case(torch, name)
    q = sets[0][0]
    B, C, Hq, dh = q.shape
    W, Hkv = sets[0][3].shape[1], sets[0][3].shape[2]
    events_ms = time_ms(torch, kernel, sets)
    plain_ms = time_ms(torch, plain, sets)
    library_events_ms = time_ms(torch, sdpa, sets)
    n_bytes, flops = ring_work(torch, sets[0], mask)
    bound_bytes, bound_flops = n_bytes / PEAK_BYTES, flops / PEAK_FLOPS
    bound_ms = 1e3 * max(bound_bytes, bound_flops)
    tiles, splits = ops.ring_split(B, C, W, Hq, Hkv)
    log(f"[ring] B={B} C={C} W={W} Hq={Hq} Hkv={Hkv} dh={dh} {q.dtype}: "
        f"events_ms={events_ms:.4f} plain_ms={plain_ms:.4f} "
        f"library_events_ms={library_events_ms:.4f} bound_ms={bound_ms:.6f} "
        f"({n_bytes} bytes, {flops:.0f} flops needed); {splits} splits "
        f"(ring splits of {tiles} tiles of {ops.RING_TILE} slots, and the "
        "chunk's); SDPA backend: " + sdpa_backend(torch, sdpa, sets[0]))
    return {"plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": "bytes" if bound_bytes >= bound_flops
            else "operations", "splits": splits, "events_ms": events_ms,
            "library_events_ms": library_events_ms}


def ring_device_times(torch, row):
    """The ring row's ``ms`` and ``library_ms``: device times a call from
    torch.profiler's kernel events — the split kernel and the merge, and
    every kernel of the yardstick's call — at both serving shapes.  A call
    of either is tens of microseconds on the device, less than the host's
    Python around it, so CUDA events would time the host.  Run after the
    kernel phases, which CUDA events time (a profiler session can slow the
    launches that follow it), and before the model phases: after the whole
    script the profiler recorded almost none of the ring kernels' events
    (0.0 and 0.00095 ms a call)."""
    for name, prefix in (("main_path", ""), ("hybrid_path", "hybrid_")):
        sets, kernel, _, sdpa, _ = ring_case(torch, name)
        parts = device_ms(torch, kernel, sets, ("ring_wgmma_kernel",
                                                "ring_combine_kernel"))
        library = device_ms(torch, sdpa, sets, ("",))[""]   # "": every one
        row[prefix + "ms"] = sum(parts.values())
        row[prefix + "library_ms"] = library
        log(f"[ring] {name} device time a call (profiler): kernel_ms="
            f"{row[prefix + 'ms']:.4f} (split kernel "
            f"{parts['ring_wgmma_kernel']:.4f}, merge "
            f"{parts['ring_combine_kernel']:.4f}), library_ms={library:.4f} "
            f"(events: {row[prefix + 'events_ms']:.4f} and "
            f"{row[prefix + 'library_events_ms']:.4f})")


# ---------------------------------------------------------------------------
# phase 2b
# ---------------------------------------------------------------------------

# name, B, Sq, Skv, Hq, Hkv, dh, causal, window
FLASH_MAIN = ("main_path", 2, 2048, 2048, 24, 8, 128, True, 0)
# phase 7's shape: recurrentgemma-9b's local attention, dh 256, 16 query
# heads over one kv head, window 2048 at S 4096
FLASH_HYBRID = ("hybrid_path", 1, 4096, 4096, 16, 1, 256, True, 2048)
FLASH_GEOMETRIES = [
    ("fa_sweep_0", 2, 128, 128, 4, 2, 64, True, 0),
    ("fa_sweep_1", 1, 256, 256, 4, 4, 32, True, 64),
    ("fa_sweep_2", 2, 128, 128, 8, 2, 64, False, 0),
    ("fa_sweep_3", 1, 128, 128, 2, 1, 128, True, 32),
    ("fa_sweep_4", 2, 64, 64, 4, 1, 64, True, 0),
    ("fa_sweep_5", 1, 192, 192, 6, 3, 32, True, 48),
    ("ragged_s200", 2, 200, 200, 6, 2, 16, True, 0),
    ("ragged_dh256", 1, 1000, 1000, 16, 1, 256, True, 300),
    ("ragged_not_causal_dh128", 1, 77, 77, 4, 4, 128, False, 0),
    ("gqa3_window_dh128", 1, 300, 300, 6, 2, 128, True, 100),
    ("not_causal_dh256", 2, 130, 130, 4, 2, 256, False, 0),
    ("gqa16_ragged_dh64", 1, 333, 333, 16, 1, 64, True, 0),
    # phase 12's whole-prompt prefill: one prompt (B=1) at the shortest,
    # a middle and the longest length ``serve`` submits, on llama3-8b and
    # on recurrentgemma-9b's local attention
    ("eager_prefill_dense_s96", 1, 96, 96, 32, 8, 128, True, 0),
    ("eager_prefill_dense_s148", 1, 148, 148, 32, 8, 128, True, 0),
    ("eager_prefill_dense_s400", 1, 400, 400, 32, 8, 128, True, 0),
    ("eager_prefill_hybrid_s148", 1, 148, 148, 16, 1, 256, True, 2048),
    ("eager_prefill_hybrid_s400", 1, 400, 400, 16, 1, 256, True, 2048),
    # phase 13's mixtral-8x22b, G = 6 at dh 128, window 4096: the eager
    # engine's prompts (the window inert) and the training shape, where
    # the window masks half of the causal band
    ("eager_prefill_moe_s96", 1, 96, 96, 48, 8, 128, True, 4096),
    ("eager_prefill_moe_s148", 1, 148, 148, 48, 8, 128, True, 4096),
    ("eager_prefill_moe_s400", 1, 400, 400, 48, 8, 128, True, 4096),
    ("moe_train", 1, 8192, 8192, 48, 8, 128, True, 4096),
    # phase 14: qwen2-vl-2b training and whole-prompt prefill (G 6 at dh
    # 128 over 2 kv heads); seamless-m4t-large-v2 (MHA 16/16 at dh 64) at
    # the training shape (1024 frames, 1024 target tokens): the encoder's
    # non-causal self-attention (cross-attention has its shape), the
    # decoder's causal one; in prefill the encoder over 4096 frames, the
    # decoder's causal self-attention over the 32-token prefixes (one
    # partial tile with the diagonal inside it) and cross-attention of 32
    # queries over the frames, and of a 16-wide chunk step and the fused
    # verify step's 4 tokens; a ragged row with more queries than keys
    ("vlm_train", 2, 2048, 2048, 12, 2, 128, True, 0),
    ("encdec_enc", 2, 1024, 1024, 16, 16, 64, False, 0),
    ("encdec_dec", 2, 1024, 1024, 16, 16, 64, True, 0),
    ("encdec_enc_prefill", 4, 4096, 4096, 16, 16, 64, False, 0),
    ("encdec_dec_prefill", 4, 32, 32, 16, 16, 64, True, 0),
    ("encdec_cross_prefill", 4, 32, 4096, 16, 16, 64, False, 0),
    ("encdec_cross_chunk", 4, 16, 4096, 16, 16, 64, False, 0),
    ("encdec_cross_verify", 4, 4, 4096, 16, 16, 64, False, 0),
    ("ragged_sq_over_skv", 1, 300, 77, 16, 16, 64, False, 0),
    # starcoder2-15b's G = 12 (48 query heads over 4 kv heads) at dh 128,
    # causal, no window
    ("starcoder_s2048", 1, 2048, 2048, 48, 4, 128, True, 0),
    # the spmd train step's local heads on a 16-wide model axis at the
    # train_4k cell's microbatch (B=2, S=4096): llama3-8b's 2 query heads
    # over the one kv head they read (G = 2); mixtral-8x22b's,
    # nemotron-4-15b's and starcoder2-15b's 3 (G = 3, an odd group inside
    # a 64-row tile)
    ("tp_g2_s4096", 2, 4096, 4096, 2, 1, 128, True, 0),
    ("tp_g3_s4096", 2, 4096, 4096, 3, 1, 128, True, 0),
    # and on the same axis recurrentgemma-9b's local attention (1 of the
    # 16 query heads over the one kv head, dh 256, window 2048) and
    # seamless-m4t-large-v2's (1 of 16 heads over its own kv head, dh 64,
    # 2048 source frames and 2048 target tokens a row): the encoder's
    # non-causal self-attention — the decoder's cross-attention has its
    # shape at this cell, where the two lengths are equal — and the
    # decoder's causal one
    ("tp_hybrid_g1_s4096", 2, 4096, 4096, 1, 1, 256, True, 2048),
    ("tp_encdec_enc_s2048", 2, 2048, 2048, 1, 1, 64, False, 0),
    ("tp_encdec_dec_s2048", 2, 2048, 2048, 1, 1, 64, True, 0),
    # phase 17's twins of the examples, all float32: reduced llama3-8b (4
    # query heads over one kv head, dh 16) trained at B 4 (quickstart) and
    # B 8 (elastic_restart), S 64, quickstart's prefill of a 4-token
    # prompt, and train_e2e's model_100m (12 over 4, dh 64) at B 8, S 256
    ("entry_train_b4", 4, 64, 64, 4, 1, 16, True, 0),
    ("entry_train_b8", 8, 64, 64, 4, 1, 16, True, 0),
    ("entry_prefill", 1, 4, 4, 4, 1, 16, True, 0),
    ("entry_train_e2e", 8, 256, 256, 12, 4, 64, True, 0),
]
# the spmd prefill's rank shape at prefill_32k on the 16-wide "model"
# axis: llama3-8b's 2 query heads over the one kv head they read, dh 128,
# causal, S 32768, one of the rank's 2 prompts (B, S, Hq, Hkv, dh); the
# plain version runs on query blocks of TP_PREFILL_ROWS rows from each of
# TP_PREFILL_STARTS (its scores of all 32768 rows would take 8 GiB)
FLASH_TP_PREFILL = (1, 32768, 2, 1, 128)
TP_PREFILL_ROWS, TP_PREFILL_STARTS = 128, (0, 16384, 32640)
# a late block's outputs average thousands of keys (|out| about 0.01), so
# FLASH_TOL's 2e-2 absolute would hold them at nothing: each block's out is
# held at TP_PREFILL_OUT_TOL of (the block's RMS + |plain|), and lse, which
# is float32 (about 11 here, an ulp 1e-6), at TP_PREFILL_LSE_TOL absolute.
# Dropping one 64-key tile of the kernel (BN) moves a late row's lse by
# about 64 / its keys (2e-3 at 32768): the script holds the check against
# the plain version with one tile dropped and fails if that would pass
TP_PREFILL_OUT_TOL, TP_PREFILL_LSE_TOL, TP_PREFILL_TILE = 2e-2, 2e-4, 64
FLASH_SOURCE = "src/repro_torch/kernels/flash_attention/csrc/"
# the plain versions hold several (B, Hq, S, S) float32 score tensors at
# once: past this many bytes of scores they run one kv head's query group
# at a time (the groups are independent)
REF_SCORE_BYTES = 2 << 30


def flash_inputs(torch, B, S, Hq, Hkv, dh, dtype, seed, Skv=None):
    """q, k, v and an upstream gradient do, on the card: S queries over
    ``Skv`` keys (S when not given)."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    dt = getattr(torch, dtype)
    Skv = S if Skv is None else Skv
    return [torch.randn(s, generator=g, device="cuda").to(dt)
            for s in ((B, S, Hq, dh), (B, Skv, Hkv, dh), (B, Skv, Hkv, dh),
                      (B, S, Hq, dh))]


def flash_refs(torch, ref, q, k, v, do, **kw):
    """The plain forward's (out, lse) and, from them, the plain backward's
    (dq, dk, dv), one kv head's query group at a time when the whole
    problem's float32 scores would pass ``REF_SCORE_BYTES``."""
    B, S, Hq, dh = q.shape
    Hkv = k.shape[2]
    G = Hq // Hkv
    step = 1 if B * Hq * S * k.shape[1] * 4 > REF_SCORE_BYTES else Hkv
    parts = []
    for h in range(0, Hkv, step):
        qs, ks = slice(h * G, (h + step) * G), slice(h, h + step)
        qh, doh = q[:, :, qs].contiguous(), do[:, :, qs].contiguous()
        kh, vh = k[:, :, ks].contiguous(), v[:, :, ks].contiguous()
        out, lse = ref.flash_attention_fwd_ref(qh, kh, vh, **kw)
        parts.append((out, lse) + tuple(ref.flash_attention_bwd_ref(
            qh, kh, vh, out, lse, doh, **kw)))
    out, lse, dq, dk, dv = (torch.cat([p[i] for p in parts], dim=d)
                            for i, d in enumerate((2, 1, 2, 2, 2)))
    return (out, lse), (dq, dk, dv)


def max_err(torch, pairs, tol, what):
    """Largest |kernel - plain| over every element of every pair; raises
    if any element is off by more than tol + tol * |plain|."""
    worst = 0.0
    for name, got, want in pairs:
        got, want = got.float(), want.float()
        if not torch.isfinite(got).all():
            raise AssertionError(f"{what}: {name} not finite")
        err = (got - want).abs()
        worst = max(worst, float(err.max()))
        if bool((err > tol + tol * want.abs()).any()):
            raise AssertionError(f"{what}: {name} disagrees with the plain "
                                 f"version beyond {tol} (max abs err "
                                 f"{float(err.max()):.3e})")
    return worst


def phase_flash_kernels(torch):
    from repro_torch.kernels.flash_attention import ops, ref

    # the main path is bf16: its source is the tensor-core kernel; float32
    # calls take the FMA kernel of ``f32_source``
    rows = {
        "fwd": {"name": "flash_attention_fwd", "route": "cuda",
                "source": FLASH_SOURCE + "flash_attention_fwd_wgmma.cu",
                "replaces": "src/repro/kernels/flash_attention/kernel.py:101",
                "f32_source": FLASH_SOURCE + "flash_attention_fwd.cu",
                "design": "wgmma+tma"},
        "bwd": {"name": "flash_attention_bwd", "route": "cuda",
                "source": FLASH_SOURCE + "flash_attention_bwd_wgmma.cu",
                "replaces": "src/repro/kernels/flash_attention/kernel.py:367",
                "f32_source": FLASH_SOURCE + "flash_attention_bwd.cu",
                "design": "wgmma+tma"},
    }
    calls = {"bfloat16": 0, "float32": 0}
    parts = (("fwd", ops.flash_attention), ("bwd", ops.flash_attention_bwd))
    before = {part: (fn.launches, fn.wgmma_launches) for part, fn in parts}
    for geo in [FLASH_MAIN, FLASH_HYBRID] + FLASH_GEOMETRIES:
        name, B, S, Skv, Hq, Hkv, dh, causal, window = geo
        dtypes = ("bfloat16",) if name == "main_path" else ("float32",
                                                            "bfloat16")
        for dtype in dtypes:
            q, k, v, do = flash_inputs(torch, B, S, Hq, Hkv, dh, dtype,
                                       seed=S + dh, Skv=Skv)
            kw = dict(causal=causal, window=window)
            out, lse = ops.flash_attention_fwd(q, k, v, **kw)
            (want_out, want_lse), want = flash_refs(torch, ref, q, k, v, do,
                                                    **kw)
            # the backward kernels on the plain forward's out and lse
            grads = ops.flash_attention_bwd(q, k, v, want_out, want_lse, do,
                                            **kw)
            torch.cuda.synchronize()
            tf, tb = FLASH_TOL["fwd", dtype], FLASH_TOL["bwd", dtype]
            what = (f"{name} {dtype} B={B} Sq={S} Skv={Skv} Hq={Hq} "
                    f"Hkv={Hkv} dh={dh} causal={causal} window={window}")
            fwd_err = max_err(torch, [("out", out, want_out),
                                      ("lse", lse, want_lse)], tf, what)
            bwd_err = max_err(torch, zip(("dq", "dk", "dv"), grads, want),
                              tb, what)
            calls[dtype] += 1
            extra = ""
            if dtype == "bfloat16" and name in ("main_path", "hybrid_path"):
                # one owner per output element: a second run is identical
                again = ops.flash_attention_bwd(q, k, v, want_out, want_lse,
                                                do, **kw)
                calls[dtype] += 1
                if not all(torch.equal(a, b) for a, b in zip(grads, again)):
                    raise AssertionError(f"{what}: two backward runs differ")
                extra = "; a second backward run is bit-identical"
                del again
            log(f"[flash] {what}: forward max_abs_err={fwd_err:.3e} "
                f"(tol {tf}), backward max_abs_err={bwd_err:.3e} (tol {tb})"
                + extra)
            if name == "main_path":
                rows["fwd"]["max_abs_err"] = fwd_err
                rows["bwd"]["max_abs_err"] = bwd_err
            elif name == "hybrid_path" and dtype == "bfloat16":
                rows["fwd"]["hybrid_max_abs_err"] = fwd_err
                rows["bwd"]["hybrid_max_abs_err"] = bwd_err
            elif name.startswith("eager_prefill") and dtype == "bfloat16":
                key = ("moe_eager_prefill_max_abs_err" if "_moe_" in name
                       else "eager_prefill_max_abs_err")
                rows["fwd"][key] = max(rows["fwd"].get(key, 0.0), fwd_err)
            elif name == "moe_train" and dtype == "bfloat16":
                rows["fwd"]["moe_max_abs_err"] = fwd_err
                rows["bwd"]["moe_max_abs_err"] = bwd_err
            elif name.startswith(("vlm_", "encdec_", "starcoder_", "tp_",
                                  "entry_")):
                # phase 14's rows, starcoder2-15b's, the spmd step's
                # local heads and phase 17's, by family and route
                fam = name.split("_")[0]
                key = (f"{fam}_max_abs_err" if dtype == "bfloat16"
                       else f"{fam}_f32_max_abs_err")
                for part, err in (("fwd", fwd_err), ("bwd", bwd_err)):
                    rows[part][key] = max(rows[part].get(key, 0.0), err)
            del q, k, v, do, out, lse, want_out, want_lse, grads, want
            torch.cuda.empty_cache()
    calls["bfloat16"] += flash_strided_views(torch, ops, ref)
    routes = {part: {"wgmma": fn.wgmma_launches - before[part][1],
                     "fma": (fn.launches - before[part][0]
                             - (fn.wgmma_launches - before[part][1]))}
              for part, fn in parts}
    log(f"[flash] launches by route: {routes} for {calls['bfloat16']} bf16 "
        f"and {calls['float32']} float32 calls of each kernel (the "
        f"forward {calls['bfloat16'] - 2} bf16: no second forward where "
        "the backward ran twice)")
    want_routes = {"fwd": {"wgmma": calls["bfloat16"] - 2,
                           "fma": calls["float32"]},
                   "bwd": {"wgmma": calls["bfloat16"],
                           "fma": calls["float32"]}}
    if routes != want_routes:
        raise AssertionError(f"flash launches by route {routes}, expected "
                             f"{want_routes}: a bf16 call did not take the "
                             "tensor-core kernels")
    rows["fwd"].update(flash_tp_prefill(torch, ops))
    # the timed shapes have one length for queries and keys
    timing = flash_timing(torch, ops, ref, *FLASH_MAIN[1:3],
                          *FLASH_MAIN[4:])
    hybrid = flash_timing(torch, ops, ref, *FLASH_HYBRID[1:3],
                          *FLASH_HYBRID[4:])
    for part in ("fwd", "bwd"):
        rows[part].update(timing[part])
        rows[part].update({f"hybrid_{k}": v for k, v in hybrid[part].items()})
    return rows


def flash_rows_plain(torch, q, k, v, r0, n, drop=None):
    """The plain forward's (out, lse) of causal query rows r0 .. r0 + n
    over the keys they see: ``ref.flash_attention_fwd_ref``'s operations
    with the queries' positions starting at r0.  ``drop``: a (first,
    end) range of keys left out, as a kernel that skipped them would."""
    B, _, Hq, dh = q.shape
    Hkv = k.shape[2]
    qb = q[:, r0:r0 + n].reshape(B, n, Hkv, Hq // Hkv, dh).float()
    kb, vb = k[:, :r0 + n], v[:, :r0 + n]
    s = torch.einsum("bqhgd,bkhd->bhgqk", qb, kb.float()) * dh ** -0.5
    keys = torch.arange(r0 + n, device=q.device)
    mask = keys[None, :] <= torch.arange(r0, r0 + n, device=q.device)[:, None]
    if drop is not None:
        mask = mask & ((keys < drop[0]) | (keys >= drop[1]))[None, :]
    s = torch.where(mask, s, -1e30)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.where(mask, torch.exp(s - m), 0.0)
    l = p.sum(dim=-1, keepdim=True)
    lse = (m + torch.log(l))[..., 0]
    o = torch.einsum("bhgqk,bkhd->bqhgd", p.to(vb.dtype).float(), vb.float())
    o = o / l.permute(0, 3, 1, 2, 4)
    return o.reshape(B, n, Hq, dh).to(q.dtype), lse.reshape(B, Hq, n)


def tp_block_err(torch, out, lse, want_out, want_lse, what):
    """(out, lse) max abs errors of one ``tp_prefill`` query block against
    the plain version's; raises past ``TP_PREFILL_OUT_TOL`` of (the
    block's RMS + |plain|) in out or ``TP_PREFILL_LSE_TOL`` in lse."""
    got, want = out.float(), want_out.float()
    if not (torch.isfinite(got).all() and torch.isfinite(lse).all()):
        raise AssertionError(f"{what}: not finite")
    err = (got - want).abs()
    rms = float(want.square().mean().sqrt())
    lerr = float((lse.float() - want_lse.float()).abs().max())
    if bool((err > TP_PREFILL_OUT_TOL * (rms + want.abs())).any()):
        raise AssertionError(f"{what}: out disagrees with the plain version "
                             f"beyond {TP_PREFILL_OUT_TOL} x (RMS {rms:.3e} "
                             f"+ |plain|) (max abs err {float(err.max()):.3e})")
    if lerr > TP_PREFILL_LSE_TOL:
        raise AssertionError(f"{what}: lse disagrees with the plain version "
                             f"beyond {TP_PREFILL_LSE_TOL} (max abs err "
                             f"{lerr:.3e})")
    return float(err.max()), lerr, rms


def flash_tp_prefill(torch, ops):
    """The ``tp_prefill`` row: the bf16 flash forward at
    ``FLASH_TP_PREFILL`` (the spmd prefill's rank shape at prefill_32k),
    held against the plain version on ``TP_PREFILL_STARTS``' query
    blocks (``tp_block_err``), on the tensor-core route, and timed (CUDA
    events, two input sets) beside its bound.  On each block past the
    first tile, the plain version with the tile of keys from r0 / 2 left
    out must fail that check."""
    B, S, Hq, Hkv, dh = FLASH_TP_PREFILL
    sets = [flash_inputs(torch, B, S, Hq, Hkv, dh, "bfloat16",
                         seed=S + i)[:3] for i in range(2)]
    q, k, v = sets[0]
    before = ops.flash_attention.wgmma_launches
    out, lse = ops.flash_attention_fwd(q, k, v, causal=True, window=0)
    if ops.flash_attention.wgmma_launches != before + 1:
        raise AssertionError("tp_prefill: the bf16 flash forward did not "
                             "take the tensor-core kernel")
    what = (f"tp_prefill bfloat16 B={B} S={S} Hq={Hq} Hkv={Hkv} dh={dh} "
            f"causal")
    err = 0.0
    for r0 in TP_PREFILL_STARTS:
        n = TP_PREFILL_ROWS
        got = out[:, r0:r0 + n], lse[:, :, r0:r0 + n]
        block = f"{what}, query rows {r0}+{n}"
        oerr, lerr, rms = tp_block_err(
            torch, *got, *flash_rows_plain(torch, q, k, v, r0, n), block)
        err = max(err, oerr, lerr)
        caught = "no tile before the block's rows"
        if r0 >= 2 * TP_PREFILL_TILE:
            t = r0 // 2 // TP_PREFILL_TILE * TP_PREFILL_TILE
            drop = (t, t + TP_PREFILL_TILE)
            try:
                tp_block_err(torch, *got, *flash_rows_plain(
                    torch, q, k, v, r0, n, drop=drop), block)
            except AssertionError as e:
                caught = f"keys {drop[0]}-{drop[1] - 1} dropped fail: {e}"
            else:
                raise AssertionError(f"{block}: the check passes the plain "
                                     f"version with keys {drop} left out")
        log(f"[flash] {block}: out max_abs_err={oerr:.3e} (block RMS "
            f"{rms:.3e}), lse max_abs_err={lerr:.3e}; {caught}")
    ms = time_ms(torch, lambda q, k, v: ops.flash_attention_fwd(
        q, k, v, causal=True, window=0), sets)
    n_bytes = 2 * 2 * B * S * Hq * dh + 2 * 2 * B * S * Hkv * dh \
        + 4 * B * Hq * S
    flops = 4.0 * dh * B * Hq * S * (S + 1) / 2
    bound = 1e3 * max(n_bytes / PEAK_BYTES, flops / PEAK_FLOPS)
    log(f"[flash] {what}: forward max_abs_err={err:.3e} (out "
        f"{TP_PREFILL_OUT_TOL} x (RMS + |plain|), lse {TP_PREFILL_LSE_TOL}); "
        f"kernel_ms={ms:.4f} ({flops / ms / 1e9:.1f} TFLOP/s of needed "
        f"work) bound_ms={bound:.6f}")
    return {"tp_prefill_max_abs_err": err, "tp_prefill_ms": ms,
            "tp_prefill_bound_ms": bound}


def flash_strided_views(torch, ops, ref):
    """bf16 q/k/v as strided views of one fused buffer (the stride
    contract) against the plain versions; a view whose strides break TMA's
    16-byte rule must raise.  Returns the number of calls of each
    kernel."""
    B, S, Hq, Hkv, dh = 2, 150, 6, 2, 64
    q, k, v, do = flash_inputs(torch, B, S, Hq, Hkv, dh, "bfloat16", seed=7)
    qkv = torch.cat([q, k, v], dim=2)
    qv, kv_, vv = qkv.split([Hq, Hkv, Hkv], dim=2)
    out, lse = ops.flash_attention_fwd(qv, kv_, vv)
    grads = ops.flash_attention_bwd(qv, kv_, vv, out, lse, do)
    torch.cuda.synchronize()
    want_out, want_lse = ref.flash_attention_fwd_ref(q, k, v)
    want = ref.flash_attention_bwd_ref(q, k, v, out, lse, do)
    tol = FLASH_TOL["fwd", "bfloat16"]
    err = max_err(torch, [("out", out, want_out), ("lse", lse, want_lse)]
                  + list(zip(("dq", "dk", "dv"), grads, want)), tol,
                  "strided views")
    wide = torch.zeros(B, S, Hq, dh + 1, dtype=torch.bfloat16,
                       device="cuda")
    try:
        ops.flash_attention_fwd(wide[..., :dh], k, v)
    except ValueError as e:
        refused = str(e)
    else:
        raise AssertionError("a bf16 view with a 130-byte head stride did "
                             "not raise")
    log(f"[flash] strided q/k/v views of one (B, S, Hq + 2 Hkv, dh) bf16 "
        f"buffer: max_abs_err={err:.3e} (tol {tol}); a view with a "
        f"130-byte head stride raises: {refused}")
    return 1


def flash_work(B, S, Hq, Hkv, dh, causal, window, itemsize, mask):
    """Bytes and flops the functions need on this input: every input read
    once and every output written once; 4 * dh flops per visible (query,
    key) pair forward, and five products of 2 * dh backward (s
    recomputed, dp, dv, dq, dk: the least work; the tensor-core split does
    eight)."""
    pairs = float(mask.sum()) * B * Hq
    q_bytes = B * S * Hq * dh * itemsize
    kv_bytes = 2 * B * S * Hkv * dh * itemsize
    lse_bytes = B * Hq * S * 4
    fwd = (2 * q_bytes + kv_bytes + lse_bytes, 4.0 * dh * pairs)
    # in: q, out, do, k, v, lse; out: dq, dk, dv
    bwd = (4 * q_bytes + 2 * kv_bytes + lse_bytes, 10.0 * dh * pairs)
    return {"fwd": fwd, "bwd": bwd}


def flash_timing(torch, ops, ref, B, S, Hq, Hkv, dh, causal, window):
    import torch.nn.functional as F
    kw = dict(causal=causal, window=window)
    sets = []
    for i in range(4):
        q, k, v, do = flash_inputs(torch, B, S, Hq, Hkv, dh, "bfloat16",
                                   seed=200 + i)
        out, lse = ops.flash_attention_fwd(q, k, v, **kw)
        sets.append((q, k, v, do, out, lse))
    fwd = lambda q, k, v, do, out, lse: ops.flash_attention_fwd(q, k, v, **kw)
    bwd = lambda q, k, v, do, out, lse: ops.flash_attention_bwd(
        q, k, v, out, lse, do, **kw)
    fwd_ref = lambda q, k, v, do, out, lse: ref.flash_attention_fwd_ref(
        q, k, v, **kw)
    bwd_ref = lambda q, k, v, do, out, lse: ref.flash_attention_bwd_ref(
        q, k, v, out, lse, do, **kw)

    # yardsticks only: the port never calls scaled_dot_product_attention;
    # a window needs the band as a mask, causal alone is_causal
    mask = ref.attention_mask(S, S, causal, window, "cuda") if window \
        else None
    sdpa_kw = dict(attn_mask=mask, is_causal=causal and mask is None,
                   enable_gqa=Hq != Hkv)

    def sdpa(q, k, v, do, out, lse):
        return F.scaled_dot_product_attention(
            q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
            **sdpa_kw)

    leaves = [tuple(t.detach().clone().requires_grad_(True) for t in s[:3])
              + (s[3].transpose(1, 2),) for s in sets]

    def sdpa_fwd_bwd(q, k, v, do_t):
        o = F.scaled_dot_product_attention(
            q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
            **sdpa_kw)
        return torch.autograd.grad(o, (q, k, v), do_t)

    t = {"fwd": time_ms(torch, fwd, sets), "bwd": time_ms(torch, bwd, sets),
         "fwd_plain": time_ms(torch, fwd_ref, sets, iters=10),
         "bwd_plain": time_ms(torch, bwd_ref, sets, iters=10),
         "fwd_lib": time_ms(torch, sdpa, sets),
         "bwd_lib": time_ms(torch, sdpa_fwd_bwd, leaves)}
    mask = ref.attention_mask(S, S, causal, window, "cpu")
    work = flash_work(B, S, Hq, Hkv, dh, causal, window, 2, mask)
    out = {}
    for part in ("fwd", "bwd"):
        n_bytes, flops = work[part]
        b_bytes, b_flops = n_bytes / PEAK_BYTES, flops / PEAK_FLOPS
        out[part] = {"ms": t[part], "plain_ms": t[part + "_plain"],
                     "bound_ms": 1e3 * max(b_bytes, b_flops),
                     "bound_by": "bytes" if b_bytes >= b_flops
                     else "operations", "library_ms": t[part + "_lib"],
                     "tflops": flops / t[part] / 1e9}
        log(f"[flash] {part} B={B} S={S} Hq={Hq} Hkv={Hkv} dh={dh} "
            f"window={window}: kernel_ms={t[part]:.4f} "
            f"({out[part]['tflops']:.1f} TFLOP/s of needed work) "
            f"plain_ms={t[part + '_plain']:.4f} "
            f"library_ms={t[part + '_lib']:.4f} "
            f"bound_ms={out[part]['bound_ms']:.6f} ({n_bytes} bytes, "
            f"{flops:.0f} flops needed)")
    log(f"[flash] library_ms is scaled_dot_product_attention({'the band '
        'mask' if window else 'is_causal=True'}, enable_gqa=True): forward "
        "for flash_attention_fwd, forward + backward for "
        "flash_attention_bwd; bwd kernel_ms includes the delta = "
        "rowsum(out * do) pre-pass kernel; SDPA backend: forward "
        + sdpa_backend(torch, sdpa, sets[0]) + "; forward + backward "
        + sdpa_backend(torch, sdpa_fwd_bwd, leaves[0]))
    return out


def sdpa_backend(torch, fn, args):
    """The device kernels one call of ``fn(*args)`` runs, by device time
    (names the backend scaled_dot_product_attention took)."""
    fn(*args)
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]) as prof:
        fn(*args)
        torch.cuda.synchronize()
    rows = sorted(((getattr(e, "self_device_time_total",
                            getattr(e, "self_cuda_time_total", 0.0)), e.key)
                   for e in prof.key_averages()
                   if str(getattr(e, "device_type", "")).endswith("CUDA")),
                  reverse=True)
    names = [key[:70] for dev, key in rows if dev > 0][:3]
    return " | ".join(names) if names else "not measured (no device events)"


# ---------------------------------------------------------------------------
# phase 2c
# ---------------------------------------------------------------------------

SSM_ARCH = "mamba2-780m"
# the JAX package's ssd_scan test: 3e-4 in float32; 2e-2 with bf16 B/C
SSD_TOL = {"float32": 3e-4, "bfloat16": 2e-2}
PEAK_FLOPS_F32 = 67e12          # H100 SXM float32 outside the tensor cores
# name, B, S, H, P, G, N, chunk (the main path: ssd_main_geometry)
SSD_GEOMETRIES = [
    ("ssd_sweep_0", 2, 64, 4, 16, 1, 32, 16),
    ("ssd_sweep_1", 1, 32, 4, 8, 2, 16, 32),
    ("ssd_sweep_2", 2, 128, 2, 32, 1, 8, 64),
    ("groups_2", 2, 512, 8, 64, 2, 128, 256),
    ("ragged_tiles_groups_3", 2, 300, 6, 80, 3, 20, 100),
    # phase 12's mamba2-780m prefill of one prompt: a prompt up to the
    # model's chunk of 256 is one chunk of its own length (96, 148, 230),
    # a longer one is front-padded to whole chunks (400 -> 512)
    ("eager_prefill_s96", 1, 96, 48, 64, 1, 128, 96),
    ("eager_prefill_s148", 1, 148, 48, 64, 1, 128, 148),
    ("eager_prefill_s230", 1, 230, 48, 64, 1, 128, 230),
    ("eager_prefill_s512", 1, 512, 48, 64, 1, 128, 256),
    # the spmd train step's local heads on a 16-wide model axis at the
    # train_4k cell's microbatch (B=2, S=4096): mamba2-780m's 3 of 48
    # heads over its one group
    ("tp_h3_s4096", 2, 4096, 3, 64, 1, 128, 256),
]
SSD_SOURCE = "src/repro_torch/kernels/ssd_scan/csrc/"
# the bf16 (tensor-core) route at the training shape: its float32 operands
# in two bf16 parts keep it within 2e-3 of the plain version, absolute
SSD_SPLIT_TOL = 2e-3
SSD_SYMBOLS = ("ssd_state_wgmma", "ssd_pass", "ssd_scan_wgmma")


def ssd_main_geometry():
    """The training path's SSD scan shape: mamba2-780m at phase 5's B, S."""
    return ("main_path", SSM_B, TRAIN_S, 48, 64, 1, 128, 256)


def ssd_inputs(torch, B, S, H, P, G, N, dtype, seed):
    """Model-layout x, dt, A, B_, C_ as the JAX ssd_scan test draws them
    (x and B/C in ``dtype``), and the kernel's head-major inputs xdt, a,
    B, C formed from them as ``ops.ssd_with_state`` forms them."""
    from repro_torch.kernels.ssd_scan.ops import _head_major
    g = torch.Generator(device="cuda").manual_seed(seed)
    dt_ = getattr(torch, dtype)

    def rnd(*shape):
        return torch.randn(shape, generator=g, device="cuda")

    x = rnd(B, S, H, P).to(dt_)
    dt = torch.nn.functional.softplus(rnd(B, S, H) - 1.0)
    A = -torch.exp(rnd(H) * 0.3)
    Bm = (rnd(B, S, G, N) * 0.5).to(dt_)
    Cm = (rnd(B, S, G, N) * 0.5).to(dt_)
    xdt = _head_major(x.float() * dt[..., None])
    a = (dt * A).transpose(1, 2).reshape(B * H, S).contiguous()
    return (x, dt, A, Bm, Cm), (xdt, a, _head_major(Bm), _head_major(Cm))


def ssd_work(BH, S, P, N, BG, Q, itemsize):
    """Bytes and flops ``ssd_scan`` needs on this input: xdt, a, B and C
    read once, y and h_final written once; per (group, chunk) the
    Q(Q+1)/2 visible (query, key) pairs of C B^T (N products each, in
    B/C's type: the heads of a group share them), and per (head, chunk)
    those pairs of the intra product (P each, the decay differs by head)
    and the inter-chunk and state products (Q N P each), whose other
    operand is float32.  Returns (bytes, C B^T flops, intra flops,
    inter-chunk and state flops)."""
    nc = S // Q
    tri = nc * Q * (Q + 1) / 2
    n_bytes = (2 * BH * S * P * 4 + BH * S * 4 + 2 * BG * S * N * itemsize
               + BH * N * P * 4)
    return (n_bytes, 2.0 * BG * tri * N, 2.0 * BH * tri * P,
            2 * 2.0 * BH * nc * Q * N * P)


def ssd_bounds(BH, S, P, N, BG, Q):
    """The least time of each route on its own input, (ms, "bytes" or
    "operations") each.  Tensor cores (bf16 B/C): C B^T in bf16, the intra
    product in three bf16 products (two float32 operands in two parts
    each, lo*lo dropped), the inter-chunk and state products in two (one
    float32 operand), all at the bf16 rate.  FMA (float32 B/C): every
    product at the float32 rate outside the tensor cores."""
    out = {}
    for route, itemsize in (("wgmma", 2), ("fma", 4)):
        n_bytes, bc, intra, state = ssd_work(BH, S, P, N, BG, Q, itemsize)
        t_ops = ((bc + 3 * intra + 2 * state) / PEAK_FLOPS
                 if route == "wgmma" else (bc + intra + state) / PEAK_FLOPS_F32)
        t_bytes = n_bytes / PEAK_BYTES
        out[route] = (1e3 * max(t_bytes, t_ops),
                      "bytes" if t_bytes >= t_ops else "operations",
                      n_bytes, bc + intra + state)
    return out


def phase_ssd_kernel(torch):
    """The SSD kernels against their plain version on every element of y
    and h_final, in float32 (the FMA kernel) and with bf16 B/C (the
    tensor-core kernel), at the training shape, on the ``SSD_SWEEP``
    geometries and on G > 1 with ragged tiles; every call on its dtype's
    route; times at the training shape."""
    from repro_torch.kernels.ssd_scan import ops, ref

    # the main path is bf16: its source is the tensor-core kernel; float32
    # B/C take the FMA kernel of ``f32_source``
    row = {"name": "ssd_scan", "route": "cuda",
           "source": SSD_SOURCE + "ssd_scan_wgmma.cu",
           "replaces": "src/repro/kernels/ssd_scan/kernel.py:72",
           "f32_source": SSD_SOURCE + "ssd_scan.cu",
           "design": "wgmma+tma, C B^T once for a set of a group's heads, "
                     "float32 operands in two bf16 parts"}
    fn = ops.ssd_scan
    for geo in [ssd_main_geometry()] + SSD_GEOMETRIES:
        name, Bb, S, H, P, G, N, chunk = geo
        for dtype in ("float32", "bfloat16"):
            _, (xdt, a, Bh, Ch) = ssd_inputs(torch, Bb, S, H, P, G, N,
                                             dtype, seed=S + P + N)
            kw = dict(chunk=chunk, hq_per_group=H // G)
            n0, w0 = fn.launches, fn.wgmma_launches
            y, h = fn(xdt, a, Bh, Ch, **kw)
            torch.cuda.synchronize()
            route = "wgmma" if fn.wgmma_launches == w0 + 1 else "fma"
            want_route = "wgmma" if dtype == "bfloat16" else "fma"
            what = (f"{name} B/C {dtype} B={Bb} S={S} H={H} P={P} G={G} "
                    f"N={N} chunk={chunk}")
            if fn.launches != n0 + 1 or route != want_route:
                raise AssertionError(f"{what}: {fn.launches - n0} launches, "
                                     f"route {route}, expected one on "
                                     f"{want_route}")
            want_y, want_h = ref.ssd_scan_plain(xdt, a, Bh, Ch, **kw)
            tol = SSD_TOL[dtype]
            err = max_err(torch, [("y", y, want_y), ("h_final", h, want_h)],
                          tol, what)
            log(f"[ssd] {what}: route {route}, max_abs_err={err:.3e} (tol "
                f"{tol} + {tol} * |plain|)")
            if name == "main_path" and dtype == "bfloat16":
                if err > SSD_SPLIT_TOL:
                    raise AssertionError(
                        f"{what}: max abs err {err:.3e} above the split "
                        f"bound {SSD_SPLIT_TOL}")
                log(f"[ssd] {name} bf16: max_abs_err {err:.3e} within the "
                    f"split bound {SSD_SPLIT_TOL} (absolute)")
                row["max_abs_err"] = err
            elif name == "main_path":
                row["f32_max_abs_err"] = err
            elif name.startswith("eager_prefill") and dtype == "bfloat16":
                key = "eager_prefill_max_abs_err"
                row[key] = max(row.get(key, 0.0), err)
            elif name.startswith("tp_"):
                key = "tp_max_abs_err" if dtype == "bfloat16" \
                    else "tp_f32_max_abs_err"
                row[key] = max(row.get(key, 0.0), err)
            del xdt, a, Bh, Ch, y, h, want_y, want_h
    row["tp_bc_loads"] = ssd_rank_local(torch, ops)
    row.update(ssd_timing(torch, ops, ref, *ssd_main_geometry()[1:]))
    return row


def ssd_rank_local(torch, ops):
    """The spmd step's rank-local ``ssd_with_state`` call at the
    ``tp_h3_s4096`` shape, bf16: B and C come out of a gather (the ranks'
    channel slices concatenated: new tensors, as ``all_gather`` makes
    them); the load width ``ops.ssd_bc_loads`` chose for them is printed
    and must be TMA's (0).  Returns it."""
    _, Bb, S, H, P, G, N, chunk = next(g for g in SSD_GEOMETRIES
                                       if g[0] == "tp_h3_s4096")
    gen = torch.Generator(device="cuda").manual_seed(3)
    x = torch.randn(Bb, S, H, P, generator=gen, device="cuda") \
        .to(torch.bfloat16)
    dt = torch.rand(Bb, S, H, generator=gen, device="cuda") * 0.1
    A = -torch.rand(H, generator=gen, device="cuda")
    parts = 16       # the model axis's ranks, G*N / 16 channels each
    bc = [torch.cat([torch.randn(Bb, S, G * N // parts, generator=gen,
                                 device="cuda").to(torch.bfloat16)
                     for _ in range(parts)], dim=-1).reshape(Bb, S, G, N)
          for _ in range(2)]
    seen, loads = [], ops.ssd_bc_loads

    def spy(n, ptrs):
        seen.append(loads(n, ptrs))
        return seen[-1]
    ops.ssd_bc_loads = spy
    try:
        w0 = ops.ssd_scan.wgmma_launches
        ops.ssd_with_state(x, dt, A, *bc, chunk)
        torch.cuda.synchronize()
    finally:
        ops.ssd_bc_loads = loads
    route = "TMA" if seen == [0] else f"plain loads of {seen} elements"
    log(f"[ssd] rank-local ssd_with_state B={Bb} S={S} H={H} (of 48) P={P} "
        f"G={G} N={N} chunk={chunk}, bf16 B/C gathered from {parts} channel "
        f"slices: {ops.ssd_scan.wgmma_launches - w0} tensor-core launch, "
        f"B/C loads {route}")
    if seen != [0] or ops.ssd_scan.wgmma_launches != w0 + 1:
        raise AssertionError(f"the rank-local SSD call's B/C took {route}")
    return seen[0]


def ssd_timing(torch, ops, ref, B, S, H, P, G, N, chunk):
    from repro_torch.models.ssd import ssd_chunked
    sets = [ssd_inputs(torch, B, S, H, P, G, N, "bfloat16", seed=300 + i)
            for i in range(4)]
    f32_sets = [ssd_inputs(torch, B, S, H, P, G, N, "float32", seed=300 + i)
                for i in range(4)]
    kw = dict(chunk=chunk, hq_per_group=H // G)
    kernel_ms = time_ms(torch, lambda m, k: ops.ssd_scan(*k, **kw), sets)
    fma_ms = time_ms(torch, lambda m, k: ops.ssd_scan(*k, **kw), f32_sets,
                     iters=10)
    del f32_sets
    plain_ms = time_ms(torch, lambda m, k: ref.ssd_scan_plain(*k, **kw),
                       sets, iters=10)
    # yardstick: the port's chunked form on cuBLAS einsums, model layout
    Q = min(chunk, S)
    chunked_ms = time_ms(torch, lambda m, k: ssd_chunked(*m, chunk=Q), sets,
                         iters=10)
    bounds = ssd_bounds(B * H, S, P, N, B * G, Q)
    (bound_ms, bound_by, n_bytes, flops), fma = bounds["wgmma"], bounds["fma"]
    state_heads, scan_heads = ops.ssd_head_sets(B * G, S, Q, P, H // G)
    log(f"[ssd] kernel_ms={kernel_ms:.4f} (tensor cores, bf16 B/C, "
        f"{flops / kernel_ms / 1e9:.1f} TFLOP/s of needed work) "
        f"fma_ms={fma_ms:.4f} (FMA kernel, float32 B/C) "
        f"plain_ms={plain_ms:.4f} ssd_chunked_ms={chunked_ms:.4f}; "
        f"bound_ms={bound_ms:.6f} ({bound_by}: {n_bytes} bytes, the split "
        f"products on the tensor cores) fma_bound_ms={fma[0]:.6f} "
        f"({fma[1]}: {fma[2]} bytes, {fma[3]:.0f} float32 flops at "
        f"{PEAK_FLOPS_F32:.3g}/s); heads a block: state kernel "
        f"{state_heads}, scan kernel {scan_heads}")
    log("[ssd] library_ms is null: no single PyTorch call computes an SSD "
        "scan; ssd_chunked_ms (the port's models/ssd.ssd_chunked forward "
        "on cuBLAS einsums, which the kernel's backward recomputes "
        "through) is the yardstick")
    # bound_ms is the bound of ``source``'s route, the one ``ms`` times
    return {"ms": kernel_ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": bound_by, "library_ms": None, "bound_route": "wgmma",
            "tflops": flops / kernel_ms / 1e9, "fma_ms": fma_ms,
            "fma_bound_ms": fma[0], "fma_bound_by": fma[1],
            "head_sets": [state_heads, scan_heads],
            "ssd_chunked_ms": chunked_ms}


def ssd_head_set_sweep(torch):
    """``--ssd-head-sets``: the bf16 SSD kernel at the training shape with
    the scan kernel's heads a block from 48 (one set, C B^T made once) down
    to 1, then the state kernel's (``ops.ssd_head_sets``, which picks both
    from the shapes, is replaced for the sweep): CUDA-event time, device
    time of the three kernels from torch.profiler, and the error against
    the plain version; every choice must give the same bits."""
    from repro_torch.kernels.ssd_scan import ops, ref
    _, B, S, H, P, G, N, chunk = ssd_main_geometry()
    kw = dict(chunk=chunk, hq_per_group=H // G)
    sets = [ssd_inputs(torch, B, S, H, P, G, N, "bfloat16", seed=300 + i)
            for i in range(4)]
    ins = sets[0][1]
    want_y, want_h = ref.ssd_scan_plain(*ins, **kw)
    chosen = ops.ssd_head_sets
    default = chosen(B * G, S, min(chunk, S), P, H // G)
    first = ops.ssd_scan(*ins, **kw)
    kernel = lambda m, k: ops.ssd_scan(*k, **kw)
    try:
        for which, choices in ((1, (48, 24, 16, 12, 8, 6, 4, 2, 1)),
                               (0, (48, 12, 6, 4, 3, 2, 1))):
            for heads in choices:
                pair = list(default)
                pair[which] = heads
                ops.ssd_head_sets = lambda *a, _p=tuple(pair): _p
                y, h = ops.ssd_scan(*ins, **kw)
                err = max(float((y - want_y).abs().max()),
                          float((h - want_h).abs().max()))
                if err > SSD_SPLIT_TOL or not (torch.equal(y, first[0])
                                               and torch.equal(h, first[1])):
                    raise AssertionError(f"heads a block {pair}: max abs err "
                                         f"{err:.3e}, or bits differ")
                ms = time_ms(torch, kernel, sets)
                parts = device_ms(torch, kernel, sets, SSD_SYMBOLS)
                log(f"[ssd-head-sets] heads a block (state, scan) {pair}: "
                    f"events {ms:.4f} ms; device "
                    + ", ".join(f"{k} {v:.4f}" for k, v in parts.items())
                    + f" ms; max_abs_err {err:.3e}"
                    + (" (ssd_head_sets' choice)"
                       if tuple(pair) == tuple(default) else ""))
    finally:
        ops.ssd_head_sets = chosen


# ---------------------------------------------------------------------------
# phase 2d
# ---------------------------------------------------------------------------

HYBRID_ARCH = "recurrentgemma-9b"
# recurrentgemma-9b at full width and 14 layers (four (rec, rec, attn)
# groups and the model's two-layer (rec, rec) tail): 4,144,336,896
# parameters, 46.3 GiB of bf16 weights and grads and f32 moments, plus
# about 18.7 GiB of saved activations at B=1, S=4096 (PERF.md); all 38
# layers' optimizer state (105 GiB) does not fit one card.  RecurrentGemma
# trains at 8192; at 4096 the 2048 window still masks.
HYBRID_B, HYBRID_S, HYBRID_LAYERS, HYBRID_REMAT = 1, 4096, 14, "none"
# the JAX package's LRU tests: 1e-5 on h, 1e-4 on gradients
LRU_TOL, LRU_GRAD_TOL = 1e-5, 1e-4
LRU_GEOMETRIES = [
    # name, B, S, W
    ("lru_sweep_0", 2, 128, 64), ("lru_sweep_1", 1, 64, 128),
    ("lru_sweep_2", 3, 32, 16), ("lru_sweep_3", 1, 256, 32),
    ("ragged_s100_w300", 2, 100, 300), ("ragged_s65_w33", 3, 65, 33),
    ("serving_chunk", 8, 16, 4096),
    # phase 9's hybrid verify and reapply steps: one chunk of spec_w = 5
    ("verify_chunk_b1", 1, 5, 4096), ("verify_chunk_b8", 8, 5, 4096),
    # phase 12's recurrentgemma-9b prefill of one prompt, on the
    # many-chunk route (S > 64)
    ("eager_prefill_s96", 1, 96, 4096), ("eager_prefill_s148", 1, 148, 4096),
    ("eager_prefill_s400", 1, 400, 4096),
    # the spmd train step's local channels on a 16-wide model axis at the
    # train_4k cell's microbatch: recurrentgemma-9b's 256 of 4096, forward
    # and fused VJP
    ("tp_w256_s4096", 2, 4096, 256),
]
LRU_SOURCE = "src/repro_torch/kernels/rglru_scan/csrc/lru_scan.cu"


def lru_main_geometry():
    """The training path's scan shape: a rec layer of phase 7."""
    return ("main_path", HYBRID_B, HYBRID_S, 4096)


def lru_inputs(torch, B, S, W, seed):
    """a in (0, 1) (a sigmoid of a normal, as the JAX LRU test draws it),
    b and a carried state, float32 on the card."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    rnd = lambda *s: torch.randn(s, generator=g, device="cuda")
    return torch.sigmoid(rnd(B, S, W)), rnd(B, S, W), rnd(B, W)


# a many-chunk shape for the rerun check: one channel tile, 512 chunks,
# more blocks than the card holds at once
LRU_MANY_CHUNKS = (1, 32768, 64)


def lru_vjp_inputs(torch, B, S, W, seed):
    """a, the cotangent g and the forward's h (the kernel's scan of a, b)."""
    from repro_torch.kernels.rglru_scan import ops
    a, b, _ = lru_inputs(torch, B, S, W, seed)
    g = torch.Generator(device="cuda").manual_seed(seed + 1)
    return (a, torch.randn(a.shape, generator=g, device="cuda"),
            ops.lru_scan(a, b)[0])


def lru_unfused_bwd(torch, ops):
    """The backward before the fused VJP, from plain tensor ops around the
    scan kernel: a shifted copy of a, the reverse scan, a multiply."""
    def bwd(a, g, h):
        a_next = torch.zeros_like(a)
        a_next[:, :-1] = a[:, 1:]
        db, _ = ops.lru_scan(a_next, g, reverse=True)
        da = torch.empty_like(db)
        da[:, 0] = 0.0
        torch.mul(db[:, 1:], h[:, :-1], out=da[:, 1:])
        return da, db
    return bwd


def phase_lru_kernel(torch):
    """The RG-LRU scan kernel against its plain version on every element
    of h and h_final, forward and reverse, from zero and from a carried
    state, at the training shape and on the sweep; the fused VJP against
    its plain version; bit-identical reruns; the autograd wrapper's
    gradients against the CPU route; times at the training and serving
    shapes."""
    from repro_torch.kernels.rglru_scan import ops, ref

    row = {"name": "lru_scan", "route": "cuda", "source": LRU_SOURCE,
           "replaces": "src/repro/kernels/rglru_scan/kernel.py:57",
           "design": "one pass, carry folded by a look-back in chunk order; "
                     "fused VJP",
           "tile": list(ops.LRU_TILE)}
    worst = 0.0
    for name, B, S, W in [lru_main_geometry()] + LRU_GEOMETRIES:
        for reverse in (False, True):
            for carried in (False, True):
                a, b, h0 = lru_inputs(torch, B, S, W, seed=S + W)
                h0 = h0 if carried else None
                h, fin = ops.lru_scan(a, b, h0, reverse=reverse)
                torch.cuda.synchronize()
                want_h, want_fin = ref.lru_scan_plain(a, b, h0,
                                                      reverse=reverse)
                what = (f"{name} B={B} S={S} W={W} reverse={reverse} "
                        f"h0={carried}")
                err = max_err(torch, [("h", h, want_h),
                                      ("h_final", fin, want_fin)],
                              LRU_TOL, what)
                log(f"[lru] {what}: max_abs_err={err:.3e} (tol {LRU_TOL} + "
                    f"{LRU_TOL} * |plain|)")
                if name == "main_path":
                    worst = max(worst, err)
                elif name.startswith(("eager_prefill", "tp_")):
                    key = ("tp_max_abs_err" if name.startswith("tp_")
                           else "eager_prefill_max_abs_err")
                    row[key] = max(row.get(key, 0.0), err)
    row["max_abs_err"] = worst
    # the fused VJP against its plain version at the spmd step's rank
    # shape and the training shape, and the kernel's arithmetic in plain
    # PyTorch against the kernel at the training shape
    for key, (_, B, S, W) in (("tp_bwd_max_abs_err", next(
            g for g in LRU_GEOMETRIES if g[0] == "tp_w256_s4096")),
                              ("bwd_max_abs_err", lru_main_geometry())):
        a, g, h = lru_vjp_inputs(torch, B, S, W, seed=5)
        da, db = ops._lru_vjp(a, g, h)
        torch.cuda.synchronize()
        want_da, want_db = ref.lru_vjp_plain(a, g, h)
        row[key] = max_err(torch, [("da", da, want_da), ("db", db, want_db)],
                           LRU_GRAD_TOL, "lru fused VJP")
        log(f"[lru] fused VJP B={B} S={S} W={W}: max_abs_err={row[key]:.3e} "
            f"(tol {LRU_GRAD_TOL} + {LRU_GRAD_TOL} * |plain|)")
    pa, pb = lru_unfused_bwd(torch, ops)(a, g, h)
    if not (torch.equal(db, pb) and torch.equal(da, pa)):
        raise AssertionError("lru: the fused VJP differs from the unfused "
                             "backward on the same kernel")
    log("[lru] fused VJP against the unfused backward on the same kernel: "
        "da and db bit-identical")
    # two runs give the same bits, and the forward is the kernel's
    # arithmetic (the carry folded from h0 in chunk order) bit for bit
    T = ops.LRU_TILE[0]
    for shape in ((B, S, W), LRU_MANY_CHUNKS):
        a, b, h0 = lru_inputs(torch, *shape, seed=11)
        _, g, h = lru_vjp_inputs(torch, *shape, seed=12)
        runs = [ops.lru_scan(a, b, h0) + ops._lru_vjp(a, g, h)
                for _ in range(2)]
        torch.cuda.synchronize()
        if not all(torch.equal(x, y) for x, y in zip(*runs)):
            raise AssertionError(f"lru {shape}: two runs differ")
        want = ref.lru_scan_single_pass_ref(a, b, h0, T=T)
        if not all(torch.equal(x, y) for x, y in zip(runs[0][:2], want)):
            raise AssertionError(f"lru {shape}: the kernel differs from "
                                 f"lru_scan_single_pass_ref (T {T})")
        log(f"[lru] B={shape[0]} S={shape[1]} W={shape[2]}: reruns forward "
            f"and VJP bit-identical; h and h_final equal "
            f"lru_scan_single_pass_ref (T {T}) bit for bit")
    a, b, _ = lru_inputs(torch, 2, 130, 64, seed=7)
    g = torch.randn(2, 130, 64, device="cuda")
    grads = []
    for dev in ("cuda", "cpu"):
        ta = a.detach().to(dev).clone().requires_grad_(True)
        tb = b.detach().to(dev).clone().requires_grad_(True)
        ops.lru(ta, tb).backward(g.to(dev))
        grads.append((ta.grad, tb.grad))
    err = max_err(torch, [("da", grads[0][0].cpu(), grads[1][0]),
                          ("db", grads[0][1].cpu(), grads[1][1])],
                  LRU_GRAD_TOL, "lru gradients, card vs CPU")
    log(f"[lru] ops.lru gradients (the fused VJP on the kernel) against the "
        f"CPU route: max_abs_err={err:.3e} (tol {LRU_GRAD_TOL})")
    row.update(lru_timing(torch, ops, ref, *lru_main_geometry()[1:]))
    return row


def lru_bytes(B, S, W, vjp=False, h0=False):
    """Bytes the call must move: a and b (or a, g and h) read, h (or db and
    da) written, and the (B, W) state read (h0) and written (h_final)."""
    if vjp:
        return 5 * B * S * W * 4
    return 3 * B * S * W * 4 + (2 if h0 else 1) * B * W * 4


def lru_timing(torch, ops, ref, B, S, W):
    """CUDA-event times and CUDA-graph replays of the forward, the fused
    VJP (beside the unfused backward on the same kernel) and the serving
    chunk step's call, beside their byte bounds."""
    sets = [lru_inputs(torch, B, S, W, seed=400 + i)[:2] for i in range(4)]
    kernel_ms = time_ms(torch, ops.lru_scan, sets)
    graph = graph_ms(torch, ops.lru_scan, sets)
    plain_ms = time_ms(torch, ref.lru_scan_plain, sets, iters=3, warmup=1)
    # yardstick: one elementwise pass that moves the same bytes
    outs = [torch.empty_like(a) for a, _ in sets]
    mul_ms = time_ms(torch, lambda a, b, h: torch.mul(a, b, out=h),
                     [s + (h,) for s, h in zip(sets, outs)])
    del sets, outs
    bound_ms = 1e3 * lru_bytes(B, S, W) / PEAK_BYTES
    vjp_sets = [lru_vjp_inputs(torch, B, S, W, seed=500 + i)
                for i in range(4)]
    unfused = lru_unfused_bwd(torch, ops)
    # in turns: unfused, fused, fused, unfused
    bwd = [time_ms(torch, fn, vjp_sets)
           for fn in (unfused, ops._lru_vjp, ops._lru_vjp, unfused)]
    bwd_graph = [graph_ms(torch, fn, vjp_sets) for fn in (unfused,
                                                          ops._lru_vjp)]
    del vjp_sets
    bwd_bound_ms = 1e3 * lru_bytes(B, S, W, vjp=True) / PEAK_BYTES
    _, sB, sS, sW = next(g for g in LRU_GEOMETRIES if g[0] == "serving_chunk")
    serve_sets = [lru_inputs(torch, sB, sS, sW, seed=600 + i)
                  for i in range(4)]
    serving_ms = time_ms(torch, ops.lru_scan, serve_sets)
    serving_graph = graph_ms(torch, ops.lru_scan, serve_sets)
    serving_bound_ms = 1e3 * lru_bytes(sB, sS, sW, h0=True) / PEAK_BYTES
    log(f"[lru] B={B} S={S} W={W}: kernel_ms={kernel_ms:.4f} (in a CUDA "
        f"graph {graph:.4f}) "
        f"plain_ms={plain_ms:.4f} "
        f"bound_ms={bound_ms:.6f} ({lru_bytes(B, S, W)} bytes at "
        f"{PEAK_BYTES:.3g} B/s; one multiply-add an element); yardstick "
        f"torch.mul(a, b, out=h) {mul_ms:.4f} ms")
    log(f"[lru] backward B={B} S={S} W={W}: fused VJP {bwd[1]:.4f} / "
        f"{bwd[2]:.4f} ms (in a CUDA graph {bwd_graph[1]:.4f}), the unfused "
        f"backward (shifted copy, reverse scan, multiply) {bwd[0]:.4f} / "
        f"{bwd[3]:.4f} ms (in a CUDA graph {bwd_graph[0]:.4f}); "
        f"bound_ms={bwd_bound_ms:.6f} "
        f"({lru_bytes(B, S, W, vjp=True)} bytes)")
    log(f"[lru] serving chunk B={sB} S={sS} W={sW} from h0: "
        f"{serving_ms:.4f} ms (in a CUDA graph {serving_graph:.4f}), "
        f"bound_ms={serving_bound_ms:.6f}")
    log("[lru] library_ms is null: no single PyTorch call computes a linear "
        "recurrence; torch.mul over the same bytes is the yardstick")
    return {"ms": kernel_ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": "bytes", "library_ms": None, "graph_ms": graph,
            "mul_ms": mul_ms, "bwd_ms": (bwd[1] + bwd[2]) / 2,
            "bwd_graph_ms": bwd_graph[1], "bwd_bound_ms": bwd_bound_ms,
            "bwd_unfused_ms": (bwd[0] + bwd[3]) / 2,
            "bwd_unfused_graph_ms": bwd_graph[0], "serving_ms": serving_ms,
            "serving_graph_ms": serving_graph,
            "serving_bound_ms": serving_bound_ms}


def lru_tile_sweep(torch):
    """``--lru-tiles``: the kernel at the training shape over the tiles of
    ``ops.LRU_TILE_SWEEP`` (forward and fused VJP, CUDA events;
    ``ops.LRU_TILE`` is replaced for the sweep); every tile must agree with
    the plain version."""
    from repro_torch.kernels.rglru_scan import ops, ref
    chosen = ops.LRU_TILE
    _, B, S, W = lru_main_geometry()
    sets = [lru_inputs(torch, B, S, W, seed=400 + i)[:2] for i in range(4)]
    vjp_sets = [lru_vjp_inputs(torch, B, S, W, seed=500 + i)
                for i in range(4)]
    want = ref.lru_scan_plain(*sets[0])[0]
    want_da, want_db = ref.lru_vjp_plain(*vjp_sets[0])
    try:
        for tile in ops.LRU_TILE_SWEEP:
            ops.LRU_TILE = tile
            what = (f"T {tile[0]} Wt {tile[1]}"
                    + (" (LRU_TILE)" if tile == chosen else ""))
            got = ops.lru_scan(*sets[0])[0]
            da, db = ops._lru_vjp(*vjp_sets[0])
            err = max_err(torch, [("h", got, want)], LRU_TOL, what)
            err_b = max_err(torch, [("da", da, want_da), ("db", db, want_db)],
                            LRU_GRAD_TOL, what)
            fwd = time_ms(torch, ops.lru_scan, sets)
            bwd = time_ms(torch, ops._lru_vjp, vjp_sets)
            log(f"[lru-tiles] {what}: forward {fwd:.4f} ms, VJP {bwd:.4f} "
                f"ms; max_abs_err {err:.3e} / {err_b:.3e}")
    finally:
        ops.LRU_TILE = chosen


# ---------------------------------------------------------------------------
# phase 3
# ---------------------------------------------------------------------------

ENGINE_ARCH = "llama3-8b"


def make_engine(cfg, params=None, groups=2, **ecfg):
    """The main path's engine on ``cfg``: two pool domains,
    ``EngineConfig(max_batch=8, max_len=1024, pool_streams=8)`` with
    ``ecfg`` over it; weights ``params``, else random from seed 0."""
    from repro_torch.core.topology import ChipletTopology
    from repro_torch.serving.engine import EngineConfig, ServeEngine
    topo = ChipletTopology(n_pods=1, groups_per_pod=groups, chips_per_group=1)
    base = dict(max_batch=8, max_len=1024, pool_streams=8)
    return ServeEngine(cfg, topo, EngineConfig(**{**base, **ecfg}), seed=0,
                       params=params)


def reset_launches(torch):
    """Zero the serving paths' launch counts: the ring, RG-LRU scan, flash
    forward and SSD scan wrappers'."""
    from repro_torch.kernels.flash_attention import ops
    from repro_torch.kernels.rglru_scan import ops as lru_ops
    from repro_torch.kernels.ssd_scan import ops as ssd_ops
    for fn in (ops.ring_chunk_attention, ops.flash_attention,
               ssd_ops.ssd_scan):
        fn.launches = 0
        fn.wgmma_launches = 0
    lru_ops.lru_scan.launches = 0


def kernel_launches(torch):
    """(ring, of them on the tensor-core route, RG-LRU scan) launches
    since ``reset_launches``, made by calls in Python (not by replays of a
    CUDA graph)."""
    from repro_torch.kernels.flash_attention import ops
    from repro_torch.kernels.rglru_scan import ops as lru_ops
    return (ops.ring_chunk_attention.launches,
            ops.ring_chunk_attention.wgmma_launches,
            lru_ops.lru_scan.launches)


def check_requests(cfg, reqs):
    for r in reqs:
        if not r.done or len(r.generated) != r.max_new:
            raise AssertionError(f"request {r.rid}: {len(r.generated)} of "
                                 f"{r.max_new} tokens")
        if not all(0 <= t < cfg.vocab for t in r.generated):
            raise AssertionError(f"request {r.rid}: token out of vocab")


def latency(st):
    return (f"{st['tokens'] / st['wall']:.1f} tokens/s; TTFT p50/p99 "
            f"{st['ttft_p50'] * 1e3:.1f}/{st['ttft_p99'] * 1e3:.1f} ms, "
            f"TPOT p50/p99 {st['tpot_p50'] * 1e3:.1f}/"
            f"{st['tpot_p99'] * 1e3:.1f} ms")


def phase_engine(torch, arch, profile: bool = False):
    """Serve the main path's requests on ``arch`` at full width and depth
    through the port's ServeEngine.  Returns the launches of the ring and
    the RG-LRU scan kernels over the run, the weights, every request's
    tokens and the latency stats of the 8."""
    from repro_torch.configs import REGISTRY
    from repro_torch.serving.engine import ServeEngine

    cfg = REGISTRY[arch]
    dense = cfg.family == "dense"
    types = cfg.layer_types()
    n_attn, n_rec = types.count("attn"), types.count("rec")
    tag = f"[engine {cfg.name}]"

    t0 = time.perf_counter()
    eng = make_engine(cfg)
    torch.cuda.synchronize()
    if cfg.family == "ssm":
        widths = (f"ssd heads={cfg.ssm_heads}x{cfg.ssm_head_dim} "
                  f"state={cfg.ssm_state} ")
    else:
        widths = f"heads={cfg.n_heads}/{cfg.n_kv_heads} d_ff={cfg.d_ff} "
        if cfg.family == "hybrid":
            widths += (f"({n_rec} rec + {n_attn} attn layers, lru width "
                       f"{cfg.lru_width}, local window {cfg.local_window}) ")
    log(f"{tag} d_model={cfg.d_model} layers={cfg.n_layers} " + widths
        + f"vocab={cfg.vocab} {cfg.param_dtype}; set-up "
        f"{time.perf_counter() - t0:.1f} s, "
        f"{torch.cuda.memory_allocated() / 2**30:.1f} GiB on the card")

    spent, timed = step_timers(torch, eng) if profile else (None, None)
    reset_launches(torch)
    first, reqs, res, wall = serve(torch, eng, cfg, around=timed)
    launches, wgmma, lru_launches = kernel_launches(torch)
    # bf16 serving: every ring launch took the tensor-core route
    if wgmma != launches:
        raise AssertionError(f"ring kernel: {wgmma} of {launches} launches "
                             "on the tensor-core route")
    check_requests(cfg, [first] + reqs)
    c = res["counters"]
    hits = c.get("kv_prefix_hits", 0.0)
    ticks = int(c.get("chunk_ticks", 0))
    if dense:
        if launches <= 0:
            raise AssertionError("the ring kernel never launched on the "
                                 "main path")
        if hits <= 0:
            raise AssertionError("no prefix hit: the sharing path did not "
                                 "run")
    elif cfg.family == "hybrid":
        # every chunk tick runs the chunk step once: the ring kernel in
        # each local-attention layer, the scan in each recurrent layer
        if launches != n_attn * ticks or lru_launches != n_rec * ticks:
            raise AssertionError(
                f"{ticks} chunk ticks: ring launches {launches} (want "
                f"{n_attn * ticks}), lru_scan launches {lru_launches} "
                f"(want {n_rec * ticks})")
        if hits <= 0:
            raise AssertionError("no prefix hit: the state-checkpoint "
                                 "sharing path did not run")
        if not (eng.pool.pages_per_stream and eng.pool.has_state):
            raise AssertionError("the pool did not take ring pages and a "
                                 "state slot per stream")
        if c.get("kv_reservations", 0) < len(reqs) + 1:
            raise AssertionError(f"{c.get('kv_reservations', 0)} "
                                 f"reservations for {len(reqs) + 1} "
                                 "requests")
    else:
        # state-only streams: a state slot each, no ring pages, so no
        # prefix sharing (the JAX engine shares only ring pages)
        if launches or hits:
            raise AssertionError(f"state-only model: ring launches "
                                 f"{launches}, prefix hits {hits}")
        if eng.pool.pages_per_stream or not eng.pool.has_state:
            raise AssertionError("the pool did not take the state-slot "
                                 "layout")
        if c.get("kv_reservations", 0) < len(reqs) + 1:
            raise AssertionError(f"{c.get('kv_reservations', 0)} state "
                                 f"reservations for {len(reqs) + 1} "
                                 "requests")
    eng.pool.audit([r.table for r in eng.submitted if r.table is not None])
    st = ServeEngine.stats(reqs)
    st["wall"] = wall
    log(f"{tag} {len(reqs)} requests, {st['tokens']} tokens in "
        f"{wall:.2f} s: {latency(st)}")
    log(f"{tag} ring kernel launches {launches} ({wgmma} on the tensor-core "
        f"route), lru_scan launches "
        f"{lru_launches} over {ticks} chunk ticks ({n_attn} attn, {n_rec} "
        f"rec layers), kv_prefix_hits {int(hits)}, kv_reservations "
        f"{int(c.get('kv_reservations', 0))}, relayouts "
        f"{len(res['relayouts'])}, pool audit ok")
    log(f"{tag} " + json.dumps({
        "arch": cfg.name, "layers": cfg.n_layers, "wall_s": wall,
        "tokens": st["tokens"], "tokens_per_s": st["tokens"] / wall,
        **{k: st[k] for k in ("ttft_p50", "ttft_p99", "tpot_p50",
                              "tpot_p99")},
        **{k: c.get(k, 0.0) for k in ("chunk_ticks", "split_ticks",
                                      "decode_steps")},
        "ring_launches": launches, "ring_wgmma_launches": wgmma,
        "lru_launches": lru_launches,
        "peak_gib": torch.cuda.max_memory_allocated() / 2**30}))
    params = eng.params
    tokens = [r.generated for r in [first] + reqs]
    by_prompt = {tuple(int(t) for t in r.prompt): list(r.generated)
                 for r in [first] + reqs}
    if profile:
        steps = sum(t for t, _ in spent.values())
        log("[profile] " + json.dumps({
            "arch": cfg.name, "wall_s": wall,
            "chunk_step_s": spent["chunk"][0],
            "chunk_steps": spent["chunk"][1],
            "decode_step_s": spent["decode"][0],
            "decode_steps": spent["decode"][1],
            "outside_steps_s": wall - steps}))
        del eng
        gc.collect()                # the engine's tasks hold it in cycles
        torch.cuda.empty_cache()
        profile_replay(torch, make_engine(cfg, params), cfg, wall)
    return {"ring": launches, "lru": lru_launches, "params": params,
            "tokens": tokens, "by_prompt": by_prompt, "stats": st,
            "arch": arch}


def serve(torch, eng, cfg, around=None):
    """The main path's requests: a 128-token system prompt served once (its
    pages stay resident), then 8 requests, two of which share that
    preamble.  Returns (first, the 8, run_until_done's result, wall seconds
    of the 8); ``around`` (a context manager) wraps the timed part."""
    import contextlib
    import numpy as np
    rng = np.random.default_rng(0)
    preamble = rng.integers(2, cfg.vocab, size=128)
    first = eng.submit(np.concatenate([preamble,
                                       rng.integers(2, cfg.vocab, size=20)]),
                       max_new=16)
    eng.run_until_done()
    lens = [64, 150, 230, 310, 400, 96, 180, 270]
    budgets = [16, 20, 24, 28, 32, 18, 22, 26]
    prompts = [np.concatenate([preamble, rng.integers(2, cfg.vocab, size=n)])
               if i < 2 else rng.integers(2, cfg.vocab, size=n)
               for i, n in enumerate(lens)]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    with around or contextlib.nullcontext():
        t0 = time.perf_counter()
        reqs = [eng.submit(p, max_new=m) for p, m in zip(prompts, budgets)]
        res = eng.run_until_done()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    return first, reqs, res, wall


def step_timers(torch, eng):
    """Wrap the engine's two device steps with host timers (each step ends
    in a host copy of its tokens, so the time covers its device work).
    Returns kind -> [seconds, calls] and a context manager that zeroes
    them on entry, for ``serve``'s timed part."""
    import contextlib
    spent = {"chunk": [0.0, 0], "decode": [0.0, 0]}

    @contextlib.contextmanager
    def timed_part():
        for v in spent.values():
            v[:] = [0.0, 0]
        yield
    for kind, name in (("chunk", "_paged_chunk"), ("decode", "_paged_decode")):
        def timed(*a, _fn=getattr(eng, name), _s=spent[kind]):
            torch.cuda.synchronize()
            t = time.perf_counter()
            out = _fn(*a)
            _s[0] += time.perf_counter() - t
            _s[1] += 1
            return out
        setattr(eng, name, timed)
    return spent, timed_part()


# the device symbols of the serving paths' hand-written kernels
SERVING_SYMBOLS = ("ring_wgmma_kernel", "ring_combine_kernel",
                   "lru_direct")


def device_rows(prof):
    """(device microseconds, calls, name) of every device-side event of a
    torch.profiler session (kernels, copies, fills: the host ops that
    launched them report the same time again)."""
    rows = []
    for e in prof.key_averages():
        if not str(getattr(e, "device_type", "")).endswith("CUDA"):
            continue
        dev = getattr(e, "self_device_time_total",
                      getattr(e, "self_cuda_time_total", 0.0))
        if dev > 0:
            rows.append((dev, e.count, e.key))
    return rows


def profile_replay(torch, eng, cfg, main_wall):
    """Replay the main path on a fresh engine (same seed, same requests,
    so the same device work) under torch.profiler and cProfile: the card's
    kernels by device time, its busy time against the unprofiled run's
    wall, the time and launches of the hand-written kernels
    (``SERVING_SYMBOLS``), and the host functions that take the most
    time."""
    import contextlib
    import cProfile
    import pstats
    prof = torch.profiler.profile(activities=[
        torch.profiler.ProfilerActivity.CPU,
        torch.profiler.ProfilerActivity.CUDA])
    host = cProfile.Profile()

    @contextlib.contextmanager
    def both():
        with prof:
            host.enable()
            try:
                yield
            finally:
                host.disable()

    *_, wall = serve(torch, eng, cfg, around=both())
    rows = device_rows(prof)
    if not rows:
        log("[profile] device time: not measured (the profiler saw no "
            "device activity)")
    else:
        busy = sum(r[0] for r in rows) / 1e6
        log(f"[profile] replay: device busy {busy:.6f} s; wall {wall:.6f} s "
            f"profiled, {main_wall:.6f} s unprofiled (idle share "
            f"{1 - busy / main_wall:.4f} of the unprofiled wall)")
        mine = {n: (sum(r[0] for r in rows if n in r[2]) / 1e3,
                    sum(r[1] for r in rows if n in r[2]))
                for n in SERVING_SYMBOLS}
        log("[profile] hand-written kernels: " + ", ".join(
            f"{n} {t:.3f} ms over {c} launches"
            for n, (t, c) in mine.items() if c))
        for dev, count, key in sorted(rows, reverse=True)[:15]:
            log(f"[profile]   {dev / 1e3:12.3f} ms {count:7d}x  {key[:90]}")
    out = io.StringIO()
    pstats.Stats(host, stream=out).sort_stats("tottime").print_stats(20)
    for line in out.getvalue().splitlines():
        if line.strip():
            log(f"[host] {line.rstrip()[:150]}")


class PartialDrafter:
    """One right token, then wrong ones: the next tokens of a run that
    served the same prompts (``base``: prompt -> tokens), the second and
    later each moved one id up.  Every verify of a full draft accepts a
    strict prefix and rolls the rest back."""

    def __init__(self, base, vocab):
        self.base, self.vocab = base, vocab

    def draft(self, req, k):
        done = len(req.generated)
        toks = self.base.get(tuple(int(t) for t in req.prompt),
                             [])[done:done + k]
        return toks[:1] + [(t + 1) % self.vocab for t in toks[1:]]


# the engine options of the reference runs' variants: speculative decoding
# (with a partial drafter); the asynchronous swap tier on a pool of one
# stream a domain (two streams of a group cannot both fit: streams park)
# with phase 10's watermarks (a parked stream spills); the asynchronous
# tier with a park forced mid-decode (``force_park``) and low watermarks
# (the parked stream spills its ring pages and state slot); the CUDA-graph
# warm-up; and phase 12's engine modes: the eager engine, the slot
# monolith and the scan chunk path
VARIANTS = {None: {}, "spec": {"spec_decode": "ngram", "spec_k": 4},
            "async": {"async_swap": True, "pool_streams": 1,
                      "spill_watermarks": (0.5, 0.25)},
            "async park": {"async_swap": True,
                           "spill_watermarks": (0.2, 0.1)},
            "warm": {}, "eager": {"lazy": False},
            "monolith": {"paged": False}, "scan": {"prefill_mode": "scan"}}
MODE_VARIANTS = ("eager", "monolith", "scan")


def card_variants(*names):
    return [(f"card {v}", "cuda", "blocked", v) for v in names]


# the reference runs of the variants on the card, by family.  A hybrid
# pool gives each state slot a whole ring of pages, so its streams never
# park on their own: its asynchronous run forces a park.  A pure-state
# pool (mamba2) has no pages, and a stream without pages is never a spill
# victim (``_spill_parked``, as in the JAX package): it takes no
# asynchronous run
CARD_VARIANTS = {"dense": card_variants("spec", "async", "warm",
                                        *MODE_VARIANTS),
                 "moe": card_variants("spec", "async", "warm",
                                      *MODE_VARIANTS),
                 "ssm": card_variants("spec", "warm", *MODE_VARIANTS),
                 "hybrid": card_variants("spec", "async park", "warm",
                                         *MODE_VARIANTS),
                 # the engine serves a VLM only on the lazy paged path
                 "vlm": card_variants("spec", "async", "warm", "scan")}


def force_park(eng):
    """Park the first stream four tokens past its prompt, once, as the
    JAX package's hybrid spill test does; returns the parked ids."""
    tick = eng._decode_tick
    parked = []

    def forced(g):
        out = tick(g)
        if not parked:
            for i, r in enumerate(g.slots):
                if r is not None and int(g.pos_h[i]) >= len(r.prompt) + 4:
                    eng._park_stream(g, i)
                    parked.append(r.rid)
                    break
        return out

    eng._decode_tick = forced
    return parked


def spy_state_spills(pool):
    """Record, per issued spill, whether it carries a state slot."""
    issue = pool.spill_issue
    had = []

    def issued(table):
        fresh = table.spill is None and not table.inflight
        state = bool(pool.has_state and table.state_slot)
        n = issue(table)
        if fresh and n:
            had.append(state)
        return n

    pool.spill_issue = issued
    return had


def phase_engine_reference(torch, arch, runs):
    """Small input, float32: the reduced ``arch`` engine gives the same
    tokens in every run of ``runs``, each (label, device, chunk kernel,
    variant of ``VARIANTS``), on the same weights drawn on the CPU.  The
    first run is a plain one; the spec variant's drafter drafts from its
    tokens.  After a card monolith run, ``make_prefill`` and
    ``make_generate`` (B=1, greedy) on the card give the monolith's tokens
    for the first prompt."""
    import numpy as np
    from repro_torch.configs import REGISTRY, reduced_config
    from repro_torch.core.topology import ChipletTopology
    from repro_torch.models.params import init_params
    from repro_torch.serving.engine import EngineConfig, ServeEngine

    t0 = time.perf_counter()
    cfg = reduced_config(REGISTRY[arch])
    base = init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    rng = np.random.default_rng(1)
    prompts = [rng.integers(2, cfg.vocab, size=int(n))
               for n in (5, 19, 33, 40)]
    outs, notes = {}, []
    for label, device, kernel, variant in runs:
        topo = ChipletTopology(n_pods=1, groups_per_pod=2, chips_per_group=1)
        opts = {"max_batch": 2, "max_len": 48, "pool_streams": 2,
                "chunk_kernel": kernel, **VARIANTS[variant]}
        eng = ServeEngine(cfg, topo, EngineConfig(**opts),
                          params=_to_device(base, device), device=device)
        if variant == "spec":
            first = outs[runs[0][0]]
            eng.drafter = PartialDrafter(
                {tuple(int(t) for t in p): g for p, g in zip(prompts, first)},
                cfg.vocab)
        if variant == "warm":
            eng.warm_steps()
        parked, state_spills = [], []
        if variant == "async park":
            parked = force_park(eng)
            state_spills = spy_state_spills(eng.pool)
        reqs = [eng.submit(p, max_new=12) for p in prompts]
        c = eng.run_until_done()["counters"]
        outs[label] = [r.generated for r in reqs]
        replays = sum(eng.graph_replays().values())
        spilled = (c.get("kv_spill_issues", 0) > 0
                   and c.get("recompute_tokens", 0) == 0)
        whole = (c.get("prefills") == len(prompts)
                 and not c.get("chunk_ticks", 0))
        # each variant's path really ran
        ran = {"spec": c.get("spec_rollbacks", 0) > 0,
               "async": spilled,
               "async park": (spilled and bool(parked)
                              and bool(state_spills) and all(state_spills)),
               "warm": device != "cuda" or replays > 0,
               "eager": whole and eng.pool is not None,
               "monolith": whole and eng.pool is None,
               "scan": c.get("chunk_ticks", 0) > 0
               and c.get("prefill_model_steps")
               == eng._chunk * c["chunk_ticks"]}
        if not ran.get(variant, True):
            raise AssertionError(f"reduced {arch} {label}: the {variant} "
                                 f"path did not run: {dict(c)}")
        if variant == "spec":
            notes.append(f"{label}: {int(c['spec_tokens_drafted'])} drafted, "
                         f"{int(c['spec_rollbacks'])} rollbacks")
        elif variant == "async":
            notes.append(f"{label}: {int(c['kv_spill_issues'])} spills "
                         "issued")
        elif variant == "async park":
            notes.append(f"{label}: stream {parked[0]} parked, "
                         f"{int(c['kv_spill_issues'])} spills issued, "
                         f"{sum(state_spills)} with a state slot")
        elif variant == "warm" and device == "cuda":
            notes.append(f"{label}: {replays} graph replays")
        if variant == "monolith" and device == "cuda":
            outs["card make_generate"] = [generated(
                torch, cfg, eng.params, prompts[0], 12, 48)] + outs[label][1:]
    labels = " == ".join(outs)
    if any(v != outs[runs[0][0]] for v in outs.values()):
        raise AssertionError(f"reduced {arch} float32: not {labels} tokens")
    log(f"[engine {cfg.name}] float32: {labels} tokens for 4 requests"
        + (f" ({'; '.join(notes)})" if notes else "")
        + f"; {time.perf_counter() - t0:.1f} s")


def generated(torch, cfg, params, prompt, budget, max_len):
    """``budget`` greedy tokens for ``prompt`` from ``make_prefill`` and
    ``make_generate`` at B=1 on the weights' device."""
    import numpy as np
    from repro_torch.launch.steps import make_generate, make_prefill
    dev = params["embed"].device
    tokens = torch.from_numpy(np.asarray(prompt, np.int32)[None, :]).to(dev)
    logits, cache = make_prefill(cfg, max_len)(params, {"tokens": tokens})
    first = logits.argmax(-1).to(torch.int32)[:, None]
    toks, _, _ = make_generate(cfg, budget - 1)(
        params, cache, first, torch.full((1,), len(prompt),
                                         dtype=torch.int32, device=dev))
    return [int(first[0, 0])] + [int(t) for t in toks[0].tolist()]


def _to_device(tree, device):
    if isinstance(tree, dict):
        return {k: _to_device(v, device) for k, v in tree.items()}
    return tree.clone().to(device)


# ---------------------------------------------------------------------------
# phases 9-11: speculative decoding, the asynchronous swap tier, warmed
# serving (CUDA graphs)
# ---------------------------------------------------------------------------

def live_tables(eng):
    return [r.table for r in eng.submitted if r.table is not None]


def agreement(a, b):
    """Share of token positions two runs of the same requests agree on."""
    pairs = [(x, y) for ra, rb in zip(a, b) for x, y in zip(ra, rb)]
    return sum(x == y for x, y in pairs) / max(1, len(pairs))


def served(torch, eng, cfg):
    """Serve the main path's requests on ``eng``: (every request's tokens,
    the counters, the latency stats of the 8 with their wall seconds, ring
    launches, of them on the tensor-core route, RG-LRU launches), with
    the requests and the pool's audit checked."""
    from repro_torch.serving.engine import ServeEngine
    reset_launches(torch)
    first, reqs, res, wall = serve(torch, eng, cfg)
    ring, wgmma, lru = kernel_launches(torch)
    check_requests(cfg, [first] + reqs)
    eng.pool.audit(live_tables(eng))
    if eng.pool.inflight_tables():
        raise AssertionError("a spill outlived the run")
    st = ServeEngine.stats(reqs)
    st["wall"] = wall
    return ([r.generated for r in [first] + reqs], res["counters"], st,
            ring, wgmma, lru)


def phase_spec(torch, cold):
    """Phase 9: ``cold``'s model (phase 3's or 8's weights) with
    speculative decoding, once with the engine's n-gram drafter and once
    with a partial drafter from ``cold``'s tokens; the partial run must
    draft, roll back and verify, every ring launch on the tensor-core
    route (and, on the hybrid, take state checkpoints and launch the
    RG-LRU kernel)."""
    from repro_torch.configs import REGISTRY
    cfg = REGISTRY[cold["arch"]]
    tag = f"[spec {cfg.name}]"
    out = {}
    for name in ("ngram", "partial"):
        free_card(torch)
        eng = make_engine(cfg, cold["params"], spec_decode="ngram", spec_k=4)
        if name == "partial":
            eng.drafter = PartialDrafter(cold["by_prompt"], cfg.vocab)
        toks, c, st, ring, wgmma, lru = served(torch, eng, cfg)
        kv = eng.kv_stats()
        if wgmma != ring:
            raise AssertionError(f"{tag} {name}: {wgmma} of {ring} ring "
                                 "launches on the tensor-core route")
        drafted, acc = kv["spec_tokens_drafted"], kv["spec_tokens_accepted"]
        verifies = kv["spec_verify_forwards"]
        out[name] = {
            "drafted": drafted, "accepted": acc,
            "accept_rate": kv["spec_accept_rate"],
            "accepted_per_verify": acc / verifies if verifies else 0.0,
            "verify_forwards": verifies, "rollbacks": kv["spec_rollbacks"],
            "reapply_forwards": kv["spec_reapply_forwards"],
            "ckpts": kv["spec_ckpts"],
            "agreement_with_spec_off": agreement(toks, cold["tokens"]),
            "tokens_per_s": st["tokens"] / st["wall"],
            **{k: st[k] for k in ("wall", "ttft_p50", "ttft_p99",
                                  "tpot_p50", "tpot_p99")},
            "ring_launches": ring, "lru_launches": lru}
        log(f"{tag} {name} drafter: {int(drafted)} drafted, {int(acc)} "
            f"accepted ({kv['spec_accept_rate']:.4f}), {int(verifies)} "
            f"verify forwards, {int(kv['spec_rollbacks'])} rollbacks; "
            f"agreement with spec off {out[name]['agreement_with_spec_off']:.4f}; "
            + latency(st))
        del eng
    p = out["partial"]
    if not (p["drafted"] > 0 and p["rollbacks"] > 0
            and p["verify_forwards"] > 0):
        raise AssertionError(f"{tag} the partial drafter's run did not "
                             f"draft, roll back and verify: {p}")
    if cfg.family == "hybrid" and not (p["ckpts"] > 0 and p["lru_launches"]
                                       > 0 and p["ring_launches"] > 0):
        raise AssertionError(f"{tag} no state checkpoint, RG-LRU or ring "
                             f"launch: {p}")
    cs = cold["stats"]
    log(f"{tag} spec off (phase {'3' if cfg.family == 'dense' else '8'}): "
        + latency(cs))
    log(f"{tag} " + json.dumps({
        "arch": cfg.name, "layers": cfg.n_layers, "spec_k": 4,
        "spec_off": {"tokens_per_s": cs["tokens"] / cs["wall"],
                     **{k: cs[k] for k in ("wall", "ttft_p50", "ttft_p99",
                                           "tpot_p50", "tpot_p99")}},
        **out}))
    free_card(torch)


# phase 10's pool: one replica group over one domain of two 512-token
# streams (64 pages) for requests that need about 137 pages in all, with
# the JAX benchmark's async cell's watermarks (0.5, 0.25)
ASYNC_ECFG = dict(groups=1, max_len=512, pool_streams=2,
                  spill_watermarks=(0.5, 0.25))


def phase_async(torch, cold):
    """Phase 10: phase 3's model and requests on an oversubscribed pool,
    with the asynchronous swap tier and with the synchronous one.  The
    asynchronous run must issue spills, land them rounds later and
    recompute nothing; the pool's audit runs after every transfer
    transition."""
    from repro_torch.configs import REGISTRY
    cfg = REGISTRY[ENGINE_ARCH]
    tag = f"[async {cfg.name}]"
    out, toks = {}, {}
    for is_async in (True, False):
        free_card(torch)
        eng = make_engine(cfg, cold["params"], async_swap=is_async,
                          **ASYNC_ECFG)
        audits = [0]
        pool = eng.pool
        for name in ("spill_issue", "spill_poll", "spill_fence",
                     "restore_into", "free"):
            def audited(*a, _orig=getattr(pool, name), **kw):
                r = _orig(*a, **kw)
                pool.audit(live_tables(eng))
                audits[0] += 1
                return r
            setattr(pool, name, audited)
        name = "async" if is_async else "sync"
        toks[name], c, st, ring, wgmma, _ = served(torch, eng, cfg)
        out[name] = {k: c.get(k, 0.0) for k in (
            "kv_spill_issues", "kv_spills", "kv_spill_overlap_rounds",
            "kv_fence_waits", "kv_ticks_while_inflight", "kv_restores",
            "kv_restore_prefetches", "recompute_tokens", "kv_evictions",
            "kv_mid_decode_parks")}
        out[name].update(
            tokens_per_s=st["tokens"] / st["wall"], audits=audits[0],
            **{k: st[k] for k in ("wall", "ttft_p50", "ttft_p99",
                                  "tpot_p50", "tpot_p99")})
        log(f"{tag} {name}: {int(out[name]['kv_spills'])} spills "
            f"({int(out[name]['kv_spill_issues'])} issued, overlap rounds "
            f"{int(out[name]['kv_spill_overlap_rounds'])}, fence waits "
            f"{int(out[name]['kv_fence_waits'])}), "
            f"{int(out[name]['kv_restores'])} restores, recompute "
            f"{int(out[name]['recompute_tokens'])}; {audits[0]} audits; "
            + latency(st))
        del eng, pool
    a = out["async"]
    if not (a["kv_spill_issues"] > 0 and a["kv_spills"] > 0
            and a["kv_spill_overlap_rounds"] > 0
            and a["recompute_tokens"] == 0):
        raise AssertionError(f"{tag} the asynchronous tier did not spill, "
                             f"overlap and restore without recompute: {a}")
    agree = {"async_vs_sync": agreement(toks["async"], toks["sync"]),
             "async_vs_phase3": agreement(toks["async"], cold["tokens"])}
    log(f"{tag} token agreement: async/sync {agree['async_vs_sync']:.4f}, "
        f"async/phase 3 {agree['async_vs_phase3']:.4f}")
    log(f"{tag} " + json.dumps({"arch": cfg.name, "pool": {
        k: v for k, v in ASYNC_ECFG.items()}, **out, "agreement": agree}))
    free_card(torch)


def profiled_serve(torch, eng, cfg, warm):
    """One serve of the main path's requests on ``eng`` under
    torch.profiler (after ``warm_steps`` with ``warm``, outside the
    profile): (device busy seconds, or None when the profiler saw no
    device activity; the calls of each kernel of ``SERVING_SYMBOLS`` the
    card ran, kernels replayed inside a CUDA graph included; the ring
    launches the wrapper counted in Python over the same window)."""
    import contextlib
    if warm:
        eng.warm_steps()
    prof = torch.profiler.profile(activities=[
        torch.profiler.ProfilerActivity.CPU,
        torch.profiler.ProfilerActivity.CUDA])
    counted = [0]

    @contextlib.contextmanager
    def window():
        before = kernel_launches(torch)[0]
        with prof:
            yield
        counted[0] = kernel_launches(torch)[0] - before

    serve(torch, eng, cfg, around=window())
    rows = device_rows(prof)
    calls = {n: sum(r[1] for r in rows if n in r[2]) for n in SERVING_SYMBOLS}
    return (sum(r[0] for r in rows) / 1e6 if rows else None), calls, \
        counted[0]


def phase_warm(torch, cold):
    """Phase 11: phase 3's model and requests on an engine warmed by
    ``warm_steps`` (each paged step the serve loop dispatches captured as
    a CUDA graph): tokens bit for bit phase 3's and graphs replayed (each
    graph's replays printed).  Then a cold and a warmed serve, each on a
    fresh engine under torch.profiler: the serving kernels the card ran in
    the warmed serve (inside the graphs) equal the cold serve's, whose
    ring split kernel ran once for each launch the wrapper counted; the
    device's idle share of each against its unprofiled wall."""
    from repro_torch.configs import REGISTRY
    cfg = REGISTRY[ENGINE_ARCH]
    tag = f"[warm {cfg.name}]"
    free_card(torch)
    eng = make_engine(cfg, cold["params"])
    torch.cuda.synchronize()
    alloc0, res0 = torch.cuda.memory_allocated(), torch.cuda.memory_reserved()
    t0 = time.perf_counter()
    calls = eng.warm_steps()
    torch.cuda.synchronize()
    capture_s = time.perf_counter() - t0
    pool_gib = (torch.cuda.memory_reserved() - res0) / 2**30
    held_gib = (torch.cuda.memory_allocated() - alloc0) / 2**30
    r0 = eng.graph_replays()
    toks, c, st, ring, wgmma, _ = served(torch, eng, cfg)
    by_shape = {f"{k}/{w}/{b}": n - r0[(k, w, b)]
                for (k, w, b), n in sorted(eng.graph_replays().items())}
    peak = torch.cuda.max_memory_allocated() / 2**30
    replays = sum(by_shape.values())
    if toks != cold["tokens"]:
        raise AssertionError(f"{tag} warmed tokens differ from phase 3's "
                             f"(agreement {agreement(toks, cold['tokens'])})")
    if replays <= 0:
        raise AssertionError(f"{tag} no graph was replayed")
    if wgmma != ring:
        raise AssertionError(f"{tag} {wgmma} of {ring} direct ring launches "
                             "on the tensor-core route")
    log(f"{tag} warm_steps: {calls} step calls, {len(by_shape)} graphs "
        f"captured in {capture_s:.2f} s, graph pool {pool_gib:.3f} GiB "
        f"({held_gib:.3f} GiB held by the graphs' outputs)")
    log(f"{tag} tokens bit-identical to phase 3; {replays} replays "
        "(kind/width/bucket: " + ", ".join(f"{k} {n}"
                                           for k, n in by_shape.items())
        + f"); {ring} ring launches outside a graph; peak {peak:.2f} GiB")
    log(f"{tag} cold (phase 3): " + latency(cold["stats"]))
    log(f"{tag} warm:           " + latency(st))
    del eng
    free_card(torch)
    busy, kernels, counted = {}, {}, {}
    for k in ("cold", "warm"):
        busy[k], kernels[k], counted[k] = profiled_serve(
            torch, make_engine(cfg, cold["params"]), cfg, warm=k == "warm")
        free_card(torch)
    log(f"{tag} kernels the card ran (profiler calls): cold {kernels['cold']}"
        f", warm {kernels['warm']}; ring launches counted in Python: cold "
        f"{counted['cold']}, warm {counted['warm']} (outside a graph)")
    if (kernels["warm"] != kernels["cold"]
            or kernels["cold"]["ring_wgmma_kernel"] != counted["cold"]
            or counted["cold"] <= 0):
        raise AssertionError(
            f"{tag} the warmed serve ran other kernels than the cold one, "
            f"or the profiler missed launches: {kernels}, counted {counted}")
    walls = {"cold": cold["stats"]["wall"], "warm": st["wall"]}
    idle = {k: (None if busy[k] is None else 1 - busy[k] / walls[k])
            for k in walls}
    log(f"{tag} device busy (profiled replays) cold "
        f"{busy['cold']} s, warm {busy['warm']} s; idle share of the "
        f"unprofiled wall cold {idle['cold']}, warm {idle['warm']}")
    log(f"{tag} " + json.dumps({
        "arch": cfg.name, "warm_calls": calls, "graphs": len(by_shape),
        "capture_s": capture_s, "graph_pool_gib": pool_gib,
        "graph_outputs_gib": held_gib, "peak_gib": peak,
        "replays": replays, "replays_by_shape": by_shape,
        "ring_outside_graphs": ring, "profiled_kernel_calls": kernels,
        "profiled_python_ring_launches": counted,
        "busy_s": busy, "idle_share": idle,
        **{f"{k}_{m}": v for k, s_ in (("cold", cold["stats"]), ("warm", st))
           for m, v in (("tokens_per_s", s_["tokens"] / s_["wall"]),
                        ("wall", s_["wall"]), ("ttft_p50", s_["ttft_p50"]),
                        ("ttft_p99", s_["ttft_p99"]),
                        ("tpot_p50", s_["tpot_p50"]),
                        ("tpot_p99", s_["tpot_p99"]))}}))


# ---------------------------------------------------------------------------
# phase 12: whole-prompt prefill (the eager engine and the slot monolith)
# and the per-token scan chunk path
# ---------------------------------------------------------------------------

def prefill_launches(torch):
    """(flash forward, of them on the tensor-core route, SSD scan, of them
    on the tensor-core route) launches since ``reset_launches``, made by
    calls in Python."""
    from repro_torch.kernels.flash_attention import ops
    from repro_torch.kernels.ssd_scan import ops as ssd_ops
    return (ops.flash_attention.launches, ops.flash_attention.wgmma_launches,
            ssd_ops.ssd_scan.launches, ssd_ops.ssd_scan.wgmma_launches)


def mode_serve(torch, eng, cfg):
    """Serve the main path's requests on ``eng`` in any engine mode, the
    launch counts zeroed just before and read just after: every request
    checked, a paged engine's pool audited.  Returns the tokens, counters,
    latency stats of the 8 with their wall, and each serving kernel's
    launches."""
    from repro_torch.serving.engine import ServeEngine
    reset_launches(torch)
    first, reqs, res, wall = serve(torch, eng, cfg)
    ring, ring_wgmma, lru = kernel_launches(torch)
    flash, flash_wgmma, ssd, ssd_wgmma = prefill_launches(torch)
    check_requests(cfg, [first] + reqs)
    if eng.pool is not None:
        eng.pool.audit(live_tables(eng))
    st = ServeEngine.stats(reqs)
    st["wall"] = wall
    return {"tokens": [r.generated for r in [first] + reqs],
            "counters": res["counters"], "stats": st,
            "relayouts": len(res["relayouts"]), "ring": ring,
            "ring_wgmma": ring_wgmma, "lru": lru, "flash": flash,
            "flash_wgmma": flash_wgmma, "ssd": ssd, "ssd_wgmma": ssd_wgmma}


def check_whole_prefill(tag, cfg, run, n_req):
    """An eager or monolith serve: ``n_req`` whole-prompt prefills and no
    chunk tick; each prefill launched the flash forward once an attention
    layer, the SSD scan once an SSD layer and the RG-LRU scan once a
    recurrent layer, bf16 on the tensor-core routes; no ring launch."""
    types = cfg.layer_types()
    want = {"flash": types.count("attn") * n_req,
            "ssd": types.count("ssd") * n_req,
            "lru": types.count("rec") * n_req, "ring": 0}
    c = run["counters"]
    got = {k: run[k] for k in want}
    if (c.get("prefills") != n_req or c.get("chunk_ticks", 0)
            or got != want or run["flash_wgmma"] != run["flash"]
            or run["ssd_wgmma"] != run["ssd"]):
        raise AssertionError(
            f"{tag} prefills {c.get('prefills')} (want {n_req}), chunk "
            f"ticks {c.get('chunk_ticks', 0)}, launches {got} (want {want})"
            f", tensor-core flash {run['flash_wgmma']}, SSD "
            f"{run['ssd_wgmma']}")


def mode_line(tag, name, run, ref=None, ref_name=""):
    st = run["stats"]
    log(f"{tag} {name}: {st['tokens']} tokens in {st['wall']:.2f} s: "
        + latency(st) + (f"; agreement with {ref_name} "
                         f"{agreement(run['tokens'], ref):.4f}"
                         if ref is not None else ""))


def cache_gib(eng):
    """Bytes of the slot monolith's group caches, in GiB."""
    from repro_torch.models import decode as dec
    return sum(t.numel() * t.element_size() for g in eng.groups
               for t in dec.tree_leaves(g.cache, eng._cache_spec)) / 2**30


def phase_modes(torch, cold):
    """Phase 12 on phase 3's model and requests (llama3-8b, full width and
    depth, bf16): (a) the eager engine, (b) the slot monolith over two
    groups, (c) the scan chunk path cold, then a fresh scan engine warmed
    by ``warm_steps`` (CUDA graphs of the scan step) whose tokens must be
    the cold scan run's bit for bit — a second serve on the first engine
    would meet its cached prefix pages and run another schedule — and (d)
    ``make_prefill`` + ``make_generate`` on the first request's prompt.
    Agreement with phase 3 is printed, not gated: in bf16 whole-prompt
    and chunked prefill agree only to tolerance.  Returns the flash
    forward's launches of (a)."""
    import numpy as np
    from repro_torch.configs import REGISTRY
    cfg = REGISTRY[ENGINE_ARCH]
    tag = f"[modes {cfg.name}]"
    base = cold["tokens"]
    log(f"{tag} phase 3 (lazy, fused chunks): " + latency(cold["stats"]))
    out, secs = {}, {}
    for name, opts in (("eager", {"lazy": False}),
                       ("monolith", {"paged": False}),
                       ("scan", {"prefill_mode": "scan"})):
        free_card(torch)
        t0 = time.perf_counter()
        eng = make_engine(cfg, cold["params"], **opts)
        run = mode_serve(torch, eng, cfg)
        secs[name] = time.perf_counter() - t0
        c = run["counters"]
        if name == "scan":
            ticks = c.get("chunk_ticks", 0)
            if (ticks <= 0 or c.get("prefill_model_steps")
                    != eng._chunk * ticks or run["ring"]):
                raise AssertionError(
                    f"{tag} scan: {c.get('prefill_model_steps')} model "
                    f"steps over {ticks} chunk ticks of {eng._chunk}, "
                    f"ring launches {run['ring']}")
        else:
            check_whole_prefill(f"{tag} {name}", cfg, run, 9)
        if name == "monolith" and eng.kv_stats() != {}:
            raise AssertionError(f"{tag} monolith kv_stats not empty")
        extra = (f", group caches {cache_gib(eng):.3f} GiB over "
                 f"{len(eng.groups)} groups, relayouts {run['relayouts']}"
                 if name == "monolith" else "")
        mode_line(tag, name, run, base, "phase 3")
        log(f"{tag} {name}: flash forward launches {run['flash']} "
            f"({run['flash_wgmma']} on the tensor-core route), ring "
            f"{run['ring']}, prefills {int(c.get('prefills', 0))}, chunk "
            f"ticks {int(c.get('chunk_ticks', 0))}, prefill model steps "
            f"{int(c.get('prefill_model_steps', 0))}{extra}; "
            f"{secs[name]:.1f} s with set-up")
        out[name] = run
        if name == "scan":
            scan_chunk = eng._chunk
        del eng
    mode_line(tag, "monolith against eager", out["monolith"],
              out["eager"]["tokens"], "eager")
    # (c) continued: the scan step captured as CUDA graphs
    free_card(torch)
    eng = make_engine(cfg, cold["params"], prefill_mode="scan")
    t0 = time.perf_counter()
    calls = eng.warm_steps()
    torch.cuda.synchronize()
    capture_s = time.perf_counter() - t0
    r0 = eng.graph_replays()
    warm = mode_serve(torch, eng, cfg)
    replays = {f"{k}/{w}/{b}": n - r0[(k, w, b)]
               for (k, w, b), n in sorted(eng.graph_replays().items())}
    if warm["tokens"] != out["scan"]["tokens"]:
        raise AssertionError(
            f"{tag} warmed scan tokens differ from the cold scan run's "
            f"(agreement {agreement(warm['tokens'], out['scan']['tokens'])})")
    if sum(n for k, n in replays.items()
           if k.startswith(f"chunk/{scan_chunk}/")) <= 0:
        raise AssertionError(f"{tag} no scan chunk graph replayed: "
                             f"{replays}")
    mode_line(tag, "scan warm", warm, out["scan"]["tokens"], "scan cold")
    log(f"{tag} scan warm: {calls} step calls, {len(replays)} graphs "
        f"captured in {capture_s:.2f} s; tokens bit-identical to the cold "
        f"scan run; replays (kind/width/bucket): "
        + ", ".join(f"{k} {n}" for k, n in replays.items()))
    out["scan_warm"] = warm
    del eng
    # (d) make_prefill + make_generate on the first request, B=1, greedy
    free_card(torch)
    rng = np.random.default_rng(0)
    preamble = rng.integers(2, cfg.vocab, size=128)
    prompt = np.concatenate([preamble, rng.integers(2, cfg.vocab, size=20)])
    budget = len(base[0])
    reset_launches(torch)
    t0 = time.perf_counter()
    gen = generated(torch, cfg, cold["params"], prompt, budget, 1024)
    torch.cuda.synchronize()
    gen_s = time.perf_counter() - t0
    flash = prefill_launches(torch)[0]
    if len(gen) != budget or flash != cfg.n_layers \
            or not all(0 <= t < cfg.vocab for t in gen):
        raise AssertionError(f"{tag} make_generate: {len(gen)} tokens of "
                             f"{budget}, {flash} flash launches")
    log(f"{tag} make_prefill + make_generate (B=1, greedy, {budget} tokens, "
        f"{gen_s:.2f} s, {flash} flash launches): {gen}; agreement with "
        f"phase 3's first request {agreement([gen], base[:1]):.4f}, with "
        f"the eager engine's "
        f"{agreement([gen], out['eager']['tokens'][:1]):.4f}")
    log(f"{tag} " + json.dumps({
        "arch": cfg.name, "seconds": secs, "scan_capture_s": capture_s,
        "scan_warm_calls": calls, "scan_replays": replays,
        "generate_s": gen_s,
        **{f"{k}_{m}": v for k, r in (("phase3", cold),
                                      *((n, out[n]) for n in out))
           for m, v in (("tokens_per_s", r["stats"]["tokens"]
                         / r["stats"]["wall"]),
                        ("wall", r["stats"]["wall"]),
                        ("ttft_p50", r["stats"]["ttft_p50"]),
                        ("tpot_p50", r["stats"]["tpot_p50"]))},
        **{f"{n}_agreement_phase3": agreement(out[n]["tokens"], base)
           for n in out},
        **{f"{n}_flash_launches": out[n]["flash"] for n in out}}))
    return out["eager"]["flash"]


def phase_modes_family(torch, served):
    """Phase 12 (e): the eager engine on ``served``'s model (phase 6's
    mamba2-780m or phase 8's recurrentgemma-9b, full width and depth,
    bf16) and the main path's requests.  Returns the run."""
    from repro_torch.configs import REGISTRY
    cfg = REGISTRY[served["arch"]]
    tag = f"[modes {cfg.name}]"
    free_card(torch)
    t0 = time.perf_counter()
    eng = make_engine(cfg, served["params"], lazy=False)
    run = mode_serve(torch, eng, cfg)
    secs = time.perf_counter() - t0
    check_whole_prefill(f"{tag} eager", cfg, run, 9)
    mode_line(tag, "eager", run, served["tokens"], f"phase "
              f"{'6' if cfg.family == 'ssm' else '8'}")
    log(f"{tag} eager: {run['flash']} flash forward, {run['ssd']} SSD scan "
        f"({run['ssd_wgmma']} on the tensor-core route), {run['lru']} "
        f"RG-LRU scan launches for 9 prefills, 0 ring, no chunk tick; "
        f"{secs:.1f} s with set-up")
    del eng
    free_card(torch)
    return run


# ---------------------------------------------------------------------------
# phase 4
# ---------------------------------------------------------------------------

TRAIN_ARCH = "llama3.2-3b"
TRAIN_B, TRAIN_S, TRAIN_STEPS = 2, 2048, 4
TRAIN_REMAT = "none"
# mamba2-780m saves about 144 KB a token a layer for its backward, so B=4
# (57 GB of activations beside 9.4 GB of state) fits one card with remat
# "none" and B=8 does not (PERF.md, phase 5's cell)
SSM_B, SSM_REMAT = 4, "none"


def free_card(torch):
    gc.collect()                # the engine's tasks hold it in cycles
    torch.cuda.empty_cache()


def phase_train(torch, arch, B, remat, kernels, probes, profile=False,
                S=TRAIN_S, layers=0, opt_impl="adamw", ef=False,
                stats=None, time_update=False):
    """4 steps of the port's train step on ``arch`` at full width and
    depth (``layers`` cuts the depth when given), bf16, sequence ``S``.
    ``kernels``: name -> (wrapper with a ``launches`` count, launches
    expected per step); ``probes``: name -> a parameter slice that must
    change.  ``opt_impl``: the step's optimizer ("adamw8bit": int8 /
    uint8 moments, gated); ``ef``: the step threads int8 error-feedback
    compression (``compression.int8_compress_transform``), whose buffers
    must be non-zero after the first step.  ``stats``, when given, gets
    the step's record (steady seconds a step, tokens/s, peak GiB);
    ``time_update`` adds the optimizer update's own seconds, timed by a
    spy that synchronises the card around it.
    Returns name -> launches over the 4 steps."""
    import dataclasses
    import math
    import shutil
    import tempfile
    from repro_torch.compression import (init_compression,
                                         int8_compress_transform)
    from repro_torch.configs import REGISTRY
    from repro_torch.data.pipeline import (ShardedLoader, SyntheticCorpus,
                                           make_batch, write_corpus_shards)
    from repro_torch.launch import steps as steps_mod
    from repro_torch.models.params import init_params, n_params
    from repro_torch.optim.adamw import AdamWConfig, init_opt_state
    from repro_torch.optim.quantized import init_opt_state_8bit

    cfg = dataclasses.replace(REGISTRY[arch], remat=remat,
                              n_layers=layers or REGISTRY[arch].n_layers)
    t0 = time.perf_counter()
    gen = torch.Generator(device="cuda").manual_seed(0)
    params = init_params(cfg, gen, device="cuda")
    opt = (init_opt_state_8bit if opt_impl == "adamw8bit"
           else init_opt_state)(params)
    efs = init_compression(params)["ef"] if ef else None
    update_s = []
    inner = steps_mod.UPDATES[opt_impl]
    if time_update:
        def timed_update(*a, **kw):
            torch.cuda.synchronize()
            t = time.perf_counter()
            out = inner(*a, **kw)
            torch.cuda.synchronize()
            update_s.append(time.perf_counter() - t)
            return out
        steps_mod.UPDATES[opt_impl] = timed_update
    try:
        # warmup of one step so bf16 weights move from the first update
        step = steps_mod.make_train_step(
            cfg, AdamWConfig(warmup_steps=1), opt_impl=opt_impl,
            ef_transform=int8_compress_transform if ef else None)
    finally:
        steps_mod.UPDATES[opt_impl] = inner
    torch.cuda.synchronize()
    tag = f"[train {cfg.name}]"
    log(f"{tag} layers={cfg.n_layers} d_model={cfg.d_model} "
        f"family={cfg.family} vocab={cfg.vocab} {n_params(cfg)} params "
        f"{cfg.param_dtype}, remat={cfg.remat}; B={B} S={S}; {opt_impl}"
        + (", int8 error feedback" if ef else "") + "; set-up "
        f"{time.perf_counter() - t0:.1f} s, "
        f"{torch.cuda.memory_allocated() / 2**30:.3f} GiB on the card")
    before = {k: f(params).clone() for k, f in probes.items()}
    tmp = tempfile.mkdtemp(prefix="chip_smoke_corpus_")
    try:
        files = write_corpus_shards(
            tmp, SyntheticCorpus(cfg.vocab, seed=0), n_shards=2,
            tokens_per_shard=B * (S + 1) * (TRAIN_STEPS + 1))
        loader = ShardedLoader(files, seq_len=S, batch=B)
        batches = []
        for _ in range(TRAIN_STEPS + int(profile)):
            batches.append({k: torch.from_numpy(v).to("cuda") for k, v in
                            make_batch(cfg, loader.next()).items()})
    finally:
        shutil.rmtree(tmp)
    torch.cuda.reset_peak_memory_stats()
    for fn, _ in kernels.values():
        fn.launches = 0
        if hasattr(fn, "wgmma_launches"):
            fn.wgmma_launches = 0
    secs = []
    for i in range(TRAIN_STEPS):
        torch.cuda.synchronize()
        t = time.perf_counter()
        if ef:
            params, opt, m, efs = step(params, opt, batches[i], efs)
        else:
            params, opt, m = step(params, opt, batches[i])
        loss, gnorm = float(m["loss"]), float(m["grad_norm"])
        aux = float(m["aux"])
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t)
        if not all(map(math.isfinite, (loss, gnorm, aux))):
            raise AssertionError(f"step {i + 1}: loss {loss}, grad norm "
                                 f"{gnorm}, aux {aux}")
        log(f"{tag} step {i + 1}: loss {loss:.6f} grad_norm {gnorm:.6f} "
            f"aux {aux:.6f} lr {float(m['lr']):.3e} {secs[-1]:.6f} s"
            + (f", peak {torch.cuda.max_memory_allocated() / 2**30:.3f} "
               "GiB after the first step" if i == 0 else ""))
        if ef and i == 0 and not any(
                bool(e.any()) for e in _tree_leaves(efs)):
            raise AssertionError("the error-feedback buffers are all zero "
                                 "after the first step")
    launches = {name: fn.launches for name, (fn, _) in kernels.items()}
    want = {name: TRAIN_STEPS * per for name, (_, per) in kernels.items()}
    if launches != want:
        raise AssertionError(f"kernel launches {launches} over "
                             f"{TRAIN_STEPS} steps, expected {want}")
    # bf16 steps: a kernel with two routes (the flash kernels) launched on
    # the tensor-core route only
    for name, (fn, _) in kernels.items():
        wgmma = getattr(fn, "wgmma_launches", None)
        if wgmma is not None and wgmma != launches[name]:
            raise AssertionError(f"{name}: {wgmma} of {launches[name]} "
                                 "launches on the tensor-core route")
    for k, f in probes.items():
        if torch.equal(f(params), before[k]):
            raise AssertionError(f"{k} did not change in {TRAIN_STEPS} "
                                 "steps")
    if opt_impl == "adamw8bit":
        for k, want in (("m", torch.int8), ("v", torch.uint8)):
            kinds = {q.dtype for q in _tree_leaves(opt[k]) if q.dim()
                     and q.dtype != torch.float32}
            if kinds != {want}:
                raise AssertionError(f"8-bit {k}: moments of {kinds}")
    steady = sum(secs[1:]) / len(secs[1:])
    peak = torch.cuda.max_memory_allocated() / 2**30
    log(f"{tag} launches {launches} ("
        + ", ".join(f"{per} a step" for _, per in kernels.values())
        + "); parameters changed"
        + ("; every launch of a two-route kernel took the tensor-core "
           "route"
           if any(hasattr(fn, "wgmma_launches") for fn, _ in kernels.values())
           else ""))
    record = {
        "arch": cfg.name, "layers": cfg.n_layers, "batch": B, "seq": S,
        "remat": cfg.remat, "opt_impl": opt_impl, "ef": ef, "step_s": secs,
        "steady_step_s": steady, "tokens_per_s": B * S / steady,
        "peak_gib": peak}
    if update_s:
        record["update_s"] = update_s
        record["steady_update_s"] = sum(update_s[1:]) / len(update_s[1:])
    log(f"{tag} " + json.dumps(record))
    if stats is not None:
        stats.update(record)
    if profile:
        profile_train_step(torch, step, params, opt, batches[-1],
                           KERNEL_SYMBOLS[arch])
    del params, opt, batches, before, efs
    free_card(torch)
    return launches


def _tree_leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _tree_leaves(v)
    else:
        yield tree


# the device symbols of each training path's hand-written kernels
KERNEL_SYMBOLS = {
    TRAIN_ARCH: ("flash_fwd_wgmma_kernel", "flash_dq_wgmma_kernel",
                 "flash_dkv_wgmma_kernel", "flash_delta_kernel"),
    "mamba2-780m": SSD_SYMBOLS,
    HYBRID_ARCH: ("lru_single_pass", "flash_fwd_wgmma_kernel",
                  "flash_dq_wgmma_kernel", "flash_dkv_wgmma_kernel",
                  "flash_delta_kernel"),
}


def profile_train_step(torch, step, params, opt, batch, symbols):
    """One more step under torch.profiler: the card's busy time against
    the step's wall, the kernels by device time, the share of the kernels
    named by ``symbols``."""
    prof = torch.profiler.profile(activities=[
        torch.profiler.ProfilerActivity.CPU,
        torch.profiler.ProfilerActivity.CUDA])
    torch.cuda.synchronize()
    with prof:
        t = time.perf_counter()
        step(params, opt, batch)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
    rows = []
    for e in prof.key_averages():
        if not str(getattr(e, "device_type", "")).endswith("CUDA"):
            continue
        dev = getattr(e, "self_device_time_total",
                      getattr(e, "self_cuda_time_total", 0.0))
        if dev > 0:
            rows.append((dev, e.count, e.key))
    if not rows:
        log("[profile] train step device time: not measured (the profiler "
            "saw no device activity)")
        return
    busy = sum(r[0] for r in rows) / 1e6
    mine = {n: sum(r[0] for r in rows if n in r[2]) / 1e6 for n in symbols}
    log(f"[profile] train step: wall {wall:.6f} s profiled, device busy "
        f"{busy:.6f} s (idle share {1 - busy / wall:.4f})")
    log("[profile] hand-written kernels: " + ", ".join(
        f"{n} {t:.6f} s ({t / busy:.4f} of busy)" for n, t in mine.items()))
    for dev, count, key in sorted(rows, reverse=True)[:15]:
        log(f"[profile]   {dev / 1e3:12.3f} ms {count:7d}x  {key[:90]}")


# ---------------------------------------------------------------------------
# phase 4b
# ---------------------------------------------------------------------------

def phase_train_main(torch, fa_ops, profile):
    """Phase 4: llama3.2-3b trained at full width and depth; its record
    goes to ``PHASE4`` (phase 16 holds the dry run against it).  Returns
    the flash kernels' launches over the steps."""
    from repro_torch.configs import REGISTRY
    n_dense = REGISTRY[TRAIN_ARCH].n_layers
    return phase_train(
        torch, TRAIN_ARCH, TRAIN_B, TRAIN_REMAT,
        # the forward runs twice a layer under remat
        {"flash_attention_fwd": (fa_ops.flash_attention, n_dense * (
            1 if TRAIN_REMAT == "none" else 2)),
         "flash_attention_bwd": (fa_ops.flash_attention_bwd, n_dense)},
        {"wq[0]": lambda p: p["layers"]["attn"]["wq"][0],
         "embed[:4096]": lambda p: p["embed"][:4096]}, profile,
        stats=PHASE4)


def phase_trainer(torch, arch, kernel):
    """The port's Trainer end to end on a reduced ``arch`` in float32:
    checkpoint and resume on the card, and the card's losses against the
    CPU's (the plain versions of the kernels).  ``kernel``: the wrapper
    whose launches show the card run went through its CUDA kernel."""
    import dataclasses
    import os
    import shutil
    import tempfile
    from repro_torch.configs import REGISTRY, reduced_config
    from repro_torch.data.pipeline import (ShardedLoader, SyntheticCorpus,
                                           write_corpus_shards)
    from repro_torch.models.params import init_params
    from repro_torch.optim.adamw import AdamWConfig
    from repro_torch.runtime.trainer import Trainer, TrainerConfig

    cfg = reduced_config(REGISTRY[arch])
    base = init_params(cfg, torch.Generator().manual_seed(0), device="cpu")

    tmp = tempfile.mkdtemp(prefix="chip_smoke_trainer_")
    try:
        files = write_corpus_shards(os.path.join(tmp, "data"),
                                    SyntheticCorpus(cfg.vocab, seed=1),
                                    n_shards=2, tokens_per_shard=2000)

        def trainer(device, ckpt):
            tcfg = TrainerConfig(steps=6, ckpt_every=3, log_every=100,
                                 ckpt_dir=os.path.join(tmp, ckpt),
                                 opt=AdamWConfig(peak_lr=1e-3,
                                                 warmup_steps=2,
                                                 total_steps=20))
            return Trainer(cfg, ShardedLoader(files, seq_len=64, batch=2),
                           tcfg, log=lambda s: None,
                           params=_to_device(base, device), device=device)

        f0 = kernel.launches
        card = trainer("cuda", "ckpt_cuda")
        losses = card.run()["losses"]
        if kernel.launches == f0:
            raise AssertionError(f"the Trainer on the card launched no "
                                 f"{kernel.__name__} kernel")
        if card.ckpt.steps() != [3, 6]:
            raise AssertionError(f"checkpoints {card.ckpt.steps()}")
        shutil.rmtree(card.ckpt._step_dir(6))
        fresh = trainer("cuda", "ckpt_cuda")
        if not fresh.resume_if_possible() or fresh.step != 3:
            raise AssertionError("resume from step 3 failed")
        again = fresh.run()["losses"]
        cpu = trainer("cpu", "ckpt_cpu").run()["losses"]
    finally:
        shutil.rmtree(tmp)
    resume_err = max(abs(a - b) / max(1.0, abs(b))
                     for a, b in zip(again, losses[3:]))
    cpu_err = max(abs(a - b) for a, b in zip(losses, cpu))
    log(f"[trainer] {cfg.name} float32 on the card: losses "
        f"{[round(x, 6) for x in losses]}; resumed at step 3: "
        f"{[round(x, 6) for x in again]} (max rel err {resume_err:.3e}, "
        f"tol 1e-5); CPU (plain versions) max abs err {cpu_err:.3e} "
        f"(tol 1e-4); {kernel.__name__} launched "
        f"{kernel.launches - f0} times on the card")
    if resume_err > 1e-5:
        raise AssertionError("resumed losses differ from the first run")
    if cpu_err > 1e-4:
        raise AssertionError("the card's losses differ from the CPU's")


# ---------------------------------------------------------------------------
# phase 13: the MoE family
# ---------------------------------------------------------------------------

MOE_ARCH = "mixtral-8x22b"
# mixtral-8x22b at full width cut to 8 of its 56 layers: a layer holds
# 2,504,060,928 parameters (5.01 GB in bf16), so all 56 do not fit one
# card; 8 layers with the embedding and head come to 20,435,146,752
# parameters, 38.1 GiB
MOE_LAYERS = 8
# one layer trained at mixtral's own 8192-token context (B=1): the 4096
# window masks half of the causal band; 2,906,720,256 parameters, 32.5
# GiB of weights, gradients and float32 moments
MOE_TRAIN_S = 8192


def moe_config(layers=MOE_LAYERS):
    import dataclasses
    from repro_torch.configs import REGISTRY
    return dataclasses.replace(REGISTRY[MOE_ARCH], n_layers=layers)


def decode_bound_s(cfg):
    """Seconds a decode step of the slot layout cannot go below: every
    weight but the embedding table (of which a step gathers a row a
    stream) read once, against the card's memory rate."""
    from repro_torch.models.params import param_bytes
    return (param_bytes(cfg) - cfg.vocab_padded * cfg.d_model * 2) \
        / PEAK_BYTES


def spy_dropped():
    """Record every ``moe_apply`` call's positions a row and ``dropped`` (a
    device scalar); returns (the list of pairs, a function that takes the
    spy out)."""
    from repro_torch.models import moe
    apply, seen = moe.moe_apply, []

    def spy(x, *a, **kw):
        y, aux = apply(x, *a, **kw)
        seen.append((x.shape[1], aux["dropped"].detach()))
        return y, aux

    moe.moe_apply = spy
    return seen, lambda: setattr(moe, "moe_apply", apply)


def phase_moe_serve(torch):
    """Phase 13 (a) and (b): phase 3's requests on mixtral-8x22b at full
    width and 8 layers (bf16, random weights from seed 0), (a) cold — 8
    ring launches a chunk tick on the tensor-core route, a prefix hit,
    the pool's audit — then on a fresh engine warmed by ``warm_steps``,
    whose tokens must be the cold run's bit for bit with graphs replayed
    (the dropless MoE step reads nothing on the host); (b) the eager
    engine: 8 flash forward launches a prompt on the tensor-core route,
    no ring launch, agreement with (a) printed (whole-prompt prefill
    drops claims at capacity factor 1.25, the chunk steps do not).
    Returns the ring launches of (a) and the flash launches of (b)."""
    from repro_torch.models.params import n_params
    cfg = moe_config()
    tag = f"[moe {cfg.name}]"
    t0 = time.perf_counter()
    eng = make_engine(cfg)
    torch.cuda.synchronize()
    log(f"{tag} d_model={cfg.d_model} layers={cfg.n_layers} of 56 "
        f"heads={cfg.n_heads}/{cfg.n_kv_heads} d_ff={cfg.d_ff} experts="
        f"{cfg.n_experts} top-{cfg.top_k} window={cfg.window} "
        f"vocab={cfg.vocab} {cfg.param_dtype}, {n_params(cfg)} params; "
        f"set-up {time.perf_counter() - t0:.1f} s, "
        f"{torch.cuda.memory_allocated() / 2**30:.1f} GiB on the card")
    seen, restore = spy_dropped()
    try:
        cold = mode_serve(torch, eng, cfg)
    finally:
        restore()
    # the chunk and decode steps run the experts dropless
    step_dropped = float(torch.stack([d for _, d in seen]).max())
    c = cold["counters"]
    ticks = int(c.get("chunk_ticks", 0))
    hits = c.get("kv_prefix_hits", 0.0)
    if (ticks <= 0 or cold["ring"] != cfg.n_layers * ticks
            or cold["ring_wgmma"] != cold["ring"] or cold["flash"]
            or hits <= 0 or step_dropped != 0.0):
        raise AssertionError(
            f"{tag} cold: ring launches {cold['ring']} ({cold['ring_wgmma']}"
            f" on the tensor-core route) over {ticks} chunk ticks of "
            f"{cfg.n_layers} layers, flash {cold['flash']}, prefix hits "
            f"{hits}, dropped up to {step_dropped} in a serving step")
    params = eng.params
    del eng
    free_card(torch)
    eng = make_engine(cfg, params)
    t0 = time.perf_counter()
    calls = eng.warm_steps()
    torch.cuda.synchronize()
    capture_s = time.perf_counter() - t0
    r0 = eng.graph_replays()
    warm = mode_serve(torch, eng, cfg)
    replays = {f"{k}/{w}/{b}": n - r0[(k, w, b)]
               for (k, w, b), n in sorted(eng.graph_replays().items())}
    if warm["tokens"] != cold["tokens"]:
        raise AssertionError(f"{tag} warmed tokens differ from the cold "
                             f"run's (agreement "
                             f"{agreement(warm['tokens'], cold['tokens'])})")
    if sum(replays.values()) <= 0:
        raise AssertionError(f"{tag} no graph was replayed")
    del eng
    free_card(torch)
    eng = make_engine(cfg, params, lazy=False)
    seen, restore = spy_dropped()
    try:
        eager = mode_serve(torch, eng, cfg)
    finally:
        restore()
    check_whole_prefill(f"{tag} eager", cfg, eager, 9)
    # whole-prompt prefill keeps the configured capacity; decode steps
    # (one position a row) are dropless
    prefill_dropped = [float(d) for n, d in seen if n > 1]
    if max(float(d) for n, d in seen if n == 1) != 0.0:
        raise AssertionError(f"{tag} eager: a decode step dropped claims")
    del eng, params
    free_card(torch)
    bound = decode_bound_s(cfg)
    mode_line(tag, "cold", cold)
    mode_line(tag, "warm", warm, cold["tokens"], "cold")
    mode_line(tag, "eager", eager, cold["tokens"], "cold")
    log(f"{tag} cold: ring launches {cold['ring']} ({cold['ring_wgmma']} on "
        f"the tensor-core route) over {ticks} chunk ticks, kv_prefix_hits "
        f"{int(hits)}, pool audit ok; warm: {calls} step calls, "
        f"{len(replays)} graphs captured in {capture_s:.2f} s, tokens "
        f"bit-identical to cold, replays (kind/width/bucket): "
        + ", ".join(f"{k} {n}" for k, n in replays.items()))
    log(f"{tag} eager: flash forward launches {eager['flash']} "
        f"({eager['flash_wgmma']} on the tensor-core route), ring "
        f"{eager['ring']}, 9 prefills, no chunk tick; the prefills "
        f"dropped {sum(prefill_dropped) / len(prefill_dropped):.4f} of "
        f"their claims on average over {len(prefill_dropped)} layer calls "
        f"(up to {max(prefill_dropped):.4f}) at capacity factor "
        f"{cfg.capacity_factor}, the serving steps none; decode-step bound "
        f"{bound * 1e3:.3f} ms (every weight but the embedding read once "
        f"at {PEAK_BYTES / 1e12} TB/s) against TPOT p50 cold "
        f"{cold['stats']['tpot_p50'] * 1e3:.3f} ms, warm "
        f"{warm['stats']['tpot_p50'] * 1e3:.3f} ms")
    log(f"{tag} " + json.dumps({
        "arch": cfg.name, "layers": cfg.n_layers, "chunk_ticks": ticks,
        "ring_launches": cold["ring"], "prefix_hits": hits,
        "warm_calls": calls, "capture_s": capture_s, "replays": replays,
        "eager_flash_launches": eager["flash"],
        "eager_prefill_dropped": prefill_dropped,
        "decode_bound_s": bound,
        **{f"{k}_{m}": v for k, r in (("cold", cold), ("warm", warm),
                                      ("eager", eager))
           for m, v in (("tokens_per_s", r["stats"]["tokens"]
                         / r["stats"]["wall"]),
                        ("wall", r["stats"]["wall"]),
                        ("ttft_p50", r["stats"]["ttft_p50"]),
                        ("tpot_p50", r["stats"]["tpot_p50"]))},
        "eager_agreement_cold": agreement(eager["tokens"], cold["tokens"]),
        "peak_gib": torch.cuda.max_memory_allocated() / 2**30}))
    return {"ring": cold["ring"], "flash": eager["flash"]}


def phase_moe_train(torch):
    """Phase 13 (c): one mixtral-8x22b layer at full width, B=1, S=8192,
    4 steps: losses, grad norms and ``aux`` finite, every layer's
    ``dropped`` in [0, 1), the router, an expert's ``wi`` and ``wq``
    changed, each flash kernel launched once a step.  Returns the
    launches."""
    from repro_torch.kernels.flash_attention import ops as fa_ops
    seen, restore = spy_dropped()
    try:
        launches = phase_train(
            torch, MOE_ARCH, 1, "none",
            {"flash_attention_fwd": (fa_ops.flash_attention, 1),
             "flash_attention_bwd": (fa_ops.flash_attention_bwd, 1)},
            {"router[0]": lambda p: p["layers"]["moe"]["router"][0],
             "wi[0][3][:64]": lambda p: p["layers"]["moe"]["wi"][0, 3, :64],
             "wq[0]": lambda p: p["layers"]["attn"]["wq"][0]},
            S=MOE_TRAIN_S, layers=1)
    finally:
        restore()
    dropped = [float(d) for _, d in seen]
    if len(dropped) != 4 or not all(0.0 <= d < 1.0 for d in dropped):
        raise AssertionError(f"[train {MOE_ARCH}] dropped {dropped}: want "
                             "4 values in [0, 1)")
    log(f"[train {MOE_ARCH}] dropped (share of claims past capacity, "
        f"capacity factor 1.25, a step): {dropped}")
    return launches


def phase_moe_capacity(torch):
    """Phase 13 (d), last part: reduced mixtral-8x22b in float32 at
    capacity factor 1.0 through ``make_prefill`` + ``make_generate`` (B=2)
    on the CPU and the card: the card's prefill drops claims, its logits
    agree with the CPU's to 1e-4 and its greedy tokens are the CPU's."""
    import dataclasses
    import numpy as np
    from repro_torch.configs import REGISTRY, reduced_config
    from repro_torch.launch.steps import make_generate, make_prefill
    from repro_torch.models.params import init_params
    cfg = dataclasses.replace(reduced_config(REGISTRY[MOE_ARCH]),
                              capacity_factor=1.0)
    base = init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    prompts = torch.from_numpy(np.random.default_rng(2).integers(
        2, cfg.vocab, size=(2, 40)).astype(np.int32))
    out = {}
    for device in ("cpu", "cuda"):
        params = _to_device(base, device)
        seen, restore = spy_dropped()
        try:
            logits, cache = make_prefill(cfg, 64)(
                params, {"tokens": prompts.to(device)})
        finally:
            restore()
        first = logits.argmax(-1).to(torch.int32)[:, None]
        toks, _, _ = make_generate(cfg, 11)(
            params, cache, first,
            torch.full((2,), 40, dtype=torch.int32, device=device))
        out[device] = (logits.cpu(), torch.cat([first, toks], 1).cpu(),
                       max(float(d) for _, d in seen))
    err = float((out["cuda"][0] - out["cpu"][0]).abs().max())
    tag = f"[moe {cfg.name}]"
    log(f"{tag} float32, capacity factor 1.0, make_prefill + make_generate "
        f"(B=2, 40-token prompts, 12 tokens): dropped up to "
        f"{out['cuda'][2]:.4f} a layer on the card, {out['cpu'][2]:.4f} on "
        f"the CPU; logits max abs err {err:.3e} (tol 1e-4); tokens "
        + ("equal" if torch.equal(out["cuda"][1], out["cpu"][1])
           else "DIFFER"))
    if out["cuda"][2] <= 0 or err > 1e-4 \
            or not torch.equal(out["cuda"][1], out["cpu"][1]):
        raise AssertionError(f"{tag} capacity 1.0 prefill on the card: "
                             "no drop, or not the CPU's logits and tokens")


def phase_moe(torch, rows):
    """Phase 13, the MoE family: (a)-(b) serving, (c) training, (d) the
    reduced float32 reference runs.  Adds the path's launches to the
    kernel rows and prints the phase's seconds."""
    t0 = time.perf_counter()
    free_card(torch)
    served = phase_moe_serve(torch)
    rows[0]["moe_launches"] = served["ring"]
    rows[1]["moe_eager_prefill_launches"] = served["flash"]
    free_card(torch)
    trained = phase_moe_train(torch)
    rows[1]["moe_launches"] = trained["flash_attention_fwd"]
    rows[2]["moe_launches"] = trained["flash_attention_bwd"]
    free_card(torch)
    phase_engine_reference(torch, MOE_ARCH, [
        ("CPU", "cpu", "blocked", None),
        ("kernel", "cuda", "blocked", None),
        ("plain attention", "cuda", "dense", None)] + CARD_VARIANTS["moe"])
    phase_engine_reference(torch, "grok-1-314b", [
        ("CPU", "cpu", "blocked", None), ("card", "cuda", "blocked", None)])
    phase_moe_capacity(torch)
    log(f"[moe] phase 13: {time.perf_counter() - t0:.1f} s")


# ---------------------------------------------------------------------------
# phase 14: the VLM and encoder-decoder families
# ---------------------------------------------------------------------------

VLM_ARCH = "qwen2-vl-2b"
ENCDEC_ARCH = "seamless-m4t-large-v2"
# phase 14 (b): B=2, S=2048, of which make_batch's vision_frac 0.25 makes
# 512 positions of patch embeddings ahead of 1536 text tokens
VLM_B, VLM_S = 2, 2048
# phase 14 (d): 4 streams of 4096 source frames (the JAX package's
# encoder-decoder serving source length, ``launch/inputs.py``
# ENCDEC_SRC_LEN) and 32-token target prefixes, a 256-slot decoder ring
ENCDEC_B, ENCDEC_SRC, ENCDEC_PREFIX, ENCDEC_MAX_LEN = 4, 4096, 32, 256
GENERATE_STEPS = 32


def vision_position_ids(B, S, sv, width=32):
    """M-RoPE ids (3, B, S) whose components differ over the vision span:
    the first ``sv`` positions a grid of patches ``width`` wide (time 0,
    row, column), then the text's positions, equal in all three, from the
    grid's largest id on."""
    import numpy as np
    h, w = np.arange(sv) // width, np.arange(sv) % width
    text = np.arange(S - sv) + max(h.max(), w.max()) + 1
    ids = np.stack([np.concatenate([c, text])
                    for c in (np.zeros(sv, np.int64), h, w)])
    return np.broadcast_to(ids[:, None], (3, B, S)).astype(np.int32).copy()


def flash_counts(torch):
    from repro_torch.kernels.flash_attention import ops
    return ops.flash_attention.launches, ops.flash_attention.wgmma_launches


def spy_attention_blocks():
    """Record each ``transformer.attn_block`` call of the training path as
    "enc" (non-causal self-attention), "dec" (causal) or "cross" (over
    given keys and values); returns (the list, a function that takes the
    spy out).  One call is one flash forward and, in training, one flash
    backward."""
    from repro_torch.models import transformer
    block, seen = transformer.attn_block, []

    def spy(x, p, cfg, rope, *, causal=True, window=0, kv=None, **kw):
        seen.append("cross" if kv is not None else
                    "dec" if causal else "enc")
        return block(x, p, cfg, rope, causal=causal, window=window, kv=kv,
                     **kw)

    transformer.attn_block = spy
    return seen, lambda: setattr(transformer, "attn_block", block)


def phase_vlm_serve(torch):
    """Phase 14 (a): phase 3's requests on qwen2-vl-2b at full width and
    depth, served text-only (bf16, random weights from seed 0): cold — 28
    ring launches a chunk tick on the tensor-core route, a prefix hit,
    the pool's audit — then on a fresh engine warmed by ``warm_steps``,
    whose tokens must be the cold run's bit for bit with graphs
    replayed.  Returns the cold run's ring launches and the weights."""
    from repro_torch.configs import REGISTRY
    from repro_torch.models.params import n_params
    cfg = REGISTRY[VLM_ARCH]
    tag = f"[vlm {cfg.name}]"
    t0 = time.perf_counter()
    eng = make_engine(cfg)
    torch.cuda.synchronize()
    log(f"{tag} d_model={cfg.d_model} layers={cfg.n_layers} heads="
        f"{cfg.n_heads}/{cfg.n_kv_heads} dh={cfg.head_dim} d_ff={cfg.d_ff} "
        f"M-RoPE sections {cfg.mrope_sections} vocab={cfg.vocab} "
        f"{cfg.param_dtype}, {n_params(cfg)} params; set-up "
        f"{time.perf_counter() - t0:.1f} s, "
        f"{torch.cuda.memory_allocated() / 2**30:.1f} GiB on the card")
    cold = mode_serve(torch, eng, cfg)
    c = cold["counters"]
    ticks = int(c.get("chunk_ticks", 0))
    hits = c.get("kv_prefix_hits", 0.0)
    if (ticks <= 0 or cold["ring"] != cfg.n_layers * ticks
            or cold["ring_wgmma"] != cold["ring"] or cold["flash"]
            or hits <= 0):
        raise AssertionError(
            f"{tag} cold: ring launches {cold['ring']} ({cold['ring_wgmma']}"
            f" on the tensor-core route) over {ticks} chunk ticks of "
            f"{cfg.n_layers} layers, flash {cold['flash']}, prefix hits "
            f"{hits}")
    params = eng.params
    del eng
    free_card(torch)
    eng = make_engine(cfg, params)
    t0 = time.perf_counter()
    calls = eng.warm_steps()
    torch.cuda.synchronize()
    capture_s = time.perf_counter() - t0
    r0 = eng.graph_replays()
    warm = mode_serve(torch, eng, cfg)
    replays = {f"{k}/{w}/{b}": n - r0[(k, w, b)]
               for (k, w, b), n in sorted(eng.graph_replays().items())}
    if warm["tokens"] != cold["tokens"]:
        raise AssertionError(f"{tag} warmed tokens differ from the cold "
                             f"run's (agreement "
                             f"{agreement(warm['tokens'], cold['tokens'])})")
    if sum(replays.values()) <= 0:
        raise AssertionError(f"{tag} no graph was replayed")
    del eng
    free_card(torch)
    mode_line(tag, "cold", cold)
    mode_line(tag, "warm", warm, cold["tokens"], "cold")
    log(f"{tag} cold: ring launches {cold['ring']} ({cold['ring_wgmma']} on "
        f"the tensor-core route) over {ticks} chunk ticks, kv_prefix_hits "
        f"{int(hits)}, pool audit ok; warm: {calls} step calls, "
        f"{len(replays)} graphs captured in {capture_s:.2f} s, tokens "
        f"bit-identical to cold, replays (kind/width/bucket): "
        + ", ".join(f"{k} {n}" for k, n in replays.items()))
    log(f"{tag} " + json.dumps({
        "arch": cfg.name, "chunk_ticks": ticks, "ring_launches": cold["ring"],
        "prefix_hits": hits, "warm_calls": calls, "capture_s": capture_s,
        "replays": replays,
        **{f"{k}_{m}": v for k, r in (("cold", cold), ("warm", warm))
           for m, v in (("tokens_per_s", r["stats"]["tokens"]
                         / r["stats"]["wall"]),
                        ("wall", r["stats"]["wall"]),
                        ("ttft_p50", r["stats"]["ttft_p50"]),
                        ("ttft_p99", r["stats"]["ttft_p99"]),
                        ("tpot_p50", r["stats"]["tpot_p50"]),
                        ("tpot_p99", r["stats"]["tpot_p99"]))},
        "peak_gib": torch.cuda.max_memory_allocated() / 2**30}))
    return {"ring": cold["ring"], "params": params}


def phase_vlm_vision(torch, params):
    """Phase 14 (b), first part: qwen2-vl-2b's vision frontend through
    ``make_prefill`` on a ``make_batch`` batch (B=2, S=2048: 512 patch
    embeddings, 1536 text tokens) with M-RoPE ids that differ over the
    vision span — 28 flash launches, all on the tensor-core route, finite
    logits that the ids move — then ``make_generate`` for 32 steps.
    Returns the prefill's flash launches."""
    import numpy as np
    from repro_torch.configs import REGISTRY
    from repro_torch.data.pipeline import make_batch
    from repro_torch.launch.steps import make_generate, make_prefill
    cfg = REGISTRY[VLM_ARCH]
    tag = f"[vlm {cfg.name}]"
    block = np.random.default_rng(3).integers(
        2, cfg.vocab, size=(VLM_B, VLM_S + 1)).astype(np.int32)
    batch = make_batch(cfg, block)
    sv = batch["vision_embeds"].shape[1]
    batch["position_ids"] = vision_position_ids(VLM_B, VLM_S, sv)
    feed = {k: torch.from_numpy(batch[k]).cuda()
            for k in ("tokens", "vision_embeds", "position_ids")}
    prefill = make_prefill(cfg, VLM_S + 2 * GENERATE_STEPS)
    reset_launches(torch)
    torch.cuda.synchronize()
    t = time.perf_counter()
    logits, cache = prefill(params, feed)
    torch.cuda.synchronize()
    prefill_s = time.perf_counter() - t
    flash, flash_wgmma = flash_counts(torch)
    if (flash != cfg.n_layers or flash_wgmma != flash
            or not torch.isfinite(logits).all()):
        raise AssertionError(f"{tag} vision prefill: flash launches {flash} "
                             f"({flash_wgmma} on the tensor-core route), "
                             f"want {cfg.n_layers}; logits finite "
                             f"{bool(torch.isfinite(logits).all())}")
    # the same batch with text-only ids: M-RoPE is not RoPE over the
    # vision span, so the logits move
    plain, _ = prefill(params, dict(feed, position_ids=torch.arange(
        VLM_S, dtype=torch.int32, device="cuda").expand(3, VLM_B, VLM_S)))
    moved = float((plain - logits)[:, :cfg.vocab].abs().max())
    if moved == 0.0:
        raise AssertionError(f"{tag} the vision span's M-RoPE ids did not "
                             "move the logits")
    del plain
    first = logits.argmax(-1).to(torch.int32)[:, None]
    pos = torch.full((VLM_B,), VLM_S, dtype=torch.int32, device="cuda")
    torch.cuda.synchronize()
    t = time.perf_counter()
    toks, cache, _ = make_generate(cfg, GENERATE_STEPS)(params, cache,
                                                        first, pos)
    torch.cuda.synchronize()
    gen_s = time.perf_counter() - t
    if not ((toks >= 0) & (toks < cfg.vocab)).all():
        raise AssertionError(f"{tag} a generated token is out of vocab")
    log(f"{tag} vision prefill B={VLM_B} S={VLM_S} ({sv} patch embeddings, "
        f"{VLM_S - sv} text tokens, M-RoPE t/h/w ids distinct over the "
        f"vision span; the decode steps broadcast their positions, "
        f"{VLM_S} on, to the three components): flash launches {flash} "
        f"({flash_wgmma} on the "
        f"tensor-core route), logits finite, text-only ids move them by "
        f"{moved:.4f}; prefill {prefill_s:.4f} s, {GENERATE_STEPS} "
        f"make_generate steps {gen_s:.4f} s "
        f"({VLM_B * GENERATE_STEPS / gen_s:.1f} tokens/s)")
    del cache, logits
    free_card(torch)
    return flash


def phase_encdec_train(torch):
    """Phase 14 (c): seamless-m4t-large-v2 at full width and depth, 4
    steps at B=2, S=2048 (``make_batch``: 1024 source frames, 1024 target
    tokens): per step 24 non-causal encoder, 24 causal decoder and 24
    cross-attention blocks, each one flash forward and one flash
    backward.  Returns the launches."""
    from repro_torch.configs import REGISTRY
    from repro_torch.kernels.flash_attention import ops as fa_ops
    cfg = REGISTRY[ENCDEC_ARCH]
    per = cfg.enc_layers + 2 * cfg.dec_layers
    seen, restore = spy_attention_blocks()
    try:
        launches = phase_train(
            torch, ENCDEC_ARCH, 2, "none",
            {"flash_attention_fwd": (fa_ops.flash_attention, per),
             "flash_attention_bwd": (fa_ops.flash_attention_bwd, per)},
            {"enc wq[0]": lambda p: p["enc_layers"]["attn"]["wq"][0],
             "dec cross wk[0]": lambda p: p["dec_layers"]["cross"]["wk"][0],
             "head[:, :4096]": lambda p: p["head"][:, :4096]})
    finally:
        restore()
    step = (["enc"] * cfg.enc_layers + ["dec", "cross"] * cfg.dec_layers)
    if seen != step * TRAIN_STEPS:
        counts = [seen.count(k) for k in ("enc", "dec", "cross")]
        raise AssertionError(f"[train {cfg.name}] attention blocks {counts} "
                             "(enc, dec, cross), or out of order")
    log(f"[train {cfg.name}] a step: {cfg.enc_layers} non-causal encoder, "
        f"{cfg.dec_layers} causal decoder and {cfg.dec_layers} cross-"
        f"attention blocks, each one flash forward and one backward")
    return launches


def phase_encdec_serve(torch):
    """Phase 14 (d): seamless-m4t-large-v2 at full width and depth served
    at model level, the path the JAX package has: ``make_prefill`` of 4
    streams of 4096 source frames and 32-token prefixes (72 flash
    launches: 24 encoder at S=4096, 24 decoder at S=32, 24 cross at
    Sq=32, Skv=4096), then ``make_generate`` for 32 steps.  Its chunked
    twin: ``prefill_chunk_step`` (blocked) over the prefix in 16-token
    chunks from a cache holding the same cross keys and values (24 ring
    launches at G=1, dh 64, and 24 cross flash launches at Sq=16 a
    chunk), then 32 ``decode_step``s; the tokens' agreement with the
    first run is printed, not gated.  Last, one scan verify step with 4
    drafted tokens: its argmax at each position equals 4 sequential
    ``decode_step``s'.  That gate checks only the scan identity (the scan
    verify is a loop of the same ``decode_step``, so it can catch a fault
    in the cache save and restore, nothing more); the fused verify
    (``mode="parallel"``, blocked: 24 ring launches at C=4 and 24 cross
    flash launches at Sq=4, Skv=4096) runs after it, its launches gated
    and its argmax agreement with the decode steps printed, not gated
    (bf16).  Returns the launches."""
    import numpy as np
    from repro_torch.configs import REGISTRY
    from repro_torch.kernels.flash_attention import ops
    from repro_torch.launch.steps import (make_generate, make_prefill,
                                          make_serve_step,
                                          make_spec_verify_step)
    from repro_torch.models import decode as dec
    from repro_torch.models.params import init_params, n_params
    cfg = REGISTRY[ENCDEC_ARCH]
    tag = f"[encdec {cfg.name}]"
    B, P, S_src, W = ENCDEC_B, ENCDEC_PREFIX, ENCDEC_SRC, ENCDEC_MAX_LEN
    t0 = time.perf_counter()
    params = init_params(cfg, torch.Generator(device="cuda").manual_seed(0))
    torch.cuda.synchronize()
    log(f"{tag} d_model={cfg.d_model} {cfg.enc_layers} encoder + "
        f"{cfg.dec_layers} decoder layers heads={cfg.n_heads}/"
        f"{cfg.n_kv_heads} dh={cfg.head_dim} d_ff={cfg.d_ff} vocab="
        f"{cfg.vocab} {cfg.param_dtype}, {n_params(cfg)} params; set-up "
        f"{time.perf_counter() - t0:.1f} s")
    rng = np.random.default_rng(4)
    frames = torch.from_numpy((rng.standard_normal((B, S_src, cfg.d_model))
                               * 0.02).astype(np.float32)).cuda()
    prefix = torch.from_numpy(rng.integers(2, cfg.vocab, size=(B, P))
                              .astype(np.int32)).cuda()
    pos = torch.full((B,), P, dtype=torch.int32, device="cuda")
    generate = make_generate(cfg, GENERATE_STEPS)
    torch.cuda.reset_peak_memory_stats()
    reset_launches(torch)
    torch.cuda.synchronize()
    t = time.perf_counter()
    logits, cache = make_prefill(cfg, W)(params, {"tokens": prefix,
                                                  "frame_embeds": frames})
    torch.cuda.synchronize()
    prefill_s = time.perf_counter() - t
    flash, flash_wgmma = flash_counts(torch)
    want = cfg.enc_layers + 2 * cfg.dec_layers
    if (flash != want or flash_wgmma != flash
            or not torch.isfinite(logits).all()):
        raise AssertionError(f"{tag} prefill: flash launches {flash} "
                             f"({flash_wgmma} on the tensor-core route), "
                             f"want {want}; logits finite "
                             f"{bool(torch.isfinite(logits).all())}")
    cross = (cache["cross_k"].clone(), cache["cross_v"].clone())
    first = logits.argmax(-1).to(torch.int32)[:, None]
    torch.cuda.synchronize()
    t = time.perf_counter()
    toks, _, _ = generate(params, cache, first, pos)
    torch.cuda.synchronize()
    gen_s = time.perf_counter() - t
    run1 = torch.cat([first, toks], 1).cpu()
    del cache
    # the chunked twin, from a cache holding the encoder's cross K/V
    spec = dec.cache_view_specs(cfg, W, S_src)
    twin = dec.init_cache(cfg, B, W, S_src)
    twin["cross_k"].copy_(cross[0])
    twin["cross_v"].copy_(cross[1])
    del cross
    C = 16
    n = torch.full((B,), C, dtype=torch.int32, device="cuda")
    reset_launches(torch)
    torch.cuda.synchronize()
    t = time.perf_counter()
    for c0 in range(0, P, C):
        logits2, twin = dec.prefill_chunk_step(
            params, cfg, spec, twin, prefix[:, c0:c0 + C],
            torch.full((B,), c0, dtype=torch.int32, device="cuda"), n,
            chunk_kernel="blocked")
    torch.cuda.synchronize()
    chunk_s = time.perf_counter() - t
    ring, ring_wgmma, _ = kernel_launches(torch)
    cflash, cflash_wgmma = flash_counts(torch)
    ticks = P // C
    if (ring != cfg.dec_layers * ticks or ring_wgmma != ring
            or cflash != cfg.dec_layers * ticks or cflash_wgmma != cflash
            or not torch.isfinite(logits2).all()):
        raise AssertionError(f"{tag} chunked prefix: ring {ring} "
                             f"({ring_wgmma} tensor-core), cross flash "
                             f"{cflash} ({cflash_wgmma}), want "
                             f"{cfg.dec_layers * ticks} each")
    first2 = logits2.argmax(-1).to(torch.int32)[:, None]
    # the verify step's input: the state after the prefix, and 4 drafted
    # tokens (the first and the twin's greedy continuation's first three)
    after = _to_device(twin, "cuda")
    toks2, _, _ = generate(params, twin, first2, pos)
    run2 = torch.cat([first2, toks2], 1).cpu()
    del twin
    draft = torch.cat([first2, toks2[:, :3]], 1)
    serve_step = make_serve_step(cfg)
    seq, state = [], _to_device(after, "cuda")
    for i in range(4):
        lg, state = serve_step(params, state, draft[:, i:i + 1], pos + i)
        seq.append(lg.argmax(-1))
    del state
    seq = torch.stack(seq, 1)
    four = torch.full((B,), 4, dtype=torch.int32, device="cuda")
    verify, _ = make_spec_verify_step(cfg, spec)(
        params, _to_device(after, "cuda"), draft, pos, four)
    if not torch.equal(verify.argmax(-1), seq):
        raise AssertionError(f"{tag} the verify step's argmax differs from "
                             "4 sequential decode steps")
    reset_launches(torch)
    fused, _ = make_spec_verify_step(cfg, spec, mode="parallel",
                                     chunk_kernel="blocked")(
        params, after, draft, pos, four)
    torch.cuda.synchronize()
    vring, vring_wgmma, _ = kernel_launches(torch)
    vflash, vflash_wgmma = flash_counts(torch)
    if (vring != cfg.dec_layers or vring_wgmma != vring
            or vflash != cfg.dec_layers or vflash_wgmma != vflash
            or not torch.isfinite(fused).all()):
        raise AssertionError(f"{tag} fused verify: ring {vring} "
                             f"({vring_wgmma} tensor-core), cross flash "
                             f"{vflash} ({vflash_wgmma}), want "
                             f"{cfg.dec_layers} each; logits finite "
                             f"{bool(torch.isfinite(fused).all())}")
    fused_agree = float((fused.argmax(-1) == seq).float().mean())
    peak = torch.cuda.max_memory_allocated() / 2**30
    agree = float((run1 == run2).float().mean())
    log(f"{tag} prefill of {B} streams x {S_src} frames + {P}-token "
        f"prefixes: {prefill_s:.4f} s, flash launches {flash} (all on the "
        f"tensor-core route: {cfg.enc_layers} encoder, {cfg.dec_layers} "
        f"decoder, {cfg.dec_layers} cross at Sq={P}, Skv={S_src}); "
        f"{GENERATE_STEPS} make_generate steps {gen_s:.4f} s "
        f"({B * GENERATE_STEPS / gen_s:.1f} tokens/s, "
        f"{gen_s / GENERATE_STEPS * 1e3:.3f} ms a step)")
    log(f"{tag} chunked twin: {ticks} prefill_chunk_step calls (C={C}, "
        f"blocked) {chunk_s:.4f} s, ring launches {ring} and cross flash "
        f"launches {cflash}, all on the tensor-core route; tokens agree "
        f"with the whole-prompt run on {agree:.4f} of {run1.numel()} "
        f"(bf16: not gated); the scan verify of 4 drafted tokens gives 4 "
        f"sequential decode steps' argmax at every position; the fused "
        f"verify (ring {vring}, cross flash {vflash} launches, all on the "
        f"tensor-core route) agrees with them on {fused_agree:.4f} of "
        f"{seq.numel()} positions (bf16: not gated); peak {peak:.2f} GiB")
    log(f"{tag} " + json.dumps({
        "arch": cfg.name, "streams": B, "src_len": S_src, "prefix": P,
        "prefill_s": prefill_s, "generate_s": gen_s,
        "generate_tokens_per_s": B * GENERATE_STEPS / gen_s,
        "chunk_prefix_s": chunk_s, "prefill_flash_launches": flash,
        "chunk_ring_launches": ring, "chunk_flash_launches": cflash,
        "chunked_agreement": agree, "fused_verify_agreement": fused_agree,
        "peak_gib": peak}))
    del params, after, verify, fused
    free_card(torch)
    return {"prefill_flash": flash, "ring": ring, "chunk_flash": cflash}


def phase_encdec_reference(torch):
    """Phase 14 (e), the encoder-decoder part: reduced
    seamless-m4t-large-v2 in float32 on the CPU and the card, the same
    weights: ``make_prefill`` from source frames then ``make_generate``,
    and the chunked twin (``prefill_chunk_step``, blocked, 4 tokens a
    chunk, then ``make_generate``); the card's prefill logits within 1e-4
    of the CPU's and every token equal."""
    import numpy as np
    from repro_torch.configs import REGISTRY, reduced_config
    from repro_torch.launch.steps import make_generate, make_prefill
    from repro_torch.models import decode as dec
    from repro_torch.models.params import init_params
    cfg = reduced_config(REGISTRY[ENCDEC_ARCH])
    base = init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    B, P, S_src, W, C = 2, 12, 24, 32, 4
    rng = np.random.default_rng(6)
    frames = torch.from_numpy((rng.standard_normal((B, S_src, cfg.d_model))
                               * 0.02).astype(np.float32))
    prefix = torch.from_numpy(rng.integers(2, cfg.vocab, size=(B, P))
                              .astype(np.int32))
    out = {}
    for device in ("cpu", "cuda"):
        params = _to_device(base, device)
        fr, pre = frames.to(device), prefix.to(device)
        pos = torch.full((B,), P, dtype=torch.int32, device=device)
        logits, cache = make_prefill(cfg, W)(params, {"tokens": pre,
                                                      "frame_embeds": fr})
        first = logits.argmax(-1).to(torch.int32)[:, None]
        twin = dec.init_cache(cfg, B, W, S_src, device=device)
        twin["cross_k"].copy_(cache["cross_k"])
        twin["cross_v"].copy_(cache["cross_v"])
        toks, _, _ = make_generate(cfg, 11)(params, cache, first, pos)
        spec = dec.cache_view_specs(cfg, W, S_src)
        n = torch.full((B,), C, dtype=torch.int32, device=device)
        for c0 in range(0, P, C):
            lg2, twin = dec.prefill_chunk_step(
                params, cfg, spec, twin, pre[:, c0:c0 + C],
                torch.full((B,), c0, dtype=torch.int32, device=device), n,
                chunk_kernel="blocked")
        first2 = lg2.argmax(-1).to(torch.int32)[:, None]
        toks2, _, _ = make_generate(cfg, 11)(params, twin, first2, pos)
        out[device] = (logits.cpu(), torch.cat([first, toks], 1).cpu(),
                       torch.cat([first2, toks2], 1).cpu())
    err = float((out["cuda"][0] - out["cpu"][0]).abs().max())
    equal = all(torch.equal(out["cuda"][i], out["cpu"][i]) for i in (1, 2))
    log(f"[encdec {cfg.name}] float32, make_prefill + make_generate and the "
        f"chunked twin (B={B}, {S_src} frames, {P}-token prefixes, 12 "
        f"tokens): card logits max abs err {err:.3e} against the CPU (tol "
        f"1e-4); tokens " + ("equal" if equal else "DIFFER"))
    if err > 1e-4 or not equal:
        raise AssertionError(f"reduced {cfg.name} float32: the card is not "
                             "the CPU")


def phase_vlm_encdec(torch, rows):
    """Phase 14, the VLM and encoder-decoder families at full width and
    depth: (a) qwen2-vl-2b served, (b) its vision frontend prefilled and
    generated from, and trained, (c) seamless-m4t-large-v2 trained, (d)
    served at model level, (e) the reduced float32 configs on the card
    against the CPU.  Adds the paths' launches to the kernel rows and
    prints the phase's seconds."""
    from repro_torch.configs import REGISTRY
    from repro_torch.kernels.flash_attention import ops as fa_ops
    t0 = time.perf_counter()
    free_card(torch)
    served = phase_vlm_serve(torch)
    rows[0]["vlm_launches"] = served["ring"]
    rows[1]["vlm_prefill_launches"] = phase_vlm_vision(torch,
                                                       served["params"])
    del served
    free_card(torch)
    n_vlm = REGISTRY[VLM_ARCH].n_layers
    trained = phase_train(
        torch, VLM_ARCH, VLM_B, "none",
        {"flash_attention_fwd": (fa_ops.flash_attention, n_vlm),
         "flash_attention_bwd": (fa_ops.flash_attention_bwd, n_vlm)},
        {"wq[0]": lambda p: p["layers"]["attn"]["wq"][0],
         "embed[:4096]": lambda p: p["embed"][:4096]}, S=VLM_S)
    rows[1]["vlm_launches"] = trained["flash_attention_fwd"]
    rows[2]["vlm_launches"] = trained["flash_attention_bwd"]
    trained = phase_encdec_train(torch)
    rows[1]["encdec_launches"] = trained["flash_attention_fwd"]
    rows[2]["encdec_launches"] = trained["flash_attention_bwd"]
    free_card(torch)
    enc = phase_encdec_serve(torch)
    rows[0]["encdec_launches"] = enc["ring"]
    rows[1]["encdec_prefill_launches"] = enc["prefill_flash"]
    rows[1]["encdec_chunk_launches"] = enc["chunk_flash"]
    free_card(torch)
    phase_engine_reference(torch, VLM_ARCH, [
        ("CPU", "cpu", "blocked", None),
        ("kernel", "cuda", "blocked", None),
        ("plain attention", "cuda", "dense", None)] + CARD_VARIANTS["vlm"])
    phase_trainer(torch, VLM_ARCH, fa_ops.flash_attention)
    phase_trainer(torch, ENCDEC_ARCH, fa_ops.flash_attention)
    phase_encdec_reference(torch)
    log(f"[vlm/encdec] phase 14: {time.perf_counter() - t0:.1f} s")


# ---------------------------------------------------------------------------
# phase 15: the rest of the training path — the 8-bit AdamW, error-feedback
# compression, meshes and the data-parallel step
# ---------------------------------------------------------------------------

# recurrentgemma-9b at full width and all 38 layers: 9,396,195,328
# parameters hold 6 bytes each of state with the 8-bit AdamW (bf16 weights
# and gradients, int8 m, uint8 sqrt(v)): 52.5 GiB, where float32 moments
# would need 105 GiB.  remat "full" keeps one group's activations at a
# time; if S = 4096 does not fit, the phase runs S = 2048 and prints both
# attempts' peaks
HYBRID_FULL_REMAT = "full"
HYBRID_FULL_S = (4096, 2048)


def hybrid_kernels(layers, remat):
    """The RG-LRU scan and flash wrappers with their launches a step on
    recurrentgemma-9b's first ``layers`` layers: a rec layer launches the
    scan forward and its fused VJP, an attn layer each flash kernel once;
    under remat a group's forward runs twice (the tail, not recomputed,
    once)."""
    from repro_torch.configs import REGISTRY
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.rglru_scan import ops as lru_ops
    cfg = REGISTRY[HYBRID_ARCH]
    types = cfg.layer_types()[:layers]
    period = len(cfg.block_pattern)
    grouped = types[:layers // period * period]
    again = 0 if remat == "none" else 1
    n_rec, n_attn = types.count("rec"), types.count("attn")
    return {"lru_scan": (lru_ops.lru_scan,
                         2 * n_rec + again * grouped.count("rec")),
            "flash_attention_fwd": (fa_ops.flash_attention,
                                    n_attn + again * grouped.count("attn")),
            "flash_attention_bwd": (fa_ops.flash_attention_bwd, n_attn)}


HYBRID_PROBES = {
    "w_a[0]": lambda p: p["groups"]["b0_rec"]["rec"]["w_a"][0],
    "w_in[0]": lambda p: p["groups"]["b0_rec"]["rec"]["w_in"][0],
    "wq[0]": lambda p: p["groups"]["b2_attn"]["attn"]["wq"][0],
    "tail w_out": lambda p: p["tail"]["t1_rec"]["rec"]["w_out"],
    "embed[:4096]": lambda p: p["embed"][:4096]}


def phase_hybrid_8bit(torch, rows):
    """Phase 15 (a) and (b): recurrentgemma-9b with the 8-bit AdamW, at
    all 38 layers (remat "full", S = 4096, else 2048) and at phase 7's
    14 layers and shape."""
    from repro_torch.configs import REGISTRY
    n = REGISTRY[HYBRID_ARCH].n_layers
    full, peaks = {}, {}
    for S in HYBRID_FULL_S:
        free_card(torch)
        failed = None
        try:
            launches = phase_train(
                torch, HYBRID_ARCH, HYBRID_B, HYBRID_FULL_REMAT,
                hybrid_kernels(n, HYBRID_FULL_REMAT), HYBRID_PROBES, S=S,
                opt_impl="adamw8bit", stats=full, time_update=True)
        except torch.cuda.OutOfMemoryError as e:
            failed = str(e).splitlines()[0][:160]
        peaks[S] = torch.cuda.max_memory_allocated() / 2**30
        if failed is None:
            break
        log(f"[8bit] recurrentgemma-9b, 38 layers, S={S}: out of memory "
            f"at a peak of {peaks[S]:.3f} GiB ({failed})")
    else:
        raise AssertionError("recurrentgemma-9b at 38 layers fits at no "
                             f"sequence of {HYBRID_FULL_S}")
    rows[4]["hybrid38_launches"] = launches["lru_scan"]
    rows[1]["hybrid38_launches"] = launches["flash_attention_fwd"]
    rows[2]["hybrid38_launches"] = launches["flash_attention_bwd"]
    log(f"[8bit] recurrentgemma-9b at all {n} layers, 8-bit AdamW, remat "
        f"{HYBRID_FULL_REMAT}: S={full['seq']}, "
        f"{full['steady_step_s']:.6f} s a step, "
        f"{full['tokens_per_s']:.1f} tokens/s, peak {full['peak_gib']:.3f} "
        f"GiB of the card's "
        f"{torch.cuda.get_device_properties(0).total_memory / 2**30:.2f}; "
        f"the 8-bit update {full['steady_update_s']:.6f} s a step (the "
        f"step's seconds include the spy's synchronisations around it); "
        f"peaks by S: {json.dumps({str(k): v for k, v in peaks.items()})}")
    free_card(torch)
    short = {}
    phase_train(torch, HYBRID_ARCH, HYBRID_B, HYBRID_REMAT,
                hybrid_kernels(HYBRID_LAYERS, HYBRID_REMAT), HYBRID_PROBES,
                S=HYBRID_S, layers=HYBRID_LAYERS, opt_impl="adamw8bit",
                stats=short)
    log(f"[8bit] phase 7's {HYBRID_LAYERS} layers with the 8-bit AdamW: "
        f"peak {short['peak_gib']:.3f} GiB (phase 7, float32 moments: "
        f"{PHASE7.get('peak_gib', float('nan')):.3f}), "
        f"{short['steady_step_s']:.6f} s a step (phase 7: "
        f"{PHASE7.get('steady_step_s', float('nan')):.6f})")


# phase 7's record (its steady seconds and peak), kept for phase 15 (b)
PHASE7 = {}


def phase_ef(torch, rows):
    """Phase 15 (c): error-feedback compression — mamba2-780m at phase 5's
    shape with ``ef_transform``, then the reduced float32
    ``Trainer(compress_cross_pod=True)`` on the card against the CPU."""
    import os
    import shutil
    import tempfile
    from repro_torch.configs import REGISTRY, reduced_config
    from repro_torch.data.pipeline import (ShardedLoader, SyntheticCorpus,
                                           write_corpus_shards)
    from repro_torch.kernels.ssd_scan import ops as ssd_ops
    from repro_torch.models.params import init_params
    from repro_torch.optim.adamw import AdamWConfig
    from repro_torch.runtime.trainer import Trainer, TrainerConfig

    free_card(torch)
    stats = {}
    launches = phase_train(
        torch, SSM_ARCH, SSM_B, SSM_REMAT,
        {"ssd_scan": (ssd_ops.ssd_scan, REGISTRY[SSM_ARCH].n_layers)},
        {"wx[0]": lambda p: p["layers"]["ssd"]["wx"][0],
         "embed[:4096]": lambda p: p["embed"][:4096]}, ef=True, stats=stats)
    rows[3]["ef_launches"] = launches["ssd_scan"]
    log(f"[ef] mamba2-780m with int8 error feedback: "
        f"{stats['steady_step_s']:.6f} s a step (phase 5: "
        f"{PHASE5.get('steady_step_s', float('nan')):.6f}), peak "
        f"{stats['peak_gib']:.3f} GiB")

    cfg = reduced_config(REGISTRY[SSM_ARCH])
    base = init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    tmp = tempfile.mkdtemp(prefix="chip_smoke_ef_")
    try:
        files = write_corpus_shards(os.path.join(tmp, "data"),
                                    SyntheticCorpus(cfg.vocab, seed=1),
                                    n_shards=2, tokens_per_shard=2000)

        def run(device):
            tcfg = TrainerConfig(steps=6, ckpt_every=100, log_every=100,
                                 ckpt_dir=os.path.join(tmp, device),
                                 compress_cross_pod=True,
                                 opt=AdamWConfig(peak_lr=1e-3,
                                                 warmup_steps=2,
                                                 total_steps=20))
            t = Trainer(cfg, ShardedLoader(files, seq_len=64, batch=2),
                        tcfg, log=lambda s: None,
                        params=_to_device(base, device), device=device)
            return t.run()["losses"], t

        f0 = ssd_ops.ssd_scan.launches
        card, trainer = run("cuda")
        if ssd_ops.ssd_scan.launches == f0:
            raise AssertionError("the compressed Trainer on the card "
                                 "launched no SSD kernel")
        if not all(bool(e.any()) for e in _tree_leaves(trainer._ef)):
            raise AssertionError("an error-feedback buffer stayed zero")
        cpu, _ = run("cpu")
    finally:
        shutil.rmtree(tmp)
    err = max(abs(a - b) for a, b in zip(card, cpu))
    log(f"[ef] reduced {cfg.name} Trainer(compress_cross_pod=True), float32: "
        f"card {[round(x, 6) for x in card]}, CPU max abs err {err:.3e} "
        "(tol 1e-4)")
    if err > 1e-4:
        raise AssertionError("the compressed Trainer's card losses differ "
                             "from the CPU's")


# phase 5's record, kept for phase 15 (c)
PHASE5 = {}


def phase_dist(torch, rows, card):
    """Phase 15 (d): ``torch.distributed`` on the card — an NCCL process
    group of one rank (a ``FileStore``) and a (1, 1) mesh.
    ``make_train_step_smap`` and ``make_train_step_spmd`` on reduced
    float32 llama3-8b against ``make_train_step`` (parameters after 3
    steps within 1e-5) with both optimizers, the Trainer on the mesh (the
    spmd step) against the one-card Trainer, and the 8-bit state through
    the checkpoint manager (sharded save and restore); then (e) the spmd
    step on phase 4's cell against ``make_train_step``
    (``phase_spmd_cell``) and (f) the spmd serving steps against
    ``make_prefill`` / ``make_serve_step`` (``phase_spmd_serve``)."""
    import os
    import shutil
    import tempfile
    import numpy as np
    import torch.distributed as dist
    from repro_torch.checkpoint.manager import CheckpointManager
    from repro_torch.configs import REGISTRY, reduced_config
    from repro_torch.data.pipeline import (ShardedLoader, SyntheticCorpus,
                                           write_corpus_shards)
    from repro_torch.launch import sharding as sh
    from repro_torch.launch.mesh import Mesh
    from repro_torch.launch.steps import (make_train_step,
                                          make_train_step_smap,
                                          make_train_step_spmd)
    from repro_torch.models.params import init_params
    from repro_torch.optim.adamw import AdamWConfig, init_opt_state
    from repro_torch.optim.quantized import init_opt_state_8bit
    from repro_torch.runtime.trainer import Trainer, TrainerConfig

    tmp = tempfile.mkdtemp(prefix="chip_smoke_dist_")
    torch.cuda.set_device(0)
    dist.init_process_group("nccl", store=dist.FileStore(
        os.path.join(tmp, "store"), 1), rank=0, world_size=1)
    try:
        cfg = reduced_config(REGISTRY[DIST_ARCH])
        base = init_params(cfg, torch.Generator().manual_seed(0),
                           device="cpu")
        mesh = Mesh(np.array([[0]]), ("data", "model"))
        pspecs = sh.param_specs(cfg, mesh)
        opt_cfg = AdamWConfig(peak_lr=1e-3, warmup_steps=2, total_steps=20)
        g = torch.Generator().manual_seed(1)
        batches = []
        for _ in range(3):
            blk = torch.randint(2, cfg.vocab, (4, 65), generator=g,
                                dtype=torch.int32)
            batches.append({"tokens": blk[:, :-1].cuda(),
                            "targets": blk[:, 1:].cuda(),
                            "mask": torch.ones(4, 64).cuda()})
        bspecs = sh.batch_specs(cfg, None, mesh)
        for impl in ("adamw", "adamw8bit"):
            init = init_opt_state_8bit if impl == "adamw8bit" \
                else init_opt_state
            one = _to_device(base, "cuda")
            steps = {"make_train_step": make_train_step(cfg, opt_cfg,
                                                        opt_impl=impl),
                     "make_train_step_smap": make_train_step_smap(
                         cfg, opt_cfg, mesh, pspecs, bspecs, opt_impl=impl),
                     "make_train_step_spmd": make_train_step_spmd(
                         cfg, opt_cfg, mesh, pspecs, bspecs, opt_impl=impl)}
            state = {name: (p, init(p)) for name, p in
                     [("make_train_step", one)] + [
                         (name, _to_device(base, "cuda"))
                         for name in list(steps)[1:]]}
            secs = {name: [] for name in steps}
            for b in batches:
                for name, fn in steps.items():
                    torch.cuda.synchronize()
                    t = time.perf_counter()
                    fn(*state[name], b)
                    torch.cuda.synchronize()
                    secs[name].append(time.perf_counter() - t)
            for name in list(steps)[1:]:
                ranked = state[name][0]
                err = max(float((a - b).abs().max()) for a, b in zip(
                    _tree_leaves(one), _tree_leaves(ranked)))
                log(f"[dist] {dist.get_backend()} world 1, mesh "
                    f"{mesh.shape}: {name} against make_train_step, {impl}, "
                    f"reduced {cfg.name} float32, 3 steps: params max abs "
                    f"err {err:.3e} (tol 1e-5)")
                if err > 1e-5:
                    raise AssertionError(f"{name} ({impl}) differs")
            log(f"[dist] seconds a step, {impl}: " + json.dumps(secs))
        ranked = state["make_train_step_smap"][0]
        s2 = state["make_train_step_smap"][1]
        # the 8-bit state of the smap run through the checkpoint manager
        state = {"params": ranked, "opt": s2}
        shd = {"params": sh.named(mesh, pspecs),
               "opt": sh.named(mesh, sh.opt_specs_8bit(cfg, mesh, pspecs))}
        ckpt = CheckpointManager(os.path.join(tmp, "ckpt8"))
        ckpt.save(3, state, shardings=shd)
        like = _tree_apply(torch.zeros_like, state)
        back, meta = ckpt.restore(like, shardings=shd)
        same = all(torch.equal(a, b) for a, b in zip(
            _tree_leaves(back), _tree_leaves(state)))
        kinds = {t.dtype for t in _tree_leaves(back["opt"])}
        log(f"[dist] 8-bit state through the checkpoint manager (sharded "
            f"save and restore): step {meta['step']}, equal {same}, moment "
            f"types {sorted(str(k) for k in kinds)}")
        if not same or not {torch.int8, torch.uint8} <= kinds:
            raise AssertionError("the 8-bit state did not round-trip")
        files = write_corpus_shards(os.path.join(tmp, "data"),
                                    SyntheticCorpus(cfg.vocab, seed=1),
                                    n_shards=2, tokens_per_shard=2000)
        runs = {}
        for name, kw in (("one card", {}), ("mesh", {"mesh": mesh})):
            tcfg = TrainerConfig(steps=3, ckpt_every=100, log_every=100,
                                 ckpt_dir=os.path.join(tmp, name),
                                 opt=opt_cfg)
            t = Trainer(cfg, ShardedLoader(files, seq_len=64, batch=2),
                        tcfg, log=lambda s: None,
                        params=_to_device(base, "cuda"), device="cuda", **kw)
            runs[name] = (t.run()["losses"], t.params)
        lerr = max(abs(a - b) for a, b in zip(runs["one card"][0],
                                              runs["mesh"][0]))
        perr = max(float((a - b).abs().max()) for a, b in zip(
            _tree_leaves(runs["one card"][1]), _tree_leaves(runs["mesh"][1])))
        log(f"[dist] Trainer(mesh={mesh.shape}) against the one-card "
            f"Trainer, 3 steps: losses max abs err {lerr:.3e}, params "
            f"{perr:.3e} (tol 1e-5)")
        if max(lerr, perr) > 1e-5:
            raise AssertionError("the Trainer on a mesh differs")
        del state, ranked, s2, runs, back, like
        free_card(torch)
        phase_spmd_cell(torch, rows, mesh)
        free_card(torch)
        phase_spmd_serve(torch, rows, mesh, card)
    finally:
        dist.destroy_process_group()
        shutil.rmtree(tmp)


# phase 15 (e): the spmd step against make_train_step on phase 4's cell,
# each from the same weights in turn (two copies of the state do not fit
# the card beside remat "none"'s activations); bf16 — the two are the same
# operations on one rank (the vocabulary-parallel log-sum-exp is
# torch.logsumexp's, a collective over one rank a copy; the split blocks'
# gradients add up in the unsplit order), so they differ
# only where the card's kernels are not deterministic: losses within 1e-4
# and grad norms within 1e-3 (relative), every parameter within 2.5
# learning rates (an entry that took another update in one step) and at
# most one entry in 10^3 off at all
SPMD_STEPS = 2
SPMD_LOSS_RTOL, SPMD_NORM_RTOL = 1e-4, 1e-3
SPMD_PARAM_LRS, SPMD_PARAM_OFF = 2.5, 1e-3
# then the families whose layers the spmd step splits beside attention, at
# full width and the train_4k cell's microbatch (B=2, S=4096; the hybrid
# B=1, as phase 7), the depth cut (the hybrid to one (rec, rec, attn)
# group and one tail rec layer): name, arch, config overrides, B, target
# tokens, source frames (the encoder-decoder's, longer than its target as
# in speech translation, so that cross-attention has Sq != Skv)
SPMD_FAMILY_CELLS = [
    ("ssm", "mamba2-780m", {"n_layers": 12}, 2, 4096, 0),
    ("hybrid", "recurrentgemma-9b", {"n_layers": 4}, 1, 4096, 0),
    ("encdec", "seamless-m4t-large-v2", {"enc_layers": 4, "dec_layers": 4},
     2, 1024, 2048),
]


def spmd_kernel_counts(torch, cfg):
    """The kernel wrappers the spmd step of ``cfg`` must launch and how
    often a step (remat "none"): the SSD scan once a layer (its backward
    recomputes through ``ssd_chunked``), the LRU scan twice a rec layer
    (the forward and the fused VJP), each flash kernel once an attention
    block (self-, encoder and cross-attention)."""
    from repro_torch.kernels.flash_attention import ops as fa
    from repro_torch.kernels.rglru_scan import ops as lru
    from repro_torch.kernels.ssd_scan import ops as ssd
    types = cfg.layer_types() if cfg.family != "encdec" else []
    blocks = types.count("attn") + cfg.enc_layers + 2 * cfg.dec_layers
    want = {"ssd_scan": (ssd.ssd_scan, types.count("ssd")),
            "lru_scan": (lru.lru_scan, 2 * types.count("rec")),
            "flash_attention_fwd": (fa.flash_attention, blocks),
            "flash_attention_bwd": (fa.flash_attention_bwd, blocks)}
    return {k: v for k, v in want.items() if v[1]}


def spmd_pair(torch, mesh, cfg, batches):
    """``make_train_step`` and then ``make_train_step_spmd`` on ``mesh``
    for the ``batches`` from the same seeded weights (bf16, AdamW with one
    warm-up step): name -> (the (loss, grad norm) of each step, the
    parameters on the host, seconds a step, launches of each kernel of
    ``spmd_kernel_counts``, peak GiB).  The counts are set to 0 just
    before each run's steps and read just after."""
    from repro_torch.launch import sharding as sh
    from repro_torch.launch.steps import make_train_step, make_train_step_spmd
    from repro_torch.models.params import init_params
    from repro_torch.optim.adamw import AdamWConfig, init_opt_state

    opt_cfg = AdamWConfig(warmup_steps=1)
    gen = torch.Generator(device="cuda").manual_seed(0)
    host = _tree_apply(lambda t: t.cpu(),
                       init_params(cfg, gen, device="cuda"))
    free_card(torch)
    pspecs = sh.param_specs(cfg, mesh)
    kernels = spmd_kernel_counts(torch, cfg)
    runs = {}
    for name in ("make_train_step", "make_train_step_spmd"):
        params = _to_device(host, "cuda")
        opt = init_opt_state(params)
        step = make_train_step(cfg, opt_cfg) if name == "make_train_step" \
            else make_train_step_spmd(cfg, opt_cfg, mesh, pspecs,
                                      sh.batch_specs(cfg, None, mesh))
        torch.cuda.reset_peak_memory_stats()
        for fn, _ in kernels.values():
            fn.launches = 0
            if hasattr(fn, "wgmma_launches"):
                fn.wgmma_launches = 0
        out, secs = [], []
        for b in batches:
            torch.cuda.synchronize()
            t = time.perf_counter()
            params, opt, m = step(params, opt, b)
            out.append((float(m["loss"]), float(m["grad_norm"])))
            torch.cuda.synchronize()
            secs.append(time.perf_counter() - t)
        launches = {k: fn.launches for k, (fn, _) in kernels.items()}
        runs[name] = (out, _tree_apply(lambda t: t.cpu(), params), secs,
                      launches, torch.cuda.max_memory_allocated() / 2**30)
        del params, opt, step
        free_card(torch)
    return runs, opt_cfg.peak_lr


def spmd_held(runs, lr):
    """The spmd run against make_train_step's: (loss rel err, grad norm
    rel err, params max abs err, entries that differ, entries), and
    whether they are within the ``SPMD_*`` tolerances."""
    (ref, pref, *_), (got, pgot, *_) = runs["make_train_step"], \
        runs["make_train_step_spmd"]
    worst = off = total = 0
    for a, b in zip(_tree_leaves(pref), _tree_leaves(pgot)):
        d = (a.cuda().float() - b.cuda().float()).abs()
        worst = max(worst, float(d.max()))
        off += int((d > 0).sum())
        total += d.numel()
    lerr = max(abs(a[0] - b[0]) / abs(a[0]) for a, b in zip(ref, got))
    nerr = max(abs(a[1] - b[1]) / abs(a[1]) for a, b in zip(ref, got))
    ok = (lerr <= SPMD_LOSS_RTOL and nerr <= SPMD_NORM_RTOL
          and worst <= SPMD_PARAM_LRS * lr and off <= SPMD_PARAM_OFF * total)
    return (lerr, nerr, worst, off, total), ok


def phase_spmd_cell(torch, rows, mesh):
    """Phase 15 (e): ``make_train_step_spmd`` on the (1, 1) mesh of an NCCL
    process group of one rank, at phase 4's cell (llama3.2-3b at full
    width and depth, bf16, B=2, S=2048, remat "none"), against
    ``make_train_step`` for ``SPMD_STEPS`` steps from the same seeded
    weights; then the same on ``SPMD_FAMILY_CELLS`` (mamba2-780m,
    recurrentgemma-9b and seamless-m4t-large-v2 at full width), whose
    SSD, rec, encoder and decoder layers the step splits too (on one rank
    each split is the whole).  Each kernel's count is set to 0 just before
    the spmd steps and read just after: each must have launched as often
    as its layers call it (``spmd_kernel_counts``)."""
    import dataclasses
    from repro_torch.configs import REGISTRY
    from repro_torch.models.params import n_params

    failed = []
    cells = [("dense", TRAIN_ARCH, {"remat": TRAIN_REMAT}, TRAIN_B, TRAIN_S,
              0)] + SPMD_FAMILY_CELLS
    for tag, arch, over, B, S, src in cells:
        t0 = time.perf_counter()
        cfg = dataclasses.replace(REGISTRY[arch], **dict(
            {"remat": "none"}, **over))
        g = torch.Generator().manual_seed(4)
        batches = []
        for _ in range(SPMD_STEPS):
            blk = torch.randint(2, cfg.vocab, (B, S + 1), generator=g,
                                dtype=torch.int32)
            b = {"tokens": blk[:, :-1].cuda(), "targets": blk[:, 1:].cuda(),
                 "mask": torch.ones(B, S, device="cuda")}
            if src:
                b["frame_embeds"] = (torch.randn(B, src, cfg.d_model,
                                                 generator=g) * 0.02).cuda()
            batches.append(b)
        runs, lr = spmd_pair(torch, mesh, cfg, batches)
        (lerr, nerr, worst, off, total), ok = spmd_held(runs, lr)
        ref, _, ref_secs, _, ref_peak = runs["make_train_step"]
        got, _, secs, launches, peak = runs["make_train_step_spmd"]
        want = {k: n * SPMD_STEPS
                for k, (_, n) in spmd_kernel_counts(torch, cfg).items()}
        depth = ((cfg.enc_layers, cfg.dec_layers) if src else cfg.n_layers)
        shape = (f"B={B} S={S}" + (f" source frames {src}" if src else "")
                 + f" layers {depth}")
        log(f"[spmd] make_train_step_spmd on NCCL world 1, mesh {mesh.shape}"
            f", {cfg.name} ({n_params(cfg)} params bf16, {shape}, remat="
            f"{cfg.remat}), {SPMD_STEPS} steps against make_train_step: "
            f"(loss, grad norm) {got} against {ref}: rel err {lerr:.3e} (tol "
            f"{SPMD_LOSS_RTOL}) and {nerr:.3e} (tol {SPMD_NORM_RTOL}); params "
            f"max abs err {worst:.3e} (tol {SPMD_PARAM_LRS * lr:.3e}), {off} "
            f"of {total} entries differ (tol {SPMD_PARAM_OFF}); launches "
            f"{launches} (want {want}); "
            f"seconds a step {secs} against {ref_secs}; peak {peak:.3f} GiB "
            f"against {ref_peak:.3f}; {time.perf_counter() - t0:.1f} s")
        if launches != want:
            failed.append(f"{cfg.name}: the spmd step's launches {launches}, "
                          f"expected {want}")
        if not ok:
            failed.append(f"{cfg.name}: the spmd step differs from "
                          "make_train_step")
        if tag == "dense":
            rows[1]["spmd_launches"] = launches["flash_attention_fwd"]
            rows[2]["spmd_launches"] = launches["flash_attention_bwd"]
            rows[1]["spmd_step_s"] = secs
        else:
            for k, n in launches.items():
                row = {"flash_attention_fwd": 1, "flash_attention_bwd": 2,
                       "ssd_scan": 3, "lru_scan": 4}[k]
                rows[row][f"spmd_{tag}_launches"] = n
    if failed:
        raise AssertionError("; ".join(failed))


# phase 15 (f): the spmd serving steps against make_prefill /
# make_serve_step on the same (1, 1) mesh, each from the same weights and
# prompts (B=2), a prefill and SERVE_STEPS greedy steps: llama3-8b at full
# width and depth (2048-token prompts, a 4096-slot cache), mixtral-8x22b
# at phase 13's 8 of 56 layers, qwen2-vl-2b whole (512 patch embeddings
# ahead of 1536 text tokens, M-RoPE ids distinct over the vision span and
# carried on through the steps), and mamba2-780m, recurrentgemma-9b and
# seamless-m4t-large-v2 at the depths of SPMD_FAMILY_CELLS (seamless: 2048
# source frames, 256-token target prefixes, a 512-slot decoder ring).  On
# one rank the two run the same operations on operands of the same layout
# (a collective over one rank a copy; the split SSD's gated norm a sum
# over the axis divided by d_inner, as the mean is): tokens, every call's
# logits and the final cache must be equal bit for bit
SERVE_STEPS = 32
# token steps of each run, each cell, under torch.profiler (--serve-spmd)
PROFILE_STEPS = 4
# name, arch, config overrides, B, prompt positions, cache capacity,
# source frames
_FAMILY_DEPTH = {tag: over for tag, _, over, *_ in SPMD_FAMILY_CELLS}
SPMD_SERVE_CELLS = [
    ("dense", "llama3-8b", {}, 2, 2048, 4096, 0),
    ("moe", "mixtral-8x22b", {"n_layers": MOE_LAYERS}, 2, 2048, 4096, 0),
    ("vlm", "qwen2-vl-2b", {}, 2, 2048, 4096, 0),
    ("ssm", "mamba2-780m", _FAMILY_DEPTH["ssm"], 2, 2048, 4096, 0),
    ("hybrid", "recurrentgemma-9b", _FAMILY_DEPTH["hybrid"], 2, 2048, 4096,
     0),
    ("encdec", "seamless-m4t-large-v2", _FAMILY_DEPTH["encdec"], 2, 256, 512,
     2048),
]


def serve_kernel_counts(cfg):
    """The kernel wrappers a whole-prompt prefill of ``cfg`` launches and
    how often: the flash forward once an attention block (the encoder's,
    the decoder's self- and cross-attention), the SSD scan once an SSD
    layer, the LRU scan once a rec layer.  The token steps launch none:
    their attention is plain PyTorch, as JAX's ``decode_attention`` is an
    einsum."""
    from repro_torch.kernels.flash_attention import ops as fa
    from repro_torch.kernels.rglru_scan import ops as lru
    from repro_torch.kernels.ssd_scan import ops as ssd
    types = cfg.layer_types() if cfg.family != "encdec" else []
    want = {"flash_attention_fwd": (fa.flash_attention, types.count("attn")
                                    + cfg.enc_layers + 2 * cfg.dec_layers),
            "ssd_scan": (ssd.ssd_scan, types.count("ssd")),
            "lru_scan": (lru.lru_scan, types.count("rec"))}
    return {k: v for k, v in want.items() if v[1]}


def serve_inputs(torch, cfg, B, S, src):
    """(prompt batch on the card, each step's extras, the first step's
    position) of a phase 15 (f) cell, from seed 6."""
    import numpy as np
    g = torch.Generator().manual_seed(6)
    extras, steps = {}, [None] * SERVE_STEPS
    text = S
    if cfg.family == "vlm":
        sv = int(S * cfg.vision_frac)
        text = S - sv
        ids = vision_position_ids(B, S, sv)
        extras = {"vision_embeds": torch.randn(B, sv, cfg.d_model,
                                               generator=g) * 0.02,
                  "position_ids": torch.from_numpy(ids)}
        last = int(ids.max())
        steps = [{"position_ids": torch.full(
            (3, B, 1), last + 1 + i, dtype=torch.int32, device="cuda")}
            for i in range(SERVE_STEPS)]
    if cfg.family == "encdec":
        extras = {"frame_embeds": torch.randn(B, src, cfg.d_model,
                                              generator=g) * 0.02}
    batch = {"tokens": torch.randint(2, cfg.vocab, (B, text), generator=g,
                                     dtype=torch.int32), **extras}
    return ({k: v.cuda() for k, v in batch.items()}, steps,
            np.int32(S))


def serve_run(torch, params, prefill, step, batch, steps, start, kernels):
    """``prefill`` then ``SERVE_STEPS`` greedy ``step`` calls: (logits of
    each call on the host, tokens (B, SERVE_STEPS), the final cache,
    prefill seconds, seconds of each step, each kernel's launches, peak
    GiB).  The counts are set to 0 just before the prefill and read after
    the last step."""
    torch.cuda.reset_peak_memory_stats()
    for fn, _ in kernels.values():
        fn.launches = 0
        if hasattr(fn, "wgmma_launches"):
            fn.wgmma_launches = 0
    torch.cuda.synchronize()
    t = time.perf_counter()
    logits, cache = prefill(params, batch)
    torch.cuda.synchronize()
    prefill_s = time.perf_counter() - t
    B = batch["tokens"].shape[0]
    pos = torch.full((B,), int(start), dtype=torch.int32, device="cuda")
    seen, toks, secs = [logits.cpu()], [], []
    for extras in steps:
        tok = logits.argmax(-1, keepdim=True).to(torch.int32)
        toks.append(tok[:, 0].cpu())
        torch.cuda.synchronize()
        t = time.perf_counter()
        logits, cache = step(params, cache, tok, pos, extras)
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t)
        seen.append(logits.cpu())
        pos = pos + 1
    launches = {k: fn.launches for k, (fn, _) in kernels.items()}
    return (seen, torch.stack(toks, 1), cache, prefill_s, secs, launches,
            torch.cuda.max_memory_allocated() / 2 ** 30)


class StackedRanks:
    """``n`` ranks of a mesh axis emulated on one card, rank-major on the
    batch axis: ``pmax`` and ``reduce`` fold a (n * B, ...) tensor over
    them, as ``TensorParallel``'s all-reduces over the axis do."""

    def __init__(self, n):
        self.n = n

    def _fold(self, x, op):
        y = op(x.reshape(self.n, -1, *x.shape[1:]))
        return y.repeat(self.n, *[1] * (x.dim() - 1))

    def pmax(self, x):
        return self._fold(x, lambda t: t.amax(0))

    def reduce(self, x):
        return self._fold(x, lambda t: t.sum(0))


# llama3-8b's token step on the (16, 16) pod mesh's "model" axis: B 2,
# 32 heads over 8 kv heads, dh 128, a 4096-slot ring cut into 16 slices;
# each case (name, each stream's position, window, softcap): a wrapped
# ring, a stream whose slots past the first slice are all empty, a window
# over a wrapped ring, grok-1-314b's softcap
SPLIT_WINDOW = (2, 32, 8, 128, 4096, 16)
SPLIT_WINDOW_CASES = [("wrapped", (5000, 4200), 0, 0.0),
                      ("empty slices", (100, 300), 0, 0.0),
                      ("window 1000", (5000, 9000), 1000, 0.0),
                      ("softcap 30", (3000, 6000), 0, 30.0)]
# float32: the combine's rescaled sums against one softmax, held at the
# float32 share of (the output's RMS + |whole ring's|)
SPLIT_WINDOW_TOL = TOL["float32"]


def split_window_check(torch):
    """``layers.split_decode_attention`` and the cut ``cache_update`` on
    the card, over ``SPLIT_WINDOW``'s ring cut into slices of ranks
    emulated on the batch axis (``StackedRanks``: one card runs the spmd
    token step only at world 1, where no ring is cut), against
    ``decode_attention`` and ``cache_update`` on the whole ring, float32:
    the caches equal, the outputs within ``SPLIT_WINDOW_TOL``."""
    from repro_torch.models import layers as L
    B, Hq, Hkv, dh, W, n = SPLIT_WINDOW
    Wl = W // n
    g = torch.Generator(device="cuda").manual_seed(11)
    tp = StackedRanks(n)
    for name, pos, window, softcap in SPLIT_WINDOW_CASES:
        q, kn, vn = (torch.randn(B, 1, h, dh, generator=g, device="cuda")
                     for h in (Hq, Hkv, Hkv))
        k, v = (torch.randn(B, W, Hkv, dh, generator=g, device="cuda")
                for _ in range(2))
        p = torch.tensor(pos, dtype=torch.int32, device="cuda")
        kc, vc = L.cache_update(k, v, kn, vn, p)
        parts = [L.cache_update(k[:, r * Wl:(r + 1) * Wl],
                                v[:, r * Wl:(r + 1) * Wl], kn, vn, p,
                                width=W, first=r * Wl) for r in range(n)]
        if not (torch.equal(torch.cat([a for a, _ in parts], 1), kc)
                and torch.equal(torch.cat([b for _, b in parts], 1), vc)):
            raise AssertionError(f"split window {name}: the cut cache write "
                                 "differs from the whole ring's")
        kw = dict(window=window, softcap=softcap)
        want = L.decode_attention(q, kc, vc, L.cache_positions(p, W), p,
                                  **kw)
        got = L.split_decode_attention(
            q.repeat(n, 1, 1, 1), torch.cat([a for a, _ in parts]),
            torch.cat([b for _, b in parts]),
            torch.cat([L.cache_positions(p, W, r * Wl, Wl)
                       for r in range(n)]), p.repeat(n), tp, **kw)[:B]
        err = (got - want).abs()
        rms = float(want.square().mean().sqrt())
        if not (torch.isfinite(got).all()
                and bool((err <= SPLIT_WINDOW_TOL * (rms + want.abs())).all())):
            raise AssertionError(f"split window {name}: max abs err "
                                 f"{float(err.max()):.3e} against the whole "
                                 f"ring (RMS {rms:.3e})")
        log(f"[spmd serve] split window {name} (B={B} Hq={Hq} Hkv={Hkv} "
            f"dh={dh}, a {W}-slot ring over {n} emulated ranks, positions "
            f"{pos}, window {window}, softcap {softcap}), float32: cut "
            f"cache write equal, attention max abs err {float(err.max()):.3e}"
            f" (RMS {rms:.3e}, tol {SPLIT_WINDOW_TOL} x (RMS + |want|))")


def profile_token_steps(torch, what, step, params, cache, B, start, extras):
    """``PROFILE_STEPS`` token steps from ``cache`` (after two unprofiled
    ones) under torch.profiler and cProfile: seconds a step, the card's
    busy seconds and kernels a step, its kernels and the host's operators
    and functions by time."""
    import cProfile
    import pstats
    tok = torch.zeros(B, 1, dtype=torch.int32, device="cuda")
    pos = torch.full((B,), int(start) + SERVE_STEPS, dtype=torch.int32,
                     device="cuda")
    for _ in range(2):
        _, cache = step(params, cache, tok, pos, extras)
    torch.cuda.synchronize()
    prof = torch.profiler.profile(activities=[
        torch.profiler.ProfilerActivity.CPU,
        torch.profiler.ProfilerActivity.CUDA])
    host = cProfile.Profile()
    t = time.perf_counter()
    with prof:
        host.enable()
        for _ in range(PROFILE_STEPS):
            _, cache = step(params, cache, tok, pos, extras)
        torch.cuda.synchronize()
        host.disable()
    wall = (time.perf_counter() - t) / PROFILE_STEPS
    rows = device_rows(prof)
    busy = sum(r[0] for r in rows) / 1e6 / PROFILE_STEPS
    kernels = sum(r[1] for r in rows) / PROFILE_STEPS
    nccl = [r for r in rows if "nccl" in r[2].lower()]
    log(f"[serve profile] {what}: {wall:.6f} s a step profiled, device busy "
        f"{busy:.6f} s and {kernels:.0f} device events a step, of them "
        f"NCCL {sum(r[0] for r in nccl) / 1e6 / PROFILE_STEPS:.6f} s and "
        f"{sum(r[1] for r in nccl) / PROFILE_STEPS:.0f}")
    for dev, count, key in sorted(rows, reverse=True)[:8]:
        log(f"[serve profile]   device {dev / 1e3 / PROFILE_STEPS:10.3f} ms "
            f"{count / PROFILE_STEPS:7.0f}x a step  {key[:80]}")
    ops = sorted(((e.self_cpu_time_total, e.count, e.key)
                  for e in prof.key_averages()
                  if not str(getattr(e, "device_type", "")).endswith("CUDA")),
                 reverse=True)
    for us, count, key in ops[:12]:
        log(f"[serve profile]   host op {us / 1e3 / PROFILE_STEPS:10.3f} ms "
            f"{count / PROFILE_STEPS:7.0f}x a step  {key[:80]}")
    out = io.StringIO()
    pstats.Stats(host, stream=out).sort_stats("tottime").print_stats(14)
    for line in out.getvalue().splitlines():
        if line.strip():
            log(f"[serve profile]   {line.rstrip()[:150]}")


def phase_spmd_serve(torch, rows, mesh, card, profile=False):
    """Phase 15 (f): ``split_window_check``, then ``make_prefill_spmd``
    and ``make_serve_step_spmd`` on the (1, 1) mesh of an NCCL process
    group of one rank against ``make_prefill`` and ``make_serve_step``,
    on ``SPMD_SERVE_CELLS`` at full width, bf16, from the same seeded
    weights (on one rank the rank's shards are the whole tensors: both
    runs read the same ones): greedy tokens, every call's logits and the
    final cache equal bit for bit, and each kernel of the spmd prefill
    launched as its layers call it (``serve_kernel_counts``; its counts
    set to 0 just before the spmd run and read just after).  Logs each
    run's prefill seconds, seconds a step and peak GiB beside the card's
    name and power limit.  ``profile``: each run's token steps then go
    under the profiler (``profile_token_steps``)."""
    import dataclasses
    from repro_torch.configs import REGISTRY
    from repro_torch.launch import sharding as sh
    from repro_torch.launch.steps import (make_prefill, make_prefill_spmd,
                                          make_serve_step,
                                          make_serve_step_spmd)
    from repro_torch.models import decode as dec
    from repro_torch.models.params import init_params, n_params

    split_window_check(torch)
    failed = []
    for tag, arch, over, B, S, max_len, src in SPMD_SERVE_CELLS:
        t0 = time.perf_counter()
        cfg = dataclasses.replace(REGISTRY[arch], **over)
        gen = torch.Generator(device="cuda").manual_seed(0)
        params = init_params(cfg, gen, device="cuda")
        pspecs = sh.param_specs(cfg, mesh)
        batch, steps, start = serve_inputs(torch, cfg, B, S, src)
        kernels = serve_kernel_counts(cfg)
        view = dec.cache_view_specs(cfg, max_len, src)
        runs = {}
        for name, prefill, step in (
                ("make_prefill", make_prefill(cfg, max_len),
                 make_serve_step(cfg)),
                ("make_prefill_spmd",
                 make_prefill_spmd(cfg, mesh, pspecs, max_len),
                 make_serve_step_spmd(cfg, mesh, pspecs, max_len, src))):
            seen, toks, cache, pre_s, secs, launches, peak = serve_run(
                torch, params, prefill, step, batch, steps, start, kernels)
            runs[name] = (seen, toks, [c.cpu() for c in
                                       dec.tree_leaves(cache, view)],
                          pre_s, secs, launches, peak)
            if profile:
                profile_token_steps(torch, f"{cfg.name} {name}", step,
                                    params, cache, B, start, steps[-1])
            del cache
            free_card(torch)
        (ref, rtok, rcache, rpre, rsecs, rl, rpeak), \
            (got, gtok, gcache, pre_s, secs, launches, peak) = \
            runs["make_prefill"], runs["make_prefill_spmd"]
        lerr = max(float((a - b)[:, :cfg.vocab].abs().max())
                   for a, b in zip(ref, got))
        cerr = max(float((a.float() - b.float()).abs().max())
                   for a, b in zip(rcache, gcache))
        same = (torch.equal(rtok, gtok)
                and all(torch.equal(a[:, :cfg.vocab], b[:, :cfg.vocab])
                        for a, b in zip(ref, got))
                and all(torch.equal(a, b) for a, b in zip(rcache, gcache)))
        finite = all(bool(torch.isfinite(x[:, :cfg.vocab]).all())
                     for x in got)
        want = {k: n for k, (_, n) in kernels.items()}
        depth = (cfg.enc_layers, cfg.dec_layers) if src else cfg.n_layers
        log(f"[spmd serve] make_prefill_spmd + make_serve_step_spmd on NCCL "
            f"world 1, mesh {mesh.shape}, {cfg.name} ({n_params(cfg)} "
            f"params bf16, layers {depth}, B={B}, prompt {S} positions"
            + (f", {src} source frames" if src else "")
            + f", cache {max_len}), prefill + {SERVE_STEPS} greedy steps "
            f"against make_prefill + make_serve_step: tokens, logits and "
            f"final cache bit-identical {same} (logits max abs err "
            f"{lerr:.3e}, cache {cerr:.3e}), finite {finite}; prefill "
            f"launches {launches} (want {want}; make_prefill {rl}); prefill "
            f"{pre_s:.4f} s against {rpre:.4f}, a step {sum(secs) / len(secs):.5f}"
            f" s (median {sorted(secs)[len(secs) // 2]:.5f}) against "
            f"{sum(rsecs) / len(rsecs):.5f} (median "
            f"{sorted(rsecs)[len(rsecs) // 2]:.5f}); peak {peak:.3f} GiB "
            f"against {rpeak:.3f}; card {card}; "
            f"{time.perf_counter() - t0:.1f} s")
        if not (same and finite):
            failed.append(f"{cfg.name}: the spmd serving steps differ from "
                          "make_prefill / make_serve_step")
        if launches != want:
            failed.append(f"{cfg.name}: the spmd prefill's launches "
                          f"{launches}, expected {want}")
        for k, n in launches.items():
            row = {"flash_attention_fwd": 1, "ssd_scan": 3, "lru_scan": 4}[k]
            rows[row][f"spmd_serve_{tag}_launches"] = n
        rows[1][f"spmd_serve_{tag}_step_s"] = sum(secs) / len(secs)
        del params, runs, ref, got, rcache, gcache
        free_card(torch)
    if failed:
        raise AssertionError("; ".join(failed))


def serve_spmd_only(torch, card):
    """``--serve-spmd``: phase 15 (f) on its own NCCL world-1 group and
    (1, 1) mesh, each run's token steps profiled."""
    import os
    import shutil
    import tempfile
    import numpy as np
    import torch.distributed as dist
    from repro_torch.launch.mesh import Mesh
    tmp = tempfile.mkdtemp(prefix="chip_smoke_serve_")
    torch.cuda.set_device(0)
    dist.init_process_group("nccl", store=dist.FileStore(
        os.path.join(tmp, "store"), 1), rank=0, world_size=1)
    try:
        phase_spmd_serve(torch, [{} for _ in range(5)],
                         Mesh(np.array([[0]]), ("data", "model")), card,
                         profile=True)
    finally:
        dist.destroy_process_group()
        shutil.rmtree(tmp, ignore_errors=True)


DIST_ARCH = "llama3-8b"


def _tree_apply(fn, tree):
    if isinstance(tree, dict):
        return {k: _tree_apply(fn, v) for k, v in tree.items()}
    return fn(tree)


def phase_training_state(torch, rows, card):
    """Phase 15: (a), (b) the 8-bit AdamW on recurrentgemma-9b; (c)
    error-feedback compression; (d) the data-parallel step, the Trainer
    on a mesh and the sharded checkpoint on NCCL, (e) the spmd train step
    and (f) the spmd serving steps there.  Prints its seconds."""
    t0 = time.perf_counter()
    phase_hybrid_8bit(torch, rows)
    phase_ef(torch, rows)
    free_card(torch)
    phase_dist(torch, rows, card)
    log(f"[phase 15] {time.perf_counter() - t0:.1f} s")


# ---------------------------------------------------------------------------
# phase 16
# ---------------------------------------------------------------------------

DRY_ARCH = "llama3-8b"
DRY_SHAPES = ("train_4k", "prefill_32k", "decode_32k")
DRY_PEAK_TOL = 0.10         # the dry peak against max_memory_allocated
PHASE4 = {}
# (b)'s cells, each (arch, shape, multi-pod, layers — 0: all): llama3-8b's
# three production cells, its train cell on the pod mesh, and
# mixtral-8x22b's train cell cut to 1 and 2 layers (the growth a layer);
# train cells under the dry run's default impl, gspmd (the spmd step)
DRY_CELLS = ([(DRY_ARCH, shape, False, 0) for shape in DRY_SHAPES]
             + [(DRY_ARCH, "train_4k", True, 0)]
             + [("mixtral-8x22b", "train_4k", False, n) for n in (1, 2)])


def start_dry_cells():
    """Phase 16 (b)'s processes, one a cell of ``DRY_CELLS``, started now:
    they run on the host's cores while (a) traces phase 4's cell.  Returns (processes by cell, their
    output directory)."""
    import os
    import tempfile
    out_dir = tempfile.mkdtemp(prefix="chip_smoke_dryrun_")
    env = dict(os.environ, PYTHONPATH=str(SRC))
    procs = {cell: subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
         cell[0], "--shape", cell[1], "--layers", str(cell[3]), "--out",
         out_dir] + (["--multi-pod"] if cell[2] else [])
        # a depth cut's peak is what it is for; its decomposition would
        # trace its MoE layer a second time
        + (["--skip-analysis"] if cell[3] else []),
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, env=env)
        for cell in DRY_CELLS}
    return procs, out_dir


def stop_dry_cells(dry_cells):
    """Kill ``start_dry_cells``'s processes that still run and remove
    their output directory."""
    import shutil
    procs, out_dir = dry_cells
    for proc in procs.values():
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    shutil.rmtree(out_dir, ignore_errors=True)


def phase_dryrun(torch, phase4_launches, card, dry_cells):
    """Phase 16: (a) the dry run of phase 4's cell held against what phase
    4 measured; (b) ``DRY_CELLS``, one process each (``dry_cells``, from
    ``start_dry_cells``), waited for after (a): the pod mesh's peak a
    rank at most the single pod's, and mixtral-8x22b's growth a layer
    below one layer's gathered experts (cut over "model").  ``card``: the
    card's name and power limit (phase 1's)."""
    import dataclasses
    import numpy as np
    from repro_torch.configs import REGISTRY
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.core.costmodel import model_flops
    from repro_torch.launch import analysis, dryrun
    from repro_torch.launch import trace_analysis as ta
    from repro_torch.launch.mesh import Mesh

    t0 = time.perf_counter()
    procs, out_dir = dry_cells
    try:
        # (a) phase 4's cell, one rank of a (1, 1) mesh
        cfg = dataclasses.replace(REGISTRY[TRAIN_ARCH], remat=TRAIN_REMAT)
        shape = ShapeConfig("phase4", "train", TRAIN_S, TRAIN_B)
        mesh = Mesh(np.arange(1).reshape(1, 1), ("data", "model"))
        tr, _, secs = dryrun.trace_step(cfg, shape, mesh, fsdp=False,
                                        microbatches=1, opt_impl="adamw",
                                        train_impl="smap")
        want = {k: v // TRAIN_STEPS for k, v in phase4_launches.items()}
        peak = PHASE4["peak_gib"] * 2 ** 30
        rel = tr.peak_bytes / peak - 1.0
        mf = model_flops(cfg, shape)
        # the dry run's roofline: the trace's flops, the analytic HBM
        # lower bound (``analysis.analytic_hbm_bytes``), no collective
        hbm = analysis.analytic_hbm_bytes(cfg, shape, mesh, fsdp=False)
        rl = ta.roofline(flops_per_dev=tr.flops, bytes_per_dev=hbm,
                         coll_bytes_per_dev=0.0, model_flops_total=mf,
                         chips=1)
        step_s = PHASE4["steady_step_s"]
        log(f"[dryrun 16a] {cfg.name} B={TRAIN_B} S={TRAIN_S} "
            f"remat={cfg.remat} adamw, traced on "
            f"{ta.trace_device('cuda')} in {secs:.2f} s; card {card}")
        log(f"[dryrun 16a] launches a step: dry {tr.launches}, phase 4 "
            f"{want}")
        log(f"[dryrun 16a] peak: dry {tr.peak_bytes} bytes "
            f"({tr.peak_bytes / 2 ** 30:.4f} GiB: arguments "
            f"{tr.argument_bytes / 2 ** 30:.4f}), phase 4's "
            f"max_memory_allocated {PHASE4['peak_gib']:.4f} GiB: "
            f"{rel:+.4f} (tol {DRY_PEAK_TOL})")
        log(f"[dryrun 16a] flops a step: dry {tr.flops:.6e} (kernels "
            f"{sum(tr.kernel_flops.values()):.6e}), model_flops "
            f"{mf:.6e} (ratio {tr.flops / mf:.4f}); bytes accessed "
            f"{tr.bytes_accessed:.6e}")
        log(f"[dryrun 16a] roofline bound {rl.bound_s:.6f} s "
            f"({rl.dominant}: compute {rl.compute_s:.6f} s, memory "
            f"{rl.memory_s:.6f} s of the {hbm:.6e}-byte lower bound; the "
            f"trace's every-operand upper bound "
            f"{tr.bytes_accessed / ta.HBM_BW:.6f} s) against phase 4's "
            f"{step_s:.6f} s a step (ratio {step_s / rl.bound_s:.3f})")
        if tr.launches != want:
            raise AssertionError(f"dry launches a step {tr.launches}, phase "
                                 f"4's {want}")
        if abs(rel) > DRY_PEAK_TOL:
            raise AssertionError(f"dry peak {tr.peak_bytes} bytes is "
                                 f"{rel:+.4f} of phase 4's "
                                 f"max_memory_allocated")
        # (b) the production cells
        recs = {}
        for cell, proc in procs.items():
            text, _ = proc.communicate(timeout=600)
            name = dryrun.record_name(*cell)
            path = Path(out_dir) / f"{name}.json"
            rec = json.loads(path.read_text()) if path.exists() else {}
            log(dryrun.summary(name, rec) if rec else text[-2000:])
            if proc.returncode or rec.get("status") != "ok":
                raise AssertionError(f"{name}: exit {proc.returncode}, "
                                     f"status {rec.get('status')}: "
                                     f"{text[-2000:]}")
            recs[cell] = rec
            mem = rec["memory"]
            line = (f"[dryrun 16b] {name} ({rec['tag']}): peak "
                    f"{mem['peak_per_device']} bytes a rank, fits 80 GB "
                    f"{mem['fits_hbm_80gb']}, flops "
                    f"{rec['full_step_cost_analysis']['flops']:.6e}, "
                    f"collectives {rec['collectives']['per_class_bytes']}, "
                    f"launches {rec['launches']}")
            if "roofline" in rec:
                line += (f", flops ratio decomposed/full "
                         f"{rec['decomposed']['flops_ratio']:.6f}, roofline "
                         f"{rec['roofline']['dominant']} "
                         f"{rec['roofline']['compute_s']:.6f} / "
                         f"{rec['roofline']['memory_s']:.6f} / "
                         f"{rec['roofline']['collective_s']:.6f} s, fraction "
                         f"{rec['roofline']['roofline_fraction']:.6f}")
            log(line + f"; card {card}")
        pod1 = recs[DRY_ARCH, "train_4k", False, 0]["memory"]
        pod2 = recs[DRY_ARCH, "train_4k", True, 0]["memory"]
        log(f"[dryrun 16b] {DRY_ARCH} train_4k peak a rank: pod mesh "
            f"{pod2['peak_per_device']} bytes, single pod "
            f"{pod1['peak_per_device']} bytes")
        if pod2["peak_per_device"] > pod1["peak_per_device"]:
            raise AssertionError("the pod mesh's train peak a rank exceeds "
                                 "the single pod's")
        moe_cfg = REGISTRY["mixtral-8x22b"]
        one, two = (recs["mixtral-8x22b", "train_4k", False, n]["memory"][
            "peak_per_device"] for n in (1, 2))
        experts = 2 * moe_cfg.n_experts * moe_cfg.d_model * moe_cfg.d_ff * (
            3 if moe_cfg.activation in ("swiglu", "gelu_glu", "relu_glu")
            else 2) / 16
        log(f"[dryrun 16b] mixtral-8x22b train_4k (gspmd, FSDP) peak a "
            f"rank at 1 and 2 layers: {one} and {two} bytes, growth a layer "
            f"{(two - one) / 2**30:.4f} GiB against one layer's experts "
            f"gathered over data, cut over model: {experts / 2**30:.4f} GiB")
        if not 0 < two - one < experts:
            raise AssertionError("an MoE layer grows the train peak by its "
                                 "gathered experts")
    finally:
        stop_dry_cells(dry_cells)
    log(f"[dryrun] phase 16: {time.perf_counter() - t0:.1f} s; card {card}")


# ---------------------------------------------------------------------------
# phase 17: the user entry points
# ---------------------------------------------------------------------------

# the port's twins of the JAX package's examples (``examples/*_torch.py``),
# in the order each adds pieces to the one before
ENTRY_TWINS = ("quickstart", "elastic_restart", "train_e2e",
               "serve_adaptive")


def load_twin(name):
    """``examples/<name>_torch.py`` as a module (its ``main`` not run)."""
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        f"{name}_torch", ROOT / "examples" / f"{name}_torch.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def spy_geometries(ops, seen):
    """Wrap the attention wrappers of ``ops`` so that each call adds its
    geometry to ``seen`` (a Counter keyed by (kernel, geometry, dtype));
    the wrappers still count their own launches.  Returns the undo."""
    def flash(q, k, v, *rest, causal=True, window=0):
        return (q.shape[0], q.shape[1], k.shape[1], q.shape[2], k.shape[2],
                q.shape[3], bool(causal), int(window))

    def ring(q, k_new, v_new, k_cache, v_cache, pos, n_tokens, *, window=0,
             softcap=0.0):
        return (q.shape[0], q.shape[1], k_cache.shape[1], q.shape[2],
                k_cache.shape[2], q.shape[3], int(window), float(softcap))

    names = {"flash_attention_fwd": flash, "flash_attention_bwd": flash,
             "ring_chunk_attention": ring}
    kept = {name: getattr(ops, name) for name in names}

    def spy(name):
        fn, key = kept[name], names[name]

        def call(*args, **kw):
            seen[name, key(*args, **kw), str(args[0].dtype)[6:]] += 1
            return fn(*args, **kw)
        for attr in ("launches", "wgmma_launches"):
            if hasattr(fn, attr):
                setattr(call, attr, getattr(fn, attr))
        return call

    for name in names:
        setattr(ops, name, spy(name))

    def undo():
        # a wrapper counts its launches on the name it is called by, which
        # was the spy's: its counts go back to the wrapper
        for name, fn in kept.items():
            for attr in ("launches", "wgmma_launches"):
                if hasattr(fn, attr):
                    setattr(fn, attr, getattr(getattr(ops, name), attr))
            setattr(ops, name, fn)
    return undo


def held_geometries(seen):
    """Each geometry of ``seen`` against the rows phases 2 and 2b hold
    against the plain version (every row in bf16, the float32 ones in
    float32 too; the flash main path in bf16 only): the ones no row
    holds."""
    ring = {(g[1:7] + g[9:11]): g[11] for g in RING_GEOMETRIES}
    flash = {g[1:]: g[0] for g in [FLASH_MAIN, FLASH_HYBRID]
             + FLASH_GEOMETRIES}
    missing = []
    for (name, geo, dtype) in seen:
        if name == "ring_chunk_attention":
            ok = geo in ring and dtype in (ring[geo], "bfloat16")
        else:
            ok = geo in flash and (dtype == "bfloat16"
                                   or flash[geo] != "main_path")
        if not ok:
            missing.append((name, geo, dtype))
    return missing


def entry_counts(ops):
    """Each attention kernel's launches since the counts were zeroed, by
    route: (tensor-core, FMA)."""
    parts = {"ring_chunk_attention": ops.ring_chunk_attention,
             "flash_attention_fwd": ops.flash_attention,
             "flash_attention_bwd": ops.flash_attention_bwd}
    return {name: (fn.wgmma_launches, fn.launches - fn.wgmma_launches)
            for name, fn in parts.items()}


def run_twin(torch, ops, name, work):
    """One twin's ``main()`` on the card, as a user runs it (no device
    given: CUDA), with every attention count zeroed just before and read
    just after.  Returns (its output, launches by kernel and route, the
    geometries it gave the kernels, its seconds, its peak GiB)."""
    import collections
    import os
    for fn in (ops.ring_chunk_attention, ops.flash_attention,
               ops.flash_attention_bwd):
        fn.launches = 0
        fn.wgmma_launches = 0
    free_card(torch)
    torch.cuda.reset_peak_memory_stats()
    seen = collections.Counter()
    mod = load_twin(name)
    kw = {} if name == "serve_adaptive" else {
        "workdir": os.path.join(work, name)}
    t0 = time.perf_counter()
    undo = spy_geometries(ops, seen)
    try:
        out = mod.main(**kw)
        torch.cuda.synchronize()
    finally:
        undo()
    secs = time.perf_counter() - t0
    return (out, entry_counts(ops), seen, secs,
            torch.cuda.max_memory_allocated() / 2 ** 30)


def phase_entry_points(torch, rows, card):
    """Phase 17: the four user entry points of the port, each twin's
    ``main()`` on the card at its JAX example's own size —
    ``train_e2e_torch.py`` at its default 300 steps of ``model_100m()``
    (125.8M parameters, which the example's docstring rounds to "~116M";
    float32) at B 8, S 256.  Each kernel's launches by
    route: every twin's model is float32, so every launch must take the
    FMA route and each kernel it reaches must launch; the training twins'
    flash launches are a forward and a backward a layer and step (and
    quickstart's prefill a forward a layer), serve_adaptive's ring
    launches one a layer and chunk tick.  Every geometry a twin gave a
    kernel must be a row that phases 2 and 2b hold against the plain
    version.  Fails if train_e2e's mean loss of the last 10 steps is not
    below the first 10's (the example's own assert), if elastic_restart
    does not resume at step 10, or if serve_adaptive leaves a request
    unfinished or fails the pool's audit.  ``rows``: the kernels line's
    rows, which get the launches (``entry_launches``)."""
    import shutil
    import tempfile
    from repro_torch.kernels.flash_attention import ops

    t0 = time.perf_counter()
    work = tempfile.mkdtemp(prefix="chip_smoke_entry_")
    launches = {}
    try:
        for name in ENTRY_TWINS:
            log(f"[entry] {name}_torch.py on the card ({card})")
            out, counts, seen, secs, peak = run_twin(torch, ops, name, work)
            launches[name] = counts
            missing = held_geometries(seen)
            log(f"[entry] {name}: {secs:.1f} s, peak {peak:.3f} GiB; "
                f"launches (tensor-core, FMA) {counts}; geometries "
                f"{sorted(set(seen))}")
            if missing:
                raise AssertionError(f"{name}: no row of RING_GEOMETRIES / "
                                     f"FLASH_GEOMETRIES holds {missing}")
            if any(wg for wg, _ in counts.values()):
                raise AssertionError(f"{name}: a float32 call took the "
                                     f"tensor-core route: {counts}")
            check_entry(name, out, counts, peak, card)
            shutil.rmtree(Path(work) / name, ignore_errors=True)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    for i, kernel in enumerate(("ring_chunk_attention", "flash_attention_fwd",
                                "flash_attention_bwd")):
        rows[i]["entry_launches"] = {
            name: sum(launches[name][kernel]) for name in ENTRY_TWINS
            if sum(launches[name][kernel])}
    log(f"[entry] phase 17: {time.perf_counter() - t0:.1f} s; card {card}")


def unigram_entropy(n_tokens):
    """The entropy (nats) of the token frequencies of the first
    ``n_tokens`` train_e2e's loader reads: its corpus's shard 0 (2M
    tokens, i.i.d. Zipf draws and document ends)."""
    import numpy as np
    from repro_torch.data.pipeline import SyntheticCorpus
    toks = SyntheticCorpus(32768, seed=1234).shard_tokens(0, 2_000_000)
    counts = np.bincount(toks[:n_tokens], minlength=32768)
    p = counts[counts > 0] / n_tokens
    return float(-(p * np.log(p)).sum())


def check_entry(name, out, counts, peak, card):
    """Phase 17's gates and figures for one twin's output ``out``."""
    from repro_torch.configs import REGISTRY, reduced_config
    fwd, bwd, ring = (sum(counts[k]) for k in (
        "flash_attention_fwd", "flash_attention_bwd", "ring_chunk_attention"))
    if name == "quickstart":
        layers = reduced_config(REGISTRY["llama3-8b"]).n_layers
        want = (layers * (out["steps"] + 1), layers * out["steps"], 0)
        if len(out["generated"]) != 12 or not all(
                math.isfinite(x) for x in out["losses"]):
            raise AssertionError(f"quickstart: {out['generated']}, losses "
                                 f"{out['losses']}")
    elif name == "elastic_restart":
        if out["resumed_at"] != 10 or out["failure"] is None \
                or out["steps"] != 30 or len(out["losses"]) != 20:
            raise AssertionError(f"elastic_restart: failure "
                                 f"{out['failure']!r}, resumed at "
                                 f"{out['resumed_at']}, {out['steps']} steps")
        layers = reduced_config(REGISTRY["llama3-8b"]).n_layers
        # run 1 took 17 steps before its injected failure, run 2 20
        want = (layers * 37, layers * 37, 0)
    elif name == "train_e2e":
        steady = out["step_times"][1:]
        step_s = sum(steady) / len(steady)
        B, S = 8, 256
        log(f"[entry] train_e2e {out['model']} ({out['n_params']} "
            f"parameters, float32) B={B} S={S}: {out['steps']} steps, "
            f"{step_s:.6f} s a step (mean of steps 2-{out['steps']}, each "
            f"to its loss on the host), {B * S / step_s:.1f} tokens/s "
            f"(the example's own, wall time with data and checkpoints: "
            f"{out['tok_per_s']:.1f}), first step {out['step_times'][0]:.3f}"
            f" s, peak {peak:.3f} GiB; loss first 10 "
            f"{out['loss_first10']:.6f} -> last 10 {out['loss_last10']:.6f}"
            f"; stragglers {out['stragglers']}; card {card}")
        log(f"[entry] train_e2e losses every 10 steps: "
            f"{[round(x, 4) for x in out['losses'][::10]]}; the unigram "
            f"entropy of the tokens it read, the loss of a model that "
            f"learned their frequencies alone: "
            f"{unigram_entropy(out['steps'] * B * (S + 1)):.6f} nats")
        if out["steps"] != 300 or not out["loss_last10"] < out[
                "loss_first10"]:
            raise AssertionError("train_e2e: the loss did not fall")
        want = (12 * 300, 12 * 300, 0)
    else:
        eng = out["engine"]
        if len(eng.submitted) != 16 or not all(r.done
                                               for r in eng.submitted):
            raise AssertionError("serve_adaptive: a request is unfinished")
        eng.pool.audit([])
        moves = [tuple(r[k] for k in ("step", "old_groups", "new_groups",
                                      "moved_slots", "requeued"))
                 for r in out["relayouts"]]
        log(f"[entry] serve_adaptive decisions {out['decisions']}; "
            f"relayouts (step, old groups, new groups, streams re-pointed, "
            f"requeued) {moves}; chunk ticks "
            f"{eng.kv_stats()['chunk_ticks']:.0f}; card {card}")
        layers = eng.cfg.n_layers
        want = (0, 0, layers * int(eng.kv_stats()["chunk_ticks"]))
    if (fwd, bwd, ring) != want or not any(want):
        raise AssertionError(f"{name}: launches (flash forward, backward, "
                             f"ring) {(fwd, bwd, ring)}, expected {want}")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--kernels-only", action="store_true",
                    help="phases 1, 2, 2b, 2c and 2d only")
    ap.add_argument("--ring-splits", action="store_true",
                    help="phase 1, then time the bf16 ring kernel at both "
                         "serving shapes over ring split widths of 1-16 "
                         "tiles, and stop")
    ap.add_argument("--ssd-head-sets", action="store_true",
                    help="phase 1, then time the bf16 SSD kernel at the "
                         "training shape over the heads a block of its "
                         "scan and state kernels, and stop")
    ap.add_argument("--lru-tiles", action="store_true",
                    help="phase 1, then time the RG-LRU scan kernel at the "
                         "training shape over tiles, and stop")
    ap.add_argument("--training-state", action="store_true",
                    help="phase 1, then phase 15 (the 8-bit AdamW, "
                         "error-feedback compression and the data-parallel "
                         "step on NCCL), and stop")
    ap.add_argument("--dry-run", action="store_true",
                    help="phase 1, phase 4 (llama3.2-3b trained on the "
                         "card), then phase 16 (the dry run held against "
                         "it), and stop")
    ap.add_argument("--serve-spmd", action="store_true",
                    help="phase 1, the flash forward's tp_prefill row, then "
                         "phase 15 (f) with each run's token steps under "
                         "torch.profiler and cProfile, and stop")
    ap.add_argument("--entry-points", action="store_true",
                    help="phase 1, then phase 17 (the port's twins of the "
                         "four examples on the card), and stop")
    ap.add_argument("--profile", action="store_true",
                    help="time phases 3's, 6's and 8's two step kinds, "
                         "then replay each on a fresh engine under "
                         "torch.profiler and cProfile; profile one more "
                         "training step in phases 4, 5 and 7")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    if not (SRC / "repro_torch").is_dir():
        print("chip_smoke: run it from a checkout of the repository "
              "(src/repro_torch is missing)", file=sys.stderr)
        return 1
    sys.path.insert(0, str(SRC))
    from repro_torch.configs import REGISTRY
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.rglru_scan import ops as lru_ops
    from repro_torch.kernels.ssd_scan import ops as ssd_ops
    t0 = time.perf_counter()
    card = phase_build(torch)
    if args.ring_splits:
        ring_split_sweep(torch)
        return 0
    if args.ssd_head_sets:
        ssd_head_set_sweep(torch)
        return 0
    if args.lru_tiles:
        lru_tile_sweep(torch)
        return 0
    if args.training_state:
        phase_training_state(torch, [{} for _ in range(5)], card)
        return 0
    if args.serve_spmd:
        from repro_torch.kernels.flash_attention import ops
        flash_tp_prefill(torch, ops)
        serve_spmd_only(torch, card)
        return 0
    if args.dry_run:
        launches = phase_train_main(torch, fa_ops, False)
        phase_dryrun(torch, launches, card, start_dry_cells())
        return 0
    if args.entry_points:
        phase_entry_points(torch, [{} for _ in range(3)], card)
        return 0
    rows = [phase_ring_kernel(torch)]
    flash = phase_flash_kernels(torch)
    rows += [flash["fwd"], flash["bwd"]]
    rows.append(phase_ssd_kernel(torch))
    rows.append(phase_lru_kernel(torch))
    ring_device_times(torch, rows[0])
    for row in rows:
        row["launches"] = 0
    if not args.kernels_only:
        free_card(torch)
        dense = phase_engine(torch, ENGINE_ARCH, args.profile)
        rows[0]["launches"] = dense["ring"]
        # phase 12 (a)-(d): the flash forward's launches in the eager
        # engine's 9 whole-prompt prefills
        rows[1]["eager_prefill_launches"] = phase_modes(torch, dense)
        phase_engine_reference(torch, ENGINE_ARCH, [
            ("CPU", "cpu", "blocked", None),
            ("kernel", "cuda", "blocked", None),
            ("plain attention", "cuda", "dense", None)]
            + CARD_VARIANTS["dense"])
        phase_spec(torch, dense)            # phase 9
        phase_async(torch, dense)           # phase 10
        phase_warm(torch, dense)            # phase 11
        del dense
        free_card(torch)
        flash_launches = phase_train_main(torch, fa_ops, args.profile)
        rows[1]["launches"] = flash_launches["flash_attention_fwd"]
        rows[2]["launches"] = flash_launches["flash_attention_bwd"]
        phase_trainer(torch, TRAIN_ARCH, fa_ops.flash_attention)
        # one launch a layer and step; the backward recomputes through
        # ssd_chunked and launches nothing
        rows[3]["launches"] = phase_train(
            torch, SSM_ARCH, SSM_B, SSM_REMAT,
            {"ssd_scan": (ssd_ops.ssd_scan, REGISTRY[SSM_ARCH].n_layers)},
            {"wx[0]": lambda p: p["layers"]["ssd"]["wx"][0],
             "A_log": lambda p: p["layers"]["ssd"]["A_log"],
             "embed[:4096]": lambda p: p["embed"][:4096]},
            args.profile, stats=PHASE5)["ssd_scan"]
        phase_trainer(torch, SSM_ARCH, ssd_ops.ssd_scan)
        free_card(torch)
        ssm = phase_engine(torch, SSM_ARCH, args.profile)
        # phase 12 (e): the SSD scan in the eager engine's prefills
        rows[3]["eager_prefill_launches"] = phase_modes_family(
            torch, ssm)["ssd"]
        del ssm
        phase_engine_reference(torch, SSM_ARCH, [
            ("CPU", "cpu", "blocked", None),
            ("card", "cuda", "blocked", None)] + CARD_VARIANTS["ssm"])
        free_card(torch)
        # phase 7: the scan forward and reverse in each rec layer, each
        # flash kernel once in each attn layer, a step
        types = REGISTRY[HYBRID_ARCH].layer_types()[:HYBRID_LAYERS]
        n_rec, n_attn = types.count("rec"), types.count("attn")
        hybrid = phase_train(
            torch, HYBRID_ARCH, HYBRID_B, HYBRID_REMAT,
            {"lru_scan": (lru_ops.lru_scan, 2 * n_rec),
             "flash_attention_fwd": (fa_ops.flash_attention, n_attn * (
                 1 if HYBRID_REMAT == "none" else 2)),
             "flash_attention_bwd": (fa_ops.flash_attention_bwd, n_attn)},
            # (lam, a bf16 -5.0, moves by less than half its ulp in 4
            # steps of lr 3e-4, so it is no probe)
            {"w_a[0]": lambda p: p["groups"]["b0_rec"]["rec"]["w_a"][0],
             "w_in[0]": lambda p: p["groups"]["b0_rec"]["rec"]["w_in"][0],
             "wq[0]": lambda p: p["groups"]["b2_attn"]["attn"]["wq"][0],
             "tail w_out": lambda p: p["tail"]["t1_rec"]["rec"]["w_out"],
             "embed[:4096]": lambda p: p["embed"][:4096]},
            args.profile, S=HYBRID_S, layers=HYBRID_LAYERS, stats=PHASE7)
        rows[4]["launches"] = hybrid["lru_scan"]
        rows[1]["hybrid_launches"] = hybrid["flash_attention_fwd"]
        rows[2]["hybrid_launches"] = hybrid["flash_attention_bwd"]
        phase_trainer(torch, HYBRID_ARCH, lru_ops.lru_scan)
        free_card(torch)
        # phase 8
        served = phase_engine(torch, HYBRID_ARCH, args.profile)
        rows[0]["hybrid_launches"] = served["ring"]
        rows[4]["serving_launches"] = served["lru"]
        phase_spec(torch, served)           # phase 9, the hybrid
        eager = phase_modes_family(torch, served)   # phase 12 (e)
        rows[4]["eager_prefill_launches"] = eager["lru"]
        rows[1]["hybrid_eager_prefill_launches"] = eager["flash"]
        del served
        free_card(torch)
        phase_engine_reference(torch, HYBRID_ARCH, [
            ("CPU", "cpu", "blocked", None),
            ("card", "cuda", "blocked", None)] + CARD_VARIANTS["hybrid"])
        phase_moe(torch, rows)              # phase 13
        phase_vlm_encdec(torch, rows)       # phase 14
        phase_training_state(torch, rows, card)   # phase 15
        free_card(torch)
        # phase 16; its (b) processes start after phase 15's timed steps,
        # so that none of those ran beside them on the host
        phase_dryrun(torch, flash_launches, card, start_dry_cells())
        free_card(torch)
        phase_entry_points(torch, rows, card)      # phase 17
    log(f"[smoke] {time.perf_counter() - t0:.1f} s")
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    # the contract's keys first, then each kernel's numbers on its other
    # path (hybrid_*: recurrentgemma-9b's shapes, phases 7 and 8)
    print(json.dumps({"kernels": [
        {**{k: row[k] for k in keys},
         **{k: v for k, v in row.items() if k not in keys}}
        for row in rows]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0

if __name__ == "__main__":
    sys.exit(main())
