#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

    python3 chip_smoke.py              # all phases, one card
    python3 chip_smoke.py --profile    # + where phases 3-8 spend their time
    python3 chip_smoke.py --ring-splits  # the bf16 ring kernel by split width
    python3 chip_smoke.py --ssd-head-sets  # the bf16 SSD kernel by head set
    python3 chip_smoke.py --lru-tiles  # the RG-LRU scan kernel by tile

Phases (any error fails the run with a non-zero exit):

1. Build every kernel from the sources in this checkout, print each
   kernel's registers and spills from the compiler's log, and the card's
   name and power limit.  TF32 is switched off for float32 matmuls
   and convolutions, so float32 references are full float32.
2. Hold the ring-chunk kernels against their plain PyTorch version on the
   card, at the serving path's shape and at the edge geometries (ring
   wrap, a chunk wider than the ring, idle rows and an idle stream, GQA
   8:1, window with softcap, a short history in a wide ring) and at phase
   8's dh 256 shape (16 query heads over one kv head), every geometry in
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
   directory and the port's ``ShardedLoader`` read back: losses and grad
   norms finite, parameters changed, and both flash kernels launched once
   per layer and step (the forward twice under remat).  ``--profile``
   adds one more step under torch.profiler.
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
   geometries, ragged S and W, and the serving chunk's shape; the fused
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

The last line is ``{"ok": true, "device": {...}}``; the line before it
lists every kernel with its launches (counted over its main path: phase
3 for the ring kernel, phase 4 for the flash kernels, phase 5 for the SSD
kernel, phase 7 for the RG-LRU scan; ``hybrid_*`` and
``serving_launches`` give the numbers on the hybrid's paths, phases 7
and 8), error and times.
"""
from __future__ import annotations

import argparse
import gc
import io
import json
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
    bound.  ``ring_device_times`` adds the device times last."""
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
    Python around it, so CUDA events would time the host.  Run after every
    phase that CUDA events time: a profiler session can slow the launches
    that follow it."""
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

# name, B, S, Hq, Hkv, dh, causal, window
FLASH_MAIN = ("main_path", 2, 2048, 24, 8, 128, True, 0)
# phase 7's shape: recurrentgemma-9b's local attention, dh 256, 16 query
# heads over one kv head, window 2048 at S 4096
FLASH_HYBRID = ("hybrid_path", 1, 4096, 16, 1, 256, True, 2048)
FLASH_GEOMETRIES = [
    ("fa_sweep_0", 2, 128, 4, 2, 64, True, 0),
    ("fa_sweep_1", 1, 256, 4, 4, 32, True, 64),
    ("fa_sweep_2", 2, 128, 8, 2, 64, False, 0),
    ("fa_sweep_3", 1, 128, 2, 1, 128, True, 32),
    ("fa_sweep_4", 2, 64, 4, 1, 64, True, 0),
    ("fa_sweep_5", 1, 192, 6, 3, 32, True, 48),
    ("ragged_s200", 2, 200, 6, 2, 16, True, 0),
    ("ragged_dh256", 1, 1000, 16, 1, 256, True, 300),
    ("ragged_not_causal_dh128", 1, 77, 4, 4, 128, False, 0),
    ("gqa3_window_dh128", 1, 300, 6, 2, 128, True, 100),
    ("not_causal_dh256", 2, 130, 4, 2, 256, False, 0),
    ("gqa16_ragged_dh64", 1, 333, 16, 1, 64, True, 0),
]
FLASH_SOURCE = "src/repro_torch/kernels/flash_attention/csrc/"


def flash_inputs(torch, B, S, Hq, Hkv, dh, dtype, seed):
    """q, k, v and an upstream gradient do, on the card."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    dt = getattr(torch, dtype)
    return [torch.randn(s, generator=g, device="cuda").to(dt)
            for s in ((B, S, Hq, dh), (B, S, Hkv, dh), (B, S, Hkv, dh),
                      (B, S, Hq, dh))]


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
        name, B, S, Hq, Hkv, dh, causal, window = geo
        dtypes = ("bfloat16",) if name == "main_path" else ("float32",
                                                            "bfloat16")
        for dtype in dtypes:
            q, k, v, do = flash_inputs(torch, B, S, Hq, Hkv, dh, dtype,
                                       seed=S + dh)
            kw = dict(causal=causal, window=window)
            out, lse = ops.flash_attention_fwd(q, k, v, **kw)
            want_out, want_lse = ref.flash_attention_fwd_ref(q, k, v, **kw)
            # the backward kernels on the plain forward's out and lse
            grads = ops.flash_attention_bwd(q, k, v, want_out, want_lse, do,
                                            **kw)
            torch.cuda.synchronize()
            want = ref.flash_attention_bwd_ref(q, k, v, want_out, want_lse,
                                               do, **kw)
            tf, tb = FLASH_TOL["fwd", dtype], FLASH_TOL["bwd", dtype]
            what = (f"{name} {dtype} B={B} S={S} Hq={Hq} Hkv={Hkv} dh={dh} "
                    f"causal={causal} window={window}")
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
    timing = flash_timing(torch, ops, ref, *FLASH_MAIN[1:])
    hybrid = flash_timing(torch, ops, ref, *FLASH_HYBRID[1:])
    for part in ("fwd", "bwd"):
        rows[part].update(timing[part])
        rows[part].update({f"hybrid_{k}": v for k, v in hybrid[part].items()})
    return rows


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
            del xdt, a, Bh, Ch, y, h, want_y, want_h
    row.update(ssd_timing(torch, ops, ref, *ssd_main_geometry()[1:]))
    return row


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
    row["max_abs_err"] = worst
    # the fused VJP against its plain version, and the kernel's arithmetic
    # in plain PyTorch against the kernel, at the training shape
    _, B, S, W = lru_main_geometry()
    a, g, h = lru_vjp_inputs(torch, B, S, W, seed=5)
    da, db = ops._lru_vjp(a, g, h)
    torch.cuda.synchronize()
    want_da, want_db = ref.lru_vjp_plain(a, g, h)
    row["bwd_max_abs_err"] = max_err(torch, [("da", da, want_da),
                                             ("db", db, want_db)],
                                     LRU_GRAD_TOL, "lru fused VJP")
    log(f"[lru] fused VJP B={B} S={S} W={W}: max_abs_err="
        f"{row['bwd_max_abs_err']:.3e} (tol {LRU_GRAD_TOL} + {LRU_GRAD_TOL}"
        " * |plain|)")
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


def phase_engine(torch, arch, profile: bool = False):
    """Serve the main path's requests on ``arch`` at full width and depth
    through the port's ServeEngine.  Returns the launches of the ring and
    the RG-LRU scan kernels over the run."""
    from repro_torch.configs import REGISTRY
    from repro_torch.core.topology import ChipletTopology
    from repro_torch.kernels.flash_attention import ops
    from repro_torch.kernels.rglru_scan import ops as lru_ops
    from repro_torch.serving.engine import EngineConfig, ServeEngine

    cfg = REGISTRY[arch]
    dense = cfg.family == "dense"
    types = cfg.layer_types()
    n_attn, n_rec = types.count("attn"), types.count("rec")
    tag = f"[engine {cfg.name}]"

    def engine():
        topo = ChipletTopology(n_pods=1, groups_per_pod=2, chips_per_group=1)
        ecfg = EngineConfig(max_batch=8, max_len=1024, pool_streams=8)
        return ServeEngine(cfg, topo, ecfg, seed=0)

    t0 = time.perf_counter()
    eng = engine()
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
    ops.ring_chunk_attention.launches = 0
    ops.ring_chunk_attention.wgmma_launches = 0
    lru_ops.lru_scan.launches = 0
    first, reqs, res, wall = serve(torch, eng, cfg, around=timed)
    launches = ops.ring_chunk_attention.launches
    wgmma = ops.ring_chunk_attention.wgmma_launches
    lru_launches = lru_ops.lru_scan.launches
    # bf16 serving: every ring launch took the tensor-core route
    if wgmma != launches:
        raise AssertionError(f"ring kernel: {wgmma} of {launches} launches "
                             "on the tensor-core route")

    for r in [first] + reqs:
        if not r.done or len(r.generated) != r.max_new:
            raise AssertionError(f"request {r.rid}: {len(r.generated)} of "
                                 f"{r.max_new} tokens")
        if not all(0 <= t < cfg.vocab for t in r.generated):
            raise AssertionError(f"request {r.rid}: token out of vocab")
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
    log(f"{tag} {len(reqs)} requests, {st['tokens']} tokens in "
        f"{wall:.2f} s: {st['tokens'] / wall:.1f} tokens/s; "
        f"TTFT p50 {st['ttft_p50'] * 1e3:.1f} ms, "
        f"TPOT p50 {st['tpot_p50'] * 1e3:.1f} ms")
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
        profile_replay(torch, engine(), cfg, wall)
    return {"ring": launches, "lru": lru_launches}


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
    rows = []
    for e in prof.key_averages():
        # device-side events only (kernels, copies, fills): the host ops
        # that launched them report the same time again
        if not str(getattr(e, "device_type", "")).endswith("CUDA"):
            continue
        dev = getattr(e, "self_device_time_total",
                      getattr(e, "self_cuda_time_total", 0.0))
        if dev > 0:
            rows.append((dev, e.count, e.key))
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


def phase_engine_reference(torch, arch, runs):
    """Small input, float32: the reduced ``arch`` engine gives the same
    tokens in every run of ``runs``, each (label, device, chunk kernel),
    on the same weights drawn on the CPU."""
    import numpy as np
    from repro_torch.configs import REGISTRY, reduced_config
    from repro_torch.core.topology import ChipletTopology
    from repro_torch.models.params import init_params
    from repro_torch.serving.engine import EngineConfig, ServeEngine

    cfg = reduced_config(REGISTRY[arch])
    base = init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    rng = np.random.default_rng(1)
    prompts = [rng.integers(2, cfg.vocab, size=int(n))
               for n in (5, 19, 33, 40)]
    outs = {}
    for label, device, kernel in runs:
        topo = ChipletTopology(n_pods=1, groups_per_pod=2, chips_per_group=1)
        eng = ServeEngine(cfg, topo, EngineConfig(
            max_batch=2, max_len=48, pool_streams=2, chunk_kernel=kernel),
            params=_to_device(base, device), device=device)
        reqs = [eng.submit(p, max_new=12) for p in prompts]
        eng.run_until_done()
        outs[label] = [r.generated for r in reqs]
    labels = " == ".join(outs)
    if any(v != outs[runs[0][0]] for v in outs.values()):
        raise AssertionError(f"reduced {arch} float32: not {labels} tokens")
    log(f"[engine {cfg.name}] float32: {labels} tokens for 4 requests")


def _to_device(tree, device):
    if isinstance(tree, dict):
        return {k: _to_device(v, device) for k, v in tree.items()}
    return tree.clone().to(device)


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
                S=TRAIN_S, layers=0):
    """4 steps of the port's train step on ``arch`` at full width and
    depth (``layers`` cuts the depth when given), bf16, sequence ``S``.
    ``kernels``: name -> (wrapper with a ``launches`` count, launches
    expected per step); ``probes``: name -> a parameter slice that must
    change.  Returns name -> launches over the 4 steps."""
    import dataclasses
    import math
    import shutil
    import tempfile
    from repro_torch.configs import REGISTRY
    from repro_torch.data.pipeline import (ShardedLoader, SyntheticCorpus,
                                           make_batch, write_corpus_shards)
    from repro_torch.launch.steps import make_train_step
    from repro_torch.models.params import init_params, n_params
    from repro_torch.optim.adamw import AdamWConfig, init_opt_state

    cfg = dataclasses.replace(REGISTRY[arch], remat=remat,
                              n_layers=layers or REGISTRY[arch].n_layers)
    t0 = time.perf_counter()
    gen = torch.Generator(device="cuda").manual_seed(0)
    params = init_params(cfg, gen, device="cuda")
    opt = init_opt_state(params)
    # warmup of one step so bf16 weights move from the first update
    step = make_train_step(cfg, AdamWConfig(warmup_steps=1))
    torch.cuda.synchronize()
    tag = f"[train {cfg.name}]"
    log(f"{tag} layers={cfg.n_layers} d_model={cfg.d_model} "
        f"family={cfg.family} vocab={cfg.vocab} {n_params(cfg)} params "
        f"{cfg.param_dtype}, remat={cfg.remat}; B={B} S={S}; set-up "
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
        params, opt, m = step(params, opt, batches[i])
        loss, gnorm = float(m["loss"]), float(m["grad_norm"])
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t)
        if not (math.isfinite(loss) and math.isfinite(gnorm)):
            raise AssertionError(f"step {i + 1}: loss {loss}, grad norm "
                                 f"{gnorm}")
        log(f"{tag} step {i + 1}: loss {loss:.6f} grad_norm {gnorm:.6f} "
            f"lr {float(m['lr']):.3e} {secs[-1]:.6f} s"
            + (f", peak {torch.cuda.max_memory_allocated() / 2**30:.3f} "
               "GiB after the first step" if i == 0 else ""))
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
    steady = sum(secs[1:]) / len(secs[1:])
    peak = torch.cuda.max_memory_allocated() / 2**30
    log(f"{tag} launches {launches} ("
        + ", ".join(f"{per} a step" for _, per in kernels.values())
        + "); parameters changed"
        + ("; every launch of a two-route kernel took the tensor-core "
           "route"
           if any(hasattr(fn, "wgmma_launches") for fn, _ in kernels.values())
           else ""))
    log(f"{tag} " + json.dumps({
        "arch": cfg.name, "layers": cfg.n_layers, "batch": B, "seq": S,
        "remat": cfg.remat, "step_s": secs, "steady_step_s": steady,
        "tokens_per_s": B * S / steady, "peak_gib": peak}))
    if profile:
        profile_train_step(torch, step, params, opt, batches[-1],
                           KERNEL_SYMBOLS[arch])
    del params, opt, batches, before
    free_card(torch)
    return launches


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
    phase_build(torch)
    if args.ring_splits:
        ring_split_sweep(torch)
        return 0
    if args.ssd_head_sets:
        ssd_head_set_sweep(torch)
        return 0
    if args.lru_tiles:
        lru_tile_sweep(torch)
        return 0
    rows = [phase_ring_kernel(torch)]
    flash = phase_flash_kernels(torch)
    rows += [flash["fwd"], flash["bwd"]]
    rows.append(phase_ssd_kernel(torch))
    rows.append(phase_lru_kernel(torch))
    for row in rows:
        row["launches"] = 0
    if not args.kernels_only:
        free_card(torch)
        rows[0]["launches"] = phase_engine(torch, ENGINE_ARCH,
                                           args.profile)["ring"]
        phase_engine_reference(torch, ENGINE_ARCH, [
            ("kernel", "cuda", "blocked"),
            ("plain attention", "cuda", "dense")])
        free_card(torch)
        n_dense = REGISTRY[TRAIN_ARCH].n_layers
        flash_launches = phase_train(
            torch, TRAIN_ARCH, TRAIN_B, TRAIN_REMAT,
            # the forward runs twice a layer under remat
            {"flash_attention_fwd": (fa_ops.flash_attention, n_dense * (
                1 if TRAIN_REMAT == "none" else 2)),
             "flash_attention_bwd": (fa_ops.flash_attention_bwd, n_dense)},
            {"wq[0]": lambda p: p["layers"]["attn"]["wq"][0],
             "embed[:4096]": lambda p: p["embed"][:4096]}, args.profile)
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
            args.profile)["ssd_scan"]
        phase_trainer(torch, SSM_ARCH, ssd_ops.ssd_scan)
        free_card(torch)
        phase_engine(torch, SSM_ARCH, args.profile)
        phase_engine_reference(torch, SSM_ARCH, [
            ("card", "cuda", "blocked"), ("CPU", "cpu", "blocked")])
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
            args.profile, S=HYBRID_S, layers=HYBRID_LAYERS)
        rows[4]["launches"] = hybrid["lru_scan"]
        rows[1]["hybrid_launches"] = hybrid["flash_attention_fwd"]
        rows[2]["hybrid_launches"] = hybrid["flash_attention_bwd"]
        phase_trainer(torch, HYBRID_ARCH, lru_ops.lru_scan)
        free_card(torch)
        # phase 8
        served = phase_engine(torch, HYBRID_ARCH, args.profile)
        rows[0]["hybrid_launches"] = served["ring"]
        rows[4]["serving_launches"] = served["lru"]
        phase_engine_reference(torch, HYBRID_ARCH, [
            ("card", "cuda", "blocked"), ("CPU", "cpu", "blocked")])
    ring_device_times(torch, rows[0])
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
