#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

    python3 chip_smoke.py              # all phases, one card
    python3 chip_smoke.py --profile    # + where phase 3's time goes

Phases (any error fails the run with a non-zero exit):

1. Build every kernel from the sources in this checkout and print the
   card's name and power limit.  TF32 is switched off for float32 matmuls
   and convolutions, so float32 references are full float32.
2. Hold each kernel against its plain PyTorch version on the card, at the
   serving path's shape and at the edge geometries (ring wrap, a chunk
   wider than the ring, idle rows, GQA 8:1, window with softcap, a short
   history in a wide ring); time the kernel, the plain version and one
   PyTorch library call computing the same function, beside the least time
   the card could take for the bytes and operations this input needs.
3. Serve requests through the port's ``ServeEngine`` on llama3-8b at full
   width and depth (bf16, random weights from a seeded generator): every
   request must complete with its token budget, the ring kernel must have
   launched, prefix sharing must have hit, and the pool's audit must pass.
   Then, on a reduced llama3-8b in float32, the engine with the kernel
   must give the same tokens as the engine with the plain attention.
   ``--profile`` also times the two step kinds of the run and replays it
   on a fresh engine under torch.profiler and cProfile.

The last line is ``{"ok": true, "device": {...}}``; the line before it
lists every kernel with its launches, error and times.
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
            if "registers" in line or "spill" in line:
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


def phase_ring_kernel(torch):
    from repro_torch.kernels.flash_attention import ops, ref
    import torch.nn.functional as F

    row = {"name": "ring_chunk_attention", "route": "cuda",
           "source": "src/repro_torch/kernels/flash_attention/csrc/"
                     "ring_chunk_attention.cu",
           "replaces": "src/repro/kernels/flash_attention/kernel.py:220"}
    for (name, B, C, W, Hq, Hkv, dh, pos, nt, window, softcap,
         dtype) in RING_GEOMETRIES:
        ins = ring_inputs(torch, B, C, W, Hq, Hkv, dh, pos, nt, dtype,
                          seed=len(name))
        out = ops.ring_chunk_attention(*ins, window=window, softcap=softcap)
        torch.cuda.synchronize()
        want = ref.ring_chunk_attention_ref(*ins, window=window,
                                            softcap=softcap)
        # every row, active or not: the kernel's tile skip must leave even
        # the rows past n_tokens as the plain version has them
        o, w = out.float(), want.float()
        err = (o - w).abs()
        tol = TOL[dtype]
        max_err = float(err.max())
        bad = bool((err > tol + tol * w.abs()).any())
        if not torch.isfinite(o).all():
            raise AssertionError(f"{name}: kernel output not finite")
        # a row with no visible key (stream idle at pos 0) is exactly 0
        for b in range(B):
            if pos[b] == 0 and nt[b] == 0 and o[b].abs().max() != 0:
                raise AssertionError(f"{name}: idle row of stream {b} not 0")
        log(f"[ring] {name}: {dtype} B={B} C={C} W={W} Hq={Hq} Hkv={Hkv} "
            f"dh={dh} max_abs_err={max_err:.3e} (tol {tol})")
        if bad:
            raise AssertionError(f"{name}: kernel disagrees with the plain "
                                 f"version beyond {tol}")
        if name == "main_path":
            row["max_abs_err"] = max_err
            timing = ring_timing(torch, F, ops, ref, B, C, W, Hq, Hkv, dh,
                                 pos, nt, dtype)
            row.update(timing)
    return row


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


def ring_timing(torch, F, ops, ref, B, C, W, Hq, Hkv, dh, pos, nt, dtype):
    sets = [ring_inputs(torch, B, C, W, Hq, Hkv, dh, pos, nt, dtype,
                        seed=100 + i) for i in range(4)]
    kernel_ms = time_ms(torch, ops.ring_chunk_attention, sets)
    plain_ms = time_ms(torch, ref.ring_chunk_attention_ref, sets)
    mask = ref.visible(sets[0][5], sets[0][6], W, C)       # (B, C, W+C)
    G = Hq // Hkv

    def sdpa(q, kn, vn, kc, vc, p, n, _mask=mask[:, None]):
        # yardstick only: the port never calls it
        k = torch.cat([kc, kn], 1).transpose(1, 2)
        v = torch.cat([vc, vn], 1).transpose(1, 2)
        return F.scaled_dot_product_attention(
            q.transpose(1, 2), k, v, attn_mask=_mask, enable_gqa=G > 1)

    library_ms = time_ms(torch, sdpa, sets)
    n_bytes, flops = ring_work(torch, sets[0], mask)
    bound_bytes, bound_flops = n_bytes / PEAK_BYTES, flops / PEAK_FLOPS
    bound_ms = 1e3 * max(bound_bytes, bound_flops)
    log(f"[ring] kernel_ms={kernel_ms:.4f} plain_ms={plain_ms:.4f} "
        f"library_ms={library_ms:.4f} bound_ms={bound_ms:.6f} "
        f"({n_bytes} bytes, {flops:.0f} flops needed)")
    return {"ms": kernel_ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": "bytes" if bound_bytes >= bound_flops
            else "operations", "library_ms": library_ms}


# ---------------------------------------------------------------------------
# phase 3
# ---------------------------------------------------------------------------

def phase_engine(torch, profile: bool = False):
    from repro_torch.configs import REGISTRY
    from repro_torch.core.topology import ChipletTopology
    from repro_torch.kernels.flash_attention import ops
    from repro_torch.serving.engine import EngineConfig, ServeEngine

    cfg = REGISTRY["llama3-8b"]

    def engine():
        topo = ChipletTopology(n_pods=1, groups_per_pod=2, chips_per_group=1)
        ecfg = EngineConfig(max_batch=8, max_len=1024, pool_streams=8)
        return ServeEngine(cfg, topo, ecfg, seed=0)

    t0 = time.perf_counter()
    eng = engine()
    torch.cuda.synchronize()
    log(f"[engine] {cfg.name}: d_model={cfg.d_model} layers={cfg.n_layers} "
        f"heads={cfg.n_heads}/{cfg.n_kv_heads} d_ff={cfg.d_ff} "
        f"vocab={cfg.vocab} {cfg.param_dtype}; set-up "
        f"{time.perf_counter() - t0:.1f} s, "
        f"{torch.cuda.memory_allocated() / 2**30:.1f} GiB on the card")

    spent, timed = step_timers(torch, eng) if profile else (None, None)
    ops.ring_chunk_attention.launches = 0
    first, reqs, res, wall = serve(torch, eng, cfg, around=timed)
    launches = ops.ring_chunk_attention.launches

    for r in [first] + reqs:
        if not r.done or len(r.generated) != r.max_new:
            raise AssertionError(f"request {r.rid}: {len(r.generated)} of "
                                 f"{r.max_new} tokens")
        if not all(0 <= t < cfg.vocab for t in r.generated):
            raise AssertionError(f"request {r.rid}: token out of vocab")
    if launches <= 0:
        raise AssertionError("the ring kernel never launched on the main path")
    hits = res["counters"].get("kv_prefix_hits", 0.0)
    if hits <= 0:
        raise AssertionError("no prefix hit: the sharing path did not run")
    eng.pool.audit([r.table for r in eng.submitted if r.table is not None])
    st = ServeEngine.stats(reqs)
    c = res["counters"]
    log(f"[engine] {len(reqs)} requests, {st['tokens']} tokens in "
        f"{wall:.2f} s: {st['tokens'] / wall:.1f} tokens/s; "
        f"TTFT p50 {st['ttft_p50'] * 1e3:.1f} ms, "
        f"TPOT p50 {st['tpot_p50'] * 1e3:.1f} ms")
    log(f"[engine] ring kernel launches {launches} over "
        f"{int(c.get('chunk_ticks', 0))} chunk ticks ({cfg.n_layers} "
        f"layers), kv_prefix_hits {int(hits)}, relayouts "
        f"{len(res['relayouts'])}, pool audit ok")
    log("[engine] " + json.dumps({
        "layers": cfg.n_layers, "wall_s": wall, "tokens": st["tokens"],
        "tokens_per_s": st["tokens"] / wall,
        **{k: st[k] for k in ("ttft_p50", "ttft_p99", "tpot_p50",
                              "tpot_p99")},
        **{k: c.get(k, 0.0) for k in ("chunk_ticks", "split_ticks",
                                      "decode_steps")},
        "ring_launches": launches,
        "peak_gib": torch.cuda.max_memory_allocated() / 2**30}))
    if profile:
        steps = sum(t for t, _ in spent.values())
        log("[profile] " + json.dumps({
            "wall_s": wall, "chunk_step_s": spent["chunk"][0],
            "chunk_steps": spent["chunk"][1],
            "decode_step_s": spent["decode"][0],
            "decode_steps": spent["decode"][1],
            "outside_steps_s": wall - steps}))
        del eng
        gc.collect()                # the engine's tasks hold it in cycles
        torch.cuda.empty_cache()
        profile_replay(torch, engine(), cfg, wall)
    return launches


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


def profile_replay(torch, eng, cfg, main_wall):
    """Replay the main path on a fresh engine (same seed, same requests,
    so the same device work) under torch.profiler and cProfile: the card's
    kernels by device time, its busy time against the unprofiled run's
    wall, and the host functions that take the most time."""
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
        for dev, count, key in sorted(rows, reverse=True)[:15]:
            log(f"[profile]   {dev / 1e3:12.3f} ms {count:7d}x  {key[:90]}")
    out = io.StringIO()
    pstats.Stats(host, stream=out).sort_stats("tottime").print_stats(20)
    for line in out.getvalue().splitlines():
        if line.strip():
            log(f"[host] {line.rstrip()[:150]}")


def phase_engine_reference(torch):
    """Small input, float32: the engine's tokens with the kernel equal its
    tokens with the plain attention."""
    import numpy as np
    from repro_torch.configs import REGISTRY, reduced_config
    from repro_torch.core.topology import ChipletTopology
    from repro_torch.serving.engine import EngineConfig, ServeEngine

    cfg = reduced_config(REGISTRY["llama3-8b"])
    rng = np.random.default_rng(1)
    prompts = [rng.integers(2, cfg.vocab, size=int(n))
               for n in (5, 19, 33, 40)]
    outs = {}
    for kernel in ("blocked", "dense"):
        topo = ChipletTopology(n_pods=1, groups_per_pod=2, chips_per_group=1)
        eng = ServeEngine(cfg, topo, EngineConfig(
            max_batch=2, max_len=48, pool_streams=2, chunk_kernel=kernel),
            seed=0)
        reqs = [eng.submit(p, max_new=12) for p in prompts]
        eng.run_until_done()
        outs[kernel] = [r.generated for r in reqs]
    if outs["blocked"] != outs["dense"]:
        raise AssertionError("reduced llama3-8b: kernel and plain attention "
                             "give different tokens")
    log("[engine] reduced llama3-8b float32: kernel == plain attention "
        "tokens for 4 requests")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--kernels-only", action="store_true",
                    help="phases 1 and 2 only")
    ap.add_argument("--profile", action="store_true",
                    help="time phase 3's two step kinds, then replay it "
                         "on a fresh engine under torch.profiler and "
                         "cProfile")
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
    t0 = time.perf_counter()
    phase_build(torch)
    row = phase_ring_kernel(torch)
    row["launches"] = 0
    if not args.kernels_only:
        row["launches"] = phase_engine(torch, args.profile)
        phase_engine_reference(torch)
    log(f"[smoke] {time.perf_counter() - t0:.1f} s")
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    print(json.dumps({"kernels": [{k: row[k] for k in keys}]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
