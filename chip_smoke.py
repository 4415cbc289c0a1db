#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

    python3 chip_smoke.py              # all phases, one card
    python3 chip_smoke.py --profile    # + where phase 3's and 4's time goes

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
2b. Hold the flash-attention forward and backward kernels against their
   plain versions (out, lse, dq, dk, dv, every element) at the training
   path's shape and on the ``FA_SWEEP`` geometries plus a ragged sequence,
   in float32 and bf16; time both kernels, their plain versions and
   ``scaled_dot_product_attention`` (forward, and forward + backward)
   beside the least time the card could take.
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

The last line is ``{"ok": true, "device": {...}}``; the line before it
lists every kernel with its launches (counted over its main path: phase
3 for the ring kernel, phase 4 for the flash kernels), error and times.
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
# phase 2b
# ---------------------------------------------------------------------------

# name, B, S, Hq, Hkv, dh, causal, window
FLASH_MAIN = ("main_path", 2, 2048, 24, 8, 128, True, 0)
FLASH_GEOMETRIES = [
    ("fa_sweep_0", 2, 128, 4, 2, 64, True, 0),
    ("fa_sweep_1", 1, 256, 4, 4, 32, True, 64),
    ("fa_sweep_2", 2, 128, 8, 2, 64, False, 0),
    ("fa_sweep_3", 1, 128, 2, 1, 128, True, 32),
    ("fa_sweep_4", 2, 64, 4, 1, 64, True, 0),
    ("fa_sweep_5", 1, 192, 6, 3, 32, True, 48),
    ("ragged_s200", 2, 200, 6, 2, 16, True, 0),
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

    rows = {
        "fwd": {"name": "flash_attention_fwd", "route": "cuda",
                "source": FLASH_SOURCE + "flash_attention_fwd.cu",
                "replaces": "src/repro/kernels/flash_attention/kernel.py:101"},
        "bwd": {"name": "flash_attention_bwd", "route": "cuda",
                "source": FLASH_SOURCE + "flash_attention_bwd.cu",
                "replaces": "src/repro/kernels/flash_attention/kernel.py:367"},
    }
    for geo in [FLASH_MAIN] + FLASH_GEOMETRIES:
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
            log(f"[flash] {what}: forward max_abs_err={fwd_err:.3e} "
                f"(tol {tf}), backward max_abs_err={bwd_err:.3e} (tol {tb})")
            if name == "main_path":
                rows["fwd"]["max_abs_err"] = fwd_err
                rows["bwd"]["max_abs_err"] = bwd_err
            del q, k, v, do, out, lse, want_out, want_lse, grads, want
    timing = flash_timing(torch, ops, ref, *FLASH_MAIN[1:])
    for part in ("fwd", "bwd"):
        rows[part].update(timing[part])
    return rows


def flash_work(B, S, Hq, Hkv, dh, causal, window, itemsize, mask):
    """Bytes and flops the functions need on this input: every input read
    once and every output written once; 4 * dh flops per visible (query,
    key) pair forward, and five products of 2 * dh backward (s
    recomputed, dp, dv, dq, dk: the least work; the two-kernel split does
    seven)."""
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

    # yardsticks only: the port never calls scaled_dot_product_attention
    def sdpa(q, k, v, do, out, lse):
        return F.scaled_dot_product_attention(
            q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
            is_causal=True, enable_gqa=Hq != Hkv)

    leaves = [tuple(t.detach().clone().requires_grad_(True) for t in s[:3])
              + (s[3].transpose(1, 2),) for s in sets]

    def sdpa_fwd_bwd(q, k, v, do_t):
        o = F.scaled_dot_product_attention(
            q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
            is_causal=True, enable_gqa=Hq != Hkv)
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
                     else "operations", "library_ms": t[part + "_lib"]}
        log(f"[flash] {part}: kernel_ms={t[part]:.4f} "
            f"plain_ms={t[part + '_plain']:.4f} "
            f"library_ms={t[part + '_lib']:.4f} "
            f"bound_ms={out[part]['bound_ms']:.6f} ({n_bytes} bytes, "
            f"{flops:.0f} flops needed)")
    log("[flash] library_ms is scaled_dot_product_attention(is_causal=True, "
        "enable_gqa=True): forward for flash_attention_fwd, forward + "
        "backward for flash_attention_bwd; bwd kernel_ms includes the "
        "wrapper's delta = rowsum(out * do)")
    return out


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


# ---------------------------------------------------------------------------
# phase 4
# ---------------------------------------------------------------------------

TRAIN_ARCH = "llama3.2-3b"
TRAIN_B, TRAIN_S, TRAIN_STEPS = 2, 2048, 4
TRAIN_REMAT = "none"


def free_card(torch):
    gc.collect()                # the engine's tasks hold it in cycles
    torch.cuda.empty_cache()


def phase_train(torch, profile: bool = False):
    """4 steps of the port's train step at full width and depth.  Returns
    the flash kernels' (forward, backward) launches over the 4 steps."""
    import dataclasses
    import math
    import shutil
    import tempfile
    from repro_torch.configs import REGISTRY
    from repro_torch.data.pipeline import (ShardedLoader, SyntheticCorpus,
                                           make_batch, write_corpus_shards)
    from repro_torch.kernels.flash_attention import ops
    from repro_torch.launch.steps import make_train_step
    from repro_torch.models.params import init_params, n_params
    from repro_torch.optim.adamw import AdamWConfig, init_opt_state

    cfg = dataclasses.replace(REGISTRY[TRAIN_ARCH], remat=TRAIN_REMAT)
    B, S = TRAIN_B, TRAIN_S
    t0 = time.perf_counter()
    gen = torch.Generator(device="cuda").manual_seed(0)
    params = init_params(cfg, gen, device="cuda")
    opt = init_opt_state(params)
    # warmup of one step so bf16 weights move from the first update
    step = make_train_step(cfg, AdamWConfig(warmup_steps=1))
    torch.cuda.synchronize()
    log(f"[train] {cfg.name}: layers={cfg.n_layers} d_model={cfg.d_model} "
        f"heads={cfg.n_heads}/{cfg.n_kv_heads} d_ff={cfg.d_ff} "
        f"vocab={cfg.vocab} {n_params(cfg)} params {cfg.param_dtype}, "
        f"remat={cfg.remat}; B={B} S={S}; set-up "
        f"{time.perf_counter() - t0:.1f} s, "
        f"{torch.cuda.memory_allocated() / 2**30:.3f} GiB on the card")
    probes = {"wq[0]": lambda p: p["layers"]["attn"]["wq"][0],
              "embed[:4096]": lambda p: p["embed"][:4096]}
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
    ops.flash_attention.launches = 0
    ops.flash_attention_bwd.launches = 0
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
        log(f"[train] step {i + 1}: loss {loss:.6f} grad_norm {gnorm:.6f} "
            f"lr {float(m['lr']):.3e} {secs[-1]:.6f} s"
            + (f", peak {torch.cuda.max_memory_allocated() / 2**30:.3f} "
               "GiB after the first step" if i == 0 else ""))
    launches = (ops.flash_attention.launches,
                ops.flash_attention_bwd.launches)
    per_fwd = cfg.n_layers * (1 if cfg.remat == "none" else 2)
    want = (TRAIN_STEPS * per_fwd, TRAIN_STEPS * cfg.n_layers)
    if launches != want:
        raise AssertionError(f"flash launches (fwd, bwd) {launches} over "
                             f"{TRAIN_STEPS} steps, expected {want}")
    for k, f in probes.items():
        if torch.equal(f(params), before[k]):
            raise AssertionError(f"{k} did not change in {TRAIN_STEPS} "
                                 "steps")
    steady = sum(secs[1:]) / len(secs[1:])
    peak = torch.cuda.max_memory_allocated() / 2**30
    log(f"[train] flash launches fwd {launches[0]} bwd {launches[1]} "
        f"({per_fwd} and {cfg.n_layers} a step); parameters changed")
    log("[train] " + json.dumps({
        "arch": cfg.name, "layers": cfg.n_layers, "batch": B, "seq": S,
        "remat": cfg.remat, "step_s": secs, "steady_step_s": steady,
        "tokens_per_s": B * S / steady, "peak_gib": peak}))
    if profile:
        profile_train_step(torch, step, params, opt, batches[-1])
    del params, opt, batches, before
    free_card(torch)
    return launches


def profile_train_step(torch, step, params, opt, batch):
    """One more step under torch.profiler: the card's busy time against
    the step's wall, the kernels by device time, the flash kernels'
    share."""
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
    flash = {n: sum(r[0] for r in rows if n in r[2]) / 1e6
             for n in ("flash_fwd_kernel", "flash_dq_kernel",
                       "flash_dkv_kernel")}
    log(f"[profile] train step: wall {wall:.6f} s profiled, device busy "
        f"{busy:.6f} s (idle share {1 - busy / wall:.4f})")
    log("[profile] flash kernels: " + ", ".join(
        f"{n} {t:.6f} s ({t / busy:.4f} of busy)" for n, t in flash.items()))
    for dev, count, key in sorted(rows, reverse=True)[:15]:
        log(f"[profile]   {dev / 1e3:12.3f} ms {count:7d}x  {key[:90]}")


# ---------------------------------------------------------------------------
# phase 4b
# ---------------------------------------------------------------------------

def phase_trainer(torch):
    """The port's Trainer end to end on a reduced llama3.2-3b in float32:
    checkpoint and resume on the card, and the card's losses against the
    CPU's (the plain attention)."""
    import dataclasses
    import os
    import shutil
    import tempfile
    from repro_torch.configs import REGISTRY, reduced_config
    from repro_torch.data.pipeline import (ShardedLoader, SyntheticCorpus,
                                           write_corpus_shards)
    from repro_torch.kernels.flash_attention import ops
    from repro_torch.models.params import init_params
    from repro_torch.optim.adamw import AdamWConfig
    from repro_torch.runtime.trainer import Trainer, TrainerConfig

    cfg = reduced_config(REGISTRY[TRAIN_ARCH])
    base = init_params(cfg, torch.Generator().manual_seed(0), device="cpu")

    def copy_to(device, tree=base):
        if isinstance(tree, dict):
            return {k: copy_to(device, v) for k, v in tree.items()}
        return tree.clone().to(device)

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
                           params=copy_to(device), device=device)

        f0 = ops.flash_attention.launches
        card = trainer("cuda", "ckpt_cuda")
        losses = card.run()["losses"]
        if ops.flash_attention.launches == f0:
            raise AssertionError("the Trainer on the card launched no "
                                 "flash kernel")
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
        f"tol 1e-5); CPU (plain attention) max abs err {cpu_err:.3e} "
        f"(tol 1e-4)")
    if resume_err > 1e-5:
        raise AssertionError("resumed losses differ from the first run")
    if cpu_err > 1e-4:
        raise AssertionError("the card's losses differ from the CPU's")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--kernels-only", action="store_true",
                    help="phases 1, 2 and 2b only")
    ap.add_argument("--profile", action="store_true",
                    help="time phase 3's two step kinds, then replay it "
                         "on a fresh engine under torch.profiler and "
                         "cProfile; profile one more training step in "
                         "phase 4")
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
    rows = [phase_ring_kernel(torch)]
    flash = phase_flash_kernels(torch)
    rows += [flash["fwd"], flash["bwd"]]
    for row in rows:
        row["launches"] = 0
    if not args.kernels_only:
        free_card(torch)
        rows[0]["launches"] = phase_engine(torch, args.profile)
        phase_engine_reference(torch)
        free_card(torch)
        rows[1]["launches"], rows[2]["launches"] = phase_train(
            torch, args.profile)
        phase_trainer(torch)
    log(f"[smoke] {time.perf_counter() - t0:.1f} s")
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    print(json.dumps({"kernels": [{k: row[k] for k in keys}
                                  for row in rows]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0

if __name__ == "__main__":
    sys.exit(main())
