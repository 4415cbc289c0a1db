"""The port's serving engine on the card: CUDA-graph replay of the paged
steps, the storage-address check that guards it, the asynchronous swap
tier's in-flight copy, and the ring kernel at the verify step's widths.

* ``warm_steps`` captures every paged step as a CUDA graph; serving after
  it replays them.  Replay runs the same kernels at the same shapes as
  the eager steps, so tokens AND pool bytes are bit-identical to a cold
  engine's, in bf16, for the dense, SSM and hybrid families, and the card
  runs the same serving kernels (counted by torch.profiler: the ring
  kernel and, on the hybrid, the RG-LRU one-chunk kernel).
* A replay refuses to run once a storage leaf has been replaced: the
  graph would read the old address.
* An issued spill whose copy has not landed keeps its pages: the poll
  lands nothing, the fence waits and lands it.
* The speculative verify step calls the ring kernel at C = spec_k + 1
  (4 and 5 here), not at the chunk width, at both serving models' heads.
* The scan chunk step replays bit for bit too, and whole-prompt prefill
  (the eager engine's) matches the CPU in float32 and launches the flash,
  SSD and RG-LRU kernels once a layer and prompt.

The graphs and the kernels have no CPU mode, so the tests are marked
``gpu`` and skip where no CUDA device is visible.  This file imports
neither JAX nor the JAX package:

    PYTHONPATH=src python3 -m pytest -q --noconftest -m gpu \\
        tests/test_torch_serving_gpu.py
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.configs import REGISTRY, reduced_config
from repro_torch.core.topology import ChipletTopology
from repro_torch.kernels.flash_attention import ops, ref
from repro_torch.models import decode as dec
from repro_torch.models.params import init_params
from repro_torch.serving.engine import EngineConfig, ServeEngine
from repro_torch.serving.kvpool import KVBlockPool

# the tolerance of the JAX package's bf16 kernel tests
BF16_TOL = 2e-2


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: CUDA graphs, the pool's copy "
                    "stream and the ring kernel have no CPU mode")
    return torch.device("cuda")


def bf16_config(arch):
    """The reduced config in bf16, with 64-wide heads (the ring kernel's
    tensor-core route at a head dim the model path uses)."""
    cfg = reduced_config(REGISTRY[arch])
    wide = {"d_model": 256, "head_dim": 64} if cfg.n_heads else {}
    return dataclasses.replace(cfg, param_dtype="bfloat16",
                               compute_dtype="bfloat16", **wide)


# the device symbols of the serving steps' hand-written kernels
SERVING_KERNELS = ("ring_wgmma_kernel", "ring_combine_kernel", "lru_direct")


def serve(cfg, params, warm, **ecfg):
    """Serve five requests (two sharing a preamble) under torch.profiler,
    after ``warm_steps`` when ``warm``: (the engine, the calls of each
    serving kernel the card ran, graph replays included)."""
    eng = ServeEngine(cfg, ChipletTopology(1, 2, 1), EngineConfig(
        max_batch=4, max_len=64, pool_streams=4, **ecfg), params=params)
    if warm:
        assert eng.warm_steps() > 0
    rng = np.random.default_rng(0)
    preamble = rng.integers(2, cfg.vocab, size=32)
    prompts = [np.concatenate([preamble, rng.integers(2, cfg.vocab, size=n)])
               if i < 2 else rng.integers(2, cfg.vocab, size=n)
               for i, n in enumerate((7, 19, 3, 26, 11))]
    for p, m in zip(prompts, (9, 14, 6, 12, 8)):
        eng.submit(p, max_new=m)
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CUDA]) as prof:
        eng.run_until_done()
        torch.cuda.synchronize()
    assert all(r.done for r in eng.submitted)
    calls = dict.fromkeys(SERVING_KERNELS, 0)
    for e in prof.key_averages():
        for name in SERVING_KERNELS:
            if name in e.key and str(e.device_type).endswith("CUDA"):
                calls[name] += e.count
    return eng, calls


def bits(t):
    return t.view({2: torch.int16, 4: torch.int32}[t.element_size()])


def live_bytes(eng):
    """Every pool leaf but the null block and null state slot (which the
    warm-up's null rows write)."""
    out = []
    for leaf, s in zip(dec.tree_leaves(eng.pool.storage, eng.pool.spec),
                       eng.pool.spec.leaves):
        out.append(leaf.narrow(s.batch_axis, 1,
                               leaf.shape[s.batch_axis] - 1).cpu())
    return out


@pytest.mark.gpu
@pytest.mark.parametrize("spec", ["off", "ngram"])
@pytest.mark.parametrize("arch", ["llama3-8b", "mamba2-780m",
                                  "recurrentgemma-9b"])
def test_graph_replay_bit_identical_to_eager(cuda, arch, spec):
    cfg = bf16_config(arch)
    params = init_params(cfg, torch.Generator(cuda).manual_seed(0),
                         device=cuda)
    w0 = ops.ring_chunk_attention.wgmma_launches
    cold, cold_calls = serve(cfg, params, warm=False, spec_decode=spec)
    direct = ops.ring_chunk_attention.wgmma_launches - w0
    warm, warm_calls = serve(cfg, params, warm=True, spec_decode=spec)
    assert [r.generated for r in warm.submitted] == \
        [r.generated for r in cold.submitted]
    for a, b in zip(live_bytes(cold), live_bytes(warm)):
        assert torch.equal(bits(a), bits(b))
    replays = warm.graph_replays()
    assert replays and sum(replays.values()) > 0
    assert cold.graph_replays() == {}
    # the card ran the same kernels inside the graphs as eagerly: counted
    # by the profiler, not by the wrappers (which count Python calls)
    assert warm_calls == cold_calls
    if cfg.family != "ssm":
        assert cold_calls["ring_wgmma_kernel"] == direct > 0
    if cfg.family == "hybrid":
        assert warm_calls["lru_direct"] > 0


@pytest.mark.gpu
@pytest.mark.parametrize("arch", ["llama3-8b", "mamba2-780m",
                                  "recurrentgemma-9b"])
def test_scan_graph_replay_bit_identical_to_eager(cuda, arch):
    """The per-token scan chunk step (``prefill_mode="scan"``: C
    single-token steps with per-stream save and restore, no host sync)
    captured as a CUDA graph gives a cold scan engine's tokens and pool
    bytes bit for bit."""
    cfg = bf16_config(arch)
    params = init_params(cfg, torch.Generator(cuda).manual_seed(0),
                         device=cuda)
    cold, _ = serve(cfg, params, warm=False, prefill_mode="scan")
    warm, _ = serve(cfg, params, warm=True, prefill_mode="scan")
    assert [r.generated for r in warm.submitted] == \
        [r.generated for r in cold.submitted]
    for a, b in zip(live_bytes(cold), live_bytes(warm)):
        assert torch.equal(bits(a), bits(b))
    assert sum(n for (k, _, _), n in warm.graph_replays().items()
               if k == "chunk") > 0


@pytest.mark.gpu
@pytest.mark.parametrize("arch", ["llama3-8b", "mamba2-780m",
                                  "recurrentgemma-9b"])
def test_prefill_on_the_card(cuda, arch):
    """Whole-prompt prefill on the card: in float32 its logits and cache
    equal the CPU's within 1e-4 (a prompt past the ring, and for the SSD
    scan no multiple of its chunk); in bf16 the eager engine launches the
    flash forward once an attention layer, the SSD scan once an SSD layer
    and the RG-LRU scan once a recurrent layer for each prompt, on the
    tensor-core routes, and no ring kernel."""
    from repro_torch.kernels.rglru_scan import ops as lru_ops
    from repro_torch.kernels.ssd_scan import ops as ssd_ops
    cfg = reduced_config(REGISTRY[arch])
    params = init_params(cfg, torch.Generator().manual_seed(0),
                         device="cpu")
    toks = torch.from_numpy(np.random.default_rng(1).integers(
        2, cfg.vocab, size=(2, 45)).astype(np.int32))
    want_l, want_c = dec.prefill(params, cfg, toks, max_len=40)
    got_l, got_c = dec.prefill(
        _to(params, cuda), cfg, toks.to(cuda),
        max_len=40)
    spec = dec.cache_view_specs(cfg, 40)
    torch.testing.assert_close(got_l.cpu(), want_l, rtol=1e-4, atol=1e-4)
    for a, b in zip(dec.tree_leaves(want_c, spec),
                    dec.tree_leaves(got_c, spec)):
        torch.testing.assert_close(b.cpu(), a, rtol=1e-4, atol=1e-4)
    bcfg = bf16_config(arch)
    bparams = init_params(bcfg, torch.Generator(cuda).manual_seed(0),
                          device=cuda)
    fns = (ops.flash_attention, ssd_ops.ssd_scan, lru_ops.lru_scan,
           ops.ring_chunk_attention)
    before = [(f.launches, getattr(f, "wgmma_launches", 0)) for f in fns]
    eng, _ = serve(bcfg, bparams, warm=False, lazy=False)
    n = len(eng.submitted)
    got = [(f.launches - b0, getattr(f, "wgmma_launches", 0) - b1)
           for f, (b0, b1) in zip(fns, before)]
    types = bcfg.layer_types()
    assert got[0] == (types.count("attn") * n,) * 2
    assert got[1] == (types.count("ssd") * n,) * 2
    assert got[2][0] == types.count("rec") * n
    assert got[3] == (0, 0)
    assert eng.counters.totals["prefills"] == n
    assert not eng.counters.totals.get("chunk_ticks", 0)


def _to(tree, device):
    if isinstance(tree, dict):
        return {k: _to(v, device) for k, v in tree.items()}
    return tree.to(device)


@pytest.mark.gpu
def test_replay_refuses_a_moved_storage_leaf(cuda):
    cfg = bf16_config("llama3-8b")
    eng = ServeEngine(cfg, ChipletTopology(1, 1, 1), EngineConfig(
        max_batch=2, max_len=32, pool_streams=2), device=cuda)
    eng.warm_steps()
    k = eng.pool.storage["layers"]["k"]
    eng.pool.storage["layers"]["k"] = k.clone()
    with pytest.raises(RuntimeError, match="moved since the step's CUDA "
                                           "graph was captured"):
        eng._paged_decode([None], np.zeros((1, 1), np.int32),
                          np.zeros((1,), np.int32))


@pytest.mark.gpu
def test_inflight_spill_keeps_its_pages_until_it_lands(cuda):
    cfg = bf16_config("llama3-8b")
    pool = KVBlockPool(cfg, n_domains=1, max_len=64, blocks_per_domain=8,
                       states_per_domain=2, device=cuda)
    # one spill first, so every kernel of the path is loaded (a kernel's
    # first launch loads its module, which waits for the whole card)
    warm = pool.reserve(0, 32, first_tokens=32)
    warm.used_pages = len(warm.blocks)
    pool.spill(warm)
    pool.free(warm)
    t = pool.reserve(0, 64, first_tokens=64)
    t.used_pages = len(t.blocks)
    for leaf in pool.storage["layers"].values():
        leaf[:, t.blocks] = 1.5
    free0 = pool.free_blocks(0)
    landed = []
    pool.on_free(lambda: landed.append(pool.free_blocks(0)))
    # keep the copy stream busy, so the copy queued behind the sleep cannot
    # have landed at the first poll
    torch.cuda.synchronize()
    with torch.cuda.stream(pool._copy_stream):
        torch.cuda._sleep(2_000_000_000)
    assert pool.spill_issue(t) == len(t.blocks)
    assert not pool._inflight[0].ready()
    assert pool.spill_poll() == 0
    assert t.inflight and t.spill is None and t.blocks
    assert pool.free_blocks(0) == free0 and not landed
    pool.audit([t])
    assert pool.spill_fence() == 1
    assert pool.counters.totals["kv_fence_waits"] == 1
    assert not t.inflight and t.spill is not None and not t.blocks
    assert landed == [free0 + 4]
    pool.audit([t])
    for view in t.spill.data:
        assert bool((view.float() == 1.5).all())
    assert pool.restore_prefetch(t)
    assert pool.restore(t)
    for leaf in pool.storage["layers"].values():
        assert bool((leaf[:, t.blocks].float() == 1.5).all())
    pool.free(t)
    pool.audit([])


@pytest.mark.gpu
@pytest.mark.parametrize("C", [4, 5])
@pytest.mark.parametrize("B", [1, 8])
@pytest.mark.parametrize("Hq,Hkv,dh,window", [
    (32, 8, 128, 0), (16, 1, 256, 2048)], ids=["llama3-8b",
                                               "recurrentgemma-9b"])
def test_verify_width_ring_call(cuda, B, C, Hq, Hkv, dh, window):
    """The ring call at the verify step's width against the plain version,
    at both serving models' heads over a 1024-slot ring: llama3-8b (32
    query heads over 8 kv heads of 128) and recurrentgemma-9b (16 over one
    of 256, window 2048: G C = 64 or 80 query rows, one or two wgmma
    tiles)."""
    W = 1024
    gen = torch.Generator(cuda).manual_seed(B * 10 + C + dh)

    def rnd(*shape):
        return torch.randn(shape, generator=gen, device=cuda).to(
            torch.bfloat16)

    q, k, v = rnd(B, C, Hq, dh), rnd(B, C, Hkv, dh), rnd(B, C, Hkv, dh)
    kc, vc = rnd(B, W, Hkv, dh), rnd(B, W, Hkv, dh)
    pos = torch.tensor([300 + 97 * b for b in range(B)], dtype=torch.int32,
                       device=cuda)
    n = torch.tensor([C - b % 2 for b in range(B)], dtype=torch.int32,
                     device=cuda)
    w0 = ops.ring_chunk_attention.wgmma_launches
    got = ops.ring_chunk_attention(q, k, v, kc, vc, pos, n, window=window)
    assert ops.ring_chunk_attention.wgmma_launches == w0 + 1
    want = ref.ring_chunk_attention_ref(q.float(), k.float(), v.float(),
                                        kc.float(), vc.float(), pos, n,
                                        window=window)
    active = torch.arange(C, device=cuda)[None, :] < n[:, None].long()
    err = (got.float() - want).abs()[active]
    assert float(err.max()) <= BF16_TOL
