"""The port's ``ServeEngine`` on the VLM family against the JAX package's,
on the CPU: reduced qwen2-vl-2b in float32, the JAX engine's weights
carried across by ``from_reference``, the same schedule in both.

Both engines serve a VLM text-only on the lazy paged path: the chunk and
decode steps broadcast each token's position to the three M-RoPE
components, where M-RoPE is RoPE.  Each scenario gives the JAX engine's
tokens and every counter: both evict modes under pool pressure, the scan
and dense chunk paths, a prefix-sharing hit, the engine's own n-gram
speculative decoding, the asynchronous swap tier and ``warm_steps``.

Where the JAX engine fails, the port refuses at construction: a VLM with
``lazy=False`` or ``paged=False`` (the JAX engine's whole-prompt prefill
gets no vision extras: ``KeyError: 'vision_embeds'``) and an
encoder-decoder model (no JAX engine path takes source frames)."""
import numpy as np
import pytest

from repro.configs import REGISTRY, reduced_config
from repro.core.topology import ChipletTopology as JTopology
from repro.serving.engine import EngineConfig as JEngineConfig
from repro.serving.engine import ServeEngine as JServeEngine
from repro_torch.configs import REGISTRY as T_REGISTRY
from repro_torch.configs import reduced_config as t_reduced
from repro_torch.core.topology import ChipletTopology as TTopology
from repro_torch.serving.engine import EngineConfig as TEngineConfig
from repro_torch.serving.engine import ServeEngine as TServeEngine
from test_torch_async_swap import drain, settle
from torch_engine_twins import Twins, configs, same_counters, serve, \
    served_pair, tokens

ARCH = "qwen2-vl-2b"
JCFG, TCFG = configs(ARCH)


@pytest.mark.parametrize("evict_mode", ["swap", "restart"])
def test_lazy_engine_under_pool_pressure(evict_mode):
    """One stream's worth of pages a domain and long generations: parked
    streams spill to the host tier and come back (``swap``), or are
    evicted and recomputed (``restart``), to the JAX engine's tokens and
    counters."""
    rng = np.random.default_rng(0)
    prompts = [rng.integers(2, JCFG.vocab, size=int(n)) for n in (4, 9, 6)]
    max_new = [16, 14, 15]
    jeng, teng, jt, tt = served_pair(ARCH, prompts, max_new, groups=1,
                                     max_batch=3, evict_mode=evict_mode)
    same_counters(jeng, teng)
    assert tt == jt and [len(t) for t in tt] == max_new
    c = teng.counters.totals
    if evict_mode == "swap":
        assert c["kv_spills"] >= 1 and c.get("recompute_tokens", 0) == 0
    else:
        assert c["kv_evictions"] >= 1 and c["recompute_tokens"] > 0
    assert teng.pool.occupancy() == 0.0
    teng.pool.audit([])


@pytest.mark.parametrize("mode", [dict(prefill_mode="scan"),
                                  dict(chunk_kernel="dense")],
                         ids=["scan", "dense"])
def test_chunk_paths(mode):
    """The per-token scan chunk path and the fused path's dense attention:
    the JAX engine's tokens and counters."""
    rng = np.random.default_rng(2)
    prompts = [rng.integers(2, JCFG.vocab, size=s) for s in (11, 5, 19)]
    max_new = [6, 9, 5]
    jeng, teng, jt, tt = served_pair(ARCH, prompts, max_new, **mode)
    same_counters(jeng, teng)
    assert tt == jt and [len(t) for t in tt] == max_new


def test_prefix_sharing_hit():
    """A resident 32-token preamble is attached by the two later requests
    that share it: the same hits, skipped tokens and generated tokens."""
    tw = Twins(ARCH, spec="off", max_batch=2, max_len=64, pool_streams=3,
               share=True)
    rng = np.random.default_rng(1)
    pre = rng.integers(2, JCFG.vocab, size=32)
    first = np.concatenate([pre, rng.integers(2, JCFG.vocab, size=6)])
    later = [np.concatenate([pre, rng.integers(2, JCFG.vocab, size=n)])
             for n in (9, 17)]
    te = tw.port()
    for eng in (tw.jax, te):
        serve(eng, [first], [5])
        serve(eng, later, [8, 8])
    assert [r.generated for r in te.submitted] == \
        [r.generated for r in tw.jax.submitted]
    assert te.counters.totals["kv_prefix_hits"] > 0
    same_counters(tw.jax, te)


def test_ngram_speculative_decoding():
    """The engine's own n-gram drafter on prompts of repeated motifs (a
    schedule on which the random weights' continuations repeat an n-gram,
    so the drafter drafts): the port drafts, accepts and verifies exactly
    as the JAX engine, and both give the spec-off engine's tokens."""
    tw = Twins(ARCH, spec_k=3)
    rng = np.random.default_rng(7)
    prompts = [np.tile(rng.integers(2, JCFG.vocab, size=n), 4)
               for n in (4, 6)]
    max_new = [12, 10]
    base = serve(tw.port(spec_decode="off"), prompts, max_new)
    te = tw.port()
    assert serve(te, prompts, max_new) == base
    assert serve(tw.jax, prompts, max_new) == base
    same_counters(tw.jax, te)
    kv = te.kv_stats()
    assert kv["spec_tokens_drafted"] > 0 and kv["spec_verify_forwards"] > 0


def test_async_swap_and_warm_steps():
    """The asynchronous swap tier on one stream's pages a domain: spills
    issued and landed, nothing recomputed, the JAX async engine's tokens
    and counters.  Then an engine warmed by ``warm_steps`` serves the same
    tokens (``test_torch_warm_steps.py`` holds the number of step calls to
    the JAX engine's; the grid does not depend on the family)."""
    tw = Twins(ARCH, spec="off", max_len=32, pool_streams=1, max_batch=4,
               async_swap=True)
    settle(tw.jax.pool)
    rng = np.random.default_rng(5)
    prompts = [rng.integers(2, JCFG.vocab, size=s) for s in (7, 12, 4, 9)]
    te = tw.port()
    for eng in (tw.jax, te):
        for p in prompts:
            eng.submit(p, max_new=14)
    jc, tc = tw.jax.run_until_done()["counters"], drain(te)
    assert tokens(te) == tokens(tw.jax)
    assert tc["kv_spill_issues"] >= 1 and tc["kv_spills"] >= 1
    assert tc.get("recompute_tokens", 0) == 0
    same_counters(tw.jax, te)
    assert jc["kv_spills"] == tc["kv_spills"]
    warm = tw.port()
    assert warm.warm_steps() > 0
    assert serve(warm, prompts, [14] * 4) == tokens(te)


@pytest.mark.parametrize("option", ["lazy", "paged"])
def test_eager_and_monolith_vlm_engines_raise(option):
    """``lazy=False`` and ``paged=False``: the JAX engine builds and then
    fails at its first admission (``KeyError: 'vision_embeds'``, its
    whole-prompt prefill gets no extras); the port refuses at
    construction with a ``ValueError`` that says why."""
    opts = dict(max_batch=2, max_len=32, adaptive=False, **{option: False})
    jeng = JServeEngine(JCFG, JTopology(1, 1, 1), JEngineConfig(**opts),
                        seed=0)
    jeng.submit(np.arange(2, 12, dtype=np.int32), 3)
    with pytest.raises(KeyError, match="vision_embeds"):
        jeng.run_until_done()
    with pytest.raises(ValueError, match="no vision extras"):
        TServeEngine(TCFG, TTopology(1, 1, 1), TEngineConfig(**opts),
                     device="cpu")


@pytest.mark.parametrize("lazy", [True, False], ids=["lazy", "eager"])
def test_encdec_engine_raises(lazy):
    """An encoder-decoder model: the JAX engine fails serving its first
    request (lazy: a zero-length source, ``ZeroDivisionError``; eager: its
    prefill gets no ``frame_embeds``, ``KeyError``); the port refuses at
    construction, naming the missing serving path."""
    jcfg = reduced_config(REGISTRY["seamless-m4t-large-v2"])
    opts = dict(max_batch=2, max_len=32, adaptive=False, lazy=lazy)
    with pytest.raises(ZeroDivisionError if lazy else KeyError):
        jeng = JServeEngine(jcfg, JTopology(1, 1, 1), JEngineConfig(**opts),
                            seed=0)
        jeng.submit(np.arange(2, 12, dtype=np.int32), 3)
        jeng.run_until_done()
    with pytest.raises(ValueError, match="no encoder-decoder serving path"):
        TServeEngine(t_reduced(T_REGISTRY["seamless-m4t-large-v2"]),
                     TTopology(1, 1, 1), TEngineConfig(**opts), device="cpu")
