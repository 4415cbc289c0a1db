"""The port's engine on the per-token scan chunk path
(``prefill_mode="scan"``) against the JAX package, on the CPU: the
scenarios of ``tests/test_continuous_batching.py`` that run the scan
beside the fused path, and speculative decoding on the scan
(``tests/test_spec_decode.py``), on reduced models in float32 with the
JAX engine's weights carried across.

Each scan engine gives the JAX scan engine's tokens and every counter
exactly, and the fused engine's tokens; a scan chunk tick counts C model
steps, a fused one 1."""
import numpy as np
import pytest

from torch_engine_twins import (PartialDrafter, Twins, configs,
                                same_counters, serve, served_pair)

FAMILIES = ("llama3-8b", "mamba2-780m", "recurrentgemma-9b")


@pytest.mark.parametrize("arch", FAMILIES)
def test_scan_prefill_counts_c_model_steps_per_chunk_tick(arch):
    """``test_parallel_prefill_one_model_step_per_chunk_tick``: the scan
    and fused engines give one set of tokens, each the JAX engine's with
    its counters; ``prefill_model_steps`` is C a chunk tick on the scan,
    1 on the fused path, and the scan's chunk path reads no chunk
    kernel."""
    jcfg, _ = configs(arch)
    rng = np.random.default_rng(9)
    prompts = [rng.integers(2, jcfg.vocab, size=s) for s in (30, 20, 5)]
    max_new = [4, 6, 3]
    outs = {}
    for pm in ("parallel", "scan"):
        je, te, jt, tt = served_pair(arch, prompts, max_new, groups=2,
                                     prefill_mode=pm)
        same_counters(je, te)
        assert tt == jt
        kv, jkv = te.kv_stats(), je.kv_stats()
        assert kv["chunk_ticks"] > 0
        expect = 1 if pm == "parallel" else te._chunk
        assert kv["prefill_model_steps"] == expect * kv["chunk_ticks"]
        for k in ("prefill_model_steps", "chunk_kernel",
                  "prefill_chunk_bytes", "prefill_score_bytes"):
            assert kv[k] == jkv[k], k
        outs[pm] = tt
    assert outs["parallel"] == outs["scan"]
    assert te._chunk_kernel == "dense"


@pytest.mark.parametrize("arch", ["llama3-8b", "recurrentgemma-9b"])
def test_parallel_mid_chunk_park_token_identity(arch):
    """A stream that parks mid-prompt (dense: its domain has pages for one
    stream; a hybrid pool holds a whole ring a state slot, so it does not
    park) resumes at its chunk cursor on both chunk paths; they and the
    eager engine give one set of tokens, each engine the JAX engine's,
    counters included."""
    jcfg, _ = configs(arch)
    rng = np.random.default_rng(3)
    prompts = [rng.integers(2, jcfg.vocab, size=30) for _ in range(2)]
    max_new = [4, 4]
    outs = {}
    for name, opts in (("parallel", dict(prefill_mode="parallel")),
                       ("scan", dict(prefill_mode="scan")),
                       ("eager", dict(lazy=False))):
        je, te, jt, tt = served_pair(arch, prompts, max_new, groups=1,
                                     max_batch=2, **opts)
        same_counters(je, te)
        assert tt == jt
        assert te.pool.occupancy() == 0.0
        if name != "eager" and not te.pool.has_state:
            assert te.counters.totals["kv_mid_decode_parks"] >= 1, name
        outs[name] = tt
    assert outs["parallel"] == outs["scan"] == outs["eager"]


def test_scan_chunk_spanning_pages_token_identity():
    """Chunks above and below the page size (6 and 24 tokens on 16-token
    pages) on both chunk paths: one set of tokens, the scan engine's equal
    to the JAX scan engine's with its counters."""
    jcfg, _ = configs("llama3-8b")
    rng = np.random.default_rng(11)
    prompts = [rng.integers(2, jcfg.vocab, size=s) for s in (28, 9)]
    max_new = [3, 5]
    base = None
    for chunk in (6, 24):
        for pm in ("parallel", "scan"):
            je, te, jt, tt = served_pair("llama3-8b", prompts, max_new,
                                         groups=1, prefill_chunk=chunk,
                                         prefill_mode=pm)
            same_counters(je, te)
            assert tt == jt
            base = base or tt
            assert tt == base, (chunk, pm)


@pytest.mark.parametrize("arch", FAMILIES)
def test_spec_on_the_scan_path(arch):
    """Speculative decoding on the scan (the JAX engine's
    ``prefill_mode="scan"`` spec engine): one right draft token then
    garbage drafts, accepts and rolls back; the port's tokens and counters
    equal the JAX spec engine's, and its tokens the spec-off engine's."""
    tw = Twins(arch, prefill_mode="scan")
    rng = np.random.default_rng(3)
    prompts = [rng.integers(2, tw.jcfg.vocab, size=s) for s in (7, 5)]
    max_new = [14, 11]
    base = serve(tw.port(spec_decode="off"), prompts, max_new)
    te = tw.port()
    for eng in (tw.jax, te):
        eng.drafter = PartialDrafter(prompts, base, tw.jcfg.vocab, good=1)
    assert serve(tw.jax, prompts, max_new) == base
    assert serve(te, prompts, max_new) == base
    same_counters(tw.jax, te)
    kv, jkv = te.kv_stats(), tw.jax.kv_stats()
    assert kv["spec_rollbacks"] > 0 and kv["spec_tokens_accepted"] > 0
    for k in ("spec_decode", "spec_accept_rate", "spec_rejected_bytes",
              "spec_rollback_bytes", "prefill_model_steps"):
        assert kv[k] == jkv[k], k
