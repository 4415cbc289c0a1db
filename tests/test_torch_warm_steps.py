"""``warm_steps`` and ``measured_model_steps`` in the port against the JAX
package, on the CPU.

``warm_steps`` prepares the same grid of paged steps the JAX package's
compiles — decode, the chunk widths, the verify width, at every pow-2
batch bucket, plus the page-copy buckets — on null rows, and returns the
same number of step calls; on the card it captures each as a CUDA graph
(``test_torch_serving_gpu.py``), here it runs them eagerly.  Serving after
it gives a cold engine's tokens.  ``measured_model_steps`` counts the
walks one call makes through the layer stack, where the JAX package
counts the layer scan's trips in the compiled HLO: one model step for
decode, chunk and verify alike on the parallel path, one a fed token on
the scan path."""
import functools

import numpy as np
import pytest

from torch_engine_twins import PartialDrafter, Twins, serve


@functools.lru_cache(maxsize=None)
def twins(arch, **kw):
    """One ``Twins`` a configuration for this file's tests, so that its
    JAX engine compiles its steps once; a test that serves on ``jax``
    builds its port engines fresh."""
    return Twins(arch, **kw)


@pytest.mark.parametrize("arch,spec,max_batch", [
    ("llama3-8b", "ngram", 2), ("llama3-8b", "off", 4),
    ("recurrentgemma-9b", "ngram", 2), ("mamba2-780m", "off", 2)])
def test_warm_steps_count_and_tokens(arch, spec, max_batch):
    """The port's ``warm_steps`` makes as many step calls as the JAX
    engine's on the same config, leaves the null rows' writes unread, and
    serving after it gives a cold engine's tokens (and the JAX engine's)."""
    tw = twins(arch, spec=spec, max_batch=max_batch)
    warm = tw.port()
    assert warm.warm_steps() == tw.jax.warm_steps() > 0
    rng = np.random.default_rng(12)
    prompts = [rng.integers(2, tw.jcfg.vocab, size=s) for s in (5, 7)]
    max_new = [8, 6]
    cold = serve(tw.port(), prompts, max_new)
    assert serve(warm, prompts, max_new) == cold
    assert serve(tw.jax, prompts, max_new) == cold
    assert warm.graph_replays() == {}


@pytest.mark.parametrize("arch", ["llama3-8b", "recurrentgemma-9b"])
def test_served_shapes_are_the_captured_ones(arch):
    """On the card ``warm_steps`` captures only the (kind, width) pairs
    ``_dispatches`` names.  Every step a speculative serve runs — chunks,
    decode, verify and, on the hybrid (whose state rolls back from a
    snapshot), the reapply chunk at the verify width — at every bucket it
    reaches, is one of them."""
    tw = Twins(arch, spec="ngram", spec_k=3, max_batch=4)
    rng = np.random.default_rng(3)
    prompts = [rng.integers(2, tw.jcfg.vocab, size=s) for s in (5, 21, 9)]
    max_new = [10, 7, 12]
    base = serve(tw.port(spec_decode="off"), prompts, max_new)
    eng = tw.port()
    eng.drafter = PartialDrafter(prompts, base, tw.tcfg.vocab)
    ran = set()
    run_step = eng._run_step

    def spy(kind, reqs, tokens, pos, n):
        ran.add((kind, tokens.shape[1], len(reqs)))
        return run_step(kind, reqs, tokens, pos, n)

    eng._run_step = spy
    assert serve(eng, prompts, max_new) == base
    assert eng.kv_stats()["spec_rollbacks"] > 0
    assert all(eng._dispatches(kind, W) for kind, W, _ in ran)
    want = {("decode", 1), ("chunk", eng._chunk), ("spec", eng._spec_w)}
    if eng.pool.has_state:
        want.add(("chunk", eng._spec_w))
    assert {(k, W) for k, W, _ in ran} == want
    assert {B for *_, B in ran} <= {1, 2, 4}
    assert not eng._dispatches("chunk", 8) and not eng._dispatches("decode", 4)


def test_warm_steps_custom_chunks_match_reference():
    """Chunk widths past the engine's chunk clamp to it, as in JAX."""
    tw = twins("llama3-8b", spec="ngram", max_batch=2)
    assert tw.port().warm_steps(chunks=(2, 16, 64)) == \
        tw.jax.warm_steps(chunks=(2, 16, 64))


@pytest.mark.parametrize("arch", ["llama3-8b", "mamba2-780m",
                                  "recurrentgemma-9b"])
def test_measured_model_steps(arch):
    """One layer-stack walk a call for decode, chunk (any width) and
    verify; the verify step needs speculation on; an unknown kind
    raises."""
    tw = twins(arch, spec="ngram", spec_k=3)
    eng = tw.port()
    assert eng.measured_model_steps("decode") == 1.0
    assert eng.measured_model_steps("chunk") == 1.0
    assert eng.measured_model_steps("chunk", C=8, B=2) == 1.0
    assert eng.measured_model_steps("spec") == 1.0
    off = tw.port(spec_decode="off")
    with pytest.raises(ValueError, match="spec_decode is off"):
        off.measured_model_steps("spec")
    with pytest.raises(ValueError, match="unknown step kind"):
        eng.measured_model_steps("prefill")


def test_measured_model_steps_match_reference_parallel():
    """The JAX package's HLO count on the same engine config agrees."""
    tw = twins("llama3-8b", spec="ngram", spec_k=3)
    eng = tw.port()
    for kind in ("decode", "chunk", "spec"):
        assert eng.measured_model_steps(kind) == \
            tw.jax.measured_model_steps(kind)


def test_measured_model_steps_match_reference_scan():
    """On the scan path a call walks the layer stack once a fed token: C
    for a chunk, the verify width for "spec", one for decode — the JAX
    package's HLO count on the same engine config."""
    tw = Twins("llama3-8b", spec="ngram", spec_k=3, prefill_mode="scan")
    eng = tw.port()
    assert eng.measured_model_steps("chunk", C=8) == 8.0
    assert eng.measured_model_steps("spec") == eng._spec_w == 4
    for kind, C in (("decode", None), ("chunk", None), ("chunk", 8),
                    ("spec", None)):
        assert eng.measured_model_steps(kind, C=C) == \
            tw.jax.measured_model_steps(kind, C=C)


def test_scan_path_is_not_ported():
    """The per-token scan path with n-gram speculation, refused until it
    was ported, now builds as the JAX engine does: ``warm_steps`` makes
    the JAX engine's number of step calls, and a warmed serve (the
    injected drafter drafts, accepts and rolls back) gives the JAX
    engine's tokens and a cold scan engine's."""
    tw = Twins("llama3-8b", spec="ngram", spec_k=3, prefill_mode="scan")
    rng = np.random.default_rng(12)
    prompts = [rng.integers(2, tw.jcfg.vocab, size=s) for s in (5, 19)]
    max_new = [9, 6]
    cold = serve(tw.port(), prompts, max_new)
    warm = tw.port()
    assert warm.warm_steps() == tw.jax.warm_steps() > 0
    for eng in (warm, tw.jax):
        eng.drafter = PartialDrafter(prompts, cold, tw.jcfg.vocab)
    assert serve(warm, prompts, max_new) == cold
    assert serve(tw.jax, prompts, max_new) == cold
    assert warm.kv_stats()["spec_rollbacks"] > 0


def test_warm_steps_of_the_eager_and_monolith_engines():
    """The eager engine builds no chunk step: the JAX package's
    ``warm_steps`` raises (AttributeError) and the port's refuses with a
    ValueError that says why.  The slot monolith has no paged steps:
    both return 0, and ``measured_model_steps`` refuses in both."""
    tw = Twins("llama3-8b", spec="off", lazy=False)
    with pytest.raises(AttributeError):
        tw.jax.warm_steps()
    with pytest.raises(ValueError, match="lazy=False"):
        tw.port().warm_steps()
    assert tw.port().measured_model_steps("decode") == \
        tw.jax.measured_model_steps("decode") == 1.0
    with pytest.raises(ValueError, match="no chunk ticks"):
        tw.port().measured_model_steps("chunk")
    mono = tw.jax_engine(paged=False)
    port = tw.port(paged=False)
    assert port.warm_steps() == mono.warm_steps() == 0
    for eng in (mono, port):
        with pytest.raises(ValueError, match="paged path"):
            eng.measured_model_steps("decode")
    assert port.kv_stats() == mono.kv_stats() == {}
