"""Speculative decoding in the port against the JAX package, on the CPU:
the drafter, the verify step and the engine across the ported families.

The acceptance property of ``tests/test_spec_decode.py`` holds in the
port: a spec-enabled engine is token-identical to the spec-off engine, and
here also to the JAX spec engine, with the same spec and ``kv_spec_*``
counters — every counter, exactly.  Injected drafters (``torch_engine_twins``)
make drafting, acceptance and rollback certain; the n-gram drafter's own
run uses a prompt that holds every token id, so its trailing 1-gram always
recurs and a draft is certain every decode tick (the reference test's
repetition premise does not hold under this tree's jax: ROADMAP C).
The rollback edge cases are in ``test_torch_spec_rollback.py``."""
import numpy as np
import pytest
import torch

from repro.models import decode as JD
from repro.serving.spec import NGramDrafter as JNGramDrafter
from repro_torch.launch.steps import make_spec_verify_step
from repro_torch.models import decode as TD
from repro_torch.serving.spec import NGramDrafter, make_drafter
from torch_engine_twins import PartialDrafter, Twins, same_counters, serve

FAMILIES = ("llama3-8b", "mamba2-780m", "recurrentgemma-9b")


@pytest.mark.parametrize("arch", FAMILIES)
def test_spec_identity_across_families(arch):
    """One right token then garbage: every family drafts, accepts and
    rolls back, and the port's tokens and counters equal the JAX spec
    engine's; the tokens equal the port's spec-off engine's."""
    tw = Twins(arch)
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
    kv = te.kv_stats()
    assert kv["spec_tokens_drafted"] > 0
    assert kv["spec_tokens_accepted"] > 0
    assert kv["spec_rollbacks"] > 0
    assert kv["spec_verify_forwards"] > 0
    jkv = tw.jax.kv_stats()
    for k in ("spec_decode", "spec_accept_rate", "spec_rejected_bytes",
              "spec_rollback_bytes", "spec_ckpts", "spec_ckpt_pages",
              "spec_rollback_pages", "decode_forwards",
              "decode_row_forwards", "decode_committed_tokens"):
        assert kv[k] == jkv[k], k


def test_ngram_drafting_end_to_end():
    """The engine's own n-gram drafter, no injection: the prompt holds
    every token id of the vocabulary, so whatever the model emits, its
    trailing 1-gram recurs and the drafter proposes tokens every decode
    tick.  The port drafts exactly what the JAX engine drafts and stays
    token-identical to spec off."""
    tw = Twins("llama3-8b", max_len=560)
    rng = np.random.default_rng(3)
    V = tw.jcfg.vocab
    prompts = [rng.permutation(V), np.concatenate([rng.permutation(V)[:40],
                                                   rng.permutation(V)])]
    max_new = [14, 11]
    base = serve(tw.port(spec_decode="off"), prompts, max_new)
    te = tw.port()
    assert serve(te, prompts, max_new) == base
    assert serve(tw.jax, prompts, max_new) == base
    same_counters(tw.jax, te)
    kv = te.kv_stats()
    assert kv["spec_tokens_drafted"] > 0
    assert kv["spec_verify_forwards"] > 0


def _history(rng, n, vocab):
    """A random history with repeats: a few motifs, tiled and cut."""
    motifs = [list(rng.integers(0, vocab, size=int(rng.integers(1, 5))))
              for _ in range(3)]
    out = []
    while len(out) < n:
        out += motifs[int(rng.integers(0, 3))] if rng.random() < 0.7 \
            else [int(rng.integers(0, vocab))]
    return out[:n]


@pytest.mark.parametrize("seed", range(4))
def test_ngram_drafter_matches_reference(seed):
    """The port's n-gram drafter proposes what the JAX package's does on
    random histories, for every n-gram and draft length."""
    rng = np.random.default_rng(seed)

    class R:
        pass

    for _ in range(50):
        r = R()
        hist = _history(rng, int(rng.integers(1, 40)), 6)
        cut = int(rng.integers(0, len(hist) + 1))
        r.prompt, r.generated = hist[:cut], hist[cut:]
        for ngram in (1, 2, 3, 5):
            k = int(rng.integers(1, 6))
            assert NGramDrafter(max_ngram=ngram).draft(r, k) == \
                JNGramDrafter(max_ngram=ngram).draft(r, k)


def test_ngram_drafter_lookup():
    """The prompt-lookup rule itself: most recent prior occurrence of the
    trailing n-gram wins, longest n-gram first, no match -> no draft."""
    d = NGramDrafter(max_ngram=3)

    class R:
        prompt = [1, 2, 3, 9, 1, 2, 3]
        generated = []

    assert d.draft(R(), 2) == [9, 1]
    r2 = R()
    r2.prompt = [4, 5, 6, 7]
    assert d.draft(r2, 2) == []
    r3 = R()
    r3.prompt = [4, 5, 8, 5]
    assert d.draft(r3, 3) == [8, 5]
    assert isinstance(make_drafter("ngram", ngram=2), NGramDrafter)
    with pytest.raises(ValueError):
        make_drafter("model")
    with pytest.raises(ValueError):
        NGramDrafter(max_ngram=1, min_ngram=2)


@pytest.mark.parametrize("arch", ["llama3-8b", "recurrentgemma-9b"])
def test_verify_step_matches_reference(arch):
    """The verify step's per-position logits equal the JAX step's (f32,
    through the pool's gather), NEG_INF at and past ``n_tokens``, and the
    cache it writes equals JAX's, on the fused path and on the scan."""
    import jax
    import jax.numpy as jnp
    from repro.launch.steps import make_spec_verify_step as j_verify
    tw = Twins(arch)
    jspec = JD.cache_view_specs(tw.jcfg, 48)
    tspec = TD.cache_view_specs(tw.tcfg, 48)
    rng = np.random.default_rng(5)
    B, C = 3, 5
    jcache = jax.tree.map(lambda a: jnp.asarray(
        0.3 * rng.standard_normal(a.shape).astype(np.float32)),
        JD.init_cache(tw.jcfg, B, 48))
    toks = rng.integers(2, tw.jcfg.vocab, size=(B, C)).astype(np.int32)
    pos = np.asarray([0, 13, 40], np.int32)
    n = np.asarray([5, 3, 0], np.int32)
    for mode, kernel in (("parallel", "blocked"), ("scan", "dense")):
        jl, jc = j_verify(tw.jcfg, jspec, mode=mode, chunk_kernel=kernel)(
            tw.jax.params, jcache, jnp.asarray(toks), jnp.asarray(pos),
            jnp.asarray(n))
        tcache = TD.tree_from_leaves(tspec, [
            torch.from_numpy(np.array(a)) for a in jax.tree.leaves(jcache)])
        tl, tc = make_spec_verify_step(tw.tcfg, tspec, mode=mode,
                                       chunk_kernel=kernel)(
            tw.params, tcache, *map(torch.from_numpy, (toks, pos, n)))
        jl = np.asarray(jl)
        assert tuple(tl.shape) == jl.shape == (B, C, tw.jcfg.vocab)
        live = np.arange(C)[None, :] < n[:, None]
        np.testing.assert_allclose(tl.numpy()[live], jl[live], rtol=2e-4,
                                   atol=2e-4)
        assert (tl.numpy()[~live] == jl[~live]).all()
        assert (tl.numpy()[live].argmax(-1) == jl[live].argmax(-1)).all()
        for a, b in zip(jax.tree.leaves(jc), TD.tree_leaves(tc, tspec)):
            np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=2e-4,
                                       atol=2e-4)
