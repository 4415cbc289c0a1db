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
decode, chunk and verify alike on the parallel path."""
import numpy as np
import pytest

from repro_torch.configs import REGISTRY, reduced_config
from repro_torch.core.topology import ChipletTopology
from repro_torch.serving.engine import EngineConfig, ServeEngine
from torch_engine_twins import PartialDrafter, Twins, serve


@pytest.mark.parametrize("arch,spec,max_batch", [
    ("llama3-8b", "ngram", 2), ("llama3-8b", "off", 4),
    ("recurrentgemma-9b", "ngram", 2), ("mamba2-780m", "off", 2)])
def test_warm_steps_count_and_tokens(arch, spec, max_batch):
    """The port's ``warm_steps`` makes as many step calls as the JAX
    engine's on the same config, leaves the null rows' writes unread, and
    serving after it gives a cold engine's tokens (and the JAX engine's)."""
    tw = Twins(arch, spec=spec, max_batch=max_batch)
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
    tw = Twins("llama3-8b", spec="ngram", max_batch=2)
    assert tw.port().warm_steps(chunks=(2, 16, 64)) == \
        tw.jax.warm_steps(chunks=(2, 16, 64))


@pytest.mark.parametrize("arch", ["llama3-8b", "mamba2-780m",
                                  "recurrentgemma-9b"])
def test_measured_model_steps(arch):
    """One layer-stack walk a call for decode, chunk (any width) and
    verify; the verify step needs speculation on; an unknown kind
    raises."""
    tw = Twins(arch, spec="ngram", spec_k=3)
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
    tw = Twins("llama3-8b", spec="ngram", spec_k=3)
    eng = tw.port()
    for kind in ("decode", "chunk", "spec"):
        assert eng.measured_model_steps(kind) == \
            tw.jax.measured_model_steps(kind)


def test_scan_path_is_not_ported():
    """The per-token scan path (whose model steps scale with the width in
    JAX) stays refused, naming ROADMAP A item 6."""
    with pytest.raises(NotImplementedError, match="ROADMAP A item 6"):
        ServeEngine(reduced_config(REGISTRY["llama3-8b"]),
                    ChipletTopology(1, 1, 1),
                    EngineConfig(max_len=32, prefill_mode="scan",
                                 spec_decode="ngram"), device="cpu")
