"""The port's ``ServeEngine`` on the MoE family against the JAX package's,
on the CPU: reduced mixtral-8x22b in float32, the JAX engine's weights
carried across by ``from_reference``, the same schedule in both.

Every serving step runs its experts dropless (capacity = the step's
tokens) in both packages, so a stream's tokens never depend on which
streams share its step.  Each scenario gives the JAX engine's tokens and
every counter exactly: the lazy engine under pool pressure with both
evict modes, a prefix-sharing hit, the engine's own n-gram speculative
decoding, and the eager engine (``lazy=False``: whole-prompt prefill at
the configured capacity, which the reduced config sets to E / K, so
nothing drops)."""
import numpy as np
import pytest

from torch_engine_twins import Twins, configs, same_counters, serve, \
    served_pair

ARCH = "mixtral-8x22b"
JCFG, TCFG = configs(ARCH)


@pytest.mark.parametrize("evict_mode", ["swap", "restart"])
def test_lazy_engine_under_pool_pressure(evict_mode):
    """One stream's worth of pages a domain and long generations: parked
    streams spill to the host tier and come back (``swap``), or are
    evicted and recomputed (``restart``), to the JAX engine's tokens."""
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
    """The engine's own n-gram drafter on prompts of repeated motifs: the
    port drafts, accepts and verifies exactly as the JAX engine, and both
    give the spec-off engine's tokens."""
    tw = Twins(ARCH, spec_k=3)
    rng = np.random.default_rng(3)
    prompts = [np.tile(rng.integers(2, JCFG.vocab, size=n), 4)
               for n in (3, 5)]
    max_new = [12, 10]
    base = serve(tw.port(spec_decode="off"), prompts, max_new)
    te = tw.port()
    assert serve(te, prompts, max_new) == base
    assert serve(tw.jax, prompts, max_new) == base
    same_counters(tw.jax, te)
    kv = te.kv_stats()
    assert kv["spec_tokens_drafted"] > 0 and kv["spec_verify_forwards"] > 0


def test_eager_engine():
    """``lazy=False``: whole-prompt prefill into full-length reservations,
    no chunk tick; the JAX eager engine's tokens and counters."""
    rng = np.random.default_rng(4)
    prompts = [rng.integers(2, JCFG.vocab, size=s) for s in (20, 9, 13)]
    max_new = [6, 5, 8]
    jeng, teng, jt, tt = served_pair(ARCH, prompts, max_new, lazy=False)
    same_counters(jeng, teng)
    assert tt == jt and [len(t) for t in tt] == max_new
    assert teng.counters.totals["prefills"] == 3
    assert teng.kv_stats()["chunk_ticks"] == 0
