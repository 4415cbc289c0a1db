"""Speculative decoding's accept and rollback edges in the port against the
JAX package, on the CPU — the twins of ``tests/test_spec_decode.py``'s
injected-drafter tests: full rejects, full accepts, a verify window across
a page seam, prefix-shared pages under rollback, hybrid state and ring
wrap, and a park/spill between spec ticks.  Every case: the port's tokens
equal the JAX spec engine's and the spec-off baseline's, and every counter
equals the JAX engine's.  Also the pool's batched checkpoint and rollback
against the JAX pool's."""
import jax
import numpy as np

from repro.serving.kvpool import KVBlockPool as JPool
from repro_torch.models import decode as TD
from repro_torch.models.params import from_reference
from repro_torch.serving.kvpool import KVBlockPool as TPool
from torch_engine_twins import (AntiOracleDrafter, OracleDrafter,
                                PartialDrafter, Twins, same_counters, serve)


def both(tw, drafter, prompts, max_new, **over):
    """Serve on the JAX spec engine and the port's with the same injected
    drafter; both must give the port's spec-off tokens.  Returns the port
    engine."""
    base = serve(tw.port(spec_decode="off", **over), prompts, max_new)
    je = tw.jax_engine(**over) if over else tw.jax
    te = tw.port(**over)
    for eng in (je, te):
        eng.drafter = drafter(base)
    assert serve(je, prompts, max_new) == base
    assert serve(te, prompts, max_new) == base
    same_counters(je, te)
    return te


def test_full_reject_anti_oracle():
    """Every draft token wrong: full rejects every spec tick, and a
    pure-attention ring that never wraps takes no checkpoint."""
    tw = Twins("llama3-8b")
    rng = np.random.default_rng(5)
    prompts = [rng.integers(2, tw.jcfg.vocab, size=s) for s in (6, 9)]
    te = both(tw, lambda b: AntiOracleDrafter(prompts, b, tw.jcfg.vocab),
              prompts, [16, 12])
    kv = te.kv_stats()
    assert kv["spec_tokens_accepted"] == 0
    assert kv["spec_full_rejects"] > 0 and kv["spec_rollbacks"] > 0
    assert kv["spec_ckpts"] == 0 and kv["spec_rollback_pages"] == 0
    assert kv["spec_rejected_bytes"] > 0


def test_full_accept_oracle():
    """Every draft token right: total acceptance, no rollback, fewer
    model forwards than committed tokens."""
    tw = Twins("llama3-8b")
    rng = np.random.default_rng(6)
    prompts = [rng.integers(2, tw.jcfg.vocab, size=s) for s in (5, 8)]
    te = both(tw, lambda b: OracleDrafter(prompts, b), prompts, [18, 15])
    kv = te.kv_stats()
    assert kv["spec_tokens_drafted"] > 0
    assert kv["spec_tokens_accepted"] == kv["spec_tokens_drafted"]
    assert kv["spec_rollbacks"] == 0 and kv["spec_accept_rate"] == 1.0
    forwards = (kv["decode_row_forwards"] + kv["spec_row_forwards"]
                + kv["spec_row_reapplies"])
    assert forwards < kv["decode_committed_tokens"]


def test_page_boundary_rollback():
    """A 14-token prompt with k=3 puts the first verify window at
    positions 14..17, across the 16-token page seam."""
    tw = Twins("llama3-8b")
    rng = np.random.default_rng(7)
    prompts = [rng.integers(2, tw.jcfg.vocab, size=14)]
    te = both(tw, lambda b: PartialDrafter(prompts, b, tw.jcfg.vocab),
              prompts, [15])
    assert te.pool.block_tokens == 16
    kv = te.kv_stats()
    assert kv["spec_rollbacks"] > 0 and kv["spec_tokens_accepted"] > 0


def test_cow_shared_page_bits_unchanged_across_rollbacks():
    """Published prefix pages attached by a drafting stream keep their
    exact bytes through full rejects: speculation never writes (or rolls
    back) through a refcount>1 page."""
    tw = Twins("llama3-8b", share=True, max_len=64, pool_streams=3)
    rng = np.random.default_rng(8)
    pre = rng.integers(2, tw.jcfg.vocab, size=32)       # two full pages
    prompts = [np.concatenate([pre, rng.integers(2, tw.jcfg.vocab, size=3)])
               for _ in range(2)]
    max_new = [10, 10]
    base = serve(tw.port(spec_decode="off"), prompts, max_new)
    engines = (tw.jax, tw.port())
    for eng in engines:
        eng.drafter = AntiOracleDrafter(prompts, base, tw.jcfg.vocab)
        assert serve(eng, prompts[:1], max_new[:1]) == base[:1]
    je, te = engines
    shared = list(te.pool._entry_of_block)
    assert len(shared) >= 2 and shared == list(je.pool._entry_of_block)
    before = [x.clone() for x in TD.extract_pool_entries(
        te.pool.storage, te.pool.spec, shared) if x is not None]
    for eng in engines:
        eng.submit(prompts[1], max_new[1])
        eng.run_until_done()
        assert [r.generated for r in eng.submitted] == base
    same_counters(je, te)
    kv = te.kv_stats()
    assert kv["spec_full_rejects"] > 0
    assert kv["prefix_hits"] > 0 or kv["cached_page_hits"] > 0
    after = [x for x in TD.extract_pool_entries(
        te.pool.storage, te.pool.spec, shared) if x is not None]
    for a, b in zip(before, after):
        assert a.equal(b)
    te.pool.audit([r.table for r in te.submitted if r.table is not None])


def test_hybrid_state_rollback_past_ring_wrap():
    """recurrentgemma: state slots snapshot on every spec tick, and ring
    windows past the 32-token ring also snapshot their pages."""
    tw = Twins("recurrentgemma-9b", max_len=64)
    rng = np.random.default_rng(9)
    prompts = [rng.integers(2, tw.jcfg.vocab, size=5)]
    te = both(tw, lambda b: PartialDrafter(prompts, b, tw.jcfg.vocab),
              prompts, [52])
    assert te.pool.spec.width < 5 + 52
    kv = te.kv_stats()
    assert kv["spec_rollbacks"] > 0
    assert kv["spec_ckpts"] > 0 and kv["spec_ckpt_pages"] > 0
    assert kv["spec_rollback_pages"] > 0 and kv["spec_rollback_bytes"] > 0


def test_park_spill_mid_draft():
    """Oversubscription parks and spills streams between spec ticks: the
    saved cursor is the last accepted position, so restored streams go
    on token-identically with nothing recomputed."""
    tw = Twins("llama3-8b", pool_streams=1, max_batch=3, max_len=32)
    rng = np.random.default_rng(10)
    prompts = [np.tile(rng.integers(2, tw.jcfg.vocab, size=4), 5)
               for _ in range(3)]
    te = both(tw, lambda b: PartialDrafter(prompts, b, tw.jcfg.vocab),
              prompts, [20, 18, 16])
    kv = te.kv_stats()
    assert kv["spec_tokens_drafted"] > 0 and kv["spec_rollbacks"] > 0
    assert kv["spills"] > 0 and kv["recompute_tokens"] == 0


def test_checkpoint_and_rollback_rows_match_reference():
    """The pool's batched snapshot of drafted rows (wrapping pages and
    state slots) and the rollback of a subset put back exactly the bytes
    the JAX pool's do, and count the same."""
    from repro.configs import REGISTRY, reduced_config
    import jax.numpy as jnp
    tw = Twins("recurrentgemma-9b", max_len=64)
    kw = dict(n_domains=1, max_len=64, blocks_per_domain=8,
              states_per_domain=4, block_tokens=16)
    jp = JPool(reduced_config(REGISTRY["recurrentgemma-9b"]), **kw)
    tp = TPool(tw.tcfg, device="cpu", **kw)
    rng = np.random.default_rng(11)
    jp.storage = jax.tree.map(lambda a: jnp.asarray(
        rng.standard_normal(a.shape).astype(np.float32)).astype(a.dtype),
        jp.storage)
    tp.storage = from_reference(jax.tree.map(np.asarray, jp.storage),
                                device="cpu")
    rows = []
    for pool in (jp, tp):
        t1 = pool.reserve(0, 64, first_tokens=64)
        t2 = pool.reserve(0, 64, first_tokens=64)
        rows.append([(t1, 30, 4, True), (t2, 5, 3, False)])
    ckj, ckt = jp.checkpoint_rows(rows[0]), tp.checkpoint_rows(rows[1])
    # scribble over everything, then roll the first row back
    jp.storage = jax.tree.map(lambda a: a * 0 + 7, jp.storage)
    for leaf in TD.tree_leaves(tp.storage, tp.spec):
        leaf.fill_(7)
    jp.rollback_rows(ckj[:1])
    tp.rollback_rows(ckt[:1])
    for a, b in zip(jax.tree.leaves(jp.storage),
                    TD.tree_leaves(tp.storage, tp.spec)):
        np.testing.assert_array_equal(b.float().numpy(),
                                      np.asarray(a, np.float32))
    assert dict(tp.counters.totals) == dict(jp.counters.totals)
    assert tp.stats()["spec_rollback_pages"] == \
        jp.stats()["spec_rollback_pages"] > 0
