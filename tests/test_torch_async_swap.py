"""The port's asynchronous swap tier against the JAX package's, on the CPU
— the twins of ``tests/test_async_swap.py``.

A spill runs as issue / poll / fence: ``spill_issue`` snapshots the
victim's pages and starts their copy to the host tier (on the card, on a
side stream; here the copy is done on return), the poll lands it, and
only the landing re-grants the victim's pages.  The engine with
``async_swap=True`` must give the JAX async engine's tokens and its sync
twin's, recompute nothing, and keep ``pool.audit()`` exact after every
transfer transition.  On the CPU the port's copy is done when the issue
returns; the JAX package's CPU arrays may or may not be ready at the next
poll or fence.  So the JAX pools here block on their arrays at issue
(``settle``), as the reference test forces completion, and overlap rounds
and fence waits are then compared with JAX too."""
import jax
import jax.numpy as jnp
import numpy as np

from conftest import hypothesis_tools
from repro.configs import REGISTRY, reduced_config
from repro.serving.kvpool import KVBlockPool as JPool
from repro_torch.serving.kvpool import KVBlockPool as TPool
from torch_engine_twins import Twins, configs, same_counters, tokens

given, settings, st = hypothesis_tools()

JCFG, TCFG = configs("llama3-8b")


def settle(jpool):
    """Make a JAX pool's spills ready as soon as they are issued."""
    issue = jpool.spill_issue

    def issued(table):
        n = issue(table)
        for r in jpool._inflight:
            for leaf in r.leaves:
                if leaf is not None:
                    leaf.block_until_ready()
        return n

    jpool.spill_issue = issued
    return jpool


def async_twins(groups=1, **kw):
    tw = Twins("llama3-8b", groups=groups, spec="off", max_len=32,
               pool_streams=1, **kw)
    settle(tw.jax.pool)
    return tw


def instrument(eng):
    """Audit the pool after every transfer-engine transition — issue,
    poll, fence, restore and free."""
    pool = eng.pool
    audits = {"n": 0}

    def live():
        return [r.table for r in eng.submitted if r.table is not None]

    for name in ("spill_issue", "spill_poll", "spill_fence",
                 "restore_into", "restore", "free"):
        orig = getattr(pool, name)

        def wrapped(*a, _orig=orig, **kw):
            out = _orig(*a, **kw)
            pool.audit(live())
            audits["n"] += 1
            return out

        setattr(pool, name, wrapped)
    return audits


def drain(eng):
    res = eng.run_until_done()
    assert all(r.done for r in eng.submitted), "allocation deadlock"
    assert eng.pool.inflight_tables() == 0, "transfer outlived the run"
    assert eng.pool.occupancy() == 0.0
    assert eng.pool.spilled_tables == 0 and eng.pool.spilled_bytes == 0
    eng.pool.audit([])
    return res["counters"]


def longtail(rng, n, max_len):
    out = []
    for _ in range(n):
        gap = int(rng.integers(0, 4))
        plen = int(rng.integers(3, max_len // 2))
        if rng.random() < 0.5:
            max_new = int(rng.integers(max_len // 2, max_len - plen))
        else:
            max_new = int(rng.integers(1, max(2, max_len // 8)))
        out.append((gap, rng.integers(2, JCFG.vocab, size=plen), max_new))
    return out


@settings(max_examples=4, deadline=None)
@given(seed=st.integers(0, 10**6))
def test_async_token_identity_randomized(seed):
    """Randomized oversubscription schedules: the port's async engine, its
    sync twin and an uncontended baseline give the JAX async engine's
    tokens; async never recomputes or evicts, and every issue lands once."""
    rng = np.random.default_rng(seed)
    sched = longtail(rng, int(rng.integers(3, 7)), 32)
    tw = async_twins(groups=int(rng.integers(1, 3)), max_batch=4,
                     async_swap=True)
    runs = {"jax": tw.jax, "async": tw.port(),
            "sync": tw.port(async_swap=False),
            "baseline": tw.port(async_swap=False, pool_streams=8)}
    audits = instrument(runs["async"])
    counters = {}
    for name, eng in runs.items():
        eng.open_loop_client(list(sched))
        counters[name] = drain(eng) if name != "jax" else \
            eng.run_until_done()["counters"]
    toks = {name: tokens(eng) for name, eng in runs.items()}
    assert toks["async"] == toks["jax"] == toks["sync"] == toks["baseline"]
    c = counters["async"]
    assert c.get("recompute_tokens", 0) == 0 and c.get("kv_evictions", 0) == 0
    assert c.get("kv_spill_issues", 0) == c.get("kv_spills", 0)
    assert counters["baseline"].get("kv_spills", 0) == 0
    if c.get("kv_spills", 0):
        assert audits["n"] > 0


def test_async_oversubscription_overlap_counters():
    """The 1-stream/domain schedule that forces spill cycles: the async
    and sync engines give the JAX engines' tokens and every counter of
    theirs; async issues and lands every spill rounds later, sync fences
    at once and never counts a fence wait."""
    rng = np.random.default_rng(0)
    sched = [(int(rng.integers(0, 2)), rng.integers(2, JCFG.vocab, size=4),
              26) for _ in range(6)]
    kv = {}
    for is_async in (True, False):
        tw = async_twins(max_batch=4, async_swap=is_async)
        te = tw.port()
        instrument(te)
        for eng in (tw.jax, te):
            eng.open_loop_client(list(sched))
        tw.jax.run_until_done()
        drain(te)
        assert tokens(te) == tokens(tw.jax)
        same_counters(tw.jax, te)
        kv[is_async] = te.kv_stats()
        jkv = tw.jax.kv_stats()
        # (d2h_seconds prices the same bytes at each package's link rate)
        for k in ("async_swap", "spill_issues", "spills", "fence_waits",
                  "spill_overlap_rounds", "overlap_rounds_per_spill",
                  "ticks_while_inflight", "spill_inflight_pages",
                  "restore_prefetches"):
            assert kv[is_async][k] == jkv[k], k
    a, s = kv[True], kv[False]
    assert a["async_swap"] and not s["async_swap"]
    assert a["spills"] >= 1 and a["spill_issues"] == a["spills"]
    assert s["spill_issues"] == s["spills"] >= 1
    assert a["spill_overlap_rounds"] > 0 == s["spill_overlap_rounds"]
    assert a["spill_inflight_pages"] == 0 == a["spill_inflight_bytes"]
    assert a["d2h_seconds"] > 0
    assert s["fence_waits"] == 0 and s["ticks_while_inflight"] == 0


def pools(**kw):
    """A JAX pool and the port's with the same budget."""
    return settle(JPool(JCFG, **kw)), TPool(TCFG, device="cpu", **kw)


def grown_table(pool):
    t = pool.reserve(0, 40, first_tokens=8)
    pool.grow(t, 1)
    t.used_pages = 2
    return t


def test_fence_before_regrant_pool_unit():
    """An issued spill keeps the victim's pages until it lands: free
    counts unchanged at issue, the free callback at landing, no
    double issue, audit exact at every stage; the pools count as JAX's."""
    jp, tp = pools(n_domains=1, max_len=32, blocks_per_domain=4,
                   states_per_domain=2)
    for pool in (jp, tp):
        t = grown_table(pool)
        frees = []
        pool.on_free(lambda p=pool: frees.append(p.free_blocks(0)))
        free0 = pool.free_blocks(0)
        assert pool.spill_issue(t) == 2
        assert t.inflight and t.spill is None and len(t.blocks) == 2
        assert pool.free_blocks(0) == free0 and frees == []
        assert pool.inflight_tables() == 1 and pool.inflight_pages() == 2
        assert pool.inflight_bytes() > 0 and pool.inflight_domains() == {0}
        pool.audit([t])
        assert pool.spill_issue(t) == 0
        pool.audit([t])
        pool.spill_fence(t)
        assert not t.inflight and t.spill is not None and t.blocks == []
        assert pool.free_blocks(0) == free0 + 2 and len(frees) == 1
        pool.audit([t])
        assert pool.restore(t)
        pool.audit([t])
        pool.free(t)
        pool.audit([])
    assert dict(tp.counters.totals) == dict(jp.counters.totals)


def test_poll_lands_ready_transfers():
    """The per-round poll lands a completed transfer without a blocking
    fence, and the overlap clock counts the rounds in between."""
    jp, tp = pools(n_domains=2, max_len=32, blocks_per_domain=2,
                   states_per_domain=2)
    for pool in (jp, tp):
        t = grown_table(pool)
        assert pool.spill_issue(t) == 2
        assert pool._inflight[0].ready()
        assert pool.spill_poll() == 1
        assert not t.inflight and t.spill is not None
        assert pool.counters.totals.get("kv_fence_waits", 0) == 0
        pool.audit([t])
        pool.free(t)
        pool.audit([])
    assert dict(tp.counters.totals) == dict(jp.counters.totals)
    assert tp.counters.totals["kv_spill_overlap_rounds"] == 1


def test_migrate_and_free_fence_inflight_first():
    """``migrate`` (relayout, steal) and ``free`` drain a table's transfer
    before acting: a re-point or a free with bytes on the wire would
    corrupt the payload."""
    jp, tp = pools(n_domains=2, max_len=32, blocks_per_domain=2,
                   states_per_domain=2)
    for pool in (jp, tp):
        t = grown_table(pool)
        assert pool.spill_issue(t) == 2
        assert pool.migrate(t, 1)
        assert not t.inflight and t.spill is not None and t.domain == 1
        assert pool.inflight_tables() == 0
        assert pool.restore(t)
        assert t.domain == 1 and len(t.blocks) == 2
        pool.audit([t])
        t2 = grown_table(pool)
        assert pool.spill_issue(t2) == 2
        pool.free(t2)
        assert pool.inflight_tables() == 0
        pool.free(t)
        pool.audit([])
    assert dict(tp.counters.totals) == dict(jp.counters.totals)


def test_grow_refused_while_inflight():
    """An in-flight victim is frozen: grow is refused (the stream parks
    and retries after the landing)."""
    jp, tp = pools(n_domains=1, max_len=32, blocks_per_domain=4,
                   states_per_domain=2)
    for pool in (jp, tp):
        t = pool.reserve(0, 40, first_tokens=8)
        t.used_pages = 1
        assert pool.spill_issue(t) == 1
        gf0 = pool.counters.totals.get("kv_grow_failures", 0)
        assert not pool.grow(t, 1)
        assert pool.counters.totals.get("kv_grow_failures", 0) == gf0 + 1
        pool.spill_fence(t)
        pool.audit([t])
        pool.free(t)
        pool.audit([])
    assert dict(tp.counters.totals) == dict(jp.counters.totals)


def test_restore_into_failed_leg_has_zero_side_effects():
    """A sweep leg that cannot fit pages + growth leaves the table exactly
    as it was; the next leg restores atomically, growth clamped to the
    table's cap."""
    jp, tp = pools(n_domains=2, max_len=32, blocks_per_domain=4,
                   states_per_domain=2)
    for pool in (jp, tp):
        t = grown_table(pool)
        assert pool.spill(t) == 2
        eat1 = pool.reserve(1, 40, first_tokens=32)
        eat2 = pool.reserve(1, 8, first_tokens=8)
        assert pool.free_blocks(1) == 1
        free0, free1 = pool.free_blocks(0), pool.free_blocks(1)
        assert not pool.restore_into(t, 1)
        assert t.domain == 0 and t.spill is not None and t.blocks == []
        assert pool.free_blocks(0) == free0 and pool.free_blocks(1) == free1
        pool.audit([t, eat1, eat2])
        assert pool.restore_into(t, 0, grow_by=1)
        assert t.domain == 0 and t.spill is None
        assert len(t.blocks) == 2 and t.used_pages == 2
        pool.audit([t, eat1, eat2])
        for x in (t, eat1, eat2):
            pool.free(x)
        pool.audit([])
    assert dict(tp.counters.totals) == dict(jp.counters.totals)


def test_restore_into_state_slot_not_leaked_on_failed_leg():
    """Hybrid pools: a failed leg consumes neither the spilled state nor
    a destination state slot."""
    jcfg, tcfg = configs("recurrentgemma-9b")
    kw = dict(n_domains=2, max_len=32, blocks_per_domain=4,
              states_per_domain=1)
    jp, tp = settle(JPool(jcfg, **kw)), TPool(tcfg, device="cpu", **kw)
    for pool in (jp, tp):
        assert pool.has_state
        t = pool.reserve(0, 40, first_tokens=8)
        t.used_pages = len(t.blocks)
        pool.spill(t)
        assert t.spill is not None and t.spill.had_state
        eater = pool.reserve(1, 8, first_tokens=8)
        assert not pool.state_available(1)
        assert not pool.restore_into(t, 1)
        assert t.domain == 0 and t.spill is not None and t.spill.had_state
        pool.audit([t, eater])
        assert pool.restore_into(t, 0)
        assert t.state_slot and t.domain == 0
        pool.audit([t, eater])
        pool.free(t)
        pool.free(eater)
        pool.audit([])
    assert dict(tp.counters.totals) == dict(jp.counters.totals)


def test_restore_prefetch_stages_h2d_and_preserves_bytes():
    """``restore_prefetch`` stages the spilled payload on the device while
    the stream waits; the restore reads the staged copy and the bytes
    come back exact (as in the JAX pool)."""
    jp, tp = pools(n_domains=1, max_len=32, blocks_per_domain=4,
                   states_per_domain=2)
    tables = {}
    for pool in (jp, tp):
        t = tables[pool] = grown_table(pool)
        assert len(t.blocks) == 2
    jp.storage = jax.tree.map(
        lambda a: a.at[:, jnp.asarray(tables[jp].blocks)].set(3.25),
        jp.storage)
    for leaf in tp.storage["layers"].values():
        leaf[:, tables[tp].blocks] = 3.25
    for pool in (jp, tp):
        t = tables[pool]
        assert pool.spill(t) == 2
        assert pool.restore_prefetch(t)
        assert t.spill.staged is not None
        assert not pool.restore_prefetch(t)         # idempotent
        assert pool.counters.totals.get("kv_restore_prefetches", 0) == 1
        assert pool.restore(t)
        pool.audit([t])
    for leaf in tp.storage["layers"].values():
        assert bool((leaf[:, tables[tp].blocks] == 3.25).all())
    for a, b in zip(jax.tree.leaves(jp.storage),
                    [tp.storage["layers"][k] for k in ("k", "v")]):
        np.testing.assert_array_equal(b.numpy(), np.asarray(a))
    for pool in (jp, tp):
        pool.free(tables[pool])
        pool.audit([])
    assert dict(tp.counters.totals) == dict(jp.counters.totals)


def test_engine_park_while_transfer_outstanding_drains():
    """Drive the 2-stream deadlock by hand on an async engine: the ladder
    issues the victim's spill (pages kept, line head still parked), and
    the run then drains — landings, not issues, re-grant the pages — to
    an uncontended engine's tokens, the JAX engine's."""
    tw = async_twins(max_batch=2, async_swap=True)
    rng = np.random.default_rng(5)
    prompts = [rng.integers(2, JCFG.vocab, size=4) for _ in range(2)]
    eng = tw.port()
    reqs = [eng.submit(p, max_new=26) for p in prompts]
    eng._running = True
    for g in eng.groups:
        eng._spawn_group(g)
    rounds = 0
    while len(eng._parked) < 2 and rounds < 500:
        eng.sched.tick()
        rounds += 1
    assert len(eng._parked) == 2, "deadlock scenario failed to form"
    free0 = sum(eng.pool.free_blocks(d) for d in range(eng.pool.n_domains))
    assert eng._spill_parked(domain=None)
    assert eng.pool.inflight_tables() == 1
    victim = [r for r in eng._parked.values() if r.req.table.inflight]
    assert len(victim) == 1 and victim[0].req.table.spill is None
    assert sum(eng.pool.free_blocks(d)
               for d in range(eng.pool.n_domains)) == free0
    eng.pool.audit([r.table for r in eng.submitted if r.table is not None])
    eng.sched.run_until_done(max_rounds=100000, round_hook=eng._stall_hook)
    eng._running = False
    eng.pool.drain()
    assert all(r.done for r in eng.submitted)
    assert eng.pool.inflight_tables() == 0
    assert eng.pool.occupancy() == 0.0 and eng.pool.spilled_tables == 0
    base = tw.port(async_swap=False, pool_streams=8)
    base_reqs = [base.submit(p, max_new=26) for p in prompts]
    drain(base)
    jreqs = [tw.jax.submit(p, max_new=26) for p in prompts]
    tw.jax.run_until_done()
    assert [r.generated for r in reqs] == [r.generated for r in base_reqs] \
        == [r.generated for r in jreqs]


def test_sync_spill_unchanged_by_default():
    """``async_swap`` defaults off: the default engine spills through the
    synchronous ``pool.spill``, with no issue left unfenced."""
    tw = async_twins(max_batch=2)
    eng = tw.port()
    assert not eng._async and not eng.ecfg.async_swap
    calls = []
    orig = eng.pool.spill

    def spy(table, _o=orig):
        out = _o(table)
        calls.append(out)
        assert eng.pool.inflight_tables() == 0
        return out

    eng.pool.spill = spy
    rng = np.random.default_rng(5)
    for p in [rng.integers(2, JCFG.vocab, size=4) for _ in range(2)]:
        eng.submit(p, max_new=26)
    drain(eng)
    assert calls, "the deadlock schedule never spilled"
    assert eng.counters.totals.get("kv_fence_waits", 0) == 0
    assert len(calls) == eng.counters.totals["kv_spills"]


def force_park(eng):
    """Park the first stream four tokens past its prompt, once, as
    ``tests/test_slo_admission.py``'s hybrid spill test does: a hybrid
    pool budgets a whole ring of pages to each state slot, so its streams
    never park on their own."""
    tick = eng._decode_tick
    parked = []

    def forced(g):
        out = tick(g)
        if not parked:
            for i, r in enumerate(g.slots):
                if r is not None and int(g.pos_h[i]) >= len(r.prompt) + 4:
                    eng._park_stream(g, i)
                    parked.append(r.rid)
                    break
        return out

    eng._decode_tick = forced
    return parked


def spy_state_spills(pool):
    """Record, per issued spill, whether it carries the table's state
    slot."""
    issue = pool.spill_issue
    had = []

    def issued(table):
        fresh = table.spill is None and not table.inflight
        state = bool(pool.has_state and table.state_slot)
        n = issue(table)
        if fresh and n:
            had.append(state)
        return n

    pool.spill_issue = issued
    return had


def test_hybrid_async_spill_carries_the_state_slot():
    """A hybrid stream parked mid-decode is spilled by the watermark rung
    through the asynchronous tier — its ring pages and its state slot on
    the side stream — lands, restores and finishes with the JAX async
    engine's tokens and an unforced synchronous run's, recomputing
    nothing."""
    tw = Twins("recurrentgemma-9b", groups=1, spec="off", max_len=32,
               pool_streams=2, max_batch=4, async_swap=True,
               spill_watermarks=(0.2, 0.1))
    settle(tw.jax.pool)
    rng = np.random.default_rng(4)
    prompts = [rng.integers(2, tw.jcfg.vocab, size=6) for _ in range(3)]
    port = tw.port()
    audits = instrument(port)
    out, had = {}, {}
    for name, eng in (("jax", tw.jax), ("port", port)):
        assert force_park(eng) == []
        had[name] = spy_state_spills(eng.pool)
        for p in prompts:
            eng.submit(p, max_new=20)
        c = drain(eng)
        assert c["kv_spill_issues"] >= 1 and c["kv_spills"] >= 1
        assert c.get("recompute_tokens", 0) == 0
        out[name] = tokens(eng)
    assert had["port"] and all(had["port"]) and had["port"] == had["jax"]
    assert audits["n"] > 0
    base = tw.port(async_swap=False, spill_watermarks=None)
    for p in prompts:
        base.submit(p, max_new=20)
    drain(base)
    assert out["port"] == out["jax"] == tokens(base)
