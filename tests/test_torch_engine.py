"""The port's ``ServeEngine`` against the JAX package's, on the CPU.

Both engines serve reduced llama3-8b on the same schedule with the same
weights (the JAX engine's, carried across by ``from_reference``) and the
default ``EngineConfig`` apart from the sizes each scenario sets.  They
must generate identical tokens and count the same engine and pool
events: plain continuous batching, a prefix-sharing hit, a forced swap
spill and restore under pool pressure (and its restart-eviction twin),
a size-aware SLO bypass, a proactive watermark spill, and a relayout
forced mid-run."""
import jax
import numpy as np
import pytest

from repro.configs import REGISTRY, reduced_config
from repro.core.controller import Decision as JDecision
from repro.core.topology import ChipletTopology as JTopology
from repro.serving.engine import EngineConfig as JEngineConfig
from repro.serving.engine import ServeEngine as JServeEngine
from repro_torch.configs import REGISTRY as T_REGISTRY
from repro_torch.configs import reduced_config as t_reduced
from repro_torch.core.controller import Decision as TDecision
from repro_torch.core.topology import ChipletTopology as TTopology
from repro_torch.models.params import from_reference
from repro_torch.serving.engine import EngineConfig as TEngineConfig
from repro_torch.serving.engine import ServeEngine as TServeEngine

JCFG = reduced_config(REGISTRY["llama3-8b"])
TCFG = t_reduced(T_REGISTRY["llama3-8b"])
# gauges of the JAX package's asynchronous swap tier, which the port does
# not have yet
ASYNC_ONLY = {"kv_spill_inflight_pages", "kv_spill_inflight_bytes",
              "kv_spill_overlap_rounds"}


def engines(groups=2, **ecfg):
    """(JAX engine, port engine) over the same topology, config and
    weights."""
    je = JServeEngine(JCFG, JTopology(n_pods=1, groups_per_pod=groups,
                                      chips_per_group=1),
                      JEngineConfig(**ecfg), seed=0)
    te = TServeEngine(TCFG, TTopology(n_pods=1, groups_per_pod=groups,
                                      chips_per_group=1),
                      TEngineConfig(**ecfg),
                      params=from_reference(jax.tree.map(np.asarray,
                                                         je.params),
                                            device="cpu"),
                      device="cpu")
    return je, te


def tokens(eng):
    return [r.generated for r in sorted(eng.submitted, key=lambda r: r.rid)]


def same_counters(jres, tres):
    jc, tc = jres["counters"], tres["counters"]
    assert set(jc) - set(tc) <= ASYNC_ONLY, set(jc) - set(tc)
    assert set(tc) <= set(jc), set(tc) - set(jc)
    diff = {k: (jc[k], tc[k]) for k in tc if jc[k] != tc[k]}
    assert not diff, diff


def audit_live(eng):
    """Audit the pool's accounting after every spill, restore and free."""
    pool = eng.pool

    def live():
        return [r.table for r in eng.submitted if r.table is not None]

    for name in ("spill", "restore_into", "free"):
        orig = getattr(pool, name)

        def wrapped(table, *a, _orig=orig, **kw):
            out = _orig(table, *a, **kw)
            pool.audit(live())
            return out

        setattr(pool, name, wrapped)


def test_continuous_batching():
    rng = np.random.default_rng(0)
    prompts = [rng.integers(2, JCFG.vocab, size=int(n))
               for n in (5, 19, 33, 40, 12)]
    max_new = [6, 9, 4, 12, 7]
    je, te = engines(max_batch=2, max_len=48, pool_streams=2)
    out = {}
    for eng in (je, te):
        for p, m in zip(prompts, max_new):
            eng.submit(p, max_new=m)
        out[eng] = eng.run_until_done()
    assert tokens(te) == tokens(je)
    assert [len(g) for g in tokens(te)] == max_new
    same_counters(out[je], out[te])
    c = out[te]["counters"]
    assert c["chunk_ticks"] > 0 and c["split_ticks"] > 0
    assert te.pool.occupancy() == 0.0
    te.pool.audit([])


def test_prefix_sharing_hit():
    """A resident 32-token preamble (two pages) is attached refcounted by
    the two later requests that share it: both engines count the same
    hits and generate the same tokens."""
    rng = np.random.default_rng(1)
    pre = rng.integers(2, JCFG.vocab, size=32)
    first = np.concatenate([pre, rng.integers(2, JCFG.vocab, size=6)])
    later = [np.concatenate([pre, rng.integers(2, JCFG.vocab, size=n)])
             for n in (9, 17)]
    je, te = engines(max_batch=2, max_len=64, pool_streams=3)
    out = {}
    for eng in (je, te):
        eng.submit(first, max_new=5)
        eng.run_until_done()
        for p in later:
            eng.submit(p, max_new=8)
        out[eng] = eng.run_until_done()
    assert tokens(te) == tokens(je)
    jc, tc = out[je]["counters"], out[te]["counters"]
    assert tc["kv_prefix_hits"] == jc["kv_prefix_hits"] > 0
    assert tc["prefill_tokens_skipped"] == jc["prefill_tokens_skipped"] > 0
    same_counters(out[je], out[te])


@pytest.mark.parametrize("evict_mode", ["swap", "restart"])
def test_swap_spill_and_restore(evict_mode):
    """One stream's worth of pages per domain and long generations: the
    stall watchdog spills parked streams to the host tier and restores
    them — no recomputed token, the pool's audit exact after every spill,
    restore and free, and the tokens of the JAX engine.  With
    ``evict_mode="restart"`` it evicts and recomputes instead, to the same
    tokens."""
    rng = np.random.default_rng(0)
    sched = [(int(rng.integers(0, 2)), rng.integers(2, JCFG.vocab, size=4),
              26) for _ in range(6)]
    je, te = engines(groups=1, max_batch=4, max_len=32, pool_streams=1,
                     adaptive=False, evict_mode=evict_mode)
    audit_live(te)
    out = {}
    for eng in (je, te):
        eng.open_loop_client(list(sched))
        out[eng] = eng.run_until_done()
        assert all(r.done for r in eng.submitted)
    assert tokens(te) == tokens(je)
    c = out[te]["counters"]
    if evict_mode == "swap":
        assert c["kv_spills"] >= 2
        assert c["kv_restores"] == c["kv_spills"]
        assert c.get("recompute_tokens", 0) == 0
        assert c.get("kv_evictions", 0) == 0
    else:
        assert c["kv_evictions"] >= 2 and c["recompute_tokens"] > 0
        assert c.get("kv_spills", 0) == 0
    same_counters(out[je], out[te])
    assert te.pool.occupancy() == 0.0 and te.pool.spilled_tables == 0
    te.pool.audit([])


def test_slo_bypass():
    """Three big batch growers congest two one-stream domains; four small
    interactive requests arrive the moment a grower parks, the window in
    which a bypass past the parked head is provably free.  Both engines
    grant the same bypasses past the same heads and generate the same
    tokens."""
    rng = np.random.default_rng(7)
    big = [rng.integers(2, JCFG.vocab, size=6) for _ in range(3)]
    small = [rng.integers(2, JCFG.vocab, size=4) for _ in range(4)]
    je, te = engines(groups=2, max_batch=4, max_len=32, pool_streams=1,
                     adaptive=False)
    audit_live(te)
    out = {}
    for eng in (je, te):
        for p in big:
            eng.submit(p, max_new=24, cls="batch")
        orig, fired = eng._decode_tick, []

        def tick(g, _eng=eng, _orig=orig, _fired=fired):
            if not _fired and _eng._parked:
                for p in small:
                    _eng.submit(p, max_new=4, cls="interactive")
                _fired.append(True)
            _orig(g)

        eng._decode_tick = tick
        out[eng] = eng.run_until_done()
        assert all(r.done for r in eng.submitted)
    assert tokens(te) == tokens(je)
    assert out[te]["kv"]["bypass_grants"] >= 1
    assert te.bypass_log == je.bypass_log
    assert [r.bypassed for r in te.submitted] == \
        [r.bypassed for r in je.submitted]
    same_counters(out[je], out[te])
    te.pool.audit([])


def test_proactive_watermark_spill():
    """A domain crossing its high watermark sheds a parked stream before
    the stall watchdog fires: both engines spill the same streams at the
    same rounds and generate the same tokens."""
    rng = np.random.default_rng(2)
    sched = [(int(rng.integers(0, 2)),
              rng.integers(2, JCFG.vocab, size=int(rng.integers(4, 8))),
              int(rng.integers(12, 24)), "batch") for _ in range(4)]
    je, te = engines(groups=1, max_batch=4, max_len=32, pool_streams=1,
                     adaptive=False, spill_watermarks=(0.75, 0.5))
    audit_live(te)
    out = {}
    for eng in (je, te):
        eng.open_loop_client(list(sched))
        out[eng] = eng.run_until_done()
        assert all(r.done for r in eng.submitted)
    assert tokens(te) == tokens(je)
    assert out[te]["kv"]["proactive_spills"] >= 1
    same_counters(out[je], out[te])
    te.pool.audit([])


@pytest.mark.parametrize("at_tick", [3, 9])
def test_relayout_mid_run(at_tick):
    """Four replica groups merge into two after the ``at_tick``-th engine
    tick, with streams mid-prefill and mid-decode: in-flight tables
    re-point at their domain's new owner or copy their used pages, and
    both engines move the same slots and pages and keep their tokens."""
    rng = np.random.default_rng(7)
    prompts = [rng.integers(2, JCFG.vocab, size=int(n))
               for n in rng.integers(3, 30, size=8)]
    max_new = [int(m) for m in rng.integers(2, 12, size=8)]
    je, te = engines(groups=4, max_batch=2, max_len=32, pool_streams=2,
                     adaptive=False)
    out = {}
    for eng, decision in ((je, JDecision), (te, TDecision)):
        ticks = []
        orig = eng._decode_tick

        def tick(g, _eng=eng, _orig=orig, _ticks=ticks, _d=decision):
            _orig(g)
            _ticks.append(g.gid)
            if len(_ticks) == at_tick:
                _eng.sched.controller.spread_rate = 2
                _eng._relayout(_eng.sched.layout(),
                               _d(step=0, old_spread=1, new_spread=2,
                                  rate=0.0, reason="forced mid-run"))

        eng._decode_tick = tick
        for p, m in zip(prompts, max_new):
            eng.submit(p, max_new=m)
        out[eng] = eng.run_until_done()
        assert len(eng.groups) == 2
    assert tokens(te) == tokens(je)
    assert [len(g) for g in tokens(te)] == max_new
    assert out[te]["relayouts"] == out[je]["relayouts"]
    assert out[te]["relayouts"][0]["moved_slots"] > 0
    same_counters(out[je], out[te])
    te.pool.audit([])
