"""The port's ``ServeEngine`` against the JAX package's on reduced
recurrentgemma-9b, on the CPU: the hybrid twins of the JAX suite's
scenarios.

Both engines serve the same schedule with the same weights (the JAX
engine's, carried across by ``from_reference``) and the default
``EngineConfig`` apart from the sizes each scenario sets.  They must
generate identical tokens and count the same engine and pool events.  A
hybrid stream holds ring pages for its local-attention layers (width
min(max_len, local_window)) and one state slot for its recurrent layers:
a prompt prefix is shared through the state checkpoints the pool snaps at
page boundaries, and a spill carries the state leaves with the pages."""
import jax
import numpy as np
import pytest
import torch

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
from repro_torch.serving.kvpool import KVBlockPool

JCFG = reduced_config(REGISTRY["recurrentgemma-9b"])
TCFG = t_reduced(T_REGISTRY["recurrentgemma-9b"])


def engines(groups=2, **ecfg):
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
    assert set(tc) == set(jc), set(tc) ^ set(jc)
    diff = {k: (jc[k], tc[k]) for k in tc if jc[k] != tc[k]}
    assert not diff, diff


def test_pool_takes_ring_pages_and_a_state_slot():
    _, te = engines(max_batch=2, max_len=48, pool_streams=2)
    pool = te.pool
    assert pool.has_state and pool.pages_per_stream > 0
    assert pool.spec.width == TCFG.local_window == 32
    spec = pool.spec
    assert spec.paths == (
        ("groups", "b0_rec", "conv"), ("groups", "b0_rec", "h"),
        ("groups", "b1_rec", "conv"), ("groups", "b1_rec", "h"),
        ("groups", "b2_attn", "k"), ("groups", "b2_attn", "v"),
        ("tail", "t0_rec", "conv"), ("tail", "t0_rec", "h"),
        ("tail", "t1_rec", "conv"), ("tail", "t1_rec", "h"))
    # the recurrent state float32, the conv tail and rings in the compute
    # type; group leaves carry the group axis before the stream axis
    assert [s.batch_axis for s in spec.leaves] == [1] * 6 + [0] * 4
    assert [s.token_axis for s in spec.leaves] == \
        [None] * 4 + [2, 2] + [None] * 4
    assert all(d == torch.float32 for d in spec.dtypes)


def test_continuous_batching():
    """The hybrid twin of ``test_continuous_batching``'s family runs:
    five requests through two slots, prefill chunks and decode streams in
    split ticks."""
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


def test_chunk_wider_than_ring():
    """The lifted C <= W clamp (``test_continuous_batching.py:405``): the
    ring holds 32 tokens of max_len 48 and prefill chunks are 40 wide."""
    rng = np.random.default_rng(17)
    prompts = [rng.integers(2, JCFG.vocab, size=44) for _ in range(2)]
    je, te = engines(groups=1, max_batch=2, max_len=48, pool_streams=2,
                     prefill_chunk=40, adaptive=False)
    assert te._chunk == je._chunk == 40 > te.pool.spec.width == 32
    out = {}
    for eng in (je, te):
        for p in prompts:
            eng.submit(p, max_new=3)
        out[eng] = eng.run_until_done()
    assert tokens(te) == tokens(je)
    same_counters(out[je], out[te])


def test_state_checkpoint_prefix_hit():
    """The twin of ``test_prefix_sharing.py:428``: a 16-token preamble
    served once, then two requests behind it hit the prefix index through
    the donor's state checkpoint and skip its prefill."""
    rng = np.random.default_rng(8)
    pre = rng.integers(2, JCFG.vocab, size=16)
    prompts = [np.concatenate([pre, rng.integers(2, JCFG.vocab, size=5)])
               for _ in range(3)]
    je, te = engines(groups=1, max_batch=2, max_len=64, pool_streams=4,
                     adaptive=False)
    out = {}
    for eng in (je, te):
        eng.submit(prompts[0], max_new=3)
        eng.run_until_done()
        for p in prompts[1:]:
            eng.submit(p, max_new=3)
        out[eng] = eng.run_until_done()
    assert tokens(te) == tokens(je)
    same_counters(out[je], out[te])
    assert out[te]["counters"]["kv_prefix_hits"] >= 1
    assert te.kv_stats()["prefill_tokens_skipped"] > 0
    assert te.pool.occupancy() == 0.0
    te.pool.audit([])


@pytest.mark.parametrize("evict_mode", ["swap", "restart"])
def test_more_streams_than_state_slots(evict_mode):
    """One stream's worth of pages and one state slot per domain and six
    open-loop requests: admissions wait in line for the slot (a hybrid
    stream's pages never outgrow its ring, so the pool cannot deadlock and
    the watchdog never has to spill); both engines admit and finish the
    same streams in the same order with the same tokens."""
    rng = np.random.default_rng(0)
    sched = [(int(rng.integers(0, 2)), rng.integers(2, JCFG.vocab, size=4),
              26) for _ in range(6)]
    je, te = engines(groups=1, max_batch=4, max_len=32, pool_streams=1,
                     adaptive=False, evict_mode=evict_mode)
    out = {}
    for eng in (je, te):
        eng.open_loop_client(list(sched))
        out[eng] = eng.run_until_done()
        assert all(r.done for r in eng.submitted)
    assert tokens(te) == tokens(je)
    c = out[te]["counters"]
    assert c["kv_reservations"] == 6 and c["kv_alloc_failures"] > 0
    same_counters(out[je], out[te])
    assert te.pool.occupancy() == 0.0 and te.pool.spilled_tables == 0
    te.pool.audit([])


def test_pool_spill_carries_state_leaves():
    """The twin of ``test_memory_pressure.py:362`` on the port's pool: a
    hybrid table's state slot rides the spill with its ring pages through
    a cross-domain re-point and the restore, byte for byte."""
    pool = KVBlockPool(TCFG, n_domains=2, max_len=32, blocks_per_domain=4,
                       states_per_domain=2, device="cpu")
    assert pool.has_state and pool.pages_per_stream
    t = pool.reserve(0, 40, first_tokens=8)
    pool.grow(t, 1)
    t.used_pages = len(t.blocks)
    from repro_torch.models import decode as dec
    for leaf, s in zip(dec.tree_leaves(pool.storage, pool.spec),
                       pool.spec.leaves):
        idx = (slice(None),) * s.batch_axis
        if s.token_axis is not None:
            leaf[idx + (torch.tensor(t.blocks),)] = 3.25
        else:
            leaf[idx + (t.state_slot,)] = 7.5
    assert pool.spill(t) == t.used_pages
    assert t.state_slot == 0 and pool.free_states(0) == 2
    assert pool.migrate(t, 1)
    assert pool.restore(t)
    assert t.state_slot and t.domain == 1
    for leaf, s in zip(dec.tree_leaves(pool.storage, pool.spec),
                       pool.spec.leaves):
        ax = s.batch_axis
        ids = t.blocks if s.token_axis is not None else [t.state_slot]
        vals = leaf.index_select(ax, torch.tensor(ids))
        want = 3.25 if s.token_axis is not None else 7.5
        assert bool((vals == want).all()), "pages or state lost in spill"
    pool.audit([t])
    pool.free(t)
    pool.audit([])
    assert pool.spilled_tables == 0 and pool.spilled_bytes == 0.0


def test_relayout_mid_run():
    """Four replica groups merge into two after the 5th engine tick with
    streams mid-prefill and mid-decode: in-flight tables move their pages
    and state slots, and both engines move the same and keep their
    tokens."""
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
            if len(_ticks) == 5:
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
    same_counters(out[je], out[te])
    te.pool.audit([])
