"""The port's ``ServeEngine`` against the JAX package's on reduced
mamba2-780m, on the CPU: the scenarios of ``test_torch_engine.py`` on the
SSM family.

Both engines serve the same schedule with the same weights (the JAX
engine's, carried across by ``from_reference``) and the default
``EngineConfig`` apart from the sizes each scenario sets.  They must
generate identical tokens and count the same engine and pool events.  An
SSM stream holds one state slot (the SSD state and the three conv tails)
and no ring pages, so it takes the pool's state-slot paths: admission
blocks on slots rather than pages, a prompt prefix is never shared (the
JAX engine shares ring pages only), and a relayout moves state slots."""
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

JCFG = reduced_config(REGISTRY["mamba2-780m"])
TCFG = t_reduced(T_REGISTRY["mamba2-780m"])


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


def test_pool_takes_the_state_slot_layout():
    _, te = engines(max_batch=2, max_len=48, pool_streams=2)
    pool = te.pool
    assert pool.has_state and pool.pages_per_stream == 0
    assert pool.spec.width == 0
    assert [p[-1] for p in pool.spec.paths] == ["conv_B", "conv_C",
                                                "conv_x", "ssm"]
    assert pool.spec.dtypes == (torch.float32,) * 4
    assert te._chunk == TEngineConfig().block_tokens


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


def test_shared_prefix_is_recomputed():
    """Requests sharing a 32-token preamble: a state-only model has no
    ring pages to share, so neither engine hits the prefix index and both
    recompute the preamble to the same tokens."""
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
    assert tc.get("kv_prefix_hits", 0) == jc.get("kv_prefix_hits", 0) == 0
    same_counters(out[je], out[te])


@pytest.mark.parametrize("evict_mode", ["swap", "restart"])
def test_more_streams_than_state_slots(evict_mode):
    """One state slot per domain and six open-loop requests: admissions
    wait in line for slots; both engines admit and finish the same
    streams in the same order with the same tokens, and the pool ends
    empty."""
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


@pytest.mark.parametrize("at_tick", [3, 9])
def test_relayout_mid_run(at_tick):
    """Four replica groups merge into two after the ``at_tick``-th engine
    tick, with streams mid-prefill and mid-decode: in-flight tables move
    their state slots, and both engines move the same slots and keep
    their tokens."""
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
    same_counters(out[je], out[te])
    te.pool.audit([])
