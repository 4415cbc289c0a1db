"""The port's eager engine (``lazy=False``: whole-prompt prefill into a
full-length reservation) and slot monolith (``paged=False``) against the
JAX package, on the CPU, on the scenarios of
``tests/test_continuous_batching.py`` and ``tests/test_substrates.py``
that run them: reduced models in float32, the JAX engine's weights
carried across by ``from_reference``.

Each engine gives the JAX engine's tokens and every counter exactly; the
three allocator modes give one another's tokens.  One caveat of the
reference (ROADMAP C): the JAX monolith writes a hybrid model's TAIL
state leaves, whose stream axis is 0, along axis 1; the port writes every
leaf along its own stream axis, so for the hybrid the port's monolith is
held to the JAX eager engine's tokens (and the JAX monolith's counters)."""
import jax
import numpy as np
import pytest
import torch

from repro.core.controller import ControllerConfig as JControllerConfig
from repro.core.topology import ChipletTopology as JTopology
from repro.serving.engine import EngineConfig as JEngineConfig
from repro.serving.engine import ServeEngine as JServeEngine
from repro_torch.configs import REGISTRY, reduced_config
from repro_torch.core.controller import ControllerConfig
from repro_torch.core.topology import ChipletTopology
from repro_torch.models import decode as TD
from repro_torch.models.params import from_reference
from repro_torch.serving.engine import EngineConfig, ServeEngine
from torch_engine_twins import configs, same_counters, served_pair

FAMILIES = ("llama3-8b", "mamba2-780m", "recurrentgemma-9b")
MODES = {"lazy": dict(lazy=True, paged=True),
         "eager": dict(lazy=False, paged=True),
         "legacy": dict(lazy=False, paged=False)}


def _mix(cfg, seed):
    """``test_lazy_eager_legacy_token_identity``'s random request mix."""
    rng = np.random.default_rng(seed)
    n = int(rng.integers(2, 6))
    prompts = [rng.integers(2, cfg.vocab, size=int(rng.integers(3, 28)))
               for _ in range(n)]
    return prompts, [int(rng.integers(1, 20)) for _ in range(n)]


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("arch", FAMILIES)
def test_lazy_eager_legacy_token_identity(arch, seed):
    """Random mixes on a tight pool (``pool_streams=1``: streams park and
    rings wrap): the port's lazy, eager and monolith engines give one
    set of tokens, each mode the JAX engine's tokens and counters."""
    jcfg, _ = configs(arch)
    prompts, max_new = _mix(jcfg, seed)
    outs, jouts = {}, {}
    for mode, opts in MODES.items():
        jeng, teng, jt, tt = served_pair(arch, prompts, max_new, **opts)
        same_counters(jeng, teng)
        assert [len(t) for t in tt] == max_new
        outs[mode], jouts[mode] = tt, jt
        assert (teng.pool is None) == (mode == "legacy")
    assert outs["lazy"] == outs["eager"] == outs["legacy"]
    assert outs["lazy"] == jouts["lazy"] and outs["eager"] == jouts["eager"]
    if not jcfg.block_pattern:
        assert outs["legacy"] == jouts["legacy"]


def test_forced_mid_decode_park_token_identity():
    """A stream that parks mid-decode on one domain resumes and gives the
    eager run's tokens; the eager twin is the JAX eager engine's."""
    jcfg, _ = configs("llama3-8b")
    rng = np.random.default_rng(0)
    prompts = [rng.integers(2, jcfg.vocab, size=4) for _ in range(4)]
    max_new = [24, 8, 8, 8]
    jl, tl, _, lazy = served_pair("llama3-8b", prompts, max_new, groups=1)
    assert tl.counters.totals.get("kv_mid_decode_parks", 0) >= 1
    je, te, jt, eager = served_pair("llama3-8b", prompts, max_new, groups=1,
                                    lazy=False)
    same_counters(je, te)
    assert eager == jt == lazy
    assert te.counters.totals.get("kv_mid_decode_parks", 0) == 0
    assert te.pool.occupancy() == 0.0


def test_eviction_breaks_incremental_allocation_deadlock():
    """The restart-eviction deadlock breaker's tokens equal the eager
    (serialized) run's, in both packages."""
    jcfg, _ = configs("llama3-8b")
    rng = np.random.default_rng(2)
    prompts = [rng.integers(2, jcfg.vocab, size=4) for _ in range(2)]
    max_new = [26, 26]
    jl, tl, jt, lazy = served_pair("llama3-8b", prompts, max_new, groups=1,
                                   evict_mode="restart")
    same_counters(jl, tl)
    assert tl.counters.totals["kv_evictions"] >= 1 and lazy == jt
    je, te, jt_e, eager = served_pair("llama3-8b", prompts, max_new,
                                      groups=1, evict_mode="restart",
                                      lazy=False)
    same_counters(je, te)
    assert eager == jt_e == lazy


@pytest.mark.parametrize("arch", FAMILIES)
def test_eager_max_new_one_frees_without_a_slot(arch):
    """A request whose budget the prefill token meets finishes at
    admission: no decode slot, its pages free, the pool drains; counters
    equal the JAX engine's."""
    jcfg, _ = configs(arch)
    rng = np.random.default_rng(4)
    prompts = [rng.integers(2, jcfg.vocab, size=s) for s in (20, 9, 13)]
    max_new = [1, 5, 1]
    je, te, jt, tt = served_pair(arch, prompts, max_new, lazy=False)
    same_counters(je, te)
    assert tt == jt and [len(t) for t in tt] == max_new
    assert te.counters.totals["prefills"] == 3
    assert te.pool.occupancy() == 0.0
    assert te.kv_stats()["chunk_ticks"] == 0


def test_serving_legacy_slot_monolith_still_works():
    """``test_substrates.py``'s monolith check: paged and monolith engines
    give the same tokens, each the JAX engine's, counters included."""
    jcfg, _ = configs("llama3-8b")
    rng = np.random.default_rng(3)
    prompts = [rng.integers(2, jcfg.vocab, size=7) for _ in range(4)]
    runs = {}
    for paged in (True, False):
        je, te, jt, tt = served_pair("llama3-8b", prompts, [4] * 4,
                                     max_batch=2, max_len=32, paged=paged,
                                     pool_streams=None)
        same_counters(je, te)
        assert tt == jt
        runs[paged] = tt
    assert runs[True] == runs[False]
    assert te.kv_stats() == {} and te.pool is None


@pytest.mark.parametrize("arch", ["llama3-8b", "mamba2-780m"])
def test_serving_midrun_relayout_preserves_tokens(arch):
    """``test_substrates.py``'s relayout scenario on the slot monolith: the
    controller rebuilds the replica groups mid-run, each in-flight stream
    carries its cache slice to the group the round-robin deal gives it,
    and the tokens equal a non-adaptive run's and the JAX engine's, with
    the same relayouts and counters."""
    jcfg, tcfg = configs(arch)
    rng = np.random.default_rng(7)
    prompts = [rng.integers(2, jcfg.vocab, size=6) for _ in range(12)]
    max_new = [2 if i % 4 == 0 else 10 for i in range(12)]
    ctl = dict(scheduler_timer=3, threshold=1.0, min_dwell=1)
    topo = dict(n_pods=1, groups_per_pod=4, chips_per_group=1)
    outs = {}
    for adaptive in (True, False):
        opts = dict(max_batch=1, max_len=32, adaptive=adaptive, paged=False)
        je = JServeEngine(jcfg, JTopology(**topo), JEngineConfig(
            **opts, controller=JControllerConfig(**ctl)), spread_rate=1,
            seed=0)
        te = ServeEngine(tcfg, ChipletTopology(**topo), EngineConfig(
            **opts, controller=ControllerConfig(**ctl)), spread_rate=1,
            params=from_reference(jax.tree.map(np.asarray, je.params),
                                  device="cpu"), device="cpu")
        res = {}
        for name, eng in (("jax", je), ("port", te)):
            for p, m in zip(prompts, max_new):
                eng.submit(p, max_new=m)
            res[name] = eng.run_until_done()
            assert all(r.done for r in eng.submitted)
        same_counters(je, te)
        assert res["port"]["relayouts"] == res["jax"]["relayouts"]
        toks = [r.generated for r in te.submitted]
        assert toks == [r.generated for r in je.submitted]
        outs[adaptive] = (toks, res["port"])
    toks, res = outs[True]
    assert toks == outs[False][0]
    assert len(res["relayouts"]) >= 1 and res["relayouts"][0]["moved_slots"]
    assert res["counters"]["kv_slots_migrated"] == \
        res["counters"]["kv_slots_restored"]
    assert "kv" not in res and outs[False][1]["relayouts"] == []


def test_monolith_slot_holds_the_prefill_cache():
    """The monolith's admission copies the whole-prompt prefill into its
    slot along every leaf's own stream axis — the hybrid's tail state
    leaves (stream axis 0) included — and leaves the other slot alone."""
    cfg = reduced_config(REGISTRY["recurrentgemma-9b"])
    eng = ServeEngine(cfg, ChipletTopology(1, 1, 1), EngineConfig(
        max_batch=2, max_len=32, paged=False, adaptive=False),
        device="cpu")
    prompt = np.random.default_rng(0).integers(2, cfg.vocab, size=9)
    eng.submit(prompt, max_new=3)
    g = eng.groups[0]
    spec = eng._cache_spec
    before = [t.clone() for t in TD.tree_leaves(g.cache, spec)]
    eng._admit(g)
    assert g.slots[0] is not None and int(g.pos_h[0]) == 9
    _, one = TD.prefill(eng.params, cfg,
                        torch.from_numpy(prompt[None, :].astype(np.int32)),
                        max_len=32)
    assert any(p[0] == "tail" for p in spec.paths)
    for leaf, old, want, s in zip(TD.tree_leaves(g.cache, spec), before,
                                  TD.tree_leaves(one, spec), spec.leaves):
        assert torch.equal(leaf.select(s.batch_axis, 0),
                           want.select(s.batch_axis, 0))
        assert torch.equal(leaf.select(s.batch_axis, 1),
                           old.select(s.batch_axis, 1))
