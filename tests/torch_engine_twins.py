"""Helpers of the engine parity tests (``test_torch_spec_*.py``,
``test_torch_async_swap.py``, ``test_torch_warm_steps.py``): a JAX engine
and its port twin on the same config and weights, the injected drafters of
``tests/test_spec_decode.py``, and exact counter comparison."""
from typing import List

import jax
import numpy as np

from repro.configs import REGISTRY, reduced_config
from repro.core.topology import ChipletTopology as JTopology
from repro.serving.engine import EngineConfig as JEngineConfig
from repro.serving.engine import ServeEngine as JServeEngine
from repro_torch.configs import REGISTRY as T_REGISTRY
from repro_torch.configs import reduced_config as t_reduced
from repro_torch.core.topology import ChipletTopology as TTopology
from repro_torch.models.params import from_reference
from repro_torch.serving.engine import EngineConfig as TEngineConfig
from repro_torch.serving.engine import ServeEngine as TServeEngine


def configs(arch):
    return reduced_config(REGISTRY[arch]), t_reduced(T_REGISTRY[arch])


def ecfg_kw(*, spec="ngram", spec_k=3, max_batch=2, max_len=48,
            pool_streams=2, share=False, evict_mode="swap", **kw):
    """The engine options of ``tests/test_spec_decode.py``'s ``_engine``,
    ``kw`` over them (``paged`` and ``lazy`` among them)."""
    return {**dict(max_batch=max_batch, max_len=max_len, paged=True,
                   lazy=True, pool_streams=pool_streams, adaptive=False,
                   evict_mode=evict_mode, prefix_share=share,
                   spec_decode=spec, spec_k=spec_k), **kw}


class Twins:
    """A JAX engine and port engines on the same reduced ``arch`` and the
    JAX engine's weights."""

    def __init__(self, arch, groups=1, **kw):
        self.jcfg, self.tcfg = configs(arch)
        self.groups = groups
        self.kw = ecfg_kw(**kw)
        self.jax = JServeEngine(self.jcfg, self._jtopo(),
                                JEngineConfig(**self.kw), spread_rate=1,
                                seed=0)
        self.params = from_reference(jax.tree.map(np.asarray,
                                                  self.jax.params),
                                     device="cpu")

    def _jtopo(self):
        return JTopology(n_pods=1, groups_per_pod=self.groups,
                         chips_per_group=1)

    def port(self, **over):
        """A port engine with this pair's options, ``over`` on top."""
        return TServeEngine(self.tcfg, TTopology(
            n_pods=1, groups_per_pod=self.groups, chips_per_group=1),
            TEngineConfig(**{**self.kw, **over}), spread_rate=1,
            params=self.params, device="cpu")

    def jax_engine(self, **over):
        """Another JAX engine on the same weights (seed 0)."""
        return JServeEngine(self.jcfg, self._jtopo(),
                            JEngineConfig(**{**self.kw, **over}),
                            spread_rate=1, seed=0)


def serve(eng, prompts, max_new) -> List[List[int]]:
    for p, m in zip(prompts, max_new):
        eng.submit(p, m)
    eng.run_until_done()
    assert all(r.done for r in eng.submitted), "deadlock"
    return [r.generated for r in eng.submitted]


def tokens(eng):
    return [r.generated for r in sorted(eng.submitted, key=lambda r: r.rid)]


def same_counters(jeng, teng, skip=()):
    """Every counter of the two engines, exactly (``skip``: names left
    out)."""
    jc = {k: v for k, v in jeng.counters.totals.items() if k not in skip}
    tc = {k: v for k, v in teng.counters.totals.items() if k not in skip}
    assert set(jc) == set(tc), (set(jc) ^ set(tc))
    diff = {k: (jc[k], tc[k]) for k in tc if jc[k] != tc[k]}
    assert not diff, diff


class OracleDrafter:
    """Replays a spec-off baseline: every draft token is exactly what
    greedy decode will produce, so every verify is a FULL accept."""

    def __init__(self, prompts, baselines):
        self._by_prompt = {tuple(int(t) for t in p): list(b)
                           for p, b in zip(prompts, baselines)}

    def draft(self, req, k: int) -> List[int]:
        base = self._by_prompt[tuple(int(t) for t in req.prompt)]
        done = len(req.generated)
        return base[done:done + k]


class AntiOracleDrafter(OracleDrafter):
    """Baseline+1 mod vocab: every draft token is WRONG, so every verify
    is a full reject and only the boundary token commits."""

    def __init__(self, prompts, baselines, vocab):
        super().__init__(prompts, baselines)
        self._vocab = vocab

    def draft(self, req, k: int) -> List[int]:
        return [(t + 1) % self._vocab for t in super().draft(req, k)]


class PartialDrafter(OracleDrafter):
    """``good`` correct tokens followed by wrong ones: every full-width
    verify accepts a strict prefix and rolls back the rest."""

    def __init__(self, prompts, baselines, vocab, good=1):
        super().__init__(prompts, baselines)
        self._vocab = vocab
        self._good = good

    def draft(self, req, k: int) -> List[int]:
        toks = super().draft(req, k)
        return (toks[:self._good]
                + [(t + 1) % self._vocab for t in toks[self._good:]])


def served_pair(arch, prompts, max_new, *, groups=2, **kw):
    """A JAX engine and its port twin with the options of
    ``tests/test_continuous_batching.py``'s ``_run`` (``max_batch=2,
    max_len=32, pool_streams=1``, ``kw`` over them), each having served
    ``prompts`` to their budgets: (JAX engine, port engine, JAX tokens,
    port tokens), tokens in submission order."""
    jcfg, tcfg = configs(arch)
    opts = {**dict(max_batch=2, max_len=32, pool_streams=1,
                   adaptive=False), **kw}
    topo = dict(n_pods=1, groups_per_pod=groups, chips_per_group=1)
    jeng = JServeEngine(jcfg, JTopology(**topo), JEngineConfig(**opts),
                        spread_rate=1, seed=0)
    params = from_reference(jax.tree.map(np.asarray, jeng.params),
                            device="cpu")
    teng = TServeEngine(tcfg, TTopology(**topo), TEngineConfig(**opts),
                        spread_rate=1, params=params, device="cpu")
    return jeng, teng, serve(jeng, prompts, max_new), \
        serve(teng, prompts, max_new)
