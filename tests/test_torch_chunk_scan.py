"""The per-token scan chunk step (``decode.chunk_decode_step``,
``prefill_mode="scan"``) in the port against the JAX package, on the CPU,
on reduced llama3-8b, mamba2-780m and recurrentgemma-9b in float32 with
the JAX weights carried across.

Tolerances: logits and cache leaves within 1e-4 of JAX's
``chunk_decode_step``.  Inside the port the scan is exact: a stream's
cache and logits equal feeding it its tokens one ``decode_step`` at a
time, bit for bit, and a stream past its ``n_tokens`` (idle, or finished
early in the chunk) comes out of each later step bit-unchanged.  Both
step builders default to the scan, as in the JAX package."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import REGISTRY, reduced_config
from repro.launch import steps as JS
from repro.models import decode as JD
from repro.models.params import init_params as j_init_params
from repro_torch.configs import REGISTRY as T_REGISTRY
from repro_torch.configs import reduced_config as t_reduced
from repro_torch.launch import steps as TS
from repro_torch.models import decode as TD
from repro_torch.models.params import from_reference

FAMILIES = ("llama3-8b", "mamba2-780m", "recurrentgemma-9b")
TOL = 1e-4
MAX_LEN, B, C = 48, 4, 5
# ragged lengths: a full chunk, a stream that finishes mid-chunk, an idle
# slot and a single decode token; the third sits past the hybrid's
# 32-token local window, so its ring wraps
N_TOKENS = np.asarray([5, 3, 0, 1], np.int32)
POS = np.asarray([0, 13, 40, 29], np.int32)


@pytest.fixture(scope="module", params=FAMILIES)
def model(request):
    arch = request.param
    jcfg = reduced_config(REGISTRY[arch])
    tcfg = t_reduced(T_REGISTRY[arch])
    jp = j_init_params(jcfg, jax.random.PRNGKey(0))
    tp = from_reference(jax.tree.map(np.asarray, jp), device="cpu")
    rng = np.random.default_rng(5)
    jcache = jax.tree.map(lambda a: jnp.asarray(
        0.3 * rng.standard_normal(a.shape).astype(np.float32)),
        JD.init_cache(jcfg, B, MAX_LEN))
    toks = rng.integers(2, jcfg.vocab, size=(B, C)).astype(np.int32)
    return jcfg, tcfg, jp, tp, jcache, toks


def _port_cache(tspec, jcache):
    return TD.tree_from_leaves(tspec, [
        torch.from_numpy(np.array(a)) for a in jax.tree.leaves(jcache)])


def _inputs(toks):
    return [torch.from_numpy(a) for a in (toks, POS, N_TOKENS)]


@pytest.mark.parametrize("all_logits", [False, True])
def test_chunk_decode_step_matches_reference(model, all_logits):
    """Ragged ``n_tokens`` (0 included): logits (last active token, or
    every position with NEG_INF at and past ``n_tokens``) and the cache
    equal JAX's; C layer-stack walks; the idle stream's every leaf is
    bit-unchanged."""
    jcfg, tcfg, jp, tp, jcache, toks = model
    jspec = JD.cache_view_specs(jcfg, MAX_LEN)
    tspec = TD.cache_view_specs(tcfg, MAX_LEN)
    jl, jc = JD.chunk_decode_step(jp, jcfg, jspec, jcache, jnp.asarray(toks),
                                  jnp.asarray(POS), jnp.asarray(N_TOKENS),
                                  all_logits=all_logits)
    tc0 = _port_cache(tspec, jcache)
    before = [t.clone() for t in TD.tree_leaves(tc0, tspec)]
    walks = TD.layer_walks()
    tl, tc = TD.chunk_decode_step(tp, tcfg, tspec, tc0, *_inputs(toks),
                                  all_logits=all_logits)
    assert TD.layer_walks() - walks == C
    jl = np.asarray(jl)
    assert tl.shape == jl.shape
    np.testing.assert_allclose(tl.numpy(), jl, rtol=TOL, atol=TOL)
    if all_logits:
        live = np.arange(C)[None, :] < N_TOKENS[:, None]
        assert (tl.numpy()[~live] == jl[~live]).all()
    else:
        assert (tl.numpy()[2] == jl[2]).all()             # the idle row
    for a, b in zip(jax.tree.leaves(jc), TD.tree_leaves(tc, tspec)):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=TOL,
                                   atol=TOL)
    for old, new, s in zip(before, TD.tree_leaves(tc, tspec), tspec.leaves):
        assert torch.equal(old.select(s.batch_axis, 2),
                           new.select(s.batch_axis, 2))


def test_scan_is_single_token_stepping(model):
    """Every stream's cache and last logits equal feeding the whole batch
    its tokens one ``decode_step`` at a time and stopping at the stream's
    own ``n_tokens``, bit for bit: steps past a stream's length leave it
    exactly as its last token left it."""
    _, tcfg, _, tp, jcache, toks = model
    tspec = TD.cache_view_specs(tcfg, MAX_LEN)
    tl, tc = TD.chunk_decode_step(tp, tcfg, tspec,
                                  _port_cache(tspec, jcache), *_inputs(toks))
    got = TD.tree_leaves(tc, tspec)
    cache = _port_cache(tspec, jcache)
    for t in range(C):
        lg, cache = TD.decode_step(
            tp, tcfg, cache, torch.from_numpy(toks[:, t:t + 1]),
            torch.from_numpy(POS + t))
        for i in np.flatnonzero(N_TOKENS == t + 1):
            assert torch.equal(tl[i], lg[i])
            for want, have, s in zip(TD.tree_leaves(cache, tspec), got,
                                     tspec.leaves):
                assert torch.equal(have.select(s.batch_axis, i),
                                   want.select(s.batch_axis, i))


def test_builders_default_to_the_scan(model):
    """``make_serve_chunk_step`` and ``make_spec_verify_step`` called with
    no mode take the scan in both packages: the port's layer walks advance
    by C, and the outputs match the JAX builders' own defaults."""
    jcfg, tcfg, jp, tp, jcache, toks = model
    jspec = JD.cache_view_specs(jcfg, MAX_LEN)
    tspec = TD.cache_view_specs(tcfg, MAX_LEN)
    args = (jnp.asarray(toks), jnp.asarray(POS), jnp.asarray(N_TOKENS))
    for jmake, tmake in ((JS.make_serve_chunk_step, TS.make_serve_chunk_step),
                         (JS.make_spec_verify_step, TS.make_spec_verify_step)):
        jl, jc = jmake(jcfg, jspec)(jp, jcache, *args)
        walks = TD.layer_walks()
        tl, tc = tmake(tcfg, tspec)(tp, _port_cache(tspec, jcache),
                                    *_inputs(toks))
        assert TD.layer_walks() - walks == C
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=TOL,
                                   atol=TOL)
        for a, b in zip(jax.tree.leaves(jc), TD.tree_leaves(tc, tspec)):
            np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=TOL,
                                       atol=TOL)


def test_builders_check_their_options():
    cfg = t_reduced(T_REGISTRY["llama3-8b"])
    spec = TD.cache_view_specs(cfg, 16)
    for make in (TS.make_serve_chunk_step, TS.make_spec_verify_step):
        with pytest.raises(ValueError, match="chunk-step mode"):
            make(cfg, spec, mode="fused")
        with pytest.raises(ValueError, match="chunk kernel"):
            make(cfg, spec, chunk_kernel="flash")
