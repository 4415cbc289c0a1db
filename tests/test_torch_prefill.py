"""Whole-prompt prefill in the port against the JAX package, on the CPU:
``transformer.forward(return_states=True)``, ``decode.prefill`` (with its
ring arrangement), ``steps.make_prefill`` and ``steps.make_generate``, on
reduced llama3-8b, mamba2-780m and recurrentgemma-9b in float32 with the
JAX weights carried across by ``from_reference``; the VLM and
encoder-decoder prefills through ``make_prefill``'s extras; prefill,
decode and both chunk steps on reduced nemotron-4-15b and starcoder2-15b;
and bf16 prefill and decode on mamba2-780m and recurrentgemma-9b (2e-2 of
the logits' scale).

Tolerances: last-token logits within 1e-4, every cache leaf within 2e-4
(absolute and relative: keys and values pass through more float32 sums
than the logits' last row), greedy tokens identical."""
import dataclasses
import functools

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
from repro_torch.models import transformer as TT
from repro_torch.models.params import from_reference
from repro_torch.models.params import init_params as t_init_params

FAMILIES = ("llama3-8b", "mamba2-780m", "recurrentgemma-9b")
LOGIT_TOL, CACHE_TOL = 1e-4, 2e-4


@pytest.fixture(scope="module", params=FAMILIES)
def model(request):
    arch = request.param
    jcfg = reduced_config(REGISTRY[arch])
    tcfg = t_reduced(T_REGISTRY[arch])
    jp = j_init_params(jcfg, jax.random.PRNGKey(0))
    return jcfg, tcfg, jp, from_reference(jax.tree.map(np.asarray, jp),
                                          device="cpu")


def _tokens(cfg, B, S, seed):
    rng = np.random.default_rng(seed)
    return rng.integers(2, cfg.vocab, size=(B, S)).astype(np.int32)


# (S, max_len): a prompt shorter than the ring (zero-padded), one longer
# than the dense ring and the hybrid's 32-token local window (rolled so
# position p sits in slot p % W), and lengths that are no multiple of the
# reduced SSD chunk (32: the scan front-pads)
CASES = [(13, 48), (40, 24), (37, 64)]


@pytest.mark.parametrize("S,max_len", CASES)
def test_prefill_matches_reference(model, S, max_len):
    """Logits after the last token and every cache leaf equal JAX's
    ``prefill``; the cache has ``init_cache``'s layout."""
    jcfg, tcfg, jp, tp = model
    toks = _tokens(jcfg, 2, S, seed=S)
    jl, jc = JD.prefill(jp, jcfg, jnp.asarray(toks), max_len=max_len)
    tl, tc = TD.prefill(tp, tcfg, torch.from_numpy(toks), max_len=max_len)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=LOGIT_TOL,
                               atol=LOGIT_TOL)
    spec = TD.cache_view_specs(tcfg, max_len)
    ref = TD.init_cache(tcfg, 2, max_len, device="cpu")
    jleaves = jax.tree.leaves(jc)
    tleaves = TD.tree_leaves(tc, spec)
    assert len(jleaves) == len(tleaves)
    for a, b, z in zip(jleaves, tleaves, TD.tree_leaves(ref, spec)):
        assert b.shape == z.shape and b.dtype == z.dtype
        np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=CACHE_TOL,
                                   atol=CACHE_TOL)


def test_ring_arrange_positions():
    """Position p lands in slot p % W when the prompt overruns the ring;
    a short prompt is zero-padded behind its last position."""
    kv = torch.arange(1, 11, dtype=torch.float32).reshape(1, 10, 1, 1)
    ring = TD._ring_arrange(kv, 4)[0, :, 0, 0]
    assert ring.tolist() == [9.0, 10.0, 7.0, 8.0]   # positions 8, 9, 6, 7
    want = np.asarray(JD._ring_arrange(jnp.asarray(kv.numpy()), 4))
    np.testing.assert_array_equal(TD._ring_arrange(kv, 4).numpy(), want)
    short = TD._ring_arrange(kv[:, :3], 6)[0, :, 0, 0]
    assert short.tolist() == [1.0, 2.0, 3.0, 0.0, 0.0, 0.0]


def test_prefill_of_a_short_prompt_equals_decode_steps(model):
    """A prompt shorter than the conv's K-1 inputs: the conv tails come
    front-padded with a fresh state's zeros (the JAX package returns them
    at the prompt's length, which its cache cannot hold), and the whole
    cache equals the one two single-token steps build from zero, within
    the cache tolerance."""
    _, tcfg, _, tp = model
    max_len = 24
    toks = torch.from_numpy(_tokens(tcfg, 2, 2, seed=7))
    tl, tc = TD.prefill(tp, tcfg, toks, max_len=max_len)
    spec = TD.cache_view_specs(tcfg, max_len)
    cache = TD.init_cache(tcfg, 2, max_len, device="cpu")
    for t in range(2):
        lg, cache = TD.decode_step(tp, tcfg, cache, toks[:, t:t + 1],
                                   torch.full((2,), t, dtype=torch.int32))
    np.testing.assert_allclose(tl.numpy(), lg.numpy(), rtol=LOGIT_TOL,
                               atol=LOGIT_TOL)
    for a, b in zip(TD.tree_leaves(cache, spec), TD.tree_leaves(tc, spec)):
        assert a.shape == b.shape
        np.testing.assert_allclose(b.numpy(), a.numpy(), rtol=CACHE_TOL,
                                   atol=CACHE_TOL)


def test_forward_states_leave_the_hidden_states_alone(model):
    """``forward(return_states=True)`` gives the plain forward's hidden
    states bit for bit, runs without autograd, and stacks one state per
    layer (a hybrid: per group, plus its tail by name)."""
    _, tcfg, _, tp = model
    toks = torch.from_numpy(_tokens(tcfg, 2, 9, seed=3))
    x, aux = TT.forward(tp, tcfg, toks)
    xs, states, aux2 = TT.forward(tp, tcfg, toks, return_states=True)
    assert torch.equal(xs, x) and float(aux2) == float(aux) == 0.0
    assert not xs.requires_grad
    if tcfg.block_pattern:
        assert set(states) == {"groups", "tail"}
        assert set(states["tail"]) == {"t0_rec", "t1_rec"}
        assert states["groups"]["b2_attn"]["k"].shape[:3] == (1, 2, 9)
    else:
        lead = next(iter(states["layers"].values()))
        assert set(states) == {"layers"}
        assert lead.shape[:2] == (tcfg.n_layers, 2)


def test_make_prefill_and_generate_match_reference(model):
    """``make_prefill`` then ``make_generate`` greedy for 12 tokens past a
    19-token prompt (a 24-token cache: the ring wraps): tokens identical to
    the JAX package's, and the final position advanced by 12."""
    jcfg, tcfg, jp, tp = model
    max_len, steps = 24, 12
    toks = _tokens(jcfg, 2, 19, seed=11)
    jl, jc = JS.make_prefill(jcfg, max_len)(jp, {"tokens": jnp.asarray(toks)})
    tl, tc = TS.make_prefill(tcfg, max_len)(
        tp, {"tokens": torch.from_numpy(toks)})
    first = np.asarray(jnp.argmax(jl, -1)).astype(np.int32)
    assert (tl.argmax(-1).numpy() == first).all()
    pos = np.full((2,), 19, np.int32)
    jt, _, jpos = JS.make_generate(jcfg, steps)(
        jp, jc, jnp.asarray(first[:, None]), jnp.asarray(pos),
        jax.random.PRNGKey(0))
    tt, _, tpos = TS.make_generate(tcfg, steps)(
        tp, tc, torch.from_numpy(first[:, None]), torch.from_numpy(pos))
    assert tt.dtype == torch.int32 and tuple(tt.shape) == (2, steps)
    np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))
    np.testing.assert_array_equal(tpos.numpy(), np.asarray(jpos))


def test_generate_with_temperature_follows_its_generator():
    """Temperature sampling draws from an explicit ``torch.Generator``:
    the same seed gives the same tokens, every token in the vocabulary."""
    cfg = t_reduced(T_REGISTRY["llama3-8b"])
    from repro_torch.models.params import init_params
    params = init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    toks = torch.from_numpy(_tokens(cfg, 2, 5, seed=2))
    gen = TS.make_generate(cfg, 6, temperature=1.0)
    runs = []
    for _ in range(2):
        _, cache = TS.make_prefill(cfg, 16)(params, {"tokens": toks})
        out, _, _ = gen(params, cache, toks[:, -1:], torch.full(
            (2,), 5, dtype=torch.int32), torch.Generator().manual_seed(4))
        runs.append(out)
    assert torch.equal(runs[0], runs[1])
    assert ((runs[0] >= 0) & (runs[0] < cfg.vocab)).all()


def test_prefill_of_unported_families_raises():
    """``make_prefill`` hands every batch key but ``tokens`` to
    ``decode.prefill`` as extras, as the JAX package does: the
    encoder-decoder prefill (``encdec_prefill``, from ``frame_embeds``)
    and the VLM's (``vision_embeds`` ahead of the text, M-RoPE
    ``position_ids``) give the JAX package's logits and cache leaves."""
    rng = np.random.default_rng(5)
    for name in ("seamless-m4t-large-v2", "qwen2-vl-2b"):
        jcfg = reduced_config(REGISTRY[name])
        tcfg = t_reduced(T_REGISTRY[name])
        jp = j_init_params(jcfg, jax.random.PRNGKey(0))
        tp = from_reference(jax.tree.map(np.asarray, jp), device="cpu")
        toks = _tokens(jcfg, 2, 6, seed=9)
        emb = (rng.standard_normal((2, 5, jcfg.d_model)) * 0.02) \
            .astype(np.float32)
        if jcfg.family == "encdec":
            batch = {"tokens": toks, "frame_embeds": emb}
        else:
            batch = {"tokens": toks, "vision_embeds": emb,
                     "position_ids": np.stack([
                         np.arange(11), np.arange(11) // 2,
                         np.arange(11) % 3])[:, None].repeat(2, 1)
                     .astype(np.int32)}
        jl, jc = jax.jit(JS.make_prefill(jcfg, 16))(
            jp, {k: jnp.asarray(v) for k, v in batch.items()})
        tl, tc = TS.make_prefill(tcfg, 16)(
            tp, {k: torch.from_numpy(v) for k, v in batch.items()})
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl),
                                   rtol=LOGIT_TOL, atol=LOGIT_TOL,
                                   err_msg=name)
        spec = TD.cache_view_specs(tcfg, 16, 5)
        jleaves = jax.tree.leaves(jc)
        assert len(jleaves) == len(spec.paths)
        for a, b in zip(jleaves, TD.tree_leaves(tc, spec)):
            np.testing.assert_allclose(b.numpy(), np.asarray(a),
                                       rtol=CACHE_TOL, atol=CACHE_TOL,
                                       err_msg=name)


def jitted(fn, **static):
    """A JAX step with its config (and cache layout) bound, compiled once:
    the JAX package runs its steps jitted, and on the CPU one compile
    costs less than the op-by-op dispatch of an eager call."""
    return jax.jit(functools.partial(fn, **static))


@pytest.mark.parametrize("arch", ["nemotron-4-15b", "starcoder2-15b"])
def test_dense_configs_prefill_decode_and_chunk_steps(arch):
    """The dense configs beside llama3-8b — nemotron-4-15b (squared_relu)
    and starcoder2-15b (gelu, 4 kv heads) — through ``prefill`` into a
    ring the prompt overruns, 6 ``decode_step``s, then
    ``prefill_chunk_step`` (blocked and dense) and ``chunk_decode_step``
    with a prefill, a decode and an idle row: logits and every cache leaf
    equal the JAX package's."""
    jcfg = reduced_config(REGISTRY[arch])
    tcfg = t_reduced(T_REGISTRY[arch])
    jp = j_init_params(jcfg, jax.random.PRNGKey(0))
    tp = from_reference(jax.tree.map(np.asarray, jp), device="cpu")
    max_len, P = 24, 30
    spec = TD.cache_view_specs(tcfg, max_len)
    jspec = JD.cache_view_specs(jcfg, max_len)

    def same(jl, jc, tl, tc, live=slice(None)):
        np.testing.assert_allclose(tl.numpy()[live], np.asarray(jl)[live],
                                   rtol=LOGIT_TOL, atol=LOGIT_TOL)
        for a, b in zip(jax.tree.leaves(jc), TD.tree_leaves(tc, spec)):
            np.testing.assert_allclose(b.numpy(), np.asarray(a),
                                       rtol=CACHE_TOL, atol=CACHE_TOL)

    toks = _tokens(jcfg, 3, P, seed=21)
    jl, jc = jitted(JD.prefill, cfg=jcfg, max_len=max_len)(
        jp, tokens=jnp.asarray(toks))
    tl, tc = TD.prefill(tp, tcfg, torch.from_numpy(toks), max_len=max_len)
    same(jl, jc, tl, tc)
    pos = np.full((3,), P, np.int32)
    decode = jitted(JD.decode_step, cfg=jcfg)
    for _ in range(6):
        nxt = np.asarray(jnp.argmax(jl, -1)).astype(np.int32)[:, None]
        jl, jc = decode(jp, cache=jc, tokens=jnp.asarray(nxt),
                        pos=jnp.asarray(pos))
        tl, tc = TD.decode_step(tp, tcfg, tc, torch.from_numpy(nxt),
                                torch.from_numpy(pos))
        same(jl, jc, tl, tc)
        pos = pos + 1
    chunk = _tokens(jcfg, 3, 5, seed=22)
    n = np.array([5, 1, 0], np.int32)
    args = dict(tokens=jnp.asarray(chunk), pos=jnp.asarray(pos),
                n_tokens=jnp.asarray(n))
    targs = (torch.from_numpy(chunk), torch.from_numpy(pos),
             torch.from_numpy(n))
    clone = lambda: jax.tree.map(lambda t: t.clone(), tc)  # noqa: E731
    for kernel in ("blocked", "dense"):
        jl2, jc2 = jitted(JD.prefill_chunk_step, cfg=jcfg, spec=jspec,
                          chunk_kernel=kernel)(jp, cache=jc, **args)
        tl2, tc2 = TD.prefill_chunk_step(tp, tcfg, spec, clone(), *targs,
                                         chunk_kernel=kernel)
        same(jl2, jc2, tl2, tc2, n > 0)
    jl3, jc3 = jitted(JD.chunk_decode_step, cfg=jcfg, spec=jspec)(
        jp, cache=jc, **args)
    tl3, tc3 = TD.chunk_decode_step(tp, tcfg, spec, clone(), *targs)
    same(jl3, jc3, tl3, tc3, n > 0)


@pytest.mark.parametrize("arch", ["mamba2-780m", "recurrentgemma-9b"])
def test_bf16_prefill_and_decode(arch):
    """bf16 weights and compute: ``prefill`` of two 40-token prompts, then
    8 greedy ``decode_step``s fed the JAX package's tokens, every step's
    logits within 2e-2 of the JAX logits' scale (the JAX package's bf16
    kernel tolerance).  The weights are the port's seeded draw, rounded
    to bf16 in both packages."""
    kw = dict(param_dtype="bfloat16", compute_dtype="bfloat16")
    jcfg = dataclasses.replace(reduced_config(REGISTRY[arch]), **kw)
    tcfg = dataclasses.replace(t_reduced(T_REGISTRY[arch]), **kw)
    drawn = t_init_params(tcfg, torch.Generator().manual_seed(5),
                          device="cpu")
    jp = jax.tree.map(lambda w: jnp.asarray(w.float().numpy())
                      .astype(jnp.bfloat16), drawn)
    tp = from_reference(jax.tree.map(np.asarray, jp), device="cpu")
    real = slice(0, jcfg.vocab)

    def within(jl, tl):
        want = np.asarray(jl, np.float32)[:, real]
        scale = float(np.abs(want).max())
        np.testing.assert_allclose(tl.float().numpy()[:, real] / scale,
                                   want / scale, rtol=0, atol=2e-2)

    toks = _tokens(jcfg, 2, 40, seed=31)
    jl, jc = jitted(JD.prefill, cfg=jcfg, max_len=64)(
        jp, tokens=jnp.asarray(toks))
    tl, tc = TD.prefill(tp, tcfg, torch.from_numpy(toks), max_len=64)
    within(jl, tl)
    pos = np.full((2,), 40, np.int32)
    decode = jitted(JD.decode_step, cfg=jcfg)
    for _ in range(8):
        nxt = np.asarray(jnp.argmax(jl, -1)).astype(np.int32)[:, None]
        jl, jc = decode(jp, cache=jc, tokens=jnp.asarray(nxt),
                        pos=jnp.asarray(pos))
        tl, tc = TD.decode_step(tp, tcfg, tc, torch.from_numpy(nxt),
                                torch.from_numpy(pos))
        within(jl, tl)
        pos = pos + 1
