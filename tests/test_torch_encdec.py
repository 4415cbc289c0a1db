"""The encoder-decoder family (seamless-m4t-large-v2) in the port against
the JAX package, on the CPU: ``encode``, ``decoder_forward`` and
``encdec_forward``, the loss and every gradient leaf (and remat's), the
``Trainer``'s train steps through ``ShardedLoader``,
``encdec_prefill`` with ``decode_step`` and ``make_generate``, both chunk
steps over a warmed, wrapped ring, and the verify identity.

Reduced seamless-m4t-large-v2 in float32.  The port's cross-attention is
its flash kernel (non-causal, Sq ≠ Skv; the plain version here), the JAX
package's the plain ``blocked_attention``.  Tolerances: hidden states and
logits 1e-4, cache leaves 2e-4 (``test_torch_prefill.py``); loss 1e-5,
gradients, parameters and moments 1e-4 (``test_torch_train.py``).

The weights are the port's seeded ``init_params``, handed to both
packages, as ``test_torch_moe.py`` does.  The JAX ``init_params`` draws
every projection with std 0.71 at two layers (ROADMAP C): the attention
scores then reach tens, the softmax saturates, and float32 summation
order moves the hidden states by about 1e-4.  On those weights and this
file's batch the JAX package's own Pallas and jnp routes differ by 3.2e-5
on the decoder's hidden states and the port lies within 9.2e-5 of either;
on the port's weights the two packages agree to 1.7e-6.
``test_torch_prefill.py`` holds ``encdec_prefill`` on the JAX weights."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import REGISTRY, reduced_config
from repro.launch import steps as JS
from repro.models import decode as JD
from repro.models import transformer as JT
from repro_torch.configs import REGISTRY as T_REGISTRY
from repro_torch.configs import reduced_config as t_reduced
from repro_torch.data.pipeline import make_batch
from repro_torch.launch import steps as TS
from repro_torch.models import decode as TD
from repro_torch.models import transformer as TT
from repro_torch.models.params import init_params as t_init_params
from test_torch_prefill import jitted
from test_torch_vlm import clone, to_j, to_t, tree_close

ARCH = "seamless-m4t-large-v2"
JCFG, TCFG = reduced_config(REGISTRY[ARCH]), t_reduced(T_REGISTRY[ARCH])
TOL, LOGIT_TOL, CACHE_TOL = 1e-4, 1e-4, 2e-4
B, S = 2, 64                    # 32 source frames, 32 target tokens


def port_drawn(seed=5):
    """The port's seeded weights as (torch tree, JAX tree of copies)."""
    tp = t_init_params(TCFG, torch.Generator().manual_seed(seed),
                       device="cpu")
    return tp, jax.tree.map(lambda t: jnp.array(t.numpy()), tp)


def frames(B, S_src, seed):
    return (np.random.default_rng(seed).standard_normal(
        (B, S_src, JCFG.d_model)) * 0.02).astype(np.float32)


@pytest.fixture(scope="module")
def model():
    """The port's weights in both packages and a ``make_batch`` training
    batch."""
    tp, jp = port_drawn()
    rng = np.random.default_rng(7)
    block = rng.integers(2, JCFG.vocab, size=(B, S + 1)).astype(np.int32)
    batch = make_batch(TCFG, block)
    batch["mask"] = (rng.random(batch["mask"].shape) < 0.9) \
        .astype(np.float32)
    return jp, tp, batch


def test_encode_decode_and_forward(model):
    """``encode`` (non-causal self-attention, ``enc_norm``),
    ``decoder_forward`` on the JAX encoder's output and ``encdec_forward``
    give the JAX package's hidden states."""
    jp, tp, batch = model
    fe, toks = batch["frame_embeds"], batch["tokens"]
    je = JT.encode(jp, JCFG, jnp.asarray(fe))
    te = TT.encode(tp, TCFG, torch.from_numpy(fe))
    np.testing.assert_allclose(te.numpy(), np.asarray(je), rtol=TOL,
                               atol=TOL)
    jx = JT.decoder_forward(jp, JCFG, jnp.asarray(toks), je)
    tx = TT.decoder_forward(tp, TCFG, torch.from_numpy(toks),
                            torch.from_numpy(np.array(je)))
    np.testing.assert_allclose(tx.numpy(), np.asarray(jx), rtol=TOL,
                               atol=TOL)
    # the JAX encdec_forward is encode then decoder_forward
    tx, taux = TT.encdec_forward(tp, TCFG, torch.from_numpy(toks),
                                 {"frame_embeds": torch.from_numpy(fe)})
    np.testing.assert_allclose(tx.numpy(), np.asarray(jx), rtol=TOL,
                               atol=TOL)
    assert float(taux) == 0.0
    with pytest.raises(ValueError, match="encdec_forward"):
        TT.forward(tp, TCFG, torch.from_numpy(toks))


def test_loss_and_every_gradient_leaf(model):
    """``loss_fn``, then ``steps.value_and_grad`` against
    ``jax.value_and_grad(loss_fn)``, every encoder and decoder leaf (the
    cross-attention's among them); with ``remat="full"`` each encoder and
    decoder layer is recomputed in the backward, to the same loss and
    gradients."""
    jp, tp, batch = model
    jl, _ = JT.loss_fn(jp, JCFG, to_j(batch))
    tl, tparts = TT.loss_fn(tp, TCFG, to_t(batch))
    np.testing.assert_allclose(float(tl), float(jl), rtol=1e-5, atol=1e-5)
    assert float(tparts["aux"]) == 0.0
    (jl, _), jg = jax.jit(jax.value_and_grad(
        lambda p, b: JT.loss_fn(p, JCFG, b), has_aux=True))(jp, to_j(batch))
    tl, _, tg = TS.value_and_grad(TCFG, tp, to_t(batch))
    np.testing.assert_allclose(float(tl), float(jl), rtol=1e-5, atol=1e-5)
    tree_close(jg, tg, 1e-4, "grad")
    rcfg = dataclasses.replace(TCFG, remat="full")
    rl, _, rg = TS.value_and_grad(rcfg, tp, to_t(batch))
    assert float(rl) == float(tl)
    tree_close(jax.tree.map(lambda t: t.numpy(), tg), rg, 1e-6, "remat")


def test_trainer_matches_jax_trainer(tmp_path_factory, tmp_path):
    """The ``Trainer``, with no encoder-decoder code of its own, trains
    reduced seamless-m4t-large-v2 from ``ShardedLoader`` blocks through
    ``make_batch`` (half frames, half target tokens) to the JAX Trainer's
    losses and counters, both from the port's weights."""
    from test_torch_trainer import _jax_trainer_run, _matches_jax_trainer
    _matches_jax_trainer(ARCH, _jax_trainer_run(
        tmp_path_factory.mktemp("jax_encdec_trainer"), ARCH,
        params=port_drawn()[1]), tmp_path)


def _caches_close(jc, tc, spec, what=""):
    jleaves = jax.tree.leaves(jc)
    tleaves = TD.tree_leaves(tc, spec)
    assert len(jleaves) == len(tleaves) == 4
    for a, b in zip(jleaves, tleaves):
        assert tuple(b.shape) == a.shape
        np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=CACHE_TOL,
                                   atol=CACHE_TOL, err_msg=what)


def test_cache_layout():
    """``init_cache`` with ``src_len``: the cross leaves are per-stream
    state (no token axis), the self rings have the stream on axis 1 and
    the tokens on axis 2, in the JAX leaf order and shapes."""
    spec = TD.cache_view_specs(TCFG, 16, 10)
    jspec = JD.cache_view_specs(JCFG, 16, 10)
    assert [(s.batch_axis, s.token_axis, s.width) for s in spec.leaves] == \
        [(s.batch_axis, s.token_axis, s.width) for s in jspec.leaves]
    assert spec.width == jspec.width == 16
    tc = TD.init_cache(TCFG, 3, 16, 10, device="cpu")
    jc = JD.init_cache(JCFG, 3, 16, 10)
    assert [tuple(t.shape) for t in TD.tree_leaves(tc, spec)] == \
        [a.shape for a in jax.tree.leaves(jc)]
    assert spec.paths == (("cross_k",), ("cross_v",), ("self", "k"),
                          ("self", "v"))


def test_prefill_decode_and_generate(model):
    """``encdec_prefill`` (through ``make_prefill`` with ``frame_embeds``)
    then ``decode_step`` and 6 greedy ``make_generate`` steps: logits,
    every cache leaf and the tokens equal the JAX package's."""
    jp, tp, _ = model
    max_len, S_src, P = 24, 10, 9
    toks = np.random.default_rng(1).integers(
        2, JCFG.vocab, size=(B, P)).astype(np.int32)
    batch = {"tokens": toks, "frame_embeds": frames(B, S_src, 2)}
    jl, jc = jax.jit(JS.make_prefill(JCFG, max_len))(jp, to_j(batch))
    tl, tc = TS.make_prefill(TCFG, max_len)(tp, to_t(batch))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=LOGIT_TOL,
                               atol=LOGIT_TOL)
    spec = TD.cache_view_specs(TCFG, max_len, S_src)
    _caches_close(jc, tc, spec, "prefill")
    first = np.asarray(jnp.argmax(jl, -1)).astype(np.int32)[:, None]
    pos = np.full((B,), P, np.int32)
    decode = jitted(JD.decode_step, cfg=JCFG)
    jl1, jc1 = decode(jp, cache=jc, tokens=jnp.asarray(first),
                      pos=jnp.asarray(pos))
    tl1, tc1 = TD.decode_step(tp, TCFG, clone(tc), torch.from_numpy(first),
                              torch.from_numpy(pos))
    np.testing.assert_allclose(tl1.numpy(), np.asarray(jl1), rtol=LOGIT_TOL,
                               atol=LOGIT_TOL)
    _caches_close(jc1, tc1, spec, "decode")
    tt, _, _ = TS.make_generate(TCFG, 6)(tp, tc, torch.from_numpy(first),
                                         torch.from_numpy(pos))
    # greedy generation in the JAX package: its decode step, fed back
    jt, tok, p = [], first, pos
    for _ in range(6):
        lg, jc = decode(jp, cache=jc, tokens=jnp.asarray(tok),
                        pos=jnp.asarray(p))
        tok = np.asarray(jnp.argmax(lg, -1)).astype(np.int32)[:, None]
        jt.append(tok[:, 0])
        p = p + 1
    np.testing.assert_array_equal(tt.numpy(), np.stack(jt, 1))


def test_chunk_steps_over_a_wrapped_ring(model):
    """A 20-token prefix prefilled into a 16-token ring (it wraps), then
    ``prefill_chunk_step`` (blocked and dense) and ``chunk_decode_step``
    with a prefill row, a decode row and an idle row: the live rows'
    logits and every cache leaf (the cross leaves unwritten) equal the
    JAX steps'."""
    jp, tp, _ = model
    max_len, S_src, P = 16, 10, 20
    rng = np.random.default_rng(3)
    prompt = rng.integers(2, JCFG.vocab, size=(3, P)).astype(np.int32)
    fe = frames(3, S_src, 4)
    _, jc = jitted(JD.prefill, cfg=JCFG, max_len=max_len)(
        jp, tokens=jnp.asarray(prompt),
        extras={"frame_embeds": jnp.asarray(fe)})
    _, tc = TD.prefill(tp, TCFG, torch.from_numpy(prompt),
                       {"frame_embeds": torch.from_numpy(fe)},
                       max_len=max_len)
    spec = TD.cache_view_specs(TCFG, max_len, S_src)
    jspec = JD.cache_view_specs(JCFG, max_len, S_src)
    chunk = rng.integers(2, JCFG.vocab, size=(3, 6)).astype(np.int32)
    pos = np.full((3,), P, np.int32)
    n = np.array([6, 1, 0], np.int32)
    jargs = dict(tokens=jnp.asarray(chunk), pos=jnp.asarray(pos),
                 n_tokens=jnp.asarray(n))
    targs = (torch.from_numpy(chunk), torch.from_numpy(pos),
             torch.from_numpy(n))
    live = n > 0
    runs = [(k, jitted(JD.prefill_chunk_step, cfg=JCFG, spec=jspec,
                       chunk_kernel=k),
             lambda c, k=k: TD.prefill_chunk_step(tp, TCFG, spec, c, *targs,
                                                  chunk_kernel=k))
            for k in ("blocked", "dense")]
    runs.append(("scan", jitted(JD.chunk_decode_step, cfg=JCFG, spec=jspec),
                 lambda c: TD.chunk_decode_step(tp, TCFG, spec, c, *targs)))
    for what, jstep, tstep in runs:
        jlog, jc2 = jstep(jp, cache=jc, **jargs)
        tc0 = clone(tc)
        tlog, tc2 = tstep(tc0)
        np.testing.assert_allclose(tlog.numpy()[live],
                                   np.asarray(jlog)[live], rtol=LOGIT_TOL,
                                   atol=LOGIT_TOL, err_msg=what)
        assert (tlog.numpy()[~live] == -1e30).all()
        _caches_close(jc2, tc2, spec, what)
        assert torch.equal(tc2["cross_k"], tc["cross_k"])


def test_spec_verify_matches_sequential_decode():
    """The twin of ``test_spec_decode.py::
    test_spec_verify_matches_sequential_decode_encdec``: the all-logits
    verify step (``make_spec_verify_step``, scan and fused) over 4 tokens
    gives, at every position, the argmax of 4 sequential single-token
    chunk steps, and the JAX verify's logits."""
    max_len, src, W = 16, 6, 4
    tp, jp = port_drawn(seed=2)
    spec = TD.cache_view_specs(TCFG, max_len, src)
    jspec = JD.cache_view_specs(JCFG, max_len, src)
    cross = np.random.default_rng(1).standard_normal(
        (TCFG.dec_layers, 1, src, TCFG.n_kv_heads, TCFG.head_dim)) * 0.1

    def fresh():
        cache = TD.init_cache(TCFG, 1, max_len, src, device="cpu")
        cache["cross_k"] = torch.from_numpy(cross.astype(np.float32))
        cache["cross_v"] = torch.from_numpy(cross[..., ::-1].astype(
            np.float32).copy())
        return cache

    toks = np.random.default_rng(2).integers(
        2, TCFG.vocab, size=(1, W)).astype(np.int32)
    targs = (torch.from_numpy(toks), torch.zeros(1, dtype=torch.int32),
             torch.full((1,), W, dtype=torch.int32))
    seq, cache = [], fresh()
    for i in range(W):
        lg, cache = TD.chunk_decode_step(
            tp, TCFG, spec, cache, targs[0][:, i:i + 1],
            torch.full((1,), i, dtype=torch.int32),
            torch.ones(1, dtype=torch.int32))
        seq.append(lg[0].argmax().item())
    jcache = jax.tree.map(lambda t: jnp.asarray(t.numpy()), fresh())
    jv, _ = JS.make_spec_verify_step(JCFG, jspec)(
        jp, jcache, *(jnp.asarray(a.numpy()) for a in targs))
    for mode in ("scan", "parallel"):
        tv, _ = TS.make_spec_verify_step(TCFG, spec, mode=mode)(
            tp, fresh(), *targs)
        assert tv[0].argmax(-1).tolist() == seq, mode
        np.testing.assert_allclose(tv.numpy(), np.asarray(jv),
                                   rtol=LOGIT_TOL, atol=LOGIT_TOL,
                                   err_msg=mode)
