"""Parity of the port's layer functions (``repro_torch.models.layers`` and
the ``transformer`` helpers) with the JAX package, on the CPU.

The same numpy-seeded inputs go through the JAX function and its port;
outputs must agree to 1e-5 in float32, and to 2e-2 in the bf16 cases
(the MLP and a 2-layer forward to the logits).  Attention cases cover ring wrap, a chunk
wider than the ring (C > W), idle streams (n_tokens = 0), GQA 8:1 and
softcap.  Chunk attention compares active rows only: for a row with no
visible key the JAX dense path returns a discarded uniform row and the
port returns 0 (ROADMAP C)."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import REGISTRY, reduced_config
from repro.models import layers as JL
from repro.models import transformer as JT
from repro_torch.models import layers as TL
from repro_torch.models import transformer as TT
from repro_torch.configs import REGISTRY as T_REGISTRY
from repro_torch.configs import reduced_config as t_reduced

TOL = 1e-5


def rnd(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


def close(jax_out, torch_out, tol=TOL):
    np.testing.assert_allclose(np.asarray(torch_out.detach()),
                               np.asarray(jax_out), rtol=tol, atol=tol)


def t(x):
    return torch.from_numpy(np.array(x))


def test_rms_norm():
    rng = np.random.default_rng(0)
    x, s = rnd(rng, 2, 5, 64), rnd(rng, 64)
    close(JL.rms_norm(jnp.asarray(x), jnp.asarray(s), 1e-6),
          TL.rms_norm(t(x), t(s), 1e-6))


def test_rope_tables_and_apply_rope():
    rng = np.random.default_rng(1)
    pos = rng.integers(0, 3000, size=(3, 7)).astype(np.int32)
    jc, js = JL.rope_tables(jnp.asarray(pos), 16, 500_000.0)
    tc, ts = TL.rope_tables(t(pos), 16, 500_000.0)
    close(jc, tc)
    close(js, ts)
    x = rnd(rng, 3, 7, 4, 16)
    close(JL.apply_rope(jnp.asarray(x), jc, js), TL.apply_rope(t(x), tc, ts))


@pytest.mark.parametrize("activation", ["swiglu", "gelu_glu", "relu_glu",
                                        "squared_relu", "gelu"])
def test_mlp_apply(activation):
    rng = np.random.default_rng(2)
    glu = activation.endswith("glu")
    p = {"wi": rnd(rng, 32, 2, 48) if glu else rnd(rng, 32, 48),
         "wo": rnd(rng, 48, 32) * 0.1}
    x = rnd(rng, 2, 3, 32)
    close(JL.mlp_apply(jnp.asarray(x), {k: jnp.asarray(v)
                                         for k, v in p.items()}, activation),
          TL.mlp_apply(t(x), {k: t(v) for k, v in p.items()}, activation),
          )


# wo scales that put the bf16 outputs at a few hundred (tens for
# squared_relu), where bf16-rounded gate and up pre-activations move many
# outputs by more than the tolerance
BF16_WO_SCALE = {"swiglu": 0.5, "gelu_glu": 0.5, "relu_glu": 0.5,
                 "squared_relu": 0.05, "gelu": 5.0}
BF16_TOL = 2e-2     # the JAX package's bf16 kernel tests


@pytest.mark.parametrize("activation", sorted(BF16_WO_SCALE))
def test_mlp_apply_bf16(activation):
    """bf16 weights and input: the ``wi`` product stays float32 up to the
    activation, as the JAX einsum's ``preferred_element_type`` keeps it;
    rounding gate and up to bf16 first misses the tolerance by up to 3.4
    on outputs of a few hundred."""
    rng = np.random.default_rng(0)
    D, Fd = 64, 96
    glu = activation.endswith("glu")
    p = {"wi": rnd(rng, D, 2, Fd) if glu else rnd(rng, D, Fd),
         "wo": rnd(rng, Fd, D) * BF16_WO_SCALE[activation]}
    x = rnd(rng, 2, 8, D)
    tp = {k: t(v).to(torch.bfloat16) for k, v in p.items()}
    tx = t(x).to(torch.bfloat16)
    want = JL.mlp_apply(jnp.asarray(tx.float().numpy()).astype(jnp.bfloat16),
                        {k: jnp.asarray(v.float().numpy())
                         .astype(jnp.bfloat16) for k, v in tp.items()},
                        activation)
    got = TL.mlp_apply(tx, tp, activation)
    assert got.dtype == torch.bfloat16
    close(jnp.asarray(want, jnp.float32), got.float(), tol=BF16_TOL)


def test_forward_logits_bf16():
    """A 2-layer reduced llama3-8b in bf16, the full forward to the
    logits, JAX (its Pallas flash kernel in interpret mode, the route the
    port's attention mirrors) against the port on the same bf16 weights
    carried across by ``from_reference``: within 2e-2 of the logits'
    scale.  The weights are the port's seeded draw: the JAX init grows
    the activations of a 2-layer model to about 800, where bf16 ties that
    round the other way in one package move the logits by 3% of their
    scale."""
    from repro_torch.models.params import from_reference, init_params
    kw = dict(param_dtype="bfloat16", compute_dtype="bfloat16", n_layers=2,
              use_pallas=True)
    jcfg = dataclasses.replace(reduced_config(REGISTRY["llama3-8b"]), **kw)
    tcfg = dataclasses.replace(t_reduced(T_REGISTRY["llama3-8b"]), **kw)
    drawn = init_params(tcfg, torch.Generator().manual_seed(5), device="cpu")
    jp = jax.tree.map(lambda w: jnp.asarray(w.float().numpy())
                      .astype(jnp.bfloat16), drawn)
    tp = from_reference(jax.tree.map(np.asarray, jp), device="cpu")
    tokens = np.random.default_rng(1).integers(
        2, jcfg.vocab, size=(2, 32)).astype(np.int32)
    jx, _ = JT.forward(jp, jcfg, jnp.asarray(tokens))
    want = np.asarray(JT.head_logits(jp, jcfg, jx), np.float32)
    tx, _ = TT.forward(tp, tcfg, torch.from_numpy(tokens))
    assert tx.dtype == torch.bfloat16
    got = TT.head_logits(tp, tcfg, tx).numpy()
    real = slice(0, jcfg.vocab)
    scale = float(np.abs(want[..., real]).max())
    np.testing.assert_allclose(got[..., real] / scale,
                               want[..., real] / scale, rtol=0,
                               atol=BF16_TOL)


# B, W, Hq, Hkv, dh, pos, window, softcap
DECODE_CASES = {
    "ring_wrap": (2, 8, 4, 2, 16, (13, 27), 0, 0.0),
    "first_token": (2, 8, 4, 2, 16, (0, 3), 0, 0.0),
    "gqa_8_to_1": (1, 16, 8, 1, 32, (11,), 0, 0.0),
    "window_softcap": (2, 16, 4, 2, 16, (20, 40), 5, 30.0),
}


@pytest.mark.parametrize("case", sorted(DECODE_CASES))
def test_decode_attention(case):
    B, W, Hq, Hkv, dh, pos, window, softcap = DECODE_CASES[case]
    rng = np.random.default_rng(3)
    q, kc, vc = rnd(rng, B, 1, Hq, dh), rnd(rng, B, W, Hkv, dh), \
        rnd(rng, B, W, Hkv, dh)
    pos = np.asarray(pos, np.int32)
    kv_pos = np.asarray(JL.cache_positions(jnp.asarray(pos), W))
    close(JL.cache_positions(jnp.asarray(pos), W),
          TL.cache_positions(t(pos), W))
    close(JL.decode_attention(jnp.asarray(q), jnp.asarray(kc),
                              jnp.asarray(vc), jnp.asarray(kv_pos),
                              jnp.asarray(pos), window=window,
                              softcap=softcap),
          TL.decode_attention(t(q), t(kc), t(vc), t(kv_pos), t(pos),
                              window=window, softcap=softcap))


# B, C, W, Hq, Hkv, dh, pos, n_tokens, window, softcap
CHUNK_CASES = {
    "ring_wrap": (2, 6, 8, 4, 4, 16, (13, 27), (6, 6), 0, 0.0),
    "chunk_wider_than_ring": (2, 10, 8, 4, 2, 16, (5, 21), (10, 7), 0, 0.0),
    "idle_rows": (3, 4, 8, 2, 1, 16, (0, 5, 9), (0, 0, 4), 0, 0.0),
    "gqa_8_to_1": (1, 4, 8, 8, 1, 32, (11,), (4,), 0, 0.0),
    "window_softcap": (2, 8, 16, 4, 2, 32, (20, 3), (8, 5), 7, 30.0),
}


def _chunk_inputs(case, seed=4):
    B, C, W, Hq, Hkv, dh, pos, nt, window, softcap = CHUNK_CASES[case]
    rng = np.random.default_rng(seed)
    return (rnd(rng, B, C, Hq, dh), rnd(rng, B, C, Hkv, dh),
            rnd(rng, B, C, Hkv, dh), rnd(rng, B, W, Hkv, dh),
            rnd(rng, B, W, Hkv, dh), np.asarray(pos, np.int32),
            np.asarray(nt, np.int32)), window, softcap


@pytest.mark.parametrize("case", sorted(CHUNK_CASES))
def test_chunk_attention_dense(case):
    ins, window, softcap = _chunk_inputs(case)
    want = np.asarray(JL.chunk_attention(*map(jnp.asarray, ins),
                                         window=window, softcap=softcap))
    got = TL.chunk_attention(*map(t, ins), window=window, softcap=softcap,
                             kernel="dense").numpy()
    nt = ins[6]
    for b in range(len(nt)):
        np.testing.assert_allclose(got[b, :nt[b]], want[b, :nt[b]],
                                   rtol=TOL, atol=TOL, err_msg=f"stream {b}")
        assert np.isfinite(got[b]).all()


@pytest.mark.parametrize("case", sorted(CHUNK_CASES))
def test_cache_update_chunk(case):
    """Last-write-wins ring write, C > W included: the port's gather must
    equal the JAX gather slot for slot."""
    ins, _, _ = _chunk_inputs(case, seed=5)
    _, kn, vn, kc, vc, pos, nt = ins
    jk, jv = JL.cache_update_chunk(*map(jnp.asarray, (kc, vc, kn, vn, pos,
                                                      nt)))
    tk, tv = TL.cache_update_chunk(*map(t, (kc, vc, kn, vn, pos, nt)))
    np.testing.assert_array_equal(tk.numpy(), np.asarray(jk))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))


def test_cache_update_one_token_wraps():
    rng = np.random.default_rng(6)
    kc, vc = rnd(rng, 3, 8, 2, 16), rnd(rng, 3, 8, 2, 16)
    kn, vn = rnd(rng, 3, 1, 2, 16), rnd(rng, 3, 1, 2, 16)
    pos = np.asarray([0, 7, 29], np.int32)
    jk, jv = JL.cache_update(*map(jnp.asarray, (kc, vc, kn, vn, pos)))
    tk, tv = TL.cache_update(*map(t, (kc, vc, kn, vn, pos)))
    np.testing.assert_array_equal(tk.numpy(), np.asarray(jk))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    assert np.array_equal(kc, kc.copy())        # inputs untouched


# ---------------------------------------------------------------------------
# transformer helpers
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ["llama3-8b", "llama3.2-3b"])
def test_embed_and_head(arch):
    """Untied (llama3-8b) and tied (llama3.2-3b) output heads, plus a
    logit softcap."""
    jcfg = dataclasses.replace(reduced_config(REGISTRY[arch]),
                               logit_softcap=20.0)
    tcfg = dataclasses.replace(t_reduced(T_REGISTRY[arch]),
                               logit_softcap=20.0)
    rng = np.random.default_rng(7)
    p = {"embed": rnd(rng, jcfg.vocab_padded, jcfg.d_model)}
    if not jcfg.tie_embeddings:
        p["head"] = rnd(rng, jcfg.d_model, jcfg.vocab_padded) * 0.1
    tokens = rng.integers(0, jcfg.vocab, size=(2, 5)).astype(np.int32)
    jp = {k: jnp.asarray(v) for k, v in p.items()}
    tp = {k: t(v) for k, v in p.items()}
    close(JT.embed_tokens(jp, jcfg, jnp.asarray(tokens)),
          TT.embed_tokens(tp, tcfg, t(tokens)))
    x = rnd(rng, 2, jcfg.d_model)
    close(JT.head_logits(jp, jcfg, jnp.asarray(x)),
          TT.head_logits(tp, tcfg, t(x)))


def test_attn_proj_out_and_ffn():
    jcfg = reduced_config(REGISTRY["llama3-8b"])
    tcfg = t_reduced(T_REGISTRY["llama3-8b"])
    D, Hq, Hkv, dh = jcfg.d_model, jcfg.n_heads, jcfg.n_kv_heads, \
        jcfg.head_dim
    rng = np.random.default_rng(8)
    attn = {"wq": rnd(rng, D, Hq, dh) * 0.1, "wk": rnd(rng, D, Hkv, dh) * 0.1,
            "wv": rnd(rng, D, Hkv, dh) * 0.1, "wo": rnd(rng, Hq, dh, D) * 0.1}
    mlp = {"wi": rnd(rng, D, 2, jcfg.d_ff) * 0.1,
           "wo": rnd(rng, jcfg.d_ff, D) * 0.1}
    x = rnd(rng, 2, 5, D)
    pos = np.arange(10, dtype=np.int32).reshape(2, 5)
    jrope = JL.rope_tables(jnp.asarray(pos), dh, jcfg.rope_theta)
    trope = TL.rope_tables(t(pos), dh, tcfg.rope_theta)
    jq = JT._attn_proj(jnp.asarray(x), {k: jnp.asarray(v)
                                        for k, v in attn.items()},
                       jrope, cfg=jcfg)
    tq = TT._attn_proj(t(x), {k: t(v) for k, v in attn.items()}, trope,
                       cfg=tcfg)
    for a, b in zip(jq, tq):
        close(a, b)
    o = rnd(rng, 2, 5, Hq, dh)
    close(JT._attn_out(jnp.asarray(o), {"wo": jnp.asarray(attn["wo"])},
                       jnp.float32),
          TT._attn_out(t(o), {"wo": t(attn["wo"])}, torch.float32))
    jf, _ = JT._ffn(jnp.asarray(x), {"mlp": {k: jnp.asarray(v)
                                             for k, v in mlp.items()}}, jcfg)
    tf, taux = TT._ffn(t(x), {"mlp": {k: t(v) for k, v in mlp.items()}},
                       tcfg)
    close(jf, tf)
    assert taux == {}
