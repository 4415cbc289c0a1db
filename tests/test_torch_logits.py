"""The output head in bf16 against the JAX package on the CPU: the logits
come out in float32 from bf16 operands without being rounded to bf16 (the
JAX einsum's ``preferred_element_type``), so the port's ``head_logits``
and ``chunked_ce_loss`` agree with the JAX package's on the same bf16
weights; and the padded-vocab mask keeps the gradient of the pad rows at
zero, with a vocab that does not divide by 256.

Tolerances: the logits are sums of exact float32 products of bf16 values,
so the packages differ only in summation order: 1e-5 of the logits'
scale.  A bf16 rounding of the logits would put errors of up to 2^-9 of
that scale in, 400 times more."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import REGISTRY, reduced_config
from repro.models import transformer as JT
from repro_torch.configs import REGISTRY as T_REGISTRY
from repro_torch.configs import reduced_config as t_reduced
from repro_torch.models import transformer as TT

ARCHS = ["llama3-8b", "llama3.2-3b", "mamba2-780m", "recurrentgemma-9b"]


def configs(arch, **kw):
    return (dataclasses.replace(reduced_config(REGISTRY[arch]), **kw),
            dataclasses.replace(t_reduced(T_REGISTRY[arch]), **kw))


def bf16_weights(jcfg, seed):
    """Output-head weights drawn in float32 and rounded to bf16: the same
    bf16 numbers for both packages."""
    rng = np.random.default_rng(seed)
    p = {"embed": rng.standard_normal((jcfg.vocab_padded, jcfg.d_model))}
    if not jcfg.tie_embeddings:
        p["head"] = rng.standard_normal((jcfg.d_model, jcfg.vocab_padded)) \
            * jcfg.d_model ** -0.5
    tp = {k: torch.from_numpy(v.astype(np.float32)).to(torch.bfloat16)
          for k, v in p.items()}
    jp = {k: jnp.asarray(v.float().numpy()).astype(jnp.bfloat16)
          for k, v in tp.items()}
    return jp, tp


@pytest.mark.parametrize("arch", ARCHS)
def test_head_logits_bf16_are_not_rounded(arch):
    jcfg, tcfg = configs(arch, param_dtype="bfloat16",
                         compute_dtype="bfloat16")
    jp, tp = bf16_weights(jcfg, seed=1)
    x = torch.from_numpy(np.random.default_rng(2).standard_normal(
        (2, 9, jcfg.d_model)).astype(np.float32)).to(torch.bfloat16)
    got = TT.head_logits(tp, tcfg, x)
    want = np.asarray(JT.head_logits(jp, jcfg,
                                     jnp.asarray(x.float().numpy())
                                     .astype(jnp.bfloat16)))
    assert got.dtype == torch.float32 and want.dtype == np.float32
    real = slice(0, jcfg.vocab)
    scale = float(np.abs(want[..., real]).max())
    np.testing.assert_allclose(got[..., real].numpy() / scale,
                               want[..., real] / scale, rtol=0, atol=1e-5)
    # the rounding the repair removed is 400 times the tolerance
    rounded = got[..., real].to(torch.bfloat16).float().numpy()
    assert np.abs(rounded - want[..., real]).max() / scale > 1e-3


@pytest.mark.parametrize("arch", ARCHS)
def test_chunked_loss_bf16_matches_jax(arch, monkeypatch):
    """The chunked cross-entropy over 4 chunks of bf16 hiddens and bf16
    weights: value to 1e-5."""
    jcfg, tcfg = configs(arch, param_dtype="bfloat16",
                         compute_dtype="bfloat16")
    monkeypatch.setattr(JT, "LOSS_CHUNK", 16)
    monkeypatch.setattr(TT, "LOSS_CHUNK", 16)
    jp, tp = bf16_weights(jcfg, seed=3)
    rng = np.random.default_rng(4)
    x = torch.from_numpy(rng.standard_normal((2, 64, jcfg.d_model))
                         .astype(np.float32)).to(torch.bfloat16)
    tgt = rng.integers(0, jcfg.vocab, size=(2, 64)).astype(np.int32)
    mask = (rng.random((2, 64)) < 0.8).astype(np.float32)
    want = JT.chunked_ce_loss(jp, jcfg, jnp.asarray(x.float().numpy())
                              .astype(jnp.bfloat16), jnp.asarray(tgt),
                              jnp.asarray(mask))
    got = TT.chunked_ce_loss(tp, tcfg, x, torch.from_numpy(tgt),
                             torch.from_numpy(mask))
    np.testing.assert_allclose(float(got), float(want), rtol=1e-5)


@pytest.mark.parametrize("arch", ["llama3-8b", "mamba2-780m"])
def test_padded_vocab_mask_gradient(arch):
    """vocab 500 pads to 512: the loss and the output-head gradient (tied
    embedding for mamba2, untied head for llama) match the JAX package's,
    and the 12 pad rows (columns) get exactly zero gradient."""
    jcfg, tcfg = configs(arch, vocab=500)
    assert jcfg.vocab_padded == 512
    rng = np.random.default_rng(5)
    key = "embed" if jcfg.tie_embeddings else "head"
    w = rng.standard_normal((512, jcfg.d_model) if key == "embed"
                            else (jcfg.d_model, 512)).astype(np.float32)
    w *= jcfg.d_model ** -0.5
    x = rng.standard_normal((2, 32, jcfg.d_model)).astype(np.float32)
    tgt = rng.integers(0, 500, size=(2, 32)).astype(np.int32)
    mask = np.ones((2, 32), np.float32)
    emb = rng.standard_normal((512, jcfg.d_model)).astype(np.float32)

    def jloss(w):
        p = {"embed": w} if key == "embed" else {"embed": jnp.asarray(emb),
                                                 "head": w}
        return JT.chunked_ce_loss(p, jcfg, jnp.asarray(x), jnp.asarray(tgt),
                                  jnp.asarray(mask))

    jl, jg = jax.value_and_grad(jloss)(jnp.asarray(w))
    tw = torch.from_numpy(w).requires_grad_(True)
    tp = {"embed": tw} if key == "embed" else {"embed": torch.from_numpy(emb),
                                               "head": tw}
    tl = TT.chunked_ce_loss(tp, tcfg, torch.from_numpy(x),
                            torch.from_numpy(tgt), torch.from_numpy(mask))
    tl.backward()
    np.testing.assert_allclose(float(tl.detach()), float(jl), rtol=1e-5)
    np.testing.assert_allclose(tw.grad.numpy(), np.asarray(jg), rtol=1e-4,
                               atol=1e-6)
    pad = tw.grad[500:] if key == "embed" else tw.grad[:, 500:]
    assert torch.count_nonzero(pad) == 0
    assert np.count_nonzero(np.asarray(jg)[500:] if key == "embed"
                            else np.asarray(jg)[:, 500:]) == 0


@pytest.mark.parametrize("arch", ["llama3.2-3b", "recurrentgemma-9b"])
def test_weight_gradient_in_column_blocks(arch, monkeypatch):
    """``matmul_f32``'s weight gradient summed 100 columns at a time (six
    blocks of the 512-column head, the last one ragged) equals the
    gradient summed whole, and both equal the JAX package's (float32
    weights, so neither gradient is rounded to bf16)."""
    from repro_torch.models import layers as TL
    jcfg, tcfg = configs(arch)
    jp, tp = bf16_weights(jcfg, seed=9)
    key = "embed" if jcfg.tie_embeddings else "head"
    rng = np.random.default_rng(10)
    x = rng.standard_normal((2, 16, jcfg.d_model)).astype(np.float32)
    g = rng.standard_normal((2, 16, jcfg.vocab_padded)).astype(np.float32)
    _, vjp = jax.vjp(lambda w: JT.head_logits(dict(jp, **{key: w}), jcfg,
                                              jnp.asarray(x)),
                     jp[key].astype(jnp.float32))
    want = np.asarray(vjp(jnp.asarray(g))[0], np.float32)
    grads = []
    for block in (TL.GRAD_BLOCK, 100):
        monkeypatch.setattr(TL, "GRAD_BLOCK", block)
        w = tp[key].float().requires_grad_(True)
        TT.head_logits(dict(tp, **{key: w}), tcfg,
                       torch.from_numpy(x)).backward(torch.from_numpy(g))
        grads.append(w.grad)
    torch.testing.assert_close(grads[1], grads[0], rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(grads[1].numpy(), want, rtol=1e-4, atol=1e-4)
