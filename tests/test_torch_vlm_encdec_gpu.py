"""The VLM and encoder-decoder families on the card.

* The flash kernels with more keys than queries and more queries than
  keys (cross-attention's shapes), non-causal, forward and backward, in
  bf16 (tensor-core route) and float32 (FMA route), against the plain
  versions at the existing tolerances.
* Reduced qwen2-vl-2b with its vision extras and reduced
  seamless-m4t-large-v2 (encoder, decoder with cross-attention) in
  float32: the card's forward, loss gradients and serving steps equal
  the CPU's.
* bf16 cross-attention reads a decoder layer's slice of the cache's
  ``cross_k`` / ``cross_v`` in place: the slice meets TMA's layout rule,
  so no copy is made and nothing falls back.
* A VLM decode step (M-RoPE broadcast from its positions) captured in a
  CUDA graph replays to the eager result bit for bit.

The card has no CPU mode, so the tests are marked ``gpu`` and skip where
no CUDA device is visible.  This file imports neither JAX nor the JAX
package:

    PYTHONPATH=src python3 -m pytest -q --noconftest -m gpu \\
        tests/test_torch_vlm_encdec_gpu.py
"""
import dataclasses

import pytest
import torch

from repro_torch.configs import REGISTRY, reduced_config
from repro_torch.kernels.flash_attention import ops, ref
from repro_torch.launch import steps as S
from repro_torch.models import decode as D
from repro_torch.models.params import init_params

# the flash kernels' tolerances (forward, backward) by dtype
TOL = {torch.float32: (2e-5, 2e-4), torch.bfloat16: (2e-2, 2e-2)}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the attention kernels and the "
                    "CUDA graph have no CPU mode")


def _close(got, want, tol, what):
    got, want = got.float().cpu(), want.float().cpu()
    bad = (got - want).abs() > tol + tol * want.abs()
    assert not bool(bad.any()), (what, float((got - want).abs().max()))


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,Sq,Skv", [(2, 32, 700), (1, 300, 77),
                                      (2, 16, 4096), (1, 129, 130),
                                      (4, 4, 4096)])
def test_flash_with_sq_unlike_skv(cuda, dtype, B, Sq, Skv):
    """Non-causal MHA at dh 64: out, lse, dq, dk and dv against the plain
    versions, on the route of the dtype."""
    g = torch.Generator(device="cuda").manual_seed(Sq + Skv)
    q, do = (torch.randn(B, Sq, 16, 64, generator=g, device="cuda")
             .to(dtype) for _ in range(2))
    k, v = (torch.randn(B, Skv, 16, 64, generator=g, device="cuda")
            .to(dtype) for _ in range(2))
    w0 = ops.flash_attention.wgmma_launches
    out, lse = ops.flash_attention_fwd(q, k, v, causal=False)
    grads = ops.flash_attention_bwd(q, k, v, out, lse, do, causal=False)
    want_out, want_lse = ref.flash_attention_fwd_ref(q, k, v, causal=False)
    want = ref.flash_attention_bwd_ref(q, k, v, out, lse, do, causal=False)
    tf, tb = TOL[dtype]
    _close(out, want_out, tf, "out")
    _close(lse, want_lse, tf, "lse")
    for name, a, b in zip(("dq", "dk", "dv"), grads, want):
        _close(a, b, tb, name)
    assert ops.flash_attention.wgmma_launches - w0 == \
        (dtype == torch.bfloat16)


def _reduced(arch, **kw):
    cfg = dataclasses.replace(reduced_config(REGISTRY[arch]), **kw)
    return cfg, init_params(cfg, torch.Generator().manual_seed(3),
                            device="cpu")


def _to(tree, device):
    if isinstance(tree, dict):
        return {k: _to(v, device) for k, v in tree.items()}
    return tree.to(device)


def _vlm_batch(cfg, B=2, S=48, sv=12):
    g = torch.Generator().manual_seed(1)
    ids = torch.arange(S)
    pid = torch.stack([ids, ids // 3, ids % 4]).int()
    return {"tokens": torch.randint(2, cfg.vocab, (B, S - sv), generator=g,
                                    dtype=torch.int32),
            "vision_embeds": torch.randn(B, sv, cfg.d_model, generator=g)
            * 0.02,
            "position_ids": pid[:, None].expand(3, B, S).contiguous(),
            "targets": torch.randint(2, cfg.vocab, (B, S), generator=g,
                                     dtype=torch.int32),
            "mask": torch.ones(B, S)}


def _encdec_batch(cfg, B=2, S_src=40, St=24):
    g = torch.Generator().manual_seed(2)
    return {"frame_embeds": torch.randn(B, S_src, cfg.d_model, generator=g)
            * 0.02,
            "tokens": torch.randint(2, cfg.vocab, (B, St), generator=g,
                                    dtype=torch.int32),
            "targets": torch.randint(2, cfg.vocab, (B, St), generator=g,
                                     dtype=torch.int32),
            "mask": torch.ones(B, St)}


@pytest.mark.gpu
@pytest.mark.parametrize("arch", ["qwen2-vl-2b", "seamless-m4t-large-v2"])
def test_loss_and_gradients_on_the_card_equal_the_cpu(cuda, arch):
    """float32: the loss within 1e-5 and every gradient leaf within 1e-4
    of the CPU run (the flash kernels' FMA route against their plain
    versions), with vision extras or source frames."""
    cfg, params = _reduced(arch)
    batch = (_vlm_batch(cfg) if cfg.family == "vlm"
             else _encdec_batch(cfg))
    f0 = ops.flash_attention.launches
    gl, _, gg = S.value_and_grad(cfg, _to(params, "cuda"),
                                 _to(batch, "cuda"))
    assert ops.flash_attention.launches > f0
    cl, _, cg = S.value_and_grad(cfg, params, batch)
    torch.testing.assert_close(gl.cpu(), cl, rtol=1e-5, atol=1e-5)

    def leaves(tree, prefix=()):
        for k in sorted(tree):
            if isinstance(tree[k], dict):
                yield from leaves(tree[k], prefix + (k,))
            else:
                yield prefix + (k,), tree[k]

    for (path, a), (_, b) in zip(leaves(gg), leaves(cg)):
        torch.testing.assert_close(a.cpu(), b, rtol=1e-4, atol=1e-4,
                                   msg=lambda m: f"{path}: {m}")


@pytest.mark.gpu
def test_encdec_serving_steps_on_the_card_equal_the_cpu(cuda):
    """float32: ``encdec_prefill``, a ``decode_step`` and a blocked
    ``prefill_chunk_step`` (ring kernel, cross-attention on the flash
    kernel) give the CPU's logits within 1e-4."""
    cfg, params = _reduced("seamless-m4t-large-v2")
    batch = _encdec_batch(cfg)
    out = {}
    for dev in ("cpu", "cuda"):
        p = _to(params, dev)
        lg, cache = S.make_prefill(cfg, 32)(
            p, {k: batch[k].to(dev) for k in ("tokens", "frame_embeds")})
        pos = torch.full((2,), 24, dtype=torch.int32, device=dev)
        tok = lg.argmax(-1).to(torch.int32)[:, None]
        lg1, cache = D.decode_step(p, cfg, cache, tok, pos)
        spec = D.cache_view_specs(cfg, 32, 40)
        chunk = batch["tokens"][:, :5].to(dev)
        n = torch.tensor([5, 2], dtype=torch.int32, device=dev)
        lg2, _ = D.prefill_chunk_step(p, cfg, spec, cache, chunk, pos + 1,
                                      n, chunk_kernel="blocked")
        out[dev] = [x.cpu() for x in (lg, lg1, lg2)]
    for a, b in zip(out["cuda"], out["cpu"]):
        torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-4)


@pytest.mark.gpu
def test_bf16_cross_attention_reads_the_cache_in_place(cuda):
    """A decoder layer's slice of the bf16 ``cross_k`` / ``cross_v`` meets
    TMA's layout rule (no copy), and a bf16 chunk step over it runs the
    cross-attention on the tensor-core flash kernel, once a layer."""
    cfg, params = _reduced("seamless-m4t-large-v2",
                           param_dtype="bfloat16", compute_dtype="bfloat16")
    cache = D.init_cache(cfg, 3, 32, 40)
    for l in range(cfg.dec_layers):
        for name in ("cross_k", "cross_v"):
            ops.tma_strides(name, tuple(cache[name][l].shape),
                            cache[name][l].stride(),
                            cache[name][l].data_ptr(), 2)
    spec = D.cache_view_specs(cfg, 32, 40)
    w0 = ops.flash_attention.wgmma_launches
    lg, _ = D.prefill_chunk_step(
        _to(params, "cuda"), cfg, spec, cache,
        torch.randint(2, cfg.vocab, (3, 4), dtype=torch.int32,
                      device="cuda"),
        torch.zeros(3, dtype=torch.int32, device="cuda"),
        torch.tensor([4, 1, 0], dtype=torch.int32, device="cuda"),
        chunk_kernel="blocked")
    assert ops.flash_attention.wgmma_launches - w0 == cfg.dec_layers
    assert torch.isfinite(lg[:2]).all()


@pytest.mark.gpu
def test_vlm_decode_step_replays_in_a_cuda_graph(cuda):
    """bf16 reduced qwen2-vl-2b: a decode step with M-RoPE broadcast from
    its positions, captured in a CUDA graph, replays on new tokens and
    positions to the eager step's logits bit for bit."""
    cfg, params = _reduced("qwen2-vl-2b", param_dtype="bfloat16",
                           compute_dtype="bfloat16")
    p = _to(params, "cuda")
    tok = torch.randint(2, cfg.vocab, (4, 1), dtype=torch.int32,
                        device="cuda")
    pos = torch.tensor([3, 9, 0, 17], dtype=torch.int32, device="cuda")
    base = D.init_cache(cfg, 4, 32)
    with torch.no_grad():
        cache = _to(base, "cuda")
        D.decode_step(p, cfg, cache, tok, pos)             # warm-up
        torch.cuda.synchronize()
        graph = torch.cuda.CUDAGraph()
        cache = _to(base, "cuda")
        with torch.cuda.graph(graph):
            out, _ = D.decode_step(p, cfg, cache, tok, pos)
        new_tok = torch.randint(2, cfg.vocab, (4, 1), dtype=torch.int32,
                                device="cuda")
        tok.copy_(new_tok)
        pos.copy_(torch.tensor([5, 1, 30, 2], dtype=torch.int32))
        for leaf in D.tree_leaves(cache, D.cache_view_specs(cfg, 32)):
            leaf.zero_()
        graph.replay()
        want, _ = D.decode_step(p, cfg, _to(base, "cuda"), new_tok, pos)
    assert torch.equal(out, want)


@pytest.mark.gpu
def test_vlm_prefill_with_vision_on_the_card_equals_the_cpu(cuda):
    """float32 ``make_prefill`` with vision embeddings and distinct t/h/w
    ids: the card's logits and cache within 1e-4 of the CPU's."""
    cfg, params = _reduced("qwen2-vl-2b")
    batch = {k: v for k, v in _vlm_batch(cfg).items()
             if k in ("tokens", "vision_embeds", "position_ids")}
    out = {}
    for dev in ("cpu", "cuda"):
        lg, cache = S.make_prefill(cfg, 64)(_to(params, dev),
                                            _to(batch, dev))
        out[dev] = (lg.cpu(), [t.cpu() for t in D.tree_leaves(
            cache, D.cache_view_specs(cfg, 64))])
    torch.testing.assert_close(out["cuda"][0], out["cpu"][0], rtol=1e-4,
                               atol=1e-4)
    for a, b in zip(out["cuda"][1], out["cpu"][1]):
        torch.testing.assert_close(a, b, rtol=2e-4, atol=2e-4)
