"""The port's MoE layer on the card.

* ``moe_apply`` in float32 on CUDA equals its CPU run to 1e-5, dropless
  and at a capacity that drops claims (the same claims drop on both).
* A dropless MoE feed-forward captured in a CUDA graph replays to the
  eager result bit for bit: slot positions are computed on the device and
  no shape depends on the routing, so nothing is read on the host.
* The top-K tie rule takes the lower expert index first on the card, as
  on the CPU (``lax.top_k``'s rule).

The graph and the card have no CPU mode, so the tests are marked ``gpu``
and skip where no CUDA device is visible.  This file imports neither JAX
nor the JAX package:

    PYTHONPATH=src python3 -m pytest -q --noconftest -m gpu \\
        tests/test_torch_moe_gpu.py
"""
import dataclasses

import pytest
import torch

from repro_torch.configs import REGISTRY, reduced_config
from repro_torch.models import moe
from repro_torch.models.params import init_params


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the MoE layer's card run and its "
                    "CUDA graph have no CPU mode")


def _layer(arch, **kw):
    cfg = dataclasses.replace(reduced_config(REGISTRY[arch]), moe_block=16,
                              **kw)
    p = init_params(cfg, torch.Generator().manual_seed(5), device="cpu")
    return cfg, {k: v[0].contiguous() for k, v in p["layers"]["moe"].items()}


def _on(tree, device):
    return {k: v.to(device) for k, v in tree.items()}


@pytest.mark.gpu
@pytest.mark.parametrize("arch", ["mixtral-8x22b", "grok-1-314b"])
@pytest.mark.parametrize("dropless", [True, False])
def test_moe_apply_on_the_card_equals_the_cpu(cuda, arch, dropless):
    cfg, p = _layer(arch, capacity_factor=1.0)
    x = torch.randn(2, 13, cfg.d_model,
                    generator=torch.Generator().manual_seed(1))
    y, aux = moe.moe_apply(x, p, cfg, dropless=dropless)
    yc, auxc = moe.moe_apply(x.cuda(), _on(p, "cuda"), cfg,
                             dropless=dropless)
    torch.testing.assert_close(yc.cpu(), y, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(auxc["lb_loss"].cpu(), aux["lb_loss"],
                               rtol=1e-5, atol=1e-5)
    assert float(auxc["dropped"]) == float(aux["dropped"])
    assert (float(aux["dropped"]) > 0) == (not dropless)


@pytest.mark.gpu
def test_dropless_moe_replays_in_a_cuda_graph(cuda):
    """bf16 at reduced width, B = 8 rows of one token (a decode step's
    shape) and of a 16-token chunk: the captured layer's replay on new
    inputs equals the eager call on them bit for bit."""
    cfg, p = _layer("mixtral-8x22b", param_dtype="bfloat16",
                    compute_dtype="bfloat16")
    p = _on(p, "cuda")
    g = torch.Generator(device="cuda").manual_seed(2)
    for C in (1, 16):
        shape = (8, C, cfg.d_model)
        x = torch.randn(shape, generator=g, device="cuda") \
            .to(torch.bfloat16)
        with torch.no_grad():
            moe.moe_apply(x, p, cfg, dropless=True)         # warm-up
            torch.cuda.synchronize()
            graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(graph):
                out, _ = moe.moe_apply(x, p, cfg, dropless=True)
            for _ in range(2):
                x.copy_(torch.randn(shape, generator=g, device="cuda"))
                graph.replay()
                want, _ = moe.moe_apply(x, p, cfg, dropless=True)
                torch.cuda.synchronize()
                assert torch.equal(out, want), C


@pytest.mark.gpu
def test_top_k_ties_take_the_lower_index_on_the_card(cuda):
    logits = torch.zeros(5, 8, device="cuda")
    logits[1, 5] = logits[1, 6] = 1.0
    logits[2, 3:] = 2.0
    _, idx = moe.top_k_lowest_first(logits, 2)
    assert idx.tolist() == [[0, 1], [5, 6], [3, 4], [0, 1], [0, 1]]
