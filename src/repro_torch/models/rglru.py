"""RG-LRU recurrent block (Griffin / RecurrentGemma): the JAX package's
``models/rglru.py`` on PyTorch.

Recurrence (per channel):
    r_t = sigmoid(x_t @ W_a)            # recurrence gate
    i_t = sigmoid(x_t @ W_x)            # input gate
    log_a_t = -c * softplus(Lambda) * r_t
    h_t = exp(log_a_t) * h_{t-1} + sqrt(1 - exp(2*log_a_t)) * (i_t * x_t)

* ``rglru_block_apply``: the full-sequence block (training forward).  Its
  scan always goes through ``ops.lru`` — the CUDA kernel on the card, its
  plain version on the CPU; ``cfg.use_pallas`` is not read.  With ``tp``
  (the spmd train step), where the specs cut ``lru`` over the model axis,
  a rank computes its channels: ``w_gate`` / ``w_in`` column-parallel,
  the conv on its channels, the gates from the whole conv output
  (gathered: ``w_a`` / ``w_x`` are column slices that read all of it),
  the scan on its channels, ``w_out`` row-parallel.
* ``rglru_init_state``, ``rglru_chunk_step`` and ``rglru_decode_step``:
  the serving steps from a carried state.  The chunk step's scan from the
  carried ``h`` is ``ops.lru_scan`` with ``h0`` — the function the JAX
  step's ``lax.associative_scan`` over [(1, h), (a_t, b_t)...] computes —
  so on the card it launches the same kernel.  ``rglru_decode_step``
  takes ``tp`` (the spmd token step) as the block does.

The gates are float32 matmuls on ``u`` (the JAX code casts both operands
to float32); the in-projections and the gate branch give float32 output
from the compute type (``layers.matmul_f32``, the counterpart of
``preferred_element_type=float32``).

params (per recurrent layer):
  w_gate:  (D, W)          # gelu branch
  w_in:    (D, W)          # recurrence branch in-projection
  conv_w:  (K, W), conv_b: (W,)
  w_a:     (W, W), w_x: (W, W)
  lam:     (W,)            # Lambda (softplus-parameterized decay)
  w_out:   (W, D)
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.kernels.rglru_scan import ops
from repro_torch.models.layers import causal_conv1d, conv1d_step, matmul_f32

RG_LRU_C = 8.0


class _UpcastMatmul(torch.autograd.Function):
    """a @ w in float32 from operands of any float type (both upcast, as
    the JAX gates cast them); the backward saves the operands as they
    came, not their float32 copies."""

    @staticmethod
    def forward(ctx, a, w):
        ctx.save_for_backward(a, w)
        return a.float() @ w.float()

    @staticmethod
    def backward(ctx, g):
        a, w = ctx.saved_tensors
        ga = (g @ w.float().t()).to(a.dtype)
        gw = (a.reshape(-1, a.shape[-1]).float().t()
              @ g.reshape(-1, g.shape[-1])).to(w.dtype)
        return ga, gw


def _gates(u, params):
    """(log_a, input gate), float32, from the conv output ``u``: float32
    matmuls on ``u`` and the gate weights."""
    r = torch.sigmoid(_UpcastMatmul.apply(u, params["w_a"]))
    i = torch.sigmoid(_UpcastMatmul.apply(u, params["w_x"]))
    log_a = -RG_LRU_C * F.softplus(params["lam"].float()) * r
    return log_a, i


def _decay_input(log_a, i_gate, u):
    """(a, b) of the recurrence h_t = a_t h_{t-1} + b_t, float32 (``u``
    is promoted exactly; autograd keeps it in its own type)."""
    a = torch.exp(log_a)
    beta = torch.sqrt(torch.clamp(1.0 - torch.exp(2.0 * log_a), min=0.0))
    return a, beta * (i_gate * u)


def _branches(x, params):
    """(gelu gate branch float32, in-projection in x's type)."""
    gate = F.gelu(matmul_f32(x, params["w_gate"]), approximate="tanh")
    u_raw = matmul_f32(x, params["w_in"]).to(x.dtype)
    return gate, u_raw


def _out(h, gate, params, dtype):
    out = (h * gate).to(dtype)
    return matmul_f32(out, params["w_out"]).to(dtype)


def rglru_init_state(cfg, batch, dtype=torch.float32, device="cuda"):
    """Zero decode state: ``h`` float32, ``conv`` in ``dtype``."""
    W, K = cfg.lru_width, cfg.conv_width
    return {"h": torch.zeros((batch, W), dtype=torch.float32, device=device),
            "conv": torch.zeros((batch, K - 1, W), dtype=dtype,
                                device=device)}


def rglru_block_apply(x, params, cfg, tp=None):
    """Full recurrent block.  x: (B, S, D) -> (out (B, S, D), decode state
    {h, conv}).  ``tp``: the rank's part of the tensor-parallel block
    where the specs cut ``lru`` (the module note; the state is then the
    rank's channels), else ignored."""
    K = cfg.conv_width
    if tp is not None and not tp.splits("lru"):
        tp = None
    gate, u_raw = _branches(tp.copy(x) if tp is not None else x, params)
    u = causal_conv1d(u_raw, params["conv_w"], params["conv_b"])
    if tp is None:
        log_a, i_gate = _gates(u, params)
    else:
        # the gates read every rank's channels of u, so each rank's
        # gradient of the gathered u is partial (summed back by the
        # gather); the rank's channels are read back from it after the
        # gates, so that its three gradients add up in the unsplit order
        whole = tp.gather_summed(u, -1)
        log_a, i_gate = _gates(whole, params)
        u = whole.narrow(-1, tp.rank * u.shape[-1], u.shape[-1])
    a, b = _decay_input(log_a, i_gate, u)
    h = ops.lru(a, b)
    state = {"h": h[:, -1, :], "conv": u_raw[:, -(K - 1):, :]}
    out = _out(h, gate, params, x.dtype)
    return (tp.reduce(out) if tp is not None else out), state


def rglru_chunk_step(x, params, cfg, state, n_tokens):
    """Multi-token chunk step from a CARRIED state (serving fused prefill).

    x: (B, C, D); state as in ``rglru_decode_step``; n_tokens: (B,) in
    [0, C] — active tokens are a prefix of the chunk.  Inactive tokens are
    forced to the identity step (log_a = 0 -> a = 1, beta = 0), so the final
    carry is the state after each stream's last active token; the scan
    starts from the carried ``h``; the conv runs over [carried K-1 inputs,
    chunk] and its carry is gathered at the per-stream active length."""
    C = x.shape[1]
    K = cfg.conv_width
    n = n_tokens.long()
    active = (torch.arange(C, device=x.device)[None, :] < n[:, None])[..., None]
    gate, u_raw = _branches(x, params)
    ext = torch.cat([state["conv"], u_raw], dim=1)         # (B, K-1+C, W)
    u = causal_conv1d(ext, params["conv_w"], params["conv_b"])[:, K - 1:]
    log_a, i_gate = _gates(u, params)
    log_a = torch.where(active, log_a, 0.0)                # identity step
    i_gate = torch.where(active, i_gate, 0.0)
    a, b = _decay_input(log_a, i_gate, u)
    h, h_last = ops.lru_scan(a.contiguous(), b.contiguous(),
                             state["h"].float().contiguous())
    idx = n[:, None] + torch.arange(K - 1, device=x.device)[None, :]
    new_conv = torch.gather(ext, 1, idx[:, :, None].expand(-1, -1,
                                                           ext.shape[2]))
    return _out(h, gate, params, x.dtype), {"h": h_last, "conv": new_conv}


def rglru_decode_step(x_t, params, cfg, state, tp=None):
    """x_t: (B, 1, D); state: {"h": (B, W) f32, "conv": (B, K-1, W)}.
    ``tp`` (the spmd token step), where the specs cut ``lru``: the rank's
    channels, as ``rglru_block_apply`` splits them, from its channels of
    the state; the gates read the conv output gathered over the axis.
    The gates' GEMMs read ``u`` row-major on both routes (the conv's
    einsum leaves it column-major; the gather's output is row-major): on
    the card the operands' layout picks the GEMM kernel, and so its
    rounding."""
    if tp is not None and not tp.splits("lru"):
        tp = None
    xt = tp.copy(x_t[:, 0]) if tp is not None else x_t[:, 0]
    gate, u = _branches(xt, params)
    u, conv_state = conv1d_step(u, state["conv"], params["conv_w"],
                                params["conv_b"])
    log_a, i_gate = _gates(tp.gather(u, -1) if tp is not None
                           else u.contiguous(), params)
    a, b = _decay_input(log_a, i_gate, u)
    h = a * state["h"] + b
    y = _out(h, gate, params, x_t.dtype)
    if tp is not None:
        y = tp.reduce(y)
    return y[:, None, :], {"h": h, "conv": conv_state}
