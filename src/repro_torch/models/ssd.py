"""Mamba2 SSD (state-space duality) block: the JAX package's
``models/ssd.py`` on PyTorch.

* ``segsum`` and ``ssd_chunked``: the chunked SSD form in float32 with
  torch einsums (cuBLAS on the card), seeded with an optional carried
  state.  It is the backward of ``ops.ssd_with_state`` (recomputed under
  autograd) and the serving chunk step's scan.
* ``ssd_block_apply``: the full-sequence block (training forward).  Its
  scan always goes through ``ops.ssd_with_state`` — the CUDA kernel on
  the card, its plain version on the CPU; ``cfg.use_pallas`` is not read.
  With ``tp`` (the spmd train step), where the specs cut ``ssd_heads``
  over the model axis, a rank computes its heads: ``wz`` / ``wx`` /
  ``wdt`` (and ``wB`` / ``wC`` where ``ssd_bc`` is cut) column-parallel,
  its convs' channels, the scan on its heads over its groups' whole B and
  C, the gated norm's mean square summed over the axis, ``out_proj``
  row-parallel.
* ``ssd_init_state``, ``ssd_chunk_step`` and ``ssd_decode_step``: the
  serving steps from a carried state (torch ops, as the JAX package's run
  jnp: no kernel has an initial-state entry point); ``ssd_decode_step``
  takes ``tp`` (the spmd token step) as the block does.

params (per layer):
  wz, wx: (D, di)     wB, wC: (D, G*N)     wdt: (D, H)
  conv_x: (K, di) + bx,  conv_B/conv_C: (K, G*N) + bB/bC
  A_log: (H,)   dt_bias: (H,)   D_skip: (H,)
  norm: (di,)   out_proj: (di, D)
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.kernels.ssd_scan import ops
from repro_torch.models.layers import (causal_conv1d, conv1d_step,
                                       matmul_f32, rms_norm)


def segsum(a):
    """Stable segment-sum: out[..., i, j] = sum_{k=j+1..i} a[..., k] (i >= j),
    -inf above the diagonal."""
    T = a.shape[-1]
    cs = torch.cumsum(a, dim=-1)
    out = cs[..., :, None] - cs[..., None, :]
    mask = torch.ones(T, T, dtype=torch.bool, device=a.device).tril()
    return out.masked_fill(~mask, float("-inf"))


def ssd_chunked(x, dt, A, B_, C_, *, chunk: int, initial_state=None):
    """Chunked SSD.  x: (B, S, H, P); dt: (B, S, H); A: (H,); B_/C_:
    (B, S, G, N).  Returns y (B, S, H, P) in x's dtype and the final state
    (B, H, P, N) float32.  Math in float32.  ``initial_state`` seeds the
    inter-chunk recurrence (None = zeros, the prefill case)."""
    Bb, S, H, P = x.shape
    G, N = B_.shape[2], B_.shape[3]
    if S % chunk:
        raise ValueError(f"sequence {S} is not a multiple of the chunk "
                         f"{chunk}")
    nc = S // chunk
    rep = H // G

    xf, dtf = x.float(), dt.float()
    Bf = B_.float().repeat_interleave(rep, dim=2)           # (B,S,H,N)
    Cf = C_.float().repeat_interleave(rep, dim=2)
    a = dtf * A.float()[None, None, :]                      # (B,S,H)
    xdt = xf * dtf[..., None]

    def r(t):  # (B, S, ...) -> (B, nc, chunk, ...)
        return t.reshape((Bb, nc, chunk) + tuple(t.shape[2:]))

    xc, ac, Bc, Cc = r(xdt), r(a), r(Bf), r(Cf)

    # intra-chunk (dense)
    L = torch.exp(segsum(ac.permute(0, 1, 3, 2)))           # (B,nc,H,Q,Q)
    scores = torch.einsum("bcqhn,bckhn->bchqk", Cc, Bc)
    y_intra = torch.einsum("bchqk,bckhp->bcqhp", scores * L, xc)

    # per-chunk end states
    a_cum = torch.cumsum(ac, dim=2)                         # (B,nc,Q,H)
    a_tot = a_cum[:, :, -1, :]                              # (B,nc,H)
    decay_to_end = torch.exp(a_tot[:, :, None, :] - a_cum)
    S_c = torch.einsum("bcqhn,bcqh,bcqhp->bchpn", Bc, decay_to_end, xc)

    # inter-chunk recurrence (a short loop over nc), state before each chunk
    h = (initial_state.float() if initial_state is not None
         else torch.zeros((Bb, H, P, N), dtype=torch.float32,
                          device=x.device))
    prev = []
    for c in range(nc):
        prev.append(h)
        h = h * torch.exp(a_tot[:, c])[..., None, None] + S_c[:, c]
    h_prev = torch.stack(prev, dim=1)                       # (B,nc,H,P,N)

    # inter-chunk output
    y_inter = torch.einsum("bcqhn,bcqh,bchpn->bcqhp", Cc, torch.exp(a_cum),
                           h_prev)
    y = (y_intra + y_inter).reshape(Bb, S, H, P)
    return y.to(x.dtype), h


def _proj_conv(x, w, conv_w, conv_b, K):
    """Returns (activated conv output, pre-conv tail for decode state)."""
    h = x @ w
    tail = h[:, -(K - 1):, :]
    h = causal_conv1d(h, conv_w, conv_b)
    return F.silu(h.float()).to(x.dtype), tail


def _dt(x, params):
    """softplus(x @ wdt + dt_bias) in float32; the projection's float32
    output is not rounded to x's type (``preferred_element_type``)."""
    return F.softplus(matmul_f32(x, params["wdt"])
                      + params["dt_bias"].float())


def _gate_norm_out(y, z, params, cfg, tp=None):
    """y * silu(z), the gated RMS norm and the output projection.  ``tp``:
    ``y`` and ``z`` are the rank's channels of ``d_inner``; the mean
    square is their sum of squares summed over the axis, and the ranks'
    partial projections are summed."""
    y = y * F.silu(z.float()).to(y.dtype)
    if tp is None:
        y = rms_norm(y, params["norm"], cfg.norm_eps)
        return y @ params["out_proj"]
    yf = y.float()
    var = tp.psum(yf.square().sum(dim=-1, keepdim=True)) / cfg.d_inner
    y = (yf * torch.rsqrt(var + cfg.norm_eps)
         * params["norm"].float()).to(y.dtype)
    return tp.reduce(y @ params["out_proj"])


def _front_pad(pad, *ts):
    """Pad each (B, S, ...) tensor with ``pad`` zero steps at the front."""
    return [F.pad(t, (0, 0) * (t.dim() - 2) + (pad, 0)) for t in ts]


def _bc_split(x, xc, params, cfg, tp, name):
    """B or C (``name``) of the rank's heads under ``tp``: (B, S, groups
    the rank's heads read, N), and the pre-conv tail of the rank's
    channels.  Where ``ssd_bc`` is cut, the rank's channels from ``xc``
    (``x`` through ``tp.copy``) gathered, each rank's gradient of the
    whole summed back over the axis; else computed whole from ``x`` and
    passed through ``tp.copy``, which sums the ranks' partial gradients
    of it, so that the replicated weights' and ``x``'s are whole."""
    G, N = cfg.ssm_groups, cfg.ssm_state
    split = tp.splits("ssd_bc")
    h, tail = _proj_conv(xc if split else x, params["w" + name],
                         params["conv_" + name], params["b" + name],
                         cfg.conv_width)
    h = tp.gather_summed(h, -1) if split else tp.copy(h)
    return h.reshape(h.shape[0], h.shape[1], G, N)[
        :, :, tp.groups(cfg.ssm_heads, G)], tail


def ssd_block_apply(x, params, cfg, tp=None):
    """Full Mamba2 block (training forward).  x: (B, S, D) -> (out (B, S,
    D), decode state {ssm, conv_x, conv_B, conv_C}).  ``tp``: the rank's
    part of the tensor-parallel block where the specs cut ``ssd_heads``
    (the module note; the state is then the rank's heads and channels),
    else ignored."""
    G, N = cfg.ssm_groups, cfg.ssm_state
    P, K = cfg.ssm_head_dim, cfg.conv_width
    Bb, S, _ = x.shape
    if tp is not None and not tp.splits("ssd_heads"):
        tp = None
    xc = tp.copy(x) if tp is not None else x
    z = xc @ params["wz"]
    xs, tail_x = _proj_conv(xc, params["wx"], params["conv_x"],
                            params["bx"], K)
    if tp is None:
        B_, tail_B = _proj_conv(x, params["wB"], params["conv_B"],
                                params["bB"], K)
        C_, tail_C = _proj_conv(x, params["wC"], params["conv_C"],
                                params["bC"], K)
        B_ = B_.reshape(Bb, S, G, N)
        C_ = C_.reshape(Bb, S, G, N)
    else:
        B_, tail_B = _bc_split(x, xc, params, cfg, tp, "B")
        C_, tail_C = _bc_split(x, xc, params, cfg, tp, "C")
    dtv = _dt(xc, params)
    xs = xs.reshape(Bb, S, dtv.shape[-1], P)
    A = -torch.exp(params["A_log"].float())
    chunk = min(cfg.ssd_chunk, S)
    pad = (-S) % chunk
    if pad:  # front-pad: zero inputs add nothing to the state (exact)
        xs, dtv, B_, C_ = _front_pad(pad, xs, dtv, B_, C_)
    y, state = ops.ssd_with_state(xs, dtv, A, B_, C_, chunk)
    if pad:
        y = y[:, pad:]
        xs = xs[:, pad:]
    # the skip term in x's dtype, as the JAX block adds it
    y = y + xs * params["D_skip"].to(x.dtype)[None, None, :, None]
    out = _gate_norm_out(y.reshape(Bb, S, -1), z, params, cfg, tp)
    full_state = {"ssm": state, "conv_x": tail_x, "conv_B": tail_B,
                  "conv_C": tail_C}
    return out, full_state


def ssd_init_state(cfg, batch, dtype=torch.float32, device="cuda"):
    """Zero decode state: ``ssm`` float32, the conv tails in ``dtype``."""
    G, N, H = cfg.ssm_groups, cfg.ssm_state, cfg.ssm_heads
    di, K = cfg.d_inner, cfg.conv_width
    return {
        "ssm": torch.zeros((batch, H, cfg.ssm_head_dim, N),
                           dtype=torch.float32, device=device),
        "conv_x": torch.zeros((batch, K - 1, di), dtype=dtype,
                              device=device),
        "conv_B": torch.zeros((batch, K - 1, G * N), dtype=dtype,
                              device=device),
        "conv_C": torch.zeros((batch, K - 1, G * N), dtype=dtype,
                              device=device),
    }


def ssd_chunk_step(x, params, cfg, state, n_tokens):
    """Multi-token chunk step from a CARRIED state (serving fused prefill).

    x: (B, C, D); state from ``ssd_init_state``; n_tokens: (B,) in [0, C]
    (active tokens are a prefix).  The chunked SSD form seeded with the
    carried SSM state, the three conv front-ends resumed from their
    carried tails.  Inactive tokens are masked via dt = 0 (decay 1, zero
    input), so the final state is the state after each stream's last
    active token; front-padding to the SSD chunk multiple is exact for the
    same reason.  Torch ops (``ssd_chunked``), as the JAX step runs jnp."""
    G, N, H = cfg.ssm_groups, cfg.ssm_state, cfg.ssm_heads
    P, di, K = cfg.ssm_head_dim, cfg.d_inner, cfg.conv_width
    Bb, C, _ = x.shape
    n = n_tokens.long()
    active = torch.arange(C, device=x.device)[None, :] < n[:, None]
    z = x @ params["wz"]

    def piece(w, conv_w, conv_b, st):
        h = x @ w
        ext = torch.cat([st, h], dim=1)                 # (B, K-1+C, k)
        idx = n[:, None] + torch.arange(K - 1, device=x.device)[None, :]
        tail = torch.gather(ext, 1, idx[:, :, None].expand(-1, -1,
                                                           ext.shape[2]))
        hc = causal_conv1d(ext, conv_w, conv_b)[:, K - 1:]
        return F.silu(hc.float()).to(x.dtype), tail

    xs, cx = piece(params["wx"], params["conv_x"], params["bx"],
                   state["conv_x"])
    B_, cb = piece(params["wB"], params["conv_B"], params["bB"],
                   state["conv_B"])
    C_, cc = piece(params["wC"], params["conv_C"], params["bC"],
                   state["conv_C"])
    dtv = torch.where(active[..., None], _dt(x, params), 0.0)
    A = -torch.exp(params["A_log"].float())
    xs = xs.reshape(Bb, C, H, P)
    B_ = B_.reshape(Bb, C, G, N)
    C_ = C_.reshape(Bb, C, G, N)
    chunk = min(cfg.ssd_chunk, C)
    pad = (-C) % chunk
    if pad:  # front-pad with dt = 0 steps: the state passes unchanged
        xs, dtv, B_, C_ = _front_pad(pad, xs, dtv, B_, C_)
    y, h = ssd_chunked(xs, dtv, A, B_, C_, chunk=chunk,
                       initial_state=state["ssm"])
    if pad:
        y = y[:, pad:]
        xs = xs[:, pad:]
    # the skip term in float32, as the JAX chunk step adds it
    y = y.float() + xs.float() * params["D_skip"].float()[None, None, :,
                                                          None]
    out = _gate_norm_out(y.reshape(Bb, C, di).to(x.dtype), z, params, cfg)
    return out, {"ssm": h, "conv_x": cx, "conv_B": cb, "conv_C": cc}


def ssd_decode_step(x_t, params, cfg, state, tp=None):
    """One decode step.  x_t: (B, 1, D); state from ``ssd_init_state``.
    ``tp`` (the spmd token step), where the specs cut ``ssd_heads``: the
    rank's heads, as ``ssd_block_apply`` splits them, from the rank's
    state (its heads' ``ssm``, its channels of ``conv_x`` and, where
    ``ssd_bc`` is cut, of ``conv_B`` / ``conv_C``); the conv is
    depthwise, so each channel's tail stays the rank's, and B and C are
    gathered after it for the groups its heads read."""
    G, N, H = cfg.ssm_groups, cfg.ssm_state, cfg.ssm_heads
    P = cfg.ssm_head_dim
    Bb = x_t.shape[0]
    if tp is not None and not tp.splits("ssd_heads"):
        tp = None
    xt = x_t[:, 0]
    xc = tp.copy(xt) if tp is not None else xt
    z = xc @ params["wz"]

    def piece(x, w, conv_w, conv_b, st):
        h, new_st = conv1d_step(x @ w, st, conv_w, conv_b)
        return F.silu(h.float()).to(xt.dtype), new_st

    def bc(name):
        split = tp is not None and tp.splits("ssd_bc")
        h, st = piece(xc if split else xt, params["w" + name],
                      params["conv_" + name], params["b" + name],
                      state["conv_" + name])
        if split:
            h = tp.gather(h, -1)
        return h.reshape(Bb, G, N), st

    xs, cx = piece(xc, params["wx"], params["conv_x"], params["bx"],
                   state["conv_x"])
    B_, cb = bc("B")
    C_, cc = bc("C")
    dtv = _dt(xc, params)                                       # (B, H)
    A = -torch.exp(params["A_log"].float())
    Hl = dtv.shape[-1]
    xs = xs.reshape(Bb, Hl, P)
    if tp is None:
        B_ = B_.repeat_interleave(H // G, dim=1).float()
        C_ = C_.repeat_interleave(H // G, dim=1).float()
    else:           # the group each of the rank's heads reads
        idx = torch.arange(Hl, device=xt.device) + tp.rank * Hl
        idx = idx // (H // G)
        B_ = B_.index_select(1, idx).float()
        C_ = C_.index_select(1, idx).float()
    decay = torch.exp(dtv * A[None, :])                         # (B, H)
    ssm = state["ssm"] * decay[..., None, None] + torch.einsum(
        "bhn,bhp,bh->bhpn", B_, xs.float(), dtv)
    y = torch.einsum("bhn,bhpn->bhp", C_, ssm)
    # the skip term in float32, as the JAX decode step adds it
    y = y + xs.float() * params["D_skip"].float()[None, :, None]
    out = _gate_norm_out(y.reshape(Bb, Hl * P).to(x_t.dtype), z, params,
                         cfg, tp)
    return out[:, None, :], {"ssm": ssm, "conv_x": cx, "conv_B": cb,
                             "conv_C": cc}
