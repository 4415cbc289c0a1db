"""Parity of the port's SSM pieces with the JAX package on the CPU: the
causal conv front-ends, the chunked SSD form, the SSD kernel's wrapper
(the plain route here) and its gradient, the full-sequence block, the
serving chunk and decode steps, the serving cache's layout and pool
state ops, and a greedy run of the model's serving steps.

The same numpy-seeded inputs go through the JAX function and its port.
Tolerances: 1e-5 for the conv layers and the plain SSD forms in float32;
3e-4 for the kernel route against the JAX Pallas kernel in interpret mode
(the JAX package's own ``test_ssd_scan`` tolerance) and 1e-4 for its
gradients; 1e-4 for the block and the steps in float32; in bf16 the block
and the steps are compared to 2e-2 (one bf16 rounding of values of order
one), since both packages round at the same places — the skip term of the
block in x's type, that of the chunk and decode steps in float32."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import REGISTRY, reduced_config
from repro.kernels.ssd_scan.kernel import ssd_scan as j_ssd_scan
from repro.kernels.ssd_scan.ops import ssd_with_state as j_ssd_with_state
from repro.kernels.ssd_scan.ref import ssd_scan_ref as j_ssd_scan_ref
from repro.models import layers as JL
from repro.models import params as JP
from repro.models import ssd as JS
from repro_torch.configs import REGISTRY as T_REGISTRY
from repro_torch.configs import reduced_config as t_reduced
from repro_torch.kernels.ssd_scan import ops, ref
from repro_torch.models import layers as TL
from repro_torch.models import ssd as TS
from repro_torch.models.params import from_reference

# B, S, H, P, G, N, chunk: tests/test_kernels.py's SSD_SWEEP
SSD_SWEEP = [(2, 64, 4, 16, 1, 32, 16), (1, 32, 4, 8, 2, 16, 32),
             (2, 128, 2, 32, 1, 8, 64)]
SWEEP_IDS = [f"B{b}_S{s}_H{h}_P{p}_G{g}_N{n}_Q{q}"
             for b, s, h, p, g, n, q in SSD_SWEEP]


def t(x, dtype=None):
    out = torch.from_numpy(np.array(x, np.float32))
    return out if dtype is None else out.to(dtype)


def close(jax_out, torch_out, tol, what=""):
    np.testing.assert_allclose(
        np.asarray(torch_out.detach().float()),
        np.asarray(jnp.asarray(jax_out, jnp.float32)), rtol=tol, atol=tol,
        err_msg=what)


def ssd_inputs(B, S, H, P, G, N, seed):
    """x, dt, A, B_, C_ as the JAX package's ssd_scan test draws them."""
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((B, S, H, P)).astype(np.float32),
            np.log1p(np.exp(rng.standard_normal((B, S, H)) - 1.0))
            .astype(np.float32),
            (-np.exp(rng.standard_normal(H) * 0.3)).astype(np.float32),
            (rng.standard_normal((B, S, G, N)) * 0.5).astype(np.float32),
            (rng.standard_normal((B, S, G, N)) * 0.5).astype(np.float32))


# ---------------------------------------------------------------------------
# conv front-ends
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_causal_conv1d_and_step(dtype):
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 11, 24)).astype(np.float32)
    w = (rng.standard_normal((4, 24)) * 0.3).astype(np.float32)
    b = rng.standard_normal(24).astype(np.float32)
    st = rng.standard_normal((2, 3, 24)).astype(np.float32)
    jd, td = getattr(jnp, dtype), getattr(torch, dtype)
    tol = 1e-5 if dtype == "float32" else 1e-2

    def j(a):
        return jnp.asarray(a).astype(jd)

    close(JL.causal_conv1d(j(x), j(w), j(b)),
          TL.causal_conv1d(t(x, td), t(w, td), t(b, td)), tol, "conv")
    close(JL.causal_conv1d(j(x), j(w)), TL.causal_conv1d(t(x, td), t(w, td)),
          tol, "conv without bias")
    jo, js = JL.conv1d_step(j(x[:, 0]), j(st), j(w), j(b))
    to, ts = TL.conv1d_step(t(x[:, 0], td), t(st, td), t(w, td), t(b, td))
    close(jo, to, tol, "step out")
    close(js, ts, 0.0, "step state")
    assert to.dtype == ts.dtype == td


def test_conv_steps_replay_the_full_conv():
    """conv1d_step token by token from a zero state equals causal_conv1d."""
    rng = np.random.default_rng(1)
    x = t(rng.standard_normal((2, 9, 8)))
    w, b = t(rng.standard_normal((4, 8))), t(rng.standard_normal(8))
    st = torch.zeros(2, 3, 8)
    outs = []
    for i in range(9):
        o, st = TL.conv1d_step(x[:, i], st, w, b)
        outs.append(o)
    torch.testing.assert_close(torch.stack(outs, 1),
                               TL.causal_conv1d(x, w, b), rtol=1e-6,
                               atol=1e-6)


# ---------------------------------------------------------------------------
# the SSD forms
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seeded", [False, True], ids=["zero_state",
                                                       "initial_state"])
@pytest.mark.parametrize("geo", SSD_SWEEP, ids=SWEEP_IDS)
def test_ssd_chunked(geo, seeded):
    B, S, H, P, G, N, chunk = geo
    ins = ssd_inputs(B, S, H, P, G, N, seed=S + P)
    h0 = (np.random.default_rng(9).standard_normal((B, H, P, N))
          .astype(np.float32) if seeded else None)
    jy, jh = JS.ssd_chunked(*map(jnp.asarray, ins), chunk=chunk,
                            initial_state=None if h0 is None
                            else jnp.asarray(h0))
    ty, th = TS.ssd_chunked(*map(t, ins), chunk=chunk,
                            initial_state=None if h0 is None else t(h0))
    close(jy, ty, 1e-5, "y")
    close(jh, th, 1e-5, "h_final")


def test_segsum():
    a = np.random.default_rng(2).standard_normal((3, 7)).astype(np.float32)
    close(JS.segsum(jnp.asarray(a)), TS.segsum(t(a)), 1e-6)


def test_per_step_oracle():
    ins = ssd_inputs(2, 24, 4, 8, 2, 16, seed=3)
    h0 = np.random.default_rng(4).standard_normal((2, 4, 8, 16)) \
        .astype(np.float32)
    jy, jh = j_ssd_scan_ref(*map(jnp.asarray, ins), jnp.asarray(h0))
    ty, th = ref.ssd_scan_ref(*map(t, ins), t(h0))
    close(jy, ty, 1e-5, "y")
    close(jh, th, 1e-5, "h_final")


@pytest.mark.parametrize("geo", SSD_SWEEP, ids=SWEEP_IDS)
def test_plain_scan_matches_the_pallas_kernel(geo):
    """``ssd_scan`` on CPU tensors (the plain version) against the JAX
    Pallas kernel in interpret mode, in the kernel's head-major layout."""
    B, S, H, P, G, N, chunk = geo
    x, dt, A, Bm, Cm = ssd_inputs(B, S, H, P, G, N, seed=S + N)
    xdt = (x * dt[..., None]).transpose(0, 2, 1, 3).reshape(B * H, S, P)
    a = (dt * A).transpose(0, 2, 1).reshape(B * H, S)

    def hm(m):
        return m.transpose(0, 2, 1, 3).reshape(B * G, S, N)

    args = (xdt, a, hm(Bm), hm(Cm))
    jy, jh = j_ssd_scan(*map(jnp.asarray, args), chunk=chunk,
                        hq_per_group=H // G, interpret=True)
    n0 = ops.ssd_scan.launches
    ty, th = ops.ssd_scan(*(t(v).contiguous() for v in args), chunk=chunk,
                          hq_per_group=H // G)
    assert ops.ssd_scan.launches == n0      # the CPU route launches nothing
    close(jy, ty, 3e-4, "y")
    close(jh, th, 3e-4, "h_final")


@pytest.mark.parametrize("geo", SSD_SWEEP, ids=SWEEP_IDS)
def test_ssd_with_state_matches_jax(geo):
    B, S, H, P, G, N, chunk = geo
    ins = ssd_inputs(B, S, H, P, G, N, seed=S + H)
    jy, jh = j_ssd_with_state(*map(jnp.asarray, ins), chunk=chunk,
                              interpret=True)
    ty, th = ops.ssd_with_state(*map(t, ins), chunk)
    assert tuple(th.shape) == (B, H, P, N) and th.dtype == torch.float32
    close(jy, ty, 3e-4, "y")
    close(jh, th, 3e-4, "h_final")
    assert torch.equal(ops.ssd(*map(t, ins), chunk), ty)


@pytest.mark.parametrize("geo", SSD_SWEEP, ids=SWEEP_IDS)
def test_ssd_with_state_gradients(geo):
    """Gradients of x, dt, A, B_ and C_ under cotangents on both outputs,
    against the JAX custom VJP (Pallas forward in interpret mode, jnp
    recompute backward)."""
    B, S, H, P, G, N, chunk = geo
    ins = ssd_inputs(B, S, H, P, G, N, seed=S + G)
    rng = np.random.default_rng(5)
    gy = rng.standard_normal((B, S, H, P)).astype(np.float32)
    gh = rng.standard_normal((B, H, P, N)).astype(np.float32)

    def jloss(*a):
        y, h = j_ssd_with_state(*a, chunk=chunk, interpret=True)
        return (y * gy).sum() + (h * gh).sum()

    jg = jax.grad(jloss, argnums=(0, 1, 2, 3, 4))(*map(jnp.asarray, ins))
    leaves = [t(v).requires_grad_(True) for v in ins]
    y, h = ops.ssd_with_state(*leaves, chunk)
    ((y * t(gy)).sum() + (h * t(gh)).sum()).backward()
    for name, want, got in zip(("x", "dt", "A", "B", "C"), jg, leaves):
        scale = float(np.abs(np.asarray(want)).max())
        close(np.asarray(want) / scale, got.grad / scale, 1e-4, name)


# ---------------------------------------------------------------------------
# the block and the serving steps
# ---------------------------------------------------------------------------

def ssm_configs(dtype="float32", **kw):
    j = dataclasses.replace(reduced_config(REGISTRY["mamba2-780m"]),
                            param_dtype=dtype, compute_dtype=dtype, **kw)
    tc = dataclasses.replace(t_reduced(T_REGISTRY["mamba2-780m"]),
                             param_dtype=dtype, compute_dtype=dtype, **kw)
    return j, tc


def layer_weights(jcfg, seed=0):
    """One SSD layer's weights (JAX init, first layer), as both trees."""
    jp = JP.init_params(jcfg, jax.random.PRNGKey(seed))
    lp = jax.tree.map(lambda a: a[0], jp["layers"]["ssd"])
    return lp, from_reference(jax.tree.map(np.asarray, lp), device="cpu")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("S", [64, 45, 7], ids=["S64", "S45_pad", "S7_pad"])
def test_ssd_block_apply(S, dtype):
    """The full-sequence block, S a multiple of the chunk (32) or not
    (front-padded), against the JAX block with its Pallas kernel
    (interpret mode) and with its jnp route; the decode state too."""
    jcfg, tcfg = ssm_configs(dtype)
    jlp, tlp = layer_weights(jcfg)
    x = np.random.default_rng(S).standard_normal((2, S, jcfg.d_model)) \
        .astype(np.float32)
    td = getattr(torch, dtype)
    tout, tst = TS.ssd_block_apply(t(x, td), tlp, tcfg)
    assert tout.dtype == td
    tol = 1e-4 if dtype == "float32" else 2e-2
    for use_pallas in (True, False):
        jout, jst = JS.ssd_block_apply(
            jnp.asarray(x).astype(getattr(jnp, dtype)), jlp,
            dataclasses.replace(jcfg, use_pallas=use_pallas))
        close(jout, tout, tol, f"out use_pallas={use_pallas}")
        for k in jst:
            close(jst[k], tst[k], tol, k)
            assert tst[k].dtype == (torch.float32 if k == "ssm" else td), k


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ssd_chunk_and_decode_steps(dtype):
    """From a carried state: a chunk step with per-stream token counts
    (full, partial, idle) and then two decode steps, each against the JAX
    step on the same state; the idle stream's state passes unchanged."""
    jcfg, tcfg = ssm_configs(dtype)
    jlp, tlp = layer_weights(jcfg, seed=1)
    rng = np.random.default_rng(6)
    B, C = 3, 12
    st = {"ssm": rng.standard_normal((B, jcfg.ssm_heads, jcfg.ssm_head_dim,
                                      jcfg.ssm_state)) * 0.3,
          "conv_x": rng.standard_normal((B, 3, jcfg.d_inner)),
          "conv_B": rng.standard_normal((B, 3, jcfg.ssm_state)),
          "conv_C": rng.standard_normal((B, 3, jcfg.ssm_state))}
    jd, td = getattr(jnp, dtype), getattr(torch, dtype)
    jst = {k: jnp.asarray(v, jnp.float32 if k == "ssm" else jd)
           for k, v in st.items()}
    tst = {k: t(v, torch.float32 if k == "ssm" else td)
           for k, v in st.items()}
    x = rng.standard_normal((B, C, jcfg.d_model)).astype(np.float32)
    n = np.array([12, 5, 0], np.int32)
    tol = 1e-4 if dtype == "float32" else 2e-2
    jout, jst = JS.ssd_chunk_step(jnp.asarray(x).astype(jd), jlp, jcfg, jst,
                                  jnp.asarray(n))
    tout, new = TS.ssd_chunk_step(t(x, td), tlp, tcfg, tst,
                                  torch.from_numpy(n))
    close(jout[:2], tout[:2], tol, "chunk out")
    for k in jst:
        close(jst[k], new[k], tol, f"chunk {k}")
        assert torch.equal(new[k][2], tst[k][2]), f"idle stream's {k}"
    tst = new
    for i in range(2):
        xt = rng.standard_normal((B, 1, jcfg.d_model)).astype(np.float32)
        jout, jst = JS.ssd_decode_step(jnp.asarray(xt).astype(jd), jlp, jcfg,
                                       jst)
        tout, tst = TS.ssd_decode_step(t(xt, td), tlp, tcfg, tst)
        close(jout, tout, tol, f"decode {i} out")
        for k in jst:
            close(jst[k], tst[k], tol, f"decode {i} {k}")
            assert tst[k].dtype == (torch.float32 if k == "ssm" else td)


def test_chunk_steps_replay_the_block():
    """Three chunk steps of 24 tokens from the zero state give the block's
    final state and (for the last chunk) its output."""
    jcfg, tcfg = ssm_configs()
    _, tlp = layer_weights(jcfg, seed=2)
    x = t(np.random.default_rng(7).standard_normal((2, 72, jcfg.d_model)))
    out, state = TS.ssd_block_apply(x, tlp, tcfg)
    st = TS.ssd_init_state(tcfg, 2, torch.float32, device="cpu")
    n = torch.full((2,), 24, dtype=torch.int32)
    for c in range(3):
        o, st = TS.ssd_chunk_step(x[:, 24 * c:24 * (c + 1)], tlp, tcfg, st, n)
    torch.testing.assert_close(o, out[:, 48:], rtol=1e-4, atol=1e-4)
    for k in state:
        torch.testing.assert_close(st[k], state[k], rtol=1e-4, atol=1e-4)


# ---------------------------------------------------------------------------
# the serving cache and the model steps
# ---------------------------------------------------------------------------

def test_cache_layout_and_pool_state_ops_bf16():
    """bf16 mamba2: the port's declared cache layout equals the JAX
    package's probed one leaf by leaf (stream axis, no token axis, shape),
    with one type per leaf — the SSD state float32, the conv tails bf16 —
    in the cache, the block pool and the pinned-host swap tier; the
    state-slot ops (gather, scatter, fork, zero, extract, insert) leave
    the pool equal to the JAX pool."""
    from repro.models import decode as JD
    from repro_torch.models import decode as TD
    from repro_torch.serving.swap import SwapTier
    jcfg, tcfg = ssm_configs("bfloat16")
    spec_j = JD.cache_view_specs(jcfg, 32)
    spec_t = TD.cache_view_specs(tcfg, 32)
    assert [(s.batch_axis, s.token_axis, s.width) for s in spec_t.leaves] \
        == [(s.batch_axis, s.token_axis, s.width) for s in spec_j.leaves]
    jleaves = jax.tree.leaves(JD.init_cache(jcfg, 1, 32))
    assert [tuple(a.shape) for a in jleaves] == list(spec_t.shapes)
    assert [str(a.dtype) for a in jleaves] == \
        [str(d).replace("torch.", "") for d in spec_t.dtypes]
    assert spec_t.dtypes == (torch.bfloat16, torch.bfloat16,
                             torch.bfloat16, torch.float32)
    cache = TD.init_cache(tcfg, 3, 32, device="cpu")
    pool = TD.init_block_pool(tcfg, spec_t, 1, 5, 1, device="cpu")
    jpool = JD.init_block_pool(jcfg, spec_j, 1, 5, 1, 32)
    for got, pl, want, d in zip(TD.tree_leaves(cache, spec_t),
                                TD.tree_leaves(pool, spec_t),
                                jax.tree.leaves(jpool), spec_t.dtypes):
        assert got.dtype == pl.dtype == d
        assert tuple(pl.shape) == tuple(want.shape)
    tier = SwapTier(TD.tree_leaves(pool, spec_t), spec_t, 0, 2)
    assert [b.dtype for b in tier._bufs] == list(spec_t.dtypes)

    rng = np.random.default_rng(8)
    jpool = jax.tree.map(lambda a: jnp.asarray(
        rng.standard_normal(a.shape).astype(np.float32)).astype(a.dtype),
        jpool)
    tpool = from_reference(jax.tree.map(np.asarray, jpool), device="cpu")

    def same():
        for a, b in zip(jax.tree.leaves(jpool), TD.tree_leaves(tpool,
                                                               spec_t)):
            assert str(a.dtype) == str(b.dtype).replace("torch.", "")
            np.testing.assert_array_equal(b.float().numpy(),
                                          np.asarray(a, np.float32))

    slots = np.asarray([3, 1], np.int32)
    none = np.zeros((2, 0), np.int32)
    jv = JD.gather_cache_view(jpool, spec_j, jnp.asarray(none),
                              jnp.asarray(slots))
    tv = TD.gather_cache_view(tpool, spec_t, torch.from_numpy(none),
                              torch.from_numpy(slots))
    for a, b in zip(jax.tree.leaves(jv), TD.tree_leaves(tv, spec_t)):
        np.testing.assert_array_equal(b.float().numpy(),
                                      np.asarray(a, np.float32))
    tv = {"layers": {k: v.flip(1) for k, v in tv["layers"].items()}}
    jv = jax.tree.map(lambda a: jnp.flip(a, 1), jv)
    jpool = JD.scatter_cache_view(jpool, spec_j, jnp.asarray(none),
                                  jnp.asarray(np.asarray([2, 4], np.int32)),
                                  jv)
    TD.scatter_cache_view(tpool, spec_t, torch.from_numpy(none),
                          torch.tensor([2, 4]), tv)
    same()
    jpool = JD.fork_state_slot(jpool, spec_j, 2, 1)
    TD.fork_state_slot(tpool, spec_t, 2, 1)
    jpool = JD.zero_state_slot(jpool, spec_j, 3)
    TD.zero_state_slot(tpool, spec_t, 3)
    same()
    host_j = JD.extract_pool_entries(jpool, spec_j, [], state_slot=4)
    host_t = TD.extract_pool_entries(tpool, spec_t, [], state_slot=4)
    jpool = JD.insert_pool_entries(jpool, spec_j, [], host_j, state_slot=3)
    TD.insert_pool_entries(tpool, spec_t, [], host_t, state_slot=3)
    same()


def test_greedy_run_matches_jax():
    """Reduced mamba2-780m, float32: two streams prefilled through
    ``prefill_chunk_step`` in chunks of 8 (one stream idle in the last
    tick), then greedy ``decode_step`` to 24 tokens each; logits agree to
    1e-4 at every step, the tokens are identical and so are the states."""
    from repro.models import decode as JD
    from repro_torch.models import decode as TD
    jcfg, tcfg = ssm_configs()
    jp = JP.init_params(jcfg, jax.random.PRNGKey(0))
    tp = from_reference(jax.tree.map(np.asarray, jp), device="cpu")
    B, C, max_len, total = 2, 8, 32, 24
    spec_j = JD.cache_view_specs(jcfg, max_len)
    spec_t = TD.cache_view_specs(tcfg, max_len)
    jc = JD.init_cache(jcfg, B, max_len)
    tc = TD.init_cache(tcfg, B, max_len, device="cpu")
    rng = np.random.default_rng(0)
    prompts = [rng.integers(2, jcfg.vocab, size=n) for n in (13, 6)]
    pos = np.zeros(B, np.int32)
    last = np.zeros(B, np.int32)
    while (pos < [len(p) for p in prompts]).any():
        toks = np.zeros((B, C), np.int32)
        n = np.zeros(B, np.int32)
        for i, p in enumerate(prompts):
            k = min(C, len(p) - pos[i])
            toks[i, :k] = p[pos[i]:pos[i] + k]
            n[i] = k
        jl, jc = JD.prefill_chunk_step(jp, jcfg, spec_j, jc,
                                       jnp.asarray(toks), jnp.asarray(pos),
                                       jnp.asarray(n))
        tl, tc = TD.prefill_chunk_step(tp, tcfg, spec_t, tc,
                                       torch.from_numpy(toks),
                                       torch.from_numpy(pos),
                                       torch.from_numpy(n))
        for i in range(B):
            if n[i]:
                close(jl[i], tl[i], 1e-4, "chunk logits")
                last[i] = int(np.argmax(np.asarray(jl[i])))
        pos += n
    gen = [[], []]
    for _ in range(total - 1):
        tok = last[:, None].astype(np.int32)
        jl, jc = JD.decode_step(jp, jcfg, jc, jnp.asarray(tok),
                                jnp.asarray(pos))
        tl, tc = TD.decode_step(tp, tcfg, tc, torch.from_numpy(tok),
                                torch.from_numpy(pos))
        close(jl, tl, 1e-4, "decode logits")
        last = np.asarray(tl.argmax(-1), np.int32)
        assert (last == np.asarray(jnp.argmax(jl, -1))).all()
        for i in range(B):
            gen[i].append(int(last[i]))
        pos += 1
    for k in jc["layers"]:
        close(jc["layers"][k], tc["layers"][k], 1e-4, k)
