"""Parity of the port's RG-LRU pieces with the JAX package on the CPU: the
linear-recurrence scan (the plain version, the kernel's wrapper on its
plain route, and its gradient), the full-sequence recurrent block, the
serving chunk and decode steps, the hybrid cache's layout and pool state
ops, and a greedy run of the hybrid model's serving steps.

The same numpy-seeded inputs go through the JAX function and its port.
Tolerances: 1e-5 for the scan against the JAX Pallas kernel in interpret
mode and its oracle (the JAX package's own ``test_lru_scan`` tolerance)
and 1e-4 for its gradients (``test_lru_grads``); 1e-4 for the block and
the steps in float32; in bf16 they are compared to 2e-2 (one bf16
rounding of values of order one), since both packages round at the same
places."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import REGISTRY, reduced_config
from repro.kernels.rglru_scan.ops import lru as j_lru
from repro.kernels.rglru_scan.ref import lru_scan_ref as j_lru_scan_ref
from repro.models import params as JP
from repro.models import rglru as JR
from repro_torch.configs import REGISTRY as T_REGISTRY
from repro_torch.configs import reduced_config as t_reduced
from repro_torch.kernels.rglru_scan import ops, ref
from repro_torch.models import rglru as TR
from repro_torch.models.params import from_reference

# B, S, W, block_s, block_w: tests/test_kernels.py's LRU_SWEEP
LRU_SWEEP = [(2, 128, 64, 32, 32), (1, 64, 128, 16, 128), (3, 32, 16, 32, 16),
             (1, 256, 32, 64, 32)]
SWEEP_IDS = [f"B{b}_S{s}_W{w}" for b, s, w, _, _ in LRU_SWEEP]


def t(x, dtype=None):
    out = torch.from_numpy(np.array(x, np.float32))
    return out if dtype is None else out.to(dtype)


def close(jax_out, torch_out, tol, what=""):
    np.testing.assert_allclose(
        np.asarray(torch_out.detach().float()),
        np.asarray(jnp.asarray(jax_out, jnp.float32)), rtol=tol, atol=tol,
        err_msg=what)


def lru_inputs(B, S, W, seed):
    """a in (0, 1) and b, as the JAX package's LRU test draws them (a
    sigmoid of a normal), and a carried state."""
    rng = np.random.default_rng(seed)
    a = 1.0 / (1.0 + np.exp(-rng.standard_normal((B, S, W))))
    return (a.astype(np.float32),
            rng.standard_normal((B, S, W)).astype(np.float32),
            rng.standard_normal((B, W)).astype(np.float32))


# ---------------------------------------------------------------------------
# the scan
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("geo", LRU_SWEEP, ids=SWEEP_IDS)
def test_scan_matches_the_pallas_kernel(geo):
    """The plain version and the wrapper's CPU route against the JAX
    Pallas kernel (interpret mode) and the JAX oracle; h and h_final."""
    B, S, W, bs, bw = geo
    a, b, _ = lru_inputs(B, S, W, seed=S + W)
    jh = j_lru(jnp.asarray(a), jnp.asarray(b), bs, bw, True)
    jref, jfin = j_lru_scan_ref(jnp.asarray(a), jnp.asarray(b))
    for h, fin in (ref.lru_scan_plain(t(a), t(b)), ops.lru_scan(t(a), t(b))):
        close(jh, h, 1e-5, "h against the Pallas kernel")
        close(jref, h, 1e-5, "h against the oracle")
        close(jfin, fin, 1e-5, "h_final")
    close(jh, ops.lru(t(a), t(b)), 1e-5, "ops.lru")


@pytest.mark.parametrize("geo", LRU_SWEEP, ids=SWEEP_IDS)
def test_scan_with_carried_state_and_reverse(geo):
    """``h0`` seeds the scan as in the JAX oracle ``lru_scan_ref(a, b,
    h0)``; ``reverse`` is the oracle on the time-flipped inputs."""
    B, S, W, _, _ = geo
    a, b, h0 = lru_inputs(B, S, W, seed=3 * S + W)
    jh, jfin = j_lru_scan_ref(jnp.asarray(a), jnp.asarray(b),
                              jnp.asarray(h0))
    h, fin = ops.lru_scan(t(a), t(b), t(h0))
    close(jh, h, 1e-5, "h0: h")
    close(jfin, fin, 1e-5, "h0: h_final")
    jh, jfin = j_lru_scan_ref(jnp.asarray(a[:, ::-1]),
                              jnp.asarray(b[:, ::-1]), jnp.asarray(h0))
    h, fin = ops.lru_scan(t(a), t(b), t(h0), reverse=True)
    close(jh[:, ::-1], h, 1e-5, "reverse: h")
    close(jfin, fin, 1e-5, "reverse: h_final")


@pytest.mark.parametrize("geo", [(2, 64, 32, 16, 32)] + LRU_SWEEP[:2],
                         ids=["B2_S64_W32"] + SWEEP_IDS[:2])
def test_scan_gradients(geo):
    """``ops.lru``'s backward (the reverse scan on the same wrapper)
    against ``jax.grad`` of the JAX ``lru`` (Pallas interpret mode), for
    the loss sum(h ** 2), in a and in b."""
    B, S, W, bs, bw = geo
    a, b, _ = lru_inputs(B, S, W, seed=S)
    gj = jax.grad(lambda a, b: (j_lru(a, b, bs, bw, True) ** 2).sum(),
                  argnums=(0, 1))(jnp.asarray(a), jnp.asarray(b))
    ta, tb = t(a).requires_grad_(True), t(b).requires_grad_(True)
    (ops.lru(ta, tb) ** 2).sum().backward()
    close(gj[0], ta.grad, 1e-4, "da")
    close(gj[1], tb.grad, 1e-4, "db")


# ---------------------------------------------------------------------------
# the block and the serving steps
# ---------------------------------------------------------------------------

def hybrid_configs(dtype="float32"):
    j = dataclasses.replace(reduced_config(REGISTRY["recurrentgemma-9b"]),
                            param_dtype=dtype, compute_dtype=dtype)
    tc = dataclasses.replace(t_reduced(T_REGISTRY["recurrentgemma-9b"]),
                             param_dtype=dtype, compute_dtype=dtype)
    return j, tc


def layer_weights(jcfg, seed=0):
    """One recurrent layer's weights (JAX init, first group's first
    layer), as both trees; the gates' weights scaled up so the gates
    move away from 0.5."""
    jp = JP.init_params(jcfg, jax.random.PRNGKey(seed))
    lp = jax.tree.map(lambda a: a[0], jp["groups"]["b0_rec"]["rec"])
    lp = dict(lp, w_a=lp["w_a"] * 30, w_x=lp["w_x"] * 30)
    return lp, from_reference(jax.tree.map(np.asarray, lp), device="cpu")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("S", [64, 45], ids=["S64", "S45"])
def test_rglru_block_apply(S, dtype):
    """The full-sequence block against the JAX block with its Pallas scan
    (interpret mode, S a multiple of its 256/S block) and with its
    associative-scan route; the decode state too."""
    jcfg, tcfg = hybrid_configs(dtype)
    jlp, tlp = layer_weights(jcfg)
    x = np.random.default_rng(S).standard_normal((2, S, jcfg.d_model)) \
        .astype(np.float32)
    td = getattr(torch, dtype)
    tout, tst = TR.rglru_block_apply(t(x, td), tlp, tcfg)
    assert tout.dtype == td
    assert tst["h"].dtype == torch.float32 and tst["conv"].dtype == td
    tol = 1e-4 if dtype == "float32" else 2e-2
    for use_pallas in (True, False):
        jout, jst = JR.rglru_block_apply(
            jnp.asarray(x).astype(getattr(jnp, dtype)), jlp,
            dataclasses.replace(jcfg, use_pallas=use_pallas))
        close(jout, tout, tol, f"out use_pallas={use_pallas}")
        for k in jst:
            close(jst[k], tst[k], tol, f"{k} use_pallas={use_pallas}")


def test_rglru_block_gradients():
    """Gradients of the block's output through the port's scan wrapper
    against ``jax.grad`` of the JAX block (Pallas route), float32, for
    the input and every weight, under a random cotangent."""
    jcfg, tcfg = hybrid_configs()
    jlp, tlp = layer_weights(jcfg, seed=4)
    rng = np.random.default_rng(5)
    x = rng.standard_normal((2, 32, jcfg.d_model)).astype(np.float32)
    g = rng.standard_normal((2, 32, jcfg.d_model)).astype(np.float32)
    cfg_p = dataclasses.replace(jcfg, use_pallas=True)
    jg = jax.grad(lambda x, p: (JR.rglru_block_apply(x, p, cfg_p)[0] * g)
                  .sum(), argnums=(0, 1))(jnp.asarray(x), jlp)
    tx = t(x).requires_grad_(True)
    tp = {k: v.clone().requires_grad_(True) for k, v in tlp.items()}
    (TR.rglru_block_apply(tx, tp, tcfg)[0] * t(g)).sum().backward()
    close(jg[0], tx.grad, 1e-4, "dx")
    for k in tp:
        close(jg[1][k], tp[k].grad, 1e-4, f"d{k}")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rglru_chunk_and_decode_steps(dtype):
    """From a carried state: a chunk step with ragged per-stream token
    counts (full, partial, idle) and then two decode steps, each against
    the JAX step on the same state; the idle stream's state passes
    unchanged."""
    jcfg, tcfg = hybrid_configs(dtype)
    jlp, tlp = layer_weights(jcfg, seed=1)
    rng = np.random.default_rng(6)
    B, C, W = 3, 12, jcfg.lru_width
    st = {"h": rng.standard_normal((B, W)) * 0.5,
          "conv": rng.standard_normal((B, jcfg.conv_width - 1, W))}
    jd, td = getattr(jnp, dtype), getattr(torch, dtype)
    jst = {"h": jnp.asarray(st["h"], jnp.float32),
           "conv": jnp.asarray(st["conv"], jd)}
    tst = {"h": t(st["h"]), "conv": t(st["conv"], td)}
    x = rng.standard_normal((B, C, jcfg.d_model)).astype(np.float32)
    n = np.array([12, 5, 0], np.int32)
    tol = 1e-4 if dtype == "float32" else 2e-2
    jout, jst = JR.rglru_chunk_step(jnp.asarray(x).astype(jd), jlp, jcfg,
                                    jst, jnp.asarray(n))
    tout, new = TR.rglru_chunk_step(t(x, td), tlp, tcfg, tst,
                                    torch.from_numpy(n))
    close(jout[0], tout[0], tol, "chunk out, full stream")
    close(jout[1, :5], tout[1, :5], tol, "chunk out, partial stream")
    for k in jst:
        close(jst[k], new[k], tol, f"chunk {k}")
        assert torch.equal(new[k][2], tst[k][2]), f"idle stream's {k}"
    assert new["h"].dtype == torch.float32 and new["conv"].dtype == td
    tst = new
    for i in range(2):
        xt = rng.standard_normal((B, 1, jcfg.d_model)).astype(np.float32)
        jout, jst = JR.rglru_decode_step(jnp.asarray(xt).astype(jd), jlp,
                                         jcfg, jst)
        tout, tst = TR.rglru_decode_step(t(xt, td), tlp, tcfg, tst)
        close(jout, tout, tol, f"decode {i} out")
        for k in jst:
            close(jst[k], tst[k], tol, f"decode {i} {k}")
        assert tst["h"].dtype == torch.float32 and tst["conv"].dtype == td


def test_chunk_steps_replay_the_block():
    """Three chunk steps of 16 tokens from the zero state give the block's
    final state and (for the last chunk) its output."""
    jcfg, tcfg = hybrid_configs()
    _, tlp = layer_weights(jcfg, seed=2)
    x = t(np.random.default_rng(7).standard_normal((2, 48, jcfg.d_model)))
    out, state = TR.rglru_block_apply(x, tlp, tcfg)
    st = TR.rglru_init_state(tcfg, 2, torch.float32, device="cpu")
    n = torch.full((2,), 16, dtype=torch.int32)
    for c in range(3):
        o, st = TR.rglru_chunk_step(x[:, 16 * c:16 * (c + 1)], tlp, tcfg, st,
                                    n)
    torch.testing.assert_close(o, out[:, 32:], rtol=1e-4, atol=1e-4)
    for k in state:
        torch.testing.assert_close(st[k], state[k], rtol=1e-4, atol=1e-4)


# ---------------------------------------------------------------------------
# the serving cache and the model steps
# ---------------------------------------------------------------------------

def test_cache_layout_and_pool_state_ops_bf16():
    """bf16 recurrentgemma: the port's declared cache layout equals the
    JAX package's probed one leaf by leaf (stream axis, token axis, ring
    width, shape, type) — the RG-LRU ``h`` float32, its conv tail and the
    local-attention rings bf16; the pool's state-slot and page ops
    (gather, scatter, fork, zero, extract, insert) leave the pool equal to
    the JAX pool."""
    from repro.models import decode as JD
    from repro_torch.models import decode as TD
    from repro_torch.serving.swap import SwapTier
    jcfg, tcfg = hybrid_configs("bfloat16")
    spec_j = JD.cache_view_specs(jcfg, 48)
    spec_t = TD.cache_view_specs(tcfg, 48)
    assert [(s.batch_axis, s.token_axis, s.width) for s in spec_t.leaves] \
        == [(s.batch_axis, s.token_axis, s.width) for s in spec_j.leaves]
    assert spec_t.width == spec_j.width == 32
    jleaves = jax.tree.leaves(JD.init_cache(jcfg, 1, 48))
    assert [tuple(a.shape) for a in jleaves] == list(spec_t.shapes)
    assert [str(a.dtype) for a in jleaves] == \
        [str(d).replace("torch.", "") for d in spec_t.dtypes]
    cache = TD.init_cache(tcfg, 3, 48, device="cpu")
    for got, want in zip(TD.tree_leaves(cache, spec_t),
                         jax.tree.leaves(JD.init_cache(jcfg, 3, 48))):
        assert tuple(got.shape) == tuple(want.shape)
    bt = 8
    pool = TD.init_block_pool(tcfg, spec_t, 6, 5, bt, device="cpu")
    jpool = JD.init_block_pool(jcfg, spec_j, 6, 5, bt, 48)
    for pl, want, d in zip(TD.tree_leaves(pool, spec_t),
                           jax.tree.leaves(jpool), spec_t.dtypes):
        assert pl.dtype == d and tuple(pl.shape) == tuple(want.shape)
    tier = SwapTier(TD.tree_leaves(pool, spec_t), spec_t, 4, 2)
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

    tables = np.asarray([[1, 2, 3, 4], [5, 0, 0, 0]], np.int32)
    slots = np.asarray([3, 1], np.int32)
    jv = JD.gather_cache_view(jpool, spec_j, jnp.asarray(tables),
                              jnp.asarray(slots))
    tv = TD.gather_cache_view(tpool, spec_t, torch.from_numpy(tables),
                              torch.from_numpy(slots))
    for a, b in zip(jax.tree.leaves(jv), TD.tree_leaves(tv, spec_t)):
        np.testing.assert_array_equal(b.float().numpy(),
                                      np.asarray(a, np.float32))
    jv = jax.tree.map(lambda a: a * 2, jv)
    tv = TD.tree_from_leaves(spec_t, [x * 2 for x in TD.tree_leaves(tv,
                                                                    spec_t)])
    new_tables = np.asarray([[4, 3, 2, 1], [5, 0, 0, 0]], np.int32)
    jpool = JD.scatter_cache_view(jpool, spec_j, jnp.asarray(new_tables),
                                  jnp.asarray(np.asarray([2, 4], np.int32)),
                                  jv)
    TD.scatter_cache_view(tpool, spec_t, torch.from_numpy(new_tables),
                          torch.tensor([2, 4]), tv)
    same()
    jpool = JD.copy_pool_entries(jpool, spec_j, [1, 2], [0, 5], 2, 1)
    TD.copy_pool_entries(tpool, spec_t, [1, 2], [0, 5], 2, 1)
    jpool = JD.zero_state_slot(jpool, spec_j, 3)
    TD.zero_state_slot(tpool, spec_t, 3)
    same()
    host_j = JD.extract_pool_entries(jpool, spec_j, [2, 3], state_slot=4)
    host_t = TD.extract_pool_entries(tpool, spec_t, [2, 3], state_slot=4)
    jpool = JD.insert_pool_entries(jpool, spec_j, [1, 5], host_j,
                                   state_slot=3)
    TD.insert_pool_entries(tpool, spec_t, [1, 5], host_t, state_slot=3)
    same()


def test_greedy_run_matches_jax():
    """Reduced recurrentgemma-9b, float32: two streams prefilled through
    ``prefill_chunk_step`` in chunks of 8 (one stream idle in the last
    ticks), then greedy ``decode_step`` past the 32-token local window;
    logits agree to 1e-4 at every step, the tokens are identical and so
    are the caches."""
    from repro.models import decode as JD
    from repro_torch.models import decode as TD
    jcfg, tcfg = hybrid_configs()
    jp = JP.init_params(jcfg, jax.random.PRNGKey(0))
    tp = from_reference(jax.tree.map(np.asarray, jp), device="cpu")
    B, C, max_len, total = 2, 8, 48, 30
    spec_j = JD.cache_view_specs(jcfg, max_len)
    # the JAX steps jitted once, as its engine runs them (op by op they
    # dispatch every operation of every step anew)
    jprefill = jax.jit(lambda p, c, t, ps, n: JD.prefill_chunk_step(
        p, jcfg, spec_j, c, t, ps, n))
    jdecode = jax.jit(lambda p, c, t, ps: JD.decode_step(p, jcfg, c, t, ps))
    spec_t = TD.cache_view_specs(tcfg, max_len)
    jc = JD.init_cache(jcfg, B, max_len)
    tc = TD.init_cache(tcfg, B, max_len, device="cpu")
    rng = np.random.default_rng(0)
    prompts = [rng.integers(2, jcfg.vocab, size=n) for n in (21, 6)]
    pos = np.zeros(B, np.int32)
    last = np.zeros(B, np.int32)
    while (pos < [len(p) for p in prompts]).any():
        toks = np.zeros((B, C), np.int32)
        n = np.zeros(B, np.int32)
        for i, p in enumerate(prompts):
            k = min(C, len(p) - pos[i])
            toks[i, :k] = p[pos[i]:pos[i] + k]
            n[i] = k
        jl, jc = jprefill(jp, jc, jnp.asarray(toks), jnp.asarray(pos),
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
    for _ in range(total - 1):
        tok = last[:, None].astype(np.int32)
        jl, jc = jdecode(jp, jc, jnp.asarray(tok), jnp.asarray(pos))
        tl, tc = TD.decode_step(tp, tcfg, tc, torch.from_numpy(tok),
                                torch.from_numpy(pos))
        close(jl, tl, 1e-4, "decode logits")
        last = np.asarray(tl.argmax(-1), np.int32)
        assert (last == np.asarray(jnp.argmax(jl, -1))).all()
        pos += 1
    for a, b in zip(jax.tree.leaves(jc), TD.tree_leaves(tc, spec_t)):
        close(a, b, 1e-4, "cache")
