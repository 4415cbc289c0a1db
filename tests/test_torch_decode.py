"""Parity of the port's dense serving steps and pool storage ops
(``repro_torch.models.decode``) with the JAX package on reduced
llama3-8b, float32 on the CPU, with the JAX weights carried across by
``from_reference``.

``prefill_chunk_step`` and ``decode_step`` logits must agree to 1e-4 at
every step of a 48-token run whose ring (W = 32) wraps, and the greedy
tokens must be identical."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import REGISTRY, reduced_config
from repro.models import decode as JD
from repro.models.params import init_params as j_init_params
from repro_torch.configs import REGISTRY as T_REGISTRY
from repro_torch.configs import reduced_config as t_reduced
from repro_torch.models import decode as TD
from repro_torch.models.params import from_reference

JCFG = reduced_config(REGISTRY["llama3-8b"])
TCFG = t_reduced(T_REGISTRY["llama3-8b"])
TOL = 1e-4


@pytest.fixture(scope="module")
def weights():
    jp = j_init_params(JCFG, jax.random.PRNGKey(0))
    return jp, from_reference(jax.tree.map(np.asarray, jp), device="cpu")


def close(want, got, tol=TOL):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=tol,
                               atol=tol)


def cache_close(jc, tc):
    for name in ("k", "v"):
        np.testing.assert_allclose(tc["layers"][name].numpy(),
                                   np.asarray(jc["layers"][name]),
                                   rtol=TOL, atol=TOL)


def test_greedy_run_matches_jax(weights):
    """Two streams: chunked prefill through ``prefill_chunk_step`` (mixed
    lengths, one stream idle in the last chunk tick), then greedy
    ``decode_step`` to 48 tokens each — past the ring width, so the ring
    wraps.  Logits match at every step; tokens are identical."""
    jp, tp = weights
    B, C, max_len, total = 2, 8, 32, 48
    spec_j = JD.cache_view_specs(JCFG, max_len)
    # the JAX steps jitted once, as its engine runs them (op by op they
    # dispatch every operation of every step anew)
    jprefill = jax.jit(lambda p, c, t, ps, n: JD.prefill_chunk_step(
        p, JCFG, spec_j, c, t, ps, n))
    jdecode = jax.jit(lambda p, c, t, ps: JD.decode_step(p, JCFG, c, t, ps))
    spec_t = TD.cache_view_specs(TCFG, max_len)
    jc = JD.init_cache(JCFG, B, max_len)
    tc = TD.init_cache(TCFG, B, max_len, device="cpu")
    rng = np.random.default_rng(0)
    prompts = [rng.integers(2, JCFG.vocab, size=n) for n in (13, 6)]
    pos = np.zeros(B, np.int32)
    last = np.zeros(B, np.int32)
    while any(pos[b] < len(prompts[b]) for b in range(B)):
        toks = np.zeros((B, C), np.int32)
        n = np.zeros(B, np.int32)
        for b in range(B):
            k = min(C, len(prompts[b]) - pos[b])
            if k > 0:
                toks[b, :k] = prompts[b][pos[b]:pos[b] + k]
                n[b] = k
        jl, jc = jprefill(jp, jc, jnp.asarray(toks), jnp.asarray(pos),
                          jnp.asarray(n))
        tl, tc = TD.prefill_chunk_step(tp, TCFG, spec_t, tc,
                                       torch.from_numpy(toks),
                                       torch.from_numpy(pos),
                                       torch.from_numpy(n),
                                       chunk_kernel="blocked")
        for b in range(B):
            if n[b]:
                close(jl[b], tl[b])
        cache_close(jc, tc)
        jn = np.asarray(JD.next_token_ids(jl, jnp.asarray(n)))
        tn = TD.next_token_ids(tl, torch.from_numpy(n)).numpy()
        np.testing.assert_array_equal(tn, jn)
        last = np.where(n > 0, tn, last)
        pos = pos + n
    gen = [[int(last[b])] for b in range(B)]
    while int(pos.min()) < total:
        toks = last[:, None].astype(np.int32)
        jl, jc = jdecode(jp, jc, jnp.asarray(toks), jnp.asarray(pos))
        tl, tc = TD.decode_step(tp, TCFG, tc, torch.from_numpy(toks),
                                torch.from_numpy(pos))
        close(jl, tl)
        cache_close(jc, tc)
        jn = np.asarray(jnp.argmax(jl, axis=-1))
        tn = tl.argmax(dim=-1).numpy()
        np.testing.assert_array_equal(tn, jn)
        last = tn.astype(np.int32)
        for b in range(B):
            gen[b].append(int(last[b]))
        pos = pos + 1
    assert [len(g) for g in gen] == [int(pos[b]) - len(prompts[b]) + 1
                                     for b in range(B)]


def test_all_logits_and_idle_rows(weights):
    """``all_logits`` rows match position by position; idle streams
    (n_tokens = 0) give NEG_INF logits and the -1 token sentinel."""
    jp, tp = weights
    B, C, max_len = 3, 6, 16
    spec_j = JD.cache_view_specs(JCFG, max_len)
    spec_t = TD.cache_view_specs(TCFG, max_len)
    rng = np.random.default_rng(1)
    toks = rng.integers(2, JCFG.vocab, size=(B, C)).astype(np.int32)
    pos = np.asarray([0, 9, 0], np.int32)
    n = np.asarray([6, 3, 0], np.int32)
    jl, _ = JD.prefill_chunk_step(jp, JCFG, spec_j,
                                  JD.init_cache(JCFG, B, max_len),
                                  jnp.asarray(toks), jnp.asarray(pos),
                                  jnp.asarray(n), all_logits=True)
    tl, _ = TD.prefill_chunk_step(tp, TCFG, spec_t,
                                  TD.init_cache(TCFG, B, max_len,
                                                device="cpu"),
                                  torch.from_numpy(toks),
                                  torch.from_numpy(pos), torch.from_numpy(n),
                                  all_logits=True)
    for b in range(B):
        close(jl[b, :n[b]], tl[b, :n[b]])
        assert (tl[b, n[b]:] == -1e30).all()
    lg = torch.zeros(B, TCFG.vocab)
    assert TD.next_token_ids(lg, torch.from_numpy(n)).tolist()[2] == -1


def test_pool_storage_ops_match_jax():
    """Gather/scatter of cache views, page copies, spill extract/insert
    and batched row gather/scatter leave the port's pool equal to the
    JAX pool, op by op."""
    max_len, bt, n_blocks = 32, 8, 9
    spec_j = JD.cache_view_specs(JCFG, max_len)
    spec_t = TD.cache_view_specs(TCFG, max_len)
    assert [(s.batch_axis, s.token_axis, s.width) for s in spec_t.leaves] \
        == [(s.batch_axis, s.token_axis, s.width) for s in spec_j.leaves]
    rng = np.random.default_rng(2)
    jpool = JD.init_block_pool(JCFG, spec_j, n_blocks, 1, bt, max_len)
    jpool = jax.tree.map(lambda a: jnp.asarray(
        rng.standard_normal(a.shape).astype(np.float32)), jpool)
    tpool = from_reference(jax.tree.map(np.asarray, jpool), device="cpu")
    zero = TD.init_block_pool(TCFG, spec_t, n_blocks, 1, bt, device="cpu")
    assert {k: v.shape for k, v in zero["layers"].items()} == \
        {k: tuple(v.shape) for k, v in tpool["layers"].items()}

    def same():
        for name in ("k", "v"):
            np.testing.assert_array_equal(tpool["layers"][name].numpy(),
                                          np.asarray(jpool["layers"][name]))

    tables = np.asarray([[3, 1, 0, 0], [5, 6, 7, 8]], np.int32)
    slots = np.zeros(2, np.int32)
    jv = JD.gather_cache_view(jpool, spec_j, jnp.asarray(tables),
                              jnp.asarray(slots))
    tv = TD.gather_cache_view(tpool, spec_t, torch.from_numpy(tables),
                              torch.from_numpy(slots))
    cache_close(jv, tv)
    upd = rng.standard_normal(tv["layers"]["k"].shape).astype(np.float32)
    jv = {"layers": {"k": jnp.asarray(upd), "v": jv["layers"]["v"]}}
    tv = {"layers": {"k": torch.from_numpy(upd), "v": tv["layers"]["v"]}}
    jpool = JD.scatter_cache_view(jpool, spec_j, jnp.asarray(tables),
                                  jnp.asarray(slots), jv)
    TD.scatter_cache_view(tpool, spec_t, torch.from_numpy(tables),
                          torch.from_numpy(slots), tv)
    # block 0 (the null page) was written twice: its bytes are unspecified
    for pool in (jpool, tpool):
        for name in ("k", "v"):
            pool["layers"][name] = pool["layers"][name][:, 1:]
    same()
    jpool = JD.init_block_pool(JCFG, spec_j, n_blocks, 1, bt, max_len)
    jpool = jax.tree.map(lambda a: jnp.asarray(
        rng.standard_normal(a.shape).astype(np.float32)), jpool)
    tpool = from_reference(jax.tree.map(np.asarray, jpool), device="cpu")
    jpool = JD.copy_pool_entries(jpool, spec_j, [2, 4], [7, 8])
    TD.copy_pool_entries(tpool, spec_t, [2, 4], [7, 8])
    same()
    host_j = JD.extract_pool_entries(jpool, spec_j, [1, 5])
    host_t = TD.extract_pool_entries(tpool, spec_t, [1, 5])
    for a, b in zip(host_j, host_t):
        np.testing.assert_array_equal(b.numpy(), a)
    jpool = JD.insert_pool_entries(jpool, spec_j, [6, 2], host_j)
    TD.insert_pool_entries(tpool, spec_t, [6, 2], host_t)
    same()
    rows_j = JD.gather_pool_rows(jpool, spec_j, [3, 4, 8])
    rows_t = TD.gather_pool_rows(tpool, spec_t, [3, 4, 8])
    for a, b in zip(rows_j, rows_t):
        np.testing.assert_array_equal(b.numpy(), np.asarray(a)[:, :3])
    jpool = JD.scatter_pool_rows(jpool, spec_j, [1, 2, 5],
                                 [np.asarray(a)[:, :3] for a in rows_j])
    TD.scatter_pool_rows(tpool, spec_t, [1, 2, 5], rows_t)
    same()
