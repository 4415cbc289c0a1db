"""The port's MoE layer (``models/moe.py``) and the MoE family's model and
serving steps against the JAX package, on the CPU, on reduced
mixtral-8x22b (swiglu experts) and grok-1-314b (gelu experts, a 30.0
logit softcap).

Weights are drawn by the port's seeded ``init_params`` and handed to both
packages (the JAX init's std ``n_layers ** -0.5`` saturates the router at
two layers; ROADMAP C).  Tolerances: float32 1e-5 on ``moe_apply``'s
output, aux terms and gradients (relative to each tensor's largest
magnitude), 1e-4 on the model's loss, gradients and steps as
``test_torch_train.py`` holds the other families; bf16 2e-2.

The reduced configs set ``capacity_factor = E / K``, so capacity equals
the block and nothing drops.  The ``cf1.0`` cases set it to 1.0 in both
packages: the JAX layer drops claims there (asserted), and the port drops
the same ones; the ``dropless`` cases run at 1.0 too and drop nothing.  Every ``moe_apply`` case runs B = 2 with S not a whole
number of blocks, so the last block holds zero-padded positions whose
logits tie across all experts: they claim experts 0 and 1 (the lower index
first, as ``lax.top_k``) and, in the flat form, take capacity ahead of
row 1's tokens."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import lax

from repro.configs import REGISTRY, reduced_config
from repro.launch import steps as JS
from repro.models import decode as JD
from repro.models import moe as JM
from repro.models import transformer as JT
from repro.optim.adamw import AdamWConfig as JAdamW
from repro.optim.adamw import init_opt_state as j_init_opt
from repro_torch.configs import REGISTRY as T_REGISTRY
from repro_torch.configs import reduced_config as t_reduced
from repro_torch.launch import steps as TS
from repro_torch.models import decode as TD
from repro_torch.models import moe as TM
from repro_torch.models.layers import GLU
from repro_torch.models import transformer as TT
from repro_torch.models.params import from_reference, init_params
from repro_torch.optim.adamw import AdamWConfig as TAdamW
from repro_torch.optim.adamw import init_opt_state as t_init_opt

ARCHS = ("mixtral-8x22b", "grok-1-314b")
TOL = {"float32": 1e-5, "bfloat16": 2e-2}
# moe_block 16 at B = 2: blocks of 8 positions, S = 13 pads 3 of them
B, S, BLOCK = 2, 13, 16


def configs(arch, **kw):
    return (dataclasses.replace(reduced_config(REGISTRY[arch]), **kw),
            dataclasses.replace(t_reduced(T_REGISTRY[arch]), **kw))


def port_weights(tcfg, seed=5):
    """The port's seeded weights as (torch tree, JAX tree)."""
    tp = init_params(tcfg, torch.Generator().manual_seed(seed), device="cpu")
    return tp, jax.tree.map(lambda t: jnp.asarray(to_np(t)), tp)


def to_np(t):
    t = t.detach()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(jnp.bfloat16)
    return t.numpy()


def close(got, want, tol, what):
    """|got - want| <= tol * max(1, max |want|), element by element."""
    got = got.detach().float().numpy() if isinstance(got, torch.Tensor) \
        else np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    scale = max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(got, want, rtol=0, atol=tol * scale,
                               err_msg=what)


def layer0(tree):
    return {k: v[0] for k, v in tree["layers"]["moe"].items()}


@pytest.fixture(scope="module", params=ARCHS)
def arch(request):
    return request.param


# (dropless, capacity factor): the reduced config's capacity (E / K: the
# block, nothing drops), capacity factor 1.0 (claims drop), and dropless
# (capacity = the block whatever the factor)
CAPACITY = {"cf_reduced": (False, None), "cf1.0": (False, 1.0),
            "dropless": (True, 1.0)}


@pytest.mark.parametrize("capacity", list(CAPACITY))
@pytest.mark.parametrize("batched", [False, True], ids=["flat", "batched"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_moe_apply_matches_jax(arch, dtype, batched, capacity):
    """``moe_apply``'s output, ``lb_loss`` and ``dropped``, and the
    gradients of sum(y * r) + lb_loss with respect to x, ``router``,
    ``wi`` and ``wo``, against ``jax.value_and_grad`` (for bf16 gelu
    experts, of a float32 run on the same values: the JAX CPU backend
    cannot run that backward in bf16)."""
    dropless, cf = CAPACITY[capacity]
    kw = dict(moe_batched=batched, moe_block=BLOCK, param_dtype=dtype,
              compute_dtype=dtype)
    if cf is not None:
        kw["capacity_factor"] = cf
    jcfg, tcfg = configs(arch, **kw)
    tp, jp = port_weights(tcfg)
    tp, jp = layer0(tp), layer0(jp)
    rng = np.random.default_rng(1)
    x = torch.from_numpy(rng.standard_normal((B, S, tcfg.d_model))
                         .astype(np.float32)).to(tp["wo"].dtype)
    r = rng.standard_normal((B, S, tcfg.d_model)).astype(np.float32)

    def jloss(x_, p):
        y, aux = JM.moe_apply(x_, p, jcfg, dropless=dropless)
        return (jnp.sum(y.astype(jnp.float32) * r) + aux["lb_loss"],
                (y, aux))

    jx = jnp.asarray(to_np(x))
    grad = jax.value_and_grad(jloss, argnums=(0, 1), has_aux=True)
    if dtype == "bfloat16" and tcfg.activation not in GLU:
        # XLA's CPU backend has no bf16 x bf16 -> f32 dot for this
        # backward: the gradients come from float32 on the same values
        jy, jaux = JM.moe_apply(jx, jp, jcfg, dropless=dropless)
        jcfg = dataclasses.replace(jcfg, param_dtype="float32",
                                   compute_dtype="float32")
        up = jax.tree.map(lambda a: a.astype(jnp.float32), (jx, jp))
        _, jg = grad(*up)
    else:
        (_, (jy, jaux)), jg = grad(jx, jp)
    if cf == 1.0 and not dropless:
        assert float(jaux["dropped"]) > 0       # the case really drops
    else:
        assert float(jaux["dropped"]) == 0.0
    xt = x.clone().requires_grad_(True)
    pt = {k: v.clone().requires_grad_(True) for k, v in tp.items()}
    ty, taux = TM.moe_apply(xt, pt, tcfg, dropless=dropless)
    ((ty.float() * torch.from_numpy(r)).sum() + taux["lb_loss"]).backward()
    tol = TOL[dtype]
    assert ty.dtype == x.dtype and ty.shape == x.shape
    close(ty, jy, tol, "y")
    close(taux["lb_loss"], jaux["lb_loss"], tol, "lb_loss")
    assert float(taux["dropped"]) == float(jaux["dropped"])
    close(xt.grad, jg[0], tol, "dx")
    for k in ("router", "wi", "wo"):
        assert pt[k].grad.dtype == tp[k].dtype
        close(pt[k].grad, jg[1][k], tol, f"d{k}")


@pytest.mark.parametrize("form", ["moe_block_apply", "moe_block_apply_flat"])
@pytest.mark.parametrize("dropless", [False, True],
                         ids=["capacity", "dropless"])
def test_block_forms_match_jax(arch, form, dropless):
    """One block with zero rows among its tokens, at capacity factor 1.0
    (capacity 5 of the flat form's 20 tokens): output and aux of each
    block form against the JAX one."""
    jcfg, tcfg = configs(arch)
    tp, jp = port_weights(tcfg)
    tp, jp = layer0(tp), layer0(jp)
    x = np.random.default_rng(2).standard_normal((2, 10, tcfg.d_model)) \
        .astype(np.float32)
    x[0, 7:] = 0.0
    x[1, :2] = 0.0
    kw = dict(n_experts=tcfg.n_experts, top_k=tcfg.top_k,
              capacity_factor=1.0, activation=tcfg.activation,
              dropless=dropless)
    jy, jaux = getattr(JM, form)(jnp.asarray(x), jp, **kw)
    ty, taux = getattr(TM, form)(torch.from_numpy(x), tp, **kw)
    close(ty, jy, 1e-5, "y")
    close(taux["lb_loss"], jaux["lb_loss"], 1e-5, "lb_loss")
    assert float(taux["dropped"]) == float(jaux["dropped"])
    assert (float(jaux["dropped"]) > 0) == (not dropless)


def test_top_k_ties_take_the_lower_index():
    """Equal logits: the lower expert index first, as ``lax.top_k``."""
    rng = np.random.default_rng(0)
    logits = rng.integers(0, 3, size=(64, 8)).astype(np.float32)
    logits[:4] = 0.0
    jv, ji = lax.top_k(jnp.asarray(logits), 2)
    tv, ti = TM.top_k_lowest_first(torch.from_numpy(logits), 2)
    assert ti[:4].tolist() == [[0, 1]] * 4
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))


def test_blocks_recompute_only_where_autograd_records(monkeypatch):
    """A step whose weights require no gradient (a serving step) calls
    its MoE blocks directly, as JAX's serve steps do; a training forward
    wraps each block in a checkpoint.  On the card a first checkpoint
    imports ``torch._dynamo``: 12.6 s before serve_adaptive_torch.py's
    first token (PR 28, call 2)."""
    _, tcfg = configs("mixtral-8x22b")
    params = layer0(init_params(tcfg, torch.Generator().manual_seed(0),
                                device="cpu"))
    x = torch.randn(B, S, tcfg.d_model, generator=torch.Generator()
                    .manual_seed(1))
    calls = []
    real = TM.checkpoint

    def spy(*args, **kw):
        calls.append(1)
        return real(*args, **kw)

    monkeypatch.setattr(TM, "checkpoint", spy)
    served, _ = TM.moe_apply(x, params, tcfg, dropless=True)
    assert calls == []
    trained = {k: v.clone().requires_grad_() for k, v in params.items()}
    y, _ = TM.moe_apply(x, trained, tcfg, dropless=True)
    # one checkpoint a block of the sequence
    assert len(calls) == -(-S // max(1, min(tcfg.moe_block // B, S)))
    torch.testing.assert_close(y, served, rtol=0, atol=0)


# ---------------------------------------------------------------------------
# The model: forward, loss, gradients, train steps
# ---------------------------------------------------------------------------

OPT = dict(peak_lr=1e-3, warmup_steps=2, total_steps=10)
TB, TS_ = 2, 64


@pytest.fixture(scope="module")
def model(arch):
    jcfg, tcfg = configs(arch)
    tp, jp = port_weights(tcfg)
    rng = np.random.default_rng(7)
    block = rng.integers(2, jcfg.vocab, size=(TB, TS_ + 1)).astype(np.int32)
    mask = (rng.random((TB, TS_)) < 0.9).astype(np.float32)
    batch = {"tokens": block[:, :-1], "targets": block[:, 1:], "mask": mask}
    return jcfg, tcfg, tp, jp, batch


def tbatch(batch):
    return {k: torch.from_numpy(np.array(v)) for k, v in batch.items()}


def fresh(tp):
    return jax.tree.map(lambda t: t.clone(), tp)


def tree_close(jtree, ttree, tol, what):
    jl = jax.tree_util.tree_flatten_with_path(jtree)[0]
    tl = dict(jax.tree_util.tree_flatten_with_path(ttree)[0])
    assert len(jl) == len(tl), what
    for path, want in jl:
        np.testing.assert_allclose(
            tl[path].detach().float().numpy(), np.asarray(want, np.float32),
            rtol=tol, atol=tol, err_msg=f"{what} {jax.tree_util.keystr(path)}")


def test_forward_and_loss(model):
    """``forward``'s hiddens and aux (the layers' summed ``lb_loss``),
    ``loss_fn``'s loss, ce and aux."""
    jcfg, tcfg, tp, jp, batch = model
    jx, jaux = JT.forward(jp, jcfg, jnp.asarray(batch["tokens"]))
    tx, taux = TT.forward(tp, tcfg, torch.from_numpy(batch["tokens"]))
    close(tx, jx, 1e-5, "x")
    assert float(jaux) > 0
    np.testing.assert_allclose(float(taux), float(jaux), rtol=1e-5)
    jl, jparts = JT.loss_fn(jp, jcfg, batch)
    tl, tparts = TT.loss_fn(tp, tcfg, tbatch(batch))
    for got, want in ((tl, jl), (tparts["ce"], jparts["ce"]),
                      (tparts["aux"], jparts["aux"])):
        np.testing.assert_allclose(float(got), float(want), rtol=1e-5,
                                   atol=1e-5)


@pytest.mark.parametrize("remat", ["none", "full"])
def test_every_gradient_leaf(model, remat):
    """``steps.value_and_grad`` against ``jax.value_and_grad(loss_fn)``,
    the router's and experts' leaves among them; under remat each layer
    is recomputed around the blocks' own recomputation."""
    jcfg, tcfg, tp, jp, batch = model
    tcfg = dataclasses.replace(tcfg, remat=remat)
    (jl, _), jg = jax.value_and_grad(
        lambda p: JT.loss_fn(p, jcfg, batch), has_aux=True)(jp)
    tl, _, tg = TS.value_and_grad(tcfg, fresh(tp), tbatch(batch))
    np.testing.assert_allclose(float(tl), float(jl), rtol=1e-5, atol=1e-5)
    tree_close(jg, tg, 1e-4, "grad")


def test_train_steps_match(model):
    """Two steps of ``make_train_step``: params, moments and the metrics,
    ``aux`` among them."""
    jcfg, tcfg, tp, jp, batch = model
    jstep = jax.jit(JS.make_train_step(jcfg, JAdamW(**OPT)))
    tstep = TS.make_train_step(tcfg, TAdamW(**OPT))
    jparams, jopt = jp, j_init_opt(jp)
    tparams = fresh(tp)
    topt = t_init_opt(tparams)
    for _ in range(2):
        jparams, jopt, jm = jstep(jparams, jopt, batch)
        tparams, topt, tm = tstep(tparams, topt, tbatch(batch))
        assert float(tm["aux"]) > 0
        for k in ("loss", "ce", "aux", "grad_norm", "lr"):
            np.testing.assert_allclose(float(tm[k]), float(jm[k]),
                                       rtol=1e-4, atol=1e-5, err_msg=k)
    tree_close(jparams, tparams, 1e-4, "params")
    tree_close(jopt["m"], topt["m"], 1e-4, "m")
    tree_close(jopt["v"], topt["v"], 1e-4, "v")


# ---------------------------------------------------------------------------
# The serving steps, on reduced mixtral-8x22b
# ---------------------------------------------------------------------------

LOGIT_TOL, CACHE_TOL = 1e-4, 2e-4


@pytest.fixture(scope="module")
def served():
    jcfg, tcfg = configs("mixtral-8x22b")
    tp, jp = port_weights(tcfg)
    return jcfg, tcfg, tp, jp


def _caches_close(jc, tc, spec):
    jleaves = jax.tree.leaves(jc)
    tleaves = TD.tree_leaves(tc, spec)
    assert len(jleaves) == len(tleaves) == 2
    for a, b in zip(jleaves, tleaves):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=CACHE_TOL,
                                   atol=CACHE_TOL)


@pytest.mark.parametrize("cf", [None, 1.0], ids=["cf_reduced", "cf1.0"])
def test_prefill_keeps_the_capacity(served, cf, monkeypatch):
    """Whole-prompt ``prefill`` runs the experts at the configured
    capacity, as the JAX prefill does: at capacity factor 1.0 the port's
    layers drop claims (recorded by a spy) and the logits and ring cache
    still equal the JAX prefill's."""
    jcfg, tcfg, tp, jp = served
    if cf is not None:
        jcfg = dataclasses.replace(jcfg, capacity_factor=cf)
        tcfg = dataclasses.replace(tcfg, capacity_factor=cf)
    drops, apply = [], TM.moe_apply

    def spy(*a, **kw):
        y, aux = apply(*a, **kw)
        drops.append(float(aux["dropped"]))
        return y, aux

    monkeypatch.setattr(TM, "moe_apply", spy)
    toks = np.random.default_rng(3).integers(2, jcfg.vocab, size=(2, 70)) \
        .astype(np.int32)
    jl, jc = JD.prefill(jp, jcfg, jnp.asarray(toks), max_len=96)
    tl, tc = TD.prefill(tp, tcfg, torch.from_numpy(toks), max_len=96)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=LOGIT_TOL,
                               atol=LOGIT_TOL)
    _caches_close(jc, tc, TD.cache_view_specs(tcfg, 96))
    assert len(drops) == tcfg.n_layers
    assert (max(drops) > 0) == (cf == 1.0)


def test_decode_and_chunk_steps(served):
    """A prefill, then ``decode_step``, ``prefill_chunk_step`` (blocked and
    dense) and ``chunk_decode_step`` against the JAX steps, each from the
    same cache, at capacity factor 1.0: the serving steps run dropless,
    so no token of one stream moves another's output."""
    jcfg, tcfg, tp, jp = served
    jcfg = dataclasses.replace(jcfg, capacity_factor=1.0)
    tcfg = dataclasses.replace(tcfg, capacity_factor=1.0)
    max_len = 48
    rng = np.random.default_rng(4)
    prompt = rng.integers(2, jcfg.vocab, size=(3, 20)).astype(np.int32)
    jl, jc = JD.prefill(jp, jcfg, jnp.asarray(prompt), max_len=max_len)
    _, tc = TD.prefill(tp, tcfg, torch.from_numpy(prompt), max_len=max_len)
    spec = TD.cache_view_specs(tcfg, max_len)
    jspec = JD.cache_view_specs(jcfg, max_len)

    def tcache():
        return jax.tree.map(lambda t: t.clone(), tc)

    pos = np.full((3,), 20, np.int32)
    tok = rng.integers(2, jcfg.vocab, size=(3, 1)).astype(np.int32)
    jlog, jc1 = JD.decode_step(jp, jcfg, jc, jnp.asarray(tok),
                               jnp.asarray(pos))
    tlog, tc1 = TD.decode_step(tp, tcfg, tcache(), torch.from_numpy(tok),
                               torch.from_numpy(pos))
    np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog),
                               rtol=LOGIT_TOL, atol=LOGIT_TOL)
    _caches_close(jc1, tc1, spec)
    chunk = rng.integers(2, jcfg.vocab, size=(3, 6)).astype(np.int32)
    n = np.array([6, 3, 0], np.int32)
    args = (jnp.asarray(chunk), jnp.asarray(pos), jnp.asarray(n))
    targs = (torch.from_numpy(chunk), torch.from_numpy(pos),
             torch.from_numpy(n))
    for kernel in ("blocked", "dense"):
        jlog, jc2 = JD.prefill_chunk_step(jp, jcfg, jspec, jc, *args,
                                          chunk_kernel=kernel)
        tlog, tc2 = TD.prefill_chunk_step(tp, tcfg, spec, tcache(), *targs,
                                          chunk_kernel=kernel)
        live = n > 0
        np.testing.assert_allclose(tlog.numpy()[live],
                                   np.asarray(jlog)[live], rtol=LOGIT_TOL,
                                   atol=LOGIT_TOL, err_msg=kernel)
        _caches_close(jc2, tc2, spec)
    jlog, jc3 = JD.chunk_decode_step(jp, jcfg, jspec, jc, *args)
    tlog, tc3 = TD.chunk_decode_step(tp, tcfg, spec, tcache(), *targs)
    np.testing.assert_allclose(tlog.numpy()[live], np.asarray(jlog)[live],
                               rtol=LOGIT_TOL, atol=LOGIT_TOL)
    _caches_close(jc3, tc3, spec)
