"""The VLM family (qwen2-vl-2b) in the port against the JAX package, on
the CPU: M-RoPE, the forward with its patch embeddings ahead of the text,
the loss and every gradient leaf, train steps (microbatched too, which
splits M-RoPE's ids on their batch axis), the ``Trainer`` through
``ShardedLoader``, whole-prompt prefill with the vision extras, and the
serving steps.

Reduced qwen2-vl-2b in float32 (M-RoPE sections (4, 2, 2) at head_dim
16).  The ids' temporal, height and width components differ over the
vision span, so M-RoPE is not RoPE there.  Tolerances: logits 1e-4,
cache leaves 2e-4 (``test_torch_prefill.py``); loss 1e-5, gradients,
parameters and moments 1e-4 on the port's seeded weights
(``test_torch_train.py``)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import REGISTRY, reduced_config
from repro.launch import steps as JS
from repro.models import decode as JD
from repro.models import layers as JL
from repro.models import transformer as JT
from repro.models.params import init_params as j_init_params
from repro.optim.adamw import AdamWConfig as JAdamW
from repro.optim.adamw import init_opt_state as j_init_opt
from repro_torch.configs import REGISTRY as T_REGISTRY
from repro_torch.configs import reduced_config as t_reduced
from repro_torch.data.pipeline import make_batch
from repro_torch.launch import steps as TS
from repro_torch.models import decode as TD
from repro_torch.models import layers as TL
from repro_torch.models import transformer as TT
from repro_torch.models.params import from_reference
from repro_torch.models.params import init_params as t_init_params
from repro_torch.optim.adamw import AdamWConfig as TAdamW
from repro_torch.optim.adamw import init_opt_state as t_init_opt
from test_torch_prefill import jitted

ARCH = "qwen2-vl-2b"
JCFG, TCFG = reduced_config(REGISTRY[ARCH]), t_reduced(T_REGISTRY[ARCH])
OPT = dict(peak_lr=1e-3, warmup_steps=2, total_steps=10)
LOGIT_TOL, CACHE_TOL = 1e-4, 2e-4
B, S = 2, 64                    # 16 vision positions, 48 text tokens


def vision_ids(B, S, sv):
    """M-RoPE ids (3, B, S): over the first ``sv`` positions (a 4-wide
    patch grid) the time, row and column of each patch; after it the
    text's positions, equal in all three components, from the grid's
    largest id on."""
    t = np.zeros(sv, np.int64)
    h, w = np.arange(sv) // 4, np.arange(sv) % 4
    text = np.arange(S - sv) + max(h.max(), w.max()) + 1
    ids = np.stack([np.concatenate([c, text]) for c in (t, h, w)])
    return np.broadcast_to(ids[:, None], (3, B, S)).astype(np.int32).copy()


def to_j(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def to_t(batch):
    return {k: torch.from_numpy(np.array(v)) for k, v in batch.items()}


def port_drawn(seed=5):
    """The port's seeded weights as (torch tree, JAX tree of copies: the
    port's train step updates its tree in place)."""
    tp = t_init_params(TCFG, torch.Generator().manual_seed(seed),
                       device="cpu")
    return tp, jax.tree.map(lambda t: jnp.array(t.numpy()), tp)


def clone(tree):
    return jax.tree.map(lambda t: t.clone(), tree)


def paths(tree, prefix=()):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from paths(tree[k], prefix + (k,))
    else:
        yield prefix, tree


def tree_close(jtree, ttree, tol, what):
    want, got = dict(paths(jtree)), dict(paths(ttree))
    assert want.keys() == got.keys(), what
    for path in want:
        np.testing.assert_allclose(
            got[path].detach().float().numpy(),
            np.asarray(want[path], np.float32), rtol=tol, atol=tol,
            err_msg=f"{what} {'/'.join(path)}")


@pytest.fixture(scope="module")
def model():
    """The JAX package's weights in both packages, and a training batch
    from ``make_batch`` with distinct t/h/w ids over its vision span."""
    jp = j_init_params(JCFG, jax.random.PRNGKey(0))
    tp = from_reference(jax.tree.map(np.asarray, jp), device="cpu")
    rng = np.random.default_rng(7)
    block = rng.integers(2, JCFG.vocab, size=(B, S + 1)).astype(np.int32)
    batch = make_batch(TCFG, block)
    sv = batch["vision_embeds"].shape[1]
    batch["position_ids"] = vision_ids(B, S, sv)
    batch["mask"] = (rng.random((B, S)) < 0.9).astype(np.float32)
    return jp, tp, batch


@pytest.mark.parametrize("sections,head_dim", [((4, 2, 2), 16),
                                               ((16, 24, 24), 128)])
def test_mrope_tables(sections, head_dim):
    """``mrope_tables`` equals the JAX package's on distinct t/h/w ids
    (component c fills ``sections[c]`` frequency slots), and with three
    equal components it is ``rope_tables`` exactly."""
    pid = vision_ids(2, 40, 16)
    jc, js = JL.mrope_tables(jnp.asarray(pid), head_dim, 1e6, sections)
    tc, ts = TL.mrope_tables(torch.from_numpy(pid), head_dim, 1e6, sections)
    assert tuple(tc.shape) == (2, 40, head_dim // 2)
    assert tc.dtype == torch.float32
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), rtol=1e-6,
                               atol=1e-6)
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), rtol=1e-6,
                               atol=1e-6)
    pos = torch.arange(40)[None].expand(2, 40)
    ec, es = TL.mrope_tables(pos[None].expand(3, 2, 40), head_dim, 1e6,
                             sections)
    rc, rs = TL.rope_tables(pos, head_dim, 1e6)
    assert torch.equal(ec, rc) and torch.equal(es, rs)
    with pytest.raises(ValueError, match="do not sum"):
        TL.mrope_tables(torch.from_numpy(pid), head_dim + 2, 1e6, sections)


def test_forward_with_vision_embeds(model):
    """``forward`` with the patch embeddings ahead of the text and M-RoPE
    from distinct ids gives the JAX package's hidden states; the ids move
    them (M-RoPE is not RoPE here), and without ``position_ids`` the
    forward raises ``KeyError``, as the JAX forward does."""
    jp, tp, batch = model
    ex = {k: batch[k] for k in ("vision_embeds", "position_ids")}
    jx, _ = JT.forward(jp, JCFG, jnp.asarray(batch["tokens"]), to_j(ex))
    tx, aux = TT.forward(tp, TCFG, torch.from_numpy(batch["tokens"]),
                         to_t(ex))
    assert tuple(tx.shape) == (B, S, TCFG.d_model) and float(aux) == 0.0
    np.testing.assert_allclose(tx.numpy(), np.asarray(jx), rtol=1e-4,
                               atol=1e-4)
    text = dict(ex, position_ids=np.broadcast_to(
        np.arange(S, dtype=np.int32), (3, B, S)).copy())
    tx2, _ = TT.forward(tp, TCFG, torch.from_numpy(batch["tokens"]),
                        to_t(text))
    assert float((tx2 - tx).abs().max()) > 1e-3
    with pytest.raises(KeyError):
        TT.forward(tp, TCFG, torch.from_numpy(batch["tokens"]),
                   to_t({"vision_embeds": ex["vision_embeds"]}))


def test_loss_and_every_gradient_leaf(model):
    """``loss_fn`` on the JAX weights, then ``steps.value_and_grad``
    against ``jax.value_and_grad(loss_fn)`` on the port's weights, leaf
    by leaf (the JAX side's plain ``blocked_attention``)."""
    jp, tp, batch = model
    jl, jparts = JT.loss_fn(jp, JCFG, to_j(batch))
    tl, tparts = TT.loss_fn(tp, TCFG, to_t(batch))
    np.testing.assert_allclose(float(tl), float(jl), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(float(tparts["ce"]), float(jparts["ce"]),
                               rtol=1e-5, atol=1e-5)
    tq, jq = port_drawn()
    (jl, _), jg = jax.jit(jax.value_and_grad(
        lambda p, b: JT.loss_fn(p, JCFG, b), has_aux=True))(jq, to_j(batch))
    tl, _, tg = TS.value_and_grad(TCFG, tq, to_t(batch))
    np.testing.assert_allclose(float(tl), float(jl), rtol=1e-5, atol=1e-5)
    tree_close(jg, tg, 1e-4, "grad")


@pytest.mark.parametrize("microbatches", [2])
def test_train_steps_match(model, microbatches):
    """Two ``make_train_step`` steps in two microbatches (each takes rows
    j, j + 2, ... of every batch tensor, M-RoPE's ids along their second
    axis): parameters, moments and metrics.  ``test_trainer_matches_jax_
    trainer`` runs the single-batch step."""
    _, _, batch = model
    batch = dict(batch, mask=np.ones((B, S), np.float32))
    tp, jp = port_drawn()
    jstep = jax.jit(JS.make_train_step(JCFG, JAdamW(**OPT),
                                       microbatches=microbatches))
    tstep = TS.make_train_step(TCFG, TAdamW(**OPT),
                               microbatches=microbatches)
    jparams, jopt = jp, j_init_opt(jp)
    topt = t_init_opt(tp)
    for _ in range(2):
        jparams, jopt, jm = jstep(jparams, jopt, to_j(batch))
        tp, topt, tm = tstep(tp, topt, to_t(batch))
        for k in ("loss", "ce", "grad_norm", "lr"):
            np.testing.assert_allclose(float(tm[k]), float(jm[k]),
                                       rtol=1e-4, atol=1e-5, err_msg=k)
    tree_close(jparams, tp, 1e-4, "params")
    tree_close(jopt["v"], topt["v"], 1e-4, "v")


def test_trainer_matches_jax_trainer(tmp_path_factory, tmp_path):
    """The ``Trainer``, with no VLM code of its own, trains reduced
    qwen2-vl-2b from ``ShardedLoader`` blocks through ``make_batch`` to
    the JAX Trainer's losses and counters."""
    from test_torch_trainer import _jax_trainer_run, _matches_jax_trainer
    _matches_jax_trainer(ARCH, _jax_trainer_run(
        tmp_path_factory.mktemp("jax_vlm_trainer"), ARCH), tmp_path)


def test_prefill_and_decode_with_vision(model):
    """``make_prefill`` on a batch with vision extras, then 6 greedy
    ``make_generate`` steps (positions broadcast to the three M-RoPE
    components): logits, every cache leaf and the tokens equal the JAX
    package's."""
    jp, tp, batch = model
    max_len = 80
    pre = {k: batch[k] for k in ("tokens", "vision_embeds", "position_ids")}
    jl, jc = jax.jit(JS.make_prefill(JCFG, max_len))(jp, to_j(pre))
    tl, tc = TS.make_prefill(TCFG, max_len)(tp, to_t(pre))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=LOGIT_TOL,
                               atol=LOGIT_TOL)
    spec = TD.cache_view_specs(TCFG, max_len)
    for a, b in zip(jax.tree.leaves(jc), TD.tree_leaves(tc, spec)):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=CACHE_TOL,
                                   atol=CACHE_TOL)
    first = np.asarray(jnp.argmax(jl, -1)).astype(np.int32)[:, None]
    pos = np.full((B,), S, np.int32)
    jt, _, _ = jax.jit(JS.make_generate(JCFG, 6))(
        jp, jc, jnp.asarray(first), jnp.asarray(pos), jax.random.PRNGKey(0))
    tt, _, _ = TS.make_generate(TCFG, 6)(tp, tc, torch.from_numpy(first),
                                         torch.from_numpy(pos))
    np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))


def _warmed(jp, tp, max_len, prompt_len, seed):
    """A text-only prefill of three streams into a ``max_len`` ring that
    the prompt overruns (the ring wraps)."""
    prompt = np.random.default_rng(seed).integers(
        2, JCFG.vocab, size=(3, prompt_len)).astype(np.int32)
    text = {"position_ids": np.broadcast_to(
        np.arange(prompt_len, dtype=np.int32), (3, 3, prompt_len)).copy(),
        "vision_embeds": np.zeros((3, 0, JCFG.d_model), np.float32)}
    _, jc = jitted(JD.prefill, cfg=JCFG, max_len=max_len)(
        jp, tokens=jnp.asarray(prompt), extras=to_j(text))
    _, tc = TD.prefill(tp, TCFG, torch.from_numpy(prompt), to_t(text),
                       max_len=max_len)
    return jc, tc


@pytest.mark.parametrize("ids", ["broadcast", "given"])
def test_chunk_steps(model, ids):
    """``prefill_chunk_step`` (blocked and dense) and
    ``chunk_decode_step`` over a warmed, wrapped ring, with a prefill
    row, a decode row and an idle row: the live rows' logits and every
    cache leaf equal the JAX steps'.  M-RoPE takes the chunk's positions
    (``broadcast``) or ``position_ids`` extras whose components differ
    (``given``, the fused step only: the scan hands its extras to each
    single-token step)."""
    jp, tp, _ = model
    max_len, P = 32, 40
    jc, tc = _warmed(jp, tp, max_len, P, seed=3)
    spec = TD.cache_view_specs(TCFG, max_len)
    jspec = JD.cache_view_specs(JCFG, max_len)
    rng = np.random.default_rng(4)
    chunk = rng.integers(2, JCFG.vocab, size=(3, 6)).astype(np.int32)
    pos = np.array([P, P, P], np.int32)
    n = np.array([6, 1, 0], np.int32)
    extras = None
    if ids == "given":
        q = pos[:, None] + np.arange(6)[None]
        extras = {"position_ids": np.stack([q, q // 2, q % 5])
                  .astype(np.int32)}
    jargs = dict(tokens=jnp.asarray(chunk), pos=jnp.asarray(pos),
                 n_tokens=jnp.asarray(n))
    targs = (torch.from_numpy(chunk), torch.from_numpy(pos),
             torch.from_numpy(n))
    live = n > 0

    def check(jlog, jc2, tlog, tc2, what):
        np.testing.assert_allclose(tlog.numpy()[live],
                                   np.asarray(jlog)[live], rtol=LOGIT_TOL,
                                   atol=LOGIT_TOL, err_msg=what)
        for a, b in zip(jax.tree.leaves(jc2), TD.tree_leaves(tc2, spec)):
            np.testing.assert_allclose(b.numpy(), np.asarray(a),
                                       rtol=CACHE_TOL, atol=CACHE_TOL,
                                       err_msg=what)

    for kernel in ("blocked", "dense"):
        jlog, jc2 = jitted(JD.prefill_chunk_step, cfg=JCFG, spec=jspec,
                           chunk_kernel=kernel)(
            jp, cache=jc, **jargs, extras=extras and to_j(extras))
        tlog, tc2 = TD.prefill_chunk_step(
            tp, TCFG, spec, clone(tc), *targs, extras and to_t(extras),
            chunk_kernel=kernel)
        check(jlog, jc2, tlog, tc2, kernel)
    if ids == "broadcast":
        jlog, jc3 = jitted(JD.chunk_decode_step, cfg=JCFG, spec=jspec)(
            jp, cache=jc, **jargs)
        tlog, tc3 = TD.chunk_decode_step(tp, TCFG, spec, clone(tc), *targs)
        check(jlog, jc3, tlog, tc3, "scan")
