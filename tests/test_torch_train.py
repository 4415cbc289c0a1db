"""Parity of the port's training path (``models.transformer`` forward and
loss, ``launch.steps`` train/eval steps, ``optim.adamw``) with the JAX
package, on reduced llama3.2-3b, reduced llama3-8b, reduced mamba2-780m
and reduced recurrentgemma-9b in float32 on the CPU, with weights carried
across by ``from_reference``.

The loss agrees to 1e-5 on the JAX package's own weights.  Every gradient
leaf, and the parameters, moments, ``count``, ``grad_norm`` and ``lr``
after one and three steps, agree to 1e-4, against the JAX package with its
Pallas kernels (flash attention, the SSD scan or the RG-LRU scan,
interpret mode) and with its jnp routes.

The gradient and optimizer-step tests draw their weights with the port's
``init_params`` (a seeded ``torch.Generator``, std 1/sqrt(fan-in)) and
hand the same numbers to both packages.  The JAX ``init_params`` draws
every stacked projection with std ``n_layers ** -0.5`` (ROADMAP C), 0.71
at 2 layers: the softmax saturates and the embedding gradient grows to
about 11, where float32 summation order alone moves it by more than 1e-4 —
on those weights the JAX package's own Pallas and jnp routes differ by
6.3e-4 on reduced llama3-8b's embedding gradient.  AdamW then divides
each near-zero gradient entry by its own magnitude, so such entries step
by up to the learning rate either way and two runs drift apart within
three steps on equally right math."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import REGISTRY, reduced_config
from repro.launch import steps as JS
from repro.models import transformer as JT
from repro.models.params import init_params as j_init_params
from repro.optim.adamw import AdamWConfig as JAdamW
from repro.optim.adamw import init_opt_state as j_init_opt
from repro_torch.configs import REGISTRY as T_REGISTRY
from repro_torch.configs import reduced_config as t_reduced
from repro_torch.launch import steps as TS
from repro_torch.models import transformer as TT
from repro_torch.models.params import from_reference
from repro_torch.models.params import init_params as t_init_params
from repro_torch.optim.adamw import AdamWConfig as TAdamW
from repro_torch.optim.adamw import init_opt_state as t_init_opt
from repro_torch.optim.adamw import opt_state_from_reference

ARCHS = ["llama3.2-3b", "llama3-8b", "mamba2-780m", "recurrentgemma-9b"]
OPT = dict(peak_lr=1e-3, warmup_steps=2, total_steps=10)
B, S = 2, 64


def configs(arch, **kw):
    return (dataclasses.replace(reduced_config(REGISTRY[arch]), **kw),
            dataclasses.replace(t_reduced(T_REGISTRY[arch]), **kw))


@pytest.fixture(scope="module", params=ARCHS)
def setup(request):
    jcfg, tcfg = configs(request.param)
    jp = j_init_params(jcfg, jax.random.PRNGKey(3))
    rng = np.random.default_rng(7)
    block = rng.integers(2, jcfg.vocab, size=(B, S + 1)).astype(np.int32)
    mask = (rng.random((B, S)) < 0.9).astype(np.float32)
    batch = {"tokens": block[:, :-1], "targets": block[:, 1:], "mask": mask}
    return jcfg, tcfg, jp, batch


@pytest.fixture(scope="module")
def stepped(setup):
    """Three steps of ``make_train_step`` in both packages from the port's
    weights and a fresh optimizer state: each step's metrics, and
    (params, opt state) after steps 1 and 3 (the port's copied: its step
    updates in place)."""
    jcfg, tcfg, _, batch = setup
    jp = port_drawn(tcfg)
    jstep = jax.jit(JS.make_train_step(jcfg, JAdamW(**OPT)))
    tstep = TS.make_train_step(tcfg, TAdamW(**OPT))
    jparams, jopt = jp, j_init_opt(jp)
    tp = tparams(jp)
    topt = t_init_opt(tp)
    tb = tbatch(batch)
    out = {"jax_metrics": [], "port_metrics": []}
    for n in range(1, 4):
        jparams, jopt, jm = jstep(jparams, jopt, batch)
        tp, topt, tm = tstep(tp, topt, tb)
        out["jax_metrics"].append(jm)
        out["port_metrics"].append(tm)
        if n in (1, 3):
            out[n] = (jparams, jopt, jax.tree.map(
                lambda t: t.clone(), (tp, topt)))
    return out


def tbatch(batch):
    return {k: torch.from_numpy(np.array(v)) for k, v in batch.items()}


def tparams(jp):
    return from_reference(jax.tree.map(np.asarray, jp), device="cpu")


def port_drawn(tcfg):
    """Weights from the port's seeded ``init_params``, as a JAX tree."""
    gen = torch.Generator().manual_seed(5)
    tp = t_init_params(tcfg, gen, device="cpu")
    return jax.tree.map(lambda t: jnp.asarray(t.numpy()), tp)


def paths(tree, prefix=()):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from paths(tree[k], prefix + (k,))
    else:
        yield prefix, tree


def tree_close(jtree, ttree, tol, what):
    want = dict(paths(jtree))
    got = dict(paths(ttree))
    assert want.keys() == got.keys(), what
    for path in want:
        np.testing.assert_allclose(
            got[path].detach().float().numpy(), np.asarray(want[path],
                                                           np.float32),
            rtol=tol, atol=tol, err_msg=f"{what} {'/'.join(path)}")


def test_loss_matches(setup):
    jcfg, tcfg, jp, batch = setup
    jl, jparts = jax.jit(lambda p: JT.loss_fn(p, jcfg, batch))(jp)
    tl, tparts = TT.loss_fn(tparams(jp), tcfg, tbatch(batch))
    np.testing.assert_allclose(float(tl), float(jl), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(float(tparts["ce"]), float(jparts["ce"]),
                               rtol=1e-5, atol=1e-5)
    assert float(tparts["aux"]) == float(jparts["aux"]) == 0.0


@pytest.mark.parametrize("use_pallas", [True, False],
                         ids=["pallas_interpret", "jnp"])
def test_every_gradient_leaf(setup, use_pallas):
    """``steps.value_and_grad`` against ``jax.value_and_grad(loss_fn)``
    (jitted): with ``use_pallas`` the JAX side runs its Pallas kernels'
    custom VJP (interpret mode), without it ``blocked_attention`` or the
    jnp ``ssd_chunked``."""
    jcfg, tcfg, _, batch = setup
    jp = port_drawn(tcfg)
    jcfg = dataclasses.replace(jcfg, use_pallas=use_pallas)
    (jl, _), jg = jax.jit(jax.value_and_grad(
        lambda p: JT.loss_fn(p, jcfg, batch), has_aux=True))(jp)
    tl, _, tg = TS.value_and_grad(tcfg, tparams(jp), tbatch(batch))
    np.testing.assert_allclose(float(tl), float(jl), rtol=1e-5, atol=1e-5)
    tree_close(jg, tg, 1e-4, "grad")


def test_chunked_loss_over_several_chunks(setup, monkeypatch):
    """Both packages' loss chunk set to 16 tokens: 4 chunks of the
    64-token sequence, value and gradients."""
    jcfg, tcfg, _, batch = setup
    jp = port_drawn(tcfg)
    monkeypatch.setattr(JT, "LOSS_CHUNK", 16)
    monkeypatch.setattr(TT, "LOSS_CHUNK", 16)
    (jl, _), jg = jax.jit(jax.value_and_grad(
        lambda p: JT.loss_fn(p, jcfg, batch), has_aux=True))(jp)
    tl, _, tg = TS.value_and_grad(tcfg, tparams(jp), tbatch(batch))
    np.testing.assert_allclose(float(tl), float(jl), rtol=1e-5, atol=1e-5)
    tree_close(jg, tg, 1e-4, "grad")


@pytest.mark.parametrize("n_steps", [1, 3])
def test_train_steps_match(stepped, n_steps):
    """``make_train_step`` run n times from the same weights and a fresh
    optimizer state (``stepped``): params, m, v, count and the metrics of
    each step."""
    for jm, tm in zip(stepped["jax_metrics"][:n_steps],
                      stepped["port_metrics"][:n_steps]):
        for k in ("loss", "ce", "aux", "grad_norm", "lr"):
            np.testing.assert_allclose(float(tm[k]), float(jm[k]),
                                       rtol=1e-4, atol=1e-5, err_msg=k)
    jparams, jopt, (tp, topt) = stepped[n_steps]
    tree_close(jparams, tp, 1e-4, "params")
    tree_close(jopt["m"], topt["m"], 1e-4, "m")
    tree_close(jopt["v"], topt["v"], 1e-4, "v")
    assert int(topt["count"]) == int(jopt["count"]) == n_steps
    assert topt["count"].dtype == torch.int32


def test_microbatches(setup):
    """``microbatches=2`` against 1 in the port (the mean of the two
    halves' gradients is the full batch's: every microbatch has the same
    mask count here), and against the JAX package's ``microbatches=2``."""
    jcfg, tcfg, _, batch = setup
    jp = port_drawn(tcfg)
    batch = dict(batch, mask=np.ones((B, S), np.float32))
    one = TS.make_train_step(tcfg, TAdamW(**OPT))
    two = TS.make_train_step(tcfg, TAdamW(**OPT), microbatches=2)
    p1, o1, m1 = one(tparams(jp), t_init_opt(tparams(jp)), tbatch(batch))
    p2, o2, m2 = two(tparams(jp), t_init_opt(tparams(jp)), tbatch(batch))
    tree_close(jax.tree.map(lambda t: t.numpy(), p1), p2, 1e-5, "params")
    np.testing.assert_allclose(float(m2["loss"]), float(m1["loss"]),
                               rtol=1e-5)
    jstep = jax.jit(JS.make_train_step(jcfg, JAdamW(**OPT), microbatches=2))
    jparams, jopt, jm = jstep(jp, j_init_opt(jp), batch)
    tree_close(jparams, p2, 1e-4, "params vs jax")
    tree_close(jopt["v"], o2["v"], 1e-4, "v vs jax")
    np.testing.assert_allclose(float(m2["grad_norm"]), float(jm["grad_norm"]),
                               rtol=1e-4)


def test_eval_step_and_opt_state_bridge(setup, stepped):
    """``make_eval_step`` gives the loss without building a graph; a JAX
    optimizer state after one step (``stepped``) crosses by
    ``opt_state_from_reference``."""
    jcfg, tcfg, jp, batch = setup
    tp = tparams(jp)
    out = TS.make_eval_step(tcfg)(tp, tbatch(batch))
    want = jax.jit(JS.make_eval_step(jcfg))(jp, batch)
    for k in ("loss", "ce", "aux"):
        np.testing.assert_allclose(float(out[k]), float(want[k]), rtol=1e-5,
                                   atol=1e-5)
    assert not out["loss"].requires_grad
    _, jopt, _ = stepped[1]
    topt = opt_state_from_reference(jax.tree.map(np.asarray, jopt), "cpu")
    tree_close(jopt["m"], topt["m"], 0.0, "m")
    assert int(topt["count"]) == 1 and topt["count"].dtype == torch.int32


def test_remat_recomputes_the_same_gradients(setup):
    """``cfg.remat`` checkpoints each layer (each group of a hybrid
    model): same loss and gradients (the forward kernel route runs twice
    a layer; plain route here)."""
    _, tcfg, jp, batch = setup
    tl, _, tg = TS.value_and_grad(tcfg, tparams(jp), tbatch(batch))
    rcfg = dataclasses.replace(tcfg, remat="full")
    rl, _, rg = TS.value_and_grad(rcfg, tparams(jp), tbatch(batch))
    assert float(rl) == float(tl)
    tree_close(jax.tree.map(lambda t: t.numpy(), tg), rg, 1e-6, "grad")


@pytest.mark.parametrize("what", ["adamw8bit", "ef_transform"])
def test_unported_step_options_raise(what):
    """The two step options that raised before the port had them now run:
    ``opt_impl="adamw8bit"`` steps int8 / uint8 moments (an unknown
    ``opt_impl`` still raises), ``ef_transform`` makes the step take and
    return the error-feedback state (held against JAX in
    ``test_torch_quantized.py`` and ``test_torch_grad_compress.py``)."""
    from repro_torch.compression import (init_compression,
                                         int8_compress_transform)
    from repro_torch.optim.quantized import init_opt_state_8bit
    tcfg = t_reduced(T_REGISTRY["llama3.2-3b"])
    tp = t_init_params(tcfg, torch.Generator().manual_seed(1), device="cpu")
    rng = np.random.default_rng(2)
    block = rng.integers(2, tcfg.vocab, size=(B, S + 1)).astype(np.int32)
    batch = tbatch({"tokens": block[:, :-1], "targets": block[:, 1:],
                    "mask": np.ones((B, S), np.float32)})
    if what == "adamw8bit":
        with pytest.raises(ValueError, match="opt_impl"):
            TS.make_train_step(tcfg, TAdamW(), opt_impl="adamw4bit")
        step = TS.make_train_step(tcfg, TAdamW(), opt_impl="adamw8bit")
        _, opt, m = step(tp, init_opt_state_8bit(tp), batch)
        assert opt["m"]["embed"]["q"].dtype == torch.int8
        assert opt["v"]["embed"]["q"].dtype == torch.uint8
    else:
        step = TS.make_train_step(tcfg, TAdamW(),
                                  ef_transform=int8_compress_transform)
        ef = init_compression(tp)["ef"]
        _, _, m, ef = step(tp, t_init_opt(tp), batch, ef)
        assert float(ef["embed"].abs().max()) > 0
    assert np.isfinite(float(m["loss"]))
