"""The port's 8-bit AdamW (``optim/quantized.py``) against the JAX
package's on the CPU: the update on reduced llama3-8b and mamba2-780m
trees in float32 and bf16 for 10 steps of seeded gradients, a copy of
``test_substrates.py``'s ``test_adamw8bit_tracks_fp32``, the train step
with ``opt_impl="adamw8bit"`` for 3 steps, and the 8-bit state through
the checkpoint manager in both directions.

Tolerances.  The update is held to JAX's ``adamw8bit_update`` run op by
op (each operation compiled alone, the float32 operations the port also
runs): row scales within 1e-6 relative, float32 parameters within 1e-6,
bf16 parameters within one bf16 unit (rtol 2^-7), and every int8 of ``m``
and uint8 of ``sqrt(v)`` equal but where a tie flips a unit: at most one
entry in 10^4 may differ, by one (10 steps: 1 flip of llama3-8b's
270,976 float32-path entries, up to 5 a step in bf16).  Jitted, XLA fuses
the update and contracts its multiply-adds, which moves more ties (up to
21 of the 270,976 after 10 steps).  The seeded gradients have a global norm of 0.5, under the clip
norm, so the clip scale is exactly 1 in both packages.  The train step
(jitted JAX, 3 steps): losses within 1e-5; parameters within 1e-4 (as
``test_torch_train.py`` holds the float32 step) but for at most one entry
in 10^4 — those whose quantized moment flipped a unit — which stay within
two learning rates (2e-3)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint.manager import CheckpointManager as JCkpt
from repro.configs import REGISTRY, reduced_config
from repro.launch import steps as JS
from repro.optim.adamw import AdamWConfig as JAdamW
from repro.optim.quantized import adamw8bit_update as j_adamw8
from repro.optim.quantized import init_opt_state_8bit as j_init_opt8
from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.configs import REGISTRY as T_REGISTRY
from repro_torch.configs import reduced_config as t_reduced
from repro_torch.launch import steps as TS
from repro_torch.models.params import from_reference, init_params, tree_map
from repro_torch.optim.adamw import AdamWConfig
from repro_torch.optim.adamw import adamw_update, init_opt_state
from repro_torch.optim.quantized import (adamw8bit_update,
                                         init_opt_state_8bit,
                                         opt_state_8bit_from_reference)

ARCHS = ["llama3-8b", "mamba2-780m"]
OPT = dict(peak_lr=1e-3, warmup_steps=2, total_steps=10)


def port_params(arch, dtype=torch.float32, seed=5):
    cfg = t_reduced(T_REGISTRY[arch])
    p = init_params(cfg, torch.Generator().manual_seed(seed), device="cpu")
    return tree_map(lambda t: t.to(dtype), p)


def to_np(tree):
    """Port tree -> numpy copies (bf16 through JAX's type).  A copy: JAX
    may alias a host buffer, and the port updates its tensors in place
    while a JAX step may still be reading them."""
    def one(t):
        if t.dtype == torch.bfloat16:
            return np.asarray(jnp.asarray(t.float().numpy(), jnp.bfloat16))
        return t.numpy().copy()
    return tree_map(one, tree)


def seeded_grads(params, rng, norm=0.5):
    """Gaussian gradients shaped like ``params`` (numpy, float32), scaled
    to a global norm of ``norm``."""
    g = tree_map(lambda p: rng.standard_normal(tuple(p.shape)).astype(
        np.float32), params)
    total = np.sqrt(sum(float((x.astype(np.float64) ** 2).sum())
                        for x in jax.tree.leaves(g)))
    return tree_map(lambda x: (x * (norm / total)).astype(np.float32), g)


MAX_FLIPS = 1e-4      # share of quantized entries a tie may flip


def flat(tree, prefix=()):
    """{path: leaf} of a nested dict, paths in sorted order."""
    if isinstance(tree, dict):
        out = {}
        for k in sorted(tree):
            out.update(flat(tree[k], prefix + (k,)))
        return out
    return {prefix: tree}


class Rows:
    """Every row of a tree's leaves (a row is the last axis, as the 8-bit
    state's scales cut them) as one (rows, width) matrix, each row
    zero-padded to the widest.  A zero entry changes no row maximum and
    stays zero through the update, so JAX's update on the matrix is its
    update on the tree, entry for entry, with one shape to compile op by
    op."""

    def __init__(self, tree):
        self.shapes = {k: tuple(v.shape) for k, v in flat(tree).items()}
        self.width = max(s[-1] for s in self.shapes.values())

    def group(self, tree):
        parts = []
        for k, v in flat(tree).items():
            r = np.asarray(v).reshape(-1, self.shapes[k][-1])
            parts.append(np.pad(r, ((0, 0), (0, self.width - r.shape[1]))))
        return {"rows": np.concatenate(parts)}

    def ungroup(self, rows, scale=False):
        """{path: leaf} back from ``rows``; ``scale``: the (rows, 1)
        scales, shaped leaf.shape[:-1] + (1,)."""
        out, at = {}, 0
        m = np.asarray(rows["rows"])
        for k, shape in self.shapes.items():
            n = int(np.prod(shape[:-1]))
            part = m[at:at + n, :1 if scale else shape[-1]]
            at += n
            out[k] = part.reshape(shape[:-1] + (part.shape[1],))
        return out


def assert_state_close(rows, jstate, tstate, jparams, tparams, bf16):
    flips = total = 0
    for k in ("m", "v"):
        jq = rows.ungroup({g: v["q"] for g, v in jstate[k].items()})
        js = rows.ungroup({g: v["scale"] for g, v in jstate[k].items()},
                          scale=True)
        for path, t in flat_q(tstate[k]).items():
            jarr, tarr = jq[path], t["q"].numpy()
            assert str(jarr.dtype) == str(tarr.dtype)
            d = np.abs(jarr.astype(np.int32) - tarr.astype(np.int32))
            assert d.max() <= 1
            flips, total = flips + int(d.sum()), total + d.size
            np.testing.assert_allclose(t["scale"].numpy(), js[path],
                                       rtol=1e-6)
    assert flips <= MAX_FLIPS * total, (flips, total)
    assert int(tstate["count"]) == int(jstate["count"])
    jp = rows.ungroup(jparams)
    for path, t in flat(tparams).items():
        a, b = np.asarray(jp[path], np.float32), t.float().numpy()
        if bf16:
            np.testing.assert_allclose(b, a, rtol=2 ** -7, atol=1e-6)
        else:
            np.testing.assert_allclose(b, a, rtol=0, atol=1e-6)


def flat_q(tree, prefix=()):
    """{path: {"q", "scale"}} of an 8-bit moment tree."""
    if isinstance(tree, dict) and set(tree) == {"q", "scale"}:
        return {prefix: tree}
    out = {}
    for k in sorted(tree):
        out.update(flat_q(tree[k], prefix + (k,)))
    return out


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("arch", ARCHS)
def test_adamw8bit_update_matches_jax(arch, dtype):
    """10 steps of seeded gradients through both updates from the same
    weights: moments, scales, count and parameters after every step (the
    JAX update on the trees' rows, ``Rows``)."""
    tp = port_params(arch, dtype)
    rows = Rows(tp)
    jp = {g: jnp.asarray(v) for g, v in rows.group(to_np(tp)).items()}
    ts, js = init_opt_state_8bit(tp), j_init_opt8(jp)
    cfg = JAdamW(**OPT)
    rng = np.random.default_rng(11)
    for _ in range(10):
        g = seeded_grads(tp, rng)
        jg = {k: jnp.asarray(v, jp[k].dtype)
              for k, v in rows.group(g).items()}
        tg = tree_map(lambda x: torch.from_numpy(x).to(dtype), g)
        jp, js, jm = j_adamw8(jg, js, jp, cfg)            # op by op
        tp, ts, tm = adamw8bit_update(tg, ts, tp, AdamWConfig(**OPT))
        np.testing.assert_allclose(float(tm["grad_norm"]),
                                   float(jm["grad_norm"]), rtol=1e-5)
        assert_state_close(rows, js, ts, jp, tp,
                           bf16=dtype == torch.bfloat16)


def test_adamw8bit_tracks_fp32():
    """A copy of ``test_substrates.py``'s test on the port: the 8-bit
    trajectory stays close to float32 AdamW on a least-squares problem."""
    g = torch.Generator().manual_seed(5)
    w_true = torch.randn(16, 8, generator=g)
    x = torch.randn(64, 16, generator=g)
    y = x @ w_true
    w0 = torch.randn(16, 8, generator=g) * 0.1
    loss = lambda w: ((x @ w - y) ** 2).mean()

    def grad(w):
        w = w.detach().requires_grad_(True)
        loss(w).backward()
        return {"w": w.grad}

    p32, p8 = {"w": w0.clone()}, {"w": w0.clone()}
    s32, s8 = init_opt_state(p32), init_opt_state_8bit(p8)
    cfg = AdamWConfig(peak_lr=0.05, warmup_steps=5, total_steps=200,
                      weight_decay=0.0)
    for _ in range(60):
        adamw_update(grad(p32["w"]), s32, p32, cfg)
        adamw8bit_update(grad(p8["w"]), s8, p8, cfg)
    l32, l8 = float(loss(p32["w"])), float(loss(p8["w"]))
    assert l8 < 0.15 * float(loss(w0))               # converges
    assert l8 < max(4.0 * l32, 0.02)                 # close to fp32 quality
    assert s8["m"]["w"]["q"].dtype == torch.int8
    assert s8["v"]["w"]["q"].dtype == torch.uint8


def test_pieces_never_cut_a_row(monkeypatch):
    """With a piece far smaller than a leaf, the update runs piece by
    piece (1-D leaves whole) and gives the same state as one piece."""
    from repro_torch.optim import adamw
    tp = port_params("llama3-8b")
    rng = np.random.default_rng(3)
    grads = [tree_map(torch.from_numpy, seeded_grads(tp, rng))
             for _ in range(2)]
    out = []
    for piece in (adamw.PIECE, 256):
        monkeypatch.setattr(adamw, "PIECE", piece)
        p = tree_map(torch.clone, tp)
        s = init_opt_state_8bit(p)
        for g in grads:
            adamw8bit_update(g, s, p, AdamWConfig(**OPT))
        out.append((p, s))
    for a, b in zip(jax.tree.leaves(out[0]), jax.tree.leaves(out[1])):
        assert torch.equal(a, b)


def test_train_step_8bit_matches_jax():
    """``make_train_step(opt_impl="adamw8bit")`` against JAX's for 3
    steps from the port's seeded weights in both packages (reduced
    llama3-8b; the update itself is held on both trees above)."""
    arch = "llama3-8b"
    jcfg = reduced_config(REGISTRY[arch])
    tcfg = t_reduced(T_REGISTRY[arch])
    tp = port_params(arch)
    jp = jax.tree.map(jnp.asarray, to_np(tp))
    rng = np.random.default_rng(7)
    B, S = 2, 64
    jstep = jax.jit(JS.make_train_step(jcfg, JAdamW(**OPT),
                                       opt_impl="adamw8bit"))
    tstep = TS.make_train_step(tcfg, AdamWConfig(**OPT),
                               opt_impl="adamw8bit")
    js, ts = j_init_opt8(jp), init_opt_state_8bit(tp)
    for _ in range(3):
        blk = rng.integers(2, jcfg.vocab, size=(B, S + 1)).astype(np.int32)
        batch = {"tokens": blk[:, :-1], "targets": blk[:, 1:],
                 "mask": np.ones((B, S), np.float32)}
        jp, js, jm = jstep(jp, js, batch)
        tp, ts, tm = tstep(tp, ts, {k: torch.from_numpy(v)
                                    for k, v in batch.items()})
        np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]),
                                   rtol=1e-5)
    assert ts["m"]["embed"]["q"].dtype == torch.int8
    off = total = 0
    for a, b in zip(jax.tree.leaves(jp), jax.tree.leaves(tp)):
        d = np.abs(b.numpy() - np.asarray(a))
        assert d.max() <= 2 * OPT["peak_lr"]
        off, total = off + int((d > 1e-4).sum()), total + d.size
    assert off <= MAX_FLIPS * total, (off, total)


_update8 = jax.jit(lambda g, s, p: j_adamw8(g, s, p, JAdamW(**OPT)))


def eight_bit_state(seed):
    """A JAX 8-bit state after two updates of a small tree."""
    rng = np.random.default_rng(seed)
    p = {"embed": jnp.asarray(rng.standard_normal((16, 8)), jnp.float32),
         "layers": {"w": jnp.asarray(rng.standard_normal((2, 8, 4)),
                                     jnp.bfloat16)}}
    s = j_init_opt8(p)
    for _ in range(2):
        g = jax.tree.map(lambda x: jnp.asarray(
            rng.standard_normal(x.shape) * 0.1, x.dtype), p)
        p, s, _ = _update8(g, s, p)
    return {"params": p, "opt": s}


def test_8bit_checkpoint_from_jax_restores_in_the_port(tmp_path):
    jtree = eight_bit_state(0)
    JCkpt(str(tmp_path)).save(3, jtree)
    other = jax.tree.map(np.asarray, eight_bit_state(1))
    like = {"params": from_reference(other["params"], "cpu"),
            "opt": opt_state_8bit_from_reference(other["opt"], "cpu")}
    like = tree_map(torch.zeros_like, like)
    restored, meta = CheckpointManager(str(tmp_path)).restore(like)
    assert meta["step"] == 3
    assert restored["opt"]["m"]["embed"]["q"].dtype == torch.int8
    assert restored["opt"]["v"]["layers"]["w"]["q"].dtype == torch.uint8
    for a, b in zip(jax.tree.leaves(jtree), jax.tree.leaves(restored)):
        np.testing.assert_array_equal(b.float().numpy(),
                                      np.asarray(a, np.float32))


def test_8bit_checkpoint_from_the_port_restores_in_jax(tmp_path):
    """The port's 8-bit state, converted from JAX's and written by the
    port's manager, restores in JAX with the same bytes."""
    jtree = eight_bit_state(2)
    ttree = {"params": from_reference(jax.tree.map(np.asarray,
                                                   jtree["params"]), "cpu"),
             "opt": opt_state_8bit_from_reference(
                 jax.tree.map(np.asarray, jtree["opt"]), "cpu")}
    CheckpointManager(str(tmp_path)).save(4, ttree)
    like = jax.tree.map(jnp.zeros_like, jtree)
    restored, meta = JCkpt(str(tmp_path)).restore(like)
    assert meta["step"] == 4
    for a, b in zip(jax.tree.leaves(restored), jax.tree.leaves(jtree)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(np.asarray(a, np.float32),
                                      np.asarray(b, np.float32))


def test_float32_and_8bit_states_differ_in_bytes():
    """6 bytes of training state a bf16 parameter instead of 12: the
    moments of the 8-bit state are a quarter of the float32 ones' (plus a
    float32 scale a row)."""
    tp = port_params("llama3-8b", torch.bfloat16)
    nbytes = lambda tree: sum(t.numel() * t.element_size()
                              for t in jax.tree.leaves(tree))
    n = sum(t.numel() for t in jax.tree.leaves(tp))
    s32, s8 = init_opt_state(tp), init_opt_state_8bit(tp)
    rows = sum(t.numel() // t.shape[-1] for t in jax.tree.leaves(tp))
    assert nbytes({"m": s32["m"], "v": s32["v"]}) == 8 * n
    assert nbytes({"m": s8["m"], "v": s8["v"]}) == 2 * n + 8 * rows
