"""The port's serving steps on a mesh against the JAX package's GSPMD ones,
on the CPU: ``make_prefill_spmd`` and ``make_serve_step_spmd`` on 8 gloo
ranks (``torch.distributed``) against the JAX package's ``make_prefill``
and ``make_serve_step`` jitted with the ``param_specs`` / ``batch_specs``
/ ``cache_specs`` shardings (the cache laid out by ``cache_specs`` on the
way in and out) on 8 forced host devices, as ``test_torch_distributed.py``
holds the train step.

One spawn of 8 ranks (``tests/torch_dist_workers.py``) runs every case
while one JAX subprocess runs the references, both from the port's seeded
float32 weights (``from_reference``).  Each case is a prefill of 4
prompts of 8 positions into a cache of 12 (mixtral-8x22b: a window of 8,
so that its ring is full from the prefill on and wraps at every step),
then 6 greedy token steps: at the first, the last quarter of a 12-slot
ring — a rank's slice on a 4-wide "model" axis — has never been written,
and by the fifth the ring wraps.  Cases: reduced llama3-8b on (data 2,
model 4), (pod 2, data 2, model 2) and under FSDP; mixtral-8x22b
(dropless experts on the rank's ``ff`` slice), mamba2-780m,
recurrentgemma-9b, qwen2-vl-2b (4 patch embeddings ahead of the text,
M-RoPE ids that differ by component, in the prefill and every step) and
seamless-m4t-large-v2 (8 source frames: the cross keys' source axis cut
too), each on (data 2, model 4); and mamba2-780m at d_model 48, whose 6
SSD heads the 4-wide axis does not divide (the layer computed whole, its
state's channels still cut by ``cache_specs``).

Tolerances, float32: logits 1e-4 absolute, cache shards 1e-4 absolute
(the two programs sum in other orders — the split-window softmax
combines the ranks' parts, the row-parallel products sum partial
outputs — and the port's differences from JAX stay below 4e-6 here);
greedy tokens equal.  The split-window combine alone against
``decode_attention`` on the whole ring, and a (1, 1) mesh against the
unsharded steps: 1e-6 (the same operations but the softmax's
normalisation, or the SSD's gated norm's mean square, taken as a sum
over the axis and divided)."""
import dataclasses
import os
import pickle
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

from torch_dist_workers import run_ranks
from repro_torch.configs import REGISTRY as T_REGISTRY
from repro_torch.configs import reduced_config as t_reduced
from repro_torch.models.params import init_params, tree_map

SRC = os.path.join(os.path.dirname(__file__), "..", "src")
TIMEOUT = 300
B, S, MAX_LEN, STEPS, SV, FRAMES = 4, 8, 12, 6, 4, 8
LOGIT_TOL = CACHE_TOL = 1e-4
DM, PDM = ("data", "model"), ("pod", "data", "model")
# name, arch, mesh shape, axes, fsdp, config overrides
CASES = [
    ("llama_dm", "llama3-8b", (2, 4), DM, False, {}),
    ("llama_pdm", "llama3-8b", (2, 2, 2), PDM, False, {}),
    ("llama_dm_fsdp", "llama3-8b", (2, 4), DM, True, {}),
    ("mixtral_dm", "mixtral-8x22b", (2, 4), DM, False, {"window": 8}),
    ("ssm_dm", "mamba2-780m", (2, 4), DM, False, {}),
    ("hybrid_dm", "recurrentgemma-9b", (2, 4), DM, False, {}),
    ("vlm_dm", "qwen2-vl-2b", (2, 4), DM, False, {}),
    ("encdec_dm", "seamless-m4t-large-v2", (2, 4), DM, False, {}),
    # 6 SSD heads that 4 does not divide: the layer computed whole (its
    # leaves gathered over "model"), its cut state leaves (conv_x, conv_B,
    # conv_C) gathered for the step and sliced back
    ("ssm_heads_whole_dm", "mamba2-780m", (2, 4), DM, False, {"d_model": 48}),
]
ARCHS = sorted({c[1] for c in CASES})

JAX_REFERENCE = """
import dataclasses, pickle, sys
import jax, jax.numpy as jnp, numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
from repro.configs import REGISTRY, reduced_config
from repro.launch import sharding as sh
from repro.launch.steps import make_prefill, make_serve_step

inp = pickle.load(open(sys.argv[1], "rb"))


def shards(tree):
    # every device's own part of each leaf, by device id
    return [{x.device.id: np.asarray(x.data) for x in leaf.addressable_shards}
            for leaf in jax.tree.leaves(tree)]


out = {}
for c in inp["cases"]:
    cfg = dataclasses.replace(reduced_config(REGISTRY[c["arch"]]),
                              **c["over"])
    if "pod" in c["axes"]:
        cfg = dataclasses.replace(cfg, batch_axes=("pod", "data"))
    mesh = Mesh(np.array(jax.devices()).reshape(c["shape"]), c["axes"])
    ps = sh.param_specs(cfg, mesh, fsdp=c["fsdp"])
    gs = sh.gather_specs(cfg, mesh) if c["fsdp"] else None
    p = jax.device_put(jax.tree.map(jnp.asarray, inp["params"][c["name"]]),
                       sh.named(mesh, ps))
    bspecs = sh.batch_specs(cfg, None, mesh)
    b = bspecs["tokens"][0]
    batch = {k: jax.device_put(jnp.asarray(v), NamedSharding(mesh, bspecs[k]))
             for k, v in dict(c["extras"], tokens=c["prompt"]).items()}
    pre = make_prefill(cfg, c["max_len"], gather_specs=gs)
    with mesh:
        csh = sh.named(mesh, sh.cache_specs(
            cfg, mesh, jax.eval_shape(pre, p, batch)[1]))
        rep = NamedSharding(mesh, P())
        logits, cache = jax.jit(pre, out_shardings=(rep, csh))(p, batch)
        rec = {"logits": [np.asarray(logits)], "prefill_cache": shards(cache)}
        step = jax.jit(make_serve_step(cfg, gather_specs=gs),
                       out_shardings=(rep, csh))
        pos = np.full((c["prompt"].shape[0],), c["start"], np.int32)
        toks = []
        for i in range(c["steps"]):
            tok = np.asarray(jnp.argmax(logits, -1)).astype(np.int32)[:, None]
            toks.append(tok[:, 0])
            args = [p, cache, jax.device_put(tok, NamedSharding(mesh, P(b, None))),
                    jax.device_put(pos, NamedSharding(mesh, P(b)))]
            if c["steps_extras"]:
                args.append({k: jax.device_put(v[i], NamedSharding(
                    mesh, P(None, b, None)))
                    for k, v in c["steps_extras"].items()})
            logits, cache = step(*args)
            rec["logits"].append(np.asarray(logits))
            pos = pos + 1
    rec["tokens"] = np.stack(toks, 1)
    rec["cache"] = shards(cache)
    out[c["name"]] = rec
pickle.dump(out, open(sys.argv[2], "wb"))
"""


def _case_inputs(name, arch, shape, axes, fsdp, over, rng):
    """A case's keyword arguments for ``serve_spmd_case``: the prompts and
    the family's extras (numpy)."""
    cfg = dataclasses.replace(t_reduced(T_REGISTRY[arch]), **over)
    text = S - SV if cfg.family == "vlm" else S
    prompt = rng.integers(2, cfg.vocab, (B, text)).astype(np.int32)
    extras, steps_extras = {}, {}
    if cfg.family == "encdec":
        extras["frame_embeds"] = (rng.standard_normal(
            (B, FRAMES, cfg.d_model)) * 0.02).astype(np.float32)
    if cfg.family == "vlm":
        extras["vision_embeds"] = (rng.standard_normal(
            (B, SV, cfg.d_model)) * 0.02).astype(np.float32)
        q = np.arange(S + STEPS)
        ids = np.stack([q, q // 2, q % 5])                  # (3, S + STEPS)
        extras["position_ids"] = np.ascontiguousarray(np.broadcast_to(
            ids[:, None, :S], (3, B, S))).astype(np.int32)
        steps_extras["position_ids"] = np.ascontiguousarray(np.broadcast_to(
            ids[:, S:].T[:, :, None, None], (STEPS, 3, B, 1))).astype(np.int32)
    return dict(name=name, arch=arch, shape=shape, axes=axes, fsdp=fsdp,
                over=over, prompt=prompt, extras=extras,
                steps_extras=steps_extras, max_len=MAX_LEN, steps=STEPS,
                start=S)


def _params(arch, over):
    return tree_map(lambda t: t.numpy(), init_params(
        dataclasses.replace(t_reduced(T_REGISTRY[arch]), **over),
        torch.Generator().manual_seed(5), device="cpu"))


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(port results by rank, JAX results by case): the JAX subprocess and
    the 8 port ranks run at the same time."""
    tmp = tmp_path_factory.mktemp("serve_spmd")
    rng = np.random.default_rng(7)
    cases = [_case_inputs(*c, rng) for c in CASES]
    params = {c[0]: _params(c[1], c[5]) for c in CASES}
    with open(tmp / "in.pkl", "wb") as f:
        pickle.dump({"cases": cases, "params": params}, f)
    env = dict(os.environ, PYTHONPATH=SRC, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=8")
    with open(tmp / "jax.log", "w") as log:
        ref = subprocess.Popen(
            [sys.executable, "-c", textwrap.dedent(JAX_REFERENCE),
             str(tmp / "in.pkl"), str(tmp / "out.pkl")], env=env,
            stdout=log, stderr=subprocess.STDOUT)
        try:
            port = run_ranks("serve_spmd_scenarios", 8, tmp, TIMEOUT,
                             cases=cases, params=params)
            ref.wait(timeout=TIMEOUT)
        finally:
            if ref.poll() is None:
                ref.kill()
                ref.wait()
    assert ref.returncode == 0, (tmp / "jax.log").read_text()[-4000:]
    with open(tmp / "out.pkl", "rb") as f:
        return port, pickle.load(f)


def _rows(case, rank):
    """The batch rows of ``rank`` on the case's mesh (pod major)."""
    shape, axes = dict((c[0], c[2:4]) for c in CASES)[case]
    coords = np.argwhere(np.arange(8).reshape(shape) == rank)[0]
    j, n = 0, 1
    for a, i, size in zip(axes, coords, shape):
        if a != "model":
            j, n = j * size + i, n * size
    return slice(j * B // n, (j + 1) * B // n)


@pytest.mark.parametrize("case", [c[0] for c in CASES])
def test_spmd_serving_matches_jax(runs, case):
    """Every rank's logits of its rows after the prefill and each of the 6
    token steps (over the whole vocabulary, on every rank of "model"),
    its greedy tokens, and its cache shard after the prefill and after
    the last step against the JAX device of the same index; each cache
    leaf has ``cache_specs``' local shape."""
    port, ref = runs
    jr = ref[case]
    for r in range(8):
        got, rows = port[r][case], _rows(case, r)
        assert got["shapes_ok"]
        np.testing.assert_array_equal(got["tokens"], jr["tokens"][rows])
        for a, b in zip(got["logits"], jr["logits"]):
            np.testing.assert_allclose(a, b[rows], rtol=0, atol=LOGIT_TOL)
        for key in ("prefill_cache", "cache"):
            assert len(got[key]) == len(jr[key])
            for a, per in zip(got[key], jr[key]):
                np.testing.assert_allclose(a, per[r], rtol=0, atol=CACHE_TOL)


@pytest.mark.parametrize("case", [c[0] for c in CASES])
def test_spmd_serving_gathers_no_layer_weight_over_model(runs, case):
    """No tensor that a rank gathers over "model" in the prefill or the
    token steps has the local shape of a layer leaf that "model" cuts:
    the layers compute on the rank's shards, and what crosses the axis is
    activations — the token's q and k / v, each layer's prompt keys and
    values, the conv output that the SSD's B / C and the RG-LRU's gates
    read, and the logits.  The one exception, an SSD layer whose heads
    the axis does not divide, gathers its cut leaves (and no other
    layer's)."""
    port, _ = runs
    for r in range(8):
        got = port[r][case]
        assert got["gathered"]
        assert not set(got["gathered"]) & set(got["layer_shards"])
        assert set(got["whole_layer_shards"]) <= set(got["gathered"])
    assert bool(port[0][case]["whole_layer_shards"]) == (
        case == "ssm_heads_whole_dm")


@pytest.mark.parametrize("piece", ["empty_slice", "window", "softcap"])
def test_split_window_combine_matches_whole_ring(runs, piece):
    """``split_decode_attention`` on each rank's quarter of a 16-slot ring
    (its positions absolute) against ``decode_attention`` on the whole
    ring: a ring written to positions 2-7 only, so that every rank but
    the first holds a slice with no visible key for some stream (zero
    weight, no NaN), a wrapped ring under a window of 6, and scores
    through a softcap."""
    port, _ = runs
    for r in range(8):
        want, got, _ = port[r]["split_window"][piece]
        assert np.isfinite(got).all()
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    if piece == "empty_slice":
        assert sum(port[r]["split_window"][piece][2] for r in range(8)) >= 4


@pytest.mark.parametrize("arch", ARCHS)
def test_one_rank_mesh_equals_the_unsharded_steps(arch):
    """On a (1, 1) mesh (no process group) the spmd prefill and 3 token
    steps give the logits, tokens and cache of ``make_prefill`` and
    ``make_serve_step``."""
    from repro_torch.launch import sharding as sh
    from repro_torch.launch.mesh import Mesh
    from repro_torch.launch.steps import (make_prefill, make_prefill_spmd,
                                          make_serve_step,
                                          make_serve_step_spmd)
    from repro_torch.models import decode as dec
    from repro_torch.models.params import from_reference

    c = next(c for c in CASES if c[1] == arch)
    kw = _case_inputs(*c, np.random.default_rng(3))
    cfg = dataclasses.replace(t_reduced(T_REGISTRY[arch]), **c[5])
    mesh = Mesh(np.zeros((1, 1), dtype=int), DM)
    params = from_reference(_params(arch, c[5]), "cpu")
    batch = {k: torch.from_numpy(v) for k, v in
             dict(kw["extras"], tokens=kw["prompt"]).items()}
    src = FRAMES if cfg.family == "encdec" else 0
    steps = {"whole": (make_prefill(cfg, MAX_LEN), make_serve_step(cfg)),
             "spmd": (make_prefill_spmd(cfg, mesh,
                                        sh.param_specs(cfg, mesh), MAX_LEN),
                      make_serve_step_spmd(cfg, mesh,
                                           sh.param_specs(cfg, mesh),
                                           MAX_LEN, src))}
    out = {}
    for name, (prefill, step) in steps.items():
        logits, cache = prefill(params, batch)
        seen, pos = [logits], torch.full((B,), S, dtype=torch.int32)
        for i in range(3):
            ex = {k: torch.from_numpy(v[i]) for k, v in
                  kw["steps_extras"].items()} or None
            tok = logits.argmax(-1, keepdim=True).to(torch.int32)
            logits, cache = step(params, cache, tok, pos, ex)
            seen += [tok, logits]
            pos = pos + 1
        out[name] = seen + dec.tree_leaves(
            cache, dec.cache_view_specs(cfg, MAX_LEN, src))
    for a, b in zip(out["whole"], out["spmd"]):
        if a.dtype == torch.int32:
            assert torch.equal(a, b)
        else:
            torch.testing.assert_close(b, a, rtol=0, atol=1e-6)
