"""The port's multi-rank training path against the JAX package's on 8
devices, on the CPU: ``make_train_step_smap`` and ``make_train_step_spmd``
on 8 gloo ranks (``torch.distributed``) against the JAX package's
``make_train_step_smap`` and its GSPMD-partitioned ``make_train_step``
(jitted with the ``param_specs`` / ``opt_specs_for`` / ``batch_specs``
shardings, as its ``launch/dryrun.py`` does) on 8 forced host devices
(``--xla_force_host_platform_device_count=8`` in a subprocess, as
``tests/test_dryrun.py`` runs it); the tensor-parallel pieces (the
vocabulary-parallel loss, the row-parallel MLP) against their unsharded
results; the Trainer's real mesh swap (spread 1 -> 2 -> 4) against the
JAX Trainer's, the rows it feeds each rank of a (pod, data, model) mesh,
and a checkpoint written on one mesh restored on another.

One spawn of 8 ranks (``tests/torch_dist_workers.py``, a ``FileStore``
under the test's temporary directory, its own timeout) runs every port
scenario while one JAX subprocess runs the references; both start from
the port's seeded weights (reduced llama3-8b, and reduced mixtral-8x22b
for the spmd cases; float32) and read the same batches and corpus
files.

Tolerances: losses and grad norms 1e-5 (relative); parameters after 3
steps 1e-4 (absolute; most leaves agree within 1e-5, but AdamW divides
each near-zero gradient entry by its own magnitude, so a summation-order
difference there moves an entry by up to 7e-5 — ``test_torch_train.py``
holds its three-step parameters to the same 1e-4), and with 8-bit
moments all but one entry in 10^4 — where a quantization tie flipped —
which stay within two learning rates (``test_torch_quantized.py``'s
rule); Trainer losses 1e-4, as ``test_torch_trainer.py``."""
import dataclasses
import os
import pickle
import subprocess
import sys
import textwrap

import jax
import numpy as np
import pytest
import torch

from torch_dist_workers import run_ranks
from repro_torch.configs import REGISTRY as T_REGISTRY
from repro_torch.configs import reduced_config as t_reduced
from repro_torch.data.pipeline import SyntheticCorpus, write_corpus_shards
from repro_torch.models.params import init_params, tree_map

ARCH = "llama3-8b"
OPT = dict(peak_lr=1e-3, warmup_steps=2, total_steps=10)
TRAINER_OPT = dict(peak_lr=1e-3, warmup_steps=2, total_steps=20)
B, S, STEPS = 8, 32, 3
SRC = os.path.join(os.path.dirname(__file__), "..", "src")
TIMEOUT = 300
# name, mesh shape, axes, fsdp, microbatches, compress_pod, opt_impl
CASES = [
    ("fsdp_8bit", (4, 2), ("data", "model"), True, 2, False, "adamw8bit"),
    ("compress_pod", (2, 2, 2), ("pod", "data", "model"), False, 1, True,
     "adamw"),
]
DM, PDM = ("data", "model"), ("pod", "data", "model")
# the spmd step against JAX's GSPMD step: name, arch, mesh shape, axes,
# fsdp, microbatches, opt_impl, config overrides
SPMD_CASES = [
    (f"spmd_{tag}_{name}", arch, shape, axes, fsdp, mb, impl, {})
    for arch, tag in (("llama3-8b", "llama"), ("mixtral-8x22b", "mixtral"))
    for name, shape, axes, fsdp, mb, impl in (
        ("dm", (2, 4), DM, False, 1, "adamw"),
        ("dm_fsdp", (2, 4), DM, True, 1, "adamw"),
        ("pdm", (2, 2, 2), PDM, False, 1, "adamw"))
] + [("spmd_llama_dm_fsdp_8bit", "llama3-8b", (2, 4), DM, True, 2,
      "adamw8bit", {})] + [
    # a capacity that drops claims: an expert keeps 32 of a block's 128
    (f"spmd_mixtral_drop_{name}", "mixtral-8x22b", shape, axes, False, 1,
     "adamw", {"capacity_factor": 1.0})
    for name, shape, axes in (("dm", (2, 4), DM), ("pdm", (2, 2, 2), PDM))
] + [(f"spmd_{tag}_dm", arch, (2, 4), DM, False, 1, "adamw", {})
     for arch, tag in (("recurrentgemma-9b", "hybrid"),
                       ("seamless-m4t-large-v2", "encdec"),
                       ("mamba2-780m", "ssm"), ("qwen2-vl-2b", "vlm"),
                       ("grok-1-314b", "grok"))] + [
    ("spmd_ssm_pdm", "mamba2-780m", (2, 2, 2), PDM, False, 1, "adamw", {})]
SPMD_ARCHS = sorted({c[1] for c in SPMD_CASES})

JAX_REFERENCE = """
import pickle, sys
import jax, jax.numpy as jnp, numpy as np
from jax.sharding import Mesh
from repro.configs import REGISTRY, reduced_config
from repro.core.controller import ControllerConfig
from repro.core.layout import Layout
from repro.core.topology import ChipletTopology
from repro.data.pipeline import ShardedLoader
from repro.launch import sharding as sh
from repro.launch.steps import make_train_step, make_train_step_smap
from repro.optim.adamw import AdamWConfig, init_opt_state
from repro.optim.quantized import init_opt_state_8bit
from repro.runtime.trainer import Trainer, TrainerConfig

inp = pickle.load(open(sys.argv[1], "rb"))
cfg = reduced_config(REGISTRY[inp["arch"]])
params0 = jax.tree.map(jnp.asarray, inp["params"])
out = {}
for name, shape, axes, fsdp, mb, comp, impl in inp["cases"]:
    mesh = Mesh(np.array(jax.devices()).reshape(shape), axes)
    ps = sh.param_specs(cfg, mesh, fsdp=fsdp)
    init = init_opt_state_8bit if impl == "adamw8bit" else init_opt_state
    ospecs = sh.opt_specs_for(cfg, mesh, ps, jax.eval_shape(init, params0))
    psh, osh = sh.named(mesh, ps), sh.named(mesh, ospecs)
    bspecs = sh.batch_specs(cfg, None, mesh)
    step = jax.jit(make_train_step_smap(
        cfg, AdamWConfig(**inp["opt"]), mesh, ps, bspecs, microbatches=mb,
        opt_impl=impl, compress_pod=comp), out_shardings=(psh, osh, None))
    p = jax.device_put(params0, psh)
    s = jax.device_put(init(params0), osh)
    losses, norms = [], []
    for b in inp["batches"]:
        p, s, m = step(p, s, jax.device_put(b, sh.named(mesh, bspecs)))
        losses.append(float(m["loss"]))
        norms.append(float(m["grad_norm"]))
    # every device's own copy of each parameter, by device id
    per_device = [{d.id: np.asarray(x.data) for x in leaf.addressable_shards
                   for d in [x.device]} for leaf in jax.tree.leaves(p)]
    out[name] = {"params": jax.tree.map(np.asarray, p), "losses": losses,
                 "norms": norms, "per_device": per_device}

# the GSPMD step: make_train_step jitted with the mesh's shardings, as
# launch/dryrun.py's run_cell
import dataclasses
for name, arch, shape, axes, fsdp, mb, impl, over in inp["spmd_cases"]:
    c = dataclasses.replace(reduced_config(REGISTRY[arch]), **over)
    if "pod" in axes:
        c = dataclasses.replace(c, batch_axes=("pod", "data"))
    p0 = jax.tree.map(jnp.asarray, inp["spmd_params"][arch])
    mesh = Mesh(np.array(jax.devices()).reshape(shape), axes)
    ps = sh.param_specs(c, mesh, fsdp=fsdp)
    gspecs = sh.gather_specs(c, mesh) if fsdp else None
    init = init_opt_state_8bit if impl == "adamw8bit" else init_opt_state
    ospecs = sh.opt_specs_for(c, mesh, ps, jax.eval_shape(init, p0))
    psh, osh = sh.named(mesh, ps), sh.named(mesh, ospecs)
    bsh = sh.named(mesh, sh.batch_specs(c, None, mesh))
    step = jax.jit(make_train_step(
        c, AdamWConfig(**inp["opt"]), microbatches=mb, opt_impl=impl,
        gather_specs=gspecs), out_shardings=(psh, osh, None))
    p = jax.device_put(p0, psh)
    s = jax.device_put(init(p0), osh)
    losses, norms = [], []
    with mesh:
        for b in inp["spmd_batches"][arch]:
            p, s, m = step(p, s, jax.device_put(b, bsh))
            losses.append(float(m["loss"]))
            norms.append(float(m["grad_norm"]))
    out[name] = {"params": jax.tree.map(np.asarray, p), "losses": losses,
                 "norms": norms}

# the port's collective feed is its own (ROADMAP C), so the JAX Trainer's
# HLO feed is not compared: skip the second compile it makes per mesh
compile_step = Trainer._compile_step


def _compile_step(self, mesh):
    compile_step(self, mesh)
    self._hlo_bytes = {"remote": 0.0, "local": 0.0}


Trainer._compile_step = _compile_step
topo = ChipletTopology(n_pods=1, groups_per_pod=4, chips_per_group=2)
tcfg = TrainerConfig(steps=inp["steps"], ckpt_every=100, log_every=100,
                     ckpt_dir=inp["ckpt"], opt=AdamWConfig(**inp["trainer_opt"]))
trainer = Trainer(cfg, Layout(topo, 1).make_mesh(),
                  ShardedLoader(inp["files"], seq_len=inp["seq"],
                                batch=inp["batch"]), tcfg, topology=topo,
                  controller_cfg=ControllerConfig(scheduler_timer=2,
                                                  threshold=0.0, min_dwell=0),
                  log=lambda s: None)
trainer.params = jax.device_put(params0, trainer.psh)
trainer.opt_state = jax.device_put(init_opt_state(trainer.params),
                                   trainer.osh)
run = trainer.run()
out["trainer"] = {"losses": run["losses"],
                  "relayouts": run["counters"]["relayouts"],
                  "mesh": (trainer.mesh.shape["data"],
                           trainer.mesh.shape["model"])}
# the Trainer on a (pod 2, data 2, model 2) mesh with the int8 error
# feedback, as the port's pod_trainer
tcfg = TrainerConfig(steps=2, ckpt_every=100, log_every=100,
                     ckpt_dir=inp["ckpt"] + "_pod",
                     opt=AdamWConfig(**inp["trainer_opt"]),
                     compress_cross_pod=True)
pod = Trainer(cfg, Mesh(np.array(jax.devices()).reshape(2, 2, 2),
                        ("pod", "data", "model")),
              ShardedLoader(inp["files"], seq_len=inp["seq"],
                            batch=inp["batch"]), tcfg, log=lambda s: None)
# (from the numpy weights: the first Trainer's steps donated params0)
pod.params = jax.device_put(jax.tree.map(jnp.asarray, inp["params"]),
                            pod.psh)
pod.opt_state = jax.device_put(init_opt_state(pod.params), pod.osh)
out["pod_trainer"] = {"losses": pod.run()["losses"]}
pickle.dump(out, open(sys.argv[2], "wb"))
"""


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(port results by rank, JAX results): the JAX subprocess and the 8
    port ranks run at the same time."""
    tmp = tmp_path_factory.mktemp("dist")
    cfg = t_reduced(T_REGISTRY[ARCH])
    params = tree_map(lambda t: t.numpy(), init_params(
        cfg, torch.Generator().manual_seed(5), device="cpu"))
    spmd_params = {a: params if a == ARCH else tree_map(
        lambda t: t.numpy(), init_params(
            t_reduced(T_REGISTRY[a]), torch.Generator().manual_seed(5),
            device="cpu")) for a in SPMD_ARCHS}
    rng = np.random.default_rng(7)
    batches = []
    for _ in range(STEPS):
        blk = rng.integers(2, cfg.vocab, size=(B, S + 1)).astype(np.int32)
        batches.append({"tokens": blk[:, :-1], "targets": blk[:, 1:],
                        "mask": (rng.random((B, S)) < 0.9).astype(
                            np.float32)})
    # the encoder-decoder's: S // 2 source frames and S // 2 target tokens
    # of the same rows, as make_batch cuts them
    src = [(rng.standard_normal((B, S // 2, 64)) * 0.02).astype(np.float32)
           for _ in range(STEPS)]
    # the VLM's: S // 4 patch embeddings ahead of the text, the targets
    # over the whole sequence, t/h/w position ids that differ
    sv, q = S // 4, np.arange(S)
    pos = np.broadcast_to(np.stack([q, q // 2, q % 5])[:, None],
                          (3, B, S)).astype(np.int32)
    vis = [(rng.standard_normal((B, sv, 64)) * 0.02).astype(np.float32)
           for _ in range(STEPS)]
    family = {
        "encdec": [dict({k: v[:, :S // 2] for k, v in b.items()},
                        frame_embeds=f) for b, f in zip(batches, src)],
        "vlm": [dict(b, tokens=b["tokens"][:, :S - sv], vision_embeds=v,
                     position_ids=pos.copy()) for b, v in zip(batches, vis)]}
    spmd_batches = {a: family.get(T_REGISTRY[a].family, batches)
                    for a in SPMD_ARCHS}
    files = write_corpus_shards(str(tmp / "data"),
                                SyntheticCorpus(cfg.vocab, seed=3),
                                n_shards=2, tokens_per_shard=20000)
    trainer_kw = dict(files=files, steps=6, seq=16, batch=8,
                      opt=TRAINER_OPT)
    inp = dict(arch=ARCH, params=params, batches=batches, opt=OPT,
               cases=CASES, spmd_cases=SPMD_CASES, spmd_params=spmd_params,
               spmd_batches=spmd_batches,
               ckpt=str(tmp / "jax_ckpt"),
               trainer_opt=TRAINER_OPT, **{k: v for k, v in trainer_kw.items()
                                           if k != "opt"})
    with open(tmp / "in.pkl", "wb") as f:
        pickle.dump(inp, f)
    env = dict(os.environ, PYTHONPATH=SRC, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=8")
    with open(tmp / "jax.log", "w") as log:
        ref = subprocess.Popen(
            [sys.executable, "-c", textwrap.dedent(JAX_REFERENCE),
             str(tmp / "in.pkl"), str(tmp / "out.pkl")], env=env,
            stdout=log, stderr=subprocess.STDOUT)
        try:
            port = run_ranks("dist_scenarios", 8, tmp, TIMEOUT, arch=ARCH,
                             params=params, batches=batches, cases=CASES,
                             opt=OPT, trainer=dict(trainer_kw, ckpt_dir=str(
                                 tmp / "port_ckpt")), spmd_cases=SPMD_CASES,
                             spmd_params=spmd_params,
                             spmd_batches=spmd_batches, pod_trainer=dict(
                                 files=files, seq=16, batch=8,
                                 opt=TRAINER_OPT,
                                 ckpt_dir=str(tmp / "pod_ckpt")))
            ref.wait(timeout=TIMEOUT)
        finally:
            if ref.poll() is None:
                ref.kill()
                ref.wait()
    assert ref.returncode == 0, (tmp / "jax.log").read_text()[-4000:]
    with open(tmp / "out.pkl", "rb") as f:
        return port, pickle.load(f)


def _leaves(tree):
    return jax.tree.leaves(tree)


def _params_close(port_params, jax_params, eight_bit):
    off = total = 0
    for a, b in zip(_leaves(port_params), _leaves(jax_params)):
        d = np.abs(a - b)
        if not eight_bit:
            np.testing.assert_allclose(a, b, rtol=0, atol=1e-4)
        assert d.max() <= 2 * OPT["peak_lr"]
        off, total = off + int((d > 1e-4).sum()), total + d.size
    assert off <= 1e-4 * total, (off, total)


@pytest.mark.parametrize("case", [c[0] for c in CASES])
def test_smap_step_matches_jax(runs, case):
    """Losses, grad norms and every rank's parameters after 3 steps: (data
    4, model 2) with FSDP, 2 microbatches and 8-bit moments (rows cut by
    "model" and ZeRO's "data"); (pod 2, data 2, model 2) with float32
    moments and int8 over the pod hop."""
    port, ref = runs
    jr = ref[case]
    eight_bit = dict((c[0], c[6]) for c in CASES)[case] == "adamw8bit"
    for r in range(8):
        np.testing.assert_allclose(port[r][case]["losses"], jr["losses"],
                                   rtol=1e-5)
        np.testing.assert_allclose(port[r][case]["norms"], jr["norms"],
                                   rtol=1e-5)
        _params_close(port[r][case]["params"], jr["params"], eight_bit)


@pytest.mark.parametrize("case", [c[0] for c in SPMD_CASES])
def test_spmd_step_matches_jax(runs, case):
    """``make_train_step_spmd`` against the JAX package's GSPMD-partitioned
    ``make_train_step``: losses, grad norms and every rank's parameters
    after 3 steps, to the smap step's tolerances, on reduced llama3-8b and
    mixtral-8x22b — (data 2, model 4) with and without FSDP, (pod 2, data
    2, model 2), and FSDP with 2 microbatches and 8-bit moments; reduced
    mixtral-8x22b at capacity factor 1.0, which drops claims, on (data 2,
    model 4) and (pod 2, data 2, model 2) (a rank's claims take their
    slots after the lower batch shards', against the global capacity);
    on (data 2, model 4) reduced recurrentgemma-9b (split attention and
    rec layers: a rank's 16 of the 64 LRU channels, the conv output
    gathered for the gates), seamless-m4t-large-v2 (the encoder's and
    the decoder's self- and cross-attention on a rank's one head of 4,
    their MLPs on its ``ff`` slice), mamba2-780m (a rank's 2 of 8 SSD
    heads, 32 of 128 ``d_inner`` channels and 4 of the 16 B/C channels,
    gathered for its heads' one group; the gated norm's mean square
    summed over the axis), qwen2-vl-2b (the patch embeddings merged
    ahead of the text, M-RoPE) and grok-1-314b (its non-GLU gelu
    experts' ``ff`` cut); and mamba2-780m on (pod 2, data 2, model 2),
    where the model axis is not the innermost but one.  On the 4-wide
    model axis each rank of the attention families holds one query head
    and reads the one replicated kv head, an ``ff`` slice of 32 and a
    vocabulary slice of 128; the batch is cut over every batch axis."""
    port, ref = runs
    jr = ref[case]
    eight_bit = dict((c[0], c[6]) for c in SPMD_CASES)[case] == "adamw8bit"
    for r in range(8):
        np.testing.assert_allclose(port[r][case]["losses"], jr["losses"],
                                   rtol=1e-5)
        np.testing.assert_allclose(port[r][case]["norms"], jr["norms"],
                                   rtol=1e-5)
        _params_close(port[r][case]["params"], jr["params"], eight_bit)


SPLIT_BLOCKS = [f"{b}_{p}" for b in ("ssd", "ssd_bc_whole", "rec", "xattn",
                                     "xattn_kv_whole")
                for p in ("y", "dx", "dw")]


def _pairs(v):
    """The (want, got) pairs of a piece: one, a list or a dict of them."""
    if isinstance(v, dict):
        return [p for k in sorted(v) for p in _pairs(v[k])]
    return [p for x in v for p in _pairs(x)] if isinstance(v, list) else [v]


@pytest.mark.parametrize("piece", ["ce", "ce_dx", "ce_dhead", "mlp_y",
                                   "mlp_dx", "mlp_dwi", "mlp_dwo",
                                   "gather_summed_dx", "psum_y", "psum_dx"]
                         + SPLIT_BLOCKS)
def test_tensor_parallel_pieces_match_unsharded(runs, piece):
    """On (data 2, model 4): the vocabulary-parallel ``chunked_ce_loss``
    (two loss chunks a row, pad columns in the last slice) — the ranks'
    shares summed over "data" equal the whole batch's loss, and the input
    and head-slice gradients the unsharded ones; the row-parallel MLP's
    output and gradients equal the unsharded MLP's (float32, 1e-5).  The
    two collectives the split SSD and RG-LRU blocks add: the gather whose
    backward sums over the axis, then slices, and the sum summed both
    ways.  The split blocks' outputs, input gradients and each weight
    shard's gradient against the unsharded block's (float32, 1e-5 of each
    tensor's largest magnitude): the SSD block with G·N cut (B and C
    gathered) and whole (B and C computed whole), the RG-LRU block, and
    the decoder layer (self-attention, cross-attention over the encoder's
    output, whose gradient is summed over the ranks' heads, the MLP) with
    the kv heads cut and replicated (``wk`` / ``wv`` gradients partial,
    summed over "model" as the spmd step does)."""
    port, _ = runs
    for r in range(8):
        for want, got in _pairs(port[r]["tp_pieces"][piece]):
            atol = 1e-6 if piece in ("ce", "ce_dx", "ce_dhead") or \
                piece.startswith("mlp") else 1e-5 * np.abs(want).max()
            np.testing.assert_allclose(got, want, rtol=1e-5, atol=atol)
    assert port[0]["tp_pieces"]["bytes"]["intra_group"] > 0


def test_plain_gather_drops_the_other_ranks_gradients(runs):
    """The guard for the gather the RG-LRU's gates read: with ``u``
    gathered by the plain ``gather`` (whose backward only slices, right
    when every rank holds the whole gradient), the split block's input
    gradient misses the other ranks' parts — off by far more than the
    tolerance — where ``gather_summed`` matches (``rec_dx``)."""
    port, _ = runs
    for r in range(8):
        want, got = port[r]["tp_pieces"]["rec_dx_plain_gather"]
        assert np.abs(got - want).max() > 1e-3 * np.abs(want).max()


@pytest.mark.parametrize("case", [c[0] for c in SPMD_CASES])
def test_spmd_step_gathers_no_model_shard_of_a_layer(case):
    """In every spmd case, no layer leaf is gathered along "model": every
    layer type computes on the rank's model shards (``spmd_gathers``
    gathers over the batch axes only), and the model-sharded leaves the
    step holds are the rank's slices."""
    from repro_torch.launch import sharding as sh
    from repro_torch.launch.mesh import Mesh
    from repro_torch.launch.steps import spmd_gathers
    from repro_torch.models.params import _leaves

    _, arch, shape, axes, fsdp, _, _, over = \
        dict((c[0], c) for c in SPMD_CASES)[case]
    cfg = dataclasses.replace(t_reduced(T_REGISTRY[arch]), **over)
    mesh = Mesh(np.arange(8).reshape(shape), axes)
    pspecs = sh.param_specs(cfg, mesh, fsdp=fsdp)
    gat = spmd_gathers(cfg, mesh, pspecs)
    held = 0
    for key in ("layers", "groups", "tail", "enc_layers", "dec_layers"):
        for (_, f), (_, spec) in zip(_leaves(gat.get(key, {})),
                                     _leaves(pspecs.get(key, {}))):
            assert "model" not in {a for e in f.keywords["sharding"].spec
                                   for a in sh.entry_axes(e)}
            held += "model" in {a for e in spec for a in sh.entry_axes(e)}
    assert held > 0


def test_trainer_feeds_each_rank_its_rows(runs):
    """The Trainer on a (pod 2, data 2, model 2) mesh steps with the spmd
    step, the int8 error feedback threaded through it: every ``loss_fn``
    call of a rank sees 1/(pod x data) of the batch of 8 rows, as the JAX
    Trainer's ``batch_sharding``, and every rank's losses equal the JAX
    Trainer's on the same mesh (1e-4, as the Trainer tests)."""
    port, ref = runs
    for r in range(8):
        t = port[r]["pod_trainer"]
        assert t["rows"] == [2, 2]
        np.testing.assert_allclose(t["losses"], ref["pod_trainer"]["losses"],
                                   rtol=1e-4, atol=1e-4)


def test_compress_pod_result_is_the_same_on_every_device(runs):
    """On a mesh with a pod axis the JAX step's ``manualize`` leaves the
    batch's ("pod", "data") entry unsplit, so every device takes the whole
    batch and every pod's data-summed gradient, int8 scale and result
    agree (ROADMAP C); the port's ranks agree the same way."""
    port, ref = runs
    for per in ref["compress_pod"]["per_device"]:
        # device id = (pod * 2 + data) * 2 + model: the devices of one
        # model index hold the same part of the leaf
        for d, arr in per.items():
            np.testing.assert_array_equal(arr, per[d % 2])
    for r in range(1, 8):
        for a, b in zip(_leaves(port[r]["compress_pod"]["params"]),
                        _leaves(port[0]["compress_pod"]["params"])):
            np.testing.assert_array_equal(a, b)


def test_smap_collectives_are_classed(runs):
    """The FSDP step's collectives: the model-axis gathers stay in a data
    row (intra_group), the data-axis sums and gathers cross rows
    (intra_pod); the pod mesh's int8 hop crosses pods."""
    port, _ = runs
    fsdp = port[0]["fsdp_8bit"]["bytes"]
    assert fsdp["intra_group"] > 0 and fsdp["intra_pod"] > 0
    assert "cross_pod" not in fsdp
    assert port[0]["compress_pod"]["bytes"]["cross_pod"] > 0


def test_trainer_midrun_relayout_meshswap(runs):
    """The port's twin of ``test_trainer_midrun_relayout_meshswap_
    subprocess``: spread walks 1 -> 2 -> 4, the final mesh is (1, 8), every
    rank's local parameter and moment shapes follow the new specs, and the
    losses equal the JAX Trainer's from the same weights."""
    port, ref = runs
    jt = ref["trainer"]
    assert jt["mesh"] == (1, 8) and jt["relayouts"] >= 2
    for r in range(8):
        t = port[r]["trainer"]
        assert t["mesh"] == (1, 8)
        assert t["counters"]["relayouts"] == jt["relayouts"]
        assert t["shapes_ok"]
        np.testing.assert_allclose(t["losses"], jt["losses"], rtol=1e-4,
                                   atol=1e-4)
    # collectives moved bytes, remote (across data rows) and local
    c = port[0]["trainer"]["counters"]
    assert c["remote_bytes"] > 0 and c["local_bytes"] > 0


def test_checkpoint_written_on_one_mesh_restores_on_another(runs):
    """The Trainer's step-6 checkpoint, written from the (1, 8) mesh,
    restores onto (4, 2): every rank reads its slices, and the gathered
    parameters and moments equal the writer's bit for bit."""
    port, _ = runs
    for r in range(8):
        t = port[r]["trainer"]
        assert t["resumed"] and t["resumed_step"] == 6
        assert t["restored_mesh"] == (4, 2)
        for a, b in zip(_leaves(t["restored"]), _leaves(t["final"])):
            np.testing.assert_array_equal(a, b)
