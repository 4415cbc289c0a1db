"""The port's multi-rank training path against the JAX package's on 8
devices, on the CPU: ``make_train_step_smap`` on 8 gloo ranks
(``torch.distributed``) against the JAX step on 8 forced host devices
(``--xla_force_host_platform_device_count=8`` in a subprocess, as
``tests/test_dryrun.py`` runs it); the Trainer's real mesh swap
(spread 1 -> 2 -> 4) against the JAX Trainer's; and a checkpoint written
on one mesh restored on another.

One spawn of 8 ranks (``tests/torch_dist_workers.py``, a ``FileStore``
under the test's temporary directory, its own timeout) runs every port
scenario while one JAX subprocess runs the references; both start from
the port's seeded weights (reduced llama3-8b, float32) and read the same
batches and corpus files.

Tolerances: losses and grad norms 1e-5 (relative); parameters after 3
steps 1e-4 (absolute; most leaves agree within 1e-5, but AdamW divides
each near-zero gradient entry by its own magnitude, so a summation-order
difference there moves an entry by up to 7e-5 — ``test_torch_train.py``
holds its three-step parameters to the same 1e-4), and with 8-bit
moments all but one entry in 10^4 — where a quantization tie flipped —
which stay within two learning rates (``test_torch_quantized.py``'s
rule); Trainer losses 1e-4, as ``test_torch_trainer.py``."""
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
from repro.launch.steps import make_train_step_smap
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
    rng = np.random.default_rng(7)
    batches = []
    for _ in range(STEPS):
        blk = rng.integers(2, cfg.vocab, size=(B, S + 1)).astype(np.int32)
        batches.append({"tokens": blk[:, :-1], "targets": blk[:, 1:],
                        "mask": (rng.random((B, S)) < 0.9).astype(
                            np.float32)})
    files = write_corpus_shards(str(tmp / "data"),
                                SyntheticCorpus(cfg.vocab, seed=3),
                                n_shards=2, tokens_per_shard=20000)
    trainer_kw = dict(files=files, steps=6, seq=16, batch=8,
                      opt=TRAINER_OPT)
    inp = dict(arch=ARCH, params=params, batches=batches, opt=OPT,
               cases=CASES, ckpt=str(tmp / "jax_ckpt"),
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
                                 tmp / "port_ckpt")))
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
