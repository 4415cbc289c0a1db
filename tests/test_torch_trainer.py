"""The port's training substrates against the JAX package on the CPU: the
``Trainer`` (losses and counters, checkpoint and resume), the checkpoint
layout in both directions, and copies of ``test_substrates.py``'s data,
schedule, checkpoint and failure tests run on the port's modules.

Both trainers read the same corpus files and start from the same weights
(the JAX Trainer's, carried across with ``from_reference``)."""
import dataclasses
import json
import os
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from repro.checkpoint.manager import CheckpointManager as JCkpt
from repro.configs import REGISTRY, reduced_config
from repro.core.controller import ControllerConfig as JControllerConfig
from repro.core.topology import ChipletTopology as JTopology
from repro.data.pipeline import ShardedLoader as JLoader
from repro.data.pipeline import SyntheticCorpus as JCorpus
from repro.data.pipeline import make_batch as j_make_batch
from repro.data.pipeline import write_corpus_shards as j_write
from repro.optim.adamw import AdamWConfig as JAdamW
from repro.optim.adamw import init_opt_state as j_init_opt_state
from repro.runtime.trainer import Trainer as JTrainer
from repro.runtime.trainer import TrainerConfig as JTrainerConfig
from repro_torch.checkpoint.manager import (CheckpointManager, load_pytree,
                                            save_pytree)
from repro_torch.configs import REGISTRY as T_REGISTRY
from repro_torch.configs import reduced_config as t_reduced
from repro_torch.core.controller import ControllerConfig
from repro_torch.core.topology import ChipletTopology
from repro_torch.data.pipeline import (ShardedLoader, SyntheticCorpus,
                                       make_batch, write_corpus_shards)
from repro_torch.models.params import from_reference
from repro_torch.optim.adamw import AdamWConfig, lr_schedule
from repro_torch.runtime.failure import HeartbeatMonitor, StragglerDetector
from repro_torch.runtime.trainer import Trainer, TrainerConfig

ARCH = "llama3.2-3b"
OPT = dict(peak_lr=1e-3, warmup_steps=2, total_steps=20)
SEQ, BATCH = 32, 2


def corpus_files(tmp_path, vocab):
    return write_corpus_shards(str(tmp_path / "data"),
                               SyntheticCorpus(vocab, seed=3), n_shards=2,
                               tokens_per_shard=4000)


def t_trainer(cfg, files, ckpt_dir, params, steps=4, ckpt_every=100, **kw):
    tcfg = TrainerConfig(steps=steps, ckpt_every=ckpt_every, log_every=100,
                         ckpt_dir=str(ckpt_dir), opt=AdamWConfig(**OPT))
    return Trainer(cfg, ShardedLoader(files, seq_len=SEQ, batch=BATCH), tcfg,
                   log=lambda s: None, params=params, device="cpu", **kw)


def _jax_trainer_run(tmp, arch, params=None):
    """The JAX Trainer, 4 steps on reduced ``arch`` with the adaptive
    controller at threshold 0 (a relayout every second step, logical on
    one device), from its own initial weights or ``params`` (a tree of
    arrays): its starting weights, losses and counters."""
    cfg = reduced_config(REGISTRY[arch])
    files = j_write(str(tmp / "data"), JCorpus(cfg.vocab, seed=3),
                    n_shards=2, tokens_per_shard=4000)
    mesh = Mesh(np.array(jax.devices()[:1]).reshape(1, 1), ("data", "model"))
    tcfg = JTrainerConfig(steps=4, ckpt_every=100, log_every=100,
                          ckpt_dir=str(tmp / "ckpt"), opt=JAdamW(**OPT))
    trainer = JTrainer(cfg, mesh, JLoader(files, seq_len=SEQ, batch=BATCH),
                       tcfg, topology=JTopology(1, 4, 2),
                       controller_cfg=JControllerConfig(
                           scheduler_timer=2, threshold=0.0, min_dwell=0),
                       log=lambda s: None)
    if params is not None:
        trainer.params = jax.device_put(params, trainer.psh)
        trainer.opt_state = jax.device_put(
            j_init_opt_state(trainer.params), trainer.osh)
    params0 = jax.tree.map(np.array, trainer.params)
    out = trainer.run()
    return params0, out


@pytest.fixture(scope="module")
def jax_run(tmp_path_factory):
    return _jax_trainer_run(tmp_path_factory.mktemp("jax_trainer"), ARCH)


def _matches_jax_trainer(arch, jax_out, tmp_path):
    params0, jout = jax_out
    cfg = t_reduced(T_REGISTRY[arch])
    trainer = t_trainer(cfg, corpus_files(tmp_path, cfg.vocab),
                        tmp_path / "ckpt", from_reference(params0, "cpu"),
                        topology=ChipletTopology(1, 4, 2),
                        controller_cfg=ControllerConfig(
                            scheduler_timer=2, threshold=0.0, min_dwell=0))
    out = trainer.run()
    np.testing.assert_allclose(out["losses"], jout["losses"], rtol=1e-4,
                               atol=1e-4)
    assert out["steps"] == jout["steps"] == 4
    assert out["counters"] == jout["counters"]
    assert out["counters"]["relayouts"] >= 1
    assert CheckpointManager(str(tmp_path / "ckpt")).latest() == 4


def test_trainer_matches_jax_trainer(jax_run, tmp_path):
    _matches_jax_trainer(ARCH, jax_run, tmp_path)


def test_ssm_trainer_matches_jax_trainer(tmp_path_factory, tmp_path):
    """The same on reduced mamba2-780m: the SSD kernel's route (its plain
    version here) against the JAX Trainer's jnp SSD."""
    ssm = "mamba2-780m"
    _matches_jax_trainer(ssm, _jax_trainer_run(
        tmp_path_factory.mktemp("jax_ssm_trainer"), ssm), tmp_path)


def test_hybrid_trainer_matches_jax_trainer(tmp_path_factory, tmp_path):
    """The same on reduced recurrentgemma-9b: groups and tail, the RG-LRU
    scan's route (its plain version here) and the windowed attention
    against the JAX Trainer's jnp routes."""
    hybrid = "recurrentgemma-9b"
    _matches_jax_trainer(hybrid, _jax_trainer_run(
        tmp_path_factory.mktemp("jax_hybrid_trainer"), hybrid), tmp_path)


@pytest.mark.parametrize("arch", [ARCH, "mamba2-780m", "recurrentgemma-9b"])
def test_resume_continues_with_the_same_losses(tmp_path, arch):
    """6 steps with a checkpoint every 3; a fresh Trainer resumed from step
    3 (the step-6 checkpoint removed) gives the same losses for 4-6."""
    cfg = t_reduced(T_REGISTRY[arch])
    files = corpus_files(tmp_path, cfg.vocab)
    first = t_trainer(cfg, files, tmp_path / "ckpt", None, steps=6,
                      ckpt_every=3)
    losses = first.run()["losses"]
    assert first.ckpt.steps() == [3, 6]
    shutil.rmtree(first.ckpt._step_dir(6))
    fresh = t_trainer(cfg, files, tmp_path / "ckpt", None, steps=6)
    assert fresh.resume_if_possible() and fresh.step == 3
    again = fresh.run()["losses"]
    np.testing.assert_allclose(again, losses[3:], rtol=1e-6, atol=1e-6)
    assert int(fresh.opt_state["count"]) == 6


def test_failure_injection_and_resume(tmp_path):
    from repro_torch.runtime.failure import FailureInjector, SimulatedFailure
    cfg = t_reduced(T_REGISTRY[ARCH])
    files = corpus_files(tmp_path, cfg.vocab)
    trainer = t_trainer(cfg, files, tmp_path / "ckpt", None, steps=4,
                        ckpt_every=2, failure=FailureInjector(fail_at_step=3))
    with pytest.raises(SimulatedFailure):
        trainer.run()
    fresh = t_trainer(cfg, files, tmp_path / "ckpt", None, steps=4)
    assert fresh.resume_if_possible() and fresh.step == 2
    assert len(fresh.run()["losses"]) == 2


def small_state(seed):
    """A params/opt tree with bf16, f32 and int32 leaves, as numpy."""
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)
    return {"params": {"embed": f(16, 8), "layers": {"w": f(2, 8, 4)}},
            "opt": {"m": {"embed": f(16, 8)}, "count": np.int32(5)}}


def to_jax_tree(tree):
    out = jax.tree.map(jnp.asarray, tree)
    out["params"]["layers"]["w"] = out["params"]["layers"]["w"].astype(
        jnp.bfloat16)
    return out


def to_torch_tree(tree):
    out = from_reference(tree, "cpu")
    out["params"]["layers"]["w"] = out["params"]["layers"]["w"].to(
        torch.bfloat16)
    return out


def leaves_equal(jtree, ttree):
    for jl, tl in zip(jax.tree.leaves(jtree),
                      jax.tree.leaves(jax.tree.map(lambda x: x, ttree))):
        assert str(jl.dtype) == str(tl.dtype).replace("torch.", "")
        np.testing.assert_array_equal(np.asarray(jl, np.float32),
                                      tl.float().numpy())


def test_checkpoint_from_jax_restores_in_the_port(tmp_path):
    jtree = to_jax_tree(small_state(0))
    JCkpt(str(tmp_path)).save(7, jtree, metadata={"loader": {"step": 2}})
    like = jax.tree.map(torch.zeros_like, to_torch_tree(small_state(1)))
    restored, meta = CheckpointManager(str(tmp_path)).restore(like)
    assert meta == {"loader": {"step": 2}, "step": 7}
    leaves_equal(jtree, restored)


def test_checkpoint_from_the_port_restores_in_jax(tmp_path):
    ttree = to_torch_tree(small_state(2))
    CheckpointManager(str(tmp_path / "t")).save(7, ttree,
                                                metadata={"x": 1})
    like = jax.tree.map(jnp.zeros_like, to_jax_tree(small_state(3)))
    restored, meta = JCkpt(str(tmp_path / "t")).restore(like)
    assert meta == {"x": 1, "step": 7}
    leaves_equal(restored, ttree)
    # the same tree written by JAX gives the same files and manifest
    JCkpt(str(tmp_path / "j")).save(7, to_jax_tree(small_state(2)),
                                    metadata={"x": 1})
    tdir, jdir = (str(tmp_path / d / "step_00000007") for d in "tj")
    assert sorted(os.listdir(tdir)) == sorted(os.listdir(jdir))
    for name in os.listdir(jdir):
        with open(os.path.join(tdir, name), "rb") as a, \
                open(os.path.join(jdir, name), "rb") as b:
            assert a.read() == b.read(), name


def test_trainer_state_round_trips_through_jax_checkpoint(jax_run,
                                                          tmp_path):
    """A whole training state (params + AdamW state) written by the port's
    Trainer restores into the JAX Trainer's tree structure and back."""
    params0, _ = jax_run
    cfg = t_reduced(T_REGISTRY[ARCH])
    trainer = t_trainer(cfg, corpus_files(tmp_path, cfg.vocab),
                        tmp_path / "ckpt", from_reference(params0, "cpu"),
                        steps=2, ckpt_every=2)
    trainer.run()
    like = {"params": jax.tree.map(jnp.asarray, params0),
            "opt": {"m": jax.tree.map(jnp.asarray, params0),
                    "v": jax.tree.map(jnp.asarray, params0),
                    "count": jnp.zeros((), jnp.int32)}}
    jstate, meta = JCkpt(str(tmp_path / "ckpt")).restore(like)
    assert meta["step"] == 2 and int(jstate["opt"]["count"]) == 2
    leaves_equal(jstate["params"], trainer.params)
    leaves_equal(jstate["opt"]["v"], trainer.opt_state["v"])


# ---------------------------------------------------------------------------
# copies of test_substrates.py, on the port's modules
# ---------------------------------------------------------------------------

def test_lr_schedule_shape():
    cfg = AdamWConfig(peak_lr=1.0, warmup_steps=10, total_steps=100,
                      min_lr_frac=0.1)
    assert lr_schedule(cfg, 0) == 0.0
    assert lr_schedule(cfg, 10) == pytest.approx(1.0)
    assert lr_schedule(cfg, 100) == pytest.approx(0.1)


def test_corpus_deterministic_and_equal_to_jax():
    c1 = SyntheticCorpus(1000, seed=7)
    c2 = SyntheticCorpus(1000, seed=7)
    np.testing.assert_array_equal(c1.shard_tokens(3, 1000),
                                  c2.shard_tokens(3, 1000))
    assert not np.array_equal(c1.shard_tokens(3, 1000),
                              c1.shard_tokens(4, 1000))
    np.testing.assert_array_equal(c1.shard_tokens(3, 1000),
                                  JCorpus(1000, seed=7).shard_tokens(3, 1000))


def test_loader_sharding_and_resume(tmp_path):
    corpus = SyntheticCorpus(512, seed=1)
    files = write_corpus_shards(str(tmp_path), corpus, n_shards=4,
                                tokens_per_shard=4000)
    l_all = ShardedLoader(files, seq_len=16, batch=2)
    b1 = l_all.next()
    b2 = l_all.next()
    assert b1.shape == (2, 17)
    assert not np.array_equal(b1, b2)
    state = l_all.state_dict()
    b3 = l_all.next()
    l_resumed = ShardedLoader(files, seq_len=16, batch=2)
    l_resumed.load_state_dict(state)
    np.testing.assert_array_equal(b3, l_resumed.next())
    h0 = ShardedLoader(files, host=0, n_hosts=2, seq_len=16, batch=2)
    h1 = ShardedLoader(files, host=1, n_hosts=2, seq_len=16, batch=2)
    assert not np.array_equal(h0.next(), h1.next())
    # the JAX loader reads the same blocks from the same files
    j = JLoader(files, seq_len=16, batch=2)
    np.testing.assert_array_equal(j.next(), b1)


def test_make_batch_dense_and_unported_families():
    """Every family's batch equals the JAX package's key by key, element
    for element: the dense one; the VLM's text tokens, patch embeddings
    (a quarter of the sequence) and M-RoPE ids; the encoder-decoder's
    frame embeddings and target half."""
    block = np.random.default_rng(0).integers(
        0, 512, size=(2, 33)).astype(np.int32)
    for name in ("llama3-8b", "qwen2-vl-2b", "seamless-m4t-large-v2"):
        cfg = t_reduced(T_REGISTRY[name])
        b = make_batch(cfg, block)
        want = j_make_batch(reduced_config(REGISTRY[name]), block)
        assert b.keys() == want.keys(), name
        for k in want:
            assert b[k].dtype == want[k].dtype, (name, k)
            np.testing.assert_array_equal(b[k], want[k], err_msg=name)
        assert b["tokens"].dtype == np.int32
        assert b["targets"].shape == b["mask"].shape


def test_checkpoint_roundtrip(tmp_path):
    tree = {"a": torch.arange(12.0).reshape(3, 4),
            "b": {"c": torch.ones((2,), dtype=torch.bfloat16)}}
    save_pytree(str(tmp_path / "ck"), tree, metadata={"step": 3})
    like = jax.tree.map(torch.zeros_like, tree)
    out, meta = load_pytree(str(tmp_path / "ck"), like)
    assert meta["step"] == 3
    assert out["b"]["c"].dtype == torch.bfloat16
    for a, b in zip(jax.tree.leaves(tree), jax.tree.leaves(out)):
        np.testing.assert_array_equal(a.float().numpy(), b.float().numpy())


def test_checkpoint_manager_gc_and_latest(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=2)
    for s in (1, 2, 3):
        mgr.save(s, {"x": torch.full((2,), float(s))})
    assert mgr.latest() == 3
    assert mgr.steps() == [2, 3]          # gc dropped step 1
    out, meta = mgr.restore({"x": torch.zeros((2,))})
    assert meta["step"] == 3 and float(out["x"][0]) == 3.0


def test_checkpoint_async(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=2)
    mgr.save(1, {"x": torch.ones((4,))}, blocking=False)
    mgr.wait()
    assert mgr.latest() == 1
    with open(tmp_path / "step_00000001" / "manifest.json") as f:
        assert json.load(f)["leaves"][0]["dtype"] == "float32"


def test_straggler_detector():
    det = StragglerDetector(factor=2.0, min_samples=3)
    for _ in range(6):
        det.observe(0.1)
    assert det.observe(0.5) is True
    assert det.observe(0.1) is False
    assert len(det.events) == 1


def test_heartbeat_monitor():
    t = [0.0]
    clock = lambda: t[0]
    dead = []
    mon = HeartbeatMonitor([0, 1], timeout=1.0, on_dead=dead.append,
                           clock=clock)
    t[0] = 0.5
    mon.beat(0)
    t[0] = 1.2
    assert mon.check() == [1]
    assert dead == [1]
    t[0] = 1.9
    assert mon.check() == [0]


def test_compress_cross_pod_raises(tmp_path):
    """``compress_cross_pod`` no longer raises: the Trainer threads float32
    error-feedback buffers shaped like the parameters through its steps
    (held against the JAX Trainer in ``test_torch_grad_compress.py``).  A
    mesh of several ranks without a process group still raises."""
    from repro_torch.launch.mesh import Mesh
    cfg = t_reduced(T_REGISTRY[ARCH])
    files = corpus_files(tmp_path, cfg.vocab)
    tcfg = TrainerConfig(steps=1, ckpt_every=100, log_every=100,
                         ckpt_dir=str(tmp_path / "ckpt"),
                         compress_cross_pod=True)
    trainer = Trainer(cfg, ShardedLoader(files, seq_len=SEQ, batch=BATCH),
                      tcfg, log=lambda s: None, device="cpu")
    assert trainer._ef["embed"].dtype == torch.float32
    assert trainer._ef["embed"].shape == trainer.params["embed"].shape
    assert np.isfinite(trainer.run()["losses"]).all()
    assert float(trainer._ef["embed"].abs().max()) > 0
    with pytest.raises(RuntimeError, match="process group"):
        Trainer(cfg, None, tcfg, mesh=Mesh(np.arange(2).reshape(2, 1),
                                           ("data", "model")), device="cpu")
