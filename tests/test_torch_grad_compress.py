"""The port's error-feedback gradient compression
(``compression/grad_compress.py``) against the JAX package's on the CPU:
the int8 and top-k transforms on a tree of 1-, 2- and 3-axis leaves with
error feedback carried for 20 steps, rows with ties at the top-k
threshold among them; copies of ``test_substrates.py``'s compression
tests; and the Trainer with ``compress_cross_pod=True`` against the JAX
Trainer on a 1 x 1 mesh.

Tolerances: the transforms' compressed gradients and error-feedback
buffers within 1e-6 (the same float32 operations; top-k keeps exactly the
same entries); Trainer losses within 1e-4 and counters equal, as
``test_torch_trainer.py``."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from repro.compression import grad_compress as JC
from repro.configs import REGISTRY, reduced_config
from repro.data.pipeline import ShardedLoader as JLoader
from repro.optim.adamw import AdamWConfig as JAdamW
from repro.optim.adamw import init_opt_state as j_init_opt_state
from repro.runtime.trainer import Trainer as JTrainer
from repro.runtime.trainer import TrainerConfig as JTrainerConfig
from repro_torch.compression import (CompressionState,
                                     compressed_bytes_per_row,
                                     init_compression,
                                     int8_compress_transform,
                                     topk_compress_transform)
from repro_torch.configs import REGISTRY as T_REGISTRY
from repro_torch.configs import reduced_config as t_reduced
from repro_torch.data.pipeline import (ShardedLoader, SyntheticCorpus,
                                       write_corpus_shards)
from repro_torch.models.params import init_params, tree_map
from repro_torch.optim.adamw import AdamWConfig, adamw_update, init_opt_state
from repro_torch.runtime.trainer import Trainer, TrainerConfig


def grad_tree(rng):
    """Leaves of 1, 2 and 3 axes; the 2-axis leaf's first rows hold ties
    at the top-k threshold (k = 2 of 8 at frac 0.25)."""
    g = {"b": rng.standard_normal(24), "w": rng.standard_normal((6, 8)),
         "layers": {"x": rng.standard_normal((2, 5, 16))}}
    g["w"][0] = [3.0, -3.0, 3.0, 1.0, 0.5, -0.1, 0.0, 2.0]   # 3 at |3|
    g["w"][1] = [1.0, 1.0, 1.0, 1.0, 1.0, 1.0, 1.0, 1.0]     # all tie
    return tree_map(lambda x: x.astype(np.float32), g)


TRANSFORMS = {
    "int8": (JC.int8_compress_transform, int8_compress_transform),
    "topk": (lambda g, e: JC.topk_compress_transform(g, e, frac=0.25),
             lambda g, e: topk_compress_transform(g, e, frac=0.25)),
}


@pytest.mark.parametrize("name", sorted(TRANSFORMS))
def test_transforms_match_jax(name):
    """20 steps of seeded gradients with the error feedback carried in
    each package: every compressed gradient and buffer agrees."""
    jt, tt = TRANSFORMS[name]
    rng = np.random.default_rng(0)
    g0 = grad_tree(rng)
    jef = JC.init_compression(jax.tree.map(jnp.asarray, g0))["ef"]
    tef = init_compression(tree_map(torch.from_numpy, g0))["ef"]
    for step in range(20):
        g = g0 if step == 0 else grad_tree(rng)
        jg, jef = jt(jax.tree.map(jnp.asarray, g), jef)
        tg, tef = tt(tree_map(torch.from_numpy, g), tef)
        for a, b in zip(jax.tree.leaves(jg), jax.tree.leaves(tg)):
            np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=0,
                                       atol=1e-6)
        for a, b in zip(jax.tree.leaves(jef), jax.tree.leaves(tef)):
            np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=0,
                                       atol=1e-6)
        if name == "topk" and step == 0:
            # ties keep more than k: 3 of row 0, all 8 of row 1
            assert int((tg["w"][0] != 0).sum()) == 3
            assert int((tg["w"][1] != 0).sum()) == 8


def test_bf16_gradients_keep_their_type():
    g = {"w": torch.randn(4, 8, generator=torch.Generator().manual_seed(1))
         .to(torch.bfloat16)}
    ef = init_compression(g)["ef"]
    out, ef2 = int8_compress_transform(g, ef)
    assert out["w"].dtype == torch.bfloat16 and ef2["w"].dtype == torch.float32
    assert CompressionState.init(g).ef["w"].shape == (4, 8)
    assert compressed_bytes_per_row(8) == 12


def test_int8_error_feedback_unbiased():
    """With EF, the accumulated compressed signal converges to the truth."""
    g_true = {"w": torch.tensor([[0.3, -0.001, 0.7, 0.0002]] * 2)}
    ef = init_compression(g_true)["ef"]
    acc = torch.zeros_like(g_true["w"])
    for _ in range(50):
        gq, ef = int8_compress_transform(g_true, ef)
        acc = acc + gq["w"]
    np.testing.assert_allclose((acc / 50).numpy(), g_true["w"].numpy(),
                               rtol=0.02, atol=1e-4)


def test_topk_keeps_largest():
    g = {"w": torch.tensor([[1.0, 0.1, -2.0, 0.01]])}
    ef = init_compression(g)["ef"]
    gq, ef = topk_compress_transform(g, ef, frac=0.5)
    w = gq["w"][0].numpy()
    assert w[2] == -2.0 and w[0] == 1.0
    assert w[1] == 0.0 and w[3] == 0.0
    # EF holds the dropped mass
    np.testing.assert_allclose(ef["w"][0].numpy(), [0.0, 0.1, 0.0, 0.01],
                               atol=1e-7)


def test_compression_training_converges():
    """int8+EF compressed training reaches ~uncompressed loss."""
    gen = torch.Generator().manual_seed(5)
    w_true = torch.randn(8, 4, generator=gen)
    x = torch.randn(32, 8, generator=gen)
    y = x @ w_true
    w0 = torch.randn(8, 4, generator=gen) * 0.1
    loss = lambda w: ((x @ w - y) ** 2).mean()
    cfg = AdamWConfig(peak_lr=0.05, warmup_steps=5, weight_decay=0.0)

    def train(compressed):
        p = {"w": w0.clone()}
        s = init_opt_state(p)
        ef = init_compression(p)["ef"]
        for _ in range(80):
            w = p["w"].detach().requires_grad_(True)
            loss(w).backward()
            g = {"w": w.grad}
            if compressed:
                g, ef = int8_compress_transform(g, ef)
            adamw_update(g, s, p, cfg)
        return float(loss(p["w"]))

    lc, lu = train(True), train(False)
    assert lc < max(3.0 * lu, 1e-3)


OPT = dict(peak_lr=1e-3, warmup_steps=2, total_steps=20)


def test_compressed_trainer_matches_jax_trainer(tmp_path):
    """``Trainer(compress_cross_pod=True)`` (the int8 error-feedback state
    threaded through the step) against the JAX Trainer on a 1 x 1 mesh,
    from the same weights and corpus: losses and counters."""
    arch = "llama3.2-3b"
    jcfg, tcfg = reduced_config(REGISTRY[arch]), t_reduced(T_REGISTRY[arch])
    files = write_corpus_shards(str(tmp_path / "data"),
                                SyntheticCorpus(tcfg.vocab, seed=3),
                                n_shards=2, tokens_per_shard=4000)
    params = init_params(tcfg, torch.Generator().manual_seed(5),
                         device="cpu")
    mesh = Mesh(np.array(jax.devices()[:1]).reshape(1, 1),
                ("data", "model"))

    class OneDevice(JTrainer):
        """One device moves no collective bytes: the HLO feed is zero
        (the port's counters say the same), so skip its second compile."""

        def _compile_step(self, mesh):
            super()._compile_step(mesh)
            self._hlo_bytes = {"remote": 0.0, "local": 0.0}

    jt = OneDevice(jcfg, mesh, JLoader(files, seq_len=32, batch=2),
                  JTrainerConfig(steps=4, ckpt_every=100, log_every=100,
                                 ckpt_dir=str(tmp_path / "jckpt"),
                                 opt=JAdamW(**OPT), compress_cross_pod=True),
                  log=lambda s: None)
    jt.params = jax.device_put(jax.tree.map(
        lambda t: jnp.asarray(t.numpy().copy()), params), jt.psh)
    jt.opt_state = jax.device_put(j_init_opt_state(jt.params), jt.osh)
    jout = jt.run()
    tt = Trainer(tcfg, ShardedLoader(files, seq_len=32, batch=2),
                 TrainerConfig(steps=4, ckpt_every=100, log_every=100,
                               ckpt_dir=str(tmp_path / "tckpt"),
                               opt=AdamWConfig(**OPT),
                               compress_cross_pod=True),
                 log=lambda s: None, params=tree_map(torch.clone, params),
                 device="cpu")
    tout = tt.run()
    np.testing.assert_allclose(tout["losses"], jout["losses"], rtol=1e-4,
                               atol=1e-4)
    assert tout["counters"] == jout["counters"]
    # the error feedback moved: non-zero residuals after 4 steps (the
    # residuals themselves are not compared: a gradient that differs in
    # its last bits may round to the next int8 level and move its entry's
    # residual by a whole unit)
    assert all(float(e.abs().max()) > 0 for e in jax.tree.leaves(tt._ef))
