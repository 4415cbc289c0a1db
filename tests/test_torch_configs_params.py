"""The port's configs and parameter trees against the JAX package.

Every architecture's config (full and reduced) equals the JAX package's
field by field; for every family the port's parameter tree has the JAX
tree's paths, shapes and dtype, ``from_reference`` carries JAX weights
across exactly, and the constant leaves (zeros, ones, ``const:<v>``) hold
the JAX package's values."""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.configs import REGISTRY, SHAPES, reduced_config
from repro.models import params as JP
from repro_torch.configs import REGISTRY as T_REGISTRY
from repro_torch.configs import SHAPES as T_SHAPES
from repro_torch.configs import reduced_config as t_reduced
from repro_torch.models import params as TP

ARCHS = sorted(REGISTRY)


def _jax_shapes(cfg):
    leaves, _ = jax.tree_util.tree_flatten_with_path(
        JP.model_def(cfg), is_leaf=lambda x: isinstance(x, JP.ParamDef))
    return {tuple(k.key for k in path): p.shape for path, p in leaves}


def test_registry_and_shapes_match():
    assert sorted(T_REGISTRY) == ARCHS
    assert {k: dataclasses.asdict(v) for k, v in T_SHAPES.items()} == \
        {k: dataclasses.asdict(v) for k, v in SHAPES.items()}


@pytest.mark.parametrize("arch", ARCHS)
def test_config_fields_match(arch):
    for j, t in ((REGISTRY[arch], T_REGISTRY[arch]),
                 (reduced_config(REGISTRY[arch]),
                  t_reduced(T_REGISTRY[arch]))):
        assert dataclasses.asdict(t) == dataclasses.asdict(j)
        assert t.vocab_padded == j.vocab_padded
        assert t.layer_types() == j.layer_types()


@pytest.mark.parametrize("arch", ARCHS)
def test_param_tree_or_not_ported(arch):
    """Every family, the VLM and encoder-decoder ones among them: same
    paths and shapes as ``repro.models.params`` at full size, same bytes
    and count (qwen2-vl-2b 1,543,853,568 parameters, seamless-m4t-large-v2
    1,632,233,472)."""
    cfg = T_REGISTRY[arch]
    assert TP.param_shapes(cfg) == _jax_shapes(REGISTRY[arch])
    assert TP.param_bytes(cfg) == JP.param_bytes(REGISTRY[arch])
    assert TP.n_params(cfg) == JP.n_params(REGISTRY[arch])


@pytest.mark.parametrize("arch", ARCHS)
def test_init_and_from_reference(arch):
    """Reduced size: ``init_params`` fills every leaf of the JAX tree's
    shape in the config's dtype, seeded (same seed, same weights), and
    ``from_reference`` of the JAX weights is exact leaf by leaf."""
    jcfg, tcfg = reduced_config(REGISTRY[arch]), t_reduced(T_REGISTRY[arch])
    jp = jax.tree.map(np.asarray, JP.init_params(jcfg, jax.random.PRNGKey(0)))
    tp = TP.from_reference(jp, device="cpu")
    flat_j = dict(jax.tree_util.tree_flatten_with_path(jp)[0])
    flat_j = {tuple(k.key for k in path): v for path, v in flat_j.items()}

    def flat(tree, prefix=()):
        for k, v in tree.items():
            if isinstance(v, dict):
                yield from flat(v, prefix + (k,))
            else:
                yield prefix + (k,), v

    got = dict(flat(tp))
    assert set(got) == set(flat_j)
    for path, v in got.items():
        np.testing.assert_array_equal(v.float().numpy(),
                                      np.asarray(flat_j[path], np.float32),
                                      err_msg=str(path))
    g = torch.Generator().manual_seed(3)
    a = TP.init_params(tcfg, g, device="cpu")
    b = TP.init_params(tcfg, torch.Generator().manual_seed(3), device="cpu")
    dtype = TP.torch_dtype(tcfg.param_dtype)
    for (path, x), (_, y) in zip(flat(a), flat(b)):
        assert tuple(x.shape) == flat_j[path].shape, path
        assert x.dtype == dtype and torch.equal(x, y), path
        assert torch.isfinite(x.float()).all(), path
    defs = dict(flat(TP.model_def(tcfg)))
    for path, x in flat(a):
        if TP._const(defs[path].init) is not None:
            np.testing.assert_array_equal(
                x.float().numpy(), np.asarray(flat_j[path], np.float32),
                err_msg=f"constant leaf {path}")
