"""The port's sharding rules, meshes and elastic helpers against the JAX
package's, spec for spec, in one process: every config of the registry at
full size on the production meshes (16, 16) and (2, 16, 16) and on
``Layout(ChipletTopology(1, 4, 2), s).make_mesh()`` for s = 1, 2, 4, with
FSDP on and off, float32 and 8-bit moments, every shape's batch specs and
the decode caches' specs.  The JAX spec functions read only a mesh's
``shape`` and ``axis_names``, so a stub stands in for a JAX mesh here;
``make_production_mesh`` and ``degraded_mesh`` run in a JAX subprocess of
512 forced host devices.  Reshard-on-load as ``test_substrates.py``'s
``test_elastic_reshard_on_load``, on a one-rank mesh (the multi-rank
restores are in ``test_torch_distributed.py``)."""
import dataclasses
import os
import subprocess
import sys
import textwrap

import jax
import numpy as np
import pytest
import torch

from repro.configs import REGISTRY, SHAPES
from repro.launch import sharding as JS
from repro.models.decode import abstract_cache
from repro.optim.adamw import init_opt_state as j_init_opt
from repro.optim.quantized import init_opt_state_8bit as j_init_opt8
from repro.runtime.elastic import rebatch_for as j_rebatch_for
from repro.models.params import abstract_params
from repro_torch.checkpoint.manager import load_pytree, save_pytree
from repro_torch.configs import REGISTRY as T_REGISTRY
from repro_torch.configs import SHAPES as T_SHAPES
from repro_torch.core.layout import Layout
from repro_torch.core.topology import ChipletTopology
from repro_torch.launch import mesh as TM
from repro_torch.launch import sharding as TSH
from repro_torch.runtime.elastic import degraded_mesh, rebatch_for

SRC = os.path.join(os.path.dirname(__file__), "..", "src")


@dataclasses.dataclass
class StubMesh:
    """What the JAX spec functions read of a mesh."""
    shape: dict
    axis_names: tuple


def meshes():
    """(name, port Mesh) of every mesh the specs are held on."""
    out = [("prod", TM.make_production_mesh()),
           ("prod_multi_pod", TM.make_production_mesh(multi_pod=True))]
    topo = ChipletTopology(1, 4, 2)
    out += [(f"layout_s{s}", Layout(topo, s).make_mesh()) for s in (1, 2, 4)]
    return out


MESHES = meshes()


def stub(mesh):
    return StubMesh(dict(mesh.shape), mesh.axis_names)


def specs_equal(jtree, ttree):
    """Every JAX PartitionSpec equals the port's, entry for entry."""
    jl = jax.tree.leaves(jtree, is_leaf=lambda x: isinstance(
        x, jax.sharding.PartitionSpec))
    tl = jax.tree.leaves(ttree, is_leaf=lambda x: isinstance(
        x, TSH.PartitionSpec))
    assert len(jl) == len(tl) > 0
    for a, b in zip(jl, tl):
        assert isinstance(b, TSH.PartitionSpec)
        assert tuple(a) == tuple(b), (a, b)


@pytest.mark.parametrize("arch", sorted(REGISTRY))
def test_param_and_opt_specs_match(arch):
    cfg, tcfg = REGISTRY[arch], T_REGISTRY[arch]
    aparams = abstract_params(cfg)
    aopt = jax.eval_shape(j_init_opt, aparams)
    aopt8 = jax.eval_shape(j_init_opt8, aparams)
    t_opt = {"m": {"x": torch.zeros(1)}}
    t_opt8 = {"m": {"x": {"q": 0, "scale": 0}}}
    for _, mesh in MESHES:
        jm = stub(mesh)
        assert JS.axis_rules(cfg, jm, fsdp=True) == \
            TSH.axis_rules(tcfg, mesh, fsdp=True)
        for fsdp in (False, True):
            jp = JS.param_specs(cfg, jm, fsdp=fsdp)
            tp = TSH.param_specs(tcfg, mesh, fsdp=fsdp)
            specs_equal(jp, tp)
            for zero in (True, False):
                specs_equal(JS.opt_specs(cfg, jm, jp, zero=zero),
                            TSH.opt_specs(tcfg, mesh, tp, zero=zero))
            specs_equal(JS.opt_specs_for(cfg, jm, jp, aopt),
                        TSH.opt_specs_for(tcfg, mesh, tp, t_opt))
            specs_equal(JS.opt_specs_for(cfg, jm, jp, aopt8),
                        TSH.opt_specs_for(tcfg, mesh, tp, t_opt8))
        specs_equal(JS.gather_specs(cfg, jm), TSH.gather_specs(tcfg, mesh))
        for shape in SHAPES.values():
            specs_equal(JS.batch_specs(cfg, shape, jm),
                        TSH.batch_specs(tcfg, T_SHAPES[shape.name], mesh))
            assert JS.needs_fsdp(cfg, shape, mesh.size, mesh.shape["model"]) \
                == TSH.needs_fsdp(tcfg, T_SHAPES[shape.name], mesh.size,
                                  mesh.shape["model"])


@pytest.mark.parametrize("arch", sorted(REGISTRY))
def test_cache_specs_match(arch):
    """The decode cache's specs (JAX's abstract cache tree, which both
    read by shape only) at 128 streams of 4096 tokens."""
    cfg, tcfg = REGISTRY[arch], T_REGISTRY[arch]
    cache = abstract_cache(cfg, 128, 4096,
                           src_len=512 if cfg.family == "encdec" else 0)
    for _, mesh in MESHES:
        specs_equal(JS.cache_specs(cfg, stub(mesh), cache),
                    TSH.cache_specs(tcfg, mesh, cache))


def test_named_and_mesh_helpers():
    mesh = TM.make_production_mesh(multi_pod=True)
    assert mesh.shape == {"pod": 2, "data": 16, "model": 16}
    assert mesh.size == 512
    assert TM.batch_axes(mesh) == ("pod", "data")
    assert TM.model_axis_size(mesh) == 16 and TM.data_axis_size(mesh) == 32
    cfg = T_REGISTRY["llama3-8b"]
    pspecs = TSH.param_specs(cfg, mesh)
    named = TSH.named(mesh, pspecs)
    assert named["embed"] == TSH.NamedSharding(mesh, pspecs["embed"])
    assert mesh.classify([0, 1]) == "intra_group"
    assert mesh.classify([0, 16]) == "intra_pod"
    assert mesh.classify([0, 256]) == "cross_pod"
    # a tuple of one axis is that axis, as in JAX
    assert TSH.P(("data",), None) == ("data", None)


def test_mesh_collectives_of_one_rank():
    """A one-rank mesh needs no process group: its collectives return
    their inputs and count no bytes."""
    mesh = TM.Mesh(np.array([[0]]), ("data", "model"))
    comm = mesh.comm()
    t = torch.arange(6.0).reshape(2, 3)
    assert torch.equal(comm.all_reduce(t.clone(), ("data", "model")), t)
    assert torch.equal(comm.all_gather(t, ("model",), 1), t)
    assert comm.bytes == {}
    with pytest.raises(RuntimeError, match="process group"):
        TM.Mesh(np.arange(8).reshape(4, 2), ("data", "model")).comm()


class FakeComm:
    """The coordinates of one rank of a described mesh."""

    def __init__(self, mesh, rank):
        self.mesh, self.coords = mesh, mesh.coords(rank)

    def index(self, axes):
        i = 0
        for a in axes:
            i = i * self.mesh.shape[a] + self.coords[a]
        return i


def test_local_slices_tile_the_leaf():
    """Every rank's slice under a spec, over all ranks of a (pod 2, data
    2, model 2) mesh, covers the leaf exactly as often as the spec
    replicates it."""
    mesh = TM.Mesh(np.arange(8).reshape(2, 2, 2), ("pod", "data", "model"))
    shape = (8, 6, 4)
    for spec, copies in [(TSH.P(("pod", "data"), None, "model"), 1),
                         (TSH.P(None, "model"), 4),
                         (TSH.P("data", None, None), 4), (TSH.P(), 8)]:
        seen = np.zeros(shape, np.int64)
        for r in range(8):
            sl = TSH.local_slices(shape, spec, FakeComm(mesh, r))
            seen[sl] += 1
            assert seen[sl].shape == TSH.local_shape(shape, spec, mesh)
        assert (seen == copies).all(), spec
    with pytest.raises(ValueError, match="does not divide"):
        TSH.local_shape((6, 3), TSH.P(None, "model"), TM.Mesh(
            np.arange(4).reshape(1, 4), ("data", "model")))


def test_production_and_degraded_meshes_match_jax():
    """``make_production_mesh`` and ``degraded_mesh`` against the JAX
    package's on 512 forced host devices: the same axes, shapes and
    device ids (the port's ranks); ``rebatch_for`` against JAX's."""
    code = """
        import jax, json
        from repro.launch.mesh import make_production_mesh
        from repro.runtime.elastic import degraded_mesh
        out = {}
        for mp in (False, True):
            m = make_production_mesh(multi_pod=mp)
            out[str(mp)] = [list(m.axis_names),
                            [[d.id for d in row] for row in
                             m.devices.reshape(-1, 16)]]
        m, kept = degraded_mesh((16, 16), failed_rows=[3, 7])
        out["degraded"] = [list(m.axis_names), kept,
                           [[d.id for d in row] for row in m.devices]]
        print(json.dumps(out))
    """
    env = dict(os.environ, PYTHONPATH=SRC, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=512")
    res = subprocess.run([sys.executable, "-c", textwrap.dedent(code)],
                         capture_output=True, text=True, env=env, timeout=300)
    assert res.returncode == 0, res.stderr[-4000:]
    import json
    ref = json.loads(res.stdout.strip().splitlines()[-1])
    for mp in (False, True):
        m = TM.make_production_mesh(multi_pod=mp)
        axes, ids = ref[str(mp)]
        assert list(m.axis_names) == axes
        np.testing.assert_array_equal(
            m.devices.reshape(-1, 16).astype(np.int64), np.array(ids))
    m, kept = degraded_mesh((16, 16), failed_rows=[3, 7])
    axes, jkept, ids = ref["degraded"]
    assert list(m.axis_names) == axes and kept == jkept
    assert m.shape == {"data": 14, "model": 16}
    np.testing.assert_array_equal(m.devices.astype(np.int64), np.array(ids))
    for gb, shards in [(256, 15), (7, 8), (256, 16), (100, 14)]:
        assert rebatch_for(gb, shards) == j_rebatch_for(gb, shards)


def test_degraded_mesh_and_rebatch():
    """A copy of ``test_substrates.py``'s test on the port."""
    mesh, kept = degraded_mesh((1, 1), failed_rows=[])
    assert mesh.shape["data"] == 1
    assert rebatch_for(256, 15) == 255
    assert rebatch_for(7, 8) == 8


def test_elastic_reshard_on_load(tmp_path):
    """A checkpoint saved whole restores onto a target sharding: on a
    one-rank mesh the slice is the whole leaf."""
    tree = {"w": torch.arange(16.0).reshape(4, 4)}
    save_pytree(str(tmp_path / "ck"), tree)
    mesh = TM.Mesh(np.array([[0]]), ("data", "model"))
    shd = {"w": TSH.NamedSharding(mesh, TSH.P(None, "model"))}
    out, _ = load_pytree(str(tmp_path / "ck"), tree, shardings=shd)
    assert torch.equal(out["w"], tree["w"])


@pytest.mark.parametrize("arch", ["llama3-8b", "recurrentgemma-9b",
                                  "seamless-m4t-large-v2"])
def test_loss_fn_gather_specs_hook(arch):
    """``loss_fn(..., gather_specs=)``: spec leaves (no mesh to gather
    over) give the loss without them, bit for bit; callable leaves run on
    every leaf of every stacked layer (the hybrid's groups, the
    encoder-decoder's two stacks) as its layer runs, as the JAX forward
    constrains them."""
    from repro_torch.configs import reduced_config
    from repro_torch.data.pipeline import make_batch
    from repro_torch.models import transformer as T
    from repro_torch.models.params import init_params
    cfg = reduced_config(T_REGISTRY[arch])
    block = np.random.default_rng(0).integers(
        2, cfg.vocab, size=(2, 33)).astype(np.int32)
    batch = {k: torch.from_numpy(v) for k, v in make_batch(cfg, block).items()}
    p = init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    gs = TSH.gather_specs(cfg, TM.make_production_mesh())
    calls = []

    def seen(w):
        calls.append(w.shape)
        return w

    called = {k: jax.tree.map(lambda s: seen, v, is_leaf=lambda x: isinstance(
        x, TSH.PartitionSpec)) for k, v in gs.items()}
    with torch.no_grad():
        plain = T.loss_fn(p, cfg, batch)[0]
        hooked = T.loss_fn(p, cfg, batch, gather_specs=gs)[0]
        spied = T.loss_fn(p, cfg, batch, gather_specs=called)[0]
    assert torch.equal(plain, hooked) and torch.equal(plain, spied)
    # a callable runs once for every leaf of every stacked layer
    stacked = [k for k in ("layers", "groups", "enc_layers", "dec_layers")
               if k in p]
    want = sum(len(jax.tree.leaves(p[k])) * jax.tree.leaves(p[k])[0].shape[0]
               for k in stacked)
    assert len(calls) == want > 0
