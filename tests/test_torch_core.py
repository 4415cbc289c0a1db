"""The port's ``core/`` against the JAX package's: the runtime modules are
copies with three changes (``make_mesh`` returns the port's rank
``Mesh``, migration by ``.to(device)`` or onto new shardings, an H100
``HardwareSpec``), so the same inputs must give the
same placements, layouts, controller decisions, cost estimates (priced
with the same hardware constants) and task schedules."""
import dataclasses

import numpy as np
import pytest
import torch

from repro.configs import SHAPES, get_config
from repro.core import controller as JC
from repro.core import costmodel as JM
from repro.core import counters as JN
from repro.core import layout as JL
from repro.core import tasks as JT
from repro.core import topology as JTo
from repro_torch.configs import get_config as t_get_config
from repro_torch.core import controller as TC
from repro_torch.core import costmodel as TM
from repro_torch.core import counters as TN
from repro_torch.core import layout as TL
from repro_torch.core import scheduler as TS
from repro_torch.core import tasks as TT
from repro_torch.core import topology as TTo

TOPOLOGIES = [(1, 16, 16), (2, 16, 16), (1, 4, 2), (2, 2, 1)]


def _topos(n_pods, groups, chips, same_hw=False):
    j = JTo.ChipletTopology(n_pods, groups, chips)
    hw = TTo.HardwareSpec(**dataclasses.asdict(j.hw)) if same_hw \
        else TTo.HardwareSpec()
    return j, TTo.ChipletTopology(n_pods, groups, chips, hw=hw)


def test_hardware_spec_is_the_h100_data_sheet():
    hw = TTo.HardwareSpec()
    assert (hw.peak_flops_bf16, hw.hbm_bw, hw.hbm_bytes) == \
        (989e12, 3.35e12, 80e9)


@pytest.mark.parametrize("chiplets,cores", [(4, 4), (8, 8), (16, 4)])
def test_update_location_matches(chiplets, cores):
    for spread in range(0, chiplets + 2):
        size = max(1, min(spread, chiplets) * cores)
        for rank in range(size):
            kw = dict(chiplets=chiplets, cores_per_chiplet=cores,
                      thread_size=size)
            assert TL.update_location(rank, spread, **kw) == \
                JL.update_location(rank, spread, **kw)


@pytest.mark.parametrize("dims", TOPOLOGIES)
def test_layouts_and_device_grid_match(dims):
    jt, tt = _topos(*dims)
    for pod_axis in (False, True):
        jf = JL.layout_family(jt, pod_axis=pod_axis)
        tf = TL.layout_family(tt, pod_axis=pod_axis)
        assert [l.spread_rate for l in tf] == [l.spread_rate for l in jf]
        for jl, tl in zip(jf, tf):
            for attr in ("replicas", "replicas_per_pod", "model_degree"):
                assert getattr(tl, attr) == getattr(jl, attr), attr
            order = tl.device_order()
            np.testing.assert_array_equal(order, jl.device_order())
            # make_mesh: a Mesh of the same devices in Algorithm 2's
            # order, shaped and named like the JAX mesh (by default the
            # ranks 0 .. total_chips - 1)
            devs = [f"dev{i}" for i in range(tt.total_chips)]
            mesh = tl.make_mesh(devs)
            want = np.asarray(devs, dtype=object)[order]
            if pod_axis:
                want = want.reshape(dims[0], tl.replicas_per_pod,
                                    tl.model_degree)
            assert mesh.devices.shape == want.shape
            assert (mesh.devices == want).all()
            assert mesh.axis_names == (("pod",) if pod_axis else ()) + (
                "data", "model")
            ranks = tl.make_mesh().devices
            assert (ranks == np.arange(tt.total_chips)[order].reshape(
                want.shape)).all()


@pytest.mark.parametrize("arch,shape", [("llama3-8b", "train_4k"),
                                        ("llama3-8b", "decode_32k"),
                                        ("nemotron-4-15b", "prefill_32k"),
                                        ("starcoder2-15b", "decode_32k"),
                                        ("mixtral-8x22b", "train_4k"),
                                        ("grok-1-314b", "decode_32k")])
def test_cost_estimates_match_on_the_same_hardware(arch, shape):
    jt, tt = _topos(1, 16, 16, same_hw=True)
    jcfg, tcfg = get_config(arch), t_get_config(arch)
    jf, tf = JL.layout_family(jt), TL.layout_family(tt)
    for jl, tl in zip(jf, tf):
        assert dataclasses.asdict(TM.estimate(tcfg, SHAPES[shape], tl)) == \
            dataclasses.asdict(JM.estimate(jcfg, SHAPES[shape], jl))
    assert TM.best_layout(tcfg, SHAPES[shape], tf).spread_rate == \
        JM.best_layout(jcfg, SHAPES[shape], jf).spread_rate


def test_cost_estimate_of_unported_family_raises():
    """The estimate prices parameters from the port's own parameter tree,
    which now holds the VLM and encoder-decoder families too: for
    qwen2-vl-2b and seamless-m4t-large-v2, on every shape of ``SHAPES``
    and every layout, equal to the JAX package's."""
    for arch in ("qwen2-vl-2b", "seamless-m4t-large-v2"):
        for shape in SHAPES:
            _estimates_match(arch, shape)


def _estimates_match(arch, shape):
    jt, tt = _topos(1, 16, 16, same_hw=True)
    jcfg, tcfg = get_config(arch), t_get_config(arch)
    jf, tf = JL.layout_family(jt), TL.layout_family(tt)
    for jl, tl in zip(jf, tf):
        assert dataclasses.asdict(TM.estimate(tcfg, SHAPES[shape], tl)) == \
            dataclasses.asdict(JM.estimate(jcfg, SHAPES[shape], jl))
    assert TM.best_layout(tcfg, SHAPES[shape], tf).spread_rate == \
        JM.best_layout(jcfg, SHAPES[shape], jf).spread_rate


@pytest.mark.parametrize("shape", ["train_4k", "prefill_32k", "decode_32k",
                                   "long_500k"])
def test_ssm_cost_estimates_match_on_the_same_hardware(shape):
    """mamba2-780m: the port's estimate, priced from its own SSM parameter
    tree, equals the JAX package's on every layout of the topology."""
    _estimates_match("mamba2-780m", shape)


@pytest.mark.parametrize("shape", ["train_4k", "prefill_32k", "decode_32k",
                                   "long_500k"])
def test_hybrid_cost_estimates_match_on_the_same_hardware(shape):
    """recurrentgemma-9b: the port's estimate, priced from its own hybrid
    parameter tree (groups and tail), equals the JAX package's on every
    layout of the topology."""
    _estimates_match("recurrentgemma-9b", shape)


@pytest.mark.parametrize("rates,start,threshold", [
    ([500] * 6, 1, 300.0), ([1] * 6, 16, 300.0),
    ([150, 50] * 10, 4, 100.0), ([0, 900, 0, 900, 0, 0, 900], 2, 300.0)])
def test_controller_decisions_match(rates, start, threshold):
    history = {}
    for mod_c, mod_n, topo in ((JC, JN, JTo.ChipletTopology()),
                               (TC, TN, TTo.ChipletTopology())):
        ctrl = mod_c.AdaptiveController(
            topo, mod_c.ControllerConfig(scheduler_timer=1,
                                         threshold=threshold, min_dwell=1),
            spread_rate=start)
        cnt = mod_n.PerfCounters()
        for r in rates:
            cnt.add("remote_bytes", r)
            ctrl.maybe_reschedule(cnt)
        history[mod_c] = [dataclasses.astuple(d) for d in ctrl.decisions]
    assert history[TC] == history[JC]
    assert history[TC]


def test_task_schedules_match():
    """The same seeded runtime runs the same tasks in the same order, with
    the same steals."""
    traces, steals = {}, {}
    for mod in (JT, TT):
        rt = mod.TaskRuntime(n_pods=2, groups_per_pod=2, workers_per_group=2,
                             seed=5)
        trace = []

        def job(i, _trace=trace):
            for k in range(i % 4 + 1):
                _trace.append((i, k))
                yield

        for i in range(40):
            rt.spawn(job(i), group=i % 3, priority=i % 2)
        rt.run()
        traces[mod] = trace
        steals[mod] = {k: v for k, v in rt.counters.totals.items()
                       if k.startswith("steals")}
    assert traces[TT] == traces[JT]
    assert steals[TT] == steals[JT] and sum(steals[TT].values()) > 0


def test_migrate_pytree_moves_every_tensor():
    tree = {"a": torch.ones(2), "b": [torch.zeros(3), {"c": torch.ones(1)}],
            "n": 7}
    out = TS.migrate_pytree(tree, torch.device("meta"))
    assert out["a"].device.type == out["b"][0].device.type == \
        out["b"][1]["c"].device.type == "meta"
    assert out["n"] == 7 and isinstance(out["b"], list)
