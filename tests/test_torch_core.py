"""The port's ``core/`` against the JAX package's: the runtime modules are
copies with three changes (a device-list ``make_mesh``, ``.to(device)``
migration, an H100 ``HardwareSpec``), so the same inputs must give the
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
            # make_mesh: the same devices in Algorithm 2's order, as a
            # nested list shaped like the JAX mesh's device array
            devs = [f"dev{i}" for i in range(tt.total_chips)]
            grid = np.asarray(tl.make_mesh(devs), dtype=object)
            want = np.asarray(devs, dtype=object)[order]
            if pod_axis:
                want = want.reshape(dims[0], tl.replicas_per_pod,
                                    tl.model_degree)
            assert grid.shape == want.shape
            assert (grid == want).all()


@pytest.mark.parametrize("arch,shape", [("llama3-8b", "train_4k"),
                                        ("llama3-8b", "decode_32k"),
                                        ("nemotron-4-15b", "prefill_32k"),
                                        ("starcoder2-15b", "decode_32k")])
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
    which holds the dense family only so far."""
    _, tt = _topos(1, 16, 16)
    with pytest.raises(NotImplementedError, match="ROADMAP A8"):
        TM.estimate(t_get_config("mamba2-780m"), SHAPES["train_4k"],
                    TL.Layout(tt, 1))


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
