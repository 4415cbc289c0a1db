"""The port's ARCAS developer API (``repro_torch.core.api``) against the JAX
package's (``repro.core.api``): one program — ``run`` of plain callables
and coroutines, ``all_do`` on every worker, ``call`` to a chiplet group
synchronously and asynchronously, ``barrier`` — on the same topology and
seed must place the same tasks on the same groups and workers, return the
same results and count the same runtime events."""
import pytest

from repro.core import api as japi
from repro.core.topology import ChipletTopology as JTopology
from repro_torch.core import api as tapi
from repro_torch.core.topology import ChipletTopology as TTopology


def program(api, topology):
    """Run the API's whole surface; return what each piece observed."""
    rt = api.ARCAS_Init(topology, workers_per_group=2, seed=3)
    groups = topology.total_groups
    out = {}

    def spinner(n, tag):
        acc = 0
        for i in range(n):
            acc += i * tag
            yield
        return acc

    spawned = [api.run(lambda i=i: i * i, group=i % groups, name=f"sq{i}")
               for i in range(6)]
    spawned += [api.run(spinner(4 + i, i), group=(2 * i) % groups)
                for i in range(5)]
    # a group-less coroutine lands on the runtime's home worker
    spawned.append(api.run(spinner(3, 7), name="free"))
    everywhere = api.all_do(lambda g: 10 * g)
    out["sync_call"] = api.call(1 % groups, lambda: "rpc")
    pending = api.call(groups - 1, lambda: sum(range(10)), sync=False)
    out["pending_done_before_barrier"] = pending.done
    api.barrier()
    out["async_call"] = pending.result
    # task ids count up per process: compare them from the first task on
    base = spawned[0].id
    out["run"] = [(t.id - base, t.group, t.result, t.stats.yields,
                   t.stats.steals) for t in spawned]
    out["all_do"] = [(t.group, t.result) for t in everywhere]
    out["workers"] = [(w.wid, w.group, w.pod, w.executed_steps, w.stolen)
                      for w in rt.workers]
    out["steal_log"] = [{**e, "task": e["task"] - base}
                        for e in rt.steal_log]
    out["rounds"] = rt.rounds
    out["counters"] = dict(rt.counters.totals)
    api.ARCAS_Finalize()
    with pytest.raises(RuntimeError, match="ARCAS_Init"):
        api.run(lambda: None)
    return out


@pytest.mark.parametrize("pods,groups,chips", [(1, 4, 1), (2, 3, 2)])
def test_api_matches_reference(pods, groups, chips):
    want = program(japi, JTopology(n_pods=pods, groups_per_pod=groups,
                                   chips_per_group=chips))
    got = program(tapi, TTopology(n_pods=pods, groups_per_pod=groups,
                                  chips_per_group=chips))
    assert got == want
    n_groups = pods * groups
    assert got["sync_call"] == "rpc" and got["async_call"] == 45
    assert not got["pending_done_before_barrier"]
    assert sorted(g for g, _ in got["all_do"]) == sorted(
        w[1] for w in got["workers"])
    assert [r for _, r in got["all_do"]] == [10 * g for g, _ in got["all_do"]]
    assert {w[1] for w in got["workers"]} == set(range(n_groups))


def test_default_topology_and_finalize():
    """Without a topology both packages build their production fleet, and
    Finalize drains what is queued."""
    rt_j = japi.ARCAS_Init()
    rt_t = tapi.ARCAS_Init()
    assert len(rt_t.workers) == len(rt_j.workers)
    assert [w.group for w in rt_t.workers] == [w.group for w in rt_j.workers]
    tj = japi.run(lambda: 1)
    tt = tapi.run(lambda: 1)
    japi.ARCAS_Finalize()
    tapi.ARCAS_Finalize()
    assert tj.done and tt.done and tt.result == tj.result == 1
