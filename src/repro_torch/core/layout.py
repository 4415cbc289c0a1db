"""Algorithm 2 (Update Location) — faithful port + device-grid synthesis.

The paper's placement function maps a task ``rank`` to a (chiplet, slot,
core) under the current ``spread_rate`` and binds memory to the matching
NUMA node.  Here the same arithmetic produces the device permutation from
which the (replica, model) grid of torch devices for the chosen layout is
built:

  spread_rate s = chiplet groups per model replica
    -> model-parallel degree  m = s * chips_per_group
    -> replica count          R = total_groups / s
  mesh = (data=R, model=m), with each replica's model axis laid over s
  *contiguous* groups (the paper's affinity step), and the NUMA bind step
  becoming the NamedSharding placement of params/optimizer state.

The "LocalCache" policy of the paper is s=1 (TP confined to one ICI
neighborhood); "DistributedCache" is s=groups_per_pod.
"""
from __future__ import annotations

import dataclasses
import math
from typing import List, Optional, Tuple

import numpy as np

from repro_torch.core.topology import ChipletTopology


# ---------------------------------------------------------------------------
# Algorithm 2, faithful (rank -> core), as in the paper
# ---------------------------------------------------------------------------

def update_location(rank: int, spread_rate: int, *, chiplets: int,
                    cores_per_chiplet: int, thread_size: int
                    ) -> Optional[Tuple[int, int, int]]:
    """Returns (chiplet, slot, core) or None if the bounds check fails.

    Mirrors Algorithm 2: threads fill ``spread_rate`` chiplets using
    ``cores_per_chiplet / spread_rate`` slots on each, wrapping around when
    the computed chiplet exceeds the available count.
    """
    if not (0 < spread_rate <= chiplets):
        return None                                    # bounds check
    if thread_size > spread_rate * cores_per_chiplet * (chiplets // spread_rate):
        return None                                    # not enough cores
    slots_per_chiplet = max(1, cores_per_chiplet // spread_rate)
    chiplet = rank // slots_per_chiplet
    slot = rank % slots_per_chiplet
    if chiplet >= chiplets:                            # wrap-around
        slot = slot + (chiplet // chiplets) * slots_per_chiplet
        chiplet = chiplet % chiplets
    core = chiplet * cores_per_chiplet + slot
    return chiplet, slot, core


def numa_node_of(core: int, cores_per_numa: int) -> int:
    """Algorithm 2's set_mempolicy(MPOL_BIND, 1 << numa_node) analogue."""
    return core // cores_per_numa


# ---------------------------------------------------------------------------
# Mesh-level layout
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class Layout:
    """A concrete placement: how the fleet factors into replicas x shards."""
    topology: ChipletTopology
    spread_rate: int                    # groups per replica (1..groups_per_pod)
    pod_axis: bool = False              # keep an explicit leading "pod" axis

    def __post_init__(self):
        s = self.spread_rate
        t = self.topology
        assert 1 <= s <= t.groups_per_pod, s
        assert t.groups_per_pod % s == 0, (t.groups_per_pod, s)

    @property
    def model_degree(self) -> int:
        return self.spread_rate * self.topology.chips_per_group

    @property
    def replicas_per_pod(self) -> int:
        return self.topology.groups_per_pod // self.spread_rate

    @property
    def replicas(self) -> int:
        return self.replicas_per_pod * self.topology.n_pods

    # -- device permutation (Algorithm 2 applied to shards) ------------------
    def device_order(self) -> np.ndarray:
        """(replicas, model_degree) array of chip ids, replicas pod-major.

        Shard j of replica r sits in group  r*s + j // chips_per_group  at
        slot  j % chips_per_group  — contiguous groups per replica, the
        affinity discipline of Algorithm 2.
        """
        t = self.topology
        s = self.spread_rate
        out = np.empty((self.replicas, self.model_degree), dtype=np.int64)
        for pod in range(t.n_pods):
            for r in range(self.replicas_per_pod):
                base_group = r * s
                for j in range(self.model_degree):
                    g = base_group + j // t.chips_per_group
                    slot = j % t.chips_per_group
                    out[pod * self.replicas_per_pod + r, j] = t.chip_id(
                        pod, g, slot)
        return out

    def make_mesh(self, devices=None):
        """The layout's device grid: a nested list of torch devices shaped
        (replicas, model) — or (pods, replicas_per_pod, model) with the pod
        axis — in Algorithm 2's placement order.  ``devices`` defaults to
        every visible CUDA device."""
        import torch

        if devices is None:
            devices = [torch.device("cuda", i)
                       for i in range(torch.cuda.device_count())]
        devices = list(devices)
        order = self.device_order()
        dev_arr = np.empty(len(devices), dtype=object)
        dev_arr[:] = devices
        dev_arr = dev_arr[order]
        if self.pod_axis:
            t = self.topology
            dev_arr = dev_arr.reshape(t.n_pods, self.replicas_per_pod,
                                      self.model_degree)
        return dev_arr.tolist()

    # -- capacity (Fig. 5 working-set test) -----------------------------------
    def replica_hbm(self) -> float:
        return self.model_degree * self.topology.hw.hbm_bytes

    def fits(self, replica_working_set_bytes: float,
             headroom: float = 0.9) -> bool:
        return replica_working_set_bytes <= self.replica_hbm() * headroom

    def describe(self) -> str:
        return (f"Layout(s={self.spread_rate}: {self.replicas}r x "
                f"{self.model_degree}m, replica HBM "
                f"{self.replica_hbm() / 1e9:.0f}GB)")


def layout_family(topology: ChipletTopology, pod_axis: bool = False
                  ) -> List[Layout]:
    """All legal spread rates (divisors of groups_per_pod)."""
    g = topology.groups_per_pod
    return [Layout(topology, s, pod_axis)
            for s in range(1, g + 1) if g % s == 0]
