"""Chiplet-group model of a GPU fleet (the paper's §2 adapted to
NVIDIA H100 nodes).

The CPU hierarchy  core < chiplet (shared 32 MB L3) < NUMA socket
maps to  GPU < NVLink group ("chiplet group": the cards of one host, all
to all over NVLink) < pod, with the inter-node network playing the
cross-NUMA interconnect.

The shared-per-group resource that creates the paper's locality/capacity
trade-off is the group's aggregate HBM (the "L3 capacity" analogue) and its
NVLink bandwidth (the "L3 bandwidth" analogue).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Iterable, List, Tuple

import numpy as np


@dataclasses.dataclass(frozen=True)
class HardwareSpec:
    """NVIDIA H100 SXM5 80 GB constants (per card), from NVIDIA's data
    sheet and the Hopper architecture white paper — published peaks at the
    700 W power limit, not measured.  The latency model below is an
    assumption of the cost model, not a measurement."""
    peak_flops_bf16: float = 989e12      # FLOP/s, dense tensor cores
    hbm_bw: float = 3.35e12              # B/s
    hbm_bytes: float = 80e9              # capacity
    vmem_bytes: float = 227 * 1024       # shared memory one block can use
    ici_bw: float = 450e9                # B/s per direction, NVLink 4
    ici_links: int = 18                  # NVLink 4 links per card
    dcn_bw: float = 50e9                 # B/s per card, 400 Gb/s NIC
    # host link (PCIe gen5 x16): the swap tier's D2H/H2D path
    d2h_bw: float = 64e9                 # B/s device -> pinned host
    h2d_bw: float = 64e9                 # B/s pinned host -> device
    # latency model for the Fig.3 analogue (seconds, one 512B message)
    lat_intra_group: float = 2e-6
    lat_intra_pod: float = 5e-6
    lat_cross_pod: float = 10e-6


@dataclasses.dataclass(frozen=True)
class ChipletTopology:
    """n_pods x groups_per_pod x chips_per_group fleet."""
    n_pods: int = 1
    groups_per_pod: int = 16             # CHIPLETS (per NUMA domain)
    chips_per_group: int = 16            # CORES_PER_CHIPLET
    hw: HardwareSpec = HardwareSpec()

    @property
    def chips_per_pod(self) -> int:
        return self.groups_per_pod * self.chips_per_group

    @property
    def total_chips(self) -> int:
        return self.n_pods * self.chips_per_pod

    @property
    def total_groups(self) -> int:
        return self.n_pods * self.groups_per_pod

    # -- coordinates ------------------------------------------------------
    def coords(self, chip: int) -> Tuple[int, int, int]:
        """chip id -> (pod, group, slot)."""
        pod, rem = divmod(chip, self.chips_per_pod)
        group, slot = divmod(rem, self.chips_per_group)
        return pod, group, slot

    def chip_id(self, pod: int, group: int, slot: int) -> int:
        return (pod * self.chips_per_pod + group * self.chips_per_group
                + slot)

    def group_of(self, chip: int) -> int:
        """Global group index."""
        pod, group, _ = self.coords(chip)
        return pod * self.groups_per_pod + group

    # -- link classes (Fig. 3 analogue) ------------------------------------
    def link_class(self, a: int, b: int) -> str:
        pa, ga, _ = self.coords(a)
        pb, gb, _ = self.coords(b)
        if pa != pb:
            return "cross_pod"
        if ga != gb:
            return "intra_pod"
        return "intra_group"

    def latency(self, a: int, b: int) -> float:
        return {"intra_group": self.hw.lat_intra_group,
                "intra_pod": self.hw.lat_intra_pod,
                "cross_pod": self.hw.lat_cross_pod}[self.link_class(a, b)]

    def bandwidth(self, cls: str) -> float:
        """Effective per-chip bandwidth for a collective on links of ``cls``."""
        if cls == "intra_group":
            return self.hw.ici_bw * 2          # bidirectional ring in-row
        if cls == "intra_pod":
            return self.hw.ici_bw              # row-crossing: single column link
        return self.hw.dcn_bw

    def latency_cdf(self, sample_pairs: int = 4096, seed: int = 0):
        """(latencies, labels) over random chip pairs — the Fig. 3 CDF."""
        rng = np.random.default_rng(seed)
        n = self.total_chips
        a = rng.integers(0, n, sample_pairs)
        b = rng.integers(0, n, sample_pairs)
        lats = np.array([self.latency(x, y) for x, y in zip(a, b)])
        cls = [self.link_class(x, y) for x, y in zip(a, b)]
        return lats, cls

    # -- capacity (the "L3 size" analogue) ----------------------------------
    def group_hbm(self) -> float:
        return self.chips_per_group * self.hw.hbm_bytes


def production_topology(multi_pod: bool = False) -> ChipletTopology:
    """The assigned production mesh: 16x16 per pod, optionally 2 pods."""
    return ChipletTopology(n_pods=2 if multi_pod else 1)
