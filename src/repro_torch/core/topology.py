"""Copy of ``repro.core.topology`` for the port (the reference module is
jax-free; the port imports nothing of the reference package).  The TPU
constants below are the reference's design figures, not measurements of
the port.

The paper's fabric (Fig. 2): 100 nodes × 8 GPUs; each GPU g on every node
hangs off *rail g* — a dedicated leaf switch per pod; 16 leaves (2 pods × 8
rails) × 8 spines, 800 GbE everywhere, full bisection in-pod, thinner
effective cross-pod capacity.  The transferable insight is a two-level
bandwidth hierarchy with a scarce cross-pod layer; this module captures it
as an explicit cost model that (a) sizes the production mesh, (b) prices
collectives for the roofline's collective term, and (c) justifies the
hierarchical all-reduce in the reference's ``core.collectives``.

TPU adaptation (DESIGN.md §2): in-pod links = ICI (~50 GB/s/link), cross-pod
= DCN (modeled thinner).  Axis order on the mesh mirrors the paper's rail
design: the innermost axis ("model") maps to the highest-bandwidth links.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, Tuple

# --- TPU v5e hardware constants (per brief) --------------------------------
PEAK_BF16_FLOPS = 197e12          # per chip
HBM_BW = 819e9                    # bytes/s per chip
ICI_BW = 50e9                     # bytes/s per link per direction
DCN_BW_PER_CHIP = 6.25e9          # bytes/s per chip cross-pod (thin layer)

# --- SAKURAONE (paper) constants, for the faithful benchmark tables --------
H100_FP64_TC = 67e12              # FLOP/s (dense tensor core fp64)
H100_FP8_TC = 1979e12             # FLOP/s
GPUS = 800
LINK_800GBE = 100e9               # bytes/s per 800 GbE port


@dataclasses.dataclass(frozen=True)
class RailTopology:
    """Leaf/spine rail-optimized fabric (paper §2.2, Fig. 2)."""
    num_pods: int = 2
    nodes_per_pod: int = 50
    gpus_per_node: int = 8        # == rails per pod == leaves per pod
    spines: int = 8
    leaf_uplink_bw: float = LINK_800GBE     # leaf->spine per link
    nic_bw: float = 50e9                    # 400 GbE per GPU NIC

    @property
    def num_gpus(self) -> int:
        return self.num_pods * self.nodes_per_pod * self.gpus_per_node

    @property
    def leaves(self) -> int:
        return self.num_pods * self.gpus_per_node

    def rail_of(self, gpu_id: int) -> int:
        return gpu_id % self.gpus_per_node

    def pod_of(self, gpu_id: int) -> int:
        return gpu_id // (self.nodes_per_pod * self.gpus_per_node)

    def hops(self, src: int, dst: int) -> int:
        """Switch hops between two GPUs (0 = same node via NVLink)."""
        if src // self.gpus_per_node == dst // self.gpus_per_node:
            return 0
        same_rail = self.rail_of(src) == self.rail_of(dst)
        same_pod = self.pod_of(src) == self.pod_of(dst)
        if same_rail and same_pod:
            return 1              # one leaf (the rail switch)
        return 3                  # leaf -> spine -> leaf

    def bisection_bw(self) -> float:
        """Full-bisection bandwidth of the fabric (bytes/s)."""
        return self.leaves * self.spines * self.leaf_uplink_bw / 2


def allreduce_cost(bytes_per_chip: float, n_chips: int, link_bw: float) -> float:
    """Ring all-reduce time: 2·(n-1)/n · B / link_bw."""
    if n_chips <= 1:
        return 0.0
    return 2.0 * (n_chips - 1) / n_chips * bytes_per_chip / link_bw


def reduce_scatter_cost(bytes_per_chip: float, n_chips: int, link_bw: float) -> float:
    if n_chips <= 1:
        return 0.0
    return (n_chips - 1) / n_chips * bytes_per_chip / link_bw


def hierarchical_allreduce_cost(bytes_per_chip: float, in_pod: int,
                                num_pods: int, *, ici_bw: float = ICI_BW,
                                dcn_bw: float = DCN_BW_PER_CHIP) -> Tuple[float, Dict[str, float]]:
    """Rail-optimized (paper-faithful) hierarchical all-reduce cost.

    Phase 1: reduce-scatter in-pod over ICI; phase 2: cross-pod all-reduce of
    the 1/in_pod shard over DCN; phase 3: all-gather in-pod.  Cross-pod bytes
    shrink by the in-pod factor — the rail-optimized property.
    """
    rs = reduce_scatter_cost(bytes_per_chip, in_pod, ici_bw)
    xp = allreduce_cost(bytes_per_chip / max(in_pod, 1), num_pods, dcn_bw)
    ag = reduce_scatter_cost(bytes_per_chip, in_pod, ici_bw)  # all-gather ≡ rs cost
    return rs + xp + ag, {"reduce_scatter": rs, "cross_pod": xp, "all_gather": ag}


def flat_allreduce_cost(bytes_per_chip: float, in_pod: int, num_pods: int,
                        *, dcn_bw: float = DCN_BW_PER_CHIP) -> float:
    """Naive single-ring all-reduce spanning pods: every hop constrained by
    the thin cross-pod layer once the ring crosses pods."""
    n = in_pod * num_pods
    if num_pods > 1:
        return 2.0 * (n - 1) / n * bytes_per_chip / dcn_bw
    return allreduce_cost(bytes_per_chip, n, ICI_BW)


@dataclasses.dataclass(frozen=True)
class RooflineTerms:
    compute_s: float
    memory_s: float
    collective_s: float

    @property
    def dominant(self) -> str:
        terms = {"compute": self.compute_s, "memory": self.memory_s,
                 "collective": self.collective_s}
        return max(terms, key=terms.get)

    @property
    def step_s(self) -> float:
        return max(self.compute_s, self.memory_s, self.collective_s)


def roofline(hlo_flops: float, hlo_bytes: float, collective_bytes: float,
             n_chips: int) -> RooflineTerms:
    """Three-term roofline per the brief (all inputs are program totals):

      compute    = HLO_FLOPs / (chips × peak)
      memory     = HLO_bytes / (chips × HBM_bw)
      collective = collective_bytes / (chips × link_bw)
    """
    return RooflineTerms(
        compute_s=hlo_flops / (n_chips * PEAK_BF16_FLOPS),
        memory_s=hlo_bytes / (n_chips * HBM_BW),
        collective_s=collective_bytes / (n_chips * ICI_BW),
    )
