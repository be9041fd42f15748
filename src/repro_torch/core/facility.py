"""Facility topology: experiment/edge facilities, data centers, WAN links.

Mirrors the paper's SLAC <-> ALCF deployment (§5.1): a 100 Gbps ESnet
backbone with ~48 ms RTT, 10 Gbps DTN NICs on each side, an edge facility
hosting edge-AI devices, and a data center hosting DCAI systems (Cerebras /
SambaNova / multi-GPU in the paper; one NVIDIA H100 here).

The topology is data, not behaviour — the transfer and compute services read
link/device parameters from it.

The port's copy of ``repro/core/facility.py``: the paper's devices and links
field for field, with the port's own target DCAI, ``h100``, in place of the
reference's own target entry.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple


@dataclasses.dataclass(frozen=True)
class WanLink:
    """Directed WAN link.  Rates in bytes/second, rtt in seconds."""

    src: str
    dst: str
    backbone_bps: float          # optical backbone capacity
    nic_bps: float               # DTN NIC capacity (the practical ceiling)
    rtt: float                   # round-trip time
    per_file_startup: float      # the paper's "S" constant (per file)

    def effective_rate(self, concurrency: int = 4) -> float:
        """Fig.-3-shaped throughput: rises with transfer concurrency and
        saturates at the DTN NIC ceiling (the paper measured >1 GB/s with
        multiple concurrent files on a 10 Gbps NIC)."""
        c = max(1, concurrency)
        single_stream = self.nic_bps * 0.35        # one stream ~35% of NIC
        return min(self.nic_bps * 0.92, single_stream * c)


@dataclasses.dataclass(frozen=True)
class ComputeDevice:
    """A compute resource at a facility.

    kind: "edge_ai" | "local_gpu" | "dcai" | "cpu_cluster"
    peak_flops: effective sustained FLOP/s for DNN training (bf16/fp32 mix)
    """

    name: str
    facility: str
    kind: str
    peak_flops: float
    hbm_bw: float = 0.0
    n_chips: int = 1
    queue_wait: float = 0.0       # mean scheduler/queue latency (s)
    service_overhead: float = 0.0  # per-invocation service overhead (s)


@dataclasses.dataclass
class Facility:
    name: str
    devices: Dict[str, ComputeDevice] = dataclasses.field(default_factory=dict)

    def add(self, dev: ComputeDevice) -> None:
        self.devices[dev.name] = dev


class Topology:
    def __init__(self) -> None:
        self.facilities: Dict[str, Facility] = {}
        self.links: Dict[Tuple[str, str], WanLink] = {}

    def add_facility(self, fac: Facility) -> None:
        self.facilities[fac.name] = fac

    def add_link(self, link: WanLink) -> None:
        self.links[(link.src, link.dst)] = link

    def link(self, src: str, dst: str) -> WanLink:
        if src == dst:
            # intra-facility: effectively free (local filesystem / LAN)
            return WanLink(src, dst, 1e12, 1e11, 1e-4, 1e-3)
        return self.links[(src, dst)]

    def device(self, name: str) -> ComputeDevice:
        for fac in self.facilities.values():
            if name in fac.devices:
                return fac.devices[name]
        raise KeyError(name)


# ---------------------------------------------------------------------------
# The paper's deployment, with one H100 added as the port's target DCAI.
# Constants from §4.2/§5.1: 100 Gbps backbone, 10 Gbps DTN NIC, 48 ms RTT,
# ~1 GB/s sustained Globus throughput, Cerebras trains BraggNN in 19 s.
# ---------------------------------------------------------------------------
def paper_topology() -> Topology:
    topo = Topology()

    edge = Facility("slac")
    edge.add(ComputeDevice("edge-tpu", "slac", "edge_ai", peak_flops=4e12,
                           service_overhead=0.1))
    edge.add(ComputeDevice("local-v100", "slac", "local_gpu",
                           peak_flops=14e12, hbm_bw=0.9e12,
                           service_overhead=0.1))
    topo.add_facility(edge)

    dc = Facility("alcf")
    dc.add(ComputeDevice("cerebras", "alcf", "dcai", peak_flops=2.5e15,
                         n_chips=1, queue_wait=2.0, service_overhead=1.0))
    dc.add(ComputeDevice("sambanova-1rdu", "alcf", "dcai", peak_flops=3e14,
                         n_chips=1, queue_wait=2.0, service_overhead=1.0))
    dc.add(ComputeDevice("gpu-server-8xv100", "alcf", "dcai",
                         peak_flops=8 * 14e12, n_chips=8, queue_wait=2.0,
                         service_overhead=1.0))
    # the port's target DCAI: one NVIDIA H100 SXM (datasheet: 989 TFLOP/s
    # dense bf16 on the tensor cores, 3.35 TB/s HBM3)
    dc.add(ComputeDevice("h100", "alcf", "dcai",
                         peak_flops=989e12, hbm_bw=3.35e12,
                         n_chips=1, queue_wait=2.0, service_overhead=1.0))
    dc.add(ComputeDevice("cpu-cluster-1024", "alcf", "cpu_cluster",
                         peak_flops=1024 * 5e10, n_chips=1024,
                         queue_wait=2.0, service_overhead=1.0))
    topo.add_facility(dc)

    # 100 Gbps backbone = 12.5 GB/s; 10 Gbps DTN NIC = 1.25 GB/s
    topo.add_link(WanLink("slac", "alcf", backbone_bps=12.5e9,
                          nic_bps=1.25e9, rtt=0.048, per_file_startup=0.6))
    topo.add_link(WanLink("alcf", "slac", backbone_bps=12.5e9,
                          nic_bps=1.25e9, rtt=0.048, per_file_startup=0.6))
    return topo
