"""Card topologies, the planner's price list: the port of
``harp_tpu.plan.topology``.

A :class:`Topology` names the worker ring, its grouping into nodes, and
two link classes (inside a node, between nodes) with declared or probed
rates.  :meth:`Topology.cost_s` prices one collective site as its ring
bytes over the slowest link class the ring crosses: a *ranking* model
(which schedule is cheapest here), not a wall-clock predictor.  The
algebra (:data:`_RING_FACTORS`, :meth:`~Topology.wire_bytes`,
:meth:`~Topology.cost_s`, :meth:`~Topology.hier_stage_cost_s`) is the
reference's, unchanged; the vocabulary is the H100's.

The four tags of :data:`TOPOLOGY_NAMES`:

- ``single_card``  — one worker: every collective folds to a local copy,
  and every wire prices 0;
- ``sim_ring_8``   — the 8-process gloo test world (a declared loopback
  rate: absolute seconds mean nothing, ratios still rank schedules, which
  is all the fail-closed planner uses);
- ``dgx_h100_8``   — one node of 8 H100 SXM cards on NVLink 4;
- ``h100_4x8``     — four such nodes, one 400 Gb/s NDR InfiniBand link a
  card between them.

The NVLink and NDR rates are DECLARED from NVIDIA's public H100 SXM and
DGX H100 figures (``rates_source="declared"``); :func:`probed` replaces
the intra-node rate by one timed through the port's allreduce.
"""

from __future__ import annotations

import dataclasses

#: the topology-tag vocabulary
TOPOLOGY_NAMES = ("single_card", "sim_ring_8", "dgx_h100_8", "h100_4x8")

#: NVLink 4 on an H100 SXM card: 900 GB/s, both directions together
#: (NVIDIA H100 data sheet: "NVLink: 900GB/s"), so 450 GB/s each way; a
#: ring step sends one way on each link
NVLINK_GBS = 450.0
#: one ConnectX-7 NDR port a card, 400 Gb/s = 50 GB/s each way (NVIDIA
#: DGX H100 data sheet: "8x single-port ConnectX-7, 400Gb/s InfiniBand")
NDR_GBS = 50.0
#: the card's HBM3 rate (H100 SXM data sheet: 3.35 TB/s): a one-card
#: "collective" is a local copy
HBM_GBS = 3350.0
#: the gloo test world's declared loopback rate (ratios only)
SIM_GBS = 10.0

#: declared device memory a worker by topology tag: the H100's 80 GB (the
#: gloo world models the same card, so that headroom fractions read alike)
HBM_BYTES_PER_CHIP = {name: 80 * 10 ** 9 for name in TOPOLOGY_NAMES}


def hbm_bytes(name: str) -> int:
    """Declared device memory a worker for a topology tag (80 GB for a tag
    outside the vocabulary, e.g. ``sim_ring_4``: never zero)."""
    return HBM_BYTES_PER_CHIP.get(name, 80 * 10 ** 9)


#: per-worker wire-byte multipliers of a ring lowering of each primitive,
#: as a fraction of the site's per-shard bytes ``b`` (the reference's):
#: psum = reduce-scatter + allgather moves 2·b·(n-1)/n; all_gather of a
#: b-byte shard sends it n-1 times; ppermute is one hop; all_to_all keeps
#: (n-1)/n of b on the wire; pmax/pmin ride the psum formula.
_RING_FACTORS = {
    "psum": lambda n: 2.0 * (n - 1) / n,
    "pmax": lambda n: 2.0 * (n - 1) / n,
    "pmin": lambda n: 2.0 * (n - 1) / n,
    "all_gather": lambda n: float(n - 1),
    "all_to_all": lambda n: (n - 1) / n,
    "ppermute": lambda n: 1.0,
    "reduce_scatter": lambda n: (n - 1) / n,
}


@dataclasses.dataclass(frozen=True)
class Topology:
    """One mesh's link-class price list (see the module docstring)."""

    name: str
    n_workers: int
    workers_per_host: int
    intra_gbs: float          # inside a node, GB/s each way
    inter_gbs: float          # between nodes, GB/s each way
    rates_source: str = "declared"   # "declared" | "probed"
    #: what :func:`probed` did, when it did not probe (one worker)
    note: str | None = None

    def __post_init__(self):
        if self.n_workers < 1 or self.workers_per_host < 1:
            raise ValueError("topology needs >= 1 worker per class")
        if self.n_workers % self.workers_per_host:
            raise ValueError(
                f"{self.n_workers} workers do not group into nodes of "
                f"{self.workers_per_host}")
        if self.intra_gbs <= 0 or self.inter_gbs <= 0:
            raise ValueError("link rates must be positive")

    @property
    def hosts(self) -> int:
        return self.n_workers // self.workers_per_host

    def wire_bytes(self, primitive: str, per_shard_bytes: int,
                   amplification: int = 1) -> float:
        """Per-worker bytes on the wire for one site per program run."""
        factor = _RING_FACTORS.get(primitive)
        if factor is None:
            raise ValueError(f"unknown collective primitive {primitive!r}")
        if self.n_workers == 1:
            return 0.0
        return per_shard_bytes * factor(self.n_workers) * max(
            amplification, 1)

    def cost_s(self, primitive: str, per_shard_bytes: int,
               amplification: int = 1) -> float:
        """Seconds to move one site's wire bytes: a flat ring's per-link
        bytes over the SLOWEST link class it crosses (on a multi-node ring
        the node-boundary links gate every step; a one-node ring rides the
        intra class alone)."""
        wire = self.wire_bytes(primitive, per_shard_bytes, amplification)
        if wire == 0.0:
            return 0.0
        rate = (min(self.intra_gbs, self.inter_gbs) if self.hosts > 1
                else self.intra_gbs)
        return wire / (rate * 1e9)

    def hier_stage_cost_s(self, per_shard_bytes: int,
                          amplification: int = 1) -> float:
        """The hierarchical two-stage reduction's price: a reduce-scatter
        and allgather inside each node (intra class, ring of
        ``workers_per_host``) and an allreduce across nodes in which each
        of a node's ``g`` workers carries 1/g of the payload over the
        boundary (inter class): the slow class moves ``2·(hosts-1)/hosts
        · b/g`` instead of the flat ring's ``2·(n-1)/n · b``."""
        b = per_shard_bytes * max(amplification, 1)
        g, h = self.workers_per_host, self.hosts
        intra = (2.0 * (g - 1) / g) * b / (self.intra_gbs * 1e9) if g > 1 \
            else 0.0
        inter = (2.0 * (h - 1) / h) * (b / g) / (self.inter_gbs * 1e9) \
            if h > 1 else 0.0
        return intra + inter


def single_card() -> Topology:
    """One worker: every collective folds to a local copy (HBM rate)."""
    return Topology("single_card", 1, 1, intra_gbs=HBM_GBS,
                    inter_gbs=HBM_GBS)


def sim_ring(n: int = 8) -> Topology:
    """The n-process gloo test world, one "node" (declared loopback rate:
    ratios rank schedules, absolutes mean nothing)."""
    return Topology(f"sim_ring_{n}", n, n, intra_gbs=SIM_GBS,
                    inter_gbs=SIM_GBS)


def dgx_h100_8() -> Topology:
    """One DGX H100 node: 8 SXM cards on NVLink 4 (declared rates)."""
    return Topology("dgx_h100_8", 8, 8, intra_gbs=NVLINK_GBS,
                    inter_gbs=NVLINK_GBS)


def h100_4x8() -> Topology:
    """Four DGX H100 nodes, 32 cards: NVLink 4 inside a node, one NDR
    400 Gb/s link a card between nodes (declared rates)."""
    return Topology("h100_4x8", 32, 8, intra_gbs=NVLINK_GBS,
                    inter_gbs=NDR_GBS)


def by_name(name: str) -> Topology:
    """The named topology of :data:`TOPOLOGY_NAMES`."""
    return {"single_card": single_card, "sim_ring_8": lambda: sim_ring(8),
            "dgx_h100_8": dgx_h100_8, "h100_4x8": h100_4x8}[name]()


def detect(mesh=None) -> Topology:
    """The topology of a :class:`~harp_tpu_torch.parallel.mesh.WorkerMesh`:
    ``single_card`` for one worker; on cards, ``dgx_h100_8`` for 8 workers
    and ``h100_4x8`` for 32 when a node holds 8 (``torch.cuda.
    device_count()``), else one NVLink node of the group's size; on the
    CPU, the gloo ring of the group's size."""
    import torch

    from harp_tpu_torch.parallel.mesh import current_mesh

    mesh = mesh or current_mesh()
    n = mesh.num_workers
    if n == 1:
        return single_card()
    if mesh.device.type != "cuda":
        return sim_ring(n)
    per_node = torch.cuda.device_count()
    if per_node == 8 and n == 8:
        return dgx_h100_8()
    if per_node == 8 and n == 32:
        return h100_4x8()
    g = per_node if per_node > 0 and n % per_node == 0 else n
    return Topology(f"h100_{n // g}x{g}", n, g, intra_gbs=NVLINK_GBS,
                    inter_gbs=NDR_GBS if g < n else NVLINK_GBS)


def probed(topo: Topology, mesh=None, size_mb: float = 4.0) -> Topology:
    """``topo`` with its intra-node rate replaced by one timed through the
    port's allreduce (:func:`harp_tpu_torch.benchmark.bench_verb` at
    ``size_mb``), stamped ``rates_source="probed"``.  On one worker there
    is no link to probe: ``topo`` comes back as declared, with a note that
    says so.  The inter-node rate keeps its declared value until a
    multi-node probe exists."""
    from harp_tpu_torch import benchmark as B
    from harp_tpu_torch.parallel.mesh import current_mesh

    mesh = mesh or current_mesh()
    if mesh.num_workers == 1:
        return dataclasses.replace(
            topo, rates_source="declared",
            note="one worker: no link to probe; rates as declared")
    rec = B.bench_verb("allreduce", mesh, int(size_mb * (1 << 20)), reps=2)
    return dataclasses.replace(topo, intra_gbs=max(rec["gb_per_sec"], 1e-3),
                               rates_source="probed", note=None)
