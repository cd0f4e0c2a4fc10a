# Port of src/repro/core/lisa/topology.py: a copy of the reference module (no JAX), pinned equal
# to it by tests/test_torch_copies.py.
"""Hop-distance cost model for the TPU mesh (the Table-1 linear model,
re-parameterised with ICI constants).

The paper's central quantitative structure is *linear-in-hops* transfer cost
with a large constant advantage over the global bus (Table 1:
T_RISC(h) = 140.5 + 8h ns vs. 1363.75 ns flat).  On a TPU v5e mesh the same
structure holds for neighbor-hop (collective-permute) schedules vs.
host-mediated / DCN movement:

    T_hop_chain(h, bytes) = h * (alpha_ici + bytes / bw_ici)
    T_host_path(bytes)    = 2 * (alpha_pcie + bytes / bw_pcie)

The analogy is *literal in the API*: :func:`ici_dram_spec` expresses the mesh
as just another :class:`~repro_torch.core.dram.spec.DramSpec` instance — a "row" is
one transfer of ``nbytes``, the RBM hop is one ICI neighbor hop, and the
off-chip channel is the PCIe host path — and the public cost functions below
are computed through that spec's ``CopyMechanism`` registry ("lisa" for the
hop chain, "memcpy" for the host path).

The runtime uses this model for cost-aware migration decisions (the paper's
"intelligent cost-aware mechanism", Sec. 3.2) — e.g. whether moving a KV page
between replicas is worth it, or which of several fast-tier slots to fill.
See DESIGN.md Sec. 2 for the full DRAM <-> TPU mapping.
"""
from __future__ import annotations

import dataclasses
import functools

from repro_torch.core.dram.spec import DramSpec, DramTiming, LisaTiming

# TPU v5e-ish constants (per task spec + public system papers).
ICI_LINK_GBPS = 50.0        # GB/s per ICI link direction
HBM_GBPS = 819.0            # GB/s HBM bandwidth per chip
PEAK_BF16_TFLOPS = 197.0    # per chip
ICI_ALPHA_US = 1.0          # per-hop launch latency (us), conservative
PCIE_GBPS = 16.0            # host <-> device path (the "narrow bus")
PCIE_ALPHA_US = 5.0


@functools.lru_cache(maxsize=256)
def ici_dram_spec(nbytes: int) -> DramSpec:
    """The ICI mesh as a ``DramSpec``: the DRAM <-> TPU analogy made literal.

    One "row" is a transfer of ``nbytes``; moving it one subarray over
    (``spec.copy_latency("lisa", h)``) is ``h`` ICI neighbor hops, and moving
    it over the "off-chip channel" (``spec.copy_latency("memcpy")``) is the
    two-leg PCIe host path.  Mapping (GB/s == bytes/ns; us == 1000 ns):

      * ``lisa.t_rbm_hop``  = alpha_ici + nbytes / bw_ici, with a zero
        ``risc_base`` (tRAS = tRP = sense_margin = 0 — there is no sensing
        phase on the mesh), so T_lisa(h) = h * per-hop cost exactly;
      * ``timing.tRCD``     = alpha_pcie and ``timing.tCCD`` = the PCIe
        transfer time, with one "cache line" per row and every other phase
        zeroed, so T_memcpy = 2 * (alpha_pcie + transfer) exactly;
      * ``t_rbm_row`` makes ``spec.rbm_bw_gbps`` == the ICI link bandwidth,
        and ``channel_bw_gbps`` is PCIe — the Sec. 2 bandwidth-ratio claim
        becomes the ICI : PCIe ratio (~3.1x).
    """
    alpha_ici_ns = ICI_ALPHA_US * 1e3
    alpha_pcie_ns = PCIE_ALPHA_US * 1e3
    return DramSpec(
        name=f"TPU_V5E_ICI_{nbytes}B",
        row_bytes=nbytes,
        cache_line_bytes=nbytes,       # one transfer per "row"
        timing=DramTiming(tCK=0.0, tRCD=alpha_pcie_ns, tRP=0.0, tRAS=0.0,
                          tCL=0.0, tCWL=0.0, tCCD=nbytes / PCIE_GBPS,
                          tBURST=0.0, tWR=0.0, tRTP=0.0),
        lisa=LisaTiming(t_rbm_hop=alpha_ici_ns + nbytes / ICI_LINK_GBPS,
                        t_rbm_row=nbytes / ICI_LINK_GBPS,
                        sense_margin=0.0,
                        t_pre_baseline=0.0, t_pre_linked=0.0),
        channel_bw_gbps=PCIE_GBPS,
    )


@dataclasses.dataclass(frozen=True)
class MeshTopology:
    """A 1-D ring view of one mesh axis (what hop schedules run over)."""
    size: int
    wraparound: bool = True     # TPU ICI tori have wraparound links

    def hops(self, src: int, dst: int) -> int:
        d = abs(dst - src)
        return min(d, self.size - d) if self.wraparound else d

    def path(self, src: int, dst: int) -> list[int]:
        d = (dst - src) % self.size
        if self.wraparound and d > self.size - d:
            step, n = -1, self.size - d
        else:
            step, n = 1, d
        return [(src + step * (i + 1)) % self.size for i in range(n)]


def hop_chain_us(hops: int, nbytes: int) -> float:
    """Neighbor-hop chain cost (the RBM-chain analogue).  Zero hops — the
    data is already local — is a free move."""
    if hops <= 0:
        return 0.0
    return ici_dram_spec(nbytes).copy_latency("lisa", hops) / 1e3


def host_path_us(nbytes: int) -> float:
    """Through-the-host cost (the memcpy-over-channel analogue)."""
    return ici_dram_spec(nbytes).copy_latency("memcpy") / 1e3


def ring_collective_us(axis_size: int, shard_bytes: int,
                       kind: str = "all_gather") -> float:
    """Cost of a ring collective over one mesh axis.

    all_gather / reduce_scatter: (n-1) hops, each carrying one shard.
    all_reduce: reduce_scatter + all_gather = 2(n-1) hops.
    """
    steps = {"all_gather": axis_size - 1,
             "reduce_scatter": axis_size - 1,
             "all_reduce": 2 * (axis_size - 1)}[kind]
    if steps <= 0:
        return 0.0
    return ici_dram_spec(shard_bytes).copy_latency("lisa", steps) / 1e3


def migration_worthwhile(nbytes: int, hops: int, expected_hits: float,
                         fast_gain_us: float) -> bool:
    """Paper Sec. 3.2: 'an intelligent cost-aware mechanism is required to
    make astute decisions on which data to cache and when.'  Move data only
    if the expected latency saved exceeds the movement cost."""
    return expected_hits * fast_gain_us > hop_chain_us(hops, nbytes)
