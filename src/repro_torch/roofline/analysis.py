"""Three-term roofline of a traced step on one NVIDIA H100 SXM5 per rank.

Port of ``repro.roofline.analysis`` with the TPU figures replaced by the
H100 SXM5 data sheet's (NVIDIA H100 Tensor Core GPU data sheet, SXM5
column; dense rates, no sparsity):

  compute    = counted FLOPs / (chips * 989.4e12 bf16 FLOP/s)
  memory     = counted bytes / (chips * 3.35e12 B/s HBM3)
  collective = link_bytes_per_chip / 450e9 B/s (NVLink 4: 900 GB/s a GPU,
               450 GB/s each direction)

The counts come from ``roofline.step_counts`` (per rank: rank 0's program
under the fake process group). Its byte count is the eager program's own
traffic (every op's inputs and output, unfused), so the memory term above
moves with the program: it says what this program costs, not what the
step's math needs. ``compulsory_floor`` is that floor: the step's
compulsory bytes (each input read once, each output written once) and its
model FLOPs over the same rates. The dominant term is the bottleneck;
roofline fraction = model_flops-derived ideal time / dominant term. The
field names and ``to_dict`` keys are the reference's (``hlo_*`` name the
counted values), so the two packages' result files compare.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional

PEAK_FLOPS = 989.4e12    # bf16 dense per H100 SXM5 (data sheet)
HBM_BW = 3.35e12         # bytes/s HBM3 per H100 SXM5 (data sheet)
LINK_BW = 450e9          # bytes/s NVLink 4, one direction (data sheet)


@dataclasses.dataclass
class Roofline:
    arch: str
    shape: str
    mesh: str
    chips: int
    hlo_flops_per_chip: float
    hlo_bytes_per_chip: float
    link_bytes_per_chip: float
    model_flops_total: float
    collective_counts: Dict[str, int]

    @property
    def t_compute(self) -> float:
        return self.hlo_flops_per_chip / PEAK_FLOPS

    @property
    def t_memory(self) -> float:
        return self.hlo_bytes_per_chip / HBM_BW

    @property
    def t_collective(self) -> float:
        return self.link_bytes_per_chip / LINK_BW

    @property
    def bottleneck(self) -> str:
        terms = {"compute": self.t_compute, "memory": self.t_memory,
                 "collective": self.t_collective}
        return max(terms, key=terms.get)

    @property
    def t_bound(self) -> float:
        return max(self.t_compute, self.t_memory, self.t_collective)

    @property
    def model_flops_ratio(self) -> float:
        """MODEL_FLOPS / total counted flops — how much executed compute is
        useful (catches remat/redundancy waste)."""
        total_hlo = self.hlo_flops_per_chip * self.chips
        return self.model_flops_total / max(total_hlo, 1.0)

    @property
    def roofline_fraction(self) -> float:
        """Ideal (useful-flops-limited) time / bound time."""
        t_ideal = self.model_flops_total / (self.chips * PEAK_FLOPS)
        return t_ideal / max(self.t_bound, 1e-30)

    def to_dict(self) -> Dict[str, Any]:
        return {
            "arch": self.arch, "shape": self.shape, "mesh": self.mesh,
            "chips": self.chips,
            "hlo_flops_per_chip": self.hlo_flops_per_chip,
            "hlo_bytes_per_chip": self.hlo_bytes_per_chip,
            "link_bytes_per_chip": self.link_bytes_per_chip,
            "model_flops_total": self.model_flops_total,
            "t_compute_s": self.t_compute,
            "t_memory_s": self.t_memory,
            "t_collective_s": self.t_collective,
            "bottleneck": self.bottleneck,
            "model_flops_ratio": self.model_flops_ratio,
            "roofline_fraction": self.roofline_fraction,
            "collective_counts": self.collective_counts,
        }


H2D_BW = 64e9            # bytes/s host->device: PCIe Gen5 x16, one direction
                         # (H100 SXM5 data sheet: 128 GB/s both ways)


@dataclasses.dataclass
class MaterializationRoofline:
    """Link/HBM model for the late-materialization handover (DESIGN §3).

    Compares the two ways a [B, L] dense batch can come to exist on device:

    * **host-dense**: the host scatters the jagged arena into zero-padded
      [B, L] arrays and ships them whole — H2D bytes scale with B*L*T
      regardless of fill;
    * **device (compact)**: only the arena + offsets cross the link
      (bytes scale with the *kept* elements), and the ``kernels/fused`` op
      rebuilds the dense layout on-accelerator.

    The fused op's HBM traffic is one arena read + one dense write. A STAGED
    device pipeline (densify kernel -> HBM -> separate decode kernel) pays the
    dense intermediate twice more (write + re-read), which is the quantitative
    case for fusing decode INTO densify. Fusing the embedding lookup as well
    buys nothing for training: the dense id lanes must reach HBM for the
    step either way (the table is a trained param inside it), so the fusion
    boundary stops at decode+densify — ``t_embed_extra`` is what a fused
    embed would merely relocate, not remove.
    """

    batch: int
    seq_len: int
    n_traits: int
    arena_rows: int          # total kept elements (sum of clipped row lens)
    itemsize: int = 4        # arena lane width (int32/float32 packing)
    table_dim: int = 0       # embedding width D; 0 = no embed stage modeled

    @property
    def fill(self) -> float:
        """Occupancy of the dense layout: kept / (B * L)."""
        return self.arena_rows / max(self.batch * self.seq_len, 1)

    @property
    def dense_h2d_bytes(self) -> int:
        return self.batch * self.seq_len * self.n_traits * self.itemsize

    @property
    def compact_h2d_bytes(self) -> int:
        # arena + shared offsets + per-row lens (both int32 [B(+1)])
        return (self.arena_rows * self.n_traits * self.itemsize
                + (self.batch + 1) * 4 + self.batch * 4)

    @property
    def h2d_savings(self) -> float:
        """Fraction of link bytes the compact payload avoids."""
        return 1.0 - self.compact_h2d_bytes / max(self.dense_h2d_bytes, 1)

    @property
    def t_h2d_dense(self) -> float:
        return self.dense_h2d_bytes / H2D_BW

    @property
    def t_h2d_compact(self) -> float:
        return self.compact_h2d_bytes / H2D_BW

    @property
    def fused_hbm_bytes(self) -> int:
        """One arena read + one dense write (decode rides in registers)."""
        return (self.arena_rows * self.n_traits * self.itemsize
                + self.dense_h2d_bytes)

    @property
    def staged_hbm_bytes(self) -> int:
        """Separate densify and decode kernels: the dense intermediate is
        written, re-read, and rewritten through HBM between the stages."""
        return self.fused_hbm_bytes + 2 * self.dense_h2d_bytes

    @property
    def t_fused(self) -> float:
        return self.fused_hbm_bytes / HBM_BW

    @property
    def t_staged(self) -> float:
        return self.staged_hbm_bytes / HBM_BW

    @property
    def t_embed_extra(self) -> float:
        """HBM time a fused embed stage would RELOCATE (not remove): the id
        lane re-read plus the table-row gather, both paid identically by the
        step's own lookup."""
        if self.table_dim <= 0:
            return 0.0
        ids = self.batch * self.seq_len * self.itemsize
        rows = self.batch * self.seq_len * self.table_dim * self.itemsize
        return (ids + rows) / HBM_BW

    @property
    def t_device_path(self) -> float:
        return self.t_h2d_compact + self.t_fused

    @property
    def t_host_path(self) -> float:
        """Link time only — host scatter cost is measured, not modeled."""
        return self.t_h2d_dense

    @property
    def device_wins(self) -> bool:
        return self.t_device_path < self.t_host_path

    def to_dict(self) -> Dict[str, Any]:
        return {
            "batch": self.batch, "seq_len": self.seq_len,
            "n_traits": self.n_traits, "arena_rows": self.arena_rows,
            "fill": self.fill,
            "dense_h2d_bytes": self.dense_h2d_bytes,
            "compact_h2d_bytes": self.compact_h2d_bytes,
            "h2d_savings": self.h2d_savings,
            "t_h2d_dense_s": self.t_h2d_dense,
            "t_h2d_compact_s": self.t_h2d_compact,
            "t_fused_s": self.t_fused,
            "t_staged_s": self.t_staged,
            "t_embed_extra_s": self.t_embed_extra,
            "t_device_path_s": self.t_device_path,
            "t_host_path_s": self.t_host_path,
            "device_wins": self.device_wins,
        }


def materialization_roofline(batch: int, seq_len: int, n_traits: int,
                             arena_rows: int, itemsize: int = 4,
                             table_dim: int = 0) -> MaterializationRoofline:
    """Model the host-dense vs device-compact materialization handover for
    one batch shape (see ``MaterializationRoofline``)."""
    return MaterializationRoofline(
        batch=batch, seq_len=seq_len, n_traits=n_traits,
        arena_rows=arena_rows, itemsize=itemsize, table_dim=table_dim)


def compulsory_floor(compulsory_bytes_per_chip: float,
                     model_flops_total: float, chips: int) -> Dict[str, Any]:
    """The least time any program could take for a cell's step on ``chips``
    H100s: its compulsory bytes (``StepCounts.compulsory_bytes``, per chip)
    over HBM3 and its model FLOPs over the bf16 peak. Neither term depends
    on how the step is written, so a time held against it does not flatter
    a program that fuses less."""
    t_memory = compulsory_bytes_per_chip / HBM_BW
    t_compute = model_flops_total / (chips * PEAK_FLOPS)
    return {"compulsory_bytes_per_chip": compulsory_bytes_per_chip,
            "t_compute_s": t_compute, "t_memory_s": t_memory,
            "t_bound_s": max(t_compute, t_memory),
            "bottleneck": "compute" if t_compute > t_memory else "memory"}


def from_compiled(arch: str, shape: str, mesh_name: str, chips: int,
                  cost: Optional[Dict[str, float]],
                  link_bytes: float, collective_counts: Dict[str, int],
                  model_flops: float) -> Roofline:
    """A ``Roofline`` from one rank's counts: ``cost`` holds ``flops`` and
    ``bytes accessed`` (``roofline.step_counts.StepCounts.cost``); the name
    and signature are the reference's."""
    flops = float(cost.get("flops", 0.0)) if cost else 0.0
    nbytes = float(cost.get("bytes accessed", 0.0)) if cost else 0.0
    return Roofline(
        arch=arch, shape=shape, mesh=mesh_name, chips=chips,
        hlo_flops_per_chip=flops, hlo_bytes_per_chip=nbytes,
        link_bytes_per_chip=link_bytes,
        model_flops_total=model_flops,
        collective_counts=collective_counts,
    )
