"""Roofline analysis of a dry-run step (``launch.dryrun``).

Three terms per (arch, shape, mesh), all in seconds.  The census
(``roofline.op_cost``) counts the ops one device runs, so every byte and
FLOP figure is PER DEVICE and the terms divide by one chip's peaks:

  compute    = dev_FLOPs  / chip.peak_flops
  memory     = dev_bytes  / chip.hbm_bw
  collective = dev_coll_bytes / chip.link_bw

The chip is a parameter.  Its one instance here, ``H100_SXM``, holds
NVIDIA's data-sheet peaks of the H100 SXM at its 700 W limit (dense
bfloat16, HBM3, NVLink one direction); they are data-sheet values, not
measurements.  FLOPs count matmuls at 2·M·N·K and elementwise work as
XLA's cost analysis does; memory bytes are an HBM-traffic estimate
(operands + outputs of every op — an upper bound that double-counts
values consumed by several ops); collective bytes sum per-device output
shapes of the collective kinds.  The field names are the reference's
(``hlo_flops``, ``hlo_bytes``), so the records and tables read alike.

Also reported: MODEL_FLOPS = 6·N·D (train) or 2·N·D (inference) with
N = active params, and the usefulness ratio MODEL_FLOPS / counted FLOPs.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional


@dataclasses.dataclass(frozen=True)
class Chip:
    """One chip's peaks: FLOP/s, HBM bytes/s and link bytes/s."""

    name: str
    peak_flops: float
    hbm_bw: float
    link_bw: float


# NVIDIA H100 SXM data sheet (700 W): 989 TFLOP/s dense bfloat16,
# 3.35 TB/s HBM3, 900 GB/s NVLink in both directions (450 GB/s each way).
H100_SXM = Chip("NVIDIA H100 SXM (data sheet)", 989e12, 3.35e12, 450e9)


@dataclasses.dataclass
class RooflineReport:
    arch: str
    shape: str
    mesh: str
    chips: int
    hlo_flops: float
    hlo_bytes: float
    coll_bytes: float
    coll_by_kind: Dict[str, int]
    model_flops: float
    bytes_per_chip: Optional[float] = None
    chip: Chip = H100_SXM

    @property
    def compute_s(self) -> float:
        return self.hlo_flops / self.chip.peak_flops  # per-device flops

    @property
    def memory_s(self) -> float:
        return self.hlo_bytes / self.chip.hbm_bw  # per-device HBM traffic

    @property
    def collective_s(self) -> float:
        return self.coll_bytes / self.chip.link_bw  # per-device link traffic

    @property
    def dominant(self) -> str:
        terms = {
            "compute": self.compute_s,
            "memory": self.memory_s,
            "collective": self.collective_s,
        }
        return max(terms, key=terms.get)

    @property
    def useful_ratio(self) -> float:
        total = self.hlo_flops * self.chips  # global counted flops
        return self.model_flops / total if total else 0.0

    @property
    def step_time_s(self) -> float:
        """Roofline-model step latency: max of the three terms."""
        return max(self.compute_s, self.memory_s, self.collective_s)

    def row(self) -> Dict:
        return {
            "arch": self.arch,
            "shape": self.shape,
            "mesh": self.mesh,
            "chips": self.chips,
            "compute_s": self.compute_s,
            "memory_s": self.memory_s,
            "collective_s": self.collective_s,
            "dominant": self.dominant,
            "hlo_flops": self.hlo_flops,
            "hlo_bytes": self.hlo_bytes,
            "coll_bytes": self.coll_bytes,
            "coll_by_kind": self.coll_by_kind,
            "model_flops": self.model_flops,
            "useful_ratio": self.useful_ratio,
            "bytes_per_chip": self.bytes_per_chip,
        }


def model_flops_for(cfg, shape) -> float:
    """6·N_active·D for training, 2·N_active·D for inference steps."""
    n_active = cfg.active_param_count()
    if shape.kind == "train":
        tokens = shape.global_batch * shape.seq_len
        return 6.0 * n_active * tokens
    if shape.kind == "prefill":
        tokens = shape.global_batch * shape.seq_len
        return 2.0 * n_active * tokens
    # decode: one token per sequence
    return 2.0 * n_active * shape.global_batch


def analyze(
    cfg,
    shape,
    mesh_name: str,
    chips: int,
    cost,
    memory_stats: Optional[Dict] = None,
    chip: Chip = H100_SXM,
) -> RooflineReport:
    """The report of one step from its per-device ``op_cost.OpCost``."""
    return RooflineReport(
        arch=cfg.name,
        shape=shape.name,
        mesh=mesh_name,
        chips=chips,
        hlo_flops=cost.flops,
        hlo_bytes=cost.mem_bytes,
        coll_bytes=cost.coll_bytes,
        coll_by_kind={k: int(v) for k, v in cost.coll_by_kind.items()},
        model_flops=model_flops_for(cfg, shape),
        bytes_per_chip=(memory_stats or {}).get("bytes_per_chip"),
        chip=chip,
    )
