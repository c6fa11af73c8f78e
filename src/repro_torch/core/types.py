"""Core value types for the PPipe control/data plane.

Terminology follows the paper:
  * accelerator class  <- "GPU type" (TPU classes, and in the port GPU classes)
  * virtual device     <- "virtual GPU" (1/v time-division share of a chip)
  * block              <- pre-partitioned group of model layers (paper section 5.2)
  * pooled pipeline    <- ordered list of partitions, each bound to a pool of
                          same-class virtual devices
"""

from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass, field
from typing import Sequence

# ----------------------------------------------------------------------------
# Hardware model
# ----------------------------------------------------------------------------


@dataclass(frozen=True)
class AcceleratorClass:
    """A class of accelerator chips (the paper's "GPU type").

    Latency modelling is a two-term roofline plus a fixed per-invocation
    overhead; `mxu_util` models achievable MXU efficiency.
    """

    name: str
    peak_flops: float  # FLOP/s (bf16)
    hbm_bw: float  # bytes/s
    ici_bw: float  # bytes/s per link (intra-pool)
    nic_bw: float  # bytes/s per host NIC (inter-pool feature-map transfers)
    overhead_s: float = 12e-6  # per-program-invocation launch overhead
    mxu_util: float = 0.72  # achievable fraction of peak on dense matmul

    def matmul_time(self, flops: float) -> float:
        return flops / (self.peak_flops * self.mxu_util)

    def hbm_time(self, bytes_: float) -> float:
        return bytes_ / self.hbm_bw


# The production target of this repo (roofline constants from the task spec).
TPU_HI = AcceleratorClass(
    name="tpu-hi",  # v5e-class
    peak_flops=197e12,
    hbm_bw=819e9,
    ici_bw=50e9,
    nic_bw=25e9,
)

# Previous-generation / lite class.  The compute:bandwidth ratio is chosen so
# cross-class per-block latency ratios vary with arithmetic intensity, which is
# exactly the diversity PPipe exploits (paper Fig. 3): memory-bound blocks see
# ~1.9x, MXU-bound blocks see ~4.4x.
TPU_LO = AcceleratorClass(
    name="tpu-lo",
    peak_flops=45e12,
    hbm_bw=430e9,
    ici_bw=25e9,
    nic_bw=12.5e9,
    overhead_s=18e-6,
    mxu_util=0.68,
)

# Extra classes used by the MILP scalability benchmark (paper Fig. 14b).
TPU_MID = AcceleratorClass(
    name="tpu-mid",
    peak_flops=123e12,
    hbm_bw=615e9,
    ici_bw=40e9,
    nic_bw=20e9,
    overhead_s=14e-6,
    mxu_util=0.70,
)
TPU_EDGE = AcceleratorClass(
    name="tpu-edge",
    peak_flops=22e12,
    hbm_bw=200e9,
    ici_bw=12e9,
    nic_bw=8e9,
    overhead_s=25e-6,
    mxu_util=0.62,
)

# GPU classes.  The port runs on one H100; the lower classes are declared
# stand-ins that give the planner the heterogeneity PPipe exploits (their
# pools run on the same card, where calibrate_runtime replaces every
# modelled stage latency with one measured there).  peak_flops is the dense
# bf16 tensor-core rate and hbm_bw the device-memory rate of each data
# sheet; ici_bw is the card's peer link one way (NVLink, else PCIe x16);
# nic_bw is an assumed host network, not a data-sheet figure.
# overhead_s and mxu_util keep the class defaults.
H100 = AcceleratorClass(  # NVIDIA H100 SXM5 data sheet
    name="h100",
    peak_flops=989e12,
    hbm_bw=3.35e12,
    ici_bw=450e9,  # NVLink 4, 900 GB/s both ways
    nic_bw=50e9,  # 400 Gb/s
)
A100 = AcceleratorClass(  # stand-in: NVIDIA A100 SXM4 80GB data sheet
    name="a100",
    peak_flops=312e12,
    hbm_bw=2.0e12,
    ici_bw=300e9,  # NVLink 3, 600 GB/s both ways
    nic_bw=25e9,  # 200 Gb/s
)
L4 = AcceleratorClass(  # stand-in: NVIDIA L4 data sheet (dense: half the sparse 242)
    name="l4",
    peak_flops=121e12,
    hbm_bw=300e9,
    ici_bw=32e9,  # PCIe Gen4 x16
    nic_bw=12.5e9,  # 100 Gb/s
)
T4 = AcceleratorClass(  # stand-in: NVIDIA T4 data sheet (fp16 tensor cores; no bf16)
    name="t4",
    peak_flops=65e12,
    hbm_bw=320e9,
    ici_bw=16e9,  # PCIe Gen3 x16
    nic_bw=4e9,  # 32 Gb/s
)

ACCEL_CLASSES = {c.name: c for c in (TPU_HI, TPU_MID, TPU_LO, TPU_EDGE, H100, A100, L4, T4)}


@dataclass(frozen=True)
class ClusterSpec:
    """Inventory of a heterogeneous cluster: chip count per accelerator class
    plus host topology (chips per host share one NIC -> network contention D3).
    """

    counts: dict[str, int]  # class name -> number of physical chips
    chips_per_host: int = 4
    # Effective NIC bandwidth derate (the paper observes 5x tail inflation on
    # GCP and derates link bandwidth to 1/5; we keep the same knob).
    nic_derate: float = 0.2

    def accel(self, name: str) -> AcceleratorClass:
        return ACCEL_CLASSES[name]

    @property
    def classes(self) -> list[str]:
        return list(self.counts)

    @property
    def total_chips(self) -> int:
        return sum(self.counts.values())

    def hosts_of(self, name: str) -> int:
        return math.ceil(self.counts[name] / self.chips_per_host)

    def effective_nic_bw(self, name: str) -> float:
        return self.accel(name).nic_bw * self.nic_derate


# ----------------------------------------------------------------------------
# Model cost description (input to pre-partitioning + MILP)
# ----------------------------------------------------------------------------


@dataclass(frozen=True)
class LayerCost:
    """Analytical cost of one model layer at batch size 1 for one request shape.

    flops/bytes scale with batch size; weight bytes do not.  `out_bytes` is the
    boundary activation ("feature map") emitted if a partition ends here.
    """

    name: str
    flops: float  # FLOPs per request (batch 1)
    act_bytes: float  # activation bytes read+written per request
    weight_bytes: float  # parameter bytes touched (batch independent)
    out_bytes: float  # boundary activation bytes per request

    def scaled(self, batch: int) -> tuple[float, float]:
        """(flops, hbm bytes) at a given batch size."""
        return self.flops * batch, self.act_bytes * batch + self.weight_bytes


@dataclass(frozen=True)
class Block:
    """A pre-partitioned group of consecutive layers (paper section 5.2)."""

    index: int
    layer_start: int
    layer_end: int  # exclusive
    flops: float
    act_bytes: float
    weight_bytes: float
    out_bytes: float  # boundary feature-map bytes per request (batch 1)


@dataclass(frozen=True)
class ModelProfile:
    """Everything the MILP needs to know about one model at one request shape."""

    model_name: str
    blocks: tuple[Block, ...]
    slo_s: float
    # Boundary activations are quantized before transfer (paper section 6,
    # fp32->fp16; we default to bf16->int8 via the boundary_quant kernel).
    boundary_quant_factor: float = 0.5

    @property
    def n_blocks(self) -> int:
        return len(self.blocks)

    def boundary_bytes(self, block_end: int, batch: int) -> float:
        """Transfer bytes when a partition ends at block index `block_end - 1`."""
        if block_end >= self.n_blocks:
            return 0.0
        return self.blocks[block_end - 1].out_bytes * batch * self.boundary_quant_factor


# ----------------------------------------------------------------------------
# Requests / SLO
# ----------------------------------------------------------------------------


@dataclass(order=True)
class Request:
    arrival_s: float
    req_id: int = field(compare=False)
    model_name: str = field(compare=False, default="")
    deadline_s: float = field(compare=False, default=0.0)

    @property
    def slo_s(self) -> float:
        return self.deadline_s - self.arrival_s


@dataclass
class RequestOutcome:
    req_id: int
    arrival_s: float
    deadline_s: float
    completion_s: float | None  # None => dropped
    pipeline_id: int | None = None

    @property
    def ok(self) -> bool:
        return self.completion_s is not None and self.completion_s <= self.deadline_s + 1e-9


def attainment(outcomes: Sequence[RequestOutcome]) -> float:
    """Fraction of requests completed within SLO (paper's "SLO attainment")."""
    if not outcomes:
        return 1.0
    return sum(o.ok for o in outcomes) / len(outcomes)


def replace(obj, **kw):
    return dataclasses.replace(obj, **kw)
