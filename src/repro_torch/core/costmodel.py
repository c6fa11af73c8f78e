"""Analytical latency model — the stand-in for the paper's TensorRT profiler.

The paper profiles per-layer latency on every (GPU type, batch size) offline
(section 5.1).  On TPU, with no accelerator attached to this container, we use
a calibratable two-term roofline per accelerator class:

    t(block, class, v, b) = v * interference(v) *
        [ max( flops(b) / (peak * mxu_util), bytes(b) / hbm_bw ) + overhead ]

`v` is the virtual-device denominator (1/v of a chip).  The paper realizes
virtual GPUs with MPS *spatial* sharing; TPUs have no MPS, so we realize a
virtual device as a *co-batch slot*: the stage runner fuses the v concurrent
streams into one device execution of total batch v*b, whose weights are read
once and whose latency is shared by all v tenants (see DESIGN.md section 2).
This reproduces the paper's effect — small unified batch sizes stay efficient
on high-class chips — through the TPU-native mechanism (bigger fused batches)
instead of a degenerate time-division port.  `interference(v)` models the
co-scheduling overhead, like the paper's MPS interference profiling.

Crucially this preserves the property PPipe exploits: the cross-class latency
*ratio* of a block depends on its arithmetic intensity relative to each class's
ops:byte ratio, so different blocks prefer different classes (paper Fig. 3).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Sequence

from .types import AcceleratorClass, Block, ClusterSpec, LayerCost, ModelProfile

# MPS-analogue interference: v co-resident programs contend for HBM and the
# scalar core. 6%/extra-tenant matches the flavour of the paper's profiling.
INTERFERENCE_PER_TENANT = 0.06

VFRACS = (1, 2, 3, 4)  # paper: 1/1, 1/2, 1/3, 1/4 virtual GPUs
BATCH_SIZES = (1, 2, 4, 8, 16)


def interference(v: int) -> float:
    return 1.0 + INTERFERENCE_PER_TENANT * (v - 1)


def block_latency(
    block: Block, accel: AcceleratorClass, v: int = 1, batch: int = 1
) -> float:
    """Latency (s) seen by each of the v tenants of a chip at per-tenant `batch`.

    Co-batch model: the chip executes the fused batch v*batch; weights are
    read once, activations/flops scale with the fused batch, and all tenants
    complete together.  Per-chip throughput is v*batch/latency, which grows
    with v for memory/overhead-bound blocks (weight + launch amortization) and
    saturates for MXU-bound blocks — the Pareto trade the MILP navigates.
    """
    fused = v * batch
    flops = block.flops * fused
    bytes_ = block.act_bytes * fused + block.weight_bytes
    base = max(accel.matmul_time(flops), accel.hbm_time(bytes_)) + accel.overhead_s
    return interference(v) * base


def partition_latency(
    blocks: Sequence[Block], i: int, j: int, accel: AcceleratorClass, v: int, batch: int
) -> float:
    """Latency of a partition spanning blocks [i, j) (paper: sum of block
    latencies, section 5.2)."""
    return sum(block_latency(blocks[k], accel, v, batch) for k in range(i, j))


def transfer_latency(
    profile: ModelProfile, cluster: ClusterSpec, src_class: str, dst_class: str,
    block_end: int, batch: int,
) -> float:
    """Feature-map transfer time between partitions (bottleneck of the two NICs).

    Boundary tensors are quantized (boundary_quant kernel) before transfer.
    """
    nbytes = profile.boundary_bytes(block_end, batch)
    if nbytes <= 0:
        return 0.0
    bw = min(cluster.effective_nic_bw(src_class), cluster.effective_nic_bw(dst_class))
    return nbytes / bw + 1e-4  # + connection/SYN overhead


@dataclass(frozen=True)
class LatencyTable:
    """Dense per-block latency table: the "profiling output" fed to the MILP.

    lat[(block_idx, class_name, v, batch)] -> seconds
    """

    profile: ModelProfile
    classes: tuple[str, ...]
    vfracs: tuple[int, ...]
    batch_sizes: tuple[int, ...]
    lat: dict[tuple[int, str, int, int], float]

    def partition(self, i: int, j: int, cls: str, v: int, b: int) -> float:
        return sum(self.lat[(k, cls, v, b)] for k in range(i, j))


def build_latency_table(
    profile: ModelProfile,
    cluster: ClusterSpec,
    vfracs: Sequence[int] = VFRACS,
    batch_sizes: Sequence[int] = BATCH_SIZES,
) -> LatencyTable:
    lat: dict[tuple[int, str, int, int], float] = {}
    for blk in profile.blocks:
        for cname in cluster.classes:
            accel = cluster.accel(cname)
            for v in vfracs:
                for b in batch_sizes:
                    lat[(blk.index, cname, v, b)] = block_latency(blk, accel, v, b)
    return LatencyTable(
        profile=profile,
        classes=tuple(cluster.classes),
        vfracs=tuple(vfracs),
        batch_sizes=tuple(batch_sizes),
        lat=lat,
    )


# ----------------------------------------------------------------------------
# Layer-cost helpers used by configs/ to describe the assigned architectures.
# All counts are per request (batch 1); dtype is bf16 (2 bytes) unless noted.
# ----------------------------------------------------------------------------

BYTES = 2.0  # bf16


def _ln_cost(name: str, seq: int, d: float) -> LayerCost:
    return LayerCost(name, flops=5 * seq * d, act_bytes=2 * seq * d * BYTES,
                     weight_bytes=d * BYTES, out_bytes=seq * d * BYTES)


def embed_cost(seq: int, d: int, vocab: int, name: str = "embed") -> LayerCost:
    # Gather: negligible flops, reads seq rows of the table + writes activations.
    return LayerCost(
        name,
        flops=2 * seq * d,
        act_bytes=2 * seq * d * BYTES,
        weight_bytes=vocab * d * BYTES,
        out_bytes=seq * d * BYTES,
    )


def attention_cost(
    seq: int, d: int, n_heads: int, kv_heads: int, head_dim: int | None = None,
    kv_len: int | None = None, name: str = "attn", qkv_bias: bool = False,
) -> LayerCost:
    head_dim = head_dim or d // n_heads
    kv_len = kv_len or seq
    q_dim = n_heads * head_dim
    kv_dim = kv_heads * head_dim
    proj_flops = 2 * seq * d * (q_dim + 2 * kv_dim) + 2 * seq * q_dim * d
    attn_flops = 2 * seq * kv_len * n_heads * head_dim * 2  # QK^T + PV
    w = d * (q_dim + 2 * kv_dim) + q_dim * d
    act = (4 * seq * d + 2 * seq * (q_dim + 2 * kv_dim)) * BYTES \
        + 2 * kv_len * kv_dim * BYTES  # KV cache traffic
    return LayerCost(name, flops=proj_flops + attn_flops, act_bytes=act,
                     weight_bytes=w * BYTES, out_bytes=seq * d * BYTES)


def mlp_cost(seq: int, d: int, d_ff: int, gated: bool = True, name: str = "mlp") -> LayerCost:
    mults = 3 if gated else 2
    flops = 2 * seq * d * d_ff * mults
    w = d * d_ff * mults
    act = (2 * seq * d + mults * seq * d_ff) * BYTES
    return LayerCost(name, flops=flops, act_bytes=act, weight_bytes=w * BYTES,
                     out_bytes=seq * d * BYTES)


def moe_cost(
    seq: int, d: int, d_ff: int, n_experts: int, top_k: int,
    n_shared: int = 0, name: str = "moe",
) -> LayerCost:
    """MoE layer: router + top_k routed experts + optional shared experts.

    Weight bytes count the *touched* experts per token stream; with large seq a
    block realistically touches all experts, so we charge the full expert table
    (this is what makes MoE blocks memory-bound and low-class friendly).
    """
    per_expert = mlp_cost(seq, d, d_ff, gated=True)
    router_flops = 2 * seq * d * n_experts
    flops = router_flops + per_expert.flops * (top_k + n_shared)
    act = per_expert.act_bytes * (top_k + n_shared) + seq * n_experts * BYTES
    w = (3 * d * d_ff) * (n_experts + n_shared) * BYTES + d * n_experts * BYTES
    return LayerCost(name, flops=flops, act_bytes=act, weight_bytes=w,
                     out_bytes=seq * d * BYTES)


def mamba2_cost(seq: int, d: int, d_state: int, expand: int = 2,
                name: str = "mamba2") -> LayerCost:
    d_in = expand * d
    proj_flops = 2 * seq * d * (2 * d_in + 2 * d_state) + 2 * seq * d_in * d
    scan_flops = 6 * seq * d_in * d_state
    w = d * (2 * d_in + 2 * d_state) + d_in * d
    act = (4 * seq * d + 4 * seq * d_in + 2 * d_in * d_state) * BYTES
    return LayerCost(name, flops=proj_flops + scan_flops, act_bytes=act,
                     weight_bytes=w * BYTES, out_bytes=seq * d * BYTES)


def xlstm_cost(seq: int, d: int, n_heads: int, d_state: int | None = None,
               name: str = "mlstm") -> LayerCost:
    head_dim = d // n_heads
    d_state = d_state or head_dim
    proj_flops = 2 * seq * d * 4 * d
    scan_flops = 4 * seq * n_heads * head_dim * d_state
    w = 4 * d * d
    act = (6 * seq * d + 2 * n_heads * head_dim * d_state) * BYTES
    return LayerCost(name, flops=proj_flops + scan_flops, act_bytes=act,
                     weight_bytes=w * BYTES, out_bytes=seq * d * BYTES)


def head_cost(seq: int, d: int, vocab: int, name: str = "lm_head") -> LayerCost:
    # Serving only needs logits of the last position.
    out_seq = 1
    return LayerCost(name, flops=2 * out_seq * d * vocab,
                     act_bytes=(out_seq * d + out_seq * vocab) * BYTES,
                     weight_bytes=d * vocab * BYTES,
                     out_bytes=out_seq * vocab * BYTES)


def layer_sequence_cost(name: str, costs: Sequence[LayerCost]) -> LayerCost:
    """Fuse several sub-layer costs into one logical layer."""
    return LayerCost(
        name,
        flops=sum(c.flops for c in costs),
        act_bytes=sum(c.act_bytes for c in costs),
        weight_bytes=sum(c.weight_bytes for c in costs),
        out_bytes=costs[-1].out_bytes,
    )
