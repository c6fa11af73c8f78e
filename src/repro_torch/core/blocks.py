"""DNN pre-partitioning (paper section 5.2).

Groups the layers of a model into N blocks of approximately equal runtime on a
selected accelerator class, reducing the MILP search space from ~hundreds of
layers to N~10 blocks.  We follow the paper's greedy sweep: starting from the
first layer, accumulate consecutive layers until the group's runtime is as
close as possible to 1/N of the total; repeat until the last layer.
"""

from __future__ import annotations

from typing import Sequence

from .types import AcceleratorClass, Block, LayerCost, ModelProfile
from . import costmodel


def layer_runtime(layer: LayerCost, accel: AcceleratorClass, batch: int = 1) -> float:
    flops, bytes_ = layer.scaled(batch)
    return max(accel.matmul_time(flops), accel.hbm_time(bytes_)) + accel.overhead_s


def pre_partition(
    layers: Sequence[LayerCost],
    n_blocks: int,
    accel: AcceleratorClass | None = None,
    batch: int = 1,
) -> list[Block]:
    """Greedy equal-runtime grouping of `layers` into at most `n_blocks` blocks."""
    if not layers:
        raise ValueError("cannot pre-partition an empty layer list")
    accel = accel or costmodel.VFRACS and _default_accel()
    runtimes = [layer_runtime(l, accel, batch) for l in layers]
    total = sum(runtimes)
    target = total / n_blocks

    blocks: list[Block] = []
    start = 0
    acc = 0.0
    for idx, rt in enumerate(runtimes):
        remaining_layers = len(runtimes) - idx
        remaining_blocks = n_blocks - len(blocks)
        # Close the block when adding the next layer overshoots the target more
        # than stopping here undershoots it — unless we must keep consuming to
        # leave at least one layer per remaining block boundary.
        acc += rt
        is_last_layer = idx == len(runtimes) - 1
        must_close = remaining_layers <= (remaining_blocks - 1)
        if is_last_layer:
            blocks.append(_make_block(layers, len(blocks), start, idx + 1))
            break
        if remaining_blocks == 1:
            continue
        overshoot = acc + runtimes[idx + 1] - target
        undershoot = target - acc
        if must_close or overshoot > undershoot and acc > 0:
            blocks.append(_make_block(layers, len(blocks), start, idx + 1))
            start = idx + 1
            acc = 0.0
    return blocks


def _make_block(layers: Sequence[LayerCost], index: int, start: int, end: int) -> Block:
    group = layers[start:end]
    return Block(
        index=index,
        layer_start=start,
        layer_end=end,
        flops=sum(l.flops for l in group),
        act_bytes=sum(l.act_bytes for l in group),
        weight_bytes=sum(l.weight_bytes for l in group),
        out_bytes=group[-1].out_bytes,
    )


def _default_accel() -> AcceleratorClass:
    from .types import TPU_HI

    return TPU_HI


def build_profile(
    model_name: str,
    layers: Sequence[LayerCost],
    slo_s: float,
    n_blocks: int = 10,
    accel: AcceleratorClass | None = None,
    boundary_quant_factor: float = 0.5,
) -> ModelProfile:
    """Pre-partition + wrap into the ModelProfile consumed by the MILP."""
    blocks = pre_partition(layers, n_blocks, accel)
    return ModelProfile(
        model_name=model_name,
        blocks=tuple(blocks),
        slo_s=slo_s,
        boundary_quant_factor=boundary_quant_factor,
    )
