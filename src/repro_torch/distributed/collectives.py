"""Distributed-optimization collectives: int8 gradient compression with error
feedback around the data-parallel all-reduce, the reference's
`distributed/collectives.py` in PyTorch.

The reference wraps `psum` / `pmax` inside `shard_map` over the DP axis;
here each rank calls `torch.distributed.all_reduce` on its own leaf (NCCL
on the card, gloo on the CPU):

    q = quantize_int8(g + error)      # per-tensor symmetric scale, shared
    s = all_reduce(q, SUM) / n        # int32 accumulate, exact
    g_hat = dequantize(s)
    error' = (g + error) - q * scale  # residual kept locally (error feedback)

Per-tensor int8 math in plain PyTorch, as the reference's is plain `jnp`
(not the per-row `boundary_quant` kernel).  Wire bytes drop 4x (f32) / 2x
(bf16) on an int8 transport; the all-reduce here carries int32, exact.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any

import torch
import torch.distributed as dist

from repro_torch.training.tree import leaves, map_tree, unflatten


@dataclass
class CompressionState:
    """Per-parameter error-feedback residuals (f32)."""

    error: Any

    @staticmethod
    def init(params) -> "CompressionState":
        return CompressionState(error=map_tree(
            lambda p: torch.zeros(p.shape, dtype=torch.float32, device=p.device), params))


def compressed_psum_leaf(g: torch.Tensor, err: torch.Tensor, group=None):
    """int8 all-reduce mean with error feedback for one gradient leaf.

    A SHARED global scale (the MAX all-reduce of |x|) keeps the int32
    accumulation exact and measures each rank's residual against its *own*
    dequantized contribution — the bounded-error EF-SGD form:
        mean(dequant_r) == g_hat exactly, |err| <= scale/2.
    Returns (g_hat in g's dtype, the new f32 residual)."""
    x = g.float() + err
    amax = torch.max(torch.abs(x)).reshape(1)
    dist.all_reduce(amax, op=dist.ReduceOp.MAX, group=group)
    scale = amax[0] / 127.0 + 1e-12
    q = torch.clamp(torch.round(x / scale), -127, 127)
    n = dist.get_world_size(group)
    acc = q.to(torch.int32)
    dist.all_reduce(acc, op=dist.ReduceOp.SUM, group=group)
    g_hat = acc.float() * scale / n
    new_err = x - q * scale  # residual vs own dequantized contribution
    return g_hat.to(g.dtype), new_err


def compressed_psum(grads, state: CompressionState, group=None):
    """Mean-reduce each rank's gradients over `group` (default: the world)
    with int8 compression; returns (mean_grads, new_state)."""
    out = [compressed_psum_leaf(g, e, group)
           for g, e in zip(leaves(grads), leaves(state.error))]
    new_g = unflatten(grads, [o[0] for o in out])
    new_e = unflatten(state.error, [o[1] for o in out])
    return new_g, CompressionState(error=new_e)
