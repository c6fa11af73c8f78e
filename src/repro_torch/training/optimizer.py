"""AdamW with global-norm clipping, the reference's `training/optimizer.py`
in PyTorch.

The math is the reference's, op for op and in f32: the bias corrections
`1 - b ** step` come from the int32 step tensor cast to f32, each leaf is
updated as `(p32 - lr * delta).to(p.dtype)` (no f32 master copy: a bf16
leaf stays bf16, as in the reference), and the moments are kept in
`moment_dtype` (f32 by default; bf16 for the very large configs).  Where
the reference returns new arrays, `adamw_update` writes the parameters and
the moments in place, under `torch.no_grad()`, and returns the same trees:
a full-width update then holds one leaf's f32 temporaries at a time, not a
second copy of the state.  Elementwise PyTorch, as the reference's is plain
`jnp` outside any kernel.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any

import torch

from .tree import leaves, map_tree


@dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    moment_dtype: Any = torch.float32


def init_opt_state(params, cfg: AdamWConfig) -> dict:
    """Zero moments of the parameters' structure on their device, and an
    int32 step of 0."""
    zeros = lambda p: torch.zeros(p.shape, dtype=cfg.moment_dtype, device=p.device)  # noqa: E731
    device = leaves(params)[0].device
    return {"m": map_tree(zeros, params), "v": map_tree(zeros, params),
            "step": torch.zeros((), dtype=torch.int32, device=device)}


def global_norm(tree) -> torch.Tensor:
    """sqrt of the sum over leaves (in flatten order) of sum(x^2) in f32."""
    sq = sum(torch.sum(torch.square(x.float())) for x in leaves(tree))
    return torch.sqrt(sq)


def clip_by_global_norm(grads, max_norm: float):
    """(grads scaled by min(1, max_norm / norm), in their own dtypes; norm)."""
    norm = global_norm(grads)
    scale = torch.clamp(max_norm / torch.clamp(norm, min=1e-9), max=1.0)
    return map_tree(lambda g: (g.float() * scale).to(g.dtype), grads), norm


@torch.no_grad()
def adamw_update(params, grads, state: dict, cfg: AdamWConfig):
    """One AdamW step: writes `params`, `state["m"]` and `state["v"]` in
    place and returns (params, {"m", "v", "step" + 1})."""
    step = state["step"] + 1
    b1, b2 = cfg.b1, cfg.b2
    one = torch.ones((), dtype=torch.float32, device=step.device)
    c1 = 1.0 - (one * b1) ** step.float()
    c2 = 1.0 - (one * b2) ** step.float()
    for p, g, m, v in zip(leaves(params), leaves(grads), leaves(state["m"]),
                          leaves(state["v"])):
        g32 = g.float()
        m32 = m.float() * b1 + g32 * (1 - b1)
        v32 = v.float() * b2 + g32 * g32 * (1 - b2)
        mh = m32 / c1
        vh = v32 / c2
        delta = mh / (torch.sqrt(vh) + cfg.eps) + cfg.weight_decay * p.float()
        p.copy_((p.float() - cfg.lr * delta).to(p.dtype))
        m.copy_(m32.to(cfg.moment_dtype))
        v.copy_(v32.to(cfg.moment_dtype))
    return params, {"m": state["m"], "v": state["v"], "step": step}
