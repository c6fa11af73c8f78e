"""Train-step builder: loss + grad + clip + AdamW, with activation remat and
gradient accumulation (microbatching), the reference's
`training/train_lib.py` in PyTorch.

The gradients come from `torch.autograd.grad` on the parameter leaves,
which are set to require a gradient for the step only (the serving path
keeps them frozen, so its kernels launch with no autograd wrapper).  With
`accum_steps > 1` each micro-batch's gradients are summed in f32 and scaled
by 1 / accum_steps, as the reference's scan does, and stay f32 into the
clip and the update (the reference's accumulated gradients are f32 too).

The reference's `zero_pspec` and `opt_pspecs` (ZeRO-style sharding specs of
the optimizer moments over a JAX mesh) have no counterpart on one card and
are not ported (PERF.md, section 7).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable

import torch

from repro_torch.models.model_zoo import Model

from .optimizer import AdamWConfig, adamw_update, clip_by_global_norm, init_opt_state
from .tree import leaves


@dataclass
class TrainState:
    params: Any
    opt_state: Any

    @property
    def step(self):
        return self.opt_state["step"]


def micro_batches(batch: dict, accum_steps: int) -> list[dict]:
    """The batch's leading axis cut into `accum_steps` equal micro-batches,
    in order (the reference's reshape to (accum_steps, B / accum_steps, ...))."""
    n = next(iter(batch.values())).shape[0]
    if n % accum_steps:
        raise ValueError(f"batch of {n} does not split into {accum_steps} micro-batches")
    size = n // accum_steps
    return [{k: x[i * size:(i + 1) * size] for k, x in batch.items()}
            for i in range(accum_steps)]


def make_train_step(
    model: Model,
    opt_cfg: AdamWConfig | None = None,
    remat: bool = True,
    accum_steps: int = 1,
) -> Callable:
    """Returns train_step(params, opt_state, batch) -> (params, opt_state,
    metrics), metrics {"loss", "grad_norm"} as 0-d f32 tensors.  The step
    updates params and opt_state in place (see `adamw_update`)."""
    opt_cfg = opt_cfg or AdamWConfig()

    def value_and_grad(params, batch) -> tuple[torch.Tensor, tuple]:
        loss = model.loss(params, batch, remat=remat)
        return loss.detach(), torch.autograd.grad(loss, leaves(params), materialize_grads=True)

    def grads_of(params, batch) -> tuple[torch.Tensor, list]:
        if accum_steps == 1:
            loss, grads = value_and_grad(params, batch)
            return loss, list(grads)
        loss_sum = None
        g_sum = [torch.zeros(p.shape, dtype=torch.float32, device=p.device)
                 for p in leaves(params)]
        for mb in micro_batches(batch, accum_steps):
            loss, grads = value_and_grad(params, mb)
            loss_sum = loss.float() if loss_sum is None else loss_sum + loss
            for acc, g in zip(g_sum, grads):
                acc.add_(g.float())
            del grads
        scale = 1.0 / accum_steps
        return loss_sum * scale, [g * scale for g in g_sum]

    def train_step(params, opt_state, batch):
        trained = leaves(params)
        for p in trained:
            p.requires_grad_(True)
        try:
            loss, grads = grads_of(params, batch)
        finally:
            for p in trained:
                p.requires_grad_(False)
        # the gradients stay a list in the parameters' flatten order: the
        # clip and the update walk leaves, and a list needs no tree built
        grads, gnorm = clip_by_global_norm(grads, opt_cfg.grad_clip)
        params, opt_state = adamw_update(params, grads, opt_state, opt_cfg)
        return params, opt_state, {"loss": loss, "grad_norm": gnorm}

    return train_step


def init_train_state(model: Model, generator: torch.Generator,
                     opt_cfg: AdamWConfig | None = None) -> TrainState:
    opt_cfg = opt_cfg or AdamWConfig()
    params = model.init(generator)
    return TrainState(params=params, opt_state=init_opt_state(params, opt_cfg))
