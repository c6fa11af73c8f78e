"""Model interface over the ported architectures (the dense family).

`build_model(cfg)` returns a `Model` whose methods cover what serving needs:
`init` (parameters from an explicit generator), `forward`, and
`layer_costs` — the analytic per-layer profile the PPipe control plane
consumes, equal to the reference's for the same config.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from repro_torch.core import costmodel as cm
from repro_torch.core.types import LayerCost

from . import transformer as tfm
from .common import KERNELS, ModelConfig, Ops, ParamTree, init_params

PORTED_FAMILIES = ("dense",)


@dataclass
class Model:
    cfg: ModelConfig
    defs: dict

    def init(self, generator: torch.Generator) -> ParamTree:
        """Parameters on the generator's device, with the reference's init
        formulas (values differ from the reference's: other generator)."""
        return init_params(self.defs, generator)

    def forward(self, params: ParamTree, batch: dict, ops: Ops = KERNELS) -> torch.Tensor:
        return tfm.forward(self.cfg, ops, params, batch["tokens"])

    def layer_costs(self, seq: int) -> list[LayerCost]:
        return layer_costs(self.cfg, seq)


def build_model(cfg: ModelConfig) -> Model:
    if cfg.family not in PORTED_FAMILIES:
        raise NotImplementedError(f"family {cfg.family!r} is not ported yet")
    return Model(cfg=cfg, defs=tfm.model_defs(cfg))


# ----------------------------------------------------------------------------
# Analytical per-layer costs for the PPipe control plane
# ----------------------------------------------------------------------------


def layer_costs(cfg: ModelConfig, seq: int) -> list[LayerCost]:
    """Per-layer (flops, bytes, boundary size) at batch 1 for pre-partitioning.

    One entry per schedulable unit: embedding, each attention+FFN layer,
    final norm + head.
    """
    if cfg.family not in PORTED_FAMILIES:
        raise NotImplementedError(f"family {cfg.family!r} is not ported yet")
    d, dff, V = cfg.d_model, cfg.d_ff, cfg.padded_vocab
    out: list[LayerCost] = [cm.embed_cost(seq, d, V)]
    for i in range(cfg.n_layers):
        attn = cm.attention_cost(seq, d, cfg.n_heads, cfg.kv_heads, cfg.hd,
                                 kv_len=None, name="attn", qkv_bias=cfg.qkv_bias)
        out.append(cm.layer_sequence_cost(f"layer{i}", [attn, cm.mlp_cost(seq, d, dff)]))
    out.append(cm.head_cost(seq, d, V))
    return out
