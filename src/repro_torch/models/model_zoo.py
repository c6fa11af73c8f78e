"""Model interface over the ported architectures (the dense family and the
Mamba2 hybrid).

`build_model(cfg)` returns a `Model` whose methods cover what serving needs:
`init` (parameters from an explicit generator), `forward`, `init_cache`,
`prefill` and `decode_step` (the reference's signatures, plus the `ops`
that pick kernels or plain math, and `init_cache`'s device), and `layer_costs` — the analytic
per-layer profile the PPipe control plane consumes, equal to the
reference's for the same config.
"""

from __future__ import annotations

from dataclasses import dataclass
from types import ModuleType

import torch

from repro_torch.core import costmodel as cm
from repro_torch.core.types import LayerCost

from . import hybrid, transformer as tfm
from .common import KERNELS, ModelConfig, Ops, ParamTree, init_params

PORTED_FAMILIES = ("dense", "hybrid")


@dataclass
class Model:
    cfg: ModelConfig
    defs: dict
    mod: ModuleType  # models.transformer or models.hybrid

    def init(self, generator: torch.Generator) -> ParamTree:
        """Parameters on the generator's device, with the reference's init
        formulas (values differ from the reference's: other generator)."""
        return init_params(self.defs, generator)

    def forward(self, params: ParamTree, batch: dict, ops: Ops = KERNELS) -> torch.Tensor:
        return self.mod.forward(self.cfg, ops, params, batch["tokens"])

    def init_cache(self, batch_size: int, max_len: int, device: torch.device | str) -> dict:
        """Empty caches on `device`, which the caller names (prefill takes
        its tokens' device)."""
        return self.mod.init_cache(self.cfg, batch_size, max_len, device)

    def prefill(self, params: ParamTree, batch: dict, max_len: int | None = None,
                ops: Ops = KERNELS) -> tuple[torch.Tensor, dict]:
        return self.mod.prefill(self.cfg, ops, params, batch["tokens"], max_len=max_len)

    def decode_step(self, params: ParamTree, token: torch.Tensor, cache: dict, cur_len,
                    ops: Ops = KERNELS) -> tuple[torch.Tensor, dict]:
        return self.mod.decode_step(self.cfg, ops, params, token, cache, cur_len)

    def layer_costs(self, seq: int) -> list[LayerCost]:
        return layer_costs(self.cfg, seq)


def build_model(cfg: ModelConfig) -> Model:
    if cfg.family not in PORTED_FAMILIES:
        raise NotImplementedError(f"family {cfg.family!r} is not ported yet")
    mod = tfm if cfg.family == "dense" else hybrid
    return Model(cfg=cfg, defs=mod.model_defs(cfg), mod=mod)


# ----------------------------------------------------------------------------
# Analytical per-layer costs for the PPipe control plane
# ----------------------------------------------------------------------------


def layer_costs(cfg: ModelConfig, seq: int) -> list[LayerCost]:
    """Per-layer (flops, bytes, boundary size) at batch 1 for pre-partitioning.

    One entry per schedulable unit: embedding, each sequence-mixing (+FFN)
    layer, final norm + head.
    """
    if cfg.family not in PORTED_FAMILIES:
        raise NotImplementedError(f"family {cfg.family!r} is not ported yet")
    d, dff, V = cfg.d_model, cfg.d_ff, cfg.padded_vocab
    out: list[LayerCost] = [cm.embed_cost(seq, d, V)]

    def attn():
        return cm.attention_cost(seq, d, cfg.n_heads, cfg.kv_heads, cfg.hd,
                                 kv_len=None, name="attn", qkv_bias=cfg.qkv_bias)

    if cfg.family == "dense":
        for i in range(cfg.n_layers):
            out.append(cm.layer_sequence_cost(f"layer{i}", [attn(), cm.mlp_cost(seq, d, dff)]))
    else:
        hybrid.parse_pattern(cfg)  # raises for the xLSTM codes
        for i, code in enumerate(cfg.ssm_pattern):
            if code == "m":
                out.append(cm.mamba2_cost(seq, d, cfg.d_state, cfg.ssm_expand,
                                          name=f"mamba{i}"))
            else:
                out.append(cm.layer_sequence_cost(
                    f"attn{i}", [attn(), cm.mlp_cost(seq, d, dff)]))
    out.append(cm.head_cost(seq, d, V))
    return out
