"""DeepSeek-V3 (MLA, MoE, MTP): the two dense-FFN widths that the planner's
`layer_costs` reads, from the reference's `repro.models.deepseek`.

The rest of the module (MLA in its full and absorbed forms, the MoE layers,
the MTP head) waits for its slice of the port.
"""

from __future__ import annotations

from .common import ModelConfig

# DeepSeek-V3's dense-layer FFN width (arXiv:2412.19437 Table 2); the assigned
# spec's d_ff=2048 is the *routed expert* width (cfg.moe_d_ff).
DENSE_D_FF = 18432


def dense_ff_dim(cfg: ModelConfig) -> int:
    # Full config uses DeepSeek-V3's published dense width; reduced smoke
    # configs scale it with the model width instead.
    return DENSE_D_FF if cfg.d_model >= 4096 else max(cfg.d_ff, 2 * cfg.d_model)
