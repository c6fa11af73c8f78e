"""Model interface over every architecture of the registry: the dense family
and the VLM (llava-next, a dense backbone after precomputed patch
embeddings), the MoE family (llama4's GQA + MoE, deepseek-v3's MLA + MoE +
MTP), the recurrent ones (the Mamba2 hybrid zamba2-2.7b, xLSTM) and the
encoder-decoder (seamless-m4t, over precomputed frame embeddings).

`build_model(cfg)` returns a `Model` whose methods cover what serving needs:
`init` (parameters from an explicit generator), `forward`, `init_cache`,
`prefill` and `decode_step` (the reference's signatures, plus the `ops`
that pick kernels or plain math, and `init_cache`'s device), and `layer_costs` — the analytic
per-layer profile the PPipe control plane consumes, equal to the
reference's for the same config of every family.  As in the reference, `forward` and
`prefill` read a VLM's `batch["patches"]` and an enc-dec's
`batch["frames"]`.
"""

from __future__ import annotations

from dataclasses import dataclass
from types import ModuleType

import torch

from repro_torch.core import costmodel as cm
from repro_torch.core.types import LayerCost

from . import deepseek, encdec, hybrid, moe, transformer as tfm
from .common import KERNELS, ModelConfig, Ops, ParamTree, init_params

PORTED_FAMILIES = ("dense", "vlm", "moe", "hybrid", "ssm", "audio")
_MODULES = {"dense": tfm, "vlm": tfm, "moe": moe, "hybrid": hybrid, "ssm": hybrid,
            "audio": encdec}


@dataclass
class Model:
    cfg: ModelConfig
    defs: dict
    mod: ModuleType  # models.transformer, moe, deepseek, hybrid or encdec

    def init(self, generator: torch.Generator) -> ParamTree:
        """Parameters on the generator's device, with the reference's init
        formulas (values differ from the reference's: other generator)."""
        return init_params(self.defs, generator)

    def inputs(self, batch: dict, prefill: bool = False) -> tuple:
        """The module's positional inputs after its parameters, read from
        the batch as the reference reads it: the tokens, then a VLM's
        optional patches or an enc-dec's frames (which its prefill takes
        alone)."""
        if self.cfg.family == "audio":
            return (batch["frames"],) if prefill else (batch["tokens"], batch["frames"])
        if self.cfg.family == "vlm":
            return batch["tokens"], batch.get("patches")
        return (batch["tokens"],)

    def forward(self, params: ParamTree, batch: dict, ops: Ops = KERNELS) -> torch.Tensor:
        return self.mod.forward(self.cfg, ops, params, *self.inputs(batch))

    def init_cache(self, batch_size: int, max_len: int, device: torch.device | str,
                   enc_len: int | None = None) -> dict:
        """Empty caches on `device`, which the caller names (prefill takes
        its tokens' device); `enc_len`, the enc-dec's cross-attention
        length (default max_len, as in the reference), only for it."""
        if self.cfg.family == "audio":
            return self.mod.init_cache(self.cfg, batch_size, max_len, device, enc_len)
        if enc_len is not None:
            raise ValueError(f"enc_len is for the enc-dec family, not {self.cfg.family!r}")
        return self.mod.init_cache(self.cfg, batch_size, max_len, device)

    def prefill(self, params: ParamTree, batch: dict, max_len: int | None = None,
                ops: Ops = KERNELS) -> tuple[torch.Tensor, dict]:
        return self.mod.prefill(self.cfg, ops, params, *self.inputs(batch, prefill=True),
                                max_len=max_len)

    def decode_step(self, params: ParamTree, token: torch.Tensor, cache: dict, cur_len,
                    ops: Ops = KERNELS) -> tuple[torch.Tensor, dict]:
        return self.mod.decode_step(self.cfg, ops, params, token, cache, cur_len)

    def layer_costs(self, seq: int) -> list[LayerCost]:
        return layer_costs(self.cfg, seq)


def build_model(cfg: ModelConfig) -> Model:
    if cfg.family not in PORTED_FAMILIES:
        raise NotImplementedError(f"family {cfg.family!r} is not ported yet")
    # the MoE family: deepseek's MLA layers, or llama4's GQA ones
    mod = deepseek if cfg.family == "moe" and cfg.mla else _MODULES[cfg.family]
    return Model(cfg=cfg, defs=mod.model_defs(cfg), mod=mod)


def batch_text_offset(cfg: ModelConfig) -> int:
    """Frontend tokens prepended before text (VLM patches)."""
    return cfg.frontend_tokens if cfg.family == "vlm" else 0


# ----------------------------------------------------------------------------
# Analytical per-layer costs for the PPipe control plane
# ----------------------------------------------------------------------------


def layer_costs(cfg: ModelConfig, seq: int) -> list[LayerCost]:
    """Per-layer (flops, bytes, boundary size) at batch 1 for pre-partitioning.

    One entry per schedulable unit: frontend/embedding, each
    sequence-mixing+FFN layer, final norm + head.
    """
    d, dff, V = cfg.d_model, cfg.d_ff, cfg.padded_vocab
    out: list[LayerCost] = [cm.embed_cost(seq, d, V)]

    def attn(name="attn"):
        return cm.attention_cost(seq, d, cfg.n_heads, cfg.kv_heads, cfg.hd,
                                 kv_len=None, name=name, qkv_bias=cfg.qkv_bias)

    def mla(name="mla"):
        # projections via low-rank paths + attention over (nope+rope) dims
        H = cfg.n_heads
        e = cfg.qk_nope_dim + cfg.qk_rope_dim
        w = (d * cfg.q_lora_rank + cfg.q_lora_rank * H * e
             + d * (cfg.kv_lora_rank + cfg.qk_rope_dim)
             + cfg.kv_lora_rank * H * (cfg.qk_nope_dim + cfg.v_head_dim)
             + H * cfg.v_head_dim * d)
        attn_f = 2 * seq * seq * H * (e + cfg.v_head_dim)
        act = (6 * seq * d + 2 * seq * H * e) * cm.BYTES
        return LayerCost(name, flops=2 * seq * w + attn_f, act_bytes=act,
                         weight_bytes=w * cm.BYTES, out_bytes=seq * d * cm.BYTES)

    def moe():
        return cm.moe_cost(seq, d, cfg.moe_d_ff or dff, cfg.n_experts, cfg.top_k,
                           cfg.n_shared_experts)

    if cfg.family in ("dense", "vlm"):
        for i in range(cfg.n_layers):
            out.append(cm.layer_sequence_cost(f"layer{i}", [attn(), cm.mlp_cost(seq, d, dff)]))
    elif cfg.family == "moe" and not cfg.mla:
        for i in range(cfg.n_layers):
            out.append(cm.layer_sequence_cost(f"layer{i}", [attn(), moe()]))
    elif cfg.family == "moe":
        for i in range(cfg.n_layers):
            ffn = (cm.mlp_cost(seq, d, deepseek.dense_ff_dim(cfg)) if i < cfg.dense_layers
                   else moe())
            out.append(cm.layer_sequence_cost(f"layer{i}", [mla(), ffn]))
    elif cfg.family in ("ssm", "hybrid"):
        for i, code in enumerate(cfg.ssm_pattern):
            if code == "m":
                out.append(cm.mamba2_cost(seq, d, cfg.d_state, cfg.ssm_expand,
                                          name=f"mamba{i}"))
            elif code == "M":
                out.append(cm.xlstm_cost(seq, d, cfg.n_heads, name=f"mlstm{i}"))
            elif code == "s":
                out.append(cm.xlstm_cost(seq, d, cfg.n_heads, name=f"slstm{i}"))
            elif code == "a":
                out.append(cm.layer_sequence_cost(
                    f"attn{i}", [attn(), cm.mlp_cost(seq, d, dff)]))
    elif cfg.family == "audio":
        for i in range(cfg.encoder_layers):
            out.append(cm.layer_sequence_cost(
                f"enc{i}", [attn(name="enc_attn"), cm.mlp_cost(seq, d, dff)]))
        for i in range(cfg.n_layers):
            out.append(cm.layer_sequence_cost(
                f"dec{i}", [attn(), attn(name="cross"), cm.mlp_cost(seq, d, dff)]))
    else:
        raise ValueError(cfg.family)
    out.append(cm.head_cost(seq, d, V))
    return out
