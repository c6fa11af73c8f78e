"""Model interface over every architecture of the registry: the dense family
and the VLM (llava-next, a dense backbone after precomputed patch
embeddings), the MoE family (llama4's GQA + MoE, deepseek-v3's MLA + MoE +
MTP), the recurrent ones (the Mamba2 hybrid zamba2-2.7b, xLSTM) and the
encoder-decoder (seamless-m4t, over precomputed frame embeddings).

`build_model(cfg)` returns a `Model` whose methods cover the whole
lifecycle: `init` (parameters from an explicit generator; `shapes`, empty
ones on the meta device for the dry run), `forward` and
`loss` (training), `init_cache`, `prefill` and `decode_step` (serving) —
the reference's signatures, plus the `ops` that pick kernels or plain math,
and `init_cache`'s device — and `layer_costs`, the analytic per-layer
profile the PPipe control plane consumes, equal to the reference's for the
same config of every family.  As in the reference, `forward` and
`prefill` read a VLM's `batch["patches"]` and an enc-dec's
`batch["frames"]`.
"""

from __future__ import annotations

from dataclasses import dataclass
from types import ModuleType

import torch
import torch.nn.functional as F

from repro_torch.core import costmodel as cm
from repro_torch.core.types import LayerCost

from . import deepseek, encdec, hybrid, moe, transformer as tfm
from .common import (KERNELS, ModelConfig, Ops, ParamTree, ce_chunk_of, empty_params, init_params,
                     remat_call)

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

    def shapes(self, device="meta") -> ParamTree:
        """The parameter tree as empty tensors on `device`, one per
        `ParamDef` with its dtype, nothing drawn: on the meta device (the
        default, the dry run's) shapes and dtypes with no storage, the
        counterpart of the reference's `Model.shapes`."""
        return empty_params(self.defs, device)

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

    def forward(self, params: ParamTree, batch: dict, remat: bool = False,
                ops: Ops = KERNELS) -> torch.Tensor:
        return self.mod.forward(self.cfg, ops, params, *self.inputs(batch), remat=remat)

    def loss(self, params: ParamTree, batch: dict, remat: bool = False,
             ops: Ops = KERNELS) -> torch.Tensor:
        """The reference's training loss: the chunked next-token CE over the
        final hidden states (labels `batch["labels"]`, or the tokens shifted
        by one after a VLM's patches; labels < 0 masked), plus deepseek's
        MTP term (tokens t + 2) at weight 0.3."""
        cfg, tokens = self.cfg, batch["tokens"]
        if cfg.family == "moe" and cfg.mla and cfg.mtp and "mtp" in params:
            h, y = deepseek.forward_with_mtp(cfg, ops, params, tokens, remat=remat,
                                             unembed_out=False)
            main = _ce_from_hidden(cfg, params, h[:, :-1], tokens[:, 1:])
            mtp = _ce_from_hidden(cfg, params, y[:, :-1], tokens[:, 2:])
            return main + 0.3 * mtp
        hidden = self.mod.forward(cfg, ops, params, *self.inputs(batch), remat=remat,
                                  unembed_out=False)
        labels = batch.get("labels")
        if labels is None:
            labels = tokens[:, 1:]
            hidden = hidden[:, batch_text_offset(cfg):-1]
        return _ce_from_hidden(cfg, params, hidden, labels)

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


def _ce_loss(cfg: ModelConfig, logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Masked CE over the true (un-padded) vocabulary, mean over tokens."""
    mask = torch.arange(logits.shape[-1], device=logits.device) < cfg.vocab
    logits = torch.where(mask, logits.float(), -1e30)
    logz = torch.logsumexp(logits, dim=-1)
    gold = logits.gather(-1, labels[..., None].long())[..., 0]
    return (logz - gold).mean()


def _ce_chunk(xc: torch.Tensor, lc: torch.Tensor, w: torch.Tensor,
              vocab: int) -> tuple[torch.Tensor, torch.Tensor]:
    """(sum of the chunk's token losses, its count of valid labels)."""
    logits = (xc @ w).float()
    vmask = torch.arange(w.shape[-1], device=w.device) < vocab
    logits = torch.where(vmask, logits, -1e30)
    logz = torch.logsumexp(logits, dim=-1)
    gold = logits.gather(-1, lc.clamp(min=0)[..., None].long())[..., 0]
    valid = (lc >= 0).float()
    return ((logz - gold) * valid).sum(), valid.sum()


def _ce_from_hidden(cfg: ModelConfig, params, hidden: torch.Tensor,
                    labels: torch.Tensor) -> torch.Tensor:
    """Chunked cross-entropy from the final hidden states, the reference's
    scan as a loop over `ce_chunk_of` chunks.  Each chunk's (B, chunk, V)
    f32 logits are computed under a checkpoint, so the backward recomputes
    them rather than holding every chunk's (2.5 GB a chunk at qwen2-1.5b's
    4 x 1023 x 151936).  Labels < 0 are masked out."""
    w = params["head"] if "head" in params else params["embed"].T
    B, S, _ = hidden.shape
    chunk = ce_chunk_of(cfg, S)
    pad = (-S) % chunk
    if pad:
        hidden = F.pad(hidden, (0, 0, 0, pad))
        labels = F.pad(labels, (0, pad), value=-1)
    tot = torch.zeros((), dtype=torch.float32, device=hidden.device)
    cnt = torch.zeros((), dtype=torch.float32, device=hidden.device)
    for c in range(0, S + pad, chunk):
        part, n = remat_call(_ce_chunk, hidden[:, c:c + chunk], labels[:, c:c + chunk], w,
                             cfg.vocab)
        tot, cnt = tot + part, cnt + n
    return tot / torch.clamp(cnt, min=1.0)


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
