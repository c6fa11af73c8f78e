"""DeepSeek-V3 (671B): Multi-head Latent Attention, MoE (1 shared + 256
routed experts, top-8) and the Multi-Token Prediction head.

The counterpart of the reference's `repro.models.deepseek`.  MLA runs in two
forms, as there:

* full / prefill: the compressed latent c_kv is expanded back to per-head K
  and V, and the heads attend through `ops.attention` (flash attention on
  the card, at head_dim qk_nope + qk_rope = 192 with 128-wide values, which
  its wrapper pads for the bf16 forward; under grad the backward kernel
  reads and writes them at 128);
* decode: the "absorbed" form, plain einsums against the compressed cache
  (c_kv, k_rope): the queries are projected into the latent space and the
  scores taken there in f32.  It has no Pallas kernel in the reference and
  does not fit the decode-attention kernel (one latent "head" for all the
  query heads, 576-wide keys, 512-wide values).

The first `dense_layers` layers have a dense SwiGLU MLP, the rest the MoE FFN
of `models.moe`.  Every function takes `ops` where the reference takes its
sharding `rules`.  Where the reference keeps the two stacks (`dense_layers`,
`moe_layers`), the port keeps lists of per-layer trees, initialised with each
stack's fan-in.  The cache is the reference's {"c_kv", "k_rope"} of (L, B,
max_len, width) tensors; decode writes its row in place.
"""

from __future__ import annotations

import math

import torch

from . import moe as moe_mod
from . import transformer as tfm
from .common import ModelConfig, Ops, ParamDef, apply_rope, swiglu

# DeepSeek-V3's dense-layer FFN width (arXiv:2412.19437 Table 2); the assigned
# spec's d_ff=2048 is the *routed expert* width (cfg.moe_d_ff).
DENSE_D_FF = 18432


def dense_ff_dim(cfg: ModelConfig) -> int:
    # Full config uses DeepSeek-V3's published dense width; reduced smoke
    # configs scale it with the model width instead.
    return DENSE_D_FF if cfg.d_model >= 4096 else max(cfg.d_ff, 2 * cfg.d_model)


# ----------------------------------------------------------------------------
# Multi-head Latent Attention
# ----------------------------------------------------------------------------


def mla_defs(cfg: ModelConfig, stacked: int = 0) -> dict:
    d, H = cfg.d_model, cfg.n_heads
    nope, rope, vd = cfg.qk_nope_dim, cfg.qk_rope_dim, cfg.v_head_dim
    dt = cfg.dtype
    return {
        "q_a": ParamDef((d, cfg.q_lora_rank), dtype=dt, stacked=stacked),
        "q_a_norm": ParamDef((cfg.q_lora_rank,), init="ones", dtype=dt),
        "q_b": ParamDef((cfg.q_lora_rank, H, nope + rope), dtype=dt, stacked=stacked),
        "kv_a": ParamDef((d, cfg.kv_lora_rank + rope), dtype=dt, stacked=stacked),
        "kv_a_norm": ParamDef((cfg.kv_lora_rank,), init="ones", dtype=dt),
        "kv_b": ParamDef((cfg.kv_lora_rank, H, nope + vd), dtype=dt, stacked=stacked),
        "wo": ParamDef((H * vd, d), dtype=dt, stacked=stacked),
    }


def _mla_q(cfg: ModelConfig, ops: Ops, p, x: torch.Tensor, positions):
    """The query path: low-rank down and up projections, split into the
    nope and rope parts, RoPE on the latter.  Each (B, T, H, width)."""
    nope = cfg.qk_nope_dim
    B, T, _ = x.shape
    cq = ops.rms_norm(x @ p["q_a"], p["q_a_norm"], cfg.norm_eps)
    q = (cq @ p["q_b"].reshape(cfg.q_lora_rank, -1)).reshape(B, T, cfg.n_heads, -1)
    return q[..., :nope], apply_rope(q[..., nope:], positions, cfg.rope_theta)


def _mla_kv_latent(cfg: ModelConfig, ops: Ops, p, x: torch.Tensor, positions):
    """The latent path, what the cache keeps: the compressed c_kv (B, T,
    kv_lora_rank), normalised, and k_rope (B, T, qk_rope_dim), shared by the
    heads."""
    r = cfg.kv_lora_rank
    kv = x @ p["kv_a"]
    # a slice of the row: the norm kernel takes contiguous rows
    c_kv = ops.rms_norm(kv[..., :r].contiguous(), p["kv_a_norm"], cfg.norm_eps)
    k_rope = apply_rope(kv[..., r:][:, :, None, :], positions, cfg.rope_theta)[:, :, 0]
    return c_kv, k_rope


def mla_full(cfg: ModelConfig, ops: Ops, p, x: torch.Tensor, positions):
    """MLA expanded (prefill, the teacher-forced forward): returns (out,
    (c_kv, k_rope))."""
    nope, rope = cfg.qk_nope_dim, cfg.qk_rope_dim
    B, T, _ = x.shape
    H = cfg.n_heads
    q_nope, q_rope = _mla_q(cfg, ops, p, x, positions)
    c_kv, k_rope = _mla_kv_latent(cfg, ops, p, x, positions)
    kv = (c_kv @ p["kv_b"].reshape(cfg.kv_lora_rank, -1)).reshape(B, T, H, -1)
    k_nope, v = kv[..., :nope], kv[..., nope:]
    k = torch.cat([k_nope, k_rope[:, :, None, :].expand(B, T, H, rope)], dim=-1)
    q = torch.cat([q_nope, q_rope], dim=-1)
    # the scale is head_dim**-0.5 of q, the reference's 1 / sqrt(nope + rope)
    out = ops.attention(cfg, q, k, v)
    out = out.reshape(B, T, -1) @ p["wo"]
    return out, (c_kv, k_rope)


def mla_decode(cfg: ModelConfig, ops: Ops, p, x: torch.Tensor, ckv_cache: torch.Tensor,
               krope_cache: torch.Tensor, cur_len):
    """Absorbed MLA for one token x (B, 1, d) against the compressed cache
    (B, max_len, kv_lora_rank) and (B, max_len, qk_rope_dim), whose row
    `cur_len` it writes in place.  The scores are f32, as the reference's
    `preferred_element_type=jnp.float32`: the products are taken on f32
    operands (exact products of bf16 values, summed in f32)."""
    nope, rope = cfg.qk_nope_dim, cfg.qk_rope_dim
    B = x.shape[0]
    idx = tfm._cache_index(cur_len, x.device)
    positions = idx.expand(B, 1)
    q_nope, q_rope = _mla_q(cfg, ops, p, x, positions)
    c_kv_new, k_rope_new = _mla_kv_latent(cfg, ops, p, x, positions)
    ckv_cache.index_copy_(1, idx, c_kv_new.to(ckv_cache.dtype))
    krope_cache.index_copy_(1, idx, k_rope_new.to(krope_cache.dtype))

    w_k = p["kv_b"][..., :nope]  # (kv_lora, H, nope)
    w_v = p["kv_b"][..., nope:]  # (kv_lora, H, vd)
    q_c = torch.einsum("bqhn,lhn->bqhl", q_nope, w_k)  # the queries in latent space
    s = torch.einsum("bqhl,bsl->bhqs", q_c.float(), ckv_cache.float())
    s = s + torch.einsum("bqhr,bsr->bhqs", q_rope.float(), krope_cache.float())
    s = s / math.sqrt(nope + rope)
    S = ckv_cache.shape[1]
    valid = torch.arange(S, device=x.device)[None, :] < (idx + 1)[:, None]
    s = torch.where(valid[:, None, None, :], s, torch.full_like(s, -1e30))
    pattn = torch.softmax(s, dim=-1)
    ctx = torch.einsum("bhqs,bsl->bqhl", pattn.to(ckv_cache.dtype), ckv_cache)
    out = torch.einsum("bqhl,lhv->bqhv", ctx, w_v)
    out = out.reshape(B, 1, -1) @ p["wo"]
    return out, (ckv_cache, krope_cache)


# ----------------------------------------------------------------------------
# Layers and model
# ----------------------------------------------------------------------------


def dense_layer_defs(cfg: ModelConfig, stacked: int = 0) -> dict:
    d, dff, dt = cfg.d_model, dense_ff_dim(cfg), cfg.dtype
    return {
        "attn_norm": ParamDef((d,), init="ones", dtype=dt),
        "attn": mla_defs(cfg, stacked),
        "mlp_norm": ParamDef((d,), init="ones", dtype=dt),
        "mlp": {
            "gate": ParamDef((d, dff), dtype=dt, stacked=stacked),
            "up": ParamDef((d, dff), dtype=dt, stacked=stacked),
            "down": ParamDef((dff, d), dtype=dt, stacked=stacked),
        },
    }


def moe_layer_defs(cfg: ModelConfig, stacked: int = 0) -> dict:
    d, dt = cfg.d_model, cfg.dtype
    return {
        "attn_norm": ParamDef((d,), init="ones", dtype=dt),
        "attn": mla_defs(cfg, stacked),
        "mlp_norm": ParamDef((d,), init="ones", dtype=dt),
        "moe": moe_mod.moe_ffn_defs(cfg, stacked),
    }


def model_defs(cfg: ModelConfig) -> dict:
    nd, n_moe = cfg.dense_layers, cfg.n_layers - cfg.dense_layers
    d, dt = cfg.d_model, cfg.dtype
    defs = {
        "embed": ParamDef((cfg.padded_vocab, d), scale=0.02, dtype=dt),
        "dense_layers": [dense_layer_defs(cfg, nd) for _ in range(nd)],
        "moe_layers": [moe_layer_defs(cfg, n_moe) for _ in range(n_moe)],
        "final_norm": ParamDef((d,), init="ones", dtype=dt),
        "head": ParamDef((d, cfg.padded_vocab), dtype=dt),
    }
    if cfg.mtp:
        defs["mtp"] = {
            "proj": ParamDef((2 * d, d), dtype=dt),
            "norm_h": ParamDef((d,), init="ones", dtype=dt),
            "norm_e": ParamDef((d,), init="ones", dtype=dt),
            "layer": dense_layer_defs(cfg),
        }
    return defs


def ffn_block(cfg: ModelConfig, ops: Ops, p, x: torch.Tensor) -> torch.Tensor:
    """The residual stream after a layer's FFN: the MoE, or the dense MLP."""
    if "moe" in p:
        return moe_mod.ffn_block(cfg, ops, p, x)
    h = ops.rms_norm(x, p["mlp_norm"], cfg.norm_eps)
    return x + swiglu(h, p["mlp"]["gate"], p["mlp"]["up"], p["mlp"]["down"])


# A layer is two blocks, as in models.moe: the MLA block (with its latent
# pair for the cache) and the FFN block, dense or MoE.


def attn_block_full(cfg: ModelConfig, ops: Ops, p, x, positions):
    a, kv = mla_full(cfg, ops, p["attn"], ops.rms_norm(x, p["attn_norm"], cfg.norm_eps),
                     positions)
    return x + a, kv


def attn_block_decode(cfg: ModelConfig, ops: Ops, p, x, ckv_cache, krope_cache, cur_len):
    a, caches = mla_decode(cfg, ops, p["attn"], ops.rms_norm(x, p["attn_norm"], cfg.norm_eps),
                           ckv_cache, krope_cache, cur_len)
    return x + a, caches


def layer_full(cfg: ModelConfig, ops: Ops, p, x, positions):
    """A dense or MoE layer over the whole sequence: (x, (c_kv, k_rope))."""
    x, kv = attn_block_full(cfg, ops, p, x, positions)
    return ffn_block(cfg, ops, p, x), kv


def layer_decode(cfg: ModelConfig, ops: Ops, p, x, ckv_cache, krope_cache, cur_len):
    x, caches = attn_block_decode(cfg, ops, p, x, ckv_cache, krope_cache, cur_len)
    return ffn_block(cfg, ops, p, x), caches


def layers(params) -> list:
    """The layers in order: the dense ones, then the MoE ones."""
    return [*params["dense_layers"], *params["moe_layers"]]


def _hidden_full(cfg: ModelConfig, ops: Ops, params, tokens, frontend_embeds=None,
                 collect_cache: bool = False, remat: bool = False):
    x = tfm.embed_tokens(cfg, params, tokens, frontend_embeds)
    positions = tfm.positions_for(x)
    caches = []
    if not collect_cache:
        x = tfm.run_layers(layers(params),
                           lambda lp, x: layer_full(cfg, ops, lp, x, positions)[0], x, remat)
        return x, positions, caches
    for lp in layers(params):
        x, kv = layer_full(cfg, ops, lp, x, positions)
        caches.append(kv)
    return x, positions, caches


def forward(cfg: ModelConfig, ops: Ops, params, tokens: torch.Tensor,
            frontend_embeds: torch.Tensor | None = None, remat: bool = False,
            unembed_out: bool = True) -> torch.Tensor:
    x, _, _ = _hidden_full(cfg, ops, params, tokens, frontend_embeds, remat=remat)
    return tfm.head_out(cfg, ops, params, x, unembed_out)


def forward_with_mtp(cfg: ModelConfig, ops: Ops, params, tokens: torch.Tensor,
                     remat: bool = False, unembed_out: bool = True
                     ) -> tuple[torch.Tensor, torch.Tensor]:
    """(logits, mtp_logits): the next-token prediction at every position and
    the MTP head's (t + 2) prediction over [0, S - 1); with
    unembed_out=False the two final-normed hidden states (for the chunked
    CE of `Model.loss`)."""
    x, positions, _ = _hidden_full(cfg, ops, params, tokens, remat=remat)
    h = ops.rms_norm(x, params["final_norm"], cfg.norm_eps)
    mp = params["mtp"]
    emb_next = params["embed"][tokens[:, 1:]]
    merged = torch.cat([ops.rms_norm(x[:, :-1].contiguous(), mp["norm_h"], cfg.norm_eps),
                        ops.rms_norm(emb_next, mp["norm_e"], cfg.norm_eps)], dim=-1)
    y = merged @ mp["proj"]
    y, _ = layer_full(cfg, ops, mp["layer"], y, positions[:, :-1])
    y = ops.rms_norm(y, params["final_norm"], cfg.norm_eps)
    if not unembed_out:
        return h, y
    return tfm.unembed(cfg, params, h), tfm.unembed(cfg, params, y)


def init_cache(cfg: ModelConfig, batch: int, max_len: int, device: torch.device | str) -> dict:
    L = cfg.n_layers
    return {
        "c_kv": torch.zeros((L, batch, max_len, cfg.kv_lora_rank), dtype=cfg.dtype,
                            device=device),
        "k_rope": torch.zeros((L, batch, max_len, cfg.qk_rope_dim), dtype=cfg.dtype,
                              device=device),
    }


def prefill(cfg: ModelConfig, ops: Ops, params, tokens: torch.Tensor,
            frontend_embeds: torch.Tensor | None = None,
            max_len: int | None = None) -> tuple[torch.Tensor, dict]:
    x, _, caches = _hidden_full(cfg, ops, params, tokens, frontend_embeds, collect_cache=True)
    B, S, _ = x.shape
    cache = init_cache(cfg, B, max_len or S, x.device)
    for i, (c_kv, k_rope) in enumerate(caches):
        cache["c_kv"][i, :, :S] = c_kv
        cache["k_rope"][i, :, :S] = k_rope
    h = ops.rms_norm(x[:, -1:].contiguous(), params["final_norm"], cfg.norm_eps)
    return tfm.unembed(cfg, params, h), cache


def decode_step(cfg: ModelConfig, ops: Ops, params, token: torch.Tensor, cache: dict,
                cur_len) -> tuple[torch.Tensor, dict]:
    """token: (B, 1) ids; the cache is updated in place at `cur_len`."""
    x = tfm.embed_tokens(cfg, params, token)
    for i, lp in enumerate(layers(params)):
        x, _ = layer_decode(cfg, ops, lp, x, cache["c_kv"][i], cache["k_rope"][i], cur_len)
    x = ops.rms_norm(x, params["final_norm"], cfg.norm_eps)
    return tfm.unembed(cfg, params, x), cache
