"""Dense decoder-only transformer family, forward (prefill) path.

Covers stablelm-3b and qwen3-14b (qk_norm, GQA).  Every function takes
`ops` where the reference takes its sharding `rules`: `common.KERNELS` runs
the RMSNorm and attention kernels for CUDA tensors, `common.PLAIN` the
reference's plain math.  Decode and the KV cache are not ported yet.
"""

from __future__ import annotations

import torch

from .common import ModelConfig, Ops, ParamDef, apply_rope, swiglu

# ----------------------------------------------------------------------------
# Parameter templates
# ----------------------------------------------------------------------------


def attn_defs(cfg: ModelConfig, stacked: int = 0) -> dict:
    d, H, KH, hd = cfg.d_model, cfg.n_heads, cfg.kv_heads, cfg.hd
    dt = cfg.dtype
    defs = {
        "wq": ParamDef((d, H * hd), dtype=dt, stacked=stacked),
        "wk": ParamDef((d, KH * hd), dtype=dt, stacked=stacked),
        "wv": ParamDef((d, KH * hd), dtype=dt, stacked=stacked),
        "wo": ParamDef((H * hd, d), dtype=dt, stacked=stacked),
    }
    if cfg.qkv_bias:
        defs["bq"] = ParamDef((H * hd,), init="zeros", dtype=dt)
        defs["bk"] = ParamDef((KH * hd,), init="zeros", dtype=dt)
        defs["bv"] = ParamDef((KH * hd,), init="zeros", dtype=dt)
    if cfg.qk_norm:
        defs["q_norm"] = ParamDef((hd,), init="ones", dtype=dt)
        defs["k_norm"] = ParamDef((hd,), init="ones", dtype=dt)
    return defs


def layer_defs(cfg: ModelConfig, stacked: int = 0) -> dict:
    d, dff, dt = cfg.d_model, cfg.d_ff, cfg.dtype
    return {
        "attn_norm": ParamDef((d,), init="ones", dtype=dt),
        "attn": attn_defs(cfg, stacked),
        "mlp_norm": ParamDef((d,), init="ones", dtype=dt),
        "mlp": {
            "gate": ParamDef((d, dff), dtype=dt, stacked=stacked),
            "up": ParamDef((d, dff), dtype=dt, stacked=stacked),
            "down": ParamDef((dff, d), dtype=dt, stacked=stacked),
        },
    }


def model_defs(cfg: ModelConfig) -> dict:
    defs = {
        "embed": ParamDef((cfg.padded_vocab, cfg.d_model), scale=0.02, dtype=cfg.dtype),
        # one template per layer; `stacked` keeps the reference's fan-in
        "layers": [layer_defs(cfg, cfg.n_layers) for _ in range(cfg.n_layers)],
        "final_norm": ParamDef((cfg.d_model,), init="ones", dtype=cfg.dtype),
    }
    if not cfg.tie_embeddings:
        defs["head"] = ParamDef((cfg.d_model, cfg.padded_vocab), dtype=cfg.dtype)
    return defs


# ----------------------------------------------------------------------------
# Attention block
# ----------------------------------------------------------------------------


def _qkv(cfg: ModelConfig, ops: Ops, p, x, positions):
    B, T, _ = x.shape
    H, KH, hd = cfg.n_heads, cfg.kv_heads, cfg.hd
    q = x @ p["wq"]
    k = x @ p["wk"]
    v = x @ p["wv"]
    if cfg.qkv_bias:
        q, k, v = q + p["bq"], k + p["bk"], v + p["bv"]
    q = q.reshape(B, T, H, hd)
    k = k.reshape(B, T, KH, hd)
    v = v.reshape(B, T, KH, hd)
    if cfg.qk_norm:
        q = ops.rms_norm(q, p["q_norm"], cfg.norm_eps)
        k = ops.rms_norm(k, p["k_norm"], cfg.norm_eps)
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)
    return q, k, v


def attn_full(cfg: ModelConfig, ops: Ops, p, x, positions):
    """Full-sequence causal attention (prefill). Returns (out, (k, v))."""
    q, k, v = _qkv(cfg, ops, p, x, positions)
    out = ops.attention(cfg, q, k, v)
    out = out.reshape(out.shape[0], out.shape[1], -1) @ p["wo"]
    return out, (k, v)


# ----------------------------------------------------------------------------
# Layer + model application
# ----------------------------------------------------------------------------


def layer_full(cfg: ModelConfig, ops: Ops, p, x, positions):
    a, kv = attn_full(cfg, ops, p["attn"], ops.rms_norm(x, p["attn_norm"], cfg.norm_eps),
                      positions)
    x = x + a
    m = swiglu(ops.rms_norm(x, p["mlp_norm"], cfg.norm_eps),
               p["mlp"]["gate"], p["mlp"]["up"], p["mlp"]["down"])
    return x + m, kv


def embed_tokens(cfg: ModelConfig, params, tokens: torch.Tensor) -> torch.Tensor:
    return params["embed"][tokens]  # (B, S, d)


def unembed(cfg: ModelConfig, params, x: torch.Tensor) -> torch.Tensor:
    w = params["head"] if "head" in params else params["embed"].T
    return x @ w


def positions_for(x: torch.Tensor) -> torch.Tensor:
    B, S = x.shape[:2]
    return torch.arange(S, device=x.device).expand(B, S)


def forward(cfg: ModelConfig, ops: Ops, params, tokens: torch.Tensor) -> torch.Tensor:
    """Full causal forward: logits at every position."""
    x = embed_tokens(cfg, params, tokens)
    positions = positions_for(x)
    for lp in params["layers"]:
        x, _ = layer_full(cfg, ops, lp, x, positions)
    x = ops.rms_norm(x, params["final_norm"], cfg.norm_eps)
    return unembed(cfg, params, x)
