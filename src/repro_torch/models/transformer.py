"""Dense decoder-only transformer family: forward, prefill and KV-cache
decode.

Covers stablelm-3b and qwen3-14b (qk_norm, GQA), llava-next-34b (the VLM:
precomputed patch embeddings, `frontend_embeds`, go before the text
embeddings), the shared attention block of the hybrids and the encoder of
the enc-dec family.  Every function takes `ops` where the reference takes
its sharding `rules`: `common.KERNELS` runs the RMSNorm, attention and
decode-attention kernels for CUDA tensors, `common.PLAIN` the reference's
plain math.

The cache is the reference's dict {"k", "v"} of (L, B, max_len, KH, hd)
tensors.  Where the reference writes a new K/V row with
`dynamic_update_slice` and returns new arrays, the port writes it into the
cache in place and returns the same tensors.  `cur_len` may be a Python int
or a 0-d integer tensor; a tensor stays on the device (positions, the cache
row and the decode kernel's `kv_len` are all read there), so a decode loop
needs no host synchronisation.
"""

from __future__ import annotations

import torch

from .common import ModelConfig, Ops, ParamDef, apply_rope, remat_call, swiglu

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


def _cache_index(cur_len, device) -> torch.Tensor:
    """`cur_len` as a 1-element int64 tensor on `device` (no host sync for a
    tensor already there)."""
    return torch.as_tensor(cur_len, device=device).reshape(1).long()


def attn_decode(cfg: ModelConfig, ops: Ops, p, x, k_cache, v_cache, cur_len):
    """One-token attention against the KV cache. x: (B, 1, d); k/v cache
    (B, max_len, KH, hd), written in place at `cur_len`."""
    B = x.shape[0]
    idx = _cache_index(cur_len, x.device)
    positions = idx.expand(B, 1)
    q, k, v = _qkv(cfg, ops, p, x, positions)
    k_cache.index_copy_(1, idx, k.to(k_cache.dtype))
    v_cache.index_copy_(1, idx, v.to(v_cache.dtype))
    out = ops.decode_attention(q, k_cache, v_cache, idx + 1)
    out = out.reshape(B, 1, -1) @ p["wo"]
    return out, (k_cache, v_cache)


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


def layer_decode(cfg: ModelConfig, ops: Ops, p, x, k_cache, v_cache, cur_len):
    a, (k_cache, v_cache) = attn_decode(
        cfg, ops, p["attn"], ops.rms_norm(x, p["attn_norm"], cfg.norm_eps), k_cache, v_cache,
        cur_len)
    x = x + a
    m = swiglu(ops.rms_norm(x, p["mlp_norm"], cfg.norm_eps),
               p["mlp"]["gate"], p["mlp"]["up"], p["mlp"]["down"])
    return x + m, (k_cache, v_cache)


def embed_tokens(cfg: ModelConfig, params, tokens: torch.Tensor,
                 frontend_embeds: torch.Tensor | None = None) -> torch.Tensor:
    """(B, S, d) text embeddings, after the frontend's (B, F, d) embeddings
    (cast to the text dtype) where there are any."""
    x = params["embed"][tokens]
    if frontend_embeds is not None:
        x = torch.cat([frontend_embeds.to(x.dtype), x], dim=1)
    return x


def unembed(cfg: ModelConfig, params, x: torch.Tensor) -> torch.Tensor:
    w = params["head"] if "head" in params else params["embed"].T
    return x @ w


def positions_for(x: torch.Tensor) -> torch.Tensor:
    B, S = x.shape[:2]
    return torch.arange(S, device=x.device).expand(B, S)


def head_out(cfg: ModelConfig, ops: Ops, params, x: torch.Tensor,
             unembed_out: bool = True) -> torch.Tensor:
    """The final norm, then the head's logits (or, with unembed_out=False,
    the normed hidden states, for the chunked-CE loss)."""
    x = ops.rms_norm(x, params["final_norm"], cfg.norm_eps)
    return unembed(cfg, params, x) if unembed_out else x


def run_layers(layers, body, x: torch.Tensor, remat: bool) -> torch.Tensor:
    """x through `body(lp, x)` for each layer's parameters lp in turn; with
    remat, each layer's activations are recomputed in the backward (the
    reference's `jax.checkpoint` of its scan body)."""
    for lp in layers:
        x = remat_call(body, lp, x) if remat else body(lp, x)
    return x


def forward(cfg: ModelConfig, ops: Ops, params, tokens: torch.Tensor,
            frontend_embeds: torch.Tensor | None = None, remat: bool = False,
            unembed_out: bool = True) -> torch.Tensor:
    """Full causal forward: logits at every position, frontend's included
    (unembed_out=False: the final-normed hidden states)."""
    x = embed_tokens(cfg, params, tokens, frontend_embeds)
    positions = positions_for(x)
    x = run_layers(params["layers"], lambda lp, x: layer_full(cfg, ops, lp, x, positions)[0],
                   x, remat)
    return head_out(cfg, ops, params, x, unembed_out)


def init_cache(cfg: ModelConfig, batch: int, max_len: int, device: torch.device | str) -> dict:
    shape = (cfg.n_layers, batch, max_len, cfg.kv_heads, cfg.hd)
    return {"k": torch.zeros(shape, dtype=cfg.dtype, device=device),
            "v": torch.zeros(shape, dtype=cfg.dtype, device=device)}


def prefill(cfg: ModelConfig, ops: Ops, params, tokens: torch.Tensor,
            frontend_embeds: torch.Tensor | None = None,
            max_len: int | None = None) -> tuple[torch.Tensor, dict]:
    """Prefill: fill the KV cache, return last-position logits + cache.  The
    cache's first F + S rows hold the frontend's and the text's positions,
    so decoding continues at `cur_len` F + S."""
    x = embed_tokens(cfg, params, tokens, frontend_embeds)
    B, S, _ = x.shape
    max_len = max_len or S
    positions = positions_for(x)
    cache = init_cache(cfg, B, max_len, x.device)
    for i, lp in enumerate(params["layers"]):
        x, (k, v) = layer_full(cfg, ops, lp, x, positions)
        cache["k"][i, :, :S] = k
        cache["v"][i, :, :S] = v
    x = ops.rms_norm(x[:, -1:].contiguous(), params["final_norm"], cfg.norm_eps)
    return unembed(cfg, params, x), cache


def decode_step(cfg: ModelConfig, ops: Ops, params, token: torch.Tensor, cache: dict,
                cur_len) -> tuple[torch.Tensor, dict]:
    """token: (B, 1) ids; `cur_len`: the cache's valid length, where the new
    row goes.  Returns the logits (B, 1, V) and the cache, updated in place."""
    x = embed_tokens(cfg, params, token)
    for i, lp in enumerate(params["layers"]):
        x, _ = layer_decode(cfg, ops, lp, x, cache["k"][i], cache["v"][i], cur_len)
    x = ops.rms_norm(x, params["final_norm"], cfg.norm_eps)
    return unembed(cfg, params, x), cache
