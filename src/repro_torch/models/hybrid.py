"""Hybrid model assembly, the Mamba2 subset of the reference's
`repro.models.hybrid`: zamba2-2.7b.

The layer pattern is a repeating period of Mamba2 blocks ending in the
*shared* attention block: ("m"*5 + "a") x 9 for zamba2-2.7b, one parameter
set applied at every 'a' position, each application with its own KV cache.
The reference scans over groups and layers; the port loops.  Parameters
keep the reference's grouping as nested lists, `params["inner"][g][k]` for
the (G, K) stack, with the stacked arrays' init formula (a normal leaf's
fan-in is the group count G, `ParamDef.stacked`); `shared_attn` is one
unstacked dense layer.

Caches keep the reference's keys and shapes: `inner` holds the Mamba2
states stacked (G, K, ...), `attn_k` / `attn_v` the shared block's KV
caches (G, B, max_len, KH, hd).  `decode_step` updates the cache tensors in
place and returns the same dict.  Patterns with xLSTM blocks (`M`, `s`) are
not ported.
"""

from __future__ import annotations

import torch

from . import ssm
from . import transformer as tfm
from .common import ModelConfig, Ops, ParamDef


def parse_pattern(cfg: ModelConfig) -> tuple[str, int]:
    """Return (period, n_groups).  The pattern must be periodic, made of
    Mamba2 blocks with one shared attention block at the end."""
    pat = cfg.ssm_pattern
    if not pat or len(pat) != cfg.n_layers:
        raise ValueError(f"pattern {pat!r} does not cover {cfg.n_layers} layers")
    if set(pat) & set("Ms"):
        raise NotImplementedError(
            f"pattern {pat!r} has xLSTM blocks (M, s): the mLSTM/sLSTM cells wait for the "
            f"xLSTM slice of the port")
    period = pat
    for plen in range(1, len(pat) + 1):
        if len(pat) % plen == 0 and pat == pat[:plen] * (len(pat) // plen):
            period = pat[:plen]
            break
    if set(period) - set("ma") or period[0] != "m" or "a" in period[:-1]:
        raise NotImplementedError(f"period {period!r}: the port takes Mamba2 blocks ('m') "
                                  f"with at most one shared attention block ('a') at the end")
    return period, len(pat) // len(period)


def _has_attn(period: str) -> bool:
    return period[-1] == "a"


def _n_inner(period: str) -> int:
    return sum(1 for c in period if c == "m")


def _mixer_block_defs(cfg: ModelConfig, stacked: int) -> dict:
    return {
        "norm": ParamDef((cfg.d_model,), init="ones", dtype=cfg.dtype),
        "mixer": ssm.mamba2_defs(cfg, stacked),
    }


def model_defs(cfg: ModelConfig) -> dict:
    period, G = parse_pattern(cfg)
    K = _n_inner(period)
    defs = {
        "embed": ParamDef((cfg.padded_vocab, cfg.d_model), scale=0.02, dtype=cfg.dtype),
        "inner": [[_mixer_block_defs(cfg, G) for _ in range(K)] for _ in range(G)],
        "final_norm": ParamDef((cfg.d_model,), init="ones", dtype=cfg.dtype),
        "head": ParamDef((cfg.d_model, cfg.padded_vocab), dtype=cfg.dtype),
    }
    if _has_attn(period):
        defs["shared_attn"] = tfm.layer_defs(cfg)  # ONE shared block, not stacked
    return defs


def _apply_inner_full(cfg, ops, p, x, return_state=False):
    h = ops.rms_norm(x, p["norm"], cfg.norm_eps)
    if return_state:
        y, st = ssm.mamba2_full(cfg, ops, p["mixer"], h, return_state=True)
        return x + y, st
    return x + ssm.mamba2_full(cfg, ops, p["mixer"], h), None


def _apply_inner_step(cfg, ops, p, x, state):
    h = ops.rms_norm(x, p["norm"], cfg.norm_eps)
    y, st = ssm.mamba2_step(cfg, ops, p["mixer"], h, state)
    return x + y, st


# ----------------------------------------------------------------------------
# forward / prefill / decode
# ----------------------------------------------------------------------------


def forward(cfg: ModelConfig, ops: Ops, params, tokens: torch.Tensor) -> torch.Tensor:
    period, G = parse_pattern(cfg)
    x = tfm.embed_tokens(cfg, params, tokens)
    positions = tfm.positions_for(x)
    for group in params["inner"]:
        for lp in group:
            x, _ = _apply_inner_full(cfg, ops, lp, x)
        if _has_attn(period):
            x, _ = tfm.layer_full(cfg, ops, params["shared_attn"], x, positions)
    x = ops.rms_norm(x, params["final_norm"], cfg.norm_eps)
    return tfm.unembed(cfg, params, x)


def init_cache(cfg: ModelConfig, batch: int, max_len: int, device: torch.device | str) -> dict:
    period, G = parse_pattern(cfg)
    K = _n_inner(period)
    st0 = ssm.mamba2_init_state(cfg, batch, device)
    cache = {"inner": {name: a.expand((G, K) + a.shape).clone() for name, a in st0.items()}}
    if _has_attn(period):
        shape = (G, batch, max_len, cfg.kv_heads, cfg.hd)
        cache["attn_k"] = torch.zeros(shape, dtype=cfg.dtype, device=device)
        cache["attn_v"] = torch.zeros(shape, dtype=cfg.dtype, device=device)
    return cache


def prefill(cfg: ModelConfig, ops: Ops, params, tokens: torch.Tensor,
            max_len: int | None = None) -> tuple[torch.Tensor, dict]:
    """Prefill: the Mamba2 states and the shared block's KV caches; returns
    last-position logits + cache."""
    period, G = parse_pattern(cfg)
    x = tfm.embed_tokens(cfg, params, tokens)
    B, S, _ = x.shape
    max_len = max_len or S
    positions = tfm.positions_for(x)
    cache = init_cache(cfg, B, max_len, x.device)
    for g, group in enumerate(params["inner"]):
        for j, lp in enumerate(group):
            x, st = _apply_inner_full(cfg, ops, lp, x, return_state=True)
            for name, a in st.items():
                cache["inner"][name][g, j] = a
        if _has_attn(period):
            x, (k, v) = tfm.layer_full(cfg, ops, params["shared_attn"], x, positions)
            cache["attn_k"][g, :, :S] = k
            cache["attn_v"][g, :, :S] = v
    x = ops.rms_norm(x[:, -1:].contiguous(), params["final_norm"], cfg.norm_eps)
    return tfm.unembed(cfg, params, x), cache


def decode_step(cfg: ModelConfig, ops: Ops, params, token: torch.Tensor, cache: dict,
                cur_len) -> tuple[torch.Tensor, dict]:
    """token: (B, 1) ids; `cur_len`: the KV caches' valid length.  Returns
    the logits (B, 1, V) and the cache, updated in place."""
    period, G = parse_pattern(cfg)
    x = tfm.embed_tokens(cfg, params, token)
    inner = cache["inner"]
    for g, group in enumerate(params["inner"]):
        for j, lp in enumerate(group):
            state = {name: a[g, j] for name, a in inner.items()}
            x, st = _apply_inner_step(cfg, ops, lp, x, state)
            for name, a in st.items():
                inner[name][g, j] = a
        if _has_attn(period):
            x, _ = tfm.layer_decode(cfg, ops, params["shared_attn"], x, cache["attn_k"][g],
                                    cache["attn_v"][g], cur_len)
    x = ops.rms_norm(x, params["final_norm"], cfg.norm_eps)
    return tfm.unembed(cfg, params, x), cache
