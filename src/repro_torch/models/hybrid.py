"""Hybrid / recurrent model assemblies, the reference's `repro.models.hybrid`:
xlstm-1.3b and zamba2-2.7b.

Both are built from a repeating layer-group period:
  * xlstm-1.3b : ("M"*7 + "s") x 6  — 7 mLSTM blocks then 1 sLSTM block
  * zamba2-2.7b: ("m"*5 + "a") x 9  — 5 Mamba2 blocks then the *shared*
    attention block (one parameter set applied at every 'a' position, each
    application with its own KV cache)

The reference scans over groups and layers; the port loops.  Parameters
keep the reference's grouping as nested lists, `params["inner"][g][k]` for
the (G, K) stack and `params["outer"][g]` for the G sLSTM blocks, with the
stacked arrays' init formula (a normal leaf's fan-in is the group count G,
`ParamDef.stacked`); `shared_attn` is one unstacked dense layer.

Caches keep the reference's keys and shapes: `inner` holds the inner
blocks' states stacked (G, K, ...), `outer` the sLSTM states (G, B, nh, hd)
keyed c, n, h, m, `attn_k` / `attn_v` the shared block's KV caches
(G, B, max_len, KH, hd).  `decode_step` updates the cache tensors in place
and returns the same dict.
"""

from __future__ import annotations

import torch

from . import ssm
from . import transformer as tfm
from .common import ModelConfig, Ops, ParamDef, remat_call

_FULL = {"m": ssm.mamba2_full, "M": ssm.mlstm_full}
_STEP = {"m": ssm.mamba2_step, "M": ssm.mlstm_step}
_STATE0 = {"m": ssm.mamba2_init_state, "M": ssm.mlstm_init_state}
_DEFS = {"m": ssm.mamba2_defs, "M": ssm.mlstm_defs, "s": ssm.slstm_defs}


def parse_pattern(cfg: ModelConfig) -> tuple[str, int]:
    """Return (period, n_groups).  The pattern must be periodic; its period
    is K inner blocks (Mamba2 'm' or mLSTM 'M') and at most one outer block
    at the end (the shared attention block 'a' or an sLSTM block 's'), the
    forms the reference's assembly expresses."""
    pat = cfg.ssm_pattern
    if not pat or len(pat) != cfg.n_layers:
        raise ValueError(f"pattern {pat!r} does not cover {cfg.n_layers} layers")
    period = pat
    for plen in range(1, len(pat) + 1):
        if len(pat) % plen == 0 and pat == pat[:plen] * (len(pat) // plen):
            period = pat[:plen]
            break
    inner, outer = period[0], _outer_kind(period)
    if inner not in _FULL or period != inner * _n_inner(period) + (outer or ""):
        raise ValueError(f"period {period!r}: inner blocks ('m' or 'M') followed by at most "
                         f"one outer block ('a' or 's')")
    return period, len(pat) // len(period)


def _outer_kind(period: str) -> str | None:
    return period[-1] if period[-1] != period[0] else None  # 'a' | 's' | None


def _n_inner(period: str) -> int:
    return sum(1 for c in period if c == period[0])


def _mixer_block_defs(cfg: ModelConfig, kind: str, stacked: int) -> dict:
    return {
        "norm": ParamDef((cfg.d_model,), init="ones", dtype=cfg.dtype),
        "mixer": _DEFS[kind](cfg, stacked),
    }


def model_defs(cfg: ModelConfig) -> dict:
    period, G = parse_pattern(cfg)
    K = _n_inner(period)
    outer = _outer_kind(period)
    defs = {
        "embed": ParamDef((cfg.padded_vocab, cfg.d_model), scale=0.02, dtype=cfg.dtype),
        "inner": [[_mixer_block_defs(cfg, period[0], G) for _ in range(K)] for _ in range(G)],
        "final_norm": ParamDef((cfg.d_model,), init="ones", dtype=cfg.dtype),
        "head": ParamDef((cfg.d_model, cfg.padded_vocab), dtype=cfg.dtype),
    }
    if outer == "a":
        defs["shared_attn"] = tfm.layer_defs(cfg)  # ONE shared block, not stacked
    elif outer == "s":
        defs["outer"] = [_mixer_block_defs(cfg, "s", G) for _ in range(G)]
    return defs


def _apply_inner_full(cfg, ops, kind, p, x, return_state=False):
    h = ops.rms_norm(x, p["norm"], cfg.norm_eps)
    if return_state:
        y, st = _FULL[kind](cfg, ops, p["mixer"], h, return_state=True)
        return x + y, st
    return x + _FULL[kind](cfg, ops, p["mixer"], h), None


def _apply_inner_step(cfg, ops, kind, p, x, state):
    h = ops.rms_norm(x, p["norm"], cfg.norm_eps)
    y, st = _STEP[kind](cfg, ops, p["mixer"], h, state)
    return x + y, st


def _apply_slstm_full(cfg, ops, p, x):
    y, st = ssm.slstm_full(cfg, ops, p["mixer"], ops.rms_norm(x, p["norm"], cfg.norm_eps),
                           return_state=True)
    return x + y, st


def _apply_slstm_step(cfg, ops, p, x, state):
    y, st = ssm.slstm_step(cfg, ops, p["mixer"], ops.rms_norm(x, p["norm"], cfg.norm_eps),
                           state)
    return x + y, st


# ----------------------------------------------------------------------------
# forward / prefill / decode
# ----------------------------------------------------------------------------


def forward(cfg: ModelConfig, ops: Ops, params, tokens: torch.Tensor, remat: bool = False,
            unembed_out: bool = True) -> torch.Tensor:
    """Logits at every position (unembed_out=False: the final-normed hidden
    states); with remat each group (its inner blocks and its outer block) is
    recomputed in the backward, as the reference checkpoints its group body."""
    period, G = parse_pattern(cfg)
    inner, outer = period[0], _outer_kind(period)
    x = tfm.embed_tokens(cfg, params, tokens)
    positions = tfm.positions_for(x)

    def group_body(g: int, x: torch.Tensor) -> torch.Tensor:
        for lp in params["inner"][g]:
            x, _ = _apply_inner_full(cfg, ops, inner, lp, x)
        if outer == "a":
            x, _ = tfm.layer_full(cfg, ops, params["shared_attn"], x, positions)
        elif outer == "s":
            x, _ = _apply_slstm_full(cfg, ops, params["outer"][g], x)
        return x

    for g in range(len(params["inner"])):
        x = remat_call(group_body, g, x) if remat else group_body(g, x)
    return tfm.head_out(cfg, ops, params, x, unembed_out)


def init_cache(cfg: ModelConfig, batch: int, max_len: int, device: torch.device | str) -> dict:
    period, G = parse_pattern(cfg)
    K = _n_inner(period)
    outer = _outer_kind(period)
    st0 = _STATE0[period[0]](cfg, batch, device)
    cache = {"inner": {name: a.expand((G, K) + a.shape).clone() for name, a in st0.items()}}
    if outer == "a":
        shape = (G, batch, max_len, cfg.kv_heads, cfg.hd)
        cache["attn_k"] = torch.zeros(shape, dtype=cfg.dtype, device=device)
        cache["attn_v"] = torch.zeros(shape, dtype=cfg.dtype, device=device)
    elif outer == "s":
        s0 = ssm.slstm_init_state(cfg, batch, device)
        cache["outer"] = {name: a.expand((G,) + a.shape).clone() for name, a in s0.items()}
    return cache


def prefill(cfg: ModelConfig, ops: Ops, params, tokens: torch.Tensor,
            max_len: int | None = None) -> tuple[torch.Tensor, dict]:
    """Prefill: the recurrent states and the shared block's KV caches;
    returns last-position logits + cache."""
    period, G = parse_pattern(cfg)
    inner, outer = period[0], _outer_kind(period)
    x = tfm.embed_tokens(cfg, params, tokens)
    B, S, _ = x.shape
    max_len = max_len or S
    positions = tfm.positions_for(x)
    cache = init_cache(cfg, B, max_len, x.device)
    for g, group in enumerate(params["inner"]):
        for j, lp in enumerate(group):
            x, st = _apply_inner_full(cfg, ops, inner, lp, x, return_state=True)
            for name, a in st.items():
                cache["inner"][name][g, j] = a
        if outer == "a":
            x, (k, v) = tfm.layer_full(cfg, ops, params["shared_attn"], x, positions)
            cache["attn_k"][g, :, :S] = k
            cache["attn_v"][g, :, :S] = v
        elif outer == "s":
            x, st = _apply_slstm_full(cfg, ops, params["outer"][g], x)
            for name, a in st.items():
                cache["outer"][name][g] = a
    x = ops.rms_norm(x[:, -1:].contiguous(), params["final_norm"], cfg.norm_eps)
    return tfm.unembed(cfg, params, x), cache


def decode_step(cfg: ModelConfig, ops: Ops, params, token: torch.Tensor, cache: dict,
                cur_len) -> tuple[torch.Tensor, dict]:
    """token: (B, 1) ids; `cur_len`: the KV caches' valid length.  Returns
    the logits (B, 1, V) and the cache, updated in place."""
    period, G = parse_pattern(cfg)
    inner, outer = period[0], _outer_kind(period)
    x = tfm.embed_tokens(cfg, params, token)
    states = cache["inner"]
    for g, group in enumerate(params["inner"]):
        for j, lp in enumerate(group):
            state = {name: a[g, j] for name, a in states.items()}
            x, st = _apply_inner_step(cfg, ops, inner, lp, x, state)
            for name, a in st.items():
                states[name][g, j] = a
        if outer == "a":
            x, _ = tfm.layer_decode(cfg, ops, params["shared_attn"], x, cache["attn_k"][g],
                                    cache["attn_v"][g], cur_len)
        elif outer == "s":
            state = {name: a[g] for name, a in cache["outer"].items()}
            x, st = _apply_slstm_step(cfg, ops, params["outer"][g], x, state)
            for name, a in st.items():
                cache["outer"][name][g] = a
    x = ops.rms_norm(x, params["final_norm"], cfg.norm_eps)
    return tfm.unembed(cfg, params, x), cache
