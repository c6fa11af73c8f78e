"""Mixture-of-Experts FFN and the MoE transformer (llama4-maverick-400b-a17b).

The counterpart of the reference's `repro.models.moe`.  Dispatch is
sort-based with a per-expert capacity, as there: the router in f32, softmax,
top-k and the weights renormalised; the (token, choice) pairs stably sorted
by expert, each pair's position within its expert's group, and a scatter
into an (E, capacity, d) buffer in which the pairs past the capacity are
dropped; the experts' SwiGLU as batched products over E (`torch.bmm`, where
the reference has XLA einsums: plain large products, no Pallas kernel);
then the gather, weighting and un-sort back to token order.  The capacity
is a host int from the static token count, and nothing in the dispatch
reads the routing on the host or takes a shape from it, so a decode loop
stays free of host synchronisation.

Every function takes `ops` where the reference takes its sharding `rules`
(`common.KERNELS` or `common.PLAIN`); the MoE FFN itself runs no kernel of
the repository.  Where the reference keeps stacked layers, the port keeps a
list of per-layer trees, initialised with the stacked arrays' fan-in.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from . import transformer as tfm
from .common import ModelConfig, Ops, ParamDef, swiglu

# ----------------------------------------------------------------------------
# The MoE FFN
# ----------------------------------------------------------------------------


def moe_ffn_defs(cfg: ModelConfig, stacked: int = 0) -> dict:
    d, E, ff = cfg.d_model, cfg.n_experts, cfg.moe_d_ff or cfg.d_ff
    dt = cfg.dtype
    defs = {
        "router": ParamDef((d, E), scale=0.02, dtype=torch.float32),
        "gate": ParamDef((E, d, ff), dtype=dt, stacked=stacked),
        "up": ParamDef((E, d, ff), dtype=dt, stacked=stacked),
        "down": ParamDef((E, ff, d), dtype=dt, stacked=stacked),
    }
    if cfg.n_shared_experts:
        sff = ff * cfg.n_shared_experts
        defs["shared"] = {
            "gate": ParamDef((d, sff), dtype=dt, stacked=stacked),
            "up": ParamDef((d, sff), dtype=dt, stacked=stacked),
            "down": ParamDef((sff, d), dtype=dt, stacked=stacked),
        }
    return defs


def capacity(cfg: ModelConfig, n_tokens: int) -> int:
    """Rows of each expert's buffer for a group of `n_tokens` tokens."""
    return max(8, int(math.ceil(n_tokens * cfg.top_k / cfg.n_experts * cfg.capacity_factor)))


def route(cfg: ModelConfig, p, xf: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """The router over (..., n, d) tokens: the top-k experts' renormalised
    f32 weights and their ids, each (..., n, k)."""
    probs = torch.softmax(xf.float() @ p["router"], dim=-1)
    weights, ids = torch.topk(probs, cfg.top_k, dim=-1)
    return weights / torch.clamp(weights.sum(-1, keepdim=True), min=1e-9), ids


def _plan(cfg: ModelConfig, ids: torch.Tensor):
    """The sort-based dispatch of (G, n, k) expert ids: each group's (token,
    choice) pairs stably sorted by expert (`jnp.argsort` is stable), and
    for each sorted pair its position within its expert's group and whether
    that is within the capacity.  Returns (cap, sort_idx, sorted_ids, pos,
    valid), the last four (G, n k)."""
    G, n, k = ids.shape
    E = cfg.n_experts
    cap = capacity(cfg, n)
    flat = ids.reshape(G, n * k)
    sort_idx = torch.argsort(flat, dim=-1, stable=True)
    sorted_ids = torch.gather(flat, 1, sort_idx)
    experts = torch.arange(E, device=ids.device, dtype=sorted_ids.dtype).expand(G, E)
    group_start = torch.searchsorted(sorted_ids, experts.contiguous(), side="left")
    pos = torch.arange(n * k, device=ids.device) - torch.gather(group_start, 1, sorted_ids)
    return cap, sort_idx, sorted_ids, pos, pos < cap


def _dispatch_compute(cfg: ModelConfig, p, xf: torch.Tensor) -> torch.Tensor:
    """Sort-dispatch, the experts' SwiGLU and the weighted combine over G
    groups of tokens at once, xf (G, n, d) -> (G, n, d); each group is
    dispatched alone, with its own capacity, as the reference's vmap over
    groups does."""
    G, n, d = xf.shape
    E, k = cfg.n_experts, cfg.top_k
    weights, ids = route(cfg, p, xf)
    cap, sort_idx, sorted_ids, pos, valid = _plan(cfg, ids)
    token_idx = sort_idx // k
    group = torch.arange(G, device=xf.device)[:, None]

    # the scatter: a dropped pair goes to the spare row `cap`, sliced off
    # (the reference's mode="drop")
    buf = torch.zeros((G, E, cap + 1, d), dtype=xf.dtype, device=xf.device)
    buf[group, sorted_ids, torch.where(valid, pos, cap)] = xf[group, token_idx]
    # the experts: one batched product over E of every group's rows
    rows = buf[:, :, :cap].transpose(0, 1).reshape(E, G * cap, d)
    g = torch.bmm(rows, p["gate"])
    u = torch.bmm(rows, p["up"])
    h = F.silu(g.float()).to(xf.dtype) * u
    out_buf = torch.bmm(h, p["down"]).reshape(E, G, cap, d).transpose(0, 1)

    # the gather back, the weighting and the un-sort
    routed = out_buf[group, sorted_ids, torch.clamp(pos, max=cap - 1)]  # (G, n k, d)
    routed = torch.where(valid[..., None], routed, torch.zeros((), dtype=routed.dtype,
                                                               device=routed.device))
    w = torch.gather(weights.reshape(G, n * k), 1, sort_idx).to(routed.dtype)
    routed = routed * w[..., None]
    inv = torch.argsort(sort_idx, dim=-1)
    routed = torch.gather(routed, 1, inv[..., None].expand(G, n * k, d))
    # the sum over k in f32, as jnp.sum takes a bf16 sum
    return routed.reshape(G, n, k, d).float().sum(dim=2).to(xf.dtype)


def _groups(cfg: ModelConfig, N: int) -> int:
    """Token groups dispatched apart: `moe_dispatch_groups` where it divides
    the N tokens into groups of at least 2, as in the reference; else 1."""
    G = cfg.moe_dispatch_groups
    return G if G > 1 and N % G == 0 and N >= 2 * G else 1


def moe_ffn(cfg: ModelConfig, ops: Ops, p, x: torch.Tensor) -> torch.Tensor:
    """x: (B, T, d) -> (B, T, d): the routed experts plus the shared ones.
    `moe_weight_gather` is a sharding hint of the reference (the expert
    weights gathered over the data-parallel axis at their use); on one
    device it changes nothing, and the port reads it nowhere."""
    B, T, d = x.shape
    N = B * T
    G = _groups(cfg, N)
    out = _dispatch_compute(cfg, p, x.reshape(G, N // G, d)).reshape(B, T, d)
    if cfg.n_shared_experts:
        sp = p["shared"]
        out = out + swiglu(x, sp["gate"], sp["up"], sp["down"])
    return out


def routing(cfg: ModelConfig, p, x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """The routing decisions of `moe_ffn` over x (B, T, d), for checks: each
    token's expert ids and whether each choice was within its expert's
    capacity (not dropped), both (B, T, k) in token order."""
    B, T, d = x.shape
    N = B * T
    G = _groups(cfg, N)
    _, ids = route(cfg, p, x.reshape(G, N // G, d))
    _, sort_idx, _, _, valid = _plan(cfg, ids)
    keep = torch.empty_like(valid)
    keep.scatter_(1, sort_idx, valid)
    return ids.reshape(B, T, cfg.top_k), keep.reshape(B, T, cfg.top_k)


def aux_load_balance_loss(cfg: ModelConfig, p, x: torch.Tensor) -> torch.Tensor:
    """Switch-style load-balance auxiliary loss (training): E times the sum
    over experts of the share of tokens whose top choice it is and its mean
    router probability.  As in the reference, no `loss` calls it."""
    B, T, d = x.shape
    probs = torch.softmax(x.reshape(B * T, d).float() @ p["router"], dim=-1)
    ids = probs.argmax(dim=-1)
    frac = F.one_hot(ids, cfg.n_experts).float().mean(dim=0)
    imp = probs.mean(dim=0)
    return cfg.n_experts * (frac * imp).sum()


# ----------------------------------------------------------------------------
# The MoE transformer (llama4: GQA attention and an MoE FFN in every layer)
# ----------------------------------------------------------------------------


def layer_defs(cfg: ModelConfig, stacked: int = 0) -> dict:
    d, dt = cfg.d_model, cfg.dtype
    return {
        "attn_norm": ParamDef((d,), init="ones", dtype=dt),
        "attn": tfm.attn_defs(cfg, stacked),
        "mlp_norm": ParamDef((d,), init="ones", dtype=dt),
        "moe": moe_ffn_defs(cfg, stacked),
    }


def model_defs(cfg: ModelConfig) -> dict:
    return {
        "embed": ParamDef((cfg.padded_vocab, cfg.d_model), scale=0.02, dtype=cfg.dtype),
        "layers": [layer_defs(cfg, cfg.n_layers) for _ in range(cfg.n_layers)],
        "final_norm": ParamDef((cfg.d_model,), init="ones", dtype=cfg.dtype),
        "head": ParamDef((cfg.d_model, cfg.padded_vocab), dtype=cfg.dtype),
    }


# A layer is two blocks, each returning the residual stream after it: the
# attention block (with what it adds to the cache) and the FFN block.


def attn_block_full(cfg: ModelConfig, ops: Ops, p, x, positions):
    a, kv = tfm.attn_full(cfg, ops, p["attn"], ops.rms_norm(x, p["attn_norm"], cfg.norm_eps),
                          positions)
    return x + a, kv


def attn_block_decode(cfg: ModelConfig, ops: Ops, p, x, k_cache, v_cache, cur_len):
    a, caches = tfm.attn_decode(cfg, ops, p["attn"],
                                ops.rms_norm(x, p["attn_norm"], cfg.norm_eps), k_cache, v_cache,
                                cur_len)
    return x + a, caches


def ffn_block(cfg: ModelConfig, ops: Ops, p, x: torch.Tensor) -> torch.Tensor:
    """The residual stream after a layer's MoE FFN."""
    return x + moe_ffn(cfg, ops, p["moe"], ops.rms_norm(x, p["mlp_norm"], cfg.norm_eps))


def ffn_routing(cfg: ModelConfig, ops: Ops, p, x: torch.Tensor):
    """`routing` of the FFN block over the residual stream x: what its MoE
    decides for each token."""
    return routing(cfg, p["moe"], ops.rms_norm(x, p["mlp_norm"], cfg.norm_eps))


def layer_full(cfg: ModelConfig, ops: Ops, p, x, positions):
    x, kv = attn_block_full(cfg, ops, p, x, positions)
    return ffn_block(cfg, ops, p, x), kv


def layer_decode(cfg: ModelConfig, ops: Ops, p, x, k_cache, v_cache, cur_len):
    x, caches = attn_block_decode(cfg, ops, p, x, k_cache, v_cache, cur_len)
    return ffn_block(cfg, ops, p, x), caches


def layers(params) -> list:
    """The layers in order."""
    return list(params["layers"])


def forward(cfg: ModelConfig, ops: Ops, params, tokens: torch.Tensor,
            frontend_embeds: torch.Tensor | None = None, remat: bool = False,
            unembed_out: bool = True) -> torch.Tensor:
    x = tfm.embed_tokens(cfg, params, tokens, frontend_embeds)
    positions = tfm.positions_for(x)
    x = tfm.run_layers(params["layers"],
                       lambda lp, x: layer_full(cfg, ops, lp, x, positions)[0], x, remat)
    return tfm.head_out(cfg, ops, params, x, unembed_out)


init_cache = tfm.init_cache


def prefill(cfg: ModelConfig, ops: Ops, params, tokens: torch.Tensor,
            frontend_embeds: torch.Tensor | None = None,
            max_len: int | None = None) -> tuple[torch.Tensor, dict]:
    x = tfm.embed_tokens(cfg, params, tokens, frontend_embeds)
    B, S, _ = x.shape
    positions = tfm.positions_for(x)
    cache = init_cache(cfg, B, max_len or S, x.device)
    for i, lp in enumerate(params["layers"]):
        x, (k, v) = layer_full(cfg, ops, lp, x, positions)
        cache["k"][i, :, :S] = k
        cache["v"][i, :, :S] = v
    x = ops.rms_norm(x[:, -1:].contiguous(), params["final_norm"], cfg.norm_eps)
    return tfm.unembed(cfg, params, x), cache


def decode_step(cfg: ModelConfig, ops: Ops, params, token: torch.Tensor, cache: dict,
                cur_len) -> tuple[torch.Tensor, dict]:
    """token: (B, 1) ids; the cache is updated in place at `cur_len`."""
    x = tfm.embed_tokens(cfg, params, token)
    for i, lp in enumerate(params["layers"]):
        x, _ = layer_decode(cfg, ops, lp, x, cache["k"][i], cache["v"][i], cur_len)
    x = ops.rms_norm(x, params["final_norm"], cfg.norm_eps)
    return tfm.unembed(cfg, params, x), cache
