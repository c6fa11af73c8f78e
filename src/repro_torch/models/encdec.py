"""Encoder-decoder backbone of seamless-m4t-large-v2 (the audio family).

The speech frontend is a stub, as in the reference: the batch carries
precomputed frame embeddings (B, S_enc, d_model).  The backbone is a
bidirectional encoder and a causal text decoder with cross-attention;
serving encodes the frames once at prefill, projects each decoder layer's
cross-attention K/V from the encoder's output into the cache, and decodes
the text one token at a time from a BOS token.

Every function takes `ops` where the reference takes its sharding `rules`
(`common.KERNELS` or `common.PLAIN`): the encoder's self-attention and the
teacher-forced decoder's cross-attention (T text positions over S_enc
frames) run through `ops.noncausal_attention`, flash attention on the card;
a decode step's self- and cross-attention through `ops.decode_attention`.
Where the reference keeps stacked layers (`enc_layers`, `dec_layers`), the
port keeps lists of per-layer trees, initialised with the stacked arrays'
fan-in.  The cache is the reference's dict {"k", "v", "cross_k",
"cross_v"}; decode writes the self-attention rows in place.
"""

from __future__ import annotations

import torch

from . import transformer as tfm
from .common import ModelConfig, Ops, ParamDef, swiglu

BOS_TOKEN = 1  # the token the prefill's first decoder step reads, as in the reference

# ----------------------------------------------------------------------------
# Parameter templates
# ----------------------------------------------------------------------------


def cross_attn_defs(cfg: ModelConfig, stacked: int = 0) -> dict:
    d, H, KH, hd = cfg.d_model, cfg.n_heads, cfg.kv_heads, cfg.hd
    dt = cfg.dtype
    return {
        "wq": ParamDef((d, H * hd), dtype=dt, stacked=stacked),
        "wk": ParamDef((d, KH * hd), dtype=dt, stacked=stacked),
        "wv": ParamDef((d, KH * hd), dtype=dt, stacked=stacked),
        "wo": ParamDef((H * hd, d), dtype=dt, stacked=stacked),
    }


def enc_layer_defs(cfg: ModelConfig, stacked: int = 0) -> dict:
    return tfm.layer_defs(cfg, stacked)


def dec_layer_defs(cfg: ModelConfig, stacked: int = 0) -> dict:
    d, dff, dt = cfg.d_model, cfg.d_ff, cfg.dtype
    return {
        "attn_norm": ParamDef((d,), init="ones", dtype=dt),
        "attn": tfm.attn_defs(cfg, stacked),
        "cross_norm": ParamDef((d,), init="ones", dtype=dt),
        "cross": cross_attn_defs(cfg, stacked),
        "mlp_norm": ParamDef((d,), init="ones", dtype=dt),
        "mlp": {
            "gate": ParamDef((d, dff), dtype=dt, stacked=stacked),
            "up": ParamDef((d, dff), dtype=dt, stacked=stacked),
            "down": ParamDef((dff, d), dtype=dt, stacked=stacked),
        },
    }


def model_defs(cfg: ModelConfig) -> dict:
    d, dt = cfg.d_model, cfg.dtype
    n_enc, n_dec = cfg.encoder_layers, cfg.n_layers
    return {
        "embed": ParamDef((cfg.padded_vocab, d), scale=0.02, dtype=dt),
        "enc_layers": [enc_layer_defs(cfg, n_enc) for _ in range(n_enc)],
        "enc_norm": ParamDef((d,), init="ones", dtype=dt),
        "dec_layers": [dec_layer_defs(cfg, n_dec) for _ in range(n_dec)],
        "final_norm": ParamDef((d,), init="ones", dtype=dt),
        "head": ParamDef((d, cfg.padded_vocab), dtype=dt),
    }


# ----------------------------------------------------------------------------
# Encoder
# ----------------------------------------------------------------------------


def enc_layer(cfg: ModelConfig, ops: Ops, p, x: torch.Tensor, positions) -> torch.Tensor:
    """One bidirectional encoder layer over (B, S, d)."""
    B, S, _ = x.shape
    q, k, v = tfm._qkv(cfg, ops, p["attn"], ops.rms_norm(x, p["attn_norm"], cfg.norm_eps),
                       positions)
    a = ops.noncausal_attention(cfg, q, k, v)
    x = x + a.reshape(B, S, -1) @ p["attn"]["wo"]
    return mlp_block(cfg, ops, p, x)


def encode(cfg: ModelConfig, ops: Ops, params, frames: torch.Tensor,
           remat: bool = False) -> torch.Tensor:
    """The encoder over precomputed frame embeddings (B, S, d)."""
    x = frames.to(cfg.dtype)
    positions = tfm.positions_for(x)
    x = tfm.run_layers(params["enc_layers"], lambda lp, x: enc_layer(cfg, ops, lp, x, positions),
                       x, remat)
    return ops.rms_norm(x, params["enc_norm"], cfg.norm_eps)


# ----------------------------------------------------------------------------
# Decoder blocks: each returns the residual stream after it
# ----------------------------------------------------------------------------


def cross_kv(cfg: ModelConfig, p, enc_out: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """A layer's cross-attention K and V (B, S_enc, KH, hd) from the encoder
    output (`p` the layer's "cross" tree)."""
    B, S, _ = enc_out.shape
    k = (enc_out @ p["wk"]).reshape(B, S, cfg.kv_heads, cfg.hd)
    v = (enc_out @ p["wv"]).reshape(B, S, cfg.kv_heads, cfg.hd)
    return k.to(cfg.dtype), v.to(cfg.dtype)


def self_block_full(cfg: ModelConfig, ops: Ops, p, x, positions):
    """Causal self-attention over the decoder's T positions. Returns (x, (k, v))."""
    a, kv = tfm.attn_full(cfg, ops, p["attn"], ops.rms_norm(x, p["attn_norm"], cfg.norm_eps),
                          positions)
    return x + a, kv


def cross_block_full(cfg: ModelConfig, ops: Ops, p, x, enc_out):
    """Every text position over every frame (T != S_enc in general)."""
    B, T, _ = x.shape
    h = ops.rms_norm(x, p["cross_norm"], cfg.norm_eps)
    q = (h @ p["cross"]["wq"]).reshape(B, T, cfg.n_heads, cfg.hd)
    k, v = cross_kv(cfg, p["cross"], enc_out)
    out = ops.noncausal_attention(cfg, q, k, v)
    return x + out.reshape(B, T, -1) @ p["cross"]["wo"]


def mlp_block(cfg: ModelConfig, ops: Ops, p, x):
    return x + swiglu(ops.rms_norm(x, p["mlp_norm"], cfg.norm_eps),
                      p["mlp"]["gate"], p["mlp"]["up"], p["mlp"]["down"])


def self_block_decode(cfg: ModelConfig, ops: Ops, p, x, k_cache, v_cache, cur_len):
    """x: (B, 1, d) at position `cur_len`; the layer's self-attention cache
    (B, max_len, KH, hd), written in place. Returns (x, (k, v))."""
    a, kv = tfm.attn_decode(cfg, ops, p["attn"], ops.rms_norm(x, p["attn_norm"], cfg.norm_eps),
                            k_cache, v_cache, cur_len)
    return x + a, kv


def cross_block_decode(cfg: ModelConfig, ops: Ops, p, x, cross_k, cross_v):
    """One token over all S_enc of the layer's cross K/V (B, S_enc, KH, hd)."""
    B = x.shape[0]
    h = ops.rms_norm(x, p["cross_norm"], cfg.norm_eps)
    q = (h @ p["cross"]["wq"]).reshape(B, 1, cfg.n_heads, cfg.hd)
    c = ops.decode_attention(q, cross_k, cross_v, cross_k.shape[1])
    return x + c.reshape(B, 1, -1) @ p["cross"]["wo"]


def dec_layer_full(cfg: ModelConfig, ops: Ops, p, x, positions, enc_out):
    x, kv = self_block_full(cfg, ops, p, x, positions)
    x = cross_block_full(cfg, ops, p, x, enc_out)
    return mlp_block(cfg, ops, p, x), kv


def dec_layer_decode(cfg: ModelConfig, ops: Ops, p, x, k_cache, v_cache, cross_k, cross_v,
                     cur_len):
    x, kv = self_block_decode(cfg, ops, p, x, k_cache, v_cache, cur_len)
    x = cross_block_decode(cfg, ops, p, x, cross_k, cross_v)
    return mlp_block(cfg, ops, p, x), kv


# ----------------------------------------------------------------------------
# Model
# ----------------------------------------------------------------------------


def forward(cfg: ModelConfig, ops: Ops, params, tokens: torch.Tensor,
            frames: torch.Tensor, remat: bool = False, unembed_out: bool = True) -> torch.Tensor:
    """Teacher-forced forward: the encoder over the frames, the decoder over
    the tokens (B, T); logits at every text position (unembed_out=False:
    the final-normed hidden states)."""
    enc_out = encode(cfg, ops, params, frames, remat=remat)
    x = tfm.embed_tokens(cfg, params, tokens)
    positions = tfm.positions_for(x)
    x = tfm.run_layers(params["dec_layers"],
                       lambda lp, x: dec_layer_full(cfg, ops, lp, x, positions, enc_out)[0],
                       x, remat)
    return tfm.head_out(cfg, ops, params, x, unembed_out)


def init_cache(cfg: ModelConfig, batch: int, max_len: int, device: torch.device | str,
               enc_len: int | None = None) -> dict:
    """Empty caches: the decoder's self-attention (L, B, max_len, KH, hd)
    and the cross-attention K/V (L, B, enc_len, KH, hd), enc_len defaulting
    to max_len as in the reference."""
    enc_len = enc_len or max_len
    L, KH, hd = cfg.n_layers, cfg.kv_heads, cfg.hd

    def z(n):
        return torch.zeros((L, batch, n, KH, hd), dtype=cfg.dtype, device=device)

    return {"k": z(max_len), "v": z(max_len), "cross_k": z(enc_len), "cross_v": z(enc_len)}


def prefill(cfg: ModelConfig, ops: Ops, params, frames: torch.Tensor,
            max_len: int | None = None, bos_token: int = BOS_TOKEN) -> tuple[torch.Tensor, dict]:
    """Encode, project every decoder layer's cross K/V into the cache, then
    run the BOS step at position 0.  Returns the BOS step's logits (B, 1, V)
    and the cache, whose valid length is then 1.  `max_len` (the decoder's
    cache length) defaults to S_enc, as in the reference."""
    B, S_enc = frames.shape[:2]
    enc_out = encode(cfg, ops, params, frames)
    cache = init_cache(cfg, B, max_len or S_enc, frames.device, enc_len=S_enc)
    for i, lp in enumerate(params["dec_layers"]):
        cache["cross_k"][i], cache["cross_v"][i] = cross_kv(cfg, lp["cross"], enc_out)
    bos = torch.full((B, 1), bos_token, dtype=torch.long, device=frames.device)
    return decode_step(cfg, ops, params, bos, cache, 0)


def decode_step(cfg: ModelConfig, ops: Ops, params, token: torch.Tensor, cache: dict,
                cur_len) -> tuple[torch.Tensor, dict]:
    """token: (B, 1) ids at position `cur_len` (a Python int or a 0-d
    tensor). Returns the logits (B, 1, V) and the cache, updated in place."""
    x = tfm.embed_tokens(cfg, params, token)
    for i, lp in enumerate(params["dec_layers"]):
        x, _ = dec_layer_decode(cfg, ops, lp, x, cache["k"][i], cache["v"][i],
                                cache["cross_k"][i], cache["cross_v"][i], cur_len)
    x = ops.rms_norm(x, params["final_norm"], cfg.norm_eps)
    return tfm.unembed(cfg, params, x), cache
