"""State-space sequence mixers, the Mamba2 (SSD) subset of the reference's
`repro.models.ssm`.

Mamba2's SSD is linear attention with a per-step decay, computed chunk by
chunk: `chunked_linear_attention` is the plain version (the `ssd_scan`
kernel's oracle) and `mamba2_full` reaches it through `ops.linear_attention`,
which on the card is the `ssd_scan` kernel.  The depthwise causal conv and
the decode step's single recurrence step stay plain PyTorch, as they are
plain XLA in the reference.  The xLSTM cells (mLSTM, sLSTM) are not ported.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.kernels.ssd_scan import ops as ssd_ops

from .common import ModelConfig, Ops, ParamDef, ssm_chunk_of

CLIP = ssd_ops.CLIP

# ----------------------------------------------------------------------------
# Chunked linear attention with decay
# ----------------------------------------------------------------------------

# the plain scan is the kernel's plain version: one definition of the math
chunked_linear_attention = ssd_ops.chunked_linear_attention_plain


def linear_attention_step(
    q: torch.Tensor,  # (B, NH, DK)
    k: torch.Tensor,
    v: torch.Tensor,  # (B, NH, DV)
    log_g: torch.Tensor,  # (B, NH)
    state: torch.Tensor,  # (B, NH, DK, DV)
    log_i: torch.Tensor | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Single decode step of the same recurrence."""
    g = torch.exp(torch.clamp(log_g.float(), -CLIP, CLIP))
    i = (torch.exp(torch.clamp(log_i.float(), -CLIP, CLIP)) if log_i is not None
         else torch.ones_like(g))
    kv = torch.einsum("bhd,bhv->bhdv", k.float() * i[..., None], v.float())
    state = g[..., None, None] * state + kv
    y = torch.einsum("bhd,bhdv->bhv", q.float(), state)
    return y.to(v.dtype), state


# ----------------------------------------------------------------------------
# Mamba2 mixer
# ----------------------------------------------------------------------------


def mamba2_dims(cfg: ModelConfig) -> tuple[int, int, int, int]:
    di = cfg.ssm_expand * cfg.d_model
    ds = cfg.d_state
    hd = cfg.ssm_head_dim
    nh = di // hd
    return di, ds, hd, nh


def mamba2_defs(cfg: ModelConfig, stacked: int = 0) -> dict:
    d = cfg.d_model
    di, ds, hd, nh = mamba2_dims(cfg)
    dt = cfg.dtype
    conv_dim = di + 2 * ds
    return {
        "in_proj": ParamDef((d, 2 * di + 2 * ds + nh), dtype=dt, stacked=stacked),
        "conv_w": ParamDef((4, conv_dim), scale=0.5, dtype=dt, stacked=stacked),
        "conv_b": ParamDef((conv_dim,), init="zeros", dtype=dt),
        "A_log": ParamDef((nh,), init="ones", dtype=torch.float32),
        "D": ParamDef((nh,), init="ones", dtype=torch.float32),
        "dt_bias": ParamDef((nh,), init="zeros", dtype=torch.float32),
        "norm": ParamDef((di,), init="ones", dtype=dt),
        "out_proj": ParamDef((di, d), dtype=dt, stacked=stacked),
    }


def _causal_conv(xBC: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv over time. xBC: (B, T, C); w: (K, C)."""
    K, T = w.shape[0], xBC.shape[1]
    pad = F.pad(xBC, (0, 0, K - 1, 0))
    out = pad[:, 0:T] * w[0]
    for i in range(1, K):
        out = out + pad[:, i:i + T] * w[i]
    return F.silu((out + b).float()).to(xBC.dtype)


def mamba2_init_state(cfg: ModelConfig, batch: int, device: torch.device | str) -> dict:
    di, ds, hd, nh = mamba2_dims(cfg)
    return {
        "conv": torch.zeros((batch, 3, di + 2 * ds), dtype=cfg.dtype, device=device),
        "ssm": torch.zeros((batch, nh, ds, hd), dtype=torch.float32, device=device),
    }


def mamba2_full(cfg: ModelConfig, ops: Ops, p, x: torch.Tensor, return_state: bool = False):
    """Full-sequence Mamba2. x: (B, T, d) -> (B, T, d)."""
    B, T, d = x.shape
    di, ds, hd, nh = mamba2_dims(cfg)
    zxbcdt = x @ p["in_proj"]
    z = zxbcdt[..., :di]
    raw = zxbcdt[..., di:di + di + 2 * ds]
    dt_raw = zxbcdt[..., di + di + 2 * ds:]  # (B, T, nh)
    xBC = _causal_conv(raw, p["conv_w"], p["conv_b"])
    xs = xBC[..., :di].reshape(B, T, nh, hd)
    Bm = xBC[..., di:di + ds]
    Cm = xBC[..., di + ds:]
    dt = F.softplus(dt_raw.float() + p["dt_bias"])  # (B, T, nh)
    A = -torch.exp(p["A_log"].float())
    log_g = dt * A  # <= 0
    # the head broadcast stays a view (head stride 0); the kernel reads it as is
    k = Bm[:, :, None, :].expand(B, T, nh, ds)
    q = Cm[:, :, None, :].expand(B, T, nh, ds)
    v = xs * dt[..., None].to(xs.dtype)
    y, S = ops.linear_attention(q, k, v, log_g, chunk=ssm_chunk_of(cfg, T))
    y = y + xs * p["D"].to(xs.dtype)[:, None]
    y = y.reshape(B, T, di)
    y = ops.rms_norm(y * F.silu(z.float()).to(y.dtype), p["norm"], cfg.norm_eps)
    out = y @ p["out_proj"]
    if return_state:
        T3 = min(3, T)
        cs = torch.zeros((B, 3, di + 2 * ds), dtype=x.dtype, device=x.device)
        cs[:, 3 - T3:] = raw[:, -T3:]
        return out, {"conv": cs, "ssm": S}
    return out


def mamba2_step(cfg: ModelConfig, ops: Ops, p, x: torch.Tensor, state: dict):
    """Single-token Mamba2. x: (B, 1, d).  Returns (out, new state); the
    state dict passed in is not modified."""
    B = x.shape[0]
    di, ds, hd, nh = mamba2_dims(cfg)
    zxbcdt = (x @ p["in_proj"])[:, 0]
    z = zxbcdt[..., :di]
    xBC_new = zxbcdt[..., di:di + di + 2 * ds]
    dt_raw = zxbcdt[..., di + di + 2 * ds:]
    conv = torch.cat([state["conv"], xBC_new[:, None]], dim=1)  # (B, 4, C)
    xBC = F.silu((torch.einsum("bkc,kc->bc", conv, p["conv_w"]) + p["conv_b"]).float())
    xBC = xBC.to(x.dtype)
    xs = xBC[..., :di].reshape(B, nh, hd)
    Bm = xBC[..., di:di + ds]
    Cm = xBC[..., di + ds:]
    dt = F.softplus(dt_raw.float() + p["dt_bias"])  # (B, nh)
    A = -torch.exp(p["A_log"].float())
    log_g = dt * A
    k = Bm[:, None, :].expand(B, nh, ds)
    q = Cm[:, None, :].expand(B, nh, ds)
    v = xs * dt[..., None].to(xs.dtype)
    y, S = linear_attention_step(q, k, v, log_g, state["ssm"])
    y = y + xs * p["D"].to(xs.dtype)[None, :, None]
    y = y.reshape(B, 1, di)
    y = ops.rms_norm(y * F.silu(z[:, None].float()).to(y.dtype), p["norm"], cfg.norm_eps)
    out = y @ p["out_proj"]
    return out, {"conv": conv[:, 1:], "ssm": S}
