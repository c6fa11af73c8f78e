"""State-space sequence mixers: Mamba2 (SSD) and the xLSTM cells (mLSTM,
sLSTM), the reference's `repro.models.ssm`.

Mamba2's SSD and the mLSTM are both linear attention with a per-step decay,
computed chunk by chunk: `chunked_linear_attention` is the plain version
(the `ssd_scan` kernel's oracle), and `mamba2_full` and `mlstm_full` reach
it through `ops.linear_attention`, which on the card is the `ssd_scan`
kernel (the mLSTM at state widths (hd, hd + 1): v carries a ones column
whose state column is the normaliser).  The depthwise causal conv, the
decode steps' single recurrence step and the sLSTM's recurrence over time
stay plain PyTorch on every device, because the reference computes them in
plain XLA (`lax.scan` for the sLSTM) with no Pallas kernel to port: they
are the reference's math, not a fallback.
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
    """Single decode step of the same recurrence, plain PyTorch on every
    device: the reference runs it in plain XLA, with no kernel to port, so
    this is its math on the card, not a fallback."""
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


# ----------------------------------------------------------------------------
# mLSTM (xLSTM matrix-memory cell)
# ----------------------------------------------------------------------------


def mlstm_dims(cfg: ModelConfig) -> tuple[int, int, int]:
    di = cfg.ssm_expand * cfg.d_model
    nh = cfg.n_heads
    hd = di // nh
    return di, nh, hd


def mlstm_defs(cfg: ModelConfig, stacked: int = 0) -> dict:
    d = cfg.d_model
    di, nh, hd = mlstm_dims(cfg)
    dt = cfg.dtype
    return {
        "up": ParamDef((d, 2 * di), dtype=dt, stacked=stacked),
        "wq": ParamDef((di, di), dtype=dt, stacked=stacked),
        "wk": ParamDef((di, di), dtype=dt, stacked=stacked),
        "wv": ParamDef((di, di), dtype=dt, stacked=stacked),
        "wif": ParamDef((di, 2 * nh), scale=0.02, dtype=dt),
        "b_if": ParamDef((2 * nh,), init="zeros", dtype=torch.float32),
        "norm": ParamDef((di,), init="ones", dtype=dt),
        "down": ParamDef((di, d), dtype=dt, stacked=stacked),
    }


def mlstm_init_state(cfg: ModelConfig, batch: int, device: torch.device | str) -> dict:
    di, nh, hd = mlstm_dims(cfg)
    return {"ssm": torch.zeros((batch, nh, hd, hd + 1), dtype=torch.float32, device=device)}


def _mlstm_qkvif(cfg: ModelConfig, p, u: torch.Tensor):
    B, T, di = u.shape
    _, nh, hd = mlstm_dims(cfg)
    q = (u @ p["wq"]).reshape(B, T, nh, hd) / (hd ** 0.5)
    k = (u @ p["wk"]).reshape(B, T, nh, hd)
    v = (u @ p["wv"]).reshape(B, T, nh, hd)
    if_ = (u @ p["wif"]).float() + p["b_if"]
    log_i = torch.clamp(if_[..., :nh], -CLIP, 10.0)
    log_f = F.logsigmoid(if_[..., nh:] + 4.0)  # forget-gate bias init ~1
    return q, k, v, log_i, log_f


def _with_ones(v: torch.Tensor) -> torch.Tensor:
    """v (..., hd) with a ones column appended: the state's last column
    accumulates the normaliser n."""
    return torch.cat([v, torch.ones(v.shape[:-1] + (1,), dtype=v.dtype, device=v.device)],
                     dim=-1)


def _mlstm_out(cfg: ModelConfig, ops: Ops, p, y_aug: torch.Tensor, z: torch.Tensor):
    """Normalise by max(|n|, 1), then the norm, then the silu(z) gate (the
    mLSTM's order; Mamba2 gates before its norm), then the down projection."""
    B, T = y_aug.shape[:2]
    di, _, hd = mlstm_dims(cfg)
    y, n = y_aug[..., :hd], y_aug[..., hd:]
    y = (y / torch.clamp(n.abs(), min=1.0)).reshape(B, T, di)
    y = ops.rms_norm(y, p["norm"], cfg.norm_eps) * F.silu(z.float()).to(y.dtype)
    return y @ p["down"]


def mlstm_full(cfg: ModelConfig, ops: Ops, p, x: torch.Tensor, return_state: bool = False):
    """Full-sequence mLSTM. x: (B, T, d) -> (B, T, d)."""
    T = x.shape[1]
    di, _, _ = mlstm_dims(cfg)
    ug = x @ p["up"]
    u, z = ug[..., :di], ug[..., di:]
    q, k, v, log_i, log_f = _mlstm_qkvif(cfg, p, u)
    y_aug, S = ops.linear_attention(q, k, _with_ones(v), log_f, log_i,
                                    chunk=ssm_chunk_of(cfg, T))
    out = _mlstm_out(cfg, ops, p, y_aug, z)
    if return_state:
        return out, {"ssm": S}
    return out


def mlstm_step(cfg: ModelConfig, ops: Ops, p, x: torch.Tensor, state: dict):
    """Single-token mLSTM. x: (B, 1, d).  Returns (out, new state); the state
    dict passed in is not modified."""
    di, _, _ = mlstm_dims(cfg)
    ug = x @ p["up"]
    u, z = ug[..., :di], ug[..., di:]
    q, k, v, log_i, log_f = _mlstm_qkvif(cfg, p, u)
    y, S = linear_attention_step(q[:, 0], k[:, 0], _with_ones(v)[:, 0], log_f[:, 0],
                                 state["ssm"], log_i[:, 0])
    return _mlstm_out(cfg, ops, p, y[:, None], z), {"ssm": S}


# ----------------------------------------------------------------------------
# sLSTM (scalar-memory cell with recurrent gates; strictly sequential)
# ----------------------------------------------------------------------------


def slstm_defs(cfg: ModelConfig, stacked: int = 0) -> dict:
    d = cfg.d_model
    nh = cfg.n_heads
    hd = d // nh
    dt = cfg.dtype
    return {
        "w": ParamDef((d, 4 * d), dtype=dt, stacked=stacked),
        "r": ParamDef((nh, hd, 4 * hd), scale=0.02, dtype=dt),
        "b": ParamDef((4 * d,), init="zeros", dtype=torch.float32),
        "norm": ParamDef((d,), init="ones", dtype=dt),
        "out": ParamDef((d, d), dtype=dt, stacked=stacked),
    }


def slstm_init_state(cfg: ModelConfig, batch: int, device: torch.device | str) -> dict:
    shape = (batch, cfg.n_heads, cfg.d_model // cfg.n_heads)
    state = {name: torch.zeros(shape, dtype=torch.float32, device=device)
             for name in ("c", "n", "h")}
    state["m"] = torch.full(shape, -CLIP, dtype=torch.float32, device=device)
    return state


def _slstm_cell(cfg: ModelConfig, p, wx_t: torch.Tensor, st: dict) -> dict:
    """One sLSTM step. wx_t: (B, 4*d) precomputed input contribution."""
    nh = cfg.n_heads
    hd = cfg.d_model // nh
    B = wx_t.shape[0]
    rh = torch.einsum("bnh,nhk->bnk", st["h"].to(p["r"].dtype), p["r"])  # (B, nh, 4hd)
    gates = wx_t.reshape(B, nh, 4 * hd).float() + rh.float()
    i_raw, f_raw, z_raw, o_raw = gates.chunk(4, dim=-1)
    log_f = F.logsigmoid(f_raw + 4.0)
    m_new = torch.maximum(log_f + st["m"], i_raw)
    i = torch.exp(torch.clamp(i_raw - m_new, -CLIP, CLIP))
    f = torch.exp(torch.clamp(log_f + st["m"] - m_new, -CLIP, CLIP))
    c = f * st["c"] + i * torch.tanh(z_raw)
    n = f * st["n"] + i
    h = torch.sigmoid(o_raw) * c / torch.clamp(n, min=1.0)
    return {"c": c, "n": n, "h": h, "m": m_new}


def slstm_full(cfg: ModelConfig, ops: Ops, p, x: torch.Tensor, return_state: bool = False,
               init_state: dict | None = None):
    """Full-sequence sLSTM. x: (B, T, d) -> (B, T, d).  The recurrence is a
    loop over T of `_slstm_cell`, the reference's `lax.scan`, in plain
    PyTorch on every device: the reference has no kernel for it, so on the
    card too this is its math, not a fallback."""
    B, T, d = x.shape
    wx = x @ p["w"] + p["b"].to(x.dtype)
    st = init_state or slstm_init_state(cfg, B, x.device)
    hs = []
    for t in range(T):
        st = _slstm_cell(cfg, p, wx[:, t], st)
        hs.append(st["h"])
    y = torch.stack(hs, dim=1).reshape(B, T, d).to(x.dtype)
    out = ops.rms_norm(y, p["norm"], cfg.norm_eps) @ p["out"]
    if return_state:
        return out, st
    return out


def slstm_step(cfg: ModelConfig, ops: Ops, p, x: torch.Tensor, state: dict):
    """Single-token sLSTM. x: (B, 1, d).  Returns (out, new state)."""
    B = x.shape[0]
    wx = (x @ p["w"])[:, 0] + p["b"].to(x.dtype)
    st = _slstm_cell(cfg, p, wx, state)
    y = st["h"].reshape(B, 1, -1).to(x.dtype)
    return ops.rms_norm(y, p["norm"], cfg.norm_eps) @ p["out"], st
