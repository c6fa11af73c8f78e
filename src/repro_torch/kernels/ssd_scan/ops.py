"""Chunked linear attention with decay (the Mamba2 SSD scan): the CUDA kernel
and its plain version.

`ssd_scan` takes the reference kernel's layout, q/k `(B, NH, T, DK)`, v
`(B, NH, T, DV)` and the gates `(B, NH, T)`; `ssd_scan_bthd` the model
path's, q/k `(B, T, NH, DK)`, v `(B, T, NH, DV)`, gates `(B, T, NH)`.  Both
return `(y, final_state)` with y in v's dtype and the state f32
`(B, NH, DK, DV)`.  They launch the Hopper kernel of `csrc/ssd_scan.cu` for
CUDA tensors, passing strides so that neither a transposition nor Mamba2's
head broadcast of q and k (an `expand` with head stride 0) is materialised,
and run `chunked_linear_attention_plain` for CPU tensors; any other device
raises.  They replace the Pallas kernel of the reference's
`kernels/ssd_scan/kernel.py`.  Bound on the card: f32 operations (see the
source note).

Unlike the Pallas kernel, T need not be a multiple of the chunk: the last
chunk is short, which equals the reference model's zero padding (padded
positions add nothing to y or the state).  `log_i` is optional (Mamba2
passes none).  The scan starts from a zero state, as the Pallas kernel
does; only the plain version takes an initial state (the reference model's
signature).
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from .. import _lib

CLIP = 30.0
MAX_DIM = 64        # kDP in the source: DK and DV are zero-padded to it
MAX_CHUNK = 4096    # the chunk's gates sit in shared memory


def chunked_linear_attention_plain(
    q: torch.Tensor,  # (B, T, NH, DK)
    k: torch.Tensor,  # (B, T, NH, DK)
    v: torch.Tensor,  # (B, T, NH, DV)
    log_g: torch.Tensor,  # (B, T, NH) per-step log decay (<= 0)
    log_i: torch.Tensor | None = None,  # (B, T, NH) per-step log input gate
    init_state: torch.Tensor | None = None,  # (B, NH, DK, DV)
    chunk: int = 256,
) -> tuple[torch.Tensor, torch.Tensor]:
    """The reference's `models.ssm.chunked_linear_attention`, op for op:
    y_t = q_t . sum_{s<=t} exp(sum_{u in (s,t]} log_g_u + log_i_s) k_s v_s^T,
    all accumulation in f32.  Returns (y, final_state)."""
    B, T, NH, DK = q.shape
    DV = v.shape[-1]
    Q = min(chunk, T)
    pad = (-T) % Q
    if pad:
        q, k, v = (F.pad(a, (0, 0, 0, 0, 0, pad)) for a in (q, k, v))
        log_g = F.pad(log_g, (0, 0, 0, pad))
        if log_i is not None:
            log_i = F.pad(log_i, (0, 0, 0, pad), value=-CLIP)
    NC = (T + pad) // Q

    def rs(x):
        return x.float().reshape(B, NC, Q, *x.shape[2:])

    qs, ks, vs, gs = rs(q), rs(k), rs(v), rs(log_g)
    is_ = rs(log_i) if log_i is not None else None
    S = (init_state.float() if init_state is not None
         else torch.zeros(B, NH, DK, DV, dtype=torch.float32, device=q.device))
    tri = torch.ones(Q, Q, dtype=torch.bool, device=q.device).tril()
    ys = []
    for c in range(NC):
        qb, kb, vb, gb = qs[:, c], ks[:, c], vs[:, c], gs[:, c]
        cum = torch.cumsum(gb, dim=1)  # (B, Q, NH): sum of log_g over (0, t]
        total = cum[:, -1]  # (B, NH)
        li = is_[:, c] if is_ is not None else torch.zeros_like(cum)
        # intra-chunk: D[t, s] = exp(cum_t - cum_s + log_i_s) for s <= t
        dmat = cum[:, :, None, :] - cum[:, None, :, :] + li[:, None, :, :]
        dmat = torch.where(tri[None, :, :, None], torch.clamp(dmat, -CLIP, CLIP),
                           torch.full_like(dmat, -torch.inf))
        scores = torch.einsum("bthd,bshd->btsh", qb, kb) * torch.exp(dmat)
        y_intra = torch.einsum("btsh,bshv->bthv", scores, vb)
        # inter-chunk: decay from chunk start to t is exp(cum_t)
        y_inter = torch.einsum("bthd,bhdv->bthv",
                               qb * torch.exp(torch.clamp(cum, -CLIP, CLIP))[..., None], S)
        # new state: S' = exp(total) S + sum_s exp(total - cum_s + log_i_s) k_s v_s
        w = torch.exp(torch.clamp(total[:, None] - cum + li, -CLIP, CLIP))  # (B, Q, NH)
        S_local = torch.einsum("bshd,bsh,bshv->bhdv", kb, w, vb)
        S = torch.exp(torch.clamp(total, -CLIP, CLIP))[:, :, None, None] * S + S_local
        ys.append(y_intra + y_inter)
    y = torch.cat(ys, dim=1)[:, :T]
    return y.to(v.dtype), S


_P, _L, _I = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
# q, k, v, log_g, log_i, y, state, 6 x (batch, time, head) strides (q, k,
# v, log_g, log_i, y), B, T, NH, DK, DV, chunk, in dtype, stream
_SIGNATURES = {"ssd_forward": [_P] * 7 + [_L] * 18 + [_I] * 7 + [_P]}


def _launch(q, k, v, log_g, log_i, y, state, chunk: int) -> None:
    """q/k: (B, T, NH, DK), v/y: (B, T, NH, DV), gates (B, T, NH) f32 views
    with a unit last stride (the gates' head stride is free); state f32
    (B, NH, DK, DV) contiguous."""
    B, T, NH, DK = q.shape
    DV = v.shape[-1]
    if DK > MAX_DIM or DV > MAX_DIM:
        raise ValueError(f"DK {DK}, DV {DV}: the kernel takes state dims <= {MAX_DIM}")
    if not 1 <= chunk <= MAX_CHUNK:
        raise ValueError(f"chunk {chunk} outside [1, {MAX_CHUNK}]")
    if not (q.dtype == k.dtype == v.dtype == y.dtype):
        raise TypeError(f"q, k, v differ in dtype: {q.dtype}, {k.dtype}, {v.dtype}")
    code = _lib.dtype_code(q)
    for t in (q, k, v, y):
        if t.stride(-1) != 1:
            raise ValueError("ssd_scan needs a contiguous last dim in q, k, v")
    strides = [s for t in (q, k, v, log_g) for s in t.stride()[:3]]
    strides += list(log_i.stride()) if log_i is not None else [0, 0, 0]
    strides += list(y.stride()[:3])
    lib = _lib.load("ssd_scan", _SIGNATURES)
    err = lib.ssd_forward(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), log_g.data_ptr(),
        log_i.data_ptr() if log_i is not None else 0, y.data_ptr(), state.data_ptr(),
        *strides, B, T, NH, DK, DV, chunk, code, _lib.stream_handle(q))
    _lib.check("ssd_scan", err)
    ssd_scan.launches += 1


def _f32(t: torch.Tensor | None) -> torch.Tensor | None:
    return None if t is None else t.float()


def ssd_scan_bthd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, log_g: torch.Tensor,
                  log_i: torch.Tensor | None = None, chunk: int = 256
                  ) -> tuple[torch.Tensor, torch.Tensor]:
    """The model layout: q/k (B, T, NH, DK), v (B, T, NH, DV), gates
    (B, T, NH) -> (y (B, T, NH, DV) in v's dtype, state f32 (B, NH, DK, DV))."""
    tensors = [t for t in (q, k, v, log_g, log_i) if t is not None]
    if not _lib.route(*tensors):
        return chunked_linear_attention_plain(q, k, v, log_g, log_i, chunk=chunk)
    B, T, NH, DK = q.shape
    DV = v.shape[-1]
    if k.shape != q.shape or v.shape[:3] != (B, T, NH) or log_g.shape != (B, T, NH) or \
            (log_i is not None and log_i.shape != (B, T, NH)):
        raise ValueError(f"bad shapes q{tuple(q.shape)} k{tuple(k.shape)} v{tuple(v.shape)} "
                         f"log_g{tuple(log_g.shape)}")
    y = torch.empty(v.shape, dtype=v.dtype, device=v.device)
    state = torch.empty((B, NH, DK, DV), dtype=torch.float32, device=v.device)
    _launch(q, k, v, _f32(log_g), _f32(log_i), y, state, min(chunk, T))
    return y, state


def ssd_scan(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, log_g: torch.Tensor,
             log_i: torch.Tensor | None = None,
             chunk: int = 256) -> tuple[torch.Tensor, torch.Tensor]:
    """The reference kernel's layout: q/k (B, NH, T, DK), v (B, NH, T, DV),
    gates (B, NH, T) -> (y (B, NH, T, DV), state f32 (B, NH, DK, DV))."""
    y, state = ssd_scan_bthd(q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
                             log_g.transpose(1, 2),
                             None if log_i is None else log_i.transpose(1, 2), chunk)
    return y.transpose(1, 2), state


ssd_scan.launches = 0
