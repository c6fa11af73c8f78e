"""Causal GQA flash attention (prefill): the CUDA kernel and its plain version.

`flash_attention` takes the reference's `(B, H, S, D)` layout and
`attention_bthd` the model path's `(B, T, H, D)` layout; both launch the
Hopper kernel of `csrc/flash_attention.cu` for CUDA tensors, passing strides
so that no transposed copy is made, and run `flash_attention_plain` for CPU
tensors; any other device raises.  They replace the Pallas kernel of the
reference's `kernels/flash_attention/kernel.py`, which computes the math of
`models.common.chunked_attention` when Sq == Sk.  Bound on the card: bytes
at the serving shapes (see the source note).  The kernel takes bfloat16
(its products run on the tensor cores); other dtypes on CUDA raise.

Causal alignment: the Pallas kernel masks top-left (k_pos <= q_pos), the
reference oracle bottom-right; the two agree only for Sq == Sk, the only
case supported here.  Any other shape raises.
"""

from __future__ import annotations

import ctypes

import torch

from .. import _lib

NEG_INF = -1e30
MAX_HEAD_DIM = 128  # the kernel's register tile; kMaxD in the source


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          causal: bool = True, scale: float | None = None) -> torch.Tensor:
    """q: (B, H, S, D); k/v: (B, KH, S, D) -> (B, H, S, D), softmax in f32."""
    B, H, S, D = _check_shapes(q, k, v)
    KH = k.shape[1]
    scale = scale if scale is not None else D ** -0.5
    qg = q.float().reshape(B, KH, H // KH, S, D)
    s = torch.einsum("bkgqd,bksd->bkgqs", qg, k.float()) * scale
    if causal:
        mask = torch.ones(S, S, dtype=torch.bool, device=q.device).tril()
        s = torch.where(mask, s, torch.full_like(s, NEG_INF))
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bkgqs,bksd->bkgqd", p, v.float())
    return o.reshape(B, H, S, D).to(q.dtype)


def _check_shapes(q, k, v) -> tuple[int, int, int, int]:
    if q.dim() != 4 or k.shape != v.shape or k.dim() != 4:
        raise ValueError(f"bad shapes q{tuple(q.shape)} k{tuple(k.shape)} v{tuple(v.shape)}")
    B, H, S, D = q.shape
    if k.shape[0] != B or k.shape[2] != S or k.shape[3] != D:
        raise ValueError(f"only Sq == Sk prefill is supported: q{tuple(q.shape)} "
                         f"k{tuple(k.shape)}")
    if H % k.shape[1]:
        raise ValueError(f"{H} query heads do not group over {k.shape[1]} KV heads")
    return B, H, S, D


_P, _L, _I = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
# q, k, v, o, 4 x (batch, head, seq) strides, B, H, KH, S, D, scale, causal,
# stream
_SIGNATURES = {"fa_forward": [_P] * 4 + [_L] * 12 + [_I] * 5
               + [ctypes.c_float, _I, _P]}


def _launch(q, k, v, o, causal: bool, scale: float) -> None:
    """All four are (B, heads, S, D) bf16 views with a unit stride on D."""
    B, H, S, D = q.shape
    if D > MAX_HEAD_DIM:
        raise ValueError(f"head_dim {D} exceeds the kernel's {MAX_HEAD_DIM}")
    if not (q.dtype == k.dtype == v.dtype == o.dtype == torch.bfloat16):
        raise TypeError(f"the kernel takes bfloat16 q, k, v (tensor-core products), got "
                        f"{q.dtype}, {k.dtype}, {v.dtype}")
    for t in (q, k, v, o):
        if t.stride(-1) != 1:
            raise ValueError("head_dim must be contiguous")
    if q.numel() == 0:
        return
    strides = [s for t in (q, k, v, o) for s in t.stride()[:3]]
    lib = _lib.load("flash_attention", _SIGNATURES)
    err = lib.fa_forward(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                         *strides, B, H, k.shape[1], S, D, float(scale), int(causal),
                         _lib.stream_handle(q))
    _lib.check("flash_attention", err)
    flash_attention.launches += 1


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = True, scale: float | None = None) -> torch.Tensor:
    """q: (B, H, S, D); k/v: (B, KH, S, D) -> (B, H, S, D)."""
    if not _lib.route(q, k, v):
        return flash_attention_plain(q, k, v, causal, scale)
    D = _check_shapes(q, k, v)[3]
    out = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    _launch(q, k, v, out, causal, scale if scale is not None else D ** -0.5)
    return out


def attention_bthd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Causal attention in the model layout: q (B, T, H, D), k/v (B, T, KH, D)
    -> (B, T, H, D)."""
    qh, kh, vh = q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)
    if not _lib.route(q, k, v):
        return flash_attention_plain(qh, kh, vh).transpose(1, 2)
    D = _check_shapes(qh, kh, vh)[3]
    out = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    _launch(qh, kh, vh, out.transpose(1, 2), True, D ** -0.5)
    return out


flash_attention.launches = 0
