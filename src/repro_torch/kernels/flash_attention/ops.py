"""GQA flash attention (prefill, encoder and cross-attention): the CUDA kernel
and its plain version.

`flash_attention` takes the reference's `(B, H, S, D)` layout and
`attention_bthd` the model path's `(B, T, H, D)` layout; both launch the
Hopper kernel of `csrc/flash_attention.cu` for CUDA tensors, passing strides
so that no transposed copy is made, and run `flash_attention_plain` for CPU
tensors; any other device raises.  They replace the Pallas kernel of the
reference's `kernels/flash_attention/kernel.py`, which computes the math of
`models.common.chunked_attention` with `q_offset=0`.  Bound on the card:
bytes at the serving shapes (see the source note).  bfloat16 runs on the tensor
cores (`fa_forward`) and raises for q, k, v that its TMA loads cannot
address (head_dim not a multiple of 8, a base or stride not a multiple of
16 bytes); float32 runs on CUDA-core FMAs (`fa_forward_f32`, the Pallas
kernel's f32 instance) at any stride with a unit head_dim stride; other
dtypes on CUDA raise.

Queries and keys may differ in length (Sq, Sk), as in the Pallas kernel,
and the causal mask is aligned as there, top-left: query row i sees keys
0..i (`chunked_attention` at `q_offset=0`; the kernel's `ref.py` aligns it
bottom-right, which agrees only when Sq == Sk).  Any other mismatch of
shapes raises.  head_dim may be up to 192 (MLA's q and k); in the model
layout, v may be narrower than q and k (MLA's 128-wide values).
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from .. import _lib

NEG_INF = -1e30
MAX_HEAD_DIM = 192  # three 64-column panels; kMaxD in the source


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          causal: bool = True, scale: float | None = None) -> torch.Tensor:
    """q: (B, H, Sq, D); k/v: (B, KH, Sk, D) -> (B, H, Sq, D), softmax in
    f32; the causal mask aligned top-left (key j <= query i)."""
    B, H, Sq, D = _check_shapes(q, k, v)
    KH, Sk = k.shape[1], k.shape[2]
    scale = scale if scale is not None else D ** -0.5
    qg = q.float().reshape(B, KH, H // KH, Sq, D)
    s = torch.einsum("bkgqd,bksd->bkgqs", qg, k.float()) * scale
    if causal:
        mask = torch.ones(Sq, Sk, dtype=torch.bool, device=q.device).tril()
        s = torch.where(mask, s, torch.full_like(s, NEG_INF))
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bkgqs,bksd->bkgqd", p, v.float())
    return o.reshape(B, H, Sq, D).to(q.dtype)


def _check_shapes(q, k, v) -> tuple[int, int, int, int]:
    """(B, H, Sq, D) of q (B, H, Sq, D) against k and v (B, KH, Sk, D)."""
    if q.dim() != 4 or k.shape != v.shape or k.dim() != 4:
        raise ValueError(f"bad shapes q{tuple(q.shape)} k{tuple(k.shape)} v{tuple(v.shape)}")
    B, H, Sq, D = q.shape
    if k.shape[0] != B or k.shape[3] != D:
        raise ValueError(f"q{tuple(q.shape)} does not match k{tuple(k.shape)}")
    if H % k.shape[1]:
        raise ValueError(f"{H} query heads do not group over {k.shape[1]} KV heads")
    if Sq and not k.shape[2]:
        raise ValueError(f"{Sq} queries attend over no key")
    return B, H, Sq, D


_P, _L, _I = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
# q, k, v, o, 4 x (batch, head, seq) strides, B, H, KH, Sq, Sk, D, scale,
# causal, stream
_ARGS = [_P] * 4 + [_L] * 12 + [_I] * 6 + [ctypes.c_float, _I, _P]
_SIGNATURES = {"fa_forward": _ARGS, "fa_forward_f32": _ARGS}
# the entry point of each dtype the kernel takes
_ENTRY = {torch.bfloat16: "fa_forward", torch.float32: "fa_forward_f32"}


def _launch(q, k, v, o, causal: bool, scale: float) -> None:
    """All four are (B, heads, seq, D) views of one dtype, bfloat16 or
    float32, with a unit stride on D; k and v of Sk rows, q and o of Sq."""
    B, H, Sq, D = q.shape
    if D > MAX_HEAD_DIM:
        raise ValueError(f"head_dim {D} exceeds the kernel's {MAX_HEAD_DIM}")
    entry = _ENTRY.get(q.dtype)
    if entry is None or not (q.dtype == k.dtype == v.dtype == o.dtype):
        raise TypeError(f"the kernel takes bfloat16 (tensor cores) or float32 (CUDA cores) "
                        f"q, k, v of one dtype, got {q.dtype}, {k.dtype}, {v.dtype}")
    args = []
    for t in (q, k, v, o):
        st = t.stride()
        if st[3] != 1:
            raise ValueError("head_dim must be contiguous")
        args.append(st)
    ptrs = [t.data_ptr() for t in (q, k, v, o)]
    if q.dtype == torch.bfloat16:
        for t, st, ptr in zip((q, k, v), args, ptrs):
            _check_tma(t, st, ptr)
    if q.numel() == 0:
        return
    lib = _lib.load("flash_attention", _SIGNATURES)
    err = getattr(lib, entry)(*ptrs, *args[0][:3], *args[1][:3], *args[2][:3], *args[3][:3],
                              B, H, k.shape[1], Sq, k.shape[2], D, float(scale), int(causal),
                              _lib.stream_handle(q))
    _lib.check("flash_attention", err)
    flash_attention.launches += 1


def _check_tma(t: torch.Tensor, st: tuple, ptr: int) -> None:
    """The bf16 kernel reads q, k and v through TMA tensor maps, which address
    16-byte-aligned bases and strides only (a bf16 stride a multiple of 8
    elements): raise on anything else (no fallback)."""
    n = t.shape
    if (n[3] % 8 or ptr % 16 or (st[0] % 8 and n[0] > 1) or (st[1] % 8 and n[1] > 1)
            or (st[2] % 8 and n[2] > 1)):
        raise ValueError(
            f"flash_attention: TMA cannot address a tensor of shape {tuple(n)}, strides {st}, "
            f"base {ptr % 16} bytes past 16-byte alignment; head_dim must be a multiple of 8 "
            f"and every stride a multiple of 16 bytes")


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = True, scale: float | None = None) -> torch.Tensor:
    """q: (B, H, Sq, D); k/v: (B, KH, Sk, D) -> (B, H, Sq, D)."""
    if not _lib.route(q, k, v):
        return flash_attention_plain(q, k, v, causal, scale)
    D = _check_shapes(q, k, v)[3]
    out = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    _launch(q, k, v, out, causal, scale if scale is not None else D ** -0.5)
    return out


def attention_bthd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   causal: bool = True) -> torch.Tensor:
    """Attention in the model layout: q (B, Tq, H, D), k (B, Tk, KH, D),
    v (B, Tk, KH, Dv) with Dv <= D -> (B, Tq, H, Dv).  A narrower v (MLA's
    values against its 192-wide q and k) is zero-padded to D and the
    output sliced back to Dv: exact, since the padded columns carry zeros;
    the scale stays D**-0.5 of q, as in `chunked_attention`."""
    Dv = v.shape[-1]
    if Dv < q.shape[-1]:
        v = F.pad(v, (0, q.shape[-1] - Dv))
    qh, kh, vh = q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)
    if not _lib.route(q, k, v):
        out = flash_attention_plain(qh, kh, vh, causal).transpose(1, 2)
    else:
        D = _check_shapes(qh, kh, vh)[3]
        out = torch.empty(q.shape, dtype=q.dtype, device=q.device)
        _launch(qh, kh, vh, out.transpose(1, 2), causal, D ** -0.5)
    return out[..., :Dv]


flash_attention.launches = 0
