"""Fused RMSNorm: the CUDA kernel and its plain version.

`rmsnorm` launches the Hopper kernel of `csrc/rmsnorm.cu` for CUDA tensors
and runs `rmsnorm_plain` for CPU tensors; any other device raises.  It
replaces the Pallas kernel of the reference's `kernels/rmsnorm/kernel.py`
and computes the math of `models.common.rms_norm`.  Bound on the card:
bytes (see the source note).  Leading dims are flattened into rows.
"""

from __future__ import annotations

import ctypes

import torch

from .. import _lib


def rmsnorm_plain(x: torch.Tensor, w: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """The reference's `models.common.rms_norm`, op for op (the port's
    `models.common.rms_norm` is this function)."""
    x32 = x.float()
    var = (x32 * x32).mean(dim=-1, keepdim=True)
    # cast to x's dtype BEFORE the weight multiply, as the reference does
    return (x32 * torch.rsqrt(var + eps)).to(x.dtype) * w


# x, w, out, N, D, eps, dtype, stream
_SIGNATURES = {"rmsnorm_forward": [ctypes.c_void_p] * 3 + [ctypes.c_int] * 2
               + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p]}


def _bind() -> ctypes.CDLL:
    return _lib.load("rmsnorm", _SIGNATURES)


def rmsnorm(x: torch.Tensor, w: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """x: (..., D); w: (D,) of x's dtype."""
    if not _lib.route(x, w):
        return rmsnorm_plain(x, w, eps)
    D = x.shape[-1]
    if w.dtype != x.dtype or w.shape != (D,):
        raise ValueError(f"weight must be ({D},) {x.dtype}, got {tuple(w.shape)} {w.dtype}")
    if not (x.is_contiguous() and w.is_contiguous()):
        raise ValueError("rmsnorm takes contiguous tensors")
    N = x.numel() // max(D, 1)
    out = torch.empty_like(x)
    if N == 0 or D == 0:
        return out
    err = _bind().rmsnorm_forward(x.data_ptr(), w.data_ptr(), out.data_ptr(), N, D,
                                  float(eps), _lib.dtype_code(x), _lib.stream_handle(x))
    _lib.check("rmsnorm", err)
    rmsnorm.launches += 1
    return out


rmsnorm.launches = 0
