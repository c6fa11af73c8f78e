"""Partition-boundary int8 quantization: CUDA kernels and their plain version.

`quantize` / `dequantize` launch the Hopper kernels of
`csrc/boundary_quant.cu` for CUDA tensors and run `quantize_plain` /
`dequantize_plain` for CPU tensors; any other device raises.  They replace
the Pallas kernels of the reference's `kernels/boundary_quant/kernel.py`.
Bound on the card: bytes (see the source note).  Leading dims are flattened
into rows, as the reference's `ops.py` does; any row count is accepted.
"""

from __future__ import annotations

import ctypes

import torch

from .. import _lib


def quantize_plain(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    x32 = x.float()
    amax = x32.abs().amax(dim=-1, keepdim=True)
    # a tensor divisor, not the Python scalar: PyTorch turns division by a
    # scalar into a multiply by its reciprocal, which is not the IEEE divide
    # the kernel does (and q must match the kernel bit for bit)
    scale = amax / torch.full_like(amax, 127.0) + 1e-12
    q = torch.clamp(torch.round(x32 / scale), -127, 127).to(torch.int8)  # half to even
    return q, scale


def dequantize_plain(q: torch.Tensor, scale: torch.Tensor,
                     dtype=torch.bfloat16) -> torch.Tensor:
    return (q.float() * scale).to(dtype)


_P, _I = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {
    "bq_quantize": [_P, _P, _P, _I, _I, _I, _P],    # x, q, scale, N, D, dtype, stream
    "bq_dequantize": [_P, _P, _P, _I, _I, _I, _P],  # q, scale, out, N, D, dtype, stream
}


def _bind() -> ctypes.CDLL:
    return _lib.load("boundary_quant", _SIGNATURES)


def quantize(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """x: (..., D) -> (int8 (..., D), f32 scales (..., 1))."""
    if not _lib.route(x):
        return quantize_plain(x)
    if not x.is_contiguous():
        raise ValueError("quantize takes a contiguous tensor")
    D = x.shape[-1]
    N = x.numel() // max(D, 1)
    q = torch.empty(x.shape, dtype=torch.int8, device=x.device)
    scale = torch.empty(x.shape[:-1] + (1,), dtype=torch.float32, device=x.device)
    if N == 0 or D == 0:
        return q, scale
    err = _bind().bq_quantize(x.data_ptr(), q.data_ptr(), scale.data_ptr(), N, D,
                              _lib.dtype_code(x), _lib.stream_handle(x))
    _lib.check("quantize", err)
    quantize.launches += 1
    return q, scale


def dequantize(q: torch.Tensor, scale: torch.Tensor,
               dtype=torch.bfloat16) -> torch.Tensor:
    """int8 (..., D) and f32 (..., 1) -> (..., D) in `dtype`."""
    if not _lib.route(q, scale):
        return dequantize_plain(q, scale, dtype)
    if q.dtype != torch.int8 or scale.dtype != torch.float32:
        raise TypeError("dequantize takes int8 values and float32 scales")
    if not (q.is_contiguous() and scale.is_contiguous()):
        raise ValueError("dequantize takes contiguous tensors")
    D = q.shape[-1]
    N = q.numel() // max(D, 1)
    if scale.numel() != N:
        raise ValueError(f"{scale.numel()} scales for {N} rows")
    out = torch.empty(q.shape, dtype=dtype, device=q.device)
    if N == 0 or D == 0:
        return out
    err = _bind().bq_dequantize(q.data_ptr(), scale.data_ptr(), out.data_ptr(), N, D,
                                _lib.dtype_code(out), _lib.stream_handle(q))
    _lib.check("dequantize", err)
    dequantize.launches += 1
    return out


quantize.launches = 0
dequantize.launches = 0
