"""Fused RMSNorm: the CUDA kernel and its plain version.

`rmsnorm` launches the Hopper kernel of `csrc/rmsnorm.cu` for CUDA tensors
and runs `rmsnorm_plain` for CPU tensors; any other device raises.  It
replaces the Pallas kernel of the reference's `kernels/rmsnorm/kernel.py`
and computes the math of `models.common.rms_norm`.  Bound on the card:
bytes (see the source note).  Leading dims are flattened into rows;
`launch_plan` picks the launch shape from D, and `vector_loads` whether the
kernel may use 16-byte accesses (otherwise it loads element by element).
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


VECTORS = (1, 2, 3, 4, 8)  # vectors a lane the source is built for (VPT)
NARROW = 128        # rows of at most this many vectors take a group of <= 32 lanes


def launch_plan(D: int, elem_size: int) -> tuple[int, int]:
    """(lanes a row, 16-byte vectors a lane) for rows of D elements of
    `elem_size` bytes, from the shape only.  Narrow rows (at most 128
    vectors) take a group of up to 32 lanes, the smallest power of two that
    holds every vector once, else 32 lanes of up to 4 vectors; wider rows a
    block of two vectors a thread (about D/16 threads in bf16, which
    measured faster on the H100 than one vector a thread at D = 2560 and
    5120), and past 1024 vectors at most 512 threads of up to 8 vectors.
    Raises past 4096 vectors (D > 32768 in bf16)."""
    nvec = -(-D // (16 // elem_size))
    if nvec <= NARROW:
        lanes = min(32, 1 << (nvec - 1).bit_length())
        return lanes, -(-nvec // lanes)
    vpt = max(2, -(-nvec // 512))
    vpt = min((v for v in VECTORS if v >= vpt), default=0)
    if not vpt:
        raise ValueError(f"rmsnorm takes rows of at most {4096 * 16 // elem_size} elements, "
                         f"got {D}")
    threads = -(-nvec // vpt)
    return -(-threads // 32) * 32, vpt


def vector_loads(x: torch.Tensor, w: torch.Tensor, out: torch.Tensor) -> bool:
    """16-byte accesses: every base address 16-byte aligned and D a
    multiple of the vector, so every row stays aligned."""
    D = x.shape[-1]
    return all(t.data_ptr() % 16 == 0 for t in (x, w, out)) and D % (16 // x.element_size()) == 0


# x, w, out, N, D, eps, dtype, lanes, vectors a lane, vector loads, stream
_SIGNATURES = {"rmsnorm_forward": [ctypes.c_void_p] * 3 + [ctypes.c_int64, ctypes.c_int]
               + [ctypes.c_float] + [ctypes.c_int] * 4 + [ctypes.c_void_p]}


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
    code = _lib.dtype_code(x)
    N = x.numel() // max(D, 1)
    out = torch.empty_like(x)
    if N == 0 or D == 0:
        return out
    lanes, vpt = launch_plan(D, x.element_size())
    err = _bind().rmsnorm_forward(x.data_ptr(), w.data_ptr(), out.data_ptr(), N, D, float(eps),
                                  code, lanes, vpt, int(vector_loads(x, w, out)),
                                  _lib.stream_handle(x))
    _lib.check("rmsnorm", err)
    rmsnorm.launches += 1
    return out


rmsnorm.launches = 0
