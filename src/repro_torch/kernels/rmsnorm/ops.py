"""Fused RMSNorm: the CUDA kernel and its plain version.

`rmsnorm` launches the Hopper kernel of `csrc/rmsnorm.cu` for CUDA tensors
and runs `rmsnorm_plain` for CPU tensors; any other device raises.  It
replaces the Pallas kernel of the reference's `kernels/rmsnorm/kernel.py`
and computes the math of `models.common.rms_norm`.  Bound on the card:
bytes (see the source note).  Leading dims are flattened into rows;
`launch_plan` picks the launch shape from D, and `vector_loads` whether the
kernel may use 16-byte accesses (otherwise it loads element by element).

Under autograd (an input that requires a gradient, grad mode on) a CUDA
call goes through `_RMSNormFn`, whose backward is the kernel's
`rmsnorm_backward` entry (`rmsnorm_backward`, two launches: dx and per-block
f32 partials of dw, then their fixed-order sum); a CPU call runs the plain
version and autograd differentiates it.  `rmsnorm_backward_plain` is the
same backward in explicit formulas, for the tests; nothing on the card's
path calls it.
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


def rmsnorm_backward_plain(x: torch.Tensor, w: torch.Tensor, dy: torch.Tensor,
                           eps: float = 1e-5) -> tuple[torch.Tensor, torch.Tensor]:
    """(dx, dw) of `rmsnorm_plain` at (x, w) for the output gradient dy, in
    explicit formulas, f32 inside: with r = rsqrt(mean(x^2) + eps) and
    dn = dy w, dx = r dn - x r^3 mean(dn x); dw = sum over rows of
    cast(x r) dy (the forward's rounding of the normalised row).  dx in x's
    dtype, dw in w's."""
    D = x.shape[-1]
    x32, dy32 = x.float(), dy.float()
    r = torch.rsqrt((x32 * x32).mean(dim=-1, keepdim=True) + eps)
    dn = dy32 * w.float()
    dx = r * dn - x32 * r.pow(3) * (dn * x32).mean(dim=-1, keepdim=True)
    n = (x32 * r).to(x.dtype).float()
    dw = (n * dy32).reshape(-1, D).sum(dim=0)
    return dx.to(x.dtype), dw.to(w.dtype)


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


BWD_WAVE = 8  # blocks an SM of the backward's first pass, at most


def backward_plan(N: int, D: int, elem_size: int, n_sm: int) -> tuple[int, int]:
    """(blocks of the backward's first pass, rows of its f32 dw partial)
    for N rows of D: the forward's launch shape, at most `BWD_WAVE` blocks
    an SM (and no more than the card holds at once), each writing one
    partial row a row group."""
    lanes, _ = launch_plan(D, elem_size)
    threads = 256 if lanes <= 32 else lanes
    rows_a_block = threads // lanes
    blocks = -(-N // rows_a_block)
    grid = max(1, min(blocks, n_sm * min(BWD_WAVE, 2048 // threads)))
    return grid, grid * rows_a_block


# x, w, out, N, D, eps, dtype, lanes, vectors a lane, vector loads, stream
_SIGNATURES = {"rmsnorm_forward": [ctypes.c_void_p] * 3 + [ctypes.c_int64, ctypes.c_int]
               + [ctypes.c_float] + [ctypes.c_int] * 4 + [ctypes.c_void_p],
               # x, w, dy, dx, dw, partial, N, D, eps, dtype, lanes, vpt, vec, grid, stream
               "rmsnorm_backward": [ctypes.c_void_p] * 6 + [ctypes.c_int64, ctypes.c_int]
               + [ctypes.c_float] + [ctypes.c_int] * 5 + [ctypes.c_void_p]}


def _bind() -> ctypes.CDLL:
    return _lib.load("rmsnorm", _SIGNATURES)


def _check(x: torch.Tensor, w: torch.Tensor) -> None:
    D = x.shape[-1]
    if w.dtype != x.dtype or w.shape != (D,):
        raise ValueError(f"weight must be ({D},) {x.dtype}, got {tuple(w.shape)} {w.dtype}")
    if not (x.is_contiguous() and w.is_contiguous()):
        raise ValueError("rmsnorm takes contiguous tensors")


def rmsnorm(x: torch.Tensor, w: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """x: (..., D); w: (D,) of x's dtype."""
    if not _lib.route(x, w):
        return rmsnorm_plain(x, w, eps)
    _check(x, w)
    if _lib.needs_grad(x, w):
        return _RMSNormFn.apply(x, w, eps)
    return _forward(x, w, eps)


def _forward(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    D = x.shape[-1]
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


def rmsnorm_backward(x: torch.Tensor, w: torch.Tensor, dy: torch.Tensor,
                     eps: float = 1e-5) -> tuple[torch.Tensor, torch.Tensor]:
    """(dx, dw) of rmsnorm at (x, w) for dy, by the kernel (CUDA) or
    `rmsnorm_backward_plain` (CPU).  dy is made contiguous."""
    if not _lib.route(x, w, dy):
        return rmsnorm_backward_plain(x, w, dy, eps)
    _check(x, w)
    dy = dy.contiguous()
    if dy.shape != x.shape or dy.dtype != x.dtype:
        raise ValueError(f"dy {tuple(dy.shape)} {dy.dtype} does not match x "
                         f"{tuple(x.shape)} {x.dtype}")
    D = x.shape[-1]
    code = _lib.dtype_code(x)
    N = x.numel() // max(D, 1)
    dx = torch.empty_like(x)
    if N == 0 or D == 0:
        return dx, torch.zeros_like(w)
    dw = torch.empty_like(w)
    lanes, vpt = launch_plan(D, x.element_size())
    grid, rows = backward_plan(N, D, x.element_size(), _lib.sm_count(x.device.index))
    partial = torch.empty((rows, D), dtype=torch.float32, device=x.device)
    vec = vector_loads(x, w, dx) and dy.data_ptr() % 16 == 0
    err = _bind().rmsnorm_backward(x.data_ptr(), w.data_ptr(), dy.data_ptr(), dx.data_ptr(),
                                   dw.data_ptr(), partial.data_ptr(), N, D, float(eps), code,
                                   lanes, vpt, int(vec), grid, _lib.stream_handle(x))
    _lib.check("rmsnorm_backward", err)
    rmsnorm_backward.launches += 1
    return dx, dw


rmsnorm_backward.launches = 0


class _RMSNormFn(torch.autograd.Function):
    """The kernel's forward and backward on CUDA tensors (the forward keeps
    x and w; the backward recomputes each row's rsqrt)."""

    @staticmethod
    def forward(ctx, x, w, eps):
        ctx.eps = eps
        ctx.save_for_backward(x, w)
        return _forward(x, w, eps)

    @staticmethod
    def backward(ctx, dy):
        x, w = ctx.saved_tensors
        dx, dw = rmsnorm_backward(x, w, dy, ctx.eps)
        return dx, dw, None
