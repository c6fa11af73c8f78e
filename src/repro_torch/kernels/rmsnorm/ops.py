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
`rmsnorm_backward` entry (`rmsnorm_backward`, one cooperative launch: a
persistent grid writes dx and one f32 partial row of dw a block, then,
past a grid-wide barrier, sums the partial rows in a fixed order;
`backward_plan` is its launch shape); a CPU call runs the plain version and
autograd differentiates it.  `rmsnorm_backward_plain` is the same backward
in explicit formulas, for the tests; nothing on the card's path calls it.

`rmsnorm_work` and `rmsnorm_backward_work` are each entry's bytes and
operations at a call's shapes (`kernels/work.py`); each call adds them to
its wrapper's counters.  A meta call (the dry run) runs the CUDA route
without the launch; its backward's occupancy is the H100's, read from
`occupancy.py`'s table.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from .. import _lib, occupancy
from ..work import Work, count, reset


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


def rmsnorm_work(N: int, D: int, esize: int) -> Work:
    """N rows of D elements of `esize` bytes: x read and the output written
    once, w read once; four f32 operations an element (square, sum, scale,
    the weight's product)."""
    return Work(2 * N * D * esize + D * esize, (("f32", 4.0 * N * D),))


def rmsnorm_backward_work(N: int, D: int, esize: int) -> Work:
    """x and dy read and dx written once, w read and dw written once; ten
    f32 operations an element."""
    return Work(3 * N * D * esize + 2 * D * esize, (("f32", 10.0 * N * D),))


def vector_loads(x: torch.Tensor, w: torch.Tensor, out: torch.Tensor) -> bool:
    """16-byte accesses: every base address 16-byte aligned and D a
    multiple of the vector, so every row stays aligned.  A meta tensor's
    address is 0, so it counts as aligned."""
    D = x.shape[-1]
    return all(t.data_ptr() % 16 == 0 for t in (x, w, out)) and D % (16 // x.element_size()) == 0


BWD_THREADS = 256  # kBwdThreads: threads a backward block, at most
BWD_LANE_VECTORS = {True: 8, False: 4}  # vectors a lane, at most: 16-byte loads or element-wise


class BackwardPlan(NamedTuple):
    """The backward's launch shape: `lanes` threads a row, `vectors` 16-byte
    vectors a lane, `threads` a block (`threads // lanes` rows at once),
    `grid` blocks, one row of the f32 dw partial each."""

    lanes: int
    vectors: int
    threads: int
    grid: int

    @property
    def partial_rows(self) -> int:
        return self.grid

    def bands(self, N: int) -> list[range]:
        """The rows each block walks, by block: contiguous bands."""
        per = -(-N // self.grid)
        return [range(min(N, b * per), min(N, (b + 1) * per)) for b in range(self.grid)]


def backward_shape(D: int, elem_size: int, vec: bool = True) -> tuple[int, int, int]:
    """(lanes a row, vectors a lane, threads a block) of the backward for
    rows of D elements of `elem_size` bytes: rows of at most 32 vectors
    take the fewest lanes, a power of two, that hold one vector each; wider
    rows a warp while a lane holds at most 8 vectors (4 element-wise, `vec`
    False: more would spill), so up to D = 2048 in bf16 with 16-byte loads;
    wider still W warps, the fewest within that bound.  A block holds as
    many row groups as fit in 256 threads.  Raises past 8 warps a row."""
    most = BWD_LANE_VECTORS[bool(vec)]
    nvec = -(-D // (16 // elem_size))
    if nvec > 8 * 32 * most:
        raise ValueError(f"rmsnorm_backward takes rows of at most "
                         f"{8 * 32 * most * 16 // elem_size} elements"
                         f"{'' if vec else ' element-wise'}, got {D}")
    if nvec <= 32:
        lanes = 1 << (nvec - 1).bit_length()
    else:
        lanes = 32 * -(-nvec // (32 * most))
    return lanes, -(-nvec // lanes), BWD_THREADS // lanes * lanes


def backward_plan(N: int, D: int, elem_size: int, n_sm: int, per_sm: int,
                  vec: bool = True) -> BackwardPlan:
    """The backward's launch for N rows of D on `n_sm` SMs that each hold
    `per_sm` of its blocks at once (`backward_blocks_per_sm` on the card):
    `backward_shape`, and a persistent grid of as many blocks as the rows
    need, at most every block the card holds at once (a cooperative launch
    must fit)."""
    lanes, vpt, threads = backward_shape(D, elem_size, vec)
    groups = threads // lanes
    grid = max(1, min(-(-N // groups), n_sm * per_sm))
    return BackwardPlan(lanes, vpt, threads, grid)


# x, w, out, N, D, eps, dtype, lanes, vectors a lane, vector loads, stream
_SIGNATURES = {"rmsnorm_forward": [ctypes.c_void_p] * 3 + [ctypes.c_int64, ctypes.c_int]
               + [ctypes.c_float] + [ctypes.c_int] * 4 + [ctypes.c_void_p],
               # x, w, dy, dx, dw, partial, counter, N, D, eps, dtype, lanes, vpt, vec,
               # threads, grid, stream
               "rmsnorm_backward": [ctypes.c_void_p] * 7 + [ctypes.c_int64, ctypes.c_int]
               + [ctypes.c_float] + [ctypes.c_int] * 6 + [ctypes.c_void_p],
               # D, dtype, lanes, vpt, vec, threads, the count out
               "rmsnorm_backward_blocks_per_sm": [ctypes.c_int] * 6
               + [ctypes.POINTER(ctypes.c_int)]}


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
    _lib.launch(x, "rmsnorm", lambda: _bind().rmsnorm_forward(
        x.data_ptr(), w.data_ptr(), out.data_ptr(), N, D, float(eps), code, lanes, vpt,
        int(vector_loads(x, w, out)), _lib.stream_handle(x)))
    count(rmsnorm, rmsnorm_work(N, D, x.element_size()))
    return out


def rmsnorm_backward(x: torch.Tensor, w: torch.Tensor, dy: torch.Tensor,
                     eps: float = 1e-5) -> tuple[torch.Tensor, torch.Tensor]:
    """(dx, dw) of rmsnorm at (x, w) for dy, by the kernel (CUDA: one
    cooperative launch, `backward_plan`) or `rmsnorm_backward_plain` (CPU).
    dy is made contiguous."""
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
    vec = vector_loads(x, w, dx) and dy.data_ptr() % 16 == 0
    lanes, vpt, threads = backward_shape(D, x.element_size(), vec)
    per_sm = (occupancy.rmsnorm_blocks_per_sm(D, code, vec) if x.is_meta else
              backward_blocks_per_sm(D, code, lanes, vpt, int(vec), threads, x.device.index))
    plan = backward_plan(N, D, x.element_size(), _lib.sm_count(x.device), per_sm, vec)
    partial = torch.empty((plan.partial_rows, D), dtype=torch.float32, device=x.device)
    stream = _lib.stream_handle(x)
    counter = _barrier_counter(x.device, stream)
    _lib.launch(x, "rmsnorm_backward", lambda: _bind().rmsnorm_backward(
        x.data_ptr(), w.data_ptr(), dy.data_ptr(), dx.data_ptr(), dw.data_ptr(),
        partial.data_ptr(), counter.data_ptr(), N, D, float(eps), code, lanes, vpt, int(vec),
        threads, plan.grid, stream))
    count(rmsnorm_backward, rmsnorm_backward_work(N, D, x.element_size()))
    return dx, dw


@functools.lru_cache(maxsize=256)
def backward_blocks_per_sm(D: int, code: int, lanes: int, vpt: int, vec: int, threads: int,
                           device: int | None) -> int:
    """Blocks of the backward's instance one SM of CUDA device `device`
    holds at once (`cudaOccupancyMaxActiveBlocksPerMultiprocessor`), read
    once."""
    n = ctypes.c_int(0)
    with torch.cuda.device(device):
        _lib.check("rmsnorm_backward_blocks_per_sm", _bind().rmsnorm_backward_blocks_per_sm(
            D, code, lanes, vpt, vec, threads, ctypes.byref(n)))
    if n.value < 1:
        raise RuntimeError(f"rmsnorm_backward: no block of {threads} threads fits an SM")
    return n.value


_COUNTERS: dict[tuple[int | None, int], torch.Tensor] = {}


def _barrier_counter(device: torch.device, stream: int) -> torch.Tensor:
    """The grid barrier's counter of `stream` on `device`: zeroed once, and
    its low 31 bits zero again after every launch; one a stream, so that
    launches on two streams never share one.  On meta a new one each call
    (nothing runs on it, and a cached one would outlive the dry run)."""
    if device.type == "meta":
        return torch.empty(1, dtype=torch.int32, device=device)
    key = (device.index, stream)
    counter = _COUNTERS.get(key)
    if counter is None:
        counter = _COUNTERS[key] = torch.zeros(1, dtype=torch.int32, device=device)
    return counter


reset(rmsnorm)
reset(rmsnorm_backward)


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
