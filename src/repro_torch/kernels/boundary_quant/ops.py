"""Partition-boundary int8 quantization: CUDA kernels and their plain version.

`quantize` / `dequantize` launch the Hopper kernels of
`csrc/boundary_quant.cu` for CUDA tensors and run `quantize_plain` /
`dequantize_plain` for CPU tensors; any other device raises.  They replace
the Pallas kernels of the reference's `kernels/boundary_quant/kernel.py`.
Bound on the card: bytes (see the source note).  Leading dims are flattened
into rows, as the reference's `ops.py` does; any row count is accepted.
`launch_plan` picks quantize's launch shape from D (and, for narrow rows,
the row count against the card's SMs), and `vector_loads` whether it may
use 16-byte loads (otherwise it loads element by element).
"""

from __future__ import annotations

import ctypes
import functools

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


CHUNK = 8           # elements a chunk: one 16-byte load in bf16, two in f32
CHUNKS = (1, 2, 3, 4, 8)  # chunks a lane the source is built for (CPT)
NARROW = 128        # rows of at most this many chunks take a group of <= 32 lanes
THIN = 4            # ... unless the rows are fewer than this many an SM


def launch_plan(D: int, elem_size: int, rows: int = 0, n_sm: int = 0) -> tuple[int, int]:
    """(lanes a row, chunks of 8 elements a lane) for quantizing `rows`
    rows of D elements of `elem_size` bytes on a card of `n_sm` SMs; (0, 0)
    for rows wider than the widest plan, which take the kernel that reads
    a row twice.  Narrow rows (at most 128 chunks) take a group of up to 32
    lanes, the smallest power of two that holds every chunk once, else 32
    lanes of up to 4 chunks; but where those would be 32 lanes of several
    chunks and the rows are fewer than THIN an SM (few warps on each), a
    block a row of one chunk a thread.  Wider rows take a block of two
    chunks a thread (rmsnorm's shape at D = 2560), and past 1024 chunks at
    most 512 threads of up to 8 chunks in bf16 and 4 in f32 (more would
    spill).  Without `n_sm` the plan is from the shape only."""
    nchunk = -(-D // CHUNK)
    if 32 < nchunk <= NARROW and rows < THIN * n_sm:
        return -(-nchunk // 32) * 32, 1
    if nchunk <= NARROW:
        lanes = min(32, 1 << (nchunk - 1).bit_length())
        return lanes, -(-nchunk // lanes)
    widest = 8 if elem_size <= 2 else 4
    cpt = min((c for c in CHUNKS if c >= max(2, -(-nchunk // 512))), default=0)
    if not cpt or cpt > widest:
        return 0, 0
    threads = -(-nchunk // cpt)
    return -(-threads // 32) * 32, cpt


def vector_loads(x: torch.Tensor) -> bool:
    """16-byte loads and 8-byte stores: x's base 16-byte aligned and D a
    multiple of the chunk, so every row stays aligned (q is allocated
    aligned)."""
    return x.data_ptr() % 16 == 0 and x.shape[-1] % CHUNK == 0


@functools.lru_cache(maxsize=None)
def _sm_count(index: int | None) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


_P, _I = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {
    # x, q, scale, N, D, dtype, lanes, chunks a lane, vector loads, stream
    "bq_quantize": [_P, _P, _P, ctypes.c_int64, _I, _I, _I, _I, _I, _P],
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
    code = _lib.dtype_code(x)
    lanes, cpt = launch_plan(D, x.element_size(), N, _sm_count(x.device.index))
    err = _bind().bq_quantize(x.data_ptr(), q.data_ptr(), scale.data_ptr(), N, D, code,
                              lanes, cpt, int(vector_loads(x)), _lib.stream_handle(x))
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
