"""What a kernel call must do at least: its bytes and its operations.

Each kernel entry's `ops.py` has one `*_work` function that gives, for the
shapes of a call, the bytes the function must move (each input read once,
each output written once) and its operations by precision class.  The
wrappers add each call's work to their counters (`count`), on CUDA and on
the meta device alike, beside the launch count; `chip_smoke.py` phase 2
reads the same functions for each kernel's bound, and the dry run
(`launch/hlo_analysis.py`) for a step's FLOPs and bytes.

The rates are the NVIDIA H100 SXM's data sheet (dense), at its 700 W
limit: HBM 3.35 TB/s; bf16 tensor cores 989 TFLOP/s; f32 outside the
tensor cores 67 TFLOP/s.  A product with an f32 operand that a kernel
splits into two bf16 parts (16 significant bits) is two bf16 products, so
its class runs at half the bf16 peak; with f32 inputs every operand is
three parts and a product six bf16 products, a sixth of the peak.
"""

from __future__ import annotations

from typing import NamedTuple

HBM_BYTES_S = 3.35e12
PEAKS = {"bf16": 989e12, "bf16x2": 989e12 / 2, "bf16x6": 989e12 / 6, "f32": 67e12}


class Work(NamedTuple):
    """`nbytes` to move and `ops`, (precision class, operations) pairs."""

    nbytes: float
    ops: tuple[tuple[str, float], ...] = ()


def bound_ms(work: Work) -> tuple[float, str]:
    """The least time the card could take for `work`, in ms: the larger of
    its bytes over the HBM rate and its operations, each class at its own
    peak; and which of the two it is ("bytes" or "operations")."""
    t_bytes = work.nbytes / HBM_BYTES_S
    t_ops = sum(n / PEAKS[c] for c, n in work.ops)
    return max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations"


def count(fn, work: Work) -> None:
    """One launch of `fn`'s kernel doing `work`: its launch count, bytes
    and operations by class."""
    fn.launches += 1
    fn.nbytes += work.nbytes
    for c, n in work.ops:
        fn.ops[c] = fn.ops.get(c, 0.0) + n


def reset(fn) -> None:
    fn.launches, fn.nbytes, fn.ops = 0, 0.0, {}


def dtype_class(esize: int) -> str:
    """The precision class of a product of two inputs of `esize` bytes:
    bf16 on the tensor cores, f32 outside them."""
    return "bf16" if esize == 2 else "f32"
