"""Decode attention (one query token against a KV cache): the CUDA kernel and
its plain version.

`decode_attention` takes the reference kernel's layout, q `(B, KH, G, D)`
and k/v `(B, KH, S, D)`; `decode_attention_bthd` the model path's, q
`(B, 1, H, D)` and the cache `(B, S, KH, D)`.  Both launch the Hopper kernel
of `csrc/decode_attention.cu` for CUDA tensors, passing strides so that the
cache is read where it lies (no transposed copy per layer and token), and
run `decode_attention_plain` for CPU tensors; any other device raises.  They
replace the Pallas kernel of the reference's
`kernels/decode_attention/kernel.py`.  Bound on the card: bytes (the K and V
prefix, see the source note).

`kv_len` is a Python int, a 0-d or 1-element int tensor, or a `(B,)` tensor
of per-row lengths (the reference model's `common.decode_attention` accepts
both forms; its Pallas kernel only the scalar).  A tensor stays on the
device: the kernel reads it there, so a decode loop needs no host
synchronisation.  Positions at or past `kv_len` are masked; `kv_len` must be
at least 1.

On the card the sequence is split over blocks as `split_plan` says, from
host-known shapes only (never `kv_len`), so a call's launch shape is fixed;
with more than one split, the splits of one (batch, KV head) run as a
thread block cluster whose first block merges their partials, which live in
f32 scratch allocated here.

`decode_work` is a call's bytes and operations (`kernels/work.py`), added
to the wrapper's counters: over `kv_len` keys where it is a Python int,
over the cache's capacity where it is a tensor (reading it would make the
host wait for the card).  A meta call (the dry run) runs the CUDA route
without the launch.
"""

from __future__ import annotations

import ctypes
import functools
import math

import torch

from .. import _lib
from ..work import Work, count, dtype_class, reset

NEG_INF = -1e30
MAX_HEAD_DIM = 128  # kMaxD in the source
MAX_GROUP = 8       # query heads per KV head; the largest template of the source
MIN_SPLIT_KEYS = 64  # the fewest keys a split of the sequence takes
MAX_SPLITS = 8       # a portable thread block cluster; kMaxSplits in the source
SPLIT_FILL = 0.75    # split grids aim at this share of the SMs
# the tensor-core kernel's block shapes, indexed as the source's `ring`: 16
# keys a warp of each chunk, the chunks in a ring of shared memory
RINGS = ("4 warps, 3 stages", "8 warps, 2 stages")


def decode_attention_plain(q: torch.Tensor, k_cache: torch.Tensor, v_cache: torch.Tensor,
                           kv_len, softmax_scale: float | None = None) -> torch.Tensor:
    """The reference's `models.common.decode_attention`, op for op: q
    (B, 1, H, D), k/v cache (B, S, KH, D) -> (B, 1, H, Dv).  f32 scores and
    softmax; the probabilities are cast to the cache dtype before the PV
    product, as the reference does."""
    B, _, H, D = q.shape
    S, KH = k_cache.shape[1], k_cache.shape[2]
    G = H // KH
    scale = softmax_scale or 1.0 / math.sqrt(D)
    qg = q.reshape(B, KH, G, D)
    s = torch.einsum("bhgd,bshd->bhgs", qg.float(), k_cache.float()) * scale
    pos = torch.arange(S, device=q.device)
    lens = torch.as_tensor(kv_len, device=q.device).reshape(-1, 1)
    valid = pos[None, :] < lens.expand(B, S)
    s = torch.where(valid[:, None, None, :], s, torch.full_like(s, NEG_INF))
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bhgs,bshd->bhgd", p.to(v_cache.dtype).float(), v_cache.float())
    return out.reshape(B, 1, H, v_cache.shape[-1]).to(q.dtype)


@functools.lru_cache(maxsize=1024)
def split_plan(B: int, KH: int, S: int, n_sm: int) -> tuple[int, int, int]:
    """(splits, keys per split, block shape: an index into RINGS) for a cache
    of capacity S, from shapes only (never kv_len), so the launch shape is
    fixed for a cache.

    Set from `sweep.py`'s timings on the H100 (PERF.md §6): one block a
    (batch, KV head) while those blocks are more than half the SMs; at
    half or fewer, the sequence is split, at least in two, and into as many
    as keep the grid within `SPLIT_FILL` of the SMs (clusters of more than
    two blocks measured slower once the grid reached every SM), each split
    of at least `MIN_SPLIT_KEYS` keys, at most `MAX_SPLITS`.  Split i covers
    [i * len, min((i + 1) * len, S)), so the splits cover [0, S) exactly.
    A grid of at most one block an SM streams through 8 warps a block, a
    larger one through 4."""
    pairs = B * KH
    n = 1
    if 2 * pairs <= n_sm:
        n = min(max(2, int(SPLIT_FILL * n_sm) // pairs), S // MIN_SPLIT_KEYS, MAX_SPLITS)
        while n > 1 and S - (n - 1) * -(-S // n) < MIN_SPLIT_KEYS:
            n -= 1
        n = max(n, 1)
    return n, max(1, -(-S // n)), 1 if pairs * n <= n_sm else 0


def decode_work(B: int, H: int, KH: int, L: int, D: int, esize: int) -> Work:
    """One query row a head over L keys of a cache of KH heads: K and V's
    L rows read once, q read and o written once, the int32 kv_len read;
    q.k and p.v over the L keys at the inputs' class (in bf16, p enters P.V
    as two bf16 parts: four operations a key and column)."""
    nbytes = 2 * B * L * KH * D * esize + 2 * B * H * D * esize + 4
    return Work(nbytes, ((dtype_class(esize), 4.0 * B * H * L * D),))


_P, _L, _I = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
# q, k, v, o, kv_len pointer, kv_len stride, kv_len scalar,
# 4 x (batch, kv head, row) strides, B, KH, G, S, D, scale, dtype,
# keys per split, splits, block shape, f32 scratch for the partials, stream
_SIGNATURES = {"da_forward": [_P] * 5 + [_L, _I] + [_L] * 12 + [_I] * 5
               + [ctypes.c_float, _I, _I, _I, _I, _P, _P]}


def _kv_len_args(kv_len, B: int, device) -> tuple[int, int, int, torch.Tensor | None]:
    """(pointer, stride, scalar, keep-alive tensor) for the C entry point."""
    if not isinstance(kv_len, torch.Tensor):
        return 0, 0, int(kv_len), None
    if kv_len.device != device:
        raise ValueError(f"kv_len on {kv_len.device}, the cache on {device}")
    lens = kv_len.reshape(-1).to(torch.int32)
    if lens.numel() not in (1, B):
        raise ValueError(f"kv_len has {lens.numel()} entries for batch {B}")
    return lens.data_ptr(), (lens.stride(0) if lens.numel() == B and B > 1 else 0), 0, lens


def _launch(q, k, v, o, kv_len, scale: float, plan: tuple[int, int, int] | None) -> None:
    """q/o: (B, KH, G, D) views; k/v: (B, KH, S, D) views; unit stride on D."""
    B, KH, G, D = q.shape
    S = k.shape[2]
    if D > MAX_HEAD_DIM or D % 2:
        raise ValueError(f"head_dim {D}: the kernel takes an even head_dim <= {MAX_HEAD_DIM}")
    if G > MAX_GROUP:
        raise ValueError(f"{G} query heads per KV head exceed the kernel's {MAX_GROUP}")
    if not (q.dtype == k.dtype == v.dtype == o.dtype):
        raise TypeError(f"q, k, v differ in dtype: {q.dtype}, {k.dtype}, {v.dtype}")
    code = _lib.dtype_code(q)
    pair = 2 * q.element_size()
    strides, ptrs = [], []
    for t in (q, k, v, o):
        # the kernel loads element pairs (4 bytes in bf16, 8 in f32)
        st, base = t.stride(), t.data_ptr()
        if st[3] != 1 or st[0] % 2 or st[1] % 2 or st[2] % 2 or base % pair:
            raise ValueError("decode_attention needs a contiguous head_dim and pair-aligned rows")
        strides += st[:3]
        ptrs.append(base)
    if q.numel() == 0 or S == 0:
        return
    ptr, stride, scalar, _lens = _kv_len_args(kv_len, B, q.device)
    n_split, split_len, ring = plan or split_plan(B, KH, S, _lib.sm_count(q.device))
    # per split: m and l of each query head, then its (G, D) accumulator
    part = (torch.empty(B * KH * n_split * G * (D + 2), dtype=torch.float32, device=q.device)
            if n_split > 1 else None)
    _lib.launch(q, "decode_attention", lambda: _lib.load(
        "decode_attention", _SIGNATURES).da_forward(
        *ptrs, ptr, stride, scalar, *strides, B, KH, G, S, D, float(scale), code, split_len,
        n_split, ring, 0 if part is None else part.data_ptr(), _lib.stream_handle(q)))
    keys = S if isinstance(kv_len, torch.Tensor) else min(int(kv_len), S)
    count(decode_attention, decode_work(B, KH * G, KH, keys, D, q.element_size()))


# decode has no training path: no backward will come
NO_BACKWARD = "ROADMAP.md queue 1, item 13e: no training path runs it"


def _check_shapes(q, k, v) -> None:
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(f"bad shapes q{tuple(q.shape)} k{tuple(k.shape)} v{tuple(v.shape)}")


def decode_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, kv_len,
                     scale: float | None = None) -> torch.Tensor:
    """The reference kernel's layout: q (B, KH, G, D); k/v (B, KH, S, D)
    -> (B, KH, G, D)."""
    _check_shapes(q, k, v)
    B, KH, G, D = q.shape
    if k.shape[:2] != (B, KH) or k.shape[3] != D:
        raise ValueError(f"q{tuple(q.shape)} does not match k{tuple(k.shape)}")
    if not _lib.route(q, k, v):
        out = decode_attention_plain(q.reshape(B, 1, KH * G, D), k.transpose(1, 2),
                                     v.transpose(1, 2), kv_len, scale)
        return out.reshape(B, KH, G, D)
    if _lib.needs_grad(q, k, v):
        raise _lib.no_backward("decode_attention", NO_BACKWARD)
    out = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    _launch(q, k, v, out, kv_len, scale if scale is not None else D ** -0.5, None)
    return out


def decode_attention_bthd(q: torch.Tensor, k_cache: torch.Tensor, v_cache: torch.Tensor,
                          kv_len, softmax_scale: float | None = None, *,
                          plan: tuple[int, int, int] | None = None) -> torch.Tensor:
    """The model layout: q (B, 1, H, D); k/v cache (B, S, KH, D)
    -> (B, 1, H, D).  `plan`, a (splits, keys per split, block shape)
    triple in `split_plan`'s form, replaces its choice on the card, to
    measure other plans (the kernel refuses one that does not cover the
    cache exactly); the CPU ignores it."""
    _check_shapes(q, k_cache, v_cache)
    B, T, H, D = q.shape
    KH = k_cache.shape[2]
    if T != 1 or k_cache.shape[0] != B or k_cache.shape[3] != D or H % KH:
        raise ValueError(f"q{tuple(q.shape)} does not match the cache {tuple(k_cache.shape)}")
    if not _lib.route(q, k_cache, v_cache):
        return decode_attention_plain(q, k_cache, v_cache, kv_len, softmax_scale)
    if _lib.needs_grad(q, k_cache, v_cache):
        raise _lib.no_backward("decode_attention", NO_BACKWARD)
    out = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    grouped = (B, KH, H // KH, D)
    _launch(q.reshape(grouped), k_cache.transpose(1, 2), v_cache.transpose(1, 2),
            out.reshape(grouped), kv_len, softmax_scale or D ** -0.5, plan)
    return out


reset(decode_attention)
