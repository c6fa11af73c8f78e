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
layout, v may be narrower than q and k (MLA's 128-wide values): the f32
route reads it at its own width, and so does the bf16 route wherever an
instance of the source takes (D, Dv) (`v_width`: MLA's (192, 128), or v
rounded as q is), padding it to the nearest such width elsewhere.
`forward_plan` and `f32_plan` are the two routes' launch shapes in plain
Python (the source computes the same numbers: `fa_forward_plan`,
`fa_forward_f32_plan`).

Training (an input that requires a gradient, grad mode on): a CPU call runs
the plain version and autograd differentiates it.  A CUDA call in bf16
(`GRAD_ROUTE`: causal top-left or not, Sq and Sk of their own, every
head_dim the forward takes, v at a width of its own, any number of query
heads a KV head: the dense and hybrid decoders' causal self-attention, the
enc-dec's encoder and its cross-attention, deepseek-v3's MLA at q and k 192
wide and v 128) goes through `_FlashFn`: `fa_forward_lse` (the forward
that also writes each row's log-sum-exp; v at `v_width`) and
`fa_backward`, two launches counted as one call of
`flash_attention_backward`: dQ, persistent, in L2-sized chunks of (batch,
head) pairs, the items with the most K/V tiles first, which also writes
each query row's Delta and lse in base 2 into an f32 scratch; then dK/dV,
whose items (a key tile of Sk, a batch, one or more query heads) walk the
query tiles their keys meet (every one of Sq, or under the causal mask
those from the tile's first key on): where a KV head's G query heads are
one item, a persistent walk in L2-sized chunks of (batch, KV head) pairs
(128 keys an item up to head_dim 64), dK and dV stored through TMA; else
a block an item of 64 keys, the blocks of a KV head a thread block
cluster of at most 8 that sums their partial dK and dV in rank order
through distributed shared memory.  The backward reads v, o and dout and writes dv
at v's own width, padded only to the nearest width the source instantiates
(`grad_v_width`).  `backward_plan` is that launch shape in plain Python
(the source computes the same numbers).  f32 raises under grad, naming the
ROADMAP item that brings its backward.  `flash_attention_backward_plain` is
the same backward in explicit formulas (from lse and Delta, as the kernel
computes it), for the tests.

`flash_work`, `forward_lse_work` and `backward_work` are each entry's bytes
and operations at a call's shapes (`kernels/work.py`), over the (query,
key) pairs the mask keeps (`flash_pairs`); each launch adds them to its
wrapper's counters at the widths it is handed (v as padded, where a
route pads it).  A meta call (the
dry run) runs the CUDA route without the launch; the backward's cluster
occupancy is the H100's, read from `occupancy.py`'s table.
"""

from __future__ import annotations

import ctypes
import functools
import math
from dataclasses import dataclass

import torch
import torch.nn.functional as F

from .. import _lib, occupancy
from ..work import Work, count, dtype_class, reset

NEG_INF = -1e30
MAX_HEAD_DIM = 192  # three 64-column panels; kMaxD in the source
MAX_GRAD_HEAD_DIM = 192  # kBwdMaxD in the source
MAX_CLUSTER = 8  # kMaxGroup: dK/dV blocks a cluster, the portable size
REG_COLS = 128  # kRegCols: v's widths past it take the (192, 192) instance
BWD_KEYS = 64  # kRows: keys a dK/dV item past head_dim 64 (`bwd_keys`) and a dQ K/V tile
BWD_ROWS = 64  # kRows: query rows a tile; the scratch's rows round Sq up to it
DQ_ROWS = 128  # query rows a dQ work item (two consumer warpgroups of 64)
GRAD_ROUTE = ("bf16, causal (top-left) or not, any Sq and Sk, head_dim a multiple of 8 up "
              f"to {MAX_GRAD_HEAD_DIM}, v of its own width up to head_dim, any number of "
              "query heads a KV head")
# the ROADMAP entries that bring the routes without a backward kernel
_ITEM = "ROADMAP.md queue 1, item 13"


def _causal_keep(Sq: int, Sk: int, device) -> torch.Tensor:
    """The (Sq, Sk) causal keep-mask, top-left: key j <= query i."""
    return torch.ones(Sq, Sk, dtype=torch.bool, device=device).tril()


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
        s = torch.where(_causal_keep(Sq, Sk, q.device), s, torch.full_like(s, NEG_INF))
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bkgqs,bksd->bkgqd", p, v.float())
    return o.reshape(B, H, Sq, D).to(q.dtype)


def flash_attention_lse_plain(q: torch.Tensor, k: torch.Tensor, scale: float | None = None,
                              causal: bool = True) -> torch.Tensor:
    """(B, H, Sq) f32: each query row's log-sum-exp of its scaled (and,
    causal, top-left masked) scores, as `fa_forward_lse` writes it (q (B,
    H, Sq, D), k (B, KH, Sk, D))."""
    B, H, Sq, D = q.shape
    KH, Sk = k.shape[1], k.shape[2]
    scale = scale if scale is not None else D ** -0.5
    s = torch.einsum("bkgqd,bksd->bkgqs", q.float().reshape(B, KH, H // KH, Sq, D),
                     k.float()) * scale
    if causal:
        s = torch.where(_causal_keep(Sq, Sk, q.device), s, torch.full_like(s, NEG_INF))
    return torch.logsumexp(s, dim=-1).reshape(B, H, Sq)


def flash_attention_backward_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                                   o: torch.Tensor, dout: torch.Tensor, lse: torch.Tensor,
                                   scale: float | None = None, causal: bool = True
                                   ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(dq, dk, dv) of attention in the (B, H, S, D) layout, q, o, dout and
    lse of Sq rows, k and v of Sk, v, o, dout and dv Dv <= D wide (q's
    scale), causal (top-left) or not, the way
    `fa_backward` computes them: P = exp(scale q.k - lse) under the mask,
    Delta = rowsum(dout * o), dV = P^T dout, dS = P (dout v^T - Delta),
    dQ = scale dS k, dK = scale dS^T q, dK and dV summed over the query
    heads of each KV head.  f32 inside; P and dS rounded to q's dtype
    before the products that take them, as the kernel does (a no-op in
    f32); the gradients in q's dtype."""
    B, H, Sq, D = q.shape
    KH, Sk = k.shape[1], k.shape[2]
    G = H // KH
    scale = scale if scale is not None else D ** -0.5
    qf = q.float().reshape(B, KH, G, Sq, D)
    kf, vf = k.float(), v.float()
    dof = dout.float().reshape(B, KH, G, Sq, dout.shape[-1])
    s = torch.einsum("bkgqd,bksd->bkgqs", qf, kf) * scale
    p = torch.exp(s - lse.float().reshape(B, KH, G, Sq, 1))
    if causal:
        p = torch.where(_causal_keep(Sq, Sk, q.device), p, torch.zeros_like(p))
    delta = (dout.float() * o.float()).sum(dim=-1).reshape(B, KH, G, Sq, 1)
    dp = torch.einsum("bkgqd,bksd->bkgqs", dof, vf)
    ds = p * (dp - delta)
    p, ds = p.to(q.dtype).float(), ds.to(q.dtype).float()
    dv = torch.einsum("bkgqs,bkgqd->bksd", p, dof)
    dq = torch.einsum("bkgqs,bksd->bkgqd", ds, kf) * scale
    dk = torch.einsum("bkgqs,bkgqd->bksd", ds, qf) * scale
    return dq.reshape(B, H, Sq, D).to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def _check_shapes(q, k, v, narrow_v: bool = False) -> tuple[int, int, int, int]:
    """(B, H, Sq, D) of q (B, H, Sq, D) against k and v (B, KH, Sk, D);
    `narrow_v`: v may be (B, KH, Sk, Dv) with Dv <= D."""
    same = (k.shape[:3] == v.shape[:3] and v.shape[3] <= k.shape[3] if narrow_v
            else k.shape == v.shape)
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4 or not same:
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
# q, k, v, o, 4 x (batch, head, seq) strides, B, H, KH, Sq, Sk, D, Dv,
# scale, causal, stream
_ARGS = [_P] * 4 + [_L] * 12 + [_I] * 7 + [ctypes.c_float, _I, _P]
_SIGNATURES = {"fa_forward": _ARGS,
               "fa_forward_f32": _ARGS,
               # B, H, KH, Sq, Sk, D, Dv, causal, the plan out (eleven ints)
               "fa_forward_plan": [_I] * 8 + [ctypes.POINTER(ctypes.c_int)],
               # Sq, D, Dv, the plan out (five ints)
               "fa_forward_f32_plan": [_I] * 3 + [ctypes.POINTER(ctypes.c_int)],
               # fa_forward's arguments with the lse output before the stream
               "fa_forward_lse": _ARGS[:-1] + [_P, _P],
               # q, k, v, o, dout, dq, dk, dv, lse, delta, 8 x 3 strides,
               # B, H, KH, Sq, Sk, D, Dv, scale, causal, stream
               "fa_backward": [_P] * 10 + [_L] * 24 + [_I] * 7 + [ctypes.c_float, _I, _P],
               # C, D, Dv, the count out
               "fa_backward_max_clusters": [_I] * 3 + [ctypes.POINTER(ctypes.c_int)],
               # B, H, KH, Sq, Sk, causal, D, Dv, the plan out (fifteen ints)
               "fa_backward_plan": [_I] * 8 + [ctypes.POINTER(ctypes.c_int)]}
F32_LANES = 8      # kF32Lanes: threads of a query row
F32_STAGES = 3     # kF32Stages: the K/V ring's buffers
F32_SMALL_SQ = 64  # kF32SmallSq: up to this many queries, 64 rows a block


@dataclass(frozen=True)
class F32Plan:
    """The f32 route's launch shape: a block of 256 threads takes
    `rows` query rows of one (head, batch); K and V stream in tiles of
    `keys` keys through a ring of `stages` buffers; `smem` bytes of dynamic
    shared memory (Q, the ring, P); each thread accumulates `v_chunks`
    4-column chunks of the output's `Dv` columns."""

    rows: int
    keys: int
    stages: int
    smem: int
    v_chunks: int
    Dv: int

    def items(self, B: int, H: int, Sq: int, Sk: int, causal: bool
              ) -> list[tuple[int, int, int, int, int]]:
        """(batch, head, first query row, query rows, K/V tiles) of every
        block in launch order (the source's work order): the query tiles
        with the most K/V tiles first, then head within batch."""
        n_qt = -(-Sq // self.rows)
        out = []
        for w in range(n_qt * H * B):
            q0 = (n_qt - 1 - w // (H * B)) * self.rows
            end = min(q0 + self.rows, Sq)
            n_keys = min(Sk, end) if causal else Sk
            out.append((w % (H * B) // H, w % H, q0, end - q0, -(-n_keys // self.keys)))
        return out


def f32_stride(dp: int) -> int:
    """A shared-memory row of `dp` floats (a multiple of 4) rounded up to
    an odd number of 16-byte chunks: rows a warp reads at once fall on
    distinct banks."""
    return ((dp // 4) | 1) * 4


@functools.lru_cache(maxsize=256)
def f32_plan(Sq: int, D: int, Dv: int) -> F32Plan:
    """The launch shape of `fa_forward_f32` for Sq queries at head_dim D
    and v's width Dv <= D, from the shapes only: 128 query rows a block (64
    when Sq <= 64), K/V tiles of 64 keys up to head_dim 128 and 32 past it
    (so the Q tile and the ring fit at 192), output chunks of 4 columns a
    thread for Dv (built for 2, 3, 4 or 6 of them)."""
    if not (1 <= Dv <= D <= MAX_HEAD_DIM) or Sq < 1:
        raise ValueError(f"no f32 plan for Sq {Sq}, D {D}, Dv {Dv}")
    dp, dvp = -(-D // 4) * 4, -(-Dv // 4) * 4
    rows = 32 * (2 if Sq <= F32_SMALL_SQ else 4)
    keys = F32_LANES * (8 if dp <= 128 else 4)
    cv = -(-(dvp // 4) // F32_LANES)
    cv = 2 if cv <= 2 else cv if cv <= 4 else 6
    qs = f32_stride(dp)
    smem = (rows * qs + F32_STAGES * keys * qs + rows * (keys + 8)) * 4
    return F32Plan(rows, keys, F32_STAGES, smem, cv, Dv)


def f32_plan_on_card(Sq: int, D: int, Dv: int) -> tuple[int, ...]:
    """(rows, keys, stages, smem, v_chunks) as the source computes them."""
    out = (ctypes.c_int * 5)()
    lib = _lib.load("flash_attention", _SIGNATURES)
    _lib.check("fa_forward_f32_plan", lib.fa_forward_f32_plan(Sq, D, Dv, out))
    return tuple(out)


def v_width(dtype: torch.dtype, D: int, Dv: int) -> int:
    """The width v reaches the kernel at in the model layout: its own on
    the f32 route, which takes any Dv <= D; on the bf16 one its own where
    an instance of the source takes (D, Dv), as the backward's
    (`grad_v_width`: MLA's 128 beside 192), else zero-padded to the nearest
    such width (exact: the padded columns carry zeros and are sliced
    off)."""
    return Dv if dtype == torch.float32 else grad_v_width(D, Dv)


def _padded_dim(d: int) -> int:
    """head_dim as the bf16 kernels take it (`padded_dim` in the source): a
    multiple of 16 up to 128, else 192."""
    return -(-d // 16) * 16 if d <= REG_COLS else MAX_HEAD_DIM


def grad_v_width(D: int, Dv: int) -> int:
    """The width v, o and dout reach the bf16 kernels at (the forward's
    and the backward's instances are one set), for q and k D wide and v
    Dv <= D: Dv itself where an instance takes the pair (v rounds as q
    does, or to 128 beside q past 128: MLA's (192, 128)), else the nearest
    such width above it (zero columns, exact: o and dv are sliced back)."""
    dp, dvp = _padded_dim(D), _padded_dim(Dv)
    if dvp == dp or (dp == MAX_HEAD_DIM and dvp == REG_COLS):
        return Dv
    return REG_COLS if dp == MAX_HEAD_DIM and Dv < REG_COLS else D


def flash_pairs(Sq: int, Sk: int, causal: bool) -> float:
    """The (query, key) pairs a head's mask keeps: all Sq x Sk, or under the
    causal mask, top-left, min(i + 1, Sk) for query i."""
    if not causal:
        return float(Sq * Sk)
    m = min(Sq, Sk)
    return m * (m + 1) / 2 + max(Sq - Sk, 0) * Sk


def flash_work(B: int, H: int, KH: int, Sq: int, Sk: int, D: int, Dv: int, causal: bool,
               esize: int) -> Work:
    """The forward: q (B, Sq, H, D) read and o (B, Sq, H, Dv) written once,
    and the rows of k (D wide) and v (Dv) some query keeps read once each
    (all Sk, or min(Sq, Sk) under the causal mask); Q.K^T (D wide) and P.V
    (Dv) over the kept pairs, at the inputs' class."""
    kv_rows = min(Sq, Sk) if causal else Sk
    nbytes = (B * Sq * H * (D + Dv) + B * kv_rows * KH * (D + Dv)) * esize
    return Work(nbytes, ((dtype_class(esize), 2.0 * B * H * flash_pairs(Sq, Sk, causal)
                          * (D + Dv)),))


def forward_lse_work(B: int, H: int, KH: int, Sq: int, Sk: int, D: int, Dv: int,
                     causal: bool) -> Work:
    """The training forward (bf16): `flash_work`'s, and each row's f32
    log-sum-exp written."""
    w = flash_work(B, H, KH, Sq, Sk, D, Dv, causal, 2)
    return Work(w.nbytes + B * H * Sq * 4, w.ops)


def backward_work(B: int, H: int, KH: int, Sq: int, Sk: int, D: int, Dv: int,
                  causal: bool) -> Work:
    """The backward (bf16): q, o, dout, the kept K/V rows and lse read, dq
    written, and dk, dv at all Sk rows (zeros where no query sees a key);
    S^T, dK and dQ D wide, dP^T and dV Dv wide, over the kept pairs."""
    kv_rows = min(Sq, Sk) if causal else Sk
    rows_q, rows_kv = B * H * Sq * 2, B * KH * kv_rows * 2  # bytes a column
    nbytes = (rows_q * (2 * D + 2 * Dv) + rows_kv * (D + Dv) + B * KH * Sk * (D + Dv) * 2
              + B * H * Sq * 4)
    return Work(nbytes, (("bf16", 2.0 * B * H * flash_pairs(Sq, Sk, causal)
                          * (3 * D + 2 * Dv)),))


def _launch(q, k, v, o, causal: bool, scale: float) -> None:
    """All four are (B, heads, seq, D) views of one dtype, bfloat16 or
    float32, with a unit stride on D; k and v of Sk rows, q and o of Sq;
    v and o may be Dv <= D wide (in bfloat16 a width an instance takes,
    `grad_v_width(D, Dv) == Dv`)."""
    B, H, Sq, D = q.shape
    Dv = v.shape[3]
    if D > MAX_HEAD_DIM:
        raise ValueError(f"head_dim {D} exceeds the kernel's {MAX_HEAD_DIM}")
    if not (q.dtype == k.dtype == v.dtype == o.dtype) or q.dtype not in (torch.bfloat16,
                                                                        torch.float32):
        raise TypeError(f"the kernel takes bfloat16 (tensor cores) or float32 (CUDA cores) "
                        f"q, k, v of one dtype, got {q.dtype}, {k.dtype}, {v.dtype}")
    if q.dtype == torch.bfloat16 and (Dv > D or grad_v_width(D, Dv) != Dv):
        raise ValueError(f"the bf16 route takes v of a width an instance pairs with head_dim "
                         f"{D} (grad_v_width), got {Dv}")
    args = [_strides(t) for t in (q, k, v, o)]
    ptrs = [t.data_ptr() for t in (q, k, v, o)]
    if q.dtype == torch.bfloat16:
        for t, st, ptr in zip((q, k, v), args, ptrs):
            _check_tma(t, st, ptr)
    if q.numel() == 0:
        return
    dims = (B, H, k.shape[1], Sq, k.shape[2], D, Dv)

    def call():
        lib = _lib.load("flash_attention", _SIGNATURES)
        fn = lib.fa_forward_f32 if q.dtype == torch.float32 else lib.fa_forward
        return fn(*ptrs, *args[0], *args[1], *args[2], *args[3], *dims, float(scale),
                  int(causal), _lib.stream_handle(q))

    _lib.launch(q, "flash_attention", call)
    count(flash_attention, flash_work(B, H, k.shape[1], Sq, k.shape[2], D, Dv, causal,
                                      q.element_size()))


def _check_tma(t: torch.Tensor, st: tuple, ptr: int) -> None:
    """The bf16 kernel reads q, k and v through TMA tensor maps, which address
    16-byte-aligned bases and strides only (a bf16 stride a multiple of 8
    elements): raise on anything else (no fallback).  A meta tensor's
    address is 0, so only its strides and head_dim are checked."""
    n = t.shape
    if (n[3] % 8 or ptr % 16 or (st[0] % 8 and n[0] > 1) or (st[1] % 8 and n[1] > 1)
            or (st[2] % 8 and n[2] > 1)):
        raise ValueError(
            f"flash_attention: TMA cannot address a tensor of shape {tuple(n)}, strides {st}, "
            f"base {ptr % 16} bytes past 16-byte alignment; head_dim must be a multiple of 8 "
            f"and every stride a multiple of 16 bytes")


def _check_grad_route(q, k, v) -> None:
    """Raise unless (q, k, v) in the (B, H, S, D) layout lie on the route
    the backward kernel covers (`GRAD_ROUTE`; causal or not, any Sq and
    Sk, any G): a dtype other than bf16 has no backward kernel (item 13a);
    a head_dim or v width the bf16 kernels' TMA loads cannot take raises as
    the forward does."""
    D, Dv = q.shape[3], v.shape[3]
    if not (q.dtype == k.dtype == v.dtype == torch.bfloat16):
        raise _lib.no_backward("flash_attention", f"{q.dtype} ({_ITEM}a)")
    if D % 8 or Dv % 8 or not Dv <= D <= MAX_GRAD_HEAD_DIM:
        raise ValueError(f"flash_attention: head_dim {D} and v's width {Dv}: the bf16 kernels "
                         f"take multiples of 8, v no wider than q, up to {MAX_GRAD_HEAD_DIM}")


def _strides(t: torch.Tensor) -> tuple:
    st = t.stride()
    if st[3] != 1:
        raise ValueError("head_dim must be contiguous")
    return st[:3]


def flash_attention_forward_lse(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                                o: torch.Tensor, scale: float, causal: bool = True
                                ) -> torch.Tensor:
    """The training forward on CUDA: attention of (B, H, Sq, D) query views
    over (B, KH, Sk, D) key views and (B, KH, Sk, Dv) value views into `o`
    (B, H, Sq, Dv), causal (top-left) or not, returning the (B, H, Sq) f32
    log-sum-exp of each query row; Dv a width an instance pairs with D
    (`grad_v_width(D, Dv) == Dv`)."""
    B, H, Sq, D = q.shape
    Dv = v.shape[3]
    if o.shape[3] != Dv or grad_v_width(D, Dv) != Dv:
        raise ValueError(f"flash_attention_forward_lse: v and o must share one width the kernel "
                         f"takes beside head_dim {D} (grad_v_width), got {Dv}, {o.shape[3]}")
    for t in (q, k, v, o):
        _check_tma(t, _strides(t), t.data_ptr())
    lse = torch.empty((B, H, Sq), dtype=torch.float32, device=q.device)
    _lib.launch(q, "flash_attention_forward_lse", lambda: _lib.load(
        "flash_attention", _SIGNATURES).fa_forward_lse(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), *_strides(q), *_strides(k),
        *_strides(v), *_strides(o), B, H, k.shape[1], Sq, k.shape[2], D, Dv, float(scale),
        int(causal), lse.data_ptr(), _lib.stream_handle(q)))
    count(flash_attention_forward_lse,
          forward_lse_work(B, H, k.shape[1], Sq, k.shape[2], D, Dv, causal))
    return lse


FWD_ROWS = 64       # kRows: query rows a consumer warpgroup
FWD_CONSUMERS = 2   # kConsumers: consumer warpgroups a block
PANEL_BYTES = FWD_ROWS * 128  # kPanelBytes: 64 rows of a 64-column panel
SMEM_LIMIT = 232448  # kMaxSmem: dynamic shared memory a block may have on the H100
CHUNK_BYTES = 24 << 20  # kChunkBytes: K and V a chunk of the work order may read
TURN_KEYS = 1024  # kTurnKeys: keys the longest item walks before the warpgroups take turns


@dataclass(frozen=True)
class ForwardPlan:
    """The bf16 forward's launch shape: the instance (`dp`, `dvp`), a work
    item of `consumers` warpgroups of `rows` query rows each, K/V tiles of
    `keys` keys through a ring of `stages`, `smem` bytes of dynamic shared
    memory, `items` work items walked by `grid` persistent blocks (one an
    SM at most), whether the products overlap the softmax (`overlap`:
    within each warpgroup; else each tile's S, softmax and P.V in turn, as
    at DVP 192 and where every block walks one item of at most two tiles),
    the work order's chunks of `chunk` (batch, head) pairs, and
    whether the two warpgroups take turns to issue their products
    (`turns`, the ping-pong).  `keys` is 128 for an overlapped non-causal
    call up to head_dim 64 whose items keep both warpgroups busy, else 64.
    The source's `forward_choice` makes the same choices."""

    dp: int
    dvp: int
    rows: int
    keys: int
    consumers: int
    stages: int
    smem: int
    items: int
    grid: int
    overlap: bool
    chunk: int
    turns: bool

    def as_tuple(self) -> tuple[int, ...]:
        """The twelve numbers in `fa_forward_plan`'s order."""
        return (self.dp, self.dvp, self.rows, self.keys, self.consumers, self.stages, self.smem,
                self.items, self.grid, int(self.overlap), self.chunk, int(self.turns))


@functools.lru_cache(maxsize=256)
def forward_plan(B: int, H: int, KH: int, Sq: int, Sk: int, D: int, Dv: int, causal: bool,
                 n_sm: int) -> ForwardPlan:
    """The launch shape of `fa_forward` (and `fa_forward_lse`) for (B, H,
    Sq, D) queries over KH KV heads of Sk keys, v Dv wide, on a card of
    `n_sm` SMs; raises for what the kernel does not take (head_dim or Dv
    not a multiple of 8, Dv > D, D past 192, a (D, Dv) no instance takes).
    The instance rounds each width as `_padded_dim` does; the ring has four
    stages up to head_dim 128, three at (192, 128), two at (192, 192); the
    products overlap the softmax where v's accumulator fits beside both
    score sets (DVP <= 128) unless every block walks one item (items <= SMs)
    of at most two 64-key tiles, and the two warpgroups take turns where
    both are busy (Sq past 64) and the longest item walks `TURN_KEYS` keys
    or more (min(Sq, Sk) under the causal mask).  A chunk of the work order takes whole groups of the H / KH
    heads of a KV head, as many as keep its K and V (Sk rows, D + Dv
    columns a KV head) within `CHUNK_BYTES`, so that a head's K and V stay
    in L2 while its query blocks come round."""
    if B < 1 or H < 1 or KH < 1 or H % KH or Sq < 1 or Sk < 1 or n_sm < 1:
        raise ValueError(f"no forward plan for B {B}, {H} heads over {KH}, Sq {Sq}, Sk {Sk} on "
                         f"{n_sm} SMs")
    if D % 8 or Dv % 8 or not 8 <= Dv <= D <= MAX_HEAD_DIM or grad_v_width(D, Dv) != Dv:
        raise ValueError(f"no forward plan for head_dim {D} and v's width {Dv}: the kernel takes "
                         f"multiples of 8 up to {MAX_HEAD_DIM}, v of a width an instance pairs "
                         f"with D (grad_v_width)")
    dp, dvp = _padded_dim(D), _padded_dim(Dv)
    stages = 2 if dvp > REG_COLS else 3 if dp > REG_COLS else 4
    items = -(-Sq // (FWD_CONSUMERS * FWD_ROWS)) * H * B
    longest = min(Sq, Sk) if causal else Sk
    overlap = dvp <= REG_COLS and (items > n_sm or -(-longest // FWD_ROWS) > 2)
    keys = 128 if overlap and dp <= 64 and not causal and Sq > FWD_ROWS else FWD_ROWS
    kpanel = keys * 128  # a panel of a K or V tile
    qo = (-(-dp // 64) + -(-dvp // 64)) * PANEL_BYTES  # a Q and an output tile
    kv = (-(-dp // 64) + -(-dvp // 64)) * kpanel       # a K and a V tile
    smem = FWD_CONSUMERS * qo + stages * kv + 8 * (2 + 2 * stages) + 1024
    chunk = min(max(CHUNK_BYTES // (Sk * (D + Dv) * 2), 1) * (H // KH), H * B)
    return ForwardPlan(dp, dvp, FWD_ROWS, keys, FWD_CONSUMERS, stages, smem, items,
                       min(items, n_sm), overlap, chunk,
                       overlap and Sq > FWD_ROWS and longest >= TURN_KEYS)


def forward_plan_on_card(B: int, H: int, KH: int, Sq: int, Sk: int, D: int, Dv: int,
                         causal: bool = True) -> tuple[int, ...]:
    """`ForwardPlan.as_tuple()` as the source computes it on the current
    card."""
    out = (ctypes.c_int * 12)()
    lib = _lib.load("flash_attention", _SIGNATURES)
    _lib.check("fa_forward_plan", lib.fa_forward_plan(B, H, KH, Sq, Sk, D, Dv, int(causal), out))
    return tuple(out)


def bwd_keys(D: int, persistent: bool) -> int:
    """Keys a dK/dV work item at head_dim D: 128 (`kWideKeys`) for a
    persistent walk up to a padded 64, where each consumer warpgroup runs
    the whole chain for 64 of them, else 64, where the two warpgroups split
    it (the clusters' short walks measured slower with 128)."""
    return 2 * BWD_KEYS if persistent and _padded_dim(D) <= 64 else BWD_KEYS


@dataclass(frozen=True)
class BackwardPlan:
    """The backward's launch shape at (B, H, KH, Sq, Sk, D, Dv, causal) on
    `n_sm` SMs: each dK/dV item takes `keys` keys of one KV head and walks
    `heads` query heads in turn; where its cluster is one block (`heads` ==
    G) the dK/dV launch is `persistent` (but at (192, 192), `persists`),
    one block an SM walking the items in chunks of `chunk` (batch, KV head)
    pairs and storing dK and dV through TMA, else one block an item, the G
    / heads blocks of a KV head a cluster.  K and V (`kv_bufs` buffers)
    and a ring of `stages` Q/dO stages take `smem` bytes.  dQ's persistent
    walk takes chunks of `dq_chunk` (batch, head) pairs."""

    B: int
    H: int
    KH: int
    Sq: int
    Sk: int
    D: int
    Dv: int
    causal: bool
    n_sm: int
    heads: int
    keys: int
    stages: int
    kv_bufs: int
    smem: int
    chunk: int
    dq_chunk: int
    persistent: bool

    @property
    def group(self) -> int:
        """Query heads a KV head."""
        return self.H // self.KH

    @property
    def cluster(self) -> int:
        """dK/dV blocks a cluster."""
        return self.group // self.heads

    @property
    def scratch_rows(self) -> int:
        """Sqp: Sq rounded up to a query tile, the rows of each of the
        scratch's two (B, H, Sqp) f32 planes (Delta, then lse in base 2)."""
        return self.query_tiles * BWD_ROWS

    @property
    def query_tiles(self) -> int:
        return -(-self.Sq // BWD_ROWS)

    @property
    def key_tiles(self) -> int:
        return -(-self.Sk // self.keys)

    def tile_steps(self, kb: int) -> int:
        """Query tiles a dK/dV item of key tile `kb` walks a head: every
        one, or under the causal mask those from the tile's first key on
        (none once it lies at or past Sq: such an item writes zeros)."""
        if not self.causal:
            return self.query_tiles
        return max(-(-(self.Sq - kb * self.keys) // BWD_ROWS), 0)

    @property
    def dkdv_items(self) -> int:
        return self.key_tiles * self.B * (self.H // self.heads)

    @property
    def dkdv_grid(self) -> tuple[int, int, int]:
        """Persistent: (min(items, SMs), 1, 1); else (H / heads, B, key
        tiles): blockIdx.x the block's heads (the cluster's rank is x %
        cluster), y the batch, z the key tile."""
        if self.persistent:
            return min(self.dkdv_items, self.n_sm), 1, 1
        return self.H // self.heads, self.B, self.key_tiles

    def dkdv_blocks(self) -> list[tuple[int, tuple[int, ...], int, int]]:
        """(batch, query heads, key tile, steps it walks: heads x query
        tiles) of every dK/dV item in order: persistent, the walk's order
        (`bwd_item`: in chunks of `chunk` (batch, KV head) pairs, within a
        chunk key tile 0, which walks the most query tiles, first, pairs
        fastest; block i takes items i, i + grid, ...); else the launch
        order (x fastest), key tile 0 first."""
        G, C, n = self.group, self.cluster, self.heads
        if not self.persistent:
            return [(b, tuple((x // C) * G + (x % C) * n + j for j in range(n)), kb,
                     n * self.tile_steps(kb))
                    for kb in range(self.key_tiles) for b in range(self.B)
                    for x in range(self.H // n)]
        out, pairs, n_kt = [], self.B * self.KH, self.key_tiles
        for w in range(self.dkdv_items):
            ci, r = divmod(w, self.chunk * n_kt)
            in_chunk = min(self.chunk, pairs - ci * self.chunk)
            pair, kb = ci * self.chunk + r % in_chunk, r // in_chunk
            kh, b = pair % self.KH, pair // self.KH
            out.append((b, tuple(range(kh * G, kh * G + G)), kb, G * self.tile_steps(kb)))
        return out

    @property
    def dq_items(self) -> int:
        return -(-self.Sq // DQ_ROWS) * self.H * self.B

    @property
    def dq_grid(self) -> int:
        """Persistent dQ blocks: one an SM, at most one an item."""
        return min(self.dq_items, self.n_sm)

    def dq_order(self) -> list[tuple[int, int, int, int]]:
        """(batch, head, first query row, K/V tiles it walks) of every dQ
        work item in walk order (the source's `item_at`): in chunks of
        `dq_chunk` (batch, head) pairs, within a chunk the last query block
        first (under the causal mask the one with the most K/V tiles),
        heads fastest; block i takes items i, i + dq_grid, ..."""
        n_qb, hb, chunk = -(-self.Sq // DQ_ROWS), self.H * self.B, self.dq_chunk
        n_kv = -(-self.Sk // BWD_KEYS)
        out = []
        for w in range(self.dq_items):
            ci, r = divmod(w, chunk * n_qb)
            in_chunk = min(chunk, hb - ci * chunk)
            pair = ci * chunk + r % in_chunk
            q0 = (n_qb - 1 - r // in_chunk) * DQ_ROWS
            last = min(q0 + DQ_ROWS, self.Sq) - 1
            tiles = min(n_kv, last // BWD_KEYS + 1) if self.causal else n_kv
            out.append((pair // self.H, pair % self.H, q0, tiles))
        return out

    def as_tuple(self) -> tuple[int, ...]:
        """The fifteen numbers in `fa_backward_plan`'s order."""
        return (_padded_dim(self.D), _padded_dim(self.Dv), self.keys, self.stages, self.kv_bufs,
                self.smem, self.heads, self.cluster, int(self.persistent), self.dkdv_items,
                math.prod(self.dkdv_grid), self.chunk, self.dq_items, self.dq_grid,
                self.dq_chunk)


def backward_smem(D: int, Dv: int, keys: int = BWD_KEYS,
                  persistent: bool = False) -> tuple[int, int, int]:
    """(ring stages, K/V buffers, dynamic shared-memory bytes) of the dK/dV
    kernel at head_dim D, v's width Dv and `keys` keys an item (`BwdSmem`
    in the source): K and V of an item in two buffers where three stages
    still fit beside them, else one; as many stages of Q, dO (64 rows
    each), P^T (f32, 64 x 64, where the warpgroups split the chain), lse and
    Delta as fit, up to four; a 64 x 64 f32 accumulator for each of dV's
    and dK's column ranges past `REG_COLS`; and for the persistent walk the
    bf16 dV and dK tiles staged for their TMA stores (each warpgroup's
    where it runs the whole chain).  Stages 1 means the layout does not fit:
    that walk is never launched (`persists`)."""
    dp, dvp = _padded_dim(D), _padded_dim(Dv)
    tile, vtile = -(-dp // 64) * PANEL_BYTES, -(-dvp // 64) * PANEL_BYTES
    kv = (-(-dp // 64) + -(-dvp // 64)) * keys * 128
    rope = BWD_ROWS * BWD_ROWS * 4
    ropes = (dvp > REG_COLS) + (dp > REG_COLS)
    wide = keys > BWD_KEYS
    out = (FWD_CONSUMERS if wide else 1) * (tile + vtile) if persistent else 0
    stage = tile + vtile + (0 if wide else rope) + 2 * BWD_ROWS * 4
    room = SMEM_LIMIT - 1024 - 8 * (2 * 2 + 3 * 4) - ropes * rope - out
    bufs = 2 if 2 * kv + 3 * stage <= room else 1
    stages = min(4, (room - bufs * kv) // stage)
    smem = bufs * kv + stages * stage + out + ropes * rope + 8 * (2 * bufs + 3 * stages) + 1024
    return stages, bufs, smem


def persists(D: int, Dv: int) -> bool:
    """Whether the dK/dV kernel's persistent walk has a layout at (D, Dv):
    all but the (192, 192) instance, whose C = 1 walks take the clustered
    kernel's grid."""
    return backward_smem(D, Dv, bwd_keys(D, True), True)[0] >= 2


def _chunk(nbytes: int, pairs: int, group: int = 1) -> int:
    """Pairs a chunk of a persistent walk takes: whole groups of `group`
    as many as keep `nbytes` a group within `CHUNK_BYTES`, at least one
    group, at most all `pairs`."""
    return min(max(CHUNK_BYTES // nbytes, 1) * group, pairs)


@functools.lru_cache(maxsize=256)
def backward_plan(B: int, H: int, KH: int, Sq: int, Sk: int, D: int, n_sm: int,
                  clusters: tuple[tuple[int, int], ...] | None = None,
                  causal: bool = True, Dv: int | None = None) -> BackwardPlan:
    """The launch shape of `fa_backward` for (B, H, Sq, D) queries over KH KV
    heads of Sk keys, v Dv wide (D where None), causal (top-left) or not,
    on a card of `n_sm` SMs; raises off the route's shapes.  `clusters`:
    (C, clusters of C blocks the card holds at once) for the divisors C <=
    `MAX_CLUSTER` of G, as `backward_max_clusters` reads them; None takes
    every SM as usable (n_sm // C).  The dK/dV cluster is the divisor C <=
    8 of G (a portable cluster; a prime G past 8 takes 1, an item walking
    all G heads) that minimises the launch's estimated makespan in (head,
    query tile) steps, max(all steps / (C x clusters at once), the longest
    item's steps), the larger C on a tie, as the source's `heads_a_block`
    chooses; the steps are those of the walk launched (Sq x Sk tile pairs
    of `bwd_keys` keys, or the causal mask's clipped triangle).  A cluster
    of one launches the persistent walk, in chunks of (batch, KV head)
    pairs whose G heads' Q and dO fit `CHUNK_BYTES`; dQ's walk takes the
    forward's chunks (pairs whose K and V fit it)."""
    Dv = D if Dv is None else Dv
    if B < 1 or Sq < 1 or Sk < 1 or KH < 1 or H % KH:
        raise ValueError(f"no backward plan for B {B}, Sq {Sq}, Sk {Sk}, {H} heads over {KH}")
    if D % 8 or Dv % 8 or not 8 <= Dv <= D <= MAX_GRAD_HEAD_DIM or grad_v_width(D, Dv) != Dv:
        raise ValueError(f"head_dim {D} and v's width {Dv}: the backward takes multiples of 8 "
                         f"up to {MAX_GRAD_HEAD_DIM}, v of a width an instance pairs with D")
    G = H // KH
    chunk = _chunk(G * Sq * (D + Dv) * 2, B * KH)
    dq_chunk = _chunk(Sk * (D + Dv) * 2, H * B, G)

    def plan(heads: int) -> BackwardPlan:
        persistent = heads == G and persists(D, Dv)
        keys = bwd_keys(D, persistent)
        return BackwardPlan(B, H, KH, Sq, Sk, D, Dv, bool(causal), n_sm, heads, keys,
                            *backward_smem(D, Dv, keys, persistent), chunk, dq_chunk,
                            persistent)

    walk = plan(0)  # the makespan's steps, of 64-key items (`heads` 0 is never persistent)
    at_once = dict(clusters) if clusters is not None else {}
    steps = float(B * H * sum(walk.tile_steps(kb) for kb in range(walk.key_tiles)))
    best, heads = 0.0, 0
    for C in range(min(G, MAX_CLUSTER), 0, -1):
        n = at_once.get(C, 0) if clusters is not None else n_sm // C
        if G % C or n == 0:
            continue
        est = max(steps / (C * n), float(G // C * walk.query_tiles))
        if heads == 0 or est < best:
            best, heads = est, G // C
    if heads == 0:
        raise ValueError(f"the card holds no cluster of any divisor of {G} blocks")
    return plan(heads)


def backward_plan_on_card(B: int, H: int, KH: int, Sq: int, Sk: int, D: int,
                          causal: bool = True, Dv: int | None = None) -> tuple[int, ...]:
    """`BackwardPlan.as_tuple()` as the source computes it on the current
    card."""
    out = (ctypes.c_int * 15)()
    lib = _lib.load("flash_attention", _SIGNATURES)
    _lib.check("fa_backward_plan", lib.fa_backward_plan(
        B, H, KH, Sq, Sk, int(causal), D, D if Dv is None else Dv, out))
    return tuple(out)


def _divisors(n: int) -> list[int]:
    return [c for c in range(1, n + 1) if n % c == 0]


@functools.lru_cache(maxsize=64)
def _clusters_at_once(G: int, D: int, device: int, Dv: int | None = None
                      ) -> tuple[tuple[int, int], ...]:
    """(C, clusters of C dK/dV blocks at once) on CUDA device `device` for
    the divisors C <= `MAX_CLUSTER` of G, at head_dim D and v's width Dv
    (D where None), read once."""
    with torch.cuda.device(device):
        return tuple((c, backward_max_clusters(c, D, Dv)) for c in _divisors(G)
                     if c <= MAX_CLUSTER)


def flash_attention_backward(q, k, v, o, dout, lse, dq, dk, dv, scale: float,
                             causal: bool = True) -> None:
    """The backward on CUDA: writes dq, dk (D wide) and dv (Dv wide; views
    of their own strides) from (B, H, Sq, D) views of q, (B, H, Sq, Dv)
    views of o and dout, (B, KH, Sk, D) views of k, (B, KH, Sk, Dv) views
    of v, and the forward's lse, causal (top-left) or not.  Dv must be a
    width an instance takes (`grad_v_width(D, Dv) == Dv`; `_FlashFn` pads
    v, o and dout to one)."""
    B, H, Sq, D = q.shape
    KH, Sk, Dv = k.shape[1], k.shape[2], v.shape[3]
    if not (o.shape[3] == dout.shape[3] == dv.shape[3] == Dv) or grad_v_width(D, Dv) != Dv:
        raise ValueError(f"flash_attention_backward: v, o, dout and dv must share one width "
                         f"the kernel takes beside head_dim {D} (grad_v_width), got "
                         f"{v.shape[3]}, {o.shape[3]}, {dout.shape[3]}, {dv.shape[3]}")
    for t in (q, k, v, o, dout, dq, dk, dv):
        _check_tma(t, _strides(t), t.data_ptr())
    at_once = (_clusters_on_h100(H // KH, D, Dv) if q.is_meta
               else _clusters_at_once(H // KH, D, q.device.index, Dv))
    plan = backward_plan(B, H, KH, Sq, Sk, D, _lib.sm_count(q.device), at_once, causal, Dv)
    scratch = torch.empty((2, B, H, plan.scratch_rows), dtype=torch.float32, device=q.device)
    _lib.launch(q, "flash_attention_backward", lambda: _lib.load(
        "flash_attention", _SIGNATURES).fa_backward(
        *(t.data_ptr() for t in (q, k, v, o, dout, dq, dk, dv, lse, scratch)),
        *(x for t in (q, k, v, o, dout, dq, dk, dv) for x in _strides(t)),
        B, H, KH, Sq, Sk, D, Dv, float(scale), int(causal), _lib.stream_handle(q)))
    count(flash_attention_backward, backward_work(B, H, KH, Sq, Sk, D, Dv, causal))


def _clusters_on_h100(G: int, D: int, Dv: int) -> tuple[tuple[int, int], ...]:
    """`_clusters_at_once` for the meta device: the H100's readings, by the
    instance the source takes for (D, Dv) (`grad_v_width` keeps (D, Dv) a
    pair it takes)."""
    dp, dvp = _padded_dim(D), _padded_dim(Dv)
    return tuple((c, occupancy.flash_clusters(c, dp, dvp)) for c in _divisors(G)
                 if c <= MAX_CLUSTER)


def backward_max_clusters(C: int, D: int, Dv: int | None = None) -> int:
    """Clusters of C dK/dV blocks at head_dim D and v's width Dv (D where
    None) the current card holds at once (`cudaOccupancyMaxActiveClusters`);
    0 means the launch would fail."""
    n = ctypes.c_int(0)
    lib = _lib.load("flash_attention", _SIGNATURES)
    _lib.check("fa_backward_max_clusters",
               lib.fa_backward_max_clusters(C, D, D if Dv is None else Dv, ctypes.byref(n)))
    return n.value


class _FlashFn(torch.autograd.Function):
    """bf16 attention, causal or not, with its backward kernel.  q, k, v
    are in the caller's layout, (B, T, H, D) when `bthd` or (B, H, S, D);
    v may be Dv <= D wide (MLA's values).  Both kernels take v at its own
    width wherever the source has an instance at (D, Dv) (`grad_v_width`:
    MLA's 128 beside 192); elsewhere the forward pads v with zero columns
    to that width for `fa_forward_lse` and returns the output's Dv-wide
    view, and the backward pads v, o and dout likewise and slices dv back.
    v is saved as it came.  The output is allocated in the caller's layout,
    and so are dq, dk and dv (with the strides of q, k and a dense v, which
    suit the TMA forward when remat runs it again)."""

    @staticmethod
    def forward(ctx, q, k, v, bthd: bool, scale: float, causal: bool):
        view = (lambda t: t.transpose(1, 2)) if bthd else (lambda t: t)
        D, Dv = q.shape[-1], v.shape[-1]
        W = grad_v_width(D, Dv)
        out = torch.empty((*q.shape[:-1], W), dtype=q.dtype, device=q.device)
        vp = v if Dv == W else F.pad(v, (0, W - Dv))
        lse = flash_attention_forward_lse(view(q), view(k), view(vp), view(out), scale, causal)
        out = out[..., :Dv]
        ctx.bthd, ctx.scale, ctx.causal = bthd, scale, causal
        ctx.save_for_backward(q, k, v, out, lse)
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        view = (lambda t: t.transpose(1, 2)) if ctx.bthd else (lambda t: t)
        dout = dout.contiguous()
        Dv = v.shape[-1]
        W = grad_v_width(q.shape[-1], Dv)
        if W > Dv:
            v, out, dout = (F.pad(t, (0, W - Dv)) for t in (v, out, dout))
        dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
        flash_attention_backward(view(q), view(k), view(v), view(out), view(dout), lse,
                                 view(dq), view(dk), view(dv), ctx.scale, ctx.causal)
        return dq, dk, dv[..., :Dv], None, None, None


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = True, scale: float | None = None) -> torch.Tensor:
    """q: (B, H, Sq, D); k/v: (B, KH, Sk, D) -> (B, H, Sq, D)."""
    if not _lib.route(q, k, v):
        return flash_attention_plain(q, k, v, causal, scale)
    D = _check_shapes(q, k, v)[3]
    scale = scale if scale is not None else D ** -0.5
    if _lib.needs_grad(q, k, v):
        _check_grad_route(q, k, v)
        return _FlashFn.apply(q, k, v, False, scale, causal)
    out = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    _launch(q, k, v, out, causal, scale)
    return out


def attention_bthd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   causal: bool = True) -> torch.Tensor:
    """Attention in the model layout: q (B, Tq, H, D), k (B, Tk, KH, D),
    v (B, Tk, KH, Dv) with Dv <= D -> (B, Tq, H, Dv).  A narrower v (MLA's
    values against its 192-wide q and k) goes to the kernels as it is where
    they take it (`v_width`: the f32 route always, the bf16 one at an
    instance's width, MLA's included; under grad through `_FlashFn`), and
    is zero-padded elsewhere (to `v_width`, or to D for the plain version),
    the output sliced back to Dv: exact, since the padded columns carry
    zeros; the scale stays D**-0.5 of q, as in `chunked_attention`."""
    D, Dv = q.shape[-1], v.shape[-1]
    on_card = _lib.route(q, k, v)
    if on_card and _lib.needs_grad(q, k, v):
        qh, kh, vh = q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)
        _check_shapes(qh, kh, vh, narrow_v=True)
        _check_grad_route(qh, kh, vh)
        return _FlashFn.apply(q, k, v, True, D ** -0.5, causal)
    width = v_width(q.dtype, D, Dv) if on_card else D
    if Dv < width:
        v = F.pad(v, (0, width - Dv))
    qh, kh, vh = q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)
    if not on_card:
        return flash_attention_plain(qh, kh, vh, causal).transpose(1, 2)[..., :Dv]
    _check_shapes(qh, kh, vh, narrow_v=True)
    out = torch.empty((*q.shape[:3], vh.shape[3]), dtype=q.dtype, device=q.device)
    _launch(qh, kh, vh, out.transpose(1, 2), causal, D ** -0.5)
    return out[..., :Dv]


reset(flash_attention)
reset(flash_attention_forward_lse)
reset(flash_attention_backward)
