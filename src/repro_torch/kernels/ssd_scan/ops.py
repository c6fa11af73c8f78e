"""Chunked linear attention with decay (the Mamba2 SSD scan): the CUDA kernel
and its plain version.

`ssd_scan` takes the reference kernel's layout, q/k `(B, NH, T, DK)`, v
`(B, NH, T, DV)` and the gates `(B, NH, T)`; `ssd_scan_bthd` the model
path's, q/k `(B, T, NH, DK)`, v `(B, T, NH, DV)`, gates `(B, T, NH)`.  Both
return `(y, final_state)` with y in v's dtype and the state f32
`(B, NH, DK, DV)`.  They launch the Hopper kernels of `csrc/ssd_scan.cu`
for CUDA tensors (three launches a call: the chunks' local states, their
fold in chunk order, the outputs; four where DK or DV exceeds 64, as the
mLSTM's (hd, hd + 1) do, whose decayed scores get a launch of their own),
passing strides so that neither a transposition nor Mamba2's head
broadcast of q and k (an `expand` with head stride 0) is materialised,
and run `chunked_linear_attention_plain` for CPU tensors; any other device
raises.  They replace the Pallas kernel of the
reference's `kernels/ssd_scan/kernel.py`.  Bound on the card: operations
(see the source note).  `chunk_parallel_plain` is the kernel's
decomposition written in plain PyTorch, to check its algebra.

Any DK, DV >= 1, as the Pallas kernel takes.  Unlike the Pallas kernel, T
need not be a multiple of the chunk: the last
chunk is short, which equals the reference model's zero padding (padded
positions add nothing to y or the state).  `log_i` is optional (Mamba2
passes none).  The scan starts from a zero state, as the Pallas kernel
does; only the plain version takes an initial state (the reference model's
signature).
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from .. import _lib

CLIP = 30.0
TILE = 64           # kTile in the source: DK and DV are zero-padded to its multiples
MAX_CHUNK = 4096    # the chunk's gates sit in shared memory (pass 1)
# bf16 parts of an f32 operand (Parts<T>::MID in the source): the scratch
# holding the state entering each chunk has this many planes
STATE_PARTS = {torch.bfloat16: 2, torch.float32: 3}


def chunked_linear_attention_plain(
    q: torch.Tensor,  # (B, T, NH, DK)
    k: torch.Tensor,  # (B, T, NH, DK)
    v: torch.Tensor,  # (B, T, NH, DV)
    log_g: torch.Tensor,  # (B, T, NH) per-step log decay (<= 0)
    log_i: torch.Tensor | None = None,  # (B, T, NH) per-step log input gate
    init_state: torch.Tensor | None = None,  # (B, NH, DK, DV)
    chunk: int = 256,
) -> tuple[torch.Tensor, torch.Tensor]:
    """The reference's `models.ssm.chunked_linear_attention`, op for op:
    y_t = q_t . sum_{s<=t} exp(sum_{u in (s,t]} log_g_u + log_i_s) k_s v_s^T,
    all accumulation in f32.  Returns (y, final_state)."""
    B, T, NH, DK = q.shape
    DV = v.shape[-1]
    Q = min(chunk, T)
    pad = (-T) % Q
    if pad:
        q, k, v = (F.pad(a, (0, 0, 0, 0, 0, pad)) for a in (q, k, v))
        log_g = F.pad(log_g, (0, 0, 0, pad))
        if log_i is not None:
            log_i = F.pad(log_i, (0, 0, 0, pad), value=-CLIP)
    NC = (T + pad) // Q

    def rs(x):
        return x.float().reshape(B, NC, Q, *x.shape[2:])

    qs, ks, vs, gs = rs(q), rs(k), rs(v), rs(log_g)
    is_ = rs(log_i) if log_i is not None else None
    S = (init_state.float() if init_state is not None
         else torch.zeros(B, NH, DK, DV, dtype=torch.float32, device=q.device))
    tri = torch.ones(Q, Q, dtype=torch.bool, device=q.device).tril()
    ys = []
    for c in range(NC):
        qb, kb, vb, gb = qs[:, c], ks[:, c], vs[:, c], gs[:, c]
        cum = torch.cumsum(gb, dim=1)  # (B, Q, NH): sum of log_g over (0, t]
        total = cum[:, -1]  # (B, NH)
        li = is_[:, c] if is_ is not None else torch.zeros_like(cum)
        # intra-chunk: D[t, s] = exp(cum_t - cum_s + log_i_s) for s <= t
        dmat = cum[:, :, None, :] - cum[:, None, :, :] + li[:, None, :, :]
        dmat = torch.where(tri[None, :, :, None], torch.clamp(dmat, -CLIP, CLIP),
                           torch.full_like(dmat, -torch.inf))
        scores = torch.einsum("bthd,bshd->btsh", qb, kb) * torch.exp(dmat)
        y_intra = torch.einsum("btsh,bshv->bthv", scores, vb)
        # inter-chunk: decay from chunk start to t is exp(cum_t)
        y_inter = torch.einsum("bthd,bhdv->bthv",
                               qb * torch.exp(torch.clamp(cum, -CLIP, CLIP))[..., None], S)
        # new state: S' = exp(total) S + sum_s exp(total - cum_s + log_i_s) k_s v_s
        w = torch.exp(torch.clamp(total[:, None] - cum + li, -CLIP, CLIP))  # (B, Q, NH)
        S_local = torch.einsum("bshd,bsh,bshv->bhdv", kb, w, vb)
        S = torch.exp(torch.clamp(total, -CLIP, CLIP))[:, :, None, None] * S + S_local
        ys.append(y_intra + y_inter)
    y = torch.cat(ys, dim=1)[:, :T]
    return y.to(v.dtype), S


def chunk_parallel_plain(
    q: torch.Tensor,  # (B, T, NH, DK)
    k: torch.Tensor,
    v: torch.Tensor,  # (B, T, NH, DV)
    log_g: torch.Tensor,  # (B, T, NH)
    log_i: torch.Tensor | None = None,
    chunk: int = 256,
) -> tuple[torch.Tensor, torch.Tensor]:
    """The CUDA kernel's regrouping of the scan, in f32: (1) every chunk's
    cumulative decay and local state L_c = sum_s exp(clip(total_c - cum_s +
    li_s)) k_s v_s^T, all chunks at once; (2) the fold S_c =
    exp(clip(total_c)) S_{c-1} + L_c, keeping the state entering each
    chunk; (3) every chunk's outputs from its entering state and its own
    keys.  A short last chunk is left short, as the kernel leaves it."""
    B, T, NH, DK = q.shape
    DV = v.shape[-1]
    Q = min(chunk, T)
    bounds = [(c0, min(c0 + Q, T)) for c0 in range(0, T, Q)]
    q, k, v, log_g = q.float(), k.float(), v.float(), log_g.float()
    li = log_i.float() if log_i is not None else torch.zeros_like(log_g)
    cums, locals_ = [], []
    for c0, c1 in bounds:  # pass 1
        cum = torch.cumsum(log_g[:, c0:c1], dim=1)  # (B, L, NH)
        w = torch.exp(torch.clamp(cum[:, -1:] - cum + li[:, c0:c1], -CLIP, CLIP))
        cums.append(cum)
        locals_.append(torch.einsum("bshd,bsh,bshv->bhdv", k[:, c0:c1], w, v[:, c0:c1]))
    S = torch.zeros(B, NH, DK, DV, dtype=torch.float32, device=q.device)
    entering = []
    for cum, L in zip(cums, locals_):  # pass 2
        entering.append(S)
        S = torch.exp(torch.clamp(cum[:, -1], -CLIP, CLIP))[:, :, None, None] * S + L
    ys = []
    for (c0, c1), cum, S_in in zip(bounds, cums, entering):  # pass 3
        n = c1 - c0
        causal = torch.ones(n, n, dtype=torch.bool, device=q.device).tril()
        dmat = cum[:, :, None] - cum[:, None] + li[:, None, c0:c1]  # (B, t, s, NH)
        decay = torch.where(causal[None, :, :, None], torch.exp(torch.clamp(dmat, -CLIP, CLIP)),
                            torch.zeros_like(dmat))
        scores = torch.einsum("bthd,bshd->btsh", q[:, c0:c1], k[:, c0:c1]) * decay
        y = torch.einsum("btsh,bshv->bthv", scores, v[:, c0:c1])
        y = y + torch.einsum("bthd,bhdv->bthv", q[:, c0:c1], S_in) * \
            torch.exp(torch.clamp(cum, -CLIP, CLIP))[..., None]
        ys.append(y)
    return torch.cat(ys, dim=1), S


def vector_loads(*tensors: torch.Tensor) -> bool:
    """Whether the kernel may stream these (B, T, NH, D) views by 16-byte
    copies: bf16, every base address 16-byte aligned, and the batch, time
    and head strides and the feature width multiples of 8 elements (a
    head stride of 0, Mamba2's broadcast, qualifies).  Otherwise the kernel
    loads element by element.  The wrapper asks for q, k and v apart, so
    the mLSTM's q and k keep 16-byte loads beside its v of width hd + 1,
    which `ssd_scan_bthd` hands over as a copy with padded rows."""
    return all(t.dtype == torch.bfloat16 and t.data_ptr() % 16 == 0 and t.shape[-1] % 8 == 0
               and all(s % 8 == 0 for s in t.stride()[:3]) for t in tensors)


_P, _L, _I = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
# q, k, v, log_g, log_i, y, state, 5 scratch buffers (cum, li, local,
# entering, scores), 6 x (batch, time, head) strides (q, k, v, log_g, log_i,
# y), B, T, NH, DK, DV, chunk, in dtype, vector loads of q, k and v, stream
_SIGNATURES = {"ssd_forward": [_P] * 12 + [_L] * 18 + [_I] * 10 + [_P]}


def scratch_shapes(B: int, T: int, NH: int, DK: int, DV: int, chunk: int,
                   dtype: torch.dtype) -> dict[str, tuple[tuple[int, ...], torch.dtype]]:
    """The scratch a launch needs, by name: (shape, dtype).  cum and li
    (B, NH, T) f32; the chunks' local states (B, NH, nc, nk x nv 64 x 64
    tiles, 64, 64) f32, DK and DV padded to nk and nv tiles; the state
    entering each chunk, the same tiles in its bf16 parts; and, where DK or
    DV exceeds 64, the decayed scores of each chunk's (row block, key block
    <= it) pairs, (B, NH, nc, pairs, 64, 64) f32."""
    nc, nt = -(-T // chunk), -(-chunk // TILE)
    nk, nv = -(-DK // TILE), -(-DV // TILE)
    shapes = {
        "cum": ((B, NH, T), torch.float32),
        "li": ((B, NH, T), torch.float32),
        "local": ((B, NH, nc, nk * nv, TILE, TILE), torch.float32),
        "entering": ((B, NH, nc, nk * nv, STATE_PARTS[dtype], TILE, TILE), torch.bfloat16),
    }
    if nk > 1 or nv > 1:
        shapes["scores"] = ((B, NH, nc, nt * (nt + 1) // 2, TILE, TILE), torch.float32)
    return shapes


def _launch(q, k, v, log_g, log_i, y, state, chunk: int) -> None:
    """q/k: (B, T, NH, DK), y: (B, T, NH, DV), v: (B, T, NH, DV or more: the
    columns past DV are zeros the kernel may read), gates (B, T, NH) f32
    views with a unit last stride (the gates' head stride is free); state
    f32 (B, NH, DK, DV) contiguous."""
    B, T, NH, DK = q.shape
    DV = y.shape[-1]
    if not 1 <= chunk <= MAX_CHUNK:
        raise ValueError(f"chunk {chunk} outside [1, {MAX_CHUNK}]")
    if not (q.dtype == k.dtype == v.dtype == y.dtype):
        raise TypeError(f"q, k, v differ in dtype: {q.dtype}, {k.dtype}, {v.dtype}")
    code = _lib.dtype_code(q)
    for t in (q, k, v, y):
        if t.stride(-1) != 1:
            raise ValueError("ssd_scan needs a contiguous last dim in q, k, v")
    strides = [s for t in (q, k, v, log_g) for s in t.stride()[:3]]
    strides += list(log_i.stride()) if log_i is not None else [0, 0, 0]
    strides += list(y.stride()[:3])
    scratch = {name: torch.empty(shape, dtype=dt, device=q.device) for name, (shape, dt)
               in scratch_shapes(B, T, NH, DK, DV, chunk, q.dtype).items()}
    lib = _lib.load("ssd_scan", _SIGNATURES)
    err = lib.ssd_forward(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), log_g.data_ptr(),
        log_i.data_ptr() if log_i is not None else 0, y.data_ptr(), state.data_ptr(),
        *(scratch[n].data_ptr() if n in scratch else 0
          for n in ("cum", "li", "local", "entering", "scores")), *strides,
        B, T, NH, DK, DV, chunk, code, *(int(vector_loads(t)) for t in (q, k, v)),
        _lib.stream_handle(q))
    _lib.check("ssd_scan", err)
    ssd_scan.launches += 1


def _f32(t: torch.Tensor | None) -> torch.Tensor | None:
    return None if t is None else t.float()


def ssd_scan_bthd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, log_g: torch.Tensor,
                  log_i: torch.Tensor | None = None, chunk: int = 256
                  ) -> tuple[torch.Tensor, torch.Tensor]:
    """The model layout: q/k (B, T, NH, DK), v (B, T, NH, DV), gates
    (B, T, NH) -> (y (B, T, NH, DV) in v's dtype, state f32 (B, NH, DK, DV))."""
    tensors = [t for t in (q, k, v, log_g, log_i) if t is not None]
    if not _lib.route(*tensors):
        return chunked_linear_attention_plain(q, k, v, log_g, log_i, chunk=chunk)
    if _lib.needs_grad(*tensors):
        raise _lib.no_backward("ssd_scan", "ROADMAP.md queue 1, item 13d (hybrid and xLSTM "
                               "training on the card)")
    B, T, NH, DK = q.shape
    DV = v.shape[-1]
    if k.shape != q.shape or v.shape[:3] != (B, T, NH) or log_g.shape != (B, T, NH) or \
            (log_i is not None and log_i.shape != (B, T, NH)):
        raise ValueError(f"bad shapes q{tuple(q.shape)} k{tuple(k.shape)} v{tuple(v.shape)} "
                         f"log_g{tuple(log_g.shape)}")
    y = torch.empty(v.shape, dtype=v.dtype, device=v.device)
    state = torch.empty((B, NH, DK, DV), dtype=torch.float32, device=v.device)
    if v.dtype == torch.bfloat16 and not vector_loads(v):
        # rows the kernel cannot stream by 16-byte copies (the mLSTM's v of
        # width hd + 1, rows 2-byte aligned): a copy whose rows are
        # zero-padded to a multiple of 8 elements, which it can; element
        # loads of v cost more than the copy (PERF.md, section 6)
        padded = torch.zeros((B, T, NH, -(-DV // 8) * 8), dtype=v.dtype, device=v.device)
        padded[..., :DV] = v
        v = padded
    _launch(q, k, v, _f32(log_g), _f32(log_i), y, state, min(chunk, T))
    return y, state


def ssd_scan(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, log_g: torch.Tensor,
             log_i: torch.Tensor | None = None,
             chunk: int = 256) -> tuple[torch.Tensor, torch.Tensor]:
    """The reference kernel's layout: q/k (B, NH, T, DK), v (B, NH, T, DV),
    gates (B, NH, T) -> (y (B, NH, T, DV), state f32 (B, NH, DK, DV))."""
    y, state = ssd_scan_bthd(q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
                             log_g.transpose(1, 2),
                             None if log_i is None else log_i.transpose(1, 2), chunk)
    return y.transpose(1, 2), state


ssd_scan.launches = 0
