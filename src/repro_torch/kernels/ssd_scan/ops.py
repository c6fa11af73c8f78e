"""Chunked linear attention with decay (the Mamba2 SSD scan): the CUDA kernel
and its plain version.

`ssd_scan` takes the reference kernel's layout, q/k `(B, NH, T, DK)`, v
`(B, NH, T, DV)` and the gates `(B, NH, T)`; `ssd_scan_bthd` the model
path's, q/k `(B, T, NH, DK)`, v `(B, T, NH, DV)`, gates `(B, T, NH)`.  Both
return `(y, final_state)` with y in v's dtype and the state f32
`(B, NH, DK, DV)`.  They launch the Hopper kernels of `csrc/ssd_scan.cu`
for CUDA tensors (three launches a call: for narrow states the chunks'
local states, their fold in chunk order, the outputs; where DK or DV
exceeds 64, as the mLSTM's (hd, hd + 1) do, the state pass, a block a state
tile walking the chunks with the state on chip, the decayed scores, the
outputs),
passing strides so that neither a transposition nor Mamba2's head
broadcast of q and k (an `expand` with head stride 0) is materialised,
and run `chunked_linear_attention_plain` for CPU tensors; any other device
raises.  They replace the Pallas kernel of the
reference's `kernels/ssd_scan/kernel.py`.  Bound on the card: operations
(see the source note).  `chunk_parallel_plain` is the kernel's
decomposition written in plain PyTorch, to check its algebra.

q and k may each be one head, (B, T, 1, DK), broadcast over v's NH heads
(Mamba2's B and C); the kernels read it with head stride 0 and the plain
versions expand it.

Under grad (any input requiring a gradient), bf16 q, k and v take the
forward kernel through `_ScanFn`, whose backward launches
`ssd_scan_backward` (the gradient of the reference's
`chunked_linear_attention`, which the reference takes with `jax.grad`; no
Pallas counterpart): any DK, DV, T and chunk, q and k one head or per head,
log_i or not, a final-state cotangent or none.  A one-head q or k gets its
gradient summed over the heads, at its own shape.  f32 inputs under grad
raise (`_lib.no_backward`, ROADMAP.md queue 1, item 13f).
`chunked_linear_attention_backward_plain` is its plain version, written
out in the kernel's regrouping; on the CPU the gradient is autograd's
through the plain forward.  `backward_plan` is the backward's route and
launch shape in plain Python.

Any DK, DV >= 1, as the Pallas kernel takes.  Unlike the Pallas kernel, T
need not be a multiple of the chunk: the last
chunk is short, which equals the reference model's zero padding (padded
positions add nothing to y or the state).  `log_i` is optional (Mamba2
passes none).  The scan starts from a zero state, as the Pallas kernel
does; only the plain version takes an initial state (the reference model's
signature).

`scan_work` and `scan_backward_work` are each entry's bytes and operations
at a call's shapes (`kernels/work.py`), added to the wrappers' counters.
A meta call (the dry run) runs the CUDA route, its scratch allocations
included, without the launches.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from .. import _lib
from ..work import Work, count, reset

CLIP = 30.0
TILE = 64           # kTile in the source: DK and DV are zero-padded to its multiples
MAX_CHUNK = 4096    # the chunk's gates sit in shared memory (pass 1)
# bf16 parts of an f32 operand (Parts<T>::MID in the source): the scratch
# holding the state entering each chunk has this many planes
STATE_PARTS = {torch.bfloat16: 2, torch.float32: 3}
# those of the wide path's decayed scores (Parts<T>::SCORE)
SCORE_PARTS = {torch.bfloat16: 3, torch.float32: 3}
NO_BACKWARD_F32 = "ROADMAP.md queue 1, item 13f: no training path on the card runs the scan in f32"


def chunked_linear_attention_plain(
    q: torch.Tensor,  # (B, T, NH, DK), or (B, T, 1, DK) broadcast over the heads
    k: torch.Tensor,  # likewise
    v: torch.Tensor,  # (B, T, NH, DV)
    log_g: torch.Tensor,  # (B, T, NH) per-step log decay (<= 0)
    log_i: torch.Tensor | None = None,  # (B, T, NH) per-step log input gate
    init_state: torch.Tensor | None = None,  # (B, NH, DK, DV)
    chunk: int = 256,
) -> tuple[torch.Tensor, torch.Tensor]:
    """The reference's `models.ssm.chunked_linear_attention`, op for op:
    y_t = q_t . sum_{s<=t} exp(sum_{u in (s,t]} log_g_u + log_i_s) k_s v_s^T,
    all accumulation in f32.  Returns (y, final_state)."""
    q, k = _heads(q, k, v)
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
    q, k = _heads(q, k, v)
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


def _heads(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """q and k at v's heads: a one-head q or k (B, T, 1, DK) is broadcast
    over them (an `expand`, a view)."""
    B, T, NH = v.shape[:3]
    return q.expand(B, T, NH, q.shape[-1]), k.expand(B, T, NH, k.shape[-1])


def _passes(x: torch.Tensor) -> torch.Tensor:
    """Where clip(x, -CLIP, CLIP) passes its gradient (torch.clamp's rule)."""
    return (x >= -CLIP) & (x <= CLIP)


def chunked_linear_attention_backward_plain(
    q: torch.Tensor,  # (B, T, NH, DK), or (B, T, 1, DK) broadcast over the heads
    k: torch.Tensor,  # likewise
    v: torch.Tensor,  # (B, T, NH, DV)
    log_g: torch.Tensor,  # (B, T, NH)
    log_i: torch.Tensor | None,
    dy: torch.Tensor,  # (B, T, NH, DV): the cotangent of y
    dS_fin: torch.Tensor | None,  # (B, NH, DK, DV): of the final state; None is zero
    chunk: int = 256,
) -> tuple[torch.Tensor, ...]:
    """The gradient of `chunked_linear_attention_plain` (from a zero
    state), written out in the CUDA kernel's regrouping rather than taken
    by autograd, all in f32.  Per chunk, with cum, total, li and the clips
    as in the forward, w_s = exp(clip(total - cum_s + li_s)), D_ts =
    exp(clip(cum_t - cum_s + li_s)) for s <= t, S_c the state entering
    chunk c and G_c the cotangent of the state leaving it (G_last = dS_fin,
    G_{c-1} = exp(clip(total_c)) G_c + sum_t exp(clip(cum_t)) q_t dy_t^T):

      dq_t = sum_{s<=t} D_ts (dy_t.v_s) k_s + exp(clip(cum_t)) S_c dy_t
      dk_s = sum_{t>=s} D_ts (dy_t.v_s) q_t + w_s G_c v_s
      dv_s = sum_{t>=s} D_ts (q_t.k_s) dy_t + w_s G_c^T k_s

    The gates: each intra pair's g_ts = D_ts (q_t.k_s)(dy_t.v_s) goes to
    dcum_t, -dcum_s and dli_s; the inter term exp(cum_t) q_t.S_c dy_t to
    dcum_t; the state term h_s = w_s k_s.G_c v_s to dtotal, -dcum_s and
    dli_s; the decay term exp(total) <S_c, G_c> to dtotal; each only where
    its clip passes.  dlog_g_u = sum_{t>=u in the chunk} dcum_t + dtotal.
    Returns (dq, dk, dv, dlog_g, dlog_i) in f32, dq and dk at q's and k's
    shapes: per head, or for a one-head q or k broadcast over the heads,
    the sum over the heads; dlog_i None without log_i."""
    heads_q, heads_k = q.shape[2], k.shape[2]
    q, k = _heads(q, k, v)
    B, T, NH, DK = q.shape
    DV = v.shape[-1]
    Q = min(chunk, T)
    bounds = [(c0, min(c0 + Q, T)) for c0 in range(0, T, Q)]
    q, k, v, dy, g = q.float(), k.float(), v.float(), dy.float(), log_g.float()
    li = log_i.float() if log_i is not None else torch.zeros_like(g)
    G = (dS_fin.float() if dS_fin is not None
         else torch.zeros(B, NH, DK, DV, dtype=torch.float32, device=q.device))
    cums = [torch.cumsum(g[:, c0:c1], dim=1) for c0, c1 in bounds]  # (B, L, NH)
    S, entering = torch.zeros_like(G), []
    for (c0, c1), cum in zip(bounds, cums):  # the forward's passes 1-2
        entering.append(S)
        w = torch.exp(torch.clamp(cum[:, -1:] - cum + li[:, c0:c1], -CLIP, CLIP))
        S = torch.exp(torch.clamp(cum[:, -1], -CLIP, CLIP))[:, :, None, None] * S + \
            torch.einsum("bshd,bsh,bshv->bhdv", k[:, c0:c1], w, v[:, c0:c1])
    leaving = [None] * len(bounds)
    for c in reversed(range(len(bounds))):  # the state cotangents, last chunk first
        (c0, c1), cum = bounds[c], cums[c]
        leaving[c] = G
        e = torch.exp(torch.clamp(cum, -CLIP, CLIP))
        G = torch.exp(torch.clamp(cum[:, -1], -CLIP, CLIP))[:, :, None, None] * G + \
            torch.einsum("bthd,bth,bthv->bhdv", q[:, c0:c1], e, dy[:, c0:c1])
    dq, dk, dv = torch.zeros_like(q), torch.zeros_like(k), torch.zeros_like(v)
    dlog_g, dli = torch.zeros_like(g), torch.zeros_like(g)
    for (c0, c1), cum, S_c, G_c in zip(bounds, cums, entering, leaving):
        n = c1 - c0
        qc, kc, vc, dyc, lic = q[:, c0:c1], k[:, c0:c1], v[:, c0:c1], dy[:, c0:c1], li[:, c0:c1]
        total = cum[:, -1]  # (B, NH)
        causal = torch.ones(n, n, dtype=torch.bool, device=q.device).tril()[None, :, :, None]
        a = cum[:, :, None] - cum[:, None] + lic[:, None]  # (B, t, s, NH)
        decay = torch.where(causal, torch.exp(torch.clamp(a, -CLIP, CLIP)), torch.zeros_like(a))
        p = torch.einsum("bthd,bshd->btsh", qc, kc) * decay  # the forward's decayed scores
        dp = torch.einsum("bthv,bshv->btsh", dyc, vc)
        ds = decay * dp
        gts = torch.where(causal & _passes(a), p * dp, torch.zeros_like(p))
        e = torch.exp(torch.clamp(cum, -CLIP, CLIP))  # (B, t, NH)
        w = torch.exp(torch.clamp(total[:, None] - cum + lic, -CLIP, CLIP))  # (B, s, NH)
        s_dy = torch.einsum("bhdv,bthv->bthd", S_c, dyc)
        g_v = torch.einsum("bhdv,bshv->bshd", G_c, vc)
        dq[:, c0:c1] = torch.einsum("btsh,bshd->bthd", ds, kc) + e[..., None] * s_dy
        dk[:, c0:c1] = torch.einsum("btsh,bthd->bshd", ds, qc) + w[..., None] * g_v
        dv[:, c0:c1] = torch.einsum("btsh,bthv->bshv", p, dyc) + \
            w[..., None] * torch.einsum("bhdv,bshd->bshv", G_c, kc)
        inter = torch.where(_passes(cum), e * (qc * s_dy).sum(-1), torch.zeros_like(e))
        h = torch.where(_passes(total[:, None] - cum + lic), w * (kc * g_v).sum(-1),
                        torch.zeros_like(w))
        decay_term = torch.where(_passes(total), torch.exp(torch.clamp(total, -CLIP, CLIP))
                                 * (S_c * G_c).sum((-2, -1)), torch.zeros_like(total))
        rows, cols = gts.sum(2), gts.sum(1)  # over s for each t; over t for each s
        dcum = rows - cols + inter - h
        dli[:, c0:c1] = cols + h
        dtotal = h.sum(1) + decay_term
        dlog_g[:, c0:c1] = dcum.flip(1).cumsum(1).flip(1) + dtotal[:, None]
    if heads_q == 1 < NH:
        dq = dq.sum(2, keepdim=True)
    if heads_k == 1 < NH:
        dk = dk.sum(2, keepdim=True)
    return dq, dk, dv, dlog_g, (dli if log_i is not None else None)


def scan_work(B: int, T: int, NH: int, DK: int, DV: int, chunk: int, esize: int,
              broadcast: bool, with_i: bool) -> Work:
    """The forward.  Bytes: q and k read once (once a head, or once for all
    heads where they are broadcast), v read and y written in the input
    dtype (`esize` bytes), the f32 gates and the f32 final state.
    Operations: q.k over the causal (t, s) pairs of each chunk has two
    input operands (bf16: the bf16 class), once for all heads where q and k
    are broadcast (the scores differ by head only in their decay, applied
    elementwise); the decayed scores times v, q times the state entering
    each chunk after the first, and the weighted k times v for every chunk
    each have an f32 operand, which the kernel splits into two bf16 parts
    (bf16x2); f32 inputs make every product six bf16 products (bf16x6)."""
    heads_qk = 1 if broadcast else NH
    nbytes = (2 * B * T * heads_qk * DK * esize + 2 * B * T * NH * DV * esize
              + (2 if with_i else 1) * B * T * NH * 4 + B * NH * DK * DV * 4)
    ops_qk = ops_split = 0.0
    for c0 in range(0, T, chunk):
        lc = min(chunk, T - c0)
        pairs = lc * (lc + 1) / 2
        ops_qk += pairs * 2 * DK
        ops_split += pairs * 2 * DV + 2 * lc * DK * DV * (2 if c0 > 0 else 1)
    if esize == 4:
        return Work(nbytes, (("bf16x6", B * (heads_qk * ops_qk + NH * ops_split)),))
    return Work(nbytes, (("bf16", B * heads_qk * ops_qk), ("bf16x2", B * NH * ops_split)))


def scan_backward_work(B: int, T: int, NH: int, DK: int, DV: int, chunk: int, broadcast: bool,
                       with_i: bool, final: bool) -> Work:
    """The backward (bf16): the least the function needs.  Bytes: q and k
    read once (once for all heads where broadcast), v and dy, the f32 gates
    (and log_i), the f32 final-state cotangent where given; dq and dk
    written once (head-summed where q and k are broadcast: the per-head
    rows of a design that sums later are bytes of the design, not of the
    function), dv, dlog_g (and dlog_i) f32.  Operations, per chunk of L
    steps and its L(L+1)/2 causal pairs: q.k^T over the pairs (once for all
    heads where broadcast) and dy.v^T (per head), both operands bf16 (the
    bf16 class); every other product has an f32 operand in two bf16 parts
    (bf16x2): the forward's local states again and the chunk's U_c (2 L DK
    DV each), the three state terms (dq's skipped in the first chunk) and
    dS.k, dS^T.q, P^T.dy over the pairs."""
    heads_qk = 1 if broadcast else NH
    gates = (2 if with_i else 1) * B * T * NH * 4
    nbytes = (2 * B * T * heads_qk * DK * 2 + 2 * B * T * NH * DV * 2 + gates
              + (B * NH * DK * DV * 4 if final else 0)
              + 2 * B * T * heads_qk * DK * 2 + B * T * NH * DV * 2 + gates)
    qk = dyv = split = 0.0
    for c0 in range(0, T, chunk):
        lc = min(chunk, T - c0)
        pairs = lc * (lc + 1) / 2
        qk += 2 * pairs * DK
        dyv += 2 * pairs * DV
        split += 2 * lc * DK * DV * (5 if c0 > 0 else 4) + 2 * pairs * (2 * DK + DV)
    return Work(nbytes, (("bf16", B * (heads_qk * qk + NH * dyv)), ("bf16x2", B * NH * split)))


def _broadcast(q: torch.Tensor, k: torch.Tensor) -> bool:
    """q and k one head for all of v's: one head, or expanded (head stride
    0) over several."""
    return all(t.shape[2] == 1 or t.stride(2) == 0 for t in (q, k))


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
# entering, scores; local null past 64-wide states, scores null within), 6 x
# (batch, time, head) strides (q, k, v, log_g, log_i, y), B, T, NH, DK, DV,
# chunk, in dtype, vector loads of q, k and v, stream
# the backward's pairs route: q, k, v, log_g, log_i, dy, dstate, dq, dk, dv,
# dlog_g, dlog_i, 11 scratch buffers (`BACKWARD_SCRATCH`), 6 x (batch,
# time, head) strides (q, k, v, log_g, log_i, dy), B, T, NH, DK, DV, chunk,
# in dtype, vector loads of q, k, v and dy, stream; its heads route: the
# same pointers with `HEADS_SCRATCH`, the strides, B, T, NH, DK, DV, chunk,
# head groups, heads a group, q/k heads, the vector loads, stream
_SIGNATURES = {"ssd_forward": [_P] * 12 + [_L] * 18 + [_I] * 10 + [_P],
               "ssd_backward": [_P] * 23 + [_L] * 18 + [_I] * 11 + [_P],
               "ssd_backward_heads": [_P] * 23 + [_L] * 18 + [_I] * 13 + [_P]}
BACKWARD_SCRATCH = ("cum", "li", "entering", "gstate", "pmat", "dsmat", "rpart", "cpart",
                    "ipart", "hpart", "dpart")
HEADS_SCRATCH = ("cum", "li", "entering", "gstate", "rpart", "cpart", "ipart", "hpart", "dpart",
                 "dqp", "dkp")
# what `_ScanFn` keeps of the forward's scratch for the backward (either route)
SAVED = ("cum", "li", "entering")
HEADS_MAX_CHUNK = 4 * TILE  # kMaxTb * kTile: the heads route's row blocks a chunk
HEAD_BLOCKS = 256  # the heads kernel's blocks to aim for (one an SM at a time)


def scratch_shapes(B: int, T: int, NH: int, DK: int, DV: int, chunk: int,
                   dtype: torch.dtype) -> dict[str, tuple[tuple[int, ...], torch.dtype]]:
    """The scratch a launch needs, by name: (shape, dtype).  cum and li
    (B, NH, T) f32; the state entering each chunk, (B, NH, nc, nk x nv 64 x
    64 tiles, parts, 64, 64) in the dtype's bf16 parts, DK and DV padded to
    nk and nv tiles; for narrow states (one tile) the chunks' local states,
    (B, NH, nc, 1, 64, 64) f32; past them (DK or DV over 64, where the state
    pass keeps each tile's running state on chip and no local state leaves
    it) the decayed scores of each chunk's (row block, key block <= it)
    pairs in three bf16 parts (`SCORE_PARTS`), (B, NH, nc, pairs, 3, 64,
    64)."""
    nc, nt = -(-T // chunk), -(-chunk // TILE)
    nk, nv = -(-DK // TILE), -(-DV // TILE)
    parts = STATE_PARTS[dtype]
    shapes = {
        "cum": ((B, NH, T), torch.float32),
        "li": ((B, NH, T), torch.float32),
        "entering": ((B, NH, nc, nk * nv, parts, TILE, TILE), torch.bfloat16),
    }
    if nk > 1 or nv > 1:
        shapes["scores"] = ((B, NH, nc, nt * (nt + 1) // 2, SCORE_PARTS[dtype], TILE, TILE),
                            torch.bfloat16)
    else:
        shapes["local"] = ((B, NH, nc, 1, TILE, TILE), torch.float32)
    return shapes


def backward_plan(B: int, T: int, NH: int, NQ: int, DK: int, DV: int, chunk: int
                  ) -> tuple[str, int, int]:
    """The backward's route and launch shape, from shapes alone, as
    `ssd_backward_heads` takes it: ("heads", head groups, heads a group)
    for DK and DV at most 64 and chunks of at most 256 steps, NQ the q/k
    heads (1: q and k broadcast over the NH heads, whose gradients the
    kernel sums; else NH, and a group is one head); ("pairs", 0, 0)
    otherwise.  Broadcast heads are spread over enough groups for about
    HEAD_BLOCKS (key block, group, chunk, batch) blocks, every group but
    the last full."""
    chunk = min(chunk, T)
    if DK > TILE or DV > TILE or chunk > HEADS_MAX_CHUNK:
        return "pairs", 0, 0
    if NQ != 1:
        return "heads", NH, 1
    blocks = B * -(-T // chunk) * -(-chunk // TILE)
    hg = -(-NH // min(NH, -(-HEAD_BLOCKS // blocks)))
    return "heads", -(-NH // hg), hg


def backward_scratch_shapes(B: int, T: int, NH: int, DK: int, DV: int, chunk: int
                            ) -> dict[str, tuple[tuple[int, ...], torch.dtype]]:
    """The scratch of a backward launch on the pairs route (bf16 inputs)
    beside the forward's `SAVED` cum, li and entering, by name: gstate, the
    cotangent of the state leaving each chunk, laid out as `entering`; pmat
    and dsmat, P and dS of each chunk's (row block, key block <= it) pairs
    in two bf16 parts, (B, NH, nc, pairs, 2, 64, 64); rpart and cpart, the pairs' sums of the
    gate term by row and by column, (B, NH, nc, pairs, 64); ipart and
    hpart, the inter and state gate terms over each DK tile, (B, NH, nk,
    T); dpart, the decay term over each state tile, (B, NH, nc, nk x nv).
    No chunk's U_c leaves the chip (the state pass folds it in)."""
    nc, nt = -(-T // chunk), -(-chunk // TILE)
    nk, nv = -(-DK // TILE), -(-DV // TILE)
    pairs = nt * (nt + 1) // 2
    return dict(
        gstate=scratch_shapes(B, T, NH, DK, DV, chunk, torch.bfloat16)["entering"],
        pmat=((B, NH, nc, pairs, 2, TILE, TILE), torch.bfloat16),
        dsmat=((B, NH, nc, pairs, 2, TILE, TILE), torch.bfloat16),
        rpart=((B, NH, nc, pairs, TILE), torch.float32),
        cpart=((B, NH, nc, pairs, TILE), torch.float32),
        ipart=((B, NH, nk, T), torch.float32),
        hpart=((B, NH, nk, T), torch.float32),
        dpart=((B, NH, nc, nk * nv), torch.float32))


def heads_scratch_shapes(B: int, T: int, NH: int, chunk: int, groups: int
                         ) -> dict[str, tuple[tuple[int, ...], torch.dtype]]:
    """The scratch of a backward launch on the heads route beside the
    forward's `SAVED` cum, li and entering, by name: gstate, laid out as
    entering (as on the pairs route); rpart, each pair's
    step sums of the gate term from each of its four warps, (B, NH, nc,
    pairs, 4, 64); cpart, ipart and hpart complete, (B, NH, T); dpart, the
    decay term, (B, NH, nc); dqp and dkp, each head group's f32 shares of dq
    by pair and of dk by key block, (B, nc, groups, pairs or row blocks,
    64, 64)."""
    shapes = scratch_shapes(B, T, NH, 1, 1, chunk, torch.bfloat16)
    nc, nt = -(-T // chunk), -(-chunk // TILE)
    pairs = nt * (nt + 1) // 2
    f32 = torch.float32
    return dict(
        gstate=shapes["entering"],
        rpart=((B, NH, nc, pairs, 4, TILE), f32),
        cpart=((B, NH, T), f32), ipart=((B, NH, T), f32), hpart=((B, NH, T), f32),
        dpart=((B, NH, nc), f32),
        dqp=((B, nc, groups, pairs, TILE, TILE), f32),
        dkp=((B, nc, groups, nt, TILE, TILE), f32))


def _streamable(t: torch.Tensor) -> torch.Tensor:
    """A bf16 (B, T, NH, D) tensor the kernel can stream by 16-byte copies:
    `t` itself, or a copy whose rows are zero-padded to a multiple of 8
    elements (the mLSTM's v and dy of width hd + 1, rows 2-byte aligned;
    element loads cost more than the copy, PERF.md section 6)."""
    if t.dtype != torch.bfloat16 or vector_loads(t):
        return t
    B, T, NH, D = t.shape
    padded = torch.empty((B, T, NH, -(-D // 8) * 8), dtype=t.dtype, device=t.device)
    padded[..., D:] = 0  # the pad columns alone: a fill of the whole copy costs as much again
    padded[..., :D] = t
    return padded


def _empty(shapes: dict, device) -> dict[str, torch.Tensor]:
    return {name: torch.empty(shape, dtype=dt, device=device)
            for name, (shape, dt) in shapes.items()}


def _launch(q, k, v, log_g, log_i, y, state, chunk: int) -> dict[str, torch.Tensor]:
    """q/k: (B, T, NH, DK) (one head broadcast: head stride 0), y: (B, T,
    NH, DV), v: (B, T, NH, DV or more: the columns past DV are zeros the
    kernel may read), gates (B, T, NH) f32 views with a unit last stride
    (the gates' head stride is free); state f32 (B, NH, DK, DV) contiguous.
    Returns the scratch, which holds cum, li and the entering states."""
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
    scratch = _empty(scratch_shapes(B, T, NH, DK, DV, chunk, q.dtype), q.device)
    _lib.launch(q, "ssd_scan", lambda: _lib.load("ssd_scan", _SIGNATURES).ssd_forward(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), log_g.data_ptr(),
        log_i.data_ptr() if log_i is not None else 0, y.data_ptr(), state.data_ptr(),
        *(scratch[n].data_ptr() if n in scratch else 0
          for n in ("cum", "li", "local", "entering", "scores")), *strides,
        B, T, NH, DK, DV, chunk, code, *(int(vector_loads(t)) for t in (q, k, v)),
        _lib.stream_handle(q)))
    count(ssd_scan, scan_work(B, T, NH, DK, DV, chunk, q.element_size(), _broadcast(q, k),
                              log_i is not None))
    return scratch


def _strides(q, k, v, log_g, log_i, dy) -> list[int]:
    strides = [s for t in (q, k, v, log_g) for s in t.stride()[:3]]
    strides += list(log_i.stride()) if log_i is not None else [0, 0, 0]
    return strides + list(dy.stride()[:3])


def _outputs(v, log_i, DK: int, DV: int, qk_heads: int) -> list:
    B, T, NH = v.shape[:3]
    outs = [torch.empty((B, T, qk_heads, DK), dtype=v.dtype, device=v.device) for _ in range(2)]
    outs.append(torch.empty((B, T, NH, DV), dtype=v.dtype, device=v.device))
    outs.append(torch.empty((B, T, NH), dtype=torch.float32, device=v.device))
    outs.append(None if log_i is None else torch.empty_like(outs[-1]))
    return outs


def _launch_backward(q, k, v, log_g, log_i, dy, dstate, DK: int, DV: int, chunk: int,
                     saved: dict):
    """The pairs route on CUDA, bf16: q/k (B, T, NH, DK or more, zero past
    DK; any batch, time and head strides), v and dy (B, T, NH, DV or more,
    zero past DV), gates f32 (B, T, NH) with a unit last stride, dstate f32
    (B, NH, DK, DV) contiguous or None (zero); `saved`: the forward's cum,
    li and entering (`SAVED`) at these inputs.  Returns (dq, dk, dv,
    dlog_g, dlog_i): dq, dk and dv per head in bf16, the gates' f32,
    dlog_i None without log_i."""
    B, T, NH = v.shape[:3]
    outs = _outputs(v, log_i, DK, DV, NH)
    scratch = _empty(backward_scratch_shapes(B, T, NH, DK, DV, chunk), q.device)
    scratch.update(saved)
    _lib.launch(q, "ssd_scan_backward", lambda: _lib.load("ssd_scan", _SIGNATURES).ssd_backward(
        *(0 if t is None else t.data_ptr() for t in (q, k, v, log_g, log_i, dy, dstate, *outs)),
        *(scratch[n].data_ptr() for n in BACKWARD_SCRATCH), *_strides(q, k, v, log_g, log_i, dy),
        B, T, NH, DK, DV, chunk, _lib.dtype_code(q), *(int(vector_loads(t)) for t in (q, k, v, dy)),
        _lib.stream_handle(q)))
    count(ssd_scan_backward, scan_backward_work(B, T, NH, DK, DV, chunk, _broadcast(q, k),
                                                log_i is not None, dstate is not None))
    return tuple(outs)


def _launch_heads(q, k, v, log_g, log_i, dy, dstate, DK: int, DV: int, chunk: int,
                  qk_heads: int, groups: int, heads_a_group: int, saved: dict):
    """The heads route on CUDA, bf16, the arguments as `_launch_backward`'s;
    `saved`: the forward's cum, li and entering (`SAVED`) at these inputs.
    dq and dk at (B, T, qk_heads, DK)."""
    B, T, NH = v.shape[:3]
    outs = _outputs(v, log_i, DK, DV, qk_heads)
    scratch = _empty(heads_scratch_shapes(B, T, NH, chunk, groups), q.device)
    scratch.update(saved)
    _lib.launch(q, "ssd_scan_backward", lambda: _lib.load(
        "ssd_scan", _SIGNATURES).ssd_backward_heads(
        *(0 if t is None else t.data_ptr() for t in (q, k, v, log_g, log_i, dy, dstate, *outs)),
        *(scratch[n].data_ptr() for n in HEADS_SCRATCH),
        *_strides(q, k, v, log_g, log_i, dy), B, T, NH, DK, DV, chunk, groups, heads_a_group,
        qk_heads, *(int(vector_loads(t)) for t in (q, k, v, dy)),
        _lib.stream_handle(q)))
    count(ssd_scan_backward, scan_backward_work(B, T, NH, DK, DV, chunk, _broadcast(q, k),
                                                log_i is not None, dstate is not None))
    return tuple(outs)


def ssd_scan_backward(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, log_g: torch.Tensor,
                      log_i: torch.Tensor | None, dy: torch.Tensor,
                      dstate: torch.Tensor | None, chunk: int = 256,
                      saved: dict | None = None) -> tuple:
    """The gradient of `ssd_scan_bthd` in the model layout: (dq, dk, dv,
    dlog_g, dlog_i) from the inputs, dy (B, T, NH, DV) and the final
    state's cotangent dstate (B, NH, DK, DV; None is zero).  dq and dk
    have q's and k's shapes: per head, or, for a one-head q or k (B, T, 1,
    DK) broadcast over the heads, the sum over the heads; in the inputs'
    dtype, as is dv; the gates' are f32, dlog_i None without log_i.  CUDA
    tensors (bf16 q, k, v) launch the backward kernels of
    `csrc/ssd_scan.cu`: for DK, DV <= 64 and chunks of at most 256 steps
    the heads route (`backward_plan`; three launches: the state
    cotangents, the gradients, their sums and the gates), which sums a
    broadcast q's and k's gradients over the heads itself; otherwise the
    pairs route (six launches: the state cotangents, the pairs' scores, dq,
    dk, dv, the gates), per head, a one-head q's or k's then summed over
    the heads here.  Either route runs on the forward's scratch in `saved`
    (`forward_saved`; None runs the forward kernel first, as the step's
    forward launch would).  CPU tensors run
    `chunked_linear_attention_backward_plain`."""
    tensors = [t for t in (q, k, v, log_g, log_i, dy, dstate) if t is not None]
    chunk = min(chunk, q.shape[1])
    if not _lib.route(*tensors):
        dq, dk, dv, dlog_g, dlog_i = chunked_linear_attention_backward_plain(
            q, k, v, log_g, log_i, dy, dstate, chunk)
        return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype), dlog_g, dlog_i
    _check(q, k, v, log_g, log_i, chunk)
    if q.dtype != torch.bfloat16:
        raise _lib.no_backward("ssd_scan", f"{q.dtype} ({NO_BACKWARD_F32})")
    B, T, NH, DK = v.shape[:3] + q.shape[-1:]
    DV = v.shape[-1]
    if dy.shape != v.shape or (dstate is not None and dstate.shape != (B, NH, DK, DV)):
        raise ValueError(f"bad cotangents dy{tuple(dy.shape)} for v{tuple(v.shape)}")
    return _backward(q, k, _streamable(v), log_g, log_i, dy, dstate, DV, chunk, saved)


def _backward(q, k, v, log_g, log_i, dy, dstate, DV: int, chunk: int, saved=None) -> tuple:
    """The backward kernel on CUDA tensors whose shapes `_check` passed, v
    already `_streamable` (columns past DV zero)."""
    B, T, NH = v.shape[:3]
    DK = q.shape[-1]
    qk_heads = 1 if q.shape[2] == k.shape[2] == 1 else NH
    route, groups, heads_a_group = backward_plan(B, T, NH, qk_heads, DK, DV, chunk)
    qe, ke = _heads(_streamable(q), _streamable(k), v)
    args = (qe, ke, v, _f32(log_g), _f32(log_i), _streamable(dy.to(v.dtype).contiguous()),
            None if dstate is None else dstate.float().contiguous(), DK, DV, chunk)
    if saved is None:
        scratch = _forward(q, k, v, log_g, log_i, chunk, DV)[2]
        saved = {n: scratch[n] for n in SAVED}
    if route == "heads":
        dq, dk, *rest = _launch_heads(*args, qk_heads, groups, heads_a_group, saved)
    else:
        dq, dk, *rest = _launch_backward(*args, saved)
    # per-head gradients of a one-head q or k (the pairs route, or only one
    # of the two broadcast): their sum over the heads
    if dq.shape[2] != q.shape[2]:
        dq = dq.float().sum(2, keepdim=True).to(q.dtype)
    if dk.shape[2] != k.shape[2]:
        dk = dk.float().sum(2, keepdim=True).to(k.dtype)
    return (dq, dk, *rest)


class _ScanFn(torch.autograd.Function):
    """`ssd_scan_bthd` with its backward kernel: q, k (per head, or one head
    broadcast over v's heads, whose gradients then come back summed over
    them), v, log_g (f32) and log_i (f32 or None) in; y and the final state
    out.  It keeps the forward's cum, li and entering states (`SAVED`; 21
    MB a call at zamba2-2.7b's train micro-batch on the heads route, 285 MB
    at xlstm-1.3b's mLSTM on the pairs route), so neither backward route
    runs the forward's passes again; under remat (`torch.utils.checkpoint`)
    the kept scratch is the recompute's, held only until its block's
    backward.  It saves v as the forward streamed it (the mLSTM's padded
    copy), so the backward pads only dy.  A None cotangent (the state,
    which training discards) is zero."""

    @staticmethod
    def forward(ctx, q, k, v, log_g, log_i, chunk: int):
        ctx.set_materialize_grads(False)
        ctx.chunk, ctx.dv = chunk, v.shape[-1]
        v = _streamable(v)
        y, state, scratch = _forward(q, k, v, log_g, log_i, chunk, ctx.dv)
        ctx.save_for_backward(q, k, v, log_g, log_i, *(scratch[n] for n in SAVED))
        return y, state

    @staticmethod
    def backward(ctx, dy, dstate):
        q, k, v, log_g, log_i, *kept = ctx.saved_tensors
        if dy is None:  # v's streamed shape, zero past DV as the kernel reads it
            dy = torch.zeros(v.shape, dtype=v.dtype, device=v.device)
        saved = dict(zip(SAVED, kept))
        return (*_backward(q, k, v, log_g, log_i, dy, dstate, ctx.dv, ctx.chunk, saved), None)


def _f32(t: torch.Tensor | None) -> torch.Tensor | None:
    return None if t is None else t.float()


def _check(q, k, v, log_g, log_i, chunk: int) -> None:
    B, T, NH = v.shape[:3]
    DK = q.shape[-1]
    if any(t.shape not in ((B, T, NH, DK), (B, T, 1, DK)) for t in (q, k)) or \
            log_g.shape != (B, T, NH) or (log_i is not None and log_i.shape != (B, T, NH)):
        raise ValueError(f"bad shapes q{tuple(q.shape)} k{tuple(k.shape)} v{tuple(v.shape)} "
                         f"log_g{tuple(log_g.shape)}")
    if not 1 <= chunk <= MAX_CHUNK:
        raise ValueError(f"chunk {chunk} outside [1, {MAX_CHUNK}]")


def _forward(q, k, v, log_g, log_i, chunk: int, DV: int) -> tuple:
    """The forward kernel on CUDA tensors whose shapes `_check` passed, v
    already `_streamable` (columns past DV zero): (y, state, scratch)."""
    B, T, NH = v.shape[:3]
    q, k = _heads(q, k, v)
    y = torch.empty((B, T, NH, DV), dtype=v.dtype, device=v.device)
    state = torch.empty((B, NH, q.shape[-1], DV), dtype=torch.float32, device=v.device)
    scratch = _launch(q, k, v, _f32(log_g), _f32(log_i), y, state, chunk)
    return y, state, scratch


def forward_saved(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, log_g: torch.Tensor,
                  log_i: torch.Tensor | None = None, chunk: int = 256) -> dict:
    """The forward kernel's scratch that `_ScanFn` keeps for the backward
    (`SAVED`), from one forward launch at these CUDA inputs:
    `ssd_scan_backward(..., saved=...)` then runs as a train step's does."""
    chunk = min(chunk, q.shape[1])
    _check(q, k, v, log_g, log_i, chunk)
    scratch = _forward(q, k, _streamable(v), log_g, log_i, chunk, v.shape[-1])[2]
    return {n: scratch[n] for n in SAVED}


def ssd_scan_bthd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, log_g: torch.Tensor,
                  log_i: torch.Tensor | None = None, chunk: int = 256
                  ) -> tuple[torch.Tensor, torch.Tensor]:
    """The model layout: q/k (B, T, NH, DK), or (B, T, 1, DK) broadcast over
    the heads, v (B, T, NH, DV), gates (B, T, NH) -> (y (B, T, NH, DV) in
    v's dtype, state f32 (B, NH, DK, DV))."""
    tensors = [t for t in (q, k, v, log_g, log_i) if t is not None]
    if not _lib.route(*tensors):
        return chunked_linear_attention_plain(q, k, v, log_g, log_i, chunk=chunk)
    chunk = min(chunk, q.shape[1])
    _check(q, k, v, log_g, log_i, chunk)
    if _lib.needs_grad(*tensors):
        if q.dtype != torch.bfloat16:
            raise _lib.no_backward("ssd_scan", f"{q.dtype} ({NO_BACKWARD_F32})")
        return _ScanFn.apply(q, k, v, _f32(log_g), _f32(log_i), chunk)
    return _forward(q, k, _streamable(v), log_g, log_i, chunk, v.shape[-1])[:2]


def ssd_scan(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, log_g: torch.Tensor,
             log_i: torch.Tensor | None = None,
             chunk: int = 256) -> tuple[torch.Tensor, torch.Tensor]:
    """The reference kernel's layout: q/k (B, NH, T, DK), v (B, NH, T, DV),
    gates (B, NH, T) -> (y (B, NH, T, DV), state f32 (B, NH, DK, DV))."""
    y, state = ssd_scan_bthd(q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
                             log_g.transpose(1, 2),
                             None if log_i is None else log_i.transpose(1, 2), chunk)
    return y.transpose(1, 2), state


reset(ssd_scan)
reset(ssd_scan_backward)
