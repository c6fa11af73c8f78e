"""The SSD scan's plain backward against the reference's gradient, and the
bound the card holds the backward kernel to.

* `chunked_linear_attention_backward_plain` (the kernel's regrouping,
  written out) against `jax.vjp` of the reference's
  `models.ssm.chunked_linear_attention` and against autograd of the port's
  `chunked_linear_attention_plain`, from the same numpy inputs: f32 to 1e-5
  of each gradient's scale; the plain backward from bf16 inputs to
  `GRAD_TOL` of the f32 result.  Cases: Mamba2's q and k broadcast over the
  heads, the mLSTM's per-head q and k with log_i and DV = DK + 1, a T that
  is not a multiple of the chunk, a nonzero final-state cotangent, and
  gates strong enough that the clips bind.
* The card's bound (`testing.parity.GRAD_TOL`) rejects three planted
  faults at the card check's shapes (zamba2-2.7b's Mamba2 scan, cut to
  one batch row and 8 of its 80 heads, and the mLSTM's state widths cut to
  one row): a zero state cotangent (dk and dv lose the carry), a broadcast
  gradient taken from head 0 alone, and dcum returned as dlog_g (no suffix
  sum); it accepts the sound plain backward run in bf16.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import ssm as ref_ssm
from repro_torch.kernels.ssd_scan import ops as ssd
from repro_torch.testing.parity import GRAD_TOL, grad_gap

NAMES = ("dq", "dk", "dv", "dlog_g", "dlog_i")


def _inputs(seed, B, T, NH, DK, DV, broadcast, with_i, final, gate_scale):
    """numpy f32 inputs: q, k (the same row for every head when
    `broadcast`), v, log_g = -gate_scale softplus(N(0, 1)), log_i uniform
    over the mLSTM's clip range [-30, 10] or None, dy, and the final
    state's cotangent (zeros unless `final`)."""
    rng = np.random.default_rng(seed)

    def normal(*shape, scale=1.0):
        return (rng.standard_normal(shape) * scale).astype(np.float32)

    if broadcast:
        q, k = (np.ascontiguousarray(np.broadcast_to(normal(B, T, 1, DK, scale=0.5),
                                                     (B, T, NH, DK))) for _ in range(2))
    else:
        q, k = normal(B, T, NH, DK, scale=0.5), normal(B, T, NH, DK, scale=0.5)
    v = normal(B, T, NH, DV, scale=0.5)
    log_g = (-gate_scale * np.log1p(np.exp(normal(B, T, NH)))).astype(np.float32)
    log_i = rng.uniform(-30.0, 10.0, (B, T, NH)).astype(np.float32) if with_i else None
    dy = normal(B, T, NH, DV)
    dstate = normal(B, NH, DK, DV) if final else np.zeros((B, NH, DK, DV), np.float32)
    return q, k, v, log_g, log_i, dy, dstate


def _reference_vjp(q, k, v, log_g, log_i, dy, dstate, chunk):
    """jax.vjp of the reference's scan at these inputs, in f32."""
    with_i = log_i is not None

    def f(q, k, v, g, *i):
        return ref_ssm.chunked_linear_attention(q, k, v, g, i[0] if with_i else None,
                                                chunk=chunk)

    args = [jnp.asarray(a) for a in (q, k, v, log_g)] + ([jnp.asarray(log_i)] if with_i else [])
    _, vjp = jax.vjp(f, *args)
    grads = vjp((jnp.asarray(dy), jnp.asarray(dstate)))
    return [torch.from_numpy(np.array(x)) for x in grads] + ([] if with_i else [None])


def _torch(*arrays, dtype=torch.float32):
    return [None if a is None else torch.from_numpy(a).to(dtype) for a in arrays]


CASES = {
    # (B, T, NH, DK, DV, chunk, broadcast, with_i, final, gate scale)
    "mamba2": (2, 64, 3, 16, 8, 16, True, False, False, 1.0),
    "mlstm": (2, 48, 2, 16, 17, 16, False, True, False, 1.0),
    "ragged_t": (1, 45, 2, 8, 12, 16, False, True, False, 1.0),
    "final_state": (2, 40, 2, 8, 9, 16, True, False, True, 1.0),
    # log_g down to ~ -30 a step: cum, total and the decay terms reach the
    # clip within a few steps, and log_i's range makes D's clip bind both ways
    "clip_binds": (1, 48, 2, 8, 9, 16, False, True, True, 12.0),
}


@pytest.mark.parametrize("case", list(CASES))
def test_plain_backward_matches_reference_vjp_and_autograd(case):
    B, T, NH, DK, DV, chunk, broadcast, with_i, final, gs = CASES[case]
    arrays = _inputs(7, B, T, NH, DK, DV, broadcast, with_i, final, gs)
    q, k, v, log_g, log_i, dy, dstate = _torch(*arrays)
    got = ssd.chunked_linear_attention_backward_plain(q, k, v, log_g, log_i, dy,
                                                      dstate if final else None, chunk)
    want = _reference_vjp(*arrays, chunk)
    leaves = [t.clone().requires_grad_() for t in (q, k, v, log_g)]
    leaves += [log_i.clone().requires_grad_()] if with_i else []
    y, S = ssd.chunked_linear_attention_plain(*leaves[:4], leaves[4] if with_i else None,
                                              chunk=chunk)
    auto = list(torch.autograd.grad((y, S), leaves, (dy, dstate))) + ([] if with_i else [None])
    for name, a, r, t in zip(NAMES, got, want, auto):
        if r is None:
            assert a is None and t is None, name
            continue
        assert a.dtype == torch.float32 and a.shape == r.shape, name
        assert grad_gap(a, r) <= 1e-5, (name, grad_gap(a, r))
        assert grad_gap(a, t) <= 1e-5, (name, grad_gap(a, t))
    if case == "clip_binds":  # the clips bind: some terms pass no gradient
        cum = torch.cumsum(log_g.reshape(B, -1, chunk, NH), 2)
        assert float(cum.min()) < -ssd.CLIP
    bf = ssd.chunked_linear_attention_backward_plain(
        *_torch(*arrays[:3], dtype=torch.bfloat16), log_g, log_i,
        torch.from_numpy(arrays[5]).to(torch.bfloat16), dstate if final else None, chunk)
    for name, a, r in zip(NAMES, bf, got):
        if r is not None:
            assert grad_gap(a, r) <= GRAD_TOL, (name, grad_gap(a, r))


def test_plain_backward_sums_the_broadcast_heads_in_the_model():
    """Mamba2 hands the scan one (B, T, DK) tensor expanded over the heads:
    autograd's expand backward sums the per-head dq and dk the plain
    backward (and the kernel) return, which is the reference's gradient of
    the unexpanded tensor."""
    B, T, NH, DK, DV, chunk = 2, 40, 3, 8, 8, 16
    q, k, v, log_g, _, dy, _ = _inputs(11, B, T, NH, DK, DV, True, False, False, 1.0)
    c, bm = torch.from_numpy(q[:, :, 0]).requires_grad_(), torch.from_numpy(k[:, :, 0]).requires_grad_()
    y, _ = ssd.chunked_linear_attention_plain(
        c[:, :, None].expand(B, T, NH, DK), bm[:, :, None].expand(B, T, NH, DK),
        torch.from_numpy(v), torch.from_numpy(log_g), chunk=chunk)
    y.backward(torch.from_numpy(dy))
    dq, dk = ssd.chunked_linear_attention_backward_plain(
        *_torch(q, k, v, log_g), None, torch.from_numpy(dy), None, chunk)[:2]
    assert grad_gap(dq.sum(2), c.grad) <= 1e-5 and grad_gap(dk.sum(2), bm.grad) <= 1e-5


def test_ssd_scan_backward_on_cpu_is_the_plain_one():
    """The wrapper runs the plain backward for CPU tensors, its gradients of
    q, k and v in their dtype; `ssd_scan_bthd` under grad on the CPU is
    autograd through the plain forward (no kernel counted)."""
    q, k, v, log_g, log_i, dy, dstate = _torch(*_inputs(3, 1, 40, 2, 8, 9, False, True, True,
                                                        1.0))
    before = ssd.ssd_scan_backward.launches
    got = ssd.ssd_scan_backward(q.bfloat16(), k.bfloat16(), v.bfloat16(), log_g, log_i,
                                dy.bfloat16(), dstate, chunk=16)
    want = ssd.chunked_linear_attention_backward_plain(q.bfloat16(), k.bfloat16(), v.bfloat16(),
                                                       log_g, log_i, dy.bfloat16(), dstate, 16)
    assert [t.dtype for t in got] == [torch.bfloat16] * 3 + [torch.float32] * 2
    for a, b in zip(got, want):
        torch.testing.assert_close(a.float(), b.to(a.dtype).float())
    qg = q.clone().requires_grad_()
    y, _ = ssd.ssd_scan_bthd(qg, k, v, log_g, log_i, chunk=16)
    y.backward(dy)
    assert qg.grad is not None and ssd.ssd_scan_backward.launches == before


# -------------------------------------------------- the card's bound, planted faults


def _faulty_backward(q, k, v, log_g, log_i, dy, dstate, chunk, fault):
    """The plain backward in f32 with one fault planted."""
    got = list(ssd.chunked_linear_attention_backward_plain(q, k, v, log_g, log_i, dy, dstate,
                                                           chunk))
    if fault == "no_carry":  # G = 0: dk and dv of each chunk on its own, no state cotangent
        for c0 in range(0, q.shape[1], chunk):
            sl = slice(c0, c0 + chunk)
            part = ssd.chunked_linear_attention_backward_plain(
                q[:, sl], k[:, sl], v[:, sl], log_g[:, sl],
                None if log_i is None else log_i[:, sl], dy[:, sl], None, chunk)
            got[1][:, sl], got[2][:, sl] = part[1], part[2]
    if fault == "head_0":  # every head's gradient taken from head 0
        got[0] = got[0][:, :, :1].expand_as(got[0])
        got[1] = got[1][:, :, :1].expand_as(got[1])
    if fault == "no_suffix_sum":
        got[3] = _dcum(got[3], chunk)
    return got


def _dcum(dlog_g, chunk):
    """dcum from dlog_g, each chunk's suffix sums undone (its last step keeps
    dtotal beside its own dcum)."""
    out = dlog_g.clone()
    for c0 in range(0, dlog_g.shape[1], chunk):
        d = dlog_g[:, c0:c0 + chunk]
        out[:, c0:c0 + d.shape[1] - 1] = d[:, :-1] - d[:, 1:]
    return out


def _as_the_model_sees(grads, broadcast):
    grads = list(grads)
    if broadcast:
        grads[0], grads[1] = grads[0].float().sum(2), grads[1].float().sum(2)
    return grads


@functools.lru_cache(maxsize=None)
def _card_shape(name):
    """The card check's inputs, drawn as chip_smoke.py draws them, at a cut
    of its shapes the CPU runs in seconds: zamba2-2.7b's train scan (4,
    1024, 80, 64), q/k broadcast, chunk 256, at one batch row and 8 heads;
    the mLSTM's (4, 1024, 4, 1024, 1025) with log_i over [-30, 10] at one
    row, one head and T 512, its state widths whole."""
    g = torch.Generator().manual_seed(0)
    bf16 = torch.bfloat16
    if name == "zamba2":
        B, T, NH, DK, DV, broadcast, with_i = 1, 1024, 8, 64, 64, True, False
    else:
        B, T, NH, DK, DV, broadcast, with_i = 1, 512, 1, 1024, 1025, False, True
    if broadcast:
        q, k = ((torch.randn(B, T, DK, generator=g) * 0.5).to(bf16)[:, :, None]
                .expand(B, T, NH, DK) for _ in range(2))
    else:
        q, k = ((torch.randn(B, T, NH, DK, generator=g) * 0.5).to(bf16) for _ in range(2))
    v = (torch.randn(B, T, NH, DV, generator=g) * 0.5).to(bf16)
    if with_i:
        v[..., -1] = 1.0
        log_g = torch.nn.functional.logsigmoid(torch.randn(B, T, NH, generator=g) + 4.0)
        log_i = torch.rand(B, T, NH, generator=g) * 40.0 - 30.0
    else:
        log_g = -0.05 * torch.nn.functional.softplus(torch.randn(B, T, NH, generator=g))
        log_i = None
    dy = torch.randn(B, T, NH, DV, generator=g).to(bf16)
    dstate = torch.randn(B, NH, DK, DV, generator=g)
    args = (q, k, v, log_g, log_i, dy, dstate)
    f32 = tuple(None if t is None else t.float() for t in args)
    want = ssd.chunked_linear_attention_backward_plain(*f32, chunk=256)
    return broadcast, args, f32, _as_the_model_sees(want, broadcast)


@pytest.mark.parametrize("name,fault", [("zamba2", "no_carry"), ("zamba2", "head_0"),
                                        ("zamba2", "no_suffix_sum"), ("mlstm", "no_carry"),
                                        ("mlstm", "no_suffix_sum")])
def test_card_bound_rejects_a_planted_scan_fault(name, fault):
    broadcast, _, f32, want = _card_shape(name)
    got = _as_the_model_sees(_faulty_backward(*f32, 256, fault), broadcast)
    gaps = [grad_gap(a, b) for a, b in zip(got, want) if b is not None]
    assert max(gaps) > 2 * GRAD_TOL, gaps


@pytest.mark.parametrize("name", ["zamba2", "mlstm"])
def test_card_bound_accepts_the_sound_scan_backward_in_bf16(name):
    """The plain backward from the bf16 inputs, its gradients of q, k and v
    rounded to bf16 as the kernel writes them."""
    broadcast, args, _, want = _card_shape(name)
    got = [t if t is None or i > 2 else t.to(torch.bfloat16)
           for i, t in enumerate(ssd.chunked_linear_attention_backward_plain(*args, chunk=256))]
    got = _as_the_model_sees(got, broadcast)
    gaps = [grad_gap(a, b) for a, b in zip(got, want) if b is not None]
    assert max(gaps) <= GRAD_TOL / 2, gaps
