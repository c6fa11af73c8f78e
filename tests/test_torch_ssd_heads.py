"""The SSD scan with q and k as one head broadcast over v's heads (Mamba2's
B and C), and the backward's launch plan.

* `chunked_linear_attention_plain` takes q and k as (B, T, 1, DK): y and
  the final state bit-equal to the expanded route, and autograd's
  gradients of the one-head q and k bit-equal to the expanded route's
  summed over the heads.
* `chunked_linear_attention_backward_plain` with one-head q and k returns
  their gradients summed over the heads at (B, T, 1, DK): against `jax.vjp`
  of the reference's `chunked_linear_attention` on the broadcast inputs
  (its per-head gradients summed), and against autograd of the plain
  forward, in f32 to 1e-5 of each gradient's scale; a one-head q beside a
  per-head k gets its own sum and k its per-head gradient.
* zamba2-2.7b (reduced) hands `Ops.linear_attention` one-head q and k.
* `ops.backward_plan` and `ops.heads_scratch_shapes`, the heads route's
  launch shape and scratch as the C entry checks them.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import ssm as ref_ssm
from repro_torch.configs import get_config
from repro_torch.kernels.ssd_scan import ops as ssd
from repro_torch.models import common
from repro_torch.models.model_zoo import build_model
from repro_torch.testing.parity import grad_gap

# (B, T, NH, DK, DV, chunk, with_i, final): Mamba2's shape cut down, a
# ragged T, log_i and a final-state cotangent
CASES = {
    "mamba2": (2, 64, 3, 16, 8, 16, False, False),
    "ragged_t_log_i": (1, 45, 4, 8, 12, 16, True, False),
    "final_state": (2, 40, 2, 8, 9, 16, False, True),
}


def _inputs(seed, B, T, NH, DK, DV, with_i, final):
    """numpy f32: one-head q and k (B, T, 1, DK), v, log_g = -softplus(N(0,
    1)), log_i over the mLSTM's clip range or None, dy, the final state's
    cotangent (zeros unless `final`)."""
    rng = np.random.default_rng(seed)

    def normal(*shape, scale=1.0):
        return (rng.standard_normal(shape) * scale).astype(np.float32)

    q, k = normal(B, T, 1, DK, scale=0.5), normal(B, T, 1, DK, scale=0.5)
    v = normal(B, T, NH, DV, scale=0.5)
    log_g = (-np.log1p(np.exp(normal(B, T, NH)))).astype(np.float32)
    log_i = rng.uniform(-30.0, 10.0, (B, T, NH)).astype(np.float32) if with_i else None
    dy = normal(B, T, NH, DV)
    dstate = normal(B, NH, DK, DV) if final else np.zeros((B, NH, DK, DV), np.float32)
    return q, k, v, log_g, log_i, dy, dstate


def _t(a):
    return None if a is None else torch.from_numpy(np.ascontiguousarray(a))


@pytest.mark.parametrize("case", list(CASES))
def test_one_head_forward_equals_the_expanded_route(case):
    B, T, NH, DK, DV, chunk, with_i, final = CASES[case]
    q, k, v, log_g, log_i, dy, dstate = (_t(a) for a in _inputs(1, B, T, NH, DK, DV, with_i, final))
    one = [t.clone().requires_grad_() for t in (q, k)]
    wide = [t.clone().requires_grad_() for t in (q, k)]
    y1, s1 = ssd.chunked_linear_attention_plain(*one, v, log_g, log_i, chunk=chunk)
    y2, s2 = ssd.chunked_linear_attention_plain(*(t.expand(B, T, NH, DK) for t in wide), v, log_g,
                                                log_i, chunk=chunk)
    assert torch.equal(y1, y2) and torch.equal(s1, s2)
    torch.autograd.backward((y1, s1), (dy, dstate))
    torch.autograd.backward((y2, s2), (dy, dstate))
    for a, b in zip(one, wide):
        assert a.grad.shape == (B, T, 1, DK)
        assert torch.equal(a.grad, b.grad)


def _reference_vjp(q, k, v, log_g, log_i, dy, dstate, chunk):
    """jax.vjp of the reference's scan at q and k broadcast over the heads,
    their gradients summed over the heads (the gradient of the one head)."""
    NH = v.shape[2]
    with_i = log_i is not None

    def f(q1, k1, v, g, *i):
        qb = jnp.broadcast_to(q1, q1.shape[:2] + (NH,) + q1.shape[3:])
        kb = jnp.broadcast_to(k1, k1.shape[:2] + (NH,) + k1.shape[3:])
        return ref_ssm.chunked_linear_attention(qb, kb, v, g, i[0] if with_i else None,
                                                chunk=chunk)

    args = [jnp.asarray(a) for a in (q, k, v, log_g)] + ([jnp.asarray(log_i)] if with_i else [])
    _, vjp = jax.vjp(f, *args)
    grads = vjp((jnp.asarray(dy), jnp.asarray(dstate)))
    return [torch.from_numpy(np.array(x)) for x in grads] + ([] if with_i else [None])


@pytest.mark.parametrize("case", list(CASES))
def test_plain_backward_sums_one_head_q_and_k_as_the_reference(case):
    B, T, NH, DK, DV, chunk, with_i, final = CASES[case]
    arrays = _inputs(2, B, T, NH, DK, DV, with_i, final)
    q, k, v, log_g, log_i, dy, dstate = (_t(a) for a in arrays)
    got = ssd.chunked_linear_attention_backward_plain(q, k, v, log_g, log_i, dy,
                                                      dstate if final else None, chunk)
    want = _reference_vjp(*arrays, chunk)
    leaves = [t.clone().requires_grad_() for t in (q, k, v, log_g)]
    leaves += [log_i.clone().requires_grad_()] if with_i else []
    y, S = ssd.chunked_linear_attention_plain(*leaves[:4], leaves[4] if with_i else None,
                                              chunk=chunk)
    auto = list(torch.autograd.grad((y, S), leaves, (dy, dstate))) + ([] if with_i else [None])
    assert got[0].shape == got[1].shape == (B, T, 1, DK)
    for name, a, r, t in zip(("dq", "dk", "dv", "dlog_g", "dlog_i"), got, want, auto):
        if r is None:
            assert a is None and t is None, name
            continue
        assert a.shape == r.shape == t.shape, name
        assert grad_gap(a, r) <= 1e-5, (name, grad_gap(a, r))
        assert grad_gap(a, t) <= 1e-5, (name, grad_gap(a, t))


def test_plain_backward_one_head_q_beside_a_per_head_k():
    """Each of q and k keeps its own form: a one-head q's gradient is the
    sum over heads of the per-head route's, a per-head k's is per head."""
    B, T, NH, DK, DV, chunk = 2, 40, 3, 8, 8, 16
    q, k1, v, log_g, _, dy, _ = (_t(a) for a in _inputs(3, B, T, NH, DK, DV, False, False))
    k = k1.expand(B, T, NH, DK) + 0.1 * torch.arange(NH, dtype=torch.float32)[:, None]
    got = ssd.chunked_linear_attention_backward_plain(q, k, v, log_g, None, dy, None, chunk)
    per_head = ssd.chunked_linear_attention_backward_plain(q.expand(B, T, NH, DK), k, v, log_g,
                                                           None, dy, None, chunk)
    assert got[0].shape == (B, T, 1, DK) and got[1].shape == (B, T, NH, DK)
    assert grad_gap(got[0], per_head[0].sum(2, keepdim=True)) <= 1e-6
    for a, b in zip(got[1:4], per_head[1:4]):
        assert torch.equal(a, b)


def test_zamba2_hands_the_scan_one_head_q_and_k():
    """Mamba2's B and C reach `Ops.linear_attention` as (B, T, 1, d_state)
    views (no expand), v at the block's heads; the forward equals the
    expanded route's."""
    cfg = get_config("zamba2-2.7b").reduced(dtype=torch.float32)
    model = build_model(cfg)
    params = model.init(torch.Generator().manual_seed(0))
    tokens = torch.from_numpy(np.random.default_rng(0).integers(0, cfg.vocab, (2, 12)))
    seen = []

    def recording(q, k, v, log_g, log_i=None, chunk=256):
        seen.append((tuple(q.shape), tuple(k.shape), tuple(v.shape)))
        return ssd.chunked_linear_attention_plain(q, k, v, log_g, log_i, chunk=chunk)

    def expanding(q, k, v, log_g, log_i=None, chunk=256):
        B, T, NH = v.shape[:3]
        return ssd.chunked_linear_attention_plain(q.expand(B, T, NH, q.shape[-1]),
                                                  k.expand(B, T, NH, k.shape[-1]), v, log_g,
                                                  log_i, chunk=chunk)

    ops = common.PLAIN.__class__(**{**common.PLAIN.__dict__, "linear_attention": recording})
    wide = common.PLAIN.__class__(**{**common.PLAIN.__dict__, "linear_attention": expanding})
    got = model.forward(params, {"tokens": tokens}, ops=ops)
    want = model.forward(params, {"tokens": tokens}, ops=wide)
    assert seen and len(seen) == cfg.ssm_pattern.count("m")
    for q, k, v in seen:
        assert q[2] == k[2] == 1 and q[:2] == v[:2] and v[2] > 1
    assert torch.equal(got, want)


# ------------------------------------------------------------ the launch plan

PLAN_SHAPES = [
    # (B, T, NH, NQ, DK, DV, chunk)
    (4, 1024, 80, 1, 64, 64, 256),    # zamba2-2.7b's train micro-batch
    (2, 1000, 80, 1, 64, 64, 256),    # ragged T
    (4, 512, 80, 1, 64, 64, 256),     # zamba2-2.7b's prefill
    (1, 64, 80, 1, 64, 64, 256),      # one short chunk
    (2, 256, 6, 6, 64, 64, 64),       # per-head q and k
    (1, 37, 2, 1, 16, 24, 256),       # chunk cut to T
    (3, 300, 7, 1, 64, 64, 128),
    (1, 4096, 1, 1, 64, 64, 256),     # one head
]


@pytest.mark.parametrize("shape", PLAN_SHAPES, ids=str)
def test_backward_plan_is_what_the_heads_entry_takes(shape):
    """The C entry's checks: every head in exactly one group ((groups - 1)
    x heads_a_group < NH <= groups x heads_a_group), groups a multiple of
    the q/k heads, a group of one head where q and k are per head; and
    about HEAD_BLOCKS (key block, group, chunk, batch) blocks."""
    B, T, NH, NQ, DK, DV, chunk = shape
    route, groups, hg = ssd.backward_plan(*shape)
    assert route == "heads"
    assert (groups - 1) * hg < NH <= groups * hg
    assert groups % NQ == 0
    if NQ == NH > 1:
        assert (groups, hg) == (NH, 1)
    chunk = min(chunk, T)
    blocks = B * -(-T // chunk) * -(-chunk // ssd.TILE) * groups
    assert blocks >= min(ssd.HEAD_BLOCKS, B * -(-T // chunk) * -(-chunk // ssd.TILE) * NH) // 2


def test_backward_plan_takes_the_pairs_route_past_the_heads_route():
    assert ssd.backward_plan(4, 1024, 4, 4, 1024, 1025, 256) == ("pairs", 0, 0)  # the mLSTM
    assert ssd.backward_plan(4, 1024, 80, 1, 64, 65, 256)[0] == "pairs"  # a state past 64
    assert ssd.backward_plan(1, 600, 3, 1, 64, 64, 512)[0] == "pairs"  # a chunk past 256
    assert ssd.backward_plan(1, 200, 3, 1, 64, 64, 512)[0] == "heads"  # chunk cut to T
    assert ssd.backward_plan(4, 1024, 80, 1, 64, 64, 256) == ("heads", 4, 20)


def test_heads_scratch_shapes():
    """The scratch `ssd_backward_heads` writes: the group shares of dq by
    pair and of dk by key block, each pair's step sums from its four warps,
    the complete key, inter and state gate sums, one decay value a chunk;
    beside it the forward's cum, li and entering states (`SAVED`), as the
    forward kernel leaves them at the same shapes."""
    B, T, NH, chunk, groups = 2, 1000, 80, 256, 8
    shapes = ssd.heads_scratch_shapes(B, T, NH, chunk, groups)
    forward = ssd.scratch_shapes(B, T, NH, 64, 64, chunk, torch.bfloat16)
    assert not set(shapes) & set(ssd.SAVED)
    assert tuple(n for n in ssd.HEADS_SCRATCH if n not in shapes) == ssd.SAVED
    assert set(shapes) | set(ssd.SAVED) == set(ssd.HEADS_SCRATCH)
    f32 = torch.float32
    assert shapes["dqp"] == ((B, 4, groups, 10, 64, 64), f32)
    assert shapes["dkp"] == ((B, 4, groups, 4, 64, 64), f32)
    assert shapes["rpart"] == ((B, NH, 4, 10, 4, 64), f32)
    assert shapes["dpart"] == ((B, NH, 4), f32)
    assert shapes["gstate"] == forward["entering"] == ((B, NH, 4, 1, 2, 64, 64), torch.bfloat16)
    assert forward["cum"] == forward["li"] == ((B, NH, T), f32)
    assert all(shapes[n] == ((B, NH, T), f32) for n in ("cpart", "ipart", "hpart"))
