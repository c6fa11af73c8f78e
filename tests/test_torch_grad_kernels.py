"""The backward kernels' plain versions against the reference's math, and
the bound the card holds the kernels to.

* `rmsnorm_backward_plain` against `jax.vjp` of the reference's
  `models.common.rms_norm` and against autograd of the port's own plain
  forward (f32 to 1e-5 of scale; bf16 to 2e-2, the card check's bound:
  the reference rounds dy * w to bf16 where the port keeps it f32).
* `flash_attention_backward_plain` and `flash_attention_lse_plain`, from
  the lse and Delta as the kernel computes them, against `jax.vjp` of the
  reference's `chunked_attention` (causal Sq == Sk at G 1, 2 and 6;
  non-causal Sq == Sk at G 1 and 2; non-causal and causal (top-left) Sq <
  Sk and Sq > Sk, ragged; v narrower than q and k, MLA's 192 / 128 among
  them) and against autograd of the port's plain forward: f32 to 1e-5 of
  each gradient's scale; bf16 to the card's bound.
* `backward_plan` at every walk: each (batch, head, key tile) in one dK/dV
  block, the query tiles it walks (a causal key tile at or past Sq walks
  none), the dQ items, and the cluster chosen by the makespan of the walk
  launched; past 8 query heads a KV head (G 16, 9, 11) a cluster of at
  most 8 blocks, each walking G / C heads.  `grad_v_width`: the width v
  reaches the backward kernel at.
* The card's bound (`testing.parity.GRAD_TOL`: each gradient within 2e-2
  of the f32 plain backward's max |value|) rejects planted faults — a flash
  backward that drops its Delta term, one that skips the sum over a KV
  head's query heads in dK/dV, a non-causal one whose dK/dV walk only the
  causal half, a dQ that leaves the key tile's rows past Sk unmasked, an
  rmsnorm backward that sums dw in bf16, and at MLA's widths a dK whose
  columns past v's width stay zero and a dv taken from the wrong rows of a
  padded v — at the card check's shapes, and accepts the sound plain
  backward run in bf16.
* Under grad on the CPU every op of `KERNELS` returns a tensor that carries
  a `grad_fn` (the plain versions, differentiated by autograd); the
  training route's shape rule accepts non-causal attention, Sq != Sk,
  head_dim 192 with v at its own width and any number of query heads a KV
  head, and refuses f32 (naming the ROADMAP item) and widths the bf16
  kernels cannot load.  `attention_bthd` under grad at MLA's widths hands
  `_FlashFn` v as it is (never padded) and gives dv at v's width.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from repro.models import common as ref_common
from repro_torch.kernels import _lib
from repro_torch.kernels.flash_attention import ops as fa
from repro_torch.kernels.rmsnorm import ops as rn
from repro_torch.models import common
from repro_torch.testing.parity import GRAD_TOL, flash_grads_f32, grad_gap

DTYPES = {"f32": (jnp.float32, torch.float32), "bf16": (jnp.bfloat16, torch.bfloat16)}


def _normal(seed, shape, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape) * scale).astype(np.float32)


def _both(a: np.ndarray, dtype: str):
    jdt, tdt = DTYPES[dtype]
    j = jnp.asarray(a, jdt)
    return j, torch.from_numpy(np.array(j.astype(jnp.float32))).to(tdt)


def _t(x) -> torch.Tensor:
    return torch.from_numpy(np.array(jnp.asarray(x).astype(jnp.float32)))


def _bound(dtype: str) -> float:
    return 1e-5 if dtype == "f32" else GRAD_TOL


# ------------------------------------------------------------------ rmsnorm


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("N,D", [(24, 128), (7, 1536), (3, 40)])
def test_rmsnorm_backward_plain_matches_reference_vjp(dtype, N, D):
    jx, x = _both(_normal(0, (N, D), 3.0), dtype)
    jw, w = _both(_normal(1, (D,)), dtype)
    jdy, dy = _both(_normal(2, (N, D)), dtype)
    _, vjp = jax.vjp(lambda a, b: ref_common.rms_norm(a, b, 1e-5), jx, jw)
    want_dx, want_dw = vjp(jdy)
    dx, dw = rn.rmsnorm_backward_plain(x, w, dy)
    assert dx.dtype == x.dtype and dw.dtype == w.dtype
    assert grad_gap(dx, _t(want_dx)) <= _bound(dtype)
    assert grad_gap(dw, _t(want_dw)) <= _bound(dtype)
    xa, wa = x.clone().requires_grad_(), w.clone().requires_grad_()
    auto = torch.autograd.grad(rn.rmsnorm_plain(xa, wa), (xa, wa), dy)
    for got, want in zip((dx, dw), auto):
        assert grad_gap(got, want) <= _bound(dtype)


def test_rmsnorm_backward_on_cpu_is_the_plain_one():
    x, w, dy = (torch.from_numpy(_normal(i, s)) for i, s in ((3, (5, 64)), (4, (64,)),
                                                             (5, (5, 64))))
    for got, want in zip(rn.rmsnorm_backward(x, w, dy), rn.rmsnorm_backward_plain(x, w, dy)):
        assert torch.equal(got, want)


def test_rmsnorm_backward_plan():
    """A warp a row up to 256 vectors (qwen2-1.5b's 1536 in bf16: 6 a lane),
    fewer lanes for narrow rows, W warps past it; a persistent grid of at
    most the blocks the card holds at once, one partial row a block; each
    block walks a contiguous band, every row once."""
    P = rn.BackwardPlan
    assert rn.backward_plan(4096, 1536, 2, 132, 1) == P(32, 6, 256, 132)  # qwen2-1.5b
    assert rn.backward_plan(4096, 1536, 2, 132, 2) == P(32, 6, 256, 264)
    assert rn.backward_plan(512, 512, 2, 132, 2) == P(32, 2, 256, 64)     # train_small: a row a warp
    assert rn.backward_plan(8192, 1536, 4, 132, 1) == P(64, 6, 256, 132)  # f32: two warps a row
    assert rn.backward_plan(1024, 2560, 2, 132, 1) == P(64, 5, 256, 132)  # the serve's width
    assert rn.backward_plan(5, 5120, 2, 132, 1) == P(96, 7, 192, 3)
    assert rn.backward_plan(1024, 128, 2, 132, 3) == P(16, 1, 256, 64)    # 16 lanes: 16 rows a block
    assert rn.backward_plan(1, 8, 4, 132, 8) == P(2, 1, 256, 1)           # 2 lanes
    for N, D in ((4096, 1536), (4097, 1536), (5, 1536), (1, 512), (1000, 264)):
        plan = rn.backward_plan(N, D, 2, 132, 2)
        assert plan.partial_rows == plan.grid <= 264
        assert [r for band in plan.bands(N) for r in band] == list(range(N))
    assert rn.backward_shape(16384, 2)[:2] == (256, 8)
    with pytest.raises(ValueError, match="at most 16384"):
        rn.backward_shape(16392, 2)
    # element-wise loads (D no multiple of the vector, or an unaligned view):
    # at most 4 vectors a lane
    assert rn.backward_shape(2000, 2, vec=False) == (64, 4, 256)
    assert rn.backward_shape(1000, 2, vec=False) == (32, 4, 256)
    assert rn.backward_plan(300, 1536, 2, 132, 1, vec=False) == P(64, 3, 256, 75)
    assert rn.backward_shape(8192, 2, vec=False)[:2] == (256, 4)
    with pytest.raises(ValueError, match="8192 elements element-wise"):
        rn.backward_shape(8200, 2, vec=False)


# ---------------------------------------------------------- flash attention


def _check_plan(B, H, KH, Sq, Sk, D, n_sm, causal):
    """`backward_plan`'s blocks and items at these shapes, with and without
    a card's cluster occupancy: every (batch, head, 64-key tile) in one
    dK/dV block, which walks the query tiles its keys meet (all of Sq, or
    under the causal mask those from its first key on), the blocks in
    order of those steps, most first, each aligned run of `cluster` blocks
    the heads of one KV head; every (batch, head, 128-row query block) one
    dQ item, walking all K/V tiles or those up to its last row, in order of
    its K/V tiles, most first.  Returns the plan."""
    G = H // KH
    for clusters in (None, tuple((c, n_sm // (2 * c) + 1) for c in range(1, G + 1)
                                 if G % c == 0)):
        plan = fa.backward_plan(B, H, KH, Sq, Sk, D, n_sm, clusters, causal)
        assert plan.group == G and plan.heads * plan.cluster == G
        assert plan.scratch_rows % 64 == 0 and Sq <= plan.scratch_rows < Sq + 64
        blocks = plan.dkdv_blocks()
        n_kb = -(-Sk // 64)
        assert plan.dkdv_grid == (H // plan.heads, B, n_kb) and len(blocks) == math.prod(
            plan.dkdv_grid)
        covered = [(b, h, kb) for b, heads, kb, _ in blocks for h in heads]
        assert sorted(covered) == [(b, h, kb) for b in range(B) for h in range(H)
                                   for kb in range(n_kb)]
        for _, heads, kb, steps in blocks:
            walked = range(kb * 64, Sq, 64) if causal else range(0, Sq, 64)
            assert steps == len(heads) * len(walked)
        assert all(x[3] >= y[3] for x, y in zip(blocks, blocks[1:]))
        for i in range(0, len(blocks), plan.cluster):  # x fastest: a run is one cluster
            run = blocks[i:i + plan.cluster]
            assert len({(b, kb) for b, _, kb, _ in run}) == 1
            assert sorted(h for _, heads, _, _ in run for h in heads) == list(
                range(run[0][1][0] // G * G, run[0][1][0] // G * G + G))
    items = plan.dq_order()
    n_qb = -(-Sq // 128)
    assert len(items) == plan.dq_items == B * H * n_qb
    assert {(b, h, q0) for b, h, q0, _ in items} == {
        (b, h, 128 * i) for b in range(B) for h in range(H) for i in range(n_qb)}
    for b, h, q0, tiles in items:
        last = min(q0 + 128, Sq)  # K/V tiles up to its last row, under the mask
        assert tiles == (min(-(-last // 64), -(-Sk // 64)) if causal else -(-Sk // 64))
    assert all(x[3] >= y[3] for x, y in zip(items, items[1:]))
    assert plan.dq_grid == min(n_sm, len(items))
    return plan


@pytest.mark.parametrize("B,H,KH,S,D,n_sm", [(4, 12, 2, 1024, 128, 132),  # qwen2-1.5b train
                                             (2, 8, 8, 1024, 128, 132),   # G = 1
                                             (4, 8, 2, 128, 64, 132),     # train_small
                                             (2, 16, 2, 1000, 80, 132),   # G = 8, ragged S
                                             (1, 7, 1, 70, 40, 16),       # G = 7, few SMs
                                             (3, 5, 1, 1, 32, 132)])      # one token
def test_flash_backward_plan_covers_each_block_once_longest_first(B, H, KH, S, D, n_sm):
    """Causal, Sq == Sk: each key tile walks the causal half from its first
    key (`_check_plan`)."""
    _check_plan(B, H, KH, S, S, D, n_sm, True)


@pytest.mark.parametrize("B,H,KH,Sq,Sk,D,n_sm,causal", [
    (4, 16, 16, 1024, 1024, 64, 132, False),  # seamless-m4t-large-v2's encoder
    (4, 16, 16, 256, 1024, 64, 132, False),   # its cross-attention
    (2, 8, 2, 33, 1000, 64, 132, False),      # ragged both ways
    (1, 6, 3, 1000, 70, 40, 16, False),       # Sq > Sk, few SMs
    (2, 16, 4, 300, 1000, 128, 132, True),    # causal Sq < Sk: key tiles past Sq walk nothing
    (2, 16, 4, 1000, 300, 64, 132, True),     # causal Sq > Sk
    (3, 6, 1, 1, 70, 32, 132, False)])        # one query over every key
def test_flash_backward_plan_covers_the_walks_of_any_lengths(B, H, KH, Sq, Sk, D, n_sm,
                                                             causal):
    plan = _check_plan(B, H, KH, Sq, Sk, D, n_sm, causal)
    idle = [kb for _, _, kb, steps in plan.dkdv_blocks() if steps == 0]
    assert sorted(set(idle)) == (list(range(-(-Sq // 64), -(-Sk // 64))) if causal else [])


@pytest.mark.parametrize("B,H,KH,S,clusters,heads", [
    (4, 12, 2, 1024, None, 1),                                # every SM usable: clusters of G
    (4, 12, 2, 1024, ((1, 132), (2, 66), (3, 42), (6, 17)), 3),  # 17 x 6 fill 102 SMs
    (1, 8, 1, 1024, ((1, 132), (2, 66), (4, 30), (8, 16)), 1),   # longer blocks would lose
    (2, 8, 8, 512, ((1, 132),), 1)])                          # G = 1
def test_flash_backward_plan_picks_the_cluster_by_its_makespan(B, H, KH, S, clusters, heads):
    """The cluster is the divisor C of G whose launch is estimated to end
    first: all steps over the SMs that clusters of C fill, or the longest
    block's steps, whichever is more; the larger C on a tie."""
    assert fa.backward_plan(B, H, KH, S, S, 128, 132, clusters).heads == heads


@pytest.mark.parametrize("Sq,Sk,causal,heads", [
    (1024, 1024, True, 1),    # 2176 steps: clusters of 2 end at 21.8, two heads a block at 32
    (1024, 1024, False, 2),   # 4096 steps: clusters of 2 at 41.0, two heads a block at 32
    (256, 1024, False, 2),    # 1024 steps, 4 a block: 10.2 against 8
    (1024, 256, True, 1)])    # 928 steps, 16 a block: the longest block decides, 16 against 32
def test_flash_backward_plan_counts_the_walk_launched(Sq, Sk, causal, heads):
    """The makespan counts the (head, query tile) steps the launch really
    walks, Sq x Sk tile pairs without the mask and the clipped triangle
    with it: at 16 query heads over 8 KV heads, clusters of 2 filling 100
    SMs against single blocks filling 132, the causal and the non-causal
    walk of one shape pick differently."""
    clusters = ((1, 132), (2, 50))
    assert fa.backward_plan(1, 16, 8, Sq, Sk, 128, 132, clusters, causal).heads == heads


@pytest.mark.parametrize("H,KH,D,on_route", [(18, 2, 128, True), (9, 1, 64, True),
                                             (12, 2, 136, True), (12, 2, 20, False)],
                         ids=["18-2-128", "9-1-64", "12-2-136", "12-2-20"])
def test_flash_backward_plan_raises_off_the_route(H, KH, D, on_route):
    """Off the head dims the kernel takes (not a multiple of 8), there is
    no plan; past eight query heads a KV head (G 9) and past head_dim 128
    (136 runs the 192 instance) there is one, its clusters of at most 8."""
    if not on_route:
        with pytest.raises(ValueError):
            fa.backward_plan(2, H, KH, 256, 256, D, 132)
        return
    plan = _check_plan(2, H, KH, 256, 256, D, 132, True)
    assert plan.cluster <= fa.MAX_CLUSTER and plan.heads * plan.cluster == H // KH


@pytest.mark.parametrize("G,clusters,heads", [
    (16, None, 4),                                           # 8704 steps over 4 x 33 SMs
    (16, ((1, 132), (2, 66), (4, 33), (8, 16)), 4),
    (16, ((1, 132), (2, 66), (4, 30), (8, 16)), 2),          # clusters of 4 fill 120 SMs
    (9, ((1, 132), (3, 44)), 3),
    (11, ((1, 132),), 11),                                   # prime past 8: one block, 11 heads
    (11, None, 11)])
def test_flash_backward_plan_past_eight_heads_a_kv_head(G, clusters, heads):
    """G 16, 9 and 11 over 2 KV heads, causal (2, 1024): the cluster is
    the divisor C <= 8 of G with the shortest estimated makespan (a
    cluster of 16 or 9 or 11 blocks is past the portable size); each
    (batch, head, key tile) in one dK/dV block, which walks G / C heads,
    the longest blocks first."""
    plan = fa.backward_plan(2, 2 * G, 2, 1024, 1024, 128, 132, clusters)
    assert plan.heads == heads and plan.cluster == G // heads <= fa.MAX_CLUSTER
    _check_plan(2, 2 * G, 2, 1024, 1024, 128, 132, True)
    blocks = plan.dkdv_blocks()
    assert all(len(h) == heads for _, h, _, _ in blocks)
    assert blocks[0][3] == heads * 16 == max(b[3] for b in blocks)


def test_grad_v_width_is_an_instance_of_the_source():
    """v reaches the backward at its own width where an instance takes the
    pair (v rounded to 16 as q is, or 128 beside q past 128), else padded
    to the nearest one: MLA's 128 beside 192 as it is, a 64 beside 192 to
    128, a 32 beside 48 to 48."""
    assert fa.grad_v_width(192, 128) == 128 and fa.grad_v_width(192, 192) == 192
    assert fa.grad_v_width(192, 120) == 120 and fa.grad_v_width(192, 136) == 136
    assert fa.grad_v_width(192, 64) == 128 and fa.grad_v_width(136, 96) == 128
    assert fa.grad_v_width(48, 32) == 48 and fa.grad_v_width(48, 40) == 40
    assert fa.grad_v_width(80, 72) == 72 and fa.grad_v_width(80, 64) == 80


def _attn_inputs(dtype, B, H, KH, S, D, seed=0, Sk=None, Dv=None):
    """q (B, H, S, D), k (B, KH, Sk, D), v (B, KH, Sk, Dv) (Sk defaults
    to S, Dv to D), dout (B, H, S, Dv), in both packages."""
    Sk = S if Sk is None else Sk
    Dv = D if Dv is None else Dv
    shapes = ((B, H, S, D), (B, KH, Sk, D), (B, KH, Sk, Dv), (B, H, S, Dv))
    pairs = [_both(_normal(seed + i, s), dtype) for i, s in enumerate(shapes)]
    return [p[0] for p in pairs], [p[1] for p in pairs]


def _plain_narrow(q, k, v, causal):
    """The port's plain forward at v of its own width (padded to q's with
    zero columns, the output sliced back)."""
    Dv = v.shape[-1]
    return fa.flash_attention_plain(q, k, F.pad(v, (0, q.shape[-1] - Dv)), causal)[..., :Dv]


def _check_plain_backward(dtype, B, H, KH, Sq, Sk, D, causal, Dv=None):
    """The plain backward from the plain lse against `jax.vjp` of the
    reference's `chunked_attention` (chunks of 16, so ragged lengths pad)
    and against autograd of the port's plain forward; v Dv wide."""
    (jq, jk, jv, jdo), (q, k, v, dout) = _attn_inputs(dtype, B, H, KH, Sq, D, Sk=Sk, Dv=Dv)
    tr = lambda x: jnp.swapaxes(x, 1, 2)  # noqa: E731
    f = lambda a, b, c: tr(ref_common.chunked_attention(  # noqa: E731
        tr(a), tr(b), tr(c), causal=causal, q_chunk=16, k_chunk=16))
    _, vjp = jax.vjp(f, jq, jk, jv)
    want = vjp(jdo)
    o = _plain_narrow(q, k, v, causal)
    lse = fa.flash_attention_lse_plain(q, k, causal=causal)
    got = fa.flash_attention_backward_plain(q, k, v, o, dout, lse, causal=causal)
    for name, g, w in zip("qkv", got, want):
        assert g.dtype == q.dtype and g.shape == tuple(w.shape), name
        assert grad_gap(g, _t(w)) <= _bound(dtype), name
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    auto = torch.autograd.grad(_plain_narrow(*leaves, causal), leaves, dout)
    for name, g, w in zip("qkv", got, auto):
        assert grad_gap(g, w) <= _bound(dtype), name


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("B,H,KH,S,D", [(2, 4, 4, 40, 32),    # G = 1
                                        (1, 4, 2, 64, 64),    # G = 2
                                        (2, 6, 1, 33, 16)])   # G = 6, ragged S
def test_flash_backward_plain_matches_reference_vjp(dtype, B, H, KH, S, D):
    _check_plain_backward(dtype, B, H, KH, S, S, D, True)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("B,H,KH,Sq,Sk,D,causal", [
    (2, 4, 4, 40, 40, 32, False),   # non-causal, G = 1
    (1, 4, 2, 64, 64, 64, False),   # non-causal, G = 2
    (2, 4, 2, 33, 100, 16, False),  # non-causal Sq < Sk, ragged (the cross-attention's form)
    (1, 6, 2, 90, 37, 32, False),   # non-causal Sq > Sk, ragged
    (2, 4, 2, 33, 100, 16, True),   # causal Sq < Sk, top-left: keys past Sq see no query
    (1, 6, 2, 90, 37, 32, True)])   # causal Sq > Sk, top-left: rows past Sk see every key
def test_flash_backward_plain_matches_reference_vjp_at_any_lengths(dtype, B, H, KH, Sq, Sk, D,
                                                                   causal):
    _check_plain_backward(dtype, B, H, KH, Sq, Sk, D, causal)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("B,H,KH,S,D,Dv,causal", [
    (1, 4, 2, 40, 48, 32, True),      # v narrower than q and k, G = 2
    (2, 4, 4, 33, 48, 32, False),     # non-causal, ragged
    (1, 4, 4, 40, 192, 128, True),    # MLA's widths: q and k 128 + 64, v 128
    (1, 4, 4, 40, 192, 128, False)])
def test_flash_backward_plain_matches_reference_vjp_at_a_narrow_v(dtype, B, H, KH, S, D, Dv,
                                                                 causal):
    """v, o, dout and dv Dv wide beside q and k of D, as MLA's attention
    takes them: dv at v's width, dq and dk at D."""
    _check_plain_backward(dtype, B, H, KH, S, S, D, causal, Dv=Dv)


def test_flash_lse_plain_is_the_logsumexp_of_the_masked_scores():
    _, (q, k, _, _) = _attn_inputs("f32", 1, 4, 2, 20, 16)
    lse = fa.flash_attention_lse_plain(q, k)
    s = torch.einsum("bhqd,bhkd->bhqk", q, k.repeat_interleave(2, dim=1)) * 16 ** -0.5
    s = s.masked_fill(~torch.ones(20, 20, dtype=torch.bool).tril(), float("-inf"))
    torch.testing.assert_close(lse, torch.logsumexp(s, dim=-1))


@pytest.mark.parametrize("Sq,Sk,causal", [(13, 40, False), (40, 13, False), (13, 40, True),
                                          (40, 13, True)])
def test_flash_lse_plain_at_any_lengths(Sq, Sk, causal):
    """Sq rows of lse, each over all Sk keys or, causal, top-left: row i
    keeps keys 0..i, every row at least one."""
    _, (q, k, _, _) = _attn_inputs("f32", 1, 4, 2, Sq, 16, Sk=Sk)
    lse = fa.flash_attention_lse_plain(q, k, causal=causal)
    s = torch.einsum("bhqd,bhkd->bhqk", q, k.repeat_interleave(2, dim=1)) * 16 ** -0.5
    if causal:
        s = s.masked_fill(~torch.ones(Sq, Sk, dtype=torch.bool).tril(), float("-inf"))
    assert lse.shape == (1, 4, Sq) and torch.isfinite(lse).all()
    torch.testing.assert_close(lse, torch.logsumexp(s, dim=-1))


# -------------------------------------------------- the card's bound, planted faults


def _flash_fault(q, k, v, dout, fault: str, causal: bool = True, tail=None):
    """The plain backward in f32 with one fault planted ("none": the sound
    one).  "no_delta" drops Delta; "no_group_sum" skips dK/dV's sum over a
    KV head's query heads; "causal_half" (non-causal) sums each 64-key
    tile's dK and dV over the query tiles from the tile's first key on only
    (the causal walk); "tail" (non-causal) runs dQ over the whole last
    64-key tile, its rows past Sk unmasked and holding `tail` ((k rows, v
    rows): what a load not clipped at Sk would read from a longer buffer,
    or TMA's zeros), while dK and dV are stored for keys below Sk only, so
    only dQ sees them."""
    B, H, Sq, D = q.shape
    KH, Sk = k.shape[1], k.shape[2]
    G = H // KH
    scale = D ** -0.5
    qf, kf, vf = q.float(), k.float(), v.float()
    o = fa.flash_attention_plain(qf, kf, vf, causal).reshape(B, KH, G, Sq, D)
    lse = fa.flash_attention_lse_plain(qf, kf, causal=causal).reshape(B, KH, G, Sq, 1)
    qf, dof = qf.reshape(B, KH, G, Sq, D), dout.float().reshape(B, KH, G, Sq, D)
    delta = 0.0 if fault == "no_delta" else (dof * o).sum(-1, keepdim=True)
    if fault == "tail":
        kf, vf = torch.cat([kf, tail[0]], dim=2), torch.cat([vf, tail[1]], dim=2)
    s = torch.einsum("bkgqd,bksd->bkgqs", qf, kf) * scale
    p = torch.exp(s - lse)
    if causal:
        p = torch.where(torch.ones(Sq, Sk, dtype=torch.bool).tril(), p, torch.zeros_like(p))
    ds = p * (torch.einsum("bkgqd,bksd->bkgqs", dof, vf) - delta)
    dq = (torch.einsum("bkgqs,bksd->bkgqd", ds, kf) * scale).reshape(B, H, Sq, D)
    if fault == "causal_half":
        walked = (torch.arange(Sq) // 64)[:, None] >= (torch.arange(Sk) // 64)[None, :]
        p, ds = p * walked, ds * walked
    dk_h = torch.einsum("bkgqs,bkgqd->bkgsd", ds, qf)[:, :, :, :Sk] * scale
    dv_h = torch.einsum("bkgqs,bkgqd->bkgsd", p, dof)[:, :, :, :Sk]
    if fault == "no_group_sum":
        return dq, dk_h[:, :, 0], dv_h[:, :, 0]
    return dq, dk_h.sum(2), dv_h.sum(2)


@pytest.fixture(scope="module")
def train_attn():
    """The card check's flash backward shape at B = 1: (1, 1024, 12/2, 128),
    bf16 inputs drawn as chip_smoke.py draws them."""
    g = torch.Generator().manual_seed(0)
    q, dout = (torch.randn(1, 12, 1024, 128, generator=g).to(torch.bfloat16) for _ in range(2))
    k, v = (torch.randn(1, 2, 1024, 128, generator=g).to(torch.bfloat16) for _ in range(2))
    return q, k, v, dout, flash_grads_f32(q, k, v, dout)


@pytest.mark.parametrize("fault", ["no_delta", "no_group_sum"])
def test_card_bound_rejects_a_planted_flash_fault(train_attn, fault):
    q, k, v, dout, want = train_attn
    got = _flash_fault(q, k, v, dout, fault)
    gaps = [grad_gap(a, b) for a, b in zip(got, want)]
    assert max(gaps) > 2 * GRAD_TOL, gaps


def test_card_bound_accepts_the_sound_flash_backward_in_bf16(train_attn):
    """The plain backward from bf16 inputs, with the bf16 forward's output,
    P and dS rounded to bf16 and bf16 gradients, as the kernel runs."""
    q, k, v, dout, want = train_attn
    got = fa.flash_attention_backward_plain(q, k, v, fa.flash_attention_plain(q, k, v), dout,
                                            fa.flash_attention_lse_plain(q, k))
    gaps = [grad_gap(a, b) for a, b in zip(got, want)]
    assert max(gaps) <= GRAD_TOL / 2, gaps
    sound = _flash_fault(q, k, v, dout, "none")
    assert max(grad_gap(a, b) for a, b in zip(sound, want)) <= 1e-5


def _bf16_randn(g, *shape, shift=0.0):
    return (torch.randn(*shape, generator=g) + shift).to(torch.bfloat16)


@pytest.mark.parametrize("fault", ["dk_rope_zero", "dv_wrong_rows"])
def test_card_bound_rejects_a_planted_fault_at_mla_widths(fault):
    """deepseek-v3's MLA at B = 1, 256 tokens, 16 of its heads: q and k
    (1, 16, 256, 192), v 128 wide, causal.  A backward that leaves dK's
    64 columns past v's width at zero ("dk_rope_zero": the third panel's
    shared accumulator never stored), or that takes dv from a padded v's
    rows shifted by one key ("dv_wrong_rows": the (192, 192) layout read
    at the (192, 128) one's row stride) misses the bound; the sound plain
    backward in bf16 at the same inputs lies within half of it."""
    g = torch.Generator().manual_seed(3)
    q, k = (_bf16_randn(g, 1, 16, 256, 192) for _ in range(2))
    v, dout = _bf16_randn(g, 1, 16, 256, 128), _bf16_randn(g, 1, 16, 256, 128)
    want = flash_grads_f32(q, k, v, dout)
    o = _plain_narrow(q, k, v, True)
    sound = fa.flash_attention_backward_plain(q, k, v, o, dout,
                                              fa.flash_attention_lse_plain(q, k))
    assert max(grad_gap(a, b) for a, b in zip(sound, want)) <= GRAD_TOL / 2
    dq, dk, dv = (t.clone() for t in sound)
    if fault == "dk_rope_zero":
        dk[..., 128:] = 0
    else:
        dv = torch.roll(dv, 1, dims=2)
    gaps = [grad_gap(a, b) for a, b in zip((dq, dk, dv), want)]
    assert max(gaps) > 2 * GRAD_TOL, gaps


def test_card_bound_rejects_a_noncausal_backward_that_walks_the_causal_half():
    """seamless-m4t-large-v2's encoder at B = 1, (1, 1024, 16/16, 64),
    non-causal: dK and dV of each key tile from the query tiles at or past
    it only (the causal walk) miss the bound; the sound walk lies within
    1e-5 of the f32 plain backward."""
    g = torch.Generator().manual_seed(1)
    q, k, v, dout = (_bf16_randn(g, 1, 16, 1024, 64) for _ in range(4))
    want = flash_grads_f32(q, k, v, dout, causal=False)
    got = _flash_fault(q, k, v, dout, "causal_half", causal=False)
    gaps = [grad_gap(a, b) for a, b in zip(got, want)]
    assert not all(x <= 2 * GRAD_TOL for x in gaps), gaps
    sound = _flash_fault(q, k, v, dout, "none", causal=False)
    assert max(grad_gap(a, b) for a, b in zip(sound, want)) <= 1e-5


@pytest.mark.parametrize("rows", ["buffer", "zero"])
def test_card_bound_rejects_a_dq_with_the_keys_past_sk_unmasked(rows):
    """Phase 2's ragged row, q (2, 33, 8, 64) over 1000 keys of 2 heads,
    non-causal: the last key tile reaches 24 rows past Sk.  Left unmasked
    in dQ, rows a longer buffer holds there join every query's softmax
    gradient ("buffer"); TMA's zero rows score 0, so P = exp(-lse) there,
    which overflows f32 once a row's scores lie below about -88, and dQ
    turns NaN ("zero", on scores shifted down to about -140).  The bound
    rejects both; the sound backward at the same inputs is finite and
    within 1e-5 of the f32 plain backward."""
    g = torch.Generator().manual_seed(2)
    B, H, KH, Sq, Sk, D = 2, 8, 2, 33, 1000, 64
    shift = 0.0 if rows == "buffer" else 4.2  # q.k ~ -64 x 4.2^2 / 8 ~ -141
    q, dout = _bf16_randn(g, B, H, Sq, D, shift=-shift), _bf16_randn(g, B, H, Sq, D)
    k, v = _bf16_randn(g, B, KH, Sk, D, shift=shift), _bf16_randn(g, B, KH, Sk, D)
    pad = (B, KH, -(-Sk // 64) * 64 - Sk, D)
    tail = ((torch.randn(*pad, generator=g), torch.randn(*pad, generator=g)) if rows == "buffer"
            else (torch.zeros(pad), torch.zeros(pad)))
    want = flash_grads_f32(q, k, v, dout, causal=False)
    got = _flash_fault(q, k, v, dout, "tail", causal=False, tail=tail)
    gaps = [grad_gap(a, b) for a, b in zip(got, want)]
    assert not gaps[0] <= 2 * GRAD_TOL and max(gaps[1:]) <= 1e-5, gaps
    sound = _flash_fault(q, k, v, dout, "none", causal=False)
    assert all(torch.isfinite(t).all() for t in sound)
    assert max(grad_gap(a, b) for a, b in zip(sound, want)) <= 1e-5


def _dw_in_bf16(x, w, dy):
    """dw accumulated row by row in bf16 (each partial sum rounded)."""
    x32 = x.float()
    r = torch.rsqrt((x32 * x32).mean(-1, keepdim=True) + 1e-5)
    prod = ((x32 * r).to(x.dtype).float() * dy.float()).to(torch.bfloat16)
    acc = torch.zeros(x.shape[-1], dtype=torch.bfloat16)
    for row in prod:
        acc = acc + row
    return acc


def test_card_bound_rejects_dw_summed_in_bf16_and_accepts_the_sound_one():
    """rmsnorm at the card check's train shape, one micro-batch of
    qwen2-1.5b: (4096, 1536)."""
    g = torch.Generator().manual_seed(0)
    x = (torch.randn(4096, 1536, generator=g) * 3).to(torch.bfloat16)
    w = torch.randn(1536, generator=g).to(torch.bfloat16)
    dy = torch.randn(4096, 1536, generator=g).to(torch.bfloat16)
    want_dx, want_dw = rn.rmsnorm_backward_plain(x.float(), w.float(), dy.float())
    assert grad_gap(_dw_in_bf16(x, w, dy), want_dw) > 2 * GRAD_TOL
    dx, dw = rn.rmsnorm_backward_plain(x, w, dy)
    assert grad_gap(dx, want_dx) <= GRAD_TOL / 2 and grad_gap(dw, want_dw) <= GRAD_TOL / 2


# ---------------------------------------------------------- autograd routes


def test_every_kernels_op_carries_a_grad_fn_on_cpu():
    x = torch.randn(2, 8, 4, 16, requires_grad=True)
    w = torch.ones(16, requires_grad=True)
    cfg = common.ModelConfig(name="t", family="dense", n_layers=1, d_model=64, n_heads=4,
                             kv_heads=2, d_ff=64, vocab=32, head_dim=16, dtype=torch.float32)
    kv = torch.randn(2, 8, 2, 16, requires_grad=True)
    cache = torch.randn(2, 12, 2, 16, requires_grad=True)
    gates = -torch.rand(2, 8, 4, requires_grad=True)
    outs = {
        "rms_norm": common.KERNELS.rms_norm(x, w, 1e-5),
        "attention": common.KERNELS.attention(cfg, x, kv, kv),
        "noncausal_attention": common.KERNELS.noncausal_attention(cfg, x, kv, kv),
        "decode_attention": common.KERNELS.decode_attention(x[:, :1], cache, cache, 12),
        "linear_attention": common.KERNELS.linear_attention(x, x, x, gates, chunk=4)[0],
    }
    for name, out in outs.items():
        assert out.grad_fn is not None, name
    assert _lib.needs_grad(None, x) and not _lib.needs_grad(x.detach())
    with torch.no_grad():
        assert not _lib.needs_grad(x)


@pytest.mark.parametrize("shapes,dtype,refusal", [
    (((1, 4, 64, 64), (1, 2, 64, 64)), torch.float32, (_lib.ProgramError, "item 13a")),
    (((1, 4, 64, 192), (1, 2, 64, 192)), torch.bfloat16, None),
    (((1, 4, 64, 68), (1, 2, 64, 68)), torch.bfloat16, (ValueError, "multiples of 8")),
    (((1, 18, 64, 64), (1, 2, 64, 64)), torch.bfloat16, None),
], ids=["f32", "head_dim 192", "head_dim 68", "G 9"])
def test_flash_training_route_refuses_what_the_backward_does_not_cover(shapes, dtype, refusal):
    """f32 has no backward kernel (item 13a); head_dim 68 is no width the
    bf16 kernels' TMA loads take; head_dim 192 and 9 query heads a KV head
    (item 13c) lie on the route, as does MLA's v of 128 beside q and k of
    192."""
    q, k = (torch.zeros(s, dtype=dtype) for s in shapes)
    if refusal is None:
        fa._check_grad_route(q, k, k)
    else:
        with pytest.raises(refusal[0], match=refusal[1]):
            fa._check_grad_route(q, k, k)
    fa._check_grad_route(torch.zeros(1, 12, 64, 128, dtype=torch.bfloat16),
                         torch.zeros(1, 2, 64, 128, dtype=torch.bfloat16),
                         torch.zeros(1, 2, 64, 128, dtype=torch.bfloat16))
    fa._check_grad_route(torch.zeros(1, 4, 64, 192, dtype=torch.bfloat16),
                         torch.zeros(1, 4, 64, 192, dtype=torch.bfloat16),
                         torch.zeros(1, 4, 64, 128, dtype=torch.bfloat16))
    with pytest.raises(ValueError, match="no wider than q"):
        fa._check_grad_route(torch.zeros(1, 4, 64, 128, dtype=torch.bfloat16),
                             torch.zeros(1, 4, 64, 128, dtype=torch.bfloat16),
                             torch.zeros(1, 4, 64, 192, dtype=torch.bfloat16))


@pytest.mark.parametrize("shapes", [((1, 4, 64, 64), (1, 2, 64, 64)),   # the encoder's form
                                    ((1, 4, 32, 64), (1, 2, 64, 64)),   # Sq < Sk
                                    ((1, 4, 100, 64), (1, 2, 37, 64))],  # Sq > Sk
                         ids=["Sq == Sk", "Sq < Sk", "Sq > Sk"])
def test_flash_training_route_accepts_noncausal_attention_and_unequal_lengths(shapes):
    """Item 13b: the backward kernel covers non-causal attention and Sq !=
    Sk (the route takes no mask: both masks have a backward), so the
    enc-dec's encoder and cross-attention train through it on the card."""
    q, k = (torch.zeros(s, dtype=torch.bfloat16) for s in shapes)
    fa._check_grad_route(q, k, k)
    assert "or not" in fa.GRAD_ROUTE and "any Sq and Sk" in fa.GRAD_ROUTE


def test_attention_bthd_under_grad_hands_flashfn_v_at_its_own_width(monkeypatch):
    """MLA's widths through the training route's Python, on the CPU with the
    two launches stood in for by their plain versions: `attention_bthd`
    under grad passes v to `_FlashFn` as it is (128 wide beside q and k of
    192, never padded), the forward kernel gets v at 128 and the backward
    v, o and dout at 128 (the source's (192, 128) instance), and the
    gradients, dv 128 wide, agree with autograd of the plain forward."""
    B, T, H, D, Dv = 1, 40, 4, 192, 128
    g = torch.Generator().manual_seed(4)
    q, k = (torch.randn(B, T, H, D, generator=g).requires_grad_() for _ in range(2))
    v = torch.randn(B, T, H, Dv, generator=g).requires_grad_()
    seen = {}

    def forward_lse(q, k, v, o, scale, causal=True):
        seen["forward v, o"] = (v.shape[-1], o.shape[-1])
        o.copy_(_plain_narrow(q, k, v, causal))
        return fa.flash_attention_lse_plain(q, k, scale, causal)

    def backward(q, k, v, o, dout, lse, dq, dk, dv, scale, causal=True):
        seen["backward v, o, dout, dv"] = (v.shape[-1], o.shape[-1], dout.shape[-1],
                                           dv.shape[-1])
        for out, t in zip((dq, dk, dv), fa.flash_attention_backward_plain(
                q, k, v, o, dout, lse, scale, causal)):
            out.copy_(t)

    apply = fa._FlashFn.apply

    def spy(q, k, v, *rest):
        seen["_FlashFn v"] = v.shape[-1]
        return apply(q, k, v, *rest)

    monkeypatch.setattr(fa._lib, "route", lambda *t: True)
    monkeypatch.setattr(fa, "flash_attention_forward_lse", forward_lse)
    monkeypatch.setattr(fa, "flash_attention_backward", backward)
    monkeypatch.setattr(fa._FlashFn, "apply", spy)
    monkeypatch.setattr(fa, "_check_tma", lambda *a: None)
    out = fa.attention_bthd(q.to(torch.bfloat16), k.to(torch.bfloat16), v.to(torch.bfloat16))
    assert out.shape == (B, T, H, Dv)
    dout = torch.randn(out.shape, generator=g).to(torch.bfloat16)
    got = torch.autograd.grad(out, (q, k, v), dout)
    assert seen == {"_FlashFn v": Dv, "forward v, o": (Dv, Dv),
                    "backward v, o, dout, dv": (Dv,) * 4}
    assert [t.shape for t in got] == [q.shape, k.shape, v.shape]
    monkeypatch.undo()
    leaves = [t.detach().to(torch.bfloat16).float().requires_grad_() for t in (q, k, v)]
    want = torch.autograd.grad(_plain_narrow(*(t.transpose(1, 2) for t in leaves), True)
                               .transpose(1, 2), leaves, dout.float())
    for name, a, b in zip("qkv", got, want):
        assert grad_gap(a, b) <= GRAD_TOL, name
