"""The launch shape of flash attention's bf16 forward (`ops.forward_plan`)
and the width v reaches it at, on the CPU: the plan is plain Python beside
the CUDA source's own choice (`fa_forward_plan`, held equal to it by a card
test in tests/test_torch_cuda.py), and the model layout's call on the meta
device (the dry run) takes v as the card does."""

import pytest
import torch

from repro_torch.kernels import work_counts
from repro_torch.kernels.flash_attention import ops as fa

N_SM = 132  # the H100's SMs


def _instances():
    """(D, Dv) at every pair the source instantiates, widths as the
    wrapper hands them: each multiple of 8 up to 192 with v as wide, and
    MLA's v of 128 (and of 120, which rounds to it) beside q and k past
    128."""
    pairs = [(D, D) for D in range(8, fa.MAX_HEAD_DIM + 1, 8)]
    return pairs + [(D, Dv) for D in range(136, fa.MAX_HEAD_DIM + 1, 8) for Dv in (120, 128)]


@pytest.mark.parametrize("D,Dv", _instances(), ids=lambda x: str(x))
def test_forward_plan_fits_shared_memory_with_its_ring(D, Dv):
    """Every instance fits the 232,448 bytes a block may have; the ring has
    four stages up to head_dim 128, three at (192, 128), two at (192, 192);
    K/V tiles of 128 keys for a non-causal call up to head_dim 64, else 64;
    the products overlap the softmax wherever v's accumulator is at most
    128 wide."""
    plan = fa.forward_plan(2, 8, 2, 1024, 1024, D, Dv, False, N_SM)
    assert plan.smem <= fa.SMEM_LIMIT
    assert (plan.dp, plan.dvp) == (fa._padded_dim(D), fa._padded_dim(Dv))
    want = 4 if plan.dp <= 128 else 3 if plan.dvp <= 128 else 2
    assert plan.stages == want
    assert plan.overlap == (plan.dvp <= 128)
    assert (plan.rows, plan.keys, plan.consumers) == (64, 128 if plan.dp <= 64 else 64, 2)
    assert fa.forward_plan(2, 8, 2, 1024, 1024, D, Dv, True, N_SM).keys == 64
    # one more stage would not fit where the ring is cut short
    kv = (-(-plan.dp // 64) + -(-plan.dvp // 64)) * plan.keys * 128
    if plan.stages < 4:
        assert plan.smem + kv + 16 > fa.SMEM_LIMIT


def test_forward_plan_at_mla_widths_gains_a_stage():
    """MLA's (192, 128): Q and K tiles of three panels, V and the output of
    two, a three-stage ring in 205,888 bytes (the padded (192, 192) call
    had two)."""
    narrow = fa.forward_plan(2, 128, 128, 512, 512, 192, 128, True, N_SM)
    wide = fa.forward_plan(2, 128, 128, 512, 512, 192, 192, True, N_SM)
    assert (narrow.dvp, narrow.stages, narrow.smem, narrow.overlap) == (128, 3, 205888, True)
    assert (wide.dvp, wide.stages, wide.overlap) == (192, 2, False)


@pytest.mark.parametrize("B,H,Sq,items", [(8, 32, 128, 256), (2, 56, 3008, 2688),
                                          (4, 16, 33, 64), (1, 1, 1, 1), (2, 3, 129, 12)])
def test_forward_plan_items_and_grid(B, H, Sq, items):
    """A work item is 128 query rows of one (head, batch); the persistent
    grid has one block an SM, at most one an item."""
    for n_sm in (1, 132):
        plan = fa.forward_plan(B, H, 1, Sq, 1000, 64, 64, False, n_sm)
        assert plan.items == items and plan.grid == min(items, n_sm)


@pytest.mark.parametrize("B,H,Sq,Sk,D,Dv", [
    (0, 1, 8, 8, 64, 64), (1, 0, 8, 8, 64, 64), (1, 1, 0, 8, 64, 64), (1, 1, 8, 0, 64, 64),
    (1, 3, 8, 8, 64, 64),     # 3 query heads over 2 KV heads
    (1, 1, 8, 8, 36, 36),     # head_dim not a multiple of 8: TMA cannot address its rows
    (1, 1, 8, 8, 200, 200),   # past three panels
    (1, 1, 8, 8, 64, 80),     # v wider than q
    (1, 1, 8, 8, 192, 64),    # no instance takes (192, 64): the wrapper pads v to 128
    (1, 1, 8, 8, 128, 64),    # nor (128, 64): padded to 128
    (1, 1, 8, 8, 64, 60)])
def test_forward_plan_refuses_what_the_kernel_does_not_take(B, H, Sq, Sk, D, Dv):
    with pytest.raises(ValueError, match="no forward plan"):
        fa.forward_plan(B, H, 1 if H != 3 else 2, Sq, Sk, D, Dv, True, N_SM)


@pytest.mark.parametrize("D,Dv,want", [(192, 128, 128), (192, 120, 120), (192, 64, 128),
                                       (192, 192, 192), (128, 128, 128), (128, 64, 128),
                                       (80, 80, 80), (80, 72, 72), (64, 32, 64)])
def test_v_width_is_an_instance_on_the_bf16_route(D, Dv, want):
    """The bf16 forward reads v at its own width wherever an instance takes
    (D, Dv), the backward's set, else at the nearest one above it; the f32
    route always at its own."""
    assert fa.v_width(torch.bfloat16, D, Dv) == want == fa.grad_v_width(D, Dv)
    assert fa.v_width(torch.float32, D, Dv) == Dv


@pytest.mark.parametrize("Dv,padded", [(128, False), (64, True)])
def test_attention_bthd_on_meta_pads_v_only_off_an_instance(monkeypatch, Dv, padded):
    """The dry run's call at MLA's widths: q and k 192 wide, v 128 reaches
    the kernel unpadded (no `F.pad`, nothing allocated for it) and the
    launch counts v's own width; a v of 64 is padded to the (192, 128)
    instance's 128."""
    pads = []
    real_pad = fa.F.pad

    def spy(t, pad, *a, **k):
        pads.append(tuple(pad))
        return real_pad(t, pad, *a, **k)

    monkeypatch.setattr(fa.F, "pad", spy)
    B, T, H, D = 2, 96, 4, 192
    q = torch.empty(B, T, H, D, dtype=torch.bfloat16, device="meta")
    v = torch.empty(B, T, H, Dv, dtype=torch.bfloat16, device="meta")
    before = work_counts()["flash_attention"]
    out = fa.attention_bthd(q, q, v)
    after = work_counts()["flash_attention"]
    assert out.shape == (B, T, H, Dv) and out.device.type == "meta"
    assert pads == ([(0, 128 - Dv)] if padded else [])
    W = fa.v_width(torch.bfloat16, D, Dv)
    assert after["launches"] - before["launches"] == 1
    assert after["nbytes"] - before["nbytes"] == pytest.approx(
        fa.flash_work(B, H, H, T, T, D, W, True, 2).nbytes)


def test_flash_fn_on_meta_takes_mla_v_unpadded(monkeypatch):
    """Under grad at MLA's widths `_FlashFn` hands the LSE forward v and its
    output at 128 columns and pads nothing, forward or backward."""
    pads = []
    monkeypatch.setattr(fa.F, "pad", lambda *a, **k: pads.append(a) or None)
    q = torch.empty(1, 64, 4, 192, dtype=torch.bfloat16, device="meta", requires_grad=True)
    v = torch.empty(1, 64, 4, 128, dtype=torch.bfloat16, device="meta", requires_grad=True)
    before = work_counts()["flash_attention_forward_lse"]
    out = fa.attention_bthd(q, q, v)
    after = work_counts()["flash_attention_forward_lse"]
    assert out.shape == (1, 64, 4, 128) and out.is_contiguous()
    assert after["nbytes"] - before["nbytes"] == pytest.approx(
        fa.forward_lse_work(1, 4, 4, 64, 64, 192, 128, True).nbytes)
    torch.autograd.grad(out, (q, v), torch.empty_like(out))
    assert pads == []


def test_forward_lse_refuses_an_output_of_another_width():
    """v and o must share one width an instance takes."""
    q = torch.empty(1, 2, 64, 192, dtype=torch.bfloat16, device="meta")
    v = torch.empty(1, 2, 64, 128, dtype=torch.bfloat16, device="meta")
    with pytest.raises(ValueError, match="share one width"):
        fa.flash_attention_forward_lse(q, q, v, torch.empty_like(q), 0.1)
    with pytest.raises(ValueError, match="share one width"):
        fa.flash_attention_forward_lse(q, q, v[..., :64], torch.empty_like(v[..., :64]), 0.1)


@pytest.mark.parametrize("B,H,KH,Sq,Sk,D,Dv,causal,chunk", [
    (2, 128, 128, 512, 512, 192, 128, True, 76),      # deepseek-v3's MLA prefill: K/V past L2
    (4, 128, 128, 1024, 1024, 192, 128, True, 38),    # its training forward
    (2, 56, 8, 3008, 3008, 128, 128, True, 112),      # llava-next-34b: all of K/V fits, one chunk
    (8, 32, 32, 128, 128, 80, 80, True, 256),         # the serve: one query block a head
    (3, 6, 2, 300, 100000, 64, 64, False, 3),         # one group a chunk at the least
    (2, 5, 5, 129, 70, 136, 120, True, 10)])
def test_forward_plan_chunks_whole_groups_within_l2(B, H, KH, Sq, Sk, D, Dv, causal, chunk):
    """A chunk of the work order is whole groups of the heads of a KV head
    whose K and V fit `CHUNK_BYTES` (or one group, or all B H pairs), and
    the items are every (batch, head, query block) of `consumers` x `rows`
    query rows."""
    plan = fa.forward_plan(B, H, KH, Sq, Sk, D, Dv, causal, N_SM)
    assert plan.chunk == chunk
    G = H // KH
    assert chunk % G == 0 or chunk == B * H
    assert chunk == G or chunk // G * Sk * (D + Dv) * 2 <= fa.CHUNK_BYTES
    assert chunk == B * H or (chunk + G) // G * Sk * (D + Dv) * 2 > fa.CHUNK_BYTES
    assert plan.items == -(-Sq // (plan.consumers * plan.rows)) * B * H


@pytest.mark.parametrize("Sq,Sk,causal,D,turns", [
    (128, 128, True, 80, False),      # the serve: one or two tiles an item
    (512, 512, True, 80, False),      # zamba2-2.7b's prefill: at most 8
    (1024, 1024, True, 128, True),    # qwen2-1.5b's training forward: 16
    (1024, 1024, False, 64, True),    # seamless's encoder
    (33, 1024, False, 64, False),     # its cross-attention: one busy warpgroup
    (1000, 300, True, 64, False),     # at most 5 tiles
    (1024, 1024, True, 192, False)])  # (192, 192): no overlap, no turns
def test_forward_plan_takes_turns_on_long_walks(Sq, Sk, causal, D, turns):
    """The two warpgroups take turns (ping-pong) where both are busy and
    the longest item walks 1024 keys or more."""
    assert fa.forward_plan(2, 8, 2, Sq, Sk, D, D, causal, N_SM).turns == turns


@pytest.mark.parametrize("B,H,Sq,Sk,causal,overlap,keys", [
    (1, 4, 32, 32, True, False, 64),        # the serve_pipeline example: one item a block, one tile
    (4, 8, 128, 128, True, False, 64),      # train_small: 32 items of at most two tiles
    (8, 32, 128, 128, True, True, 64),      # the serve: 256 items, more than the SMs
    (4, 16, 256, 256, True, True, 64),      # seamless's causal decoder: four tiles
    (4, 16, 1024, 1024, False, True, 128),  # its encoder: non-causal, both warpgroups busy
    (4, 16, 33, 1024, False, True, 64),     # its cross-attention at 33 queries: one busy
    (2, 8, 33, 1000, False, True, 64),
    (2, 8, 200, 100, False, False, 64)])    # 32 items of two tiles
def test_forward_plan_overlaps_and_widens_where_it_pays(B, H, Sq, Sk, causal, overlap, keys):
    """The products overlap the softmax unless every block walks one item
    of at most two 64-key tiles; K/V tiles hold 128 keys for an overlapped
    non-causal call at head_dim 64 whose items keep both warpgroups busy."""
    plan = fa.forward_plan(B, H, H, Sq, Sk, 64, 64, causal, N_SM)
    assert (plan.overlap, plan.keys) == (overlap, keys)
    assert not plan.turns or plan.overlap
