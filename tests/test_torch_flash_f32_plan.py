"""The launch shape of flash attention's f32 route (`ops.f32_plan`), on
the CPU: the plan is plain Python beside the CUDA source's own choice
(`fa_forward_f32_plan`, held equal to it by a card test in
tests/test_torch_cuda.py)."""

import pytest
import torch

from repro_torch.kernels.flash_attention import ops as fa

SMEM_LIMIT = 227 * 1024  # dynamic shared memory a block may opt in to on the H100


@pytest.mark.parametrize("Sq", [1, 64, 65, 4096])
def test_f32_plan_fits_shared_memory_at_every_width(Sq):
    """Every head_dim D and value width Dv <= D up to 192 fits the 227 KB a
    block may have, and the ring holds three buffers."""
    worst = 0
    for D in range(1, fa.MAX_HEAD_DIM + 1):
        for Dv in range(1, D + 1):
            plan = fa.f32_plan(Sq, D, Dv)
            assert plan.stages == 3 and plan.keys in (32, 64) and plan.rows in (64, 128)
            assert 4 * fa.F32_LANES * plan.v_chunks >= Dv
            worst = max(worst, plan.smem)
    assert worst <= SMEM_LIMIT


@pytest.mark.parametrize("B,H,Sq,Sk,causal", [
    (2, 4, 256, 256, True), (8, 32, 128, 128, True),      # the serve shape, one tile a head
    (2, 56, 3008, 3008, True),                            # llava-next-34b's prefill
    (4, 16, 33, 1024, False),                             # seamless's cross-attention
    (2, 3, 300, 1000, True), (2, 3, 1000, 300, True),     # causal Sq != Sk either way
    (1, 2, 1, 190, False), (1, 2, 190, 1, True), (3, 1, 129, 129, False)])
def test_f32_plan_covers_every_query_row_once_longest_first(B, H, Sq, Sk, causal):
    plan = fa.f32_plan(Sq, 128, 128)
    items = plan.items(B, H, Sq, Sk, causal)
    assert len(items) == B * H * -(-Sq // plan.rows)
    rows = {}
    for b, h, q0, n, tiles in items:
        assert 0 < n <= plan.rows
        rows.setdefault((b, h), []).extend(range(q0, q0 + n))
        n_keys = min(Sk, q0 + n) if causal else Sk
        assert tiles == -(-n_keys // plan.keys) >= 1
    assert all(sorted(r) == list(range(Sq)) for r in rows.values()) and len(rows) == B * H
    tiles = [t for *_, t in items]
    assert tiles == sorted(tiles, reverse=True)  # the far end of the diagonal first


def test_f32_plan_rows_and_tiles_follow_the_shapes():
    """64 query rows a block up to Sq 64, else 128; 64-key tiles up to
    head_dim 128, 32 past it."""
    assert (fa.f32_plan(64, 64, 64).rows, fa.f32_plan(65, 64, 64).rows) == (64, 128)
    assert (fa.f32_plan(512, 128, 128).keys, fa.f32_plan(512, 132, 132).keys) == (64, 32)
    assert fa.f32_plan(128, 80, 80).smem == (128 * 84 + 3 * 64 * 84 + 128 * 72) * 4


def test_f32_route_takes_a_narrower_v_without_a_pad():
    """MLA's values (128 beside q and k of 192): the f32 kernel reads v at
    its own width and accumulates 4 chunks of 4 columns a thread, not the 6
    a 192-wide v takes; the same tiles as the 192-wide call, so the two
    agree bit for bit on the 128 columns.  The bf16 route takes MLA's v at
    its own width too (its (192, 128) instance)."""
    narrow, wide = fa.f32_plan(512, 192, 128), fa.f32_plan(512, 192, 192)
    assert (narrow.Dv, narrow.v_chunks, wide.v_chunks) == (128, 4, 6)
    assert (narrow.rows, narrow.keys, narrow.smem) == (wide.rows, wide.keys, wide.smem)
    assert fa.v_width(torch.float32, 192, 128) == 128
    assert fa.v_width(torch.bfloat16, 192, 128) == 128


@pytest.mark.parametrize("Sq,D,Dv", [(0, 64, 64), (8, 193, 128), (8, 64, 80), (8, 64, 0)])
def test_f32_plan_refuses_what_the_kernel_does_not_take(Sq, D, Dv):
    with pytest.raises(ValueError, match="no f32 plan"):
        fa.f32_plan(Sq, D, Dv)


def test_f32_stride_is_an_odd_number_of_chunks():
    for dp in range(4, 200, 4):
        st = fa.f32_stride(dp)
        assert st >= dp and st % 4 == 0 and (st // 4) % 2 == 1 and st - dp <= 4
