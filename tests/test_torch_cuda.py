"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here is marked `requires_cuda` and skips without an NVIDIA GPU
(a CUDA kernel has no CPU mode).  The file imports neither JAX nor the
reference package, so it runs on a machine with the card alone:

    PYTHONPATH=src python -m pytest -q --noconftest tests/test_torch_cuda.py

(`--noconftest` skips tests/conftest.py, which imports JAX.)

Tolerances are those of tests/test_kernels.py (`_tol`: bf16 5e-2, f32
3e-5; the SSD scan atol 5e-4, rtol 2e-3, its test_ssd_scan), tighter for
the attention kernels in bf16 (`attn_tol`: atol and rtol 1e-2); quantize
and dequantize must be bit-equal.
"""

import time

import numpy as np
import pytest
import torch

from repro_torch.kernels import _lib
from repro_torch.kernels.boundary_quant import ops as bq
from repro_torch.kernels.decode_attention import ops as da
from repro_torch.kernels.flash_attention import ops as fa
from repro_torch.kernels.rmsnorm import ops as rn
from repro_torch.kernels.ssd_scan import ops as ssd
from repro_torch.testing.parity import assert_grad_close, attn_tol, flash_grads_f32, tol


def _normal(seed, shape, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape) * scale).astype(np.float32)


def _np(t: torch.Tensor) -> np.ndarray:
    return t.float().numpy()


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


def _on(device, seed, shape, dtype, scale=1.0):
    return torch.from_numpy(_normal(seed, shape, scale)).to(device=device, dtype=dtype)


@pytest.mark.requires_cuda
@pytest.mark.parametrize("B,H,KH,S,D", [(2, 4, 2, 256, 64), (2, 32, 32, 128, 80),
                                        (1, 8, 2, 12, 128), (3, 4, 4, 130, 32),
                                        (1, 2, 1, 70, 40),
                                        (1, 40, 8, 128, 128),  # qwen3-14b grouping (40/8)
                                        (2, 4, 2, 300, 80),    # ragged: a short last tile
                                        (1, 8, 8, 512, 80),    # eight K/V tiles through the ring
                                        (2, 4, 2, 1, 64),      # one token
                                        (2, 4, 4, 190, 64),    # one active warpgroup at the end
                                        (1, 8, 8, 300, 192),   # MLA's width: three panels, 2 stages
                                        (2, 10, 2, 200, 160),  # in (128, 192): zero-filled columns
                                        (1, 4, 4, 1, 192),     # one token at 192
                                        ])
def test_flash_attention_kernel_matches_plain(cuda, B, H, KH, S, D):
    dtype = torch.bfloat16
    q = _on(cuda, 30, (B, H, S, D), dtype)
    k = _on(cuda, 31, (B, KH, S, D), dtype)
    v = _on(cuda, 32, (B, KH, S, D), dtype)
    before = fa.flash_attention.launches
    got = fa.flash_attention(q, k, v)
    torch.cuda.synchronize()
    assert fa.flash_attention.launches == before + 1
    want = fa.flash_attention_plain(q, k, v)
    np.testing.assert_allclose(_np(got.cpu()), _np(want.cpu()), **attn_tol(dtype))
    bthd = fa.attention_bthd(q.transpose(1, 2).contiguous(), k.transpose(1, 2).contiguous(),
                             v.transpose(1, 2).contiguous())
    np.testing.assert_array_equal(_np(bthd.transpose(1, 2).cpu()), _np(got.cpu()))


@pytest.mark.requires_cuda
@pytest.mark.parametrize("B,H,KH,S,D", [(2, 4, 2, 256, 64), (1, 8, 8, 128, 128),
                                        (2, 6, 2, 384, 128), (1, 2, 1, 512, 64),
                                        (1, 8, 8, 200, 192),   # MLA's width: 72 KB ring
                                        (1, 4, 2, 130, 136)])  # Dp 136 of the 192 instance
def test_flash_attention_f32_kernel_matches_plain(cuda, B, H, KH, S, D):
    """The f32 route (CUDA-core FMAs) at tests/test_kernels.py's four shapes
    and its f32 bound, 3e-5, against the plain version in f32 (TF32 off,
    PyTorch's default, so the plain einsums are f32 products); the model
    layout reads the same inputs in place and gives the same output."""
    assert not torch.backends.cuda.matmul.allow_tf32
    q = _on(cuda, 30, (B, H, S, D), torch.float32)
    k = _on(cuda, 31, (B, KH, S, D), torch.float32)
    v = _on(cuda, 32, (B, KH, S, D), torch.float32)
    before = fa.flash_attention.launches
    got = fa.flash_attention(q, k, v)
    torch.cuda.synchronize()
    assert fa.flash_attention.launches == before + 1
    want = fa.flash_attention_plain(q, k, v)
    np.testing.assert_allclose(_np(got.cpu()), _np(want.cpu()), **tol(torch.float32))
    bthd = fa.attention_bthd(q.transpose(1, 2).contiguous(), k.transpose(1, 2).contiguous(),
                             v.transpose(1, 2).contiguous())
    np.testing.assert_array_equal(_np(bthd.transpose(1, 2).cpu()), _np(got.cpu()))


@pytest.mark.requires_cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_flash_attention_kernel_non_causal(cuda, dtype):
    """Non-causal at tests/test_kernels.py's shape (1, 4, 256, 64): f32 at
    3e-5, bf16 at `attn_tol`."""
    q, k, v = (_on(cuda, 35 + i, (1, 4, 256, 64), dtype) for i in range(3))
    got = fa.flash_attention(q, k, v, causal=False)
    want = fa.flash_attention_plain(q, k, v, causal=False)
    torch.cuda.synchronize()
    bound = tol(dtype) if dtype == torch.float32 else attn_tol(dtype)
    np.testing.assert_allclose(_np(got.cpu()), _np(want.cpu()), **bound)


@pytest.mark.requires_cuda
@pytest.mark.parametrize("B,H,KH,Sq,Sk,D", [
    (2, 4, 2, 128, 256, 64), (2, 4, 2, 256, 128, 64),      # the CPU tests' shapes
    (1, 8, 2, 64, 384, 128), (1, 8, 2, 384, 64, 128),
    (4, 16, 16, 33, 1024, 64),                             # seamless's cross-attention
    (2, 14, 2, 300, 1000, 128), (2, 8, 8, 1000, 300, 64),  # ragged either way
    (1, 4, 4, 1, 190, 64), (1, 4, 4, 190, 1, 128),         # one query, one key
])
@pytest.mark.parametrize("causal", [True, False], ids=["causal", "non_causal"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_flash_attention_kernel_unequal_lengths_match_plain(cuda, B, H, KH, Sq, Sk, D, causal,
                                                            dtype):
    """Sq != Sk, causal (aligned top-left) and not, on both routes: f32 at
    3e-5, bf16 at `attn_tol`; the model layout equal to the (B, H, S, D)
    one bit for bit."""
    q = _on(cuda, 60, (B, H, Sq, D), dtype)
    k = _on(cuda, 61, (B, KH, Sk, D), dtype)
    v = _on(cuda, 62, (B, KH, Sk, D), dtype)
    before = fa.flash_attention.launches
    got = fa.flash_attention(q, k, v, causal=causal)
    torch.cuda.synchronize()
    assert fa.flash_attention.launches == before + 1
    want = fa.flash_attention_plain(q, k, v, causal=causal)
    bound = tol(dtype) if dtype == torch.float32 else attn_tol(dtype)
    np.testing.assert_allclose(_np(got.cpu()), _np(want.cpu()), **bound)
    bthd = fa.attention_bthd(q.transpose(1, 2).contiguous(), k.transpose(1, 2).contiguous(),
                             v.transpose(1, 2).contiguous(), causal=causal)
    np.testing.assert_array_equal(_np(bthd.transpose(1, 2).cpu()), _np(got.cpu()))


@pytest.mark.requires_cuda
@pytest.mark.parametrize("causal", [True, False], ids=["causal", "non_causal"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_flash_attention_kernel_narrower_v(cuda, causal, dtype, monkeypatch):
    """MLA's layout on the card: q and k (B, T, H, 192), v 128 wide; both
    kernels read v at its own width (the bf16 one through its (192, 128)
    instance): one launch and no pad, against the plain version on the
    padded v."""
    pads = []
    real_pad = fa.F.pad
    monkeypatch.setattr(fa.F, "pad", lambda *a, **k: pads.append(a) or real_pad(*a, **k))
    q = _on(cuda, 80, (2, 130, 8, 192), dtype)
    k = _on(cuda, 81, (2, 130, 8, 192), dtype)
    v = _on(cuda, 82, (2, 130, 8, 128), dtype)
    before = fa.flash_attention.launches
    got = fa.attention_bthd(q, k, v, causal=causal)
    torch.cuda.synchronize()
    assert fa.flash_attention.launches == before + 1 and got.shape == (2, 130, 8, 128)
    assert pads == []
    monkeypatch.undo()
    vp = torch.nn.functional.pad(v, (0, 64))
    want = fa.flash_attention_plain(q.transpose(1, 2), k.transpose(1, 2), vp.transpose(1, 2),
                                    causal=causal).transpose(1, 2)[..., :128]
    bound = tol(dtype) if dtype == torch.float32 else attn_tol(dtype)
    np.testing.assert_allclose(_np(got.cpu()), _np(want.cpu()), **bound)


@pytest.mark.requires_cuda
@pytest.mark.parametrize("causal", [True, False], ids=["causal", "non_causal"])
def test_flash_attention_narrow_v_equals_the_padded_call(cuda, causal):
    """bf16 v at 128 columns (the (192, 128) instance) and the same v
    zero-padded to 192 (the (192, 192) one): the same tiles, the same
    scores and softmax, each output column the same sum over the keys, so
    the 128 columns agree bit for bit."""
    q, k = (_on(cuda, 96 + i, (2, 300, 8, 192), torch.bfloat16) for i in range(2))
    v = _on(cuda, 98, (2, 300, 8, 128), torch.bfloat16)
    got = fa.attention_bthd(q, k, v, causal=causal)
    padded = fa.attention_bthd(q, k, torch.nn.functional.pad(v, (0, 64)), causal=causal)
    torch.cuda.synchronize()
    assert torch.equal(got, padded[..., :128])


# (D, Dv) of the bf16 forward's instances on the model paths: seamless's 64,
# the serve's 80, the dense models' 128, MLA's (192, 128), and (192, 192)
_BF16_WIDTHS = [(64, 64), (80, 80), (128, 128), (192, 128), (192, 192)]


@pytest.mark.requires_cuda
@pytest.mark.parametrize("D,Dv", _BF16_WIDTHS, ids=lambda x: str(x))
@pytest.mark.parametrize("G", [1, 5, 16])
@pytest.mark.parametrize("Sq,Sk", [(200, 200), (70, 300), (300, 70), (33, 1000), (129, 1)])
@pytest.mark.parametrize("causal", [True, False], ids=["causal", "non_causal"])
def test_flash_attention_bf16_forward_widths_groups_lengths(cuda, D, Dv, G, Sq, Sk, causal):
    """The bf16 forward in the model layout at each instance (v unpadded),
    G query heads a KV head, Sq and Sk ragged against the 128-row items and
    64-key tiles, causal (Sq < Sk and Sq > Sk) and not: one launch, against
    the plain version at `attn_tol`; the LSE forward's output bit-equal to
    it and its lse the plain one."""
    B, KH = 2, 2
    dtype = torch.bfloat16
    q = _on(cuda, 170, (B, Sq, G * KH, D), dtype)
    k = _on(cuda, 171, (B, Sk, KH, D), dtype)
    v = _on(cuda, 172, (B, Sk, KH, Dv), dtype)
    before = fa.flash_attention.launches
    got = fa.attention_bthd(q, k, v, causal=causal)
    o = torch.full_like(got, float("nan"))
    lse = fa.flash_attention_forward_lse(q.transpose(1, 2), k.transpose(1, 2),
                                         v.transpose(1, 2), o.transpose(1, 2), D ** -0.5,
                                         causal)
    torch.cuda.synchronize()
    assert fa.flash_attention.launches == before + 1 and got.shape == (B, Sq, G * KH, Dv)
    vp = torch.nn.functional.pad(v, (0, D - Dv)).transpose(1, 2)
    want = fa.flash_attention_plain(q.transpose(1, 2), k.transpose(1, 2), vp,
                                    causal=causal).transpose(1, 2)[..., :Dv]
    np.testing.assert_allclose(_np(got.cpu()), _np(want.cpu()), **attn_tol(dtype))
    assert torch.equal(o, got)
    torch.testing.assert_close(lse, fa.flash_attention_lse_plain(
        q.transpose(1, 2), k.transpose(1, 2), causal=causal), atol=1e-4, rtol=1e-5)


@pytest.mark.requires_cuda
@pytest.mark.parametrize("D,Dv", _BF16_WIDTHS, ids=lambda x: str(x))
def test_flash_attention_bf16_forward_replays_bit_equal_in_a_graph(cuda, D, Dv):
    """`fa_forward` and `fa_forward_lse` captured in a CUDA graph (nothing
    allocated or synchronised in the launch) and replayed on new inputs
    copied in, over NaN: equal to the eager calls bit for bit."""
    B, Sq, Sk, H, KH = 2, 300, 300, 8, 2
    dtype = torch.bfloat16
    q = _on(cuda, 180, (B, H, Sq, D), dtype)
    k = _on(cuda, 181, (B, KH, Sk, D), dtype)
    v = _on(cuda, 182, (B, KH, Sk, Dv), dtype)
    outs = [torch.empty(B, H, Sq, Dv, dtype=dtype, device=cuda) for _ in range(2)]
    lse = torch.empty(B, H, Sq, device=cuda)

    def calls():
        fa._launch(q, k, v, outs[0], True, D ** -0.5)
        lse.copy_(fa.flash_attention_forward_lse(q, k, v, outs[1], D ** -0.5, True))

    calls()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        calls()
    for i in range(2):
        for t, seed in ((q, 183), (k, 184), (v, 185)):
            t.copy_(_on(cuda, seed + 3 * i, t.shape, dtype))
        calls()
        torch.cuda.synchronize()
        eager = [t.clone() for t in (*outs, lse)]
        for t in (*outs, lse):
            t.fill_(float("nan"))
        graph.replay()
        torch.cuda.synchronize()
        for got, want in zip((*outs, lse), eager):
            assert torch.equal(got, want), i
        assert torch.equal(outs[0], outs[1])
    del graph


@pytest.mark.requires_cuda
@pytest.mark.parametrize("B,H,KH,Sq,Sk,D,Dv", [
    (8, 32, 32, 128, 128, 80, 80), (2, 56, 8, 3008, 3008, 128, 128),
    (2, 128, 128, 512, 512, 192, 128), (4, 128, 128, 1024, 1024, 192, 128),
    (2, 8, 2, 512, 512, 192, 192), (4, 16, 16, 33, 1024, 64, 64),
    (1, 1, 1, 1, 1, 8, 8), (3, 5, 5, 129, 70, 136, 120), (4, 16, 16, 1024, 1024, 64, 64)])
@pytest.mark.parametrize("causal", [True, False], ids=["causal", "non_causal"])
def test_flash_attention_bf16_forward_launch_follows_its_plan(cuda, B, H, KH, Sq, Sk, D, Dv,
                                                              causal):
    """`ops.forward_plan` is the source's launch (`fa_forward_plan`): the
    instance, rows, keys a tile, consumers, ring stages, shared memory,
    items, grid on this card's SMs, whether the products overlap the
    softmax, the work order's chunk, and whether the warpgroups take
    turns."""
    dev = torch.cuda.current_device()
    plan = fa.forward_plan(B, H, KH, Sq, Sk, D, Dv, causal, _lib.sm_count(dev))
    assert fa.forward_plan_on_card(B, H, KH, Sq, Sk, D, Dv, causal) == plan.as_tuple()


@pytest.mark.requires_cuda
def test_flash_attention_f32_kernel_reads_unaligned_rows(cuda):
    """f32 K and V whose rows do not start on 16-byte boundaries (a row
    stride of 66 floats, head_dim 40) take the 4-byte copies."""
    B, H, S, D = 2, 4, 70, 40
    q = _on(cuda, 36, (B, H, S, D), torch.float32)
    k, v = (_on(cuda, 37 + i, (B, S, H, 66), torch.float32)[..., :D].transpose(1, 2)
            for i in range(2))
    got = fa.flash_attention(q, k, v)
    want = fa.flash_attention_plain(q, k, v)
    torch.cuda.synchronize()
    np.testing.assert_allclose(_np(got.cpu()), _np(want.cpu()), **tol(torch.float32))


# (D, Dv) of the f32 route's redesign: the serve's and seamless's head_dims,
# the dense models' 128, MLA's 192 with 128-wide values
_F32_WIDTHS = [(64, 64), (80, 80), (128, 128), (192, 128)]


@pytest.mark.requires_cuda
@pytest.mark.parametrize("D,Dv", _F32_WIDTHS, ids=lambda x: str(x))
@pytest.mark.parametrize("G", [1, 5, 7])
@pytest.mark.parametrize("Sq,Sk", [(200, 200), (70, 300), (300, 70), (33, 1000)])
@pytest.mark.parametrize("causal", [True, False], ids=["causal", "non_causal"])
def test_flash_attention_f32_kernel_widths_groups_lengths(cuda, D, Dv, G, Sq, Sk, causal):
    """The f32 route in the model layout at each width (v unpadded where it
    is narrower), query heads a KV head G in {1, 5, 7}, Sq != Sk either way
    (Sq 33: the 64-row blocks), causal and not, against the plain version
    in f32 at 3e-5 (TF32 off); one launch."""
    assert not torch.backends.cuda.matmul.allow_tf32
    B, KH = 2, 2
    q = _on(cuda, 90, (B, Sq, G * KH, D), torch.float32)
    k = _on(cuda, 91, (B, Sk, KH, D), torch.float32)
    v = _on(cuda, 92, (B, Sk, KH, Dv), torch.float32)
    before = fa.flash_attention.launches
    got = fa.attention_bthd(q, k, v, causal=causal)
    torch.cuda.synchronize()
    assert fa.flash_attention.launches == before + 1 and got.shape == (B, Sq, G * KH, Dv)
    vp = torch.nn.functional.pad(v, (0, D - Dv)).transpose(1, 2)
    want = fa.flash_attention_plain(q.transpose(1, 2), k.transpose(1, 2), vp,
                                    causal=causal).transpose(1, 2)[..., :Dv]
    np.testing.assert_allclose(_np(got.cpu()), _np(want.cpu()), **tol(torch.float32))


@pytest.mark.requires_cuda
def test_flash_attention_f32_narrow_v_equals_the_padded_call(cuda):
    """v at 128 columns and the same v zero-padded to 192 run the same tiles
    and sums: the 128 columns agree bit for bit."""
    q, k = (_on(cuda, 93 + i, (2, 300, 8, 192), torch.float32) for i in range(2))
    v = _on(cuda, 95, (2, 300, 8, 128), torch.float32)
    got = fa.attention_bthd(q, k, v)
    padded = fa.attention_bthd(q, k, torch.nn.functional.pad(v, (0, 64)))
    torch.cuda.synchronize()
    assert torch.equal(got, padded[..., :128])


@pytest.mark.requires_cuda
@pytest.mark.parametrize("Sq,D,Dv", [(1, 7, 7), (33, 64, 64), (64, 80, 80), (65, 80, 80),
                                     (128, 128, 128), (3008, 128, 128), (512, 192, 128),
                                     (512, 192, 192), (200, 136, 100), (70, 40, 40)])
def test_flash_attention_f32_launch_follows_its_plan(cuda, Sq, D, Dv):
    """`ops.f32_plan` is the source's choice (`fa_forward_f32_plan`): rows a
    block, keys a tile, ring buffers, shared-memory bytes, output chunks."""
    plan = fa.f32_plan(Sq, D, Dv)
    assert fa.f32_plan_on_card(Sq, D, Dv) == (plan.rows, plan.keys, plan.stages, plan.smem,
                                              plan.v_chunks)


@pytest.mark.requires_cuda
def test_flash_attention_kernel_refuses_float16(cuda):
    """The kernel takes bf16 and f32; any other dtype on CUDA raises, with
    no launch (nothing falls back)."""
    q = torch.zeros(1, 2, 16, 64, device=cuda, dtype=torch.float16)
    before = fa.flash_attention.launches
    with pytest.raises(TypeError, match="bfloat16"):
        fa.flash_attention(q, q, q)
    assert fa.flash_attention.launches == before


@pytest.mark.requires_cuda
@pytest.mark.parametrize("what", ["base", "stride", "head_dim"])
def test_flash_attention_kernel_raises_where_tma_cannot_address(cuda, what):
    """TMA addresses 16-byte-aligned bases and strides only: a misaligned
    base, a row stride of 132 bytes, or head_dim 36 (72-byte rows) raise in
    the wrapper; nothing falls back."""
    bf16 = torch.bfloat16
    q = torch.zeros(1, 2, 16, 64, device=cuda, dtype=bf16)
    if what == "base":
        bad = torch.zeros(2 * 16 * 64 + 1, device=cuda, dtype=bf16)[1:].view(1, 2, 16, 64)
    elif what == "stride":
        bad = torch.zeros(1, 16, 2, 66, device=cuda, dtype=bf16)[..., :64].transpose(1, 2)
    else:
        q = bad = torch.zeros(1, 2, 16, 36, device=cuda, dtype=bf16)
    before = fa.flash_attention.launches
    with pytest.raises(ValueError, match="TMA"):
        fa.flash_attention(q, bad, q)
    assert fa.flash_attention.launches == before


_RMSNORM_ROWS = [(1024, 2560), (96, 80), (7, 32),
                 (40960, 128),           # qwen3-14b's qk_norm: 16 lanes a row
                 (2048, 5120),           # the Mamba2 gated norm
                 (4, 2560), (8, 2560), (4, 5120),  # decode rows
                 (33, 1001), (5, 2563),  # D not a multiple of the vector
                 (3, 12000),             # three vectors a thread in bf16
                 (2, 16000), (3, 16384)]  # 4 in bf16, 8 in f32
_RMSNORM_CASES = [pytest.param(N, D, dtype, id=f"{name}-{N}-{D}")
                  for dtype, name in ((torch.float32, "f32"), (torch.bfloat16, "bf16"))
                  for N, D in _RMSNORM_ROWS]
# bf16 rows of 8 vectors a thread: a partial last warp of lanes (20000) and
# the widest row the kernel takes (32768; past f32's widest)
_RMSNORM_CASES += [pytest.param(N, D, torch.bfloat16, id=f"bf16-{N}-{D}")
                   for N, D in ((3, 20000), (2, 32768))]


@pytest.mark.requires_cuda
@pytest.mark.parametrize("N,D,dtype", _RMSNORM_CASES)
def test_rmsnorm_kernel_matches_plain(cuda, N, D, dtype):
    x = _on(cuda, 33, (N, D), dtype)
    w = _on(cuda, 34, (D,), dtype)
    before = rn.rmsnorm.launches
    got = rn.rmsnorm(x, w)
    again = rn.rmsnorm(x, w)
    torch.cuda.synchronize()
    assert rn.rmsnorm.launches == before + 2
    np.testing.assert_allclose(_np(got.cpu()), _np(rn.rmsnorm_plain(x, w).cpu()), **tol(dtype))
    np.testing.assert_array_equal(_np(got.cpu()), _np(again.cpu()))


@pytest.mark.requires_cuda
@pytest.mark.parametrize("offset", [1, 3, 8])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_rmsnorm_kernel_unaligned_view(cuda, offset, dtype):
    """x a contiguous view at an element offset, its data pointer off the
    16-byte grid (or on it, at offset 8 in bf16): the kernel takes it as it
    is and matches the plain version."""
    N, D = 64, 2560
    base = _on(cuda, 36, (N * D + offset,), dtype)
    x = base[offset:].view(N, D)
    w = _on(cuda, 37, (D,), dtype)
    assert rn.vector_loads(x, w, torch.empty_like(x)) == (x.data_ptr() % 16 == 0)
    before = rn.rmsnorm.launches
    got = rn.rmsnorm(x, w)
    torch.cuda.synchronize()
    assert rn.rmsnorm.launches == before + 1
    np.testing.assert_allclose(_np(got.cpu()), _np(rn.rmsnorm_plain(x, w).cpu()), **tol(dtype))


@pytest.mark.requires_cuda
def test_rmsnorm_kernel_refuses_what_it_cannot_take(cuda):
    """A row past the widest plan (in either dtype) raises before any launch."""
    before = rn.rmsnorm.launches
    for D, dtype in ((32769, torch.bfloat16), (16385, torch.float32)):
        with pytest.raises(ValueError, match="at most"):
            rn.rmsnorm(torch.zeros(2, D, device=cuda, dtype=dtype),
                       torch.zeros(D, device=cuda, dtype=dtype))
    assert rn.rmsnorm.launches == before


@pytest.mark.requires_cuda
@pytest.mark.parametrize("N,D", [(1024, 2560), (7, 96)])
def test_boundary_quant_kernels_match_plain(cuda, N, D):
    x = _on(cuda, 35, (N, D), torch.bfloat16, scale=20.0)
    q, s = bq.quantize(x)
    qp, sp = bq.quantize_plain(x)
    torch.cuda.synchronize()
    np.testing.assert_array_equal(q.cpu().numpy(), qp.cpu().numpy())
    np.testing.assert_array_equal(s.cpu().numpy(), sp.cpu().numpy())
    for dtype in (torch.bfloat16, torch.float32):
        got = bq.dequantize(q, s, dtype)
        np.testing.assert_array_equal(_np(got.cpu()), _np(bq.dequantize_plain(q, s, dtype).cpu()))


# (N, D) reaching every launch instance of quantize: narrow rows of 1-4
# chunks a lane (D = 1 and 7 element-wise), few narrow rows as blocks of 64,
# 96 and 128 threads of one chunk, block rows of 2, 3, 4 and 8 chunks, the
# two-pass kernel past the widest plan (f32 from 16385, bf16 from 32769),
# ragged row counts
_QUANT_ROWS = [(1023, 1), (333, 7), (5, 8), (1000, 96), (600, 264), (700, 520), (2000, 1024),
               (77, 264), (129, 520), (64, 1024), (1024, 2560), (1001, 2560), (9, 8200),
               (3, 16384), (3, 20000), (2, 32768), (2, 40000)]
_QUANT_CASES = [pytest.param(N, D, dtype, id=f"{name}-{N}-{D}")
                for dtype, name in ((torch.float32, "f32"), (torch.bfloat16, "bf16"))
                for N, D in _QUANT_ROWS]


def _assert_quantize_matches_plain(x):
    before = bq.quantize.launches
    q, s = bq.quantize(x)
    torch.cuda.synchronize()
    assert bq.quantize.launches == before + 1
    qp, sp = bq.quantize_plain(x)
    np.testing.assert_array_equal(q.cpu().numpy(), qp.cpu().numpy())
    np.testing.assert_array_equal(s.cpu().numpy(), sp.cpu().numpy())


@pytest.mark.requires_cuda
@pytest.mark.parametrize("N,D,dtype", _QUANT_CASES)
def test_quantize_kernel_every_instance_bit_equal(cuda, N, D, dtype):
    _assert_quantize_matches_plain(_on(cuda, 38, (N, D), dtype, scale=20.0))


@pytest.mark.requires_cuda
@pytest.mark.parametrize("offset", [1, 3, 8])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_quantize_kernel_unaligned_view(cuda, offset, dtype):
    """x a contiguous view at an element offset: element-wise loads off the
    16-byte grid, vector loads on it (offset 8 in bf16), bit-equal either
    way."""
    N, D = 300, 2560
    x = _on(cuda, 39, (N * D + offset,), dtype, scale=20.0)[offset:].view(N, D)
    assert bq.vector_loads(x) == (x.data_ptr() % 16 == 0)
    _assert_quantize_matches_plain(x)


@pytest.mark.requires_cuda
@pytest.mark.parametrize("D", [96, 2560, 40000])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_quantize_kernel_zero_and_tiny_rows(cuda, D, dtype):
    """Rows of zeros and of values near 1e-10, where the scale's + 1e-12
    decides q (without it a zero row divides 0 by 0)."""
    x = _on(cuda, 40, (6, D), dtype)
    x[0] = 0
    x[1] *= 1e-10
    x[2] *= 1e-12
    x[3, :-1] = 0
    _assert_quantize_matches_plain(x)


@pytest.mark.requires_cuda
def test_model_layers_through_kernels(cuda):
    """A reduced stablelm forward on the card launches rmsnorm twice per
    layer plus the final norm and attention once per layer, and each layer
    through the kernels matches the same layer through the plain math
    (`common.PLAIN`) from the same input, to 5e-2 of the layer output's largest magnitude.
    (Whole forwards are compared by the decisive top-1 rule only: with the
    reference init, one-ulp bf16 differences grow chaotically over layers.)"""
    from repro_torch.configs import get_config
    from repro_torch.models import transformer as tfm
    from repro_torch.models.common import KERNELS, PLAIN
    from repro_torch.models.model_zoo import build_model

    cfg = get_config("stablelm-3b").reduced(n_layers=4, head_dim=80, d_model=320)
    params = build_model(cfg).init(torch.Generator(device=cuda).manual_seed(0))
    tokens = torch.from_numpy(np.random.default_rng(0).integers(0, cfg.vocab, (2, 40))).to(cuda)
    n_rms, n_fa = rn.rmsnorm.launches, fa.flash_attention.launches
    logits = tfm.forward(cfg, KERNELS, params, tokens)
    torch.cuda.synchronize()
    assert rn.rmsnorm.launches - n_rms == 2 * cfg.n_layers + 1
    assert fa.flash_attention.launches - n_fa == cfg.n_layers
    assert torch.isfinite(logits).all()
    x = tfm.embed_tokens(cfg, params, tokens)
    pos = tfm.positions_for(x)
    for lp in params["layers"]:
        got, _ = tfm.layer_full(cfg, KERNELS, lp, x, pos)
        want, _ = tfm.layer_full(cfg, PLAIN, lp, x, pos)
        scale = want.float().abs().max()
        assert (got.float() - want.float()).abs().max() <= 5e-2 * scale
        x = got


@pytest.mark.requires_cuda
def test_encdec_through_kernels(cuda):
    """A reduced seamless-m4t on the card: the teacher-forced forward
    launches flash attention for every encoder layer and twice for every
    decoder layer (causal self-, non-causal cross-attention over S_enc !=
    T), the prefill once per encoder layer and decode attention twice per
    decoder layer (the BOS step); each encoder layer and each decoder block
    through the kernels within 5e-2 of scale of the plain math from the same
    input, and prefill + 3 steps equal to the teacher-forced forward."""
    from repro_torch.configs import get_config
    from repro_torch.models import encdec, transformer as tfm
    from repro_torch.models.common import KERNELS, PLAIN
    from repro_torch.models.model_zoo import build_model

    cfg = get_config("seamless-m4t-large-v2").reduced(dtype=torch.float32)
    model = build_model(cfg)
    params = model.init(torch.Generator(device=cuda).manual_seed(0))
    frames = _on(cuda, 70, (2, 40, cfg.d_model), torch.float32)
    tokens = torch.from_numpy(np.random.default_rng(0).integers(0, cfg.vocab, (2, 6))).to(cuda)
    tokens[:, 0] = 1  # BOS
    n_fa, n_da = fa.flash_attention.launches, da.decode_attention.launches
    full = model.forward(params, {"tokens": tokens, "frames": frames})
    torch.cuda.synchronize()
    assert fa.flash_attention.launches - n_fa == cfg.encoder_layers + 2 * cfg.n_layers
    n_fa = fa.flash_attention.launches
    lg, cache = model.prefill(params, {"frames": frames}, max_len=8)
    steps = [lg[:, 0]]
    for i in range(1, 4):
        lg, cache = model.decode_step(params, tokens[:, i:i + 1], cache, i)
        steps.append(lg[:, 0])
    torch.cuda.synchronize()
    assert fa.flash_attention.launches - n_fa == cfg.encoder_layers
    assert da.decode_attention.launches - n_da == 2 * cfg.n_layers * 4
    np.testing.assert_allclose(_np(torch.stack(steps, 1).cpu()), _np(full[:, :4].cpu()),
                               rtol=1e-4, atol=1e-4 * float(full.abs().max()))

    def close(got, want):
        assert (got - want).abs().max() <= 5e-2 * want.abs().max()

    x = frames
    pos = tfm.positions_for(x)
    for lp in params["enc_layers"]:
        got = encdec.enc_layer(cfg, KERNELS, lp, x, pos)
        close(got, encdec.enc_layer(cfg, PLAIN, lp, x, pos))
        x = got
    enc_out = KERNELS.rms_norm(x, params["enc_norm"], cfg.norm_eps)
    x = tfm.embed_tokens(cfg, params, tokens)
    pos = tfm.positions_for(x)
    for lp in params["dec_layers"]:
        got = encdec.self_block_full(cfg, KERNELS, lp, x, pos)[0]
        close(got, encdec.self_block_full(cfg, PLAIN, lp, x, pos)[0])
        x = got
        got = encdec.cross_block_full(cfg, KERNELS, lp, x, enc_out)
        close(got, encdec.cross_block_full(cfg, PLAIN, lp, x, enc_out))
        x = encdec.mlp_block(cfg, KERNELS, lp, got)


# ------------------------------------------------------------ decode attention


@pytest.mark.requires_cuda
@pytest.mark.parametrize("B,S,KH,G,D,kv_len", [
    (8, 160, 32, 1, 80, 160),   # stablelm-3b decode, batch 8, last step
    (4, 528, 32, 1, 80, 517),   # zamba2-2.7b decode, batch 4
    (2, 300, 8, 5, 128, 291),   # qwen3-14b grouping (G = 5), ragged S
    (1, 70, 2, 3, 64, 1),       # one valid position
    (4, 528, 32, 1, 80, 1),     # zamba2-2.7b's shape: 8 warps a block; one position
    (1, 1024, 8, 1, 80, 1),     # split over the sequence (8 of 128 keys), one position
    (1, 1024, 8, 1, 80, 128),   # kv_len on a split boundary
    (1, 1024, 8, 1, 80, 257),   # one past the second boundary
    (1, 1024, 8, 1, 80, 40),    # seven of eight splits empty
    (2, 1024, 4, 2, 80, (1, 1024)),  # per-row lengths: one row at 1, one full
    (1, 4096, 8, 1, 128, 4000),  # 8 splits of 512, head_dim 128, 8 warps a block
    (2, 528, 8, 5, 128, 528),   # llama4-maverick-400b-a17b decode (G = 5): split path
])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_decode_attention_kernel_matches_plain(cuda, B, S, KH, G, D, kv_len, dtype):
    q = _on(cuda, 40, (B, 1, KH * G, D), dtype)
    k = _on(cuda, 41, (B, S, KH, D), dtype)
    v = _on(cuda, 42, (B, S, KH, D), dtype)
    lens = torch.tensor(kv_len, dtype=torch.int32, device=cuda)
    kv_len = kv_len if isinstance(kv_len, int) else lens
    before = da.decode_attention.launches
    got = da.decode_attention_bthd(q, k, v, lens)
    torch.cuda.synchronize()
    assert da.decode_attention.launches == before + 1
    want = da.decode_attention_plain(q, k, v, lens)
    np.testing.assert_allclose(_np(got.cpu()), _np(want.cpu()), **attn_tol(dtype))
    # the reference kernel's layout and a Python int give the same result
    grouped = da.decode_attention(q.reshape(B, KH, G, D), k.transpose(1, 2).contiguous(),
                                  v.transpose(1, 2).contiguous(), kv_len)
    np.testing.assert_array_equal(_np(grouped.reshape(B, 1, KH * G, D).cpu()), _np(got.cpu()))


@pytest.mark.requires_cuda
def test_decode_attention_kernel_masks_tail(cuda):
    """Garbage at and past kv_len never reaches the output."""
    q = _on(cuda, 43, (2, 1, 4, 80), torch.bfloat16)
    k = _on(cuda, 44, (2, 256, 4, 80), torch.bfloat16)
    v = _on(cuda, 45, (2, 256, 4, 80), torch.bfloat16)
    out1 = da.decode_attention_bthd(q, k, v, 100)
    k[:, 100:], v[:, 100:] = 1e4, -1e4
    out2 = da.decode_attention_bthd(q, k, v, 100)
    torch.cuda.synchronize()
    np.testing.assert_array_equal(_np(out1.cpu()), _np(out2.cpu()))


@pytest.mark.requires_cuda
@pytest.mark.parametrize("arch", ["llama4-maverick-400b-a17b", "deepseek-v3-671b"])
def test_moe_models_through_kernels(cuda, arch):
    """A reduced MoE model on the card: its forward launches rmsnorm for
    every norm (two a layer and the final one; MLA's q_a_norm and kv_a_norm
    besides) and flash attention once a layer (MLA with v narrower than q
    and k), llama4's decode steps decode attention once a layer (deepseek's
    absorbed MLA none) and no step makes the host wait for the card (the
    dispatch reads no routing on the host), and prefill + 3 steps equal the forward (f32, the
    reduced capacity factor drops nothing); the MoE FFN on the card equals
    the same on the CPU (f32, 1e-5 of scale); each layer through the
    kernels within 5e-2 of scale of the plain math from the same input."""
    from repro_torch.configs import get_config
    from repro_torch.models import deepseek, moe, transformer as tfm
    from repro_torch.models.common import KERNELS, PLAIN
    from repro_torch.models.model_zoo import build_model

    cfg = get_config(arch).reduced(dtype=torch.float32)
    model = build_model(cfg)
    params = model.init(torch.Generator(device=cuda).manual_seed(0))
    tokens = torch.from_numpy(np.random.default_rng(0).integers(0, cfg.vocab, (2, 40))).to(cuda)
    n_rms, n_fa, n_da = rn.rmsnorm.launches, fa.flash_attention.launches, \
        da.decode_attention.launches
    full = model.forward(params, {"tokens": tokens})
    torch.cuda.synchronize()
    norms = 2 + 2 * cfg.mla
    assert rn.rmsnorm.launches - n_rms == norms * cfg.n_layers + 1
    assert fa.flash_attention.launches - n_fa == cfg.n_layers
    lg, cache = model.prefill(params, {"tokens": tokens[:, :36]}, max_len=40)
    steps = [lg[:, 0]]
    positions = [torch.tensor(i, device=cuda) for i in range(36, 39)]
    torch.cuda.set_sync_debug_mode("error")  # the steps make the host wait for nothing
    try:
        for i, pos in zip(range(36, 39), positions):
            lg, cache = model.decode_step(params, tokens[:, i:i + 1], cache, pos)
            steps.append(lg[:, 0])
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    assert da.decode_attention.launches - n_da == (0 if cfg.mla else 3 * cfg.n_layers)
    np.testing.assert_allclose(_np(torch.stack(steps, 1).cpu()), _np(full[:, 35:39].cpu()),
                               rtol=1e-4, atol=1e-4 * float(full.abs().max()))

    mod = deepseek if cfg.mla else moe
    layers = deepseek.layers(params) if cfg.mla else params["layers"]
    lp = layers[-1]
    x = _on(cuda, 90, (2, 40, cfg.d_model), torch.float32)
    got = moe.moe_ffn(cfg, KERNELS, lp["moe"], x)
    cpu = moe.moe_ffn(cfg, PLAIN, _cpu_tree(lp["moe"]), x.cpu())
    np.testing.assert_allclose(_np(got.cpu()), _np(cpu), rtol=1e-5,
                               atol=1e-5 * float(cpu.abs().max()))
    x = tfm.embed_tokens(cfg, params, tokens)
    pos = tfm.positions_for(x)
    for lp in layers:
        got, _ = mod.layer_full(cfg, KERNELS, lp, x, pos)
        want, _ = mod.layer_full(cfg, PLAIN, lp, x, pos)
        assert (got - want).abs().max() <= 5e-2 * want.abs().max()
        x = got


def _cpu_tree(tree):
    """A ParamTree's leaves copied to the CPU as a nested dict."""
    out = {}
    for name, p in tree.named_parameters(recurse=False):
        out[name] = p.detach().cpu()
    for name, child in tree.named_children():
        out[name] = _cpu_tree(child)
    return out


@pytest.mark.requires_cuda
@pytest.mark.parametrize("B,S,KH,G", [(4, 528, 32, 1), (8, 160, 32, 1), (2, 300, 8, 5),
                                       (1, 1024, 8, 1)])
def test_decode_attention_kernel_is_deterministic(cuda, B, S, KH, G):
    """The splits merge in a fixed order, without float atomics: two calls
    give bit-equal outputs."""
    q = _on(cuda, 60, (B, 1, KH * G, 80), torch.bfloat16)
    k = _on(cuda, 61, (B, S, KH, 80), torch.bfloat16)
    v = _on(cuda, 62, (B, S, KH, 80), torch.bfloat16)
    lens = torch.tensor(S - 3, dtype=torch.int32, device=cuda)
    first = da.decode_attention_bthd(q, k, v, lens)
    again = da.decode_attention_bthd(q, k, v, lens)
    torch.cuda.synchronize()
    np.testing.assert_array_equal(_np(first.cpu()), _np(again.cpu()))


@pytest.mark.requires_cuda
@pytest.mark.parametrize("plan", [(1, 1024, 0), (1, 1024, 1), (2, 512, 0), (2, 512, 1),
                                  (3, 342, 1), (8, 128, 0), (8, 128, 1)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_decode_attention_kernel_every_plan_matches_plain(cuda, plan, dtype):
    """Each split count and block shape computes the same attention: a
    plan that is not `split_plan`'s choice, held to the plain version at a
    kv_len that leaves the last splits partly or wholly empty."""
    q = _on(cuda, 63, (2, 1, 8, 80), dtype)
    k = _on(cuda, 64, (2, 1024, 4, 80), dtype)
    v = _on(cuda, 65, (2, 1024, 4, 80), dtype)
    lens = torch.tensor([700, 1024], dtype=torch.int32, device=cuda)
    got = da.decode_attention_bthd(q, k, v, lens, plan=plan)
    want = da.decode_attention_plain(q, k, v, lens)
    np.testing.assert_allclose(_np(got.cpu()), _np(want.cpu()), **attn_tol(dtype))


@pytest.mark.requires_cuda
def test_decode_attention_kernel_per_row_lengths(cuda):
    """A (B,) kv_len masks each batch row at its own length."""
    q = _on(cuda, 46, (3, 1, 8, 64), torch.bfloat16)
    k = _on(cuda, 47, (3, 96, 4, 64), torch.bfloat16)
    v = _on(cuda, 48, (3, 96, 4, 64), torch.bfloat16)
    lens = torch.tensor([5, 96, 40], dtype=torch.int32, device=cuda)
    got = da.decode_attention_bthd(q, k, v, lens)
    want = da.decode_attention_plain(q, k, v, lens)
    np.testing.assert_allclose(_np(got.cpu()), _np(want.cpu()), **attn_tol(torch.bfloat16))
    for b in range(3):
        row = da.decode_attention_bthd(q[b:b + 1], k[b:b + 1], v[b:b + 1], int(lens[b]))
        np.testing.assert_array_equal(_np(row.cpu()), _np(got[b:b + 1].cpu()))


# -------------------------------------------------------------------- ssd scan

SSD_TOL = dict(atol=5e-4, rtol=2e-3)


def _gates(device, seed, shape, scale=1.0):
    """Realistic decays: log_g = -scale * softplus(N(0, 1))."""
    return -scale * torch.nn.functional.softplus(_on(device, seed, shape, torch.float32))


@pytest.mark.requires_cuda
@pytest.mark.parametrize("B,T,NH,DK,DV,chunk,with_i", [
    (4, 512, 80, 64, 64, 256, False),   # zamba2-2.7b prefill
    (2, 300, 8, 64, 64, 256, False),    # ragged T: a short last chunk
    (2, 128, 3, 16, 32, 32, True),      # tests/test_kernels.py shapes, with log_i
    (1, 256, 2, 32, 16, 64, True),
    (1, 64, 1, 8, 8, 64, True),
])
def test_ssd_scan_kernel_matches_plain(cuda, B, T, NH, DK, DV, chunk, with_i):
    q = _on(cuda, 50, (B, T, NH, DK), torch.float32, 0.5)
    k = _on(cuda, 51, (B, T, NH, DK), torch.float32, 0.5)
    v = _on(cuda, 52, (B, T, NH, DV), torch.float32, 0.5)
    log_g = _gates(cuda, 53, (B, T, NH), 0.05 if chunk == 256 else 1.0)
    log_i = _gates(cuda, 54, (B, T, NH)) if with_i else None
    before = ssd.ssd_scan.launches
    y, state = ssd.ssd_scan_bthd(q, k, v, log_g, log_i, chunk=chunk)
    torch.cuda.synchronize()
    assert ssd.ssd_scan.launches == before + 1
    y_want, s_want = ssd.chunked_linear_attention_plain(q, k, v, log_g, log_i, chunk=chunk)
    np.testing.assert_allclose(_np(y.cpu()), _np(y_want.cpu()), **SSD_TOL)
    np.testing.assert_allclose(_np(state.cpu()), _np(s_want.cpu()), **SSD_TOL)


@pytest.mark.requires_cuda
@pytest.mark.parametrize("T,chunk", [(40, 256),    # T < 64: one short chunk
                                     (200, 128),   # T and the last chunk not multiples of 64
                                     (600, 128),   # five chunks, the last of 88
                                     (256, 32),    # eight chunks shorter than a tile
                                     (300, 100)])  # chunks of 100: a 36-row second tile
@pytest.mark.parametrize("broadcast", [True, False], ids=["broadcast", "per_head"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_ssd_scan_kernel_chunks_and_ragged_t(cuda, T, chunk, broadcast, dtype):
    """Any T and chunk, with q and k broadcast over the heads (head stride
    0) or per head, with log_i: y at the dtype's tolerance, the state at
    the SSD bound in both dtypes."""
    B, NH, D = 2, 5, 64
    if broadcast:
        q = _on(cuda, 70, (B, T, D), dtype, 0.5)[:, :, None].expand(B, T, NH, D)
        k = _on(cuda, 71, (B, T, D), dtype, 0.5)[:, :, None].expand(B, T, NH, D)
    else:
        q = _on(cuda, 70, (B, T, NH, D), dtype, 0.5)
        k = _on(cuda, 71, (B, T, NH, D), dtype, 0.5)
    v = _on(cuda, 72, (B, T, NH, D), dtype, 0.5)
    log_g = _gates(cuda, 73, (B, T, NH), 0.05)
    log_i = _gates(cuda, 74, (B, T, NH))
    before = ssd.ssd_scan.launches
    y, state = ssd.ssd_scan_bthd(q, k, v, log_g, log_i, chunk=chunk)
    torch.cuda.synchronize()
    assert ssd.ssd_scan.launches == before + 1
    y_want, s_want = ssd.chunked_linear_attention_plain(q, k, v, log_g, log_i, chunk=chunk)
    y_tol = SSD_TOL if dtype == torch.float32 else tol(dtype)
    np.testing.assert_allclose(_np(y.cpu()), _np(y_want.cpu()), **y_tol)
    np.testing.assert_allclose(_np(state.cpu()), _np(s_want.cpu()), **SSD_TOL)


@pytest.mark.requires_cuda
@pytest.mark.parametrize("B,T,NH,DK,DV,chunk", [(1, 300, 2, 96, 97, 64),
                                                (2, 200, 3, 128, 40, 64),
                                                (1, 512, 4, 1024, 1025, 256),
                                                (2, 300, 2, 1024, 1025, 256),
                                                (1, 700, 1, 1024, 1025, 256),
                                                (2, 200, 3, 64, 129, 64)],
                         ids=["short_last_chunk", "wide_dk_16_byte_v", "xlstm_1_3b_heads",
                              "xlstm_1_3b_2_heads_ragged", "xlstm_1_3b_1_head_ragged", "dv_129"])
@pytest.mark.parametrize("with_i", [True, False], ids=["log_i", "no_log_i"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_ssd_scan_kernel_wide_states_match_plain(cuda, B, T, NH, DK, DV, chunk, with_i, dtype):
    """State widths past one 64-wide tile, as the mLSTM's (hd, hd + 1) at
    its 4 heads and cut to 1-2 with a ragged T (a short last chunk), DV
    alone past it (129: an odd count of DV tiles), or DK alone past it with
    a v the kernel streams as it lies (bf16 rows of 40): per-head q and k, v
    with a ones column, log_i over the mLSTM's clip range [-30, 10] (decay
    terms to e^30).  y at the dtype's bound (bf16 `tol`, f32 the SSD bound)
    and the state at the SSD bound, each atol scaled by the reference's max
    |value|; two calls bit-equal; one launch counted a call."""
    q = _on(cuda, 90, (B, T, NH, DK), dtype, 0.5)
    k = _on(cuda, 91, (B, T, NH, DK), dtype, 0.5)
    v = _on(cuda, 92, (B, T, NH, DV), dtype, 0.5)
    v[..., -1] = 1.0
    log_g = _gates(cuda, 93, (B, T, NH), 0.05)
    log_i = (torch.from_numpy(np.random.default_rng(94).uniform(-30.0, 10.0, (B, T, NH)))
             .float().to(cuda) if with_i else None)
    before = ssd.ssd_scan.launches
    y, state = ssd.ssd_scan_bthd(q, k, v, log_g, log_i, chunk=chunk)
    y1, state1 = ssd.ssd_scan_bthd(q, k, v, log_g, log_i, chunk=chunk)
    torch.cuda.synchronize()
    assert ssd.ssd_scan.launches == before + 2
    assert torch.equal(y, y1) and torch.equal(state, state1)
    assert y.shape == v.shape and y.dtype == dtype and state.shape == (B, NH, DK, DV)
    y_want, s_want = ssd.chunked_linear_attention_plain(q, k, v, log_g, log_i, chunk=chunk)
    y_tol = SSD_TOL if dtype == torch.float32 else tol(dtype)
    for got, want, t in ((y, y_want, y_tol), (state, s_want, SSD_TOL)):
        got, want = _np(got.cpu()), _np(want.cpu())
        np.testing.assert_allclose(got, want, rtol=t["rtol"],
                                   atol=t["atol"] * float(np.abs(want).max()))


@pytest.mark.requires_cuda
def test_ssd_scan_kernel_refuses_what_it_cannot_take(cuda):
    """A chunk past 4096, or q, k, v of mixed dtypes, raise before any
    launch; nothing falls back to the plain version."""
    z = torch.zeros(1, 8, 2, 64, device=cuda, dtype=torch.bfloat16)
    g = torch.zeros(1, 8, 2, device=cuda)
    before = ssd.ssd_scan.launches
    long = torch.zeros(1, 5000, 2, 64, device=cuda, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="chunk"):
        ssd.ssd_scan_bthd(long, long, long, torch.zeros(1, 5000, 2, device=cuda), chunk=4097)
    with pytest.raises(TypeError, match="dtype"):
        ssd.ssd_scan_bthd(z, z, z.float(), g)
    assert ssd.ssd_scan.launches == before


@pytest.mark.requires_cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_ssd_scan_kernel_is_deterministic(cuda, dtype):
    """Fixed summation order, no atomics: two calls are bit-identical, and
    each call counts one launch."""
    B, T, NH, D = 2, 520, 8, 64
    q = _on(cuda, 75, (B, T, D), dtype, 0.5)[:, :, None].expand(B, T, NH, D)
    k = _on(cuda, 76, (B, T, D), dtype, 0.5)[:, :, None].expand(B, T, NH, D)
    v = _on(cuda, 77, (B, T, NH, D), dtype, 0.5)
    log_g = _gates(cuda, 78, (B, T, NH), 0.05)
    before = ssd.ssd_scan.launches
    y1, s1 = ssd.ssd_scan_bthd(q, k, v, log_g, chunk=256)
    y2, s2 = ssd.ssd_scan_bthd(q, k, v, log_g, chunk=256)
    torch.cuda.synchronize()
    assert ssd.ssd_scan.launches == before + 2
    np.testing.assert_array_equal(_np(y1.cpu()), _np(y2.cpu()))
    np.testing.assert_array_equal(s1.cpu().numpy(), s2.cpu().numpy())


@pytest.mark.requires_cuda
def test_ssd_scan_kernel_reads_broadcast_heads_and_bf16(cuda):
    """Mamba2's q and k are one (B, T, DK) tensor expanded over the heads
    (head stride 0): the kernel reads the view as it is, in bf16, and
    carries the state over four chunks."""
    B, T, NH, D = 2, 200, 6, 64
    c = _on(cuda, 55, (B, T, D), torch.bfloat16)
    bm = _on(cuda, 56, (B, T, D), torch.bfloat16)
    q, k = c[:, :, None].expand(B, T, NH, D), bm[:, :, None].expand(B, T, NH, D)
    v = _on(cuda, 57, (B, T, NH, D), torch.bfloat16)
    log_g = _gates(cuda, 58, (B, T, NH), 0.05)
    y, state = ssd.ssd_scan_bthd(q, k, v, log_g, chunk=64)
    y_want, s_want = ssd.chunked_linear_attention_plain(q, k, v, log_g, chunk=64)
    torch.cuda.synchronize()
    assert y.dtype == torch.bfloat16
    np.testing.assert_allclose(_np(y.cpu()), _np(y_want.cpu()), **tol(torch.bfloat16))
    np.testing.assert_allclose(_np(state.cpu()), _np(s_want.cpu()), **SSD_TOL)


def _ssd_grad_inputs(device, seed, B, T, NH, DK, DV, broadcast, with_i, final):
    """bf16 q, k (broadcast over the heads or per head), v, f32 gates (the
    mLSTM's log_i over its clip range [-30, 10], where D's clip binds), a
    bf16 dy and an f32 final-state cotangent or None."""
    bf16 = torch.bfloat16
    if broadcast:
        q, k = (_on(device, seed + i, (B, T, DK), bf16, 0.5)[:, :, None].expand(B, T, NH, DK)
                for i in range(2))
    else:
        q, k = (_on(device, seed + i, (B, T, NH, DK), bf16, 0.5) for i in range(2))
    v = _on(device, seed + 2, (B, T, NH, DV), bf16, 0.5)
    log_g = _gates(device, seed + 3, (B, T, NH), 0.05)
    log_i = (torch.from_numpy(np.random.default_rng(seed + 4).uniform(-30, 10, (B, T, NH))
                              .astype(np.float32)).to(device) if with_i else None)
    dy = _on(device, seed + 5, (B, T, NH, DV), bf16)
    dstate = _on(device, seed + 6, (B, NH, DK, DV), torch.float32) if final else None
    return q, k, v, log_g, log_i, dy, dstate


@pytest.mark.requires_cuda
@pytest.mark.parametrize("B,T,NH,DK,DV,chunk,broadcast,with_i,final", [
    (2, 256, 6, 64, 64, 64, True, False, False),   # narrow: Mamba2's broadcast q and k
    (1, 256, 2, 128, 129, 128, False, True, False),  # wide: DK 128, DV 129, with log_i
    (2, 300, 3, 32, 48, 128, False, True, True),   # ragged T, a final-state cotangent
    (1, 512, 2, 1024, 1025, 256, False, True, False),  # xlstm-1.3b's mLSTM, 2 heads
    (2, 300, 1, 1024, 1025, 256, False, True, True),   # 1 head, ragged T, a final cotangent
    (1, 200, 3, 128, 129, 64, True, True, True),   # the pairs route with one-head q and k
], ids=["narrow", "wide", "ragged", "xlstm_1_3b_2_heads", "xlstm_1_3b_1_head_ragged_final",
        "wide_one_head_qk"])
def test_ssd_scan_backward_kernel_matches_plain(cuda, B, T, NH, DK, DV, chunk, broadcast,
                                                with_i, final):
    """Each gradient within GRAD_TOL of the plain backward run in f32 from
    the same bf16 inputs, on either route (the pairs route past 64-wide
    states: the mLSTM's at 1-2 heads, log_i over [-30, 10], a ragged T, a
    nonzero final-state cotangent); two calls bit-equal, and bit-equal with
    the forward's scratch kept (`forward_saved`, as `_ScanFn` keeps it) to
    the wrapper's own forward launch; one call counted each."""
    args = _ssd_grad_inputs(cuda, 120, B, T, NH, DK, DV, broadcast, with_i, final)
    before = ssd.ssd_scan_backward.launches
    got = ssd.ssd_scan_backward(*args, chunk=chunk)
    again = ssd.ssd_scan_backward(*args, chunk=chunk)
    saved = ssd.forward_saved(*args[:5], chunk=chunk)
    kept = ssd.ssd_scan_backward(*args, chunk=chunk, saved=saved)
    torch.cuda.synchronize()
    assert ssd.ssd_scan_backward.launches == before + 3
    want = ssd.chunked_linear_attention_backward_plain(
        *(None if t is None else t.float() for t in args), chunk=chunk)
    for name, a, b, c, d in zip(("dq", "dk", "dv", "dlog_g", "dlog_i"), got, want, again, kept):
        if b is None:
            assert a is None and c is None and d is None, name
            continue
        assert a.shape == b.shape, name
        assert_grad_close(a, b, name)
        assert torch.equal(a, c) and torch.equal(a, d), name


@pytest.mark.requires_cuda
def test_ssd_scan_wide_under_grad_keeps_the_forward_scratch(cuda):
    """The mLSTM's call under grad (the pairs route): the forward kernel
    once and, in the backward, the backward kernel once on the kept
    scratch; the leaves' gradients equal a direct backward call's bits."""
    B, T, NH, DK, DV, chunk = 1, 300, 2, 128, 129, 128
    args = _ssd_grad_inputs(cuda, 160, B, T, NH, DK, DV, False, True, False)
    q, k, v, log_g, log_i, dy, _ = args
    assert ssd.backward_plan(B, T, NH, NH, DK, DV, chunk)[0] == "pairs"
    leaves = [t.clone().requires_grad_() for t in (q, k, v, log_g, log_i)]
    f0, b0 = ssd.ssd_scan.launches, ssd.ssd_scan_backward.launches
    y, _ = ssd.ssd_scan_bthd(*leaves, chunk=chunk)
    y.backward(dy)
    torch.cuda.synchronize()
    assert (ssd.ssd_scan.launches, ssd.ssd_scan_backward.launches) == (f0 + 1, b0 + 1)
    want = ssd.ssd_scan_backward(*args, chunk=chunk)
    for name, leaf, w in zip(("dq", "dk", "dv", "dlog_g", "dlog_i"), leaves, want):
        assert torch.equal(leaf.grad, w), name


@pytest.mark.requires_cuda
def test_ssd_scan_under_grad_and_in_a_graph(cuda):
    """bf16 `ssd_scan_bthd` under grad runs the forward kernel and, in the
    backward, the backward kernel once (the broadcast q and k get the sum
    over heads through `expand`'s backward); a CUDA graph's replay of the
    backward equals the eager call."""
    B, T, NH, D = 2, 200, 4, 64
    q, k, v, log_g, _, dy, _ = _ssd_grad_inputs(cuda, 130, B, T, NH, D, D, True, False, False)
    c, bm = (t[:, :, 0].clone().requires_grad_() for t in (q, k))
    vl, gl = v.clone().requires_grad_(), log_g.clone().requires_grad_()
    f0, b0 = ssd.ssd_scan.launches, ssd.ssd_scan_backward.launches
    y, _ = ssd.ssd_scan_bthd(c[:, :, None].expand(B, T, NH, D),
                             bm[:, :, None].expand(B, T, NH, D), vl, gl, chunk=64)
    y.backward(dy)
    torch.cuda.synchronize()
    assert (ssd.ssd_scan.launches, ssd.ssd_scan_backward.launches) == (f0 + 1, b0 + 1)
    want = ssd.chunked_linear_attention_backward_plain(q.float(), k.float(), v.float(), log_g,
                                                       None, dy.float(), None, chunk=64)
    for name, got, w in (("dq", c.grad, want[0].sum(2)), ("dk", bm.grad, want[1].sum(2)),
                         ("dv", vl.grad, want[2]), ("dlog_g", gl.grad, want[3])):
        assert_grad_close(got, w, name)
    args = (q, k, v, log_g, None, dy, None)
    eager = ssd.ssd_scan_backward(*args, chunk=64)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        ssd.ssd_scan_backward(*args, chunk=64)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        static = ssd.ssd_scan_backward(*args, chunk=64)
    graph.replay()
    torch.cuda.synchronize()
    for name, a, b in zip(("dq", "dk", "dv", "dlog_g"), eager, static):
        assert torch.equal(a, b), name


# (B, T, NH, DK, DV, chunk, one_head, with_i, final): the heads route at
# chunks 64, 128 and 256, q and k one head broadcast over the heads (their
# gradients summed by the kernel) or per head, ragged T, a final-state
# cotangent and log_i, each with and without
SSD_HEADS_CASES = {
    "bcast-c256": (2, 512, 12, 64, 64, 256, True, False, False),
    "bcast-c128-ragged-final": (2, 333, 10, 64, 64, 128, True, False, True),
    "bcast-c64-log_i": (1, 200, 7, 64, 64, 64, True, True, False),
    "bcast-narrow-widths": (2, 300, 5, 48, 40, 256, True, True, True),
    "per-head-c128": (2, 256, 4, 64, 64, 128, False, False, True),
    "per-head-c256-ragged-log_i": (1, 700, 3, 32, 64, 256, False, True, False),
    "one-head-short-t": (3, 37, 2, 16, 24, 256, True, False, True),
    "odd-widths": (1, 100, 3, 12, 20, 64, True, True, True),  # q, k, v rows padded to 8
}


@pytest.mark.requires_cuda
@pytest.mark.parametrize("case", list(SSD_HEADS_CASES))
def test_ssd_scan_backward_heads_route_matches_plain(cuda, case):
    """The heads route against the plain backward in f32 at GRAD_TOL; dq and
    dk at q's and k's own shapes (one head: summed over the heads by the
    kernel); two calls bit-equal; one call counted each; with the forward's
    scratch kept (as `_ScanFn` keeps it) bit-equal to the wrapper's own
    forward launch."""
    B, T, NH, DK, DV, chunk, one_head, with_i, final = SSD_HEADS_CASES[case]
    args = list(_ssd_grad_inputs(cuda, 140, B, T, NH, DK, DV, one_head, with_i, final))
    if one_head:
        args[0], args[1] = args[0][:, :, :1], args[1][:, :, :1]
    assert ssd.backward_plan(B, T, NH, 1 if one_head else NH, DK, DV, chunk)[0] == "heads"
    before = ssd.ssd_scan_backward.launches
    got = ssd.ssd_scan_backward(*args, chunk=chunk)
    again = ssd.ssd_scan_backward(*args, chunk=chunk)
    saved = ssd.forward_saved(*args[:5], chunk=chunk)
    kept = ssd.ssd_scan_backward(*args, chunk=chunk, saved=saved)
    torch.cuda.synchronize()
    assert ssd.ssd_scan_backward.launches == before + 3
    want = ssd.chunked_linear_attention_backward_plain(
        *(None if t is None else t.float() for t in args), chunk=chunk)
    for name, a, b, c, d in zip(("dq", "dk", "dv", "dlog_g", "dlog_i"), got, want, again, kept):
        if b is None:
            assert a is None and c is None and d is None, name
            continue
        assert a.shape == b.shape, name
        assert_grad_close(a, b, f"{name} ({case})")
        assert torch.equal(a, c) and torch.equal(a, d), name
    assert got[0].shape == args[0].shape and got[1].shape == args[1].shape


@pytest.mark.requires_cuda
def test_ssd_scan_backward_heads_route_in_a_graph_and_under_grad(cuda):
    """Mamba2's call: one-head q and k under grad run the forward kernel and
    the heads route once, and the leaves get the head-summed gradients
    straight from the kernel (no expand backward); a CUDA graph's replay of
    the backward, with the forward's scratch kept, equals the eager call."""
    B, T, NH, D, chunk = 2, 300, 6, 64, 128
    q, k, v, log_g, _, dy, _ = _ssd_grad_inputs(cuda, 150, B, T, NH, D, D, True, False, False)
    q, k = q[:, :, :1], k[:, :, :1]
    leaves = [t.clone().requires_grad_() for t in (q, k, v, log_g)]
    f0, b0 = ssd.ssd_scan.launches, ssd.ssd_scan_backward.launches
    y, _ = ssd.ssd_scan_bthd(*leaves, chunk=chunk)
    y.backward(dy)
    torch.cuda.synchronize()
    assert (ssd.ssd_scan.launches, ssd.ssd_scan_backward.launches) == (f0 + 1, b0 + 1)
    want = ssd.chunked_linear_attention_backward_plain(q.float(), k.float(), v.float(), log_g,
                                                       None, dy.float(), None, chunk=chunk)
    for name, leaf, w in zip(("dq", "dk", "dv", "dlog_g"), leaves, want):
        assert leaf.grad.shape == leaf.shape, name
        assert_grad_close(leaf.grad, w, name)
    saved = ssd.forward_saved(q, k, v, log_g, chunk=chunk)
    args = (q, k, v, log_g, None, dy, None)
    eager = ssd.ssd_scan_backward(*args, chunk=chunk, saved=saved)
    for name, leaf, a in zip(("dq", "dk", "dv", "dlog_g"), leaves, eager):
        assert torch.equal(leaf.grad.to(a.dtype), a), name
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        ssd.ssd_scan_backward(*args, chunk=chunk, saved=saved)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        static = ssd.ssd_scan_backward(*args, chunk=chunk, saved=saved)
    graph.replay()
    torch.cuda.synchronize()
    for name, a, b in zip(("dq", "dk", "dv", "dlog_g"), eager, static):
        assert torch.equal(a, b), name


@pytest.mark.requires_cuda
def test_ssd_scan_backward_pairs_route_sums_a_one_head_q(cuda):
    """Past the heads route (a chunk of 512 steps) a one-head q and k get
    the pairs route's per-head gradients summed over the heads."""
    B, T, NH, D, chunk = 1, 600, 3, 64, 512
    args = list(_ssd_grad_inputs(cuda, 160, B, T, NH, D, D, True, False, True))
    args[0], args[1] = args[0][:, :, :1], args[1][:, :, :1]
    assert ssd.backward_plan(B, T, NH, 1, D, D, chunk)[0] == "pairs"
    got = ssd.ssd_scan_backward(*args, chunk=chunk)
    want = ssd.chunked_linear_attention_backward_plain(
        *(None if t is None else t.float() for t in args), chunk=chunk)
    torch.cuda.synchronize()
    for name, a, b in zip(("dq", "dk", "dv", "dlog_g"), got, want):
        assert a.shape == b.shape, name
        assert_grad_close(a, b, name)


class _SpinStage:
    """A pipeline stage that keeps the card busy for `cycles` clock cycles."""

    def __init__(self, cycles: int):
        self.cycles = cycles

    def transfer(self, x):
        return x

    def __call__(self, x):
        torch.cuda._sleep(self.cycles)
        return x + 1


@pytest.mark.requires_cuda
def test_dispatcher_stage_walls_follow_the_device(cuda):
    """A stage's measured duration is its own device time, however late the
    host polls: with the chain already done when stage 0 is polled, host
    deltas would give stage 0 the whole chain and stage 1 almost nothing
    (the data plane's feedback then pins its calibration on that and
    inflates the stage's latency, which missed deadlines in served
    traces).  Stage 1 spins four times as long as stage 0."""
    from repro_torch.dataplane import PoolDispatcher

    _SpinStage(1000)(torch.zeros(1, device=cuda))  # first launches load modules
    torch.cuda.synchronize()
    disp = PoolDispatcher({0: [_SpinStage(2_000_000), _SpinStage(8_000_000)]})
    job = disp.submit_chain(0, torch.zeros(4, device=cuda))
    torch.cuda.synchronize()
    w0, w1 = disp.poll_stage(job, 0), disp.poll_stage(job, 1)
    assert w0 > 1e-4 and 3.0 < w1 / w0 < 5.0
    (done,) = disp.drain_all()
    assert done.stage_wall_s == [w0, w1]


@pytest.mark.requires_cuda
@pytest.mark.parametrize("arch", ["stablelm-3b", "qwen3-14b", "zamba2-2.7b"])
def test_prefill_decode_through_kernels(cuda, arch):
    """Reduced models on the card: prefill + decode through the kernels
    launch decode_attention once per attention layer and step (and ssd_scan
    once per Mamba2 block in prefill), and each step's logits match the
    same step through the plain math from the same cache, to 5e-2 of their
    scale."""
    from repro_torch.configs import get_config
    from repro_torch.models.common import KERNELS, PLAIN
    from repro_torch.models.model_zoo import build_model

    cfg = get_config(arch).reduced(head_dim=80, d_model=320)
    model = build_model(cfg)
    params = model.init(torch.Generator(device=cuda).manual_seed(0))
    tokens = torch.from_numpy(np.random.default_rng(0).integers(0, cfg.vocab, (2, 40))).to(cuda)
    n_attn = cfg.ssm_pattern.count("a") if cfg.ssm_pattern else cfg.n_layers
    n_ssd = ssd.ssd_scan.launches
    _, cache = model.prefill(params, {"tokens": tokens}, max_len=44)
    assert ssd.ssd_scan.launches - n_ssd == cfg.ssm_pattern.count("m")
    cur = torch.tensor(40, dtype=torch.int32, device=cuda)
    tok = tokens[:, -1:]
    for _ in range(4):
        plain_cache = {k: (v.clone() if isinstance(v, torch.Tensor)
                           else {n: a.clone() for n, a in v.items()}) for k, v in cache.items()}
        n_da = da.decode_attention.launches
        got, cache = model.decode_step(params, tok, cache, cur)
        assert da.decode_attention.launches - n_da == n_attn
        want, _ = model.decode_step(params, tok, plain_cache, cur, ops=PLAIN)
        torch.cuda.synchronize()
        assert (got.float() - want.float()).abs().max() <= 5e-2 * want.float().abs().max()
        tok, cur = got.argmax(-1), cur + 1
    assert KERNELS.decode_attention is da.decode_attention_bthd


@pytest.mark.requires_cuda
def test_xlstm_layers_through_kernels(cuda):
    """Reduced xlstm-1.3b at d_model 320 (mLSTM state widths 160 x 161, the
    scan's wide path) with its period twice: the prefill launches ssd_scan
    once per mLSTM block, and every block through `KERNELS` matches it
    through `PLAIN` from the same input and state, its full form and its
    decode step, to 5e-2 of the output's scale (chip_smoke.py's per-layer
    bound)."""
    from repro_torch.configs import get_config
    from repro_torch.models import hybrid
    from repro_torch.models import transformer as tfm
    from repro_torch.models.common import KERNELS, PLAIN
    from repro_torch.models.model_zoo import build_model

    base = get_config("xlstm-1.3b").reduced()
    cfg = get_config("xlstm-1.3b").reduced(d_model=320, ssm_pattern=base.ssm_pattern * 2,
                                           n_layers=2 * base.n_layers)
    model = build_model(cfg)
    params = model.init(torch.Generator(device=cuda).manual_seed(0))
    tokens = torch.from_numpy(np.random.default_rng(0).integers(0, cfg.vocab, (2, 40))).to(cuda)
    n_ssd = ssd.ssd_scan.launches
    _, cache = model.prefill(params, {"tokens": tokens}, max_len=41)
    assert ssd.ssd_scan.launches - n_ssd == cfg.ssm_pattern.count("M") == 14

    def close(got, want):
        assert (got.float() - want.float()).abs().max() <= 5e-2 * want.float().abs().max()

    x = tfm.embed_tokens(cfg, params, tokens)
    xd = tfm.embed_tokens(cfg, params, tokens[:, -1:])
    for g, group in enumerate(params["inner"]):
        for j, lp in enumerate(group):
            got, st = hybrid._apply_inner_full(cfg, KERNELS, "M", lp, x, return_state=True)
            want, st0 = hybrid._apply_inner_full(cfg, PLAIN, "M", lp, x, return_state=True)
            close(got, want)
            close(st["ssm"], st0["ssm"])
            state = {name: a[g, j] for name, a in cache["inner"].items()}
            steps = [hybrid._apply_inner_step(cfg, ops, "M", lp, xd, state)[0]
                     for ops in (KERNELS, PLAIN)]
            close(*steps)
            x, xd = got, steps[0]
        lp = params["outer"][g]
        got, _ = hybrid._apply_slstm_full(cfg, KERNELS, lp, x)
        close(got, hybrid._apply_slstm_full(cfg, PLAIN, lp, x)[0])
        state = {name: a[g] for name, a in cache["outer"].items()}
        steps = [hybrid._apply_slstm_step(cfg, ops, lp, xd, state)[0] for ops in (KERNELS, PLAIN)]
        close(*steps)
        x, xd = got, steps[0]
    torch.cuda.synchronize()


# ------------------------------------------------- stages as CUDA graphs

# a reduced stablelm-3b (head_dim 80 as served) on a 2-stage pooled plan of
# batch 4: buckets 1, 2 and 4 of either stage are captured at deploy
_GRAPH_MODEL = "stablelm-3b"
_GRAPH_REDUCED = dict(n_layers=4, head_dim=80, d_model=320)
_GRAPH_SEQ = 16


def _graph_session(cuda):
    from repro_torch.api import ClusterSpec, ModelSpec, ServeConfig, Session
    from repro_torch.core import costmodel as cm
    from repro_torch.core.plan import ClusterPlan, PipelinePlan, StagePlan

    cfg = ServeConfig(cluster=ClusterSpec(counts={"h100": 1, "l4": 4}),
                      models=(ModelSpec(arch=_GRAPH_MODEL, reduced=dict(_GRAPH_REDUCED),
                                        n_blocks=4, seq_len=_GRAPH_SEQ, slo_scale=20.0),),
                      serve_seq_len=_GRAPH_SEQ)
    session = Session.from_config(cfg, device=cuda)
    session.profile()
    prof = session.store.profiles[_GRAPH_MODEL]
    tbl = session.store.analytic_table(_GRAPH_MODEL)
    n, bs = prof.n_blocks, 4

    def staged(cut):
        return ClusterPlan(cluster=cfg.cluster, pipelines=[PipelinePlan(
            model_name=_GRAPH_MODEL, batch_size=bs,
            stages=(StagePlan(0, cut, "l4", 1, 2, tbl.partition(0, cut, "l4", 1, bs)),
                    StagePlan(cut, n, "h100", 1, 1, tbl.partition(cut, n, "h100", 1, bs))),
            xfer_latency_s=(cm.transfer_latency(prof, cfg.cluster, "l4", "h100", cut, bs),),
        )])

    plan_a, plan_b = staged(n // 2), staged(n // 2 + 1)
    session.use_plan(plan_a)
    session.deploy(mode="real")
    return session, plan_a, plan_b


def _tokens(cuda, seed, b):
    rng = np.random.default_rng(seed)
    return torch.from_numpy(rng.integers(0, 512, (b, _GRAPH_SEQ))).to(cuda)


def _eager_chain(execs, tokens):
    with torch.inference_mode():
        x = tokens
        for ex in execs:
            x = ex.stage_fn(ex.params, x)
        return x


@pytest.mark.requires_cuda
def test_stage_graphs_replay_equal_eager(cuda):
    """deploy("real") captures one graph per stage and bucket (1, 2, 4);
    a replay at every bucket of both stages is bit-equal to the stage run
    eagerly (`stage_fn`) on the same input: the same kernels at the same
    shapes.  No call misses a graph, and the replays count the kernels'
    launches the graphs recorded."""
    from repro_torch.serving.engine import GRAPH_STATS

    session, plan_a, _ = _graph_session(cuda)
    execs = session.dataplane.dispatcher.executors[0]
    assert [sorted(k[0][0] for k in ex.graphs) for ex in execs] == [[1, 2, 4], [1, 2, 4]]
    GRAPH_STATS.reset()
    for b in (1, 2, 4):
        x = _tokens(cuda, b, b)
        for ex in execs:
            with torch.inference_mode():
                want = ex.stage_fn(ex.params, x)
            got = ex(x)
            torch.cuda.synchronize()
            assert got.shape == want.shape and torch.equal(got, want)
            x = got
    assert GRAPH_STATS.misses == 0 and GRAPH_STATS.replays == 6
    cfg = session._cfgs[_GRAPH_MODEL]
    assert GRAPH_STATS.replayed["flash_attention"] == 3 * cfg.n_layers
    assert GRAPH_STATS.replayed["rmsnorm"] == 3 * (2 * cfg.n_layers + 1)
    session.shutdown()


@pytest.mark.requires_cuda
def test_stage_capture_survives_a_graph_left_to_the_collector(cuda):
    """A CUDA graph left in a reference cycle is freed by the next
    collection; destroyed on the capturing thread mid-capture, it would
    invalidate the capture (CUDA refuses the call).  With a collection due
    at almost every allocation and such a cycle made inside the captured
    stage, the capture holds (the collector is paused through it) and the
    replay equals the stage run eagerly."""
    import gc

    from repro_torch.serving.engine import StageExecutor

    def spare_graph():
        g, y = torch.cuda.CUDAGraph(), torch.zeros(4, device=cuda)
        s = torch.cuda.Stream(cuda)
        s.wait_stream(torch.cuda.current_stream(cuda))
        with torch.cuda.stream(s):
            g.capture_begin(capture_error_mode="thread_local")
            y.add_(1)
            g.capture_end()
        torch.cuda.synchronize()
        return g

    spare = [spare_graph()]

    def stage_fn(params, x):
        if spare:  # garbage that only a collection frees
            cycle = {"graph": spare.pop()}
            cycle["self"] = cycle
            del cycle
        return x * 2 + 1

    ex = StageExecutor(stage_fn, None, device=cuda)
    x = torch.arange(8, device=cuda, dtype=torch.float32)
    stream = torch.cuda.Stream(cuda)
    stream.wait_stream(torch.cuda.current_stream(cuda))
    thresholds = gc.get_threshold()
    gc.collect()
    gc.set_threshold(1, 1, 1)
    try:
        with torch.cuda.stream(stream):
            ex.capture(x)
        stream.synchronize()
    finally:
        gc.set_threshold(*thresholds)
    assert gc.isenabled() and not spare
    gc.collect()  # the cycle's graph, destroyed outside any capture
    got = ex(x)
    torch.cuda.synchronize()
    assert torch.equal(got, x * 2 + 1)


@pytest.mark.requires_cuda
def test_stage_graphs_five_chains_in_flight(cuda):
    """Five batches with different tokens enqueued through both stages
    before any is read (the dispatcher's in-flight window): each final
    output equals its own eager chain, so no replay's static output is
    seen by another batch."""
    from repro_torch.dataplane import PoolDispatcher

    session, _, _ = _graph_session(cuda)
    execs = session.dataplane.dispatcher.executors[0]
    inputs = [_tokens(cuda, 100 + i, 4) for i in range(5)]
    outs = []
    for x in inputs:
        for ex in execs:
            x = ex(x)
        outs.append(x)
    disp = PoolDispatcher({0: execs}, max_inflight=5)
    jobs = [disp.submit_chain(0, x) for x in inputs]
    assert disp.inflight == 5
    done = disp.drain_all()
    assert [c.job_id for c in done] == jobs
    torch.cuda.synchronize()
    for x, got in zip(inputs, outs):
        assert torch.equal(got, _eager_chain(execs, x))
    session.shutdown()


@pytest.mark.requires_cuda
def test_stage_graphs_capture_while_serving(cuda):
    """prepare_swap captures the new plan's stages on its background thread
    (thread-local capture on its own stream) while this thread replays the
    live plan's graphs: no capture or sync error, the replays meanwhile
    equal their eager results, and so do the new plan's graphs.  The swap
    retires the old epoch, whose GC releases the graphs no plan serves
    with."""
    from repro_torch.serving.engine import GRAPH_STATS

    session, plan_a, plan_b = _graph_session(cuda)
    old = session.dataplane.dispatcher.executors[0]
    x = _tokens(cuda, 7, 4)
    want = _eager_chain(old, x)
    captures = GRAPH_STATS.captures
    prep = session.prepare_swap(plan_b)
    replays, deadline = 0, time.monotonic() + 300
    while not prep.ready() or replays < 20:
        assert time.monotonic() < deadline, "the background warm did not finish"
        y = x
        for ex in old:
            y = ex(y)
        # this stream only: a device-wide synchronisation is refused while
        # another thread captures
        torch.cuda.current_stream().synchronize()
        assert torch.equal(y, want)
        replays += 1
    prep.wait()
    assert GRAPH_STATS.captures == captures + 6
    rec = session.swap(plan_b, now=session._vnow + 1.0, reason="repartition")
    assert rec.prepared and session.telemetry.epochs_gcd == 1
    new = session.dataplane.dispatcher.executors[0]
    assert all(not ex.graphs for ex in old) and all(len(ex.graphs) == 3 for ex in new)
    for b in (1, 2, 4):
        x = _tokens(cuda, 20 + b, b)
        y = x
        for ex in new:
            y = ex(y)
        torch.cuda.synchronize()
        assert torch.equal(y, _eager_chain(new, x))
    session.shutdown()


# ---------------------------------------------------------------- training


@pytest.mark.requires_cuda
@pytest.mark.parametrize("N,D", [(4096, 1536), (512, 512), (8192, 1536), (1024, 2560),
                                 (1000, 1536), (77, 128), (333, 264), (5, 5120), (129, 1000)])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "f32"])
def test_rmsnorm_backward_kernel_matches_plain(cuda, N, D, dtype):
    """dx and dw against the plain backward run in f32 from the same inputs,
    each within `GRAD_TOL` of the f32 result's max |value|: the rows of one
    micro-batch of qwen2-1.5b (4 x 1024) and of `train_small` (4 x 128),
    twice qwen2-1.5b's rows, the serve's shape, ragged row counts, narrow
    rows, a D that is not a multiple of the vector (element-wise loads);
    bit-equal run to run (the dw partials are summed in a fixed order)."""
    x = _on(cuda, 80, (N, D), dtype, 3.0)
    w = _on(cuda, 81, (D,), dtype)
    dy = _on(cuda, 82, (N, D), dtype)
    before = rn.rmsnorm_backward.launches
    dx, dw = rn.rmsnorm_backward(x, w, dy)
    dx2, dw2 = rn.rmsnorm_backward(x, w, dy)
    torch.cuda.synchronize()
    assert rn.rmsnorm_backward.launches == before + 2
    want_dx, want_dw = rn.rmsnorm_backward_plain(x.float(), w.float(), dy.float())
    assert dx.dtype == dtype and dw.dtype == dtype
    assert_grad_close(dx, want_dx, "dx")
    assert_grad_close(dw, want_dw, "dw")
    assert torch.equal(dx, dx2) and torch.equal(dw, dw2)


@pytest.mark.requires_cuda
@pytest.mark.parametrize("N,D", [(1, 1536), (5, 1536),       # one row; fewer rows than a block's warps
                                 (4097, 1536), (263, 512),   # rows no multiple of a block's
                                 (3, 2560), (1001, 4096),    # two and four warps a row
                                 (2, 8192),                  # f32: 8 warps of 8 vectors a row
                                 (17, 1000), (40, 6)])       # element-wise: D no multiple of 8
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "f32"])
def test_rmsnorm_backward_kernel_edges(cuda, N, D, dtype):
    """The one-launch backward where its plan has edges: within `GRAD_TOL`
    of the f32 plain backward, bit-equal run to run, one launch a call; its
    grid at most the blocks the card holds at once."""
    x = _on(cuda, 86, (N, D), dtype, 3.0)
    w = _on(cuda, 87, (D,), dtype)
    dy = _on(cuda, 88, (N, D), dtype)
    before = rn.rmsnorm_backward.launches
    dx, dw = rn.rmsnorm_backward(x, w, dy)
    dx2, dw2 = rn.rmsnorm_backward(x, w, dy)
    torch.cuda.synchronize()
    assert rn.rmsnorm_backward.launches == before + 2
    want_dx, want_dw = rn.rmsnorm_backward_plain(x.float(), w.float(), dy.float())
    assert_grad_close(dx, want_dx, "dx")
    assert_grad_close(dw, want_dw, "dw")
    assert torch.equal(dx, dx2) and torch.equal(dw, dw2)
    vec = rn.vector_loads(x, w, dx)
    lanes, vpt, threads = rn.backward_shape(D, x.element_size(), vec)
    per_sm = rn.backward_blocks_per_sm(D, _lib.dtype_code(x), lanes, vpt, int(vec), threads,
                                       cuda.index)
    plan = rn.backward_plan(N, D, x.element_size(), _lib.sm_count(cuda.index), per_sm, vec)
    assert plan.grid <= _lib.sm_count(cuda.index) * per_sm


@pytest.mark.requires_cuda
@pytest.mark.parametrize("offset", [1, 3])
def test_rmsnorm_backward_kernel_unaligned_view(cuda, offset):
    """x, dy and w as views at an element offset (bases off 16 bytes): the
    element-wise loads, against the plain backward."""
    N, D = 300, 1536
    x = _on(cuda, 89, (N * D + offset,), torch.bfloat16, 3.0)[offset:].view(N, D)
    dy = _on(cuda, 90, (N * D + offset,), torch.bfloat16)[offset:].view(N, D)
    w = _on(cuda, 91, (D + offset,), torch.bfloat16)[offset:]
    assert x.data_ptr() % 16 and not rn.vector_loads(x, w, x)
    dx, dw = rn.rmsnorm_backward(x, w, dy)
    torch.cuda.synchronize()
    want_dx, want_dw = rn.rmsnorm_backward_plain(x.float(), w.float(), dy.float())
    assert_grad_close(dx, want_dx, "dx")
    assert_grad_close(dw, want_dw, "dw")


@pytest.mark.requires_cuda
@pytest.mark.parametrize("N,D", [(4096, 1536), (512, 512)])
def test_rmsnorm_backward_replays_bit_equal_in_a_graph(cuda, N, D):
    """The cooperative launch is captured into a CUDA graph; each replay
    (three, on new inputs copied in) equals the eager call bit for bit."""
    x = _on(cuda, 92, (N, D), torch.bfloat16, 3.0)
    w = _on(cuda, 93, (D,), torch.bfloat16)
    dy = _on(cuda, 94, (N, D), torch.bfloat16)
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        rn.rmsnorm_backward(x, w, dy)  # warm: the library, the occupancy, the counter
    torch.cuda.current_stream().wait_stream(stream)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=stream):
        dx, dw = rn.rmsnorm_backward(x, w, dy)
    for seed in (95, 96, 97):
        x.copy_(_on(cuda, seed, (N, D), torch.bfloat16, 3.0))
        dy.copy_(_on(cuda, seed + 10, (N, D), torch.bfloat16))
        graph.replay()
        want_dx, want_dw = rn.rmsnorm_backward(x, w, dy)
        torch.cuda.synchronize()
        assert torch.equal(dx, want_dx) and torch.equal(dw, want_dw)


@pytest.mark.requires_cuda
def test_rmsnorm_under_grad_goes_through_its_backward(cuda):
    """With an input that requires a gradient the wrapper launches the
    forward through its autograd.Function; backward() launches the backward
    kernel and gives the plain backward's gradients."""
    x = _on(cuda, 83, (4, 64, 1536), torch.bfloat16).requires_grad_()
    w = _on(cuda, 84, (1536,), torch.bfloat16).requires_grad_()
    f0, b0 = rn.rmsnorm.launches, rn.rmsnorm_backward.launches
    y = rn.rmsnorm(x, w)
    assert y.grad_fn is not None and rn.rmsnorm.launches == f0 + 1
    dy = _on(cuda, 85, y.shape, torch.bfloat16)
    y.backward(dy)
    torch.cuda.synchronize()
    assert rn.rmsnorm_backward.launches == b0 + 1
    want_dx, want_dw = rn.rmsnorm_backward_plain(x.detach().float(), w.detach().float(),
                                                 dy.float())
    assert_grad_close(x.grad, want_dx, "dx")
    assert_grad_close(w.grad, want_dw, "dw")


@pytest.mark.requires_cuda
@pytest.mark.parametrize("B,H,KH,S,D", [(4, 12, 2, 1024, 128),  # qwen2-1.5b's train shape
                                        (2, 8, 8, 512, 128),    # G = 1
                                        (2, 12, 2, 1000, 128),  # ragged S
                                        (1, 8, 1, 300, 64),     # G = 8
                                        (2, 4, 2, 70, 80),      # D 80: a zero-padded k-step
                                        (1, 2, 1, 1, 32),       # one token
                                        (3, 4, 4, 190, 40),
                                        (1, 5, 1, 200, 128),    # clusters of 5, 6 and 7:
                                        (2, 12, 2, 333, 64),    # rows a rank not a power
                                        (1, 14, 2, 257, 128),   # of two
                                        (1, 16, 2, 1000, 128),  # G = 8, S no multiple of 64
                                        (2, 8, 1, 50, 64),      # G = 8, S under one key tile
                                        (1, 6, 3, 515, 40),     # D 40: one zero-padded panel
                                        (2, 8, 2, 384, 80)])    # D 80: two panels
def test_flash_attention_backward_kernel_matches_plain(cuda, B, H, KH, S, D):
    """The LSE forward's output equals `fa_forward`'s bit for bit and its lse
    the plain one; dq, dk and dv against the plain backward run in f32,
    each within `GRAD_TOL` of the f32 result's max |value|; bit-equal run
    to run (no atomics)."""
    dtype = torch.bfloat16
    q = _on(cuda, 90, (B, H, S, D), dtype)
    k = _on(cuda, 91, (B, KH, S, D), dtype)
    v = _on(cuda, 92, (B, KH, S, D), dtype)
    dout = _on(cuda, 93, (B, H, S, D), dtype)
    scale = D ** -0.5
    o = torch.empty_like(q)
    lse = fa.flash_attention_forward_lse(q, k, v, o, scale)
    direct = fa.flash_attention(q, k, v)
    grads = [torch.empty_like(t) for t in (q, k, v)]
    again = [torch.empty_like(t) for t in (q, k, v)]
    fa.flash_attention_backward(q, k, v, o, dout, lse, *grads, scale)
    fa.flash_attention_backward(q, k, v, o, dout, lse, *again, scale)
    torch.cuda.synchronize()
    assert torch.equal(o, direct)
    torch.testing.assert_close(lse, fa.flash_attention_lse_plain(q, k), atol=1e-4, rtol=1e-5)
    for name, got, want, rerun in zip(("dq", "dk", "dv"), grads,
                                      flash_grads_f32(q, k, v, dout), again):
        assert_grad_close(got, want, name)
        assert torch.equal(got, rerun), name


@pytest.mark.requires_cuda
@pytest.mark.parametrize("B,H,KH,S,D", [(4, 12, 2, 1024, 128), (2, 6, 6, 200, 64)])
def test_flash_attention_backward_replays_bit_equal_in_a_graph(cuda, B, H, KH, S, D):
    """The backward captured in a CUDA graph (its scratch from the graph's
    pool, its maps as kernel parameters) and replayed three times, on
    inputs copied into the captured tensors, gives gradients bit-equal to
    the eager call's."""
    dtype = torch.bfloat16
    q = _on(cuda, 100, (B, H, S, D), dtype)
    k = _on(cuda, 101, (B, KH, S, D), dtype)
    v = _on(cuda, 102, (B, KH, S, D), dtype)
    dout = _on(cuda, 103, (B, H, S, D), dtype)
    scale = D ** -0.5
    o = torch.empty_like(q)
    lse = fa.flash_attention_forward_lse(q, k, v, o, scale)
    eager = [torch.empty_like(t) for t in (q, k, v)]
    fa.flash_attention_backward(q, k, v, o, dout, lse, *eager, scale)
    graphed = [torch.empty_like(t) for t in (q, k, v)]
    graph = torch.cuda.CUDAGraph()
    before = fa.flash_attention_backward.launches
    with torch.cuda.graph(graph):
        fa.flash_attention_backward(q, k, v, o, dout, lse, *graphed, scale)
    assert fa.flash_attention_backward.launches == before + 1  # counted at capture
    for i in range(3):
        for t in graphed:
            t.fill_(float("nan"))
        dout.copy_(_on(cuda, 104 + i, dout.shape, dtype))
        fa.flash_attention_backward(q, k, v, o, dout, lse, *eager, scale)
        graph.replay()
        torch.cuda.synchronize()
        for name, got, want in zip(("dq", "dk", "dv"), graphed, eager):
            assert torch.equal(got, want), (name, i)
    del graph


@pytest.mark.requires_cuda
@pytest.mark.parametrize("B,H,KH,S,D", [(4, 12, 2, 1024, 128), (2, 8, 8, 1024, 128),
                                        (4, 8, 2, 128, 64), (1, 16, 2, 1000, 128),
                                        (1, 14, 2, 257, 80), (3, 5, 1, 64, 40)])
def test_flash_attention_backward_launch_follows_its_plan(cuda, B, H, KH, S, D):
    """The launch shape the source chooses from the card's cluster occupancy
    (the query heads a dK/dV item walks among it) equals `backward_plan`'s
    from the same occupancy."""
    dev = torch.cuda.current_device()
    plan = fa.backward_plan(B, H, KH, S, S, D, _lib.sm_count(dev),
                            fa._clusters_at_once(H // KH, D, dev))
    assert fa.backward_plan_on_card(B, H, KH, S, S, D) == plan.as_tuple()


# (B, H, KH, Sq, Sk, D, causal) of the backward at lengths of their own
FLASH_GRAD_LENGTHS = [
    (4, 16, 16, 1024, 1024, 64, False),  # seamless-m4t-large-v2's encoder
    (4, 16, 16, 256, 1024, 64, False),   # its cross-attention in training
    (2, 8, 2, 33, 1000, 64, False),      # ragged, G = 4
    (2, 4, 4, 100, 300, 32, False),      # G = 1
    (1, 8, 4, 1, 70, 64, False),         # one query, G = 2
    (2, 12, 2, 33, 129, 128, False),     # G = 6, Sq 33
    (1, 12, 2, 300, 77, 80, False),      # Sq > Sk, G = 6
    (1, 4, 4, 130, 130, 64, False),      # Sq == Sk, ragged
    (2, 16, 4, 300, 1000, 128, True),    # causal Sq < Sk: key tiles past Sq meet no query
    (2, 16, 4, 1000, 300, 64, True),     # causal Sq > Sk: rows past Sk see every key
    (1, 4, 2, 2, 200, 64, True),         # causal, two queries: keys 0 and 1 alone get gradients
    (2, 6, 1, 33, 500, 40, True),        # causal, G = 6, Sq 33
    # G = 1 up to head_dim 64: the persistent walk of 128-key items, each
    # warpgroup the whole chain for 64 of them
    (2, 4, 4, 70, 130, 64, True),        # causal Sq < Sk: item 1's keys 128, 129 meet no query
    (2, 4, 4, 300, 77, 64, True),        # causal Sq > Sk: the second warpgroup's 13 keys
    (1, 6, 6, 200, 64, 64, False),       # Sk 64: the second warpgroup's keys all past Sk
    (3, 5, 5, 129, 333, 48, False),      # ragged both ways, a zero-padded panel
    (2, 3, 3, 257, 200, 16, True),       # head_dim 16, Sq > Sk
    (1, 8, 8, 1000, 1000, 64, True)]     # 64 items over the card's SMs, causal diagonal


@pytest.mark.requires_cuda
@pytest.mark.parametrize("B,H,KH,Sq,Sk,D,causal", FLASH_GRAD_LENGTHS)
def test_flash_attention_backward_kernel_at_any_lengths(cuda, B, H, KH, Sq, Sk, D, causal):
    """Sq != Sk and the non-causal mask: the LSE forward's output equals
    `fa_forward`'s bit for bit and its lse the plain one; dq, dk and dv,
    written over NaN (every element must be stored, the zero dK and dV of
    keys no query sees included), against the plain backward run in f32
    within `GRAD_TOL`; bit-equal run to run."""
    dtype = torch.bfloat16
    q = _on(cuda, 120, (B, H, Sq, D), dtype)
    k = _on(cuda, 121, (B, KH, Sk, D), dtype)
    v = _on(cuda, 122, (B, KH, Sk, D), dtype)
    dout = _on(cuda, 123, (B, H, Sq, D), dtype)
    scale = D ** -0.5
    o = torch.empty_like(q)
    lse = fa.flash_attention_forward_lse(q, k, v, o, scale, causal)
    direct = fa.flash_attention(q, k, v, causal)
    grads = [torch.full_like(t, float("nan")) for t in (q, k, v)]
    again = [torch.full_like(t, float("nan")) for t in (q, k, v)]
    fa.flash_attention_backward(q, k, v, o, dout, lse, *grads, scale, causal)
    fa.flash_attention_backward(q, k, v, o, dout, lse, *again, scale, causal)
    torch.cuda.synchronize()
    assert torch.equal(o, direct)
    torch.testing.assert_close(lse, fa.flash_attention_lse_plain(q, k, causal=causal),
                               atol=1e-4, rtol=1e-5)
    for name, got, want, rerun in zip(("dq", "dk", "dv"), grads,
                                      flash_grads_f32(q, k, v, dout, causal), again):
        assert torch.isfinite(got).all(), name
        assert_grad_close(got, want, name)
        assert torch.equal(got, rerun), name
    if causal and Sq < Sk:  # keys at or past Sq meet no query
        assert not grads[1][:, :, Sq:].any() and not grads[2][:, :, Sq:].any()


@pytest.mark.requires_cuda
@pytest.mark.parametrize("B,H,KH,Sq,Sk,D,causal", [FLASH_GRAD_LENGTHS[i]
                                                     for i in (0, 1, 2, 8, 12, 13, 14, 15)])
def test_flash_attention_backward_at_any_lengths_replays_bit_equal(cuda, B, H, KH, Sq, Sk, D,
                                                                   causal):
    """Captured in a CUDA graph and replayed on new cotangents copied in,
    the backward's gradients equal the eager call's bit for bit."""
    dtype = torch.bfloat16
    q = _on(cuda, 130, (B, H, Sq, D), dtype)
    k = _on(cuda, 131, (B, KH, Sk, D), dtype)
    v = _on(cuda, 132, (B, KH, Sk, D), dtype)
    dout = _on(cuda, 133, (B, H, Sq, D), dtype)
    scale = D ** -0.5
    o = torch.empty_like(q)
    lse = fa.flash_attention_forward_lse(q, k, v, o, scale, causal)
    eager = [torch.empty_like(t) for t in (q, k, v)]
    fa.flash_attention_backward(q, k, v, o, dout, lse, *eager, scale, causal)
    graphed = [torch.empty_like(t) for t in (q, k, v)]
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        fa.flash_attention_backward(q, k, v, o, dout, lse, *graphed, scale, causal)
    for i in range(2):
        for t in graphed:
            t.fill_(float("nan"))
        dout.copy_(_on(cuda, 134 + i, dout.shape, dtype))
        fa.flash_attention_backward(q, k, v, o, dout, lse, *eager, scale, causal)
        graph.replay()
        torch.cuda.synchronize()
        for name, got, want in zip(("dq", "dk", "dv"), graphed, eager):
            assert torch.equal(got, want), (name, i)
    del graph


@pytest.mark.requires_cuda
@pytest.mark.parametrize("B,H,KH,Sq,Sk,D,causal", FLASH_GRAD_LENGTHS)
def test_flash_attention_backward_at_any_lengths_follows_its_plan(cuda, B, H, KH, Sq, Sk, D,
                                                                  causal):
    """The source's launch shape counts the walk it launches, as
    `backward_plan` does: its cluster, keys an item, stages, K/V buffers,
    shared memory, the persistent walk and its chunks, dQ's walk."""
    dev = torch.cuda.current_device()
    plan = fa.backward_plan(B, H, KH, Sq, Sk, D, _lib.sm_count(dev),
                            fa._clusters_at_once(H // KH, D, dev), causal)
    assert fa.backward_plan_on_card(B, H, KH, Sq, Sk, D, causal) == plan.as_tuple()


@pytest.mark.requires_cuda
@pytest.mark.parametrize("B,H,KH,Sq,Sk,D,Dv,causal", [
    (4, 16, 16, 1024, 1024, 64, 64, False),    # seamless-m4t-large-v2's encoder
    (4, 16, 16, 256, 256, 64, 64, True),       # its decoder
    (4, 128, 128, 1024, 1024, 192, 128, True),  # deepseek-v3's MLA: chunks of 38 pairs
    (4, 12, 2, 1024, 1024, 128, 128, True),    # qwen2-1.5b: clusters of two
    (2, 8, 2, 512, 512, 192, 192, False),      # one K/V buffer, two stages
    (1, 11, 1, 300, 300, 80, 80, True)])       # a prime G past 8: persistent, 11 heads an item
def test_flash_attention_backward_plan_on_card(cuda, B, H, KH, Sq, Sk, D, Dv, causal):
    """`fa_backward_plan`, the launch shape the source computes on this
    card, equals `backward_plan`'s from the card's cluster occupancy, v at
    its own width."""
    dev = torch.cuda.current_device()
    plan = fa.backward_plan(B, H, KH, Sq, Sk, D, _lib.sm_count(dev),
                            fa._clusters_at_once(H // KH, D, dev, Dv), causal, Dv)
    assert fa.backward_plan_on_card(B, H, KH, Sq, Sk, D, causal, Dv) == plan.as_tuple()


@pytest.mark.requires_cuda
@pytest.mark.parametrize("Tq,Tk,H,KH,causal", [(1024, 1024, 16, 16, False),  # the encoder
                                               (256, 1024, 16, 16, False),   # cross-attention
                                               (33, 1000, 8, 2, False),
                                               (300, 1000, 16, 4, True)])
def test_attention_bthd_under_grad_at_any_lengths(cuda, Tq, Tk, H, KH, causal):
    """The enc-dec's calls under `torch.autograd.grad`: `attention_bthd(...,
    causal=False)` self- and cross-attention (and a causal Sq < Sk) through
    `_FlashFn`, one LSE forward and one backward call, the gradients in the
    inputs' layout within `GRAD_TOL` of autograd of the plain version in
    f32."""
    dtype = torch.bfloat16
    q = _on(cuda, 140, (2, Tq, H, 64), dtype).requires_grad_()
    k = _on(cuda, 141, (2, Tk, KH, 64), dtype).requires_grad_()
    v = _on(cuda, 142, (2, Tk, KH, 64), dtype).requires_grad_()
    f0, l0, b0 = (fa.flash_attention.launches, fa.flash_attention_forward_lse.launches,
                  fa.flash_attention_backward.launches)
    out = fa.attention_bthd(q, k, v, causal=causal)
    dout = _on(cuda, 143, out.shape, dtype)
    got = torch.autograd.grad(out, (q, k, v), dout)
    torch.cuda.synchronize()
    assert (fa.flash_attention.launches, fa.flash_attention_forward_lse.launches,
            fa.flash_attention_backward.launches) == (f0, l0 + 1, b0 + 1)
    leaves = [t.detach().float().requires_grad_() for t in (q, k, v)]
    want_out = fa.flash_attention_plain(*(t.transpose(1, 2) for t in leaves),
                                        causal).transpose(1, 2)
    want = torch.autograd.grad(want_out, leaves, dout.float())
    for name, t, g, w in zip(("dq", "dk", "dv"), (q, k, v), got, want):
        assert g.shape == t.shape and g.stride() == t.stride(), name
        assert_grad_close(g, w, name)
    torch.testing.assert_close(out.detach().float(), want_out.detach(), **attn_tol(dtype))


@pytest.mark.requires_cuda
@pytest.mark.parametrize("D", [128, 64])
def test_flash_attention_backward_clusters_fit(cuda, D):
    """At the dK/dV kernel's shared memory and threads the card holds at
    least one cluster of every size the route launches, 1 to 8."""
    for G in range(1, fa.MAX_CLUSTER + 1):
        assert fa.backward_max_clusters(G, D) >= 1, G


@pytest.mark.requires_cuda
@pytest.mark.parametrize("D,Dv", [(192, 128), (192, 192)])
def test_flash_attention_backward_clusters_fit_at_head_dim_192(cuda, D, Dv):
    """The (192, 128) instance (three stages, dK's third panel in shared
    memory) and the (192, 192) one (two stages) fit clusters of 1 to 8."""
    for C in range(1, fa.MAX_CLUSTER + 1):
        assert fa.backward_max_clusters(C, D, Dv) >= 1, C


# (B, H, KH, Sq, Sk, D, Dv, causal) of the backward at MLA's widths, past
# 8 query heads a KV head, and at head_dim 192 with v as wide
FLASH_GRAD_WIDE = [
    (1, 16, 16, 256, 256, 192, 128, True),   # MLA's widths: q and k 128 + 64, v 128
    (2, 8, 2, 33, 1000, 192, 128, False),    # ragged, non-causal
    (1, 18, 1, 130, 130, 192, 128, True),    # G = 18 at MLA's widths
    (2, 32, 2, 1024, 1024, 128, 128, True),  # G = 16
    (1, 11, 1, 300, 300, 64, 64, True),      # G = 11, prime: a block walks all 11 heads
    (2, 8, 2, 512, 512, 192, 192, False),    # D = Dv = 192, the two-stage instance
    (1, 4, 2, 200, 200, 136, 136, True)]     # head_dim 136: the 192 instance, a partial panel


@pytest.mark.requires_cuda
@pytest.mark.parametrize("B,H,KH,Sq,Sk,D,Dv,causal", FLASH_GRAD_WIDE)
def test_flash_attention_backward_at_wide_heads_and_large_groups(cuda, B, H, KH, Sq, Sk, D, Dv,
                                                                 causal):
    """v, o, dout and dv Dv wide beside q and k of D (the forward's v
    zero-padded to D, as `_FlashFn` pads it), or G past 8: dq, dk and dv,
    written over NaN, against the plain backward run in f32 within
    `GRAD_TOL`; bit-equal run to run and in a CUDA graph's replay (over NaN,
    on a new cotangent); the source's launch shape equals `backward_plan`'s."""
    dtype = torch.bfloat16
    q = _on(cuda, 150, (B, H, Sq, D), dtype)
    k = _on(cuda, 151, (B, KH, Sk, D), dtype)
    v = _on(cuda, 152, (B, KH, Sk, Dv), dtype)
    dout = _on(cuda, 153, (B, H, Sq, Dv), dtype)
    scale = D ** -0.5
    of = torch.empty_like(q)
    lse = fa.flash_attention_forward_lse(q, k, torch.nn.functional.pad(v, (0, D - Dv)), of,
                                         scale, causal)
    o = of[..., :Dv]
    grads = [torch.full_like(t, float("nan")) for t in (q, k, v)]
    again = [torch.full_like(t, float("nan")) for t in (q, k, v)]
    fa.flash_attention_backward(q, k, v, o, dout, lse, *grads, scale, causal)
    fa.flash_attention_backward(q, k, v, o, dout, lse, *again, scale, causal)
    torch.cuda.synchronize()
    for name, got, want, rerun in zip(("dq", "dk", "dv"), grads,
                                      flash_grads_f32(q, k, v, dout, causal), again):
        assert torch.isfinite(got).all(), name
        assert_grad_close(got, want, name)
        assert torch.equal(got, rerun), name
    graphed = [torch.full_like(t, float("nan")) for t in (q, k, v)]
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        fa.flash_attention_backward(q, k, v, o, dout, lse, *graphed, scale, causal)
    for t in graphed:
        t.fill_(float("nan"))
    dout.copy_(_on(cuda, 154, dout.shape, dtype))
    fa.flash_attention_backward(q, k, v, o, dout, lse, *grads, scale, causal)
    graph.replay()
    torch.cuda.synchronize()
    for name, got, want in zip(("dq", "dk", "dv"), graphed, grads):
        assert torch.equal(got, want), name
    del graph
    dev = torch.cuda.current_device()
    plan = fa.backward_plan(B, H, KH, Sq, Sk, D, _lib.sm_count(dev),
                            fa._clusters_at_once(H // KH, D, dev, Dv), causal, Dv)
    assert plan.cluster <= fa.MAX_CLUSTER
    assert fa.backward_plan_on_card(B, H, KH, Sq, Sk, D, causal, Dv) == plan.as_tuple()


@pytest.mark.requires_cuda
@pytest.mark.parametrize("Dv", [128, 64])
def test_attention_bthd_under_grad_at_mla_widths(cuda, Dv):
    """MLA's call under grad: q and k (2, 256, 16, 192), v a Dv-wide slice of
    a wider tensor (as `mla_full` slices it from the expanded latent; 64
    is padded to the (192, 128) instance in the backward), through
    `_FlashFn`: one LSE forward and one backward call, the output and dv at
    v's width, the gradients within `GRAD_TOL` of autograd of the plain
    version in f32."""
    dtype = torch.bfloat16
    q = _on(cuda, 160, (2, 256, 16, 192), dtype).requires_grad_()
    k = _on(cuda, 161, (2, 256, 16, 192), dtype).requires_grad_()
    kv = _on(cuda, 162, (2, 256, 16, 128 + Dv), dtype).requires_grad_()
    v = kv[..., 128:]
    f0, l0, b0 = (fa.flash_attention.launches, fa.flash_attention_forward_lse.launches,
                  fa.flash_attention_backward.launches)
    out = fa.attention_bthd(q, k, v)
    assert out.shape == (2, 256, 16, Dv)
    dout = _on(cuda, 163, out.shape, dtype)
    got = torch.autograd.grad(out, (q, k, v), dout)
    torch.cuda.synchronize()
    assert (fa.flash_attention.launches, fa.flash_attention_forward_lse.launches,
            fa.flash_attention_backward.launches) == (f0, l0 + 1, b0 + 1)
    leaves = [t.detach().float().requires_grad_() for t in (q, k, v)]
    pad = torch.nn.functional.pad(leaves[2], (0, 192 - Dv))
    want_out = fa.flash_attention_plain(*(t.transpose(1, 2) for t in (leaves[0], leaves[1], pad)),
                                        True).transpose(1, 2)[..., :Dv]
    want = torch.autograd.grad(want_out, leaves, dout.float())
    for name, t, g, w in zip(("dq", "dk", "dv"), (q, k, v), got, want):
        assert g.shape == t.shape, name
        assert_grad_close(g, w, name)
    torch.testing.assert_close(out.detach().float(), want_out.detach(), **attn_tol(dtype))


@pytest.mark.requires_cuda
def test_attention_bthd_under_grad_keeps_layout(cuda):
    """The model layout under grad: the output, and dq, dk, dv in the
    inputs' (B, T, H, D) layout and strides, against autograd of the plain
    version run in f32; the forward counted as one LSE launch and the
    backward as one call."""
    dtype = torch.bfloat16
    q = _on(cuda, 94, (2, 256, 12, 128), dtype).requires_grad_()
    k = _on(cuda, 95, (2, 256, 2, 128), dtype).requires_grad_()
    v = _on(cuda, 96, (2, 256, 2, 128), dtype).requires_grad_()
    f0, l0, b0 = (fa.flash_attention.launches, fa.flash_attention_forward_lse.launches,
                  fa.flash_attention_backward.launches)
    out = fa.attention_bthd(q, k, v)
    assert out.grad_fn is not None and out.shape == q.shape and out.is_contiguous()
    dout = _on(cuda, 97, out.shape, dtype)
    out.backward(dout)
    torch.cuda.synchronize()
    assert (fa.flash_attention.launches, fa.flash_attention_forward_lse.launches,
            fa.flash_attention_backward.launches) == (f0, l0 + 1, b0 + 1)
    leaves = [t.detach().float().requires_grad_() for t in (q, k, v)]
    want_out = fa.flash_attention_plain(*(t.transpose(1, 2) for t in leaves)).transpose(1, 2)
    want = torch.autograd.grad(want_out, leaves, dout.float())
    for name, t, w in zip(("dq", "dk", "dv"), (q, k, v), want):
        assert t.grad.stride() == t.stride(), name
        assert_grad_close(t.grad, w, name)
    torch.testing.assert_close(out.detach().float(), want_out.detach(), **attn_tol(dtype))


@pytest.mark.requires_cuda
def test_kernels_without_a_backward_raise_under_grad(cuda):
    """Every wrapper whose kernel has no backward raises the port's
    `ProgramError` (not a `RuntimeError`) on CUDA under grad, as do flash
    attention's and the SSD scan's uncovered routes (each in f32; in bf16
    each launches, with a backward: the scan, and flash attention past
    eight query heads a KV head and at head_dim 192); without grad each
    launches."""
    bf16 = torch.bfloat16
    q = _on(cuda, 100, (2, 1, 8, 64), bf16).requires_grad_()
    cache = _on(cuda, 101, (2, 32, 2, 64), bf16)
    with pytest.raises(_lib.ProgramError, match="item 13e"):
        da.decode_attention_bthd(q, cache, cache, 32)
    with pytest.raises(_lib.ProgramError, match="item 13e"):
        da.decode_attention(q.reshape(2, 2, 4, 64), cache.transpose(1, 2),
                            cache.transpose(1, 2), 32)
    x = _on(cuda, 102, (2, 64, 2, 16), torch.float32).requires_grad_()
    gate = -torch.rand(2, 64, 2, device=cuda)
    with pytest.raises(_lib.ProgramError, match="item 13f"):
        ssd.ssd_scan_bthd(x, x, x, gate, chunk=16)
    launched = ssd.ssd_scan.launches
    y, _ = ssd.ssd_scan_bthd(*(x.to(bf16),) * 3, gate, chunk=16)
    assert y.grad_fn is not None and ssd.ssd_scan.launches == launched + 1
    with pytest.raises(_lib.ProgramError, match="item 13e"):
        bq.quantize(_on(cuda, 103, (8, 64), bf16).requires_grad_())
    qv, scale = bq.quantize(_on(cuda, 104, (8, 64), bf16))
    with pytest.raises(_lib.ProgramError, match="item 13e"):
        bq.dequantize(qv, scale.requires_grad_())
    k = _on(cuda, 105, (1, 2, 64, 64), bf16)
    with pytest.raises(_lib.ProgramError, match="item 13a"):
        fa.flash_attention(_on(cuda, 106, (1, 4, 64, 64), torch.float32).requires_grad_(),
                           k.float(), k.float())
    launched = fa.flash_attention_forward_lse.launches
    for args in ((_on(cuda, 107, (1, 18, 64, 64), bf16).requires_grad_(), k, k),
                 (_on(cuda, 109, (1, 4, 64, 192), bf16).requires_grad_(),
                  _on(cuda, 110, (1, 2, 64, 192), bf16), _on(cuda, 111, (1, 2, 64, 192), bf16))):
        assert fa.flash_attention(*args).grad_fn is not None
    assert fa.flash_attention_forward_lse.launches == launched + 2
    with torch.no_grad():
        da.decode_attention_bthd(q, cache, cache, 32)
        bq.quantize(_on(cuda, 103, (8, 64), bf16).requires_grad_())
    torch.cuda.synchronize()


@pytest.mark.requires_cuda
def test_model_forward_without_grad_runs_no_autograd_function(cuda):
    """Serving's forward (frozen leaves) launches the forward kernels
    directly: no LSE forward, no output with a grad_fn."""
    from repro_torch.configs import get_config
    from repro_torch.models.model_zoo import build_model

    cfg = get_config("qwen2-1.5b").reduced()
    model = build_model(cfg)
    params = model.init(torch.Generator(device=cuda).manual_seed(0))
    tokens = torch.randint(0, cfg.vocab, (2, 64), device=cuda)
    f0, l0 = fa.flash_attention.launches, fa.flash_attention_forward_lse.launches
    logits = model.forward(params, {"tokens": tokens})
    torch.cuda.synchronize()
    assert logits.grad_fn is None
    assert fa.flash_attention.launches == f0 + cfg.n_layers
    assert fa.flash_attention_forward_lse.launches == l0


# ------------------------------------------------------ the compiled step

_STEP_DIM, _STEP_LAYERS, _STEP_SEQ, _STEP_BATCH, _STEP_ACCUM = 256, 2, 64, 4, 2


def _train_setup(cuda):
    """A small qwen2-family model (`train_small.small_config` at d_model
    256, 2 layers), its eager step (AdamW lr 1e-3, remat, 2 micro-batches),
    a maker of its state from seed 0, and a maker of batches."""
    from repro_torch.data.tokens import TokenPipeline
    from repro_torch.examples.train_small import small_config
    from repro_torch.models.model_zoo import build_model
    from repro_torch.training import AdamWConfig, init_opt_state, make_train_step

    cfg = small_config(_STEP_DIM, _STEP_LAYERS)
    model = build_model(cfg)
    opt_cfg = AdamWConfig(lr=1e-3)
    step = make_train_step(model, opt_cfg, remat=True, accum_steps=_STEP_ACCUM)

    def state():
        params = model.init(torch.Generator(device=cuda).manual_seed(0))
        return params, init_opt_state(params, opt_cfg)

    def batch(i, rows=_STEP_BATCH):
        pipe = TokenPipeline(vocab=cfg.vocab, seq_len=_STEP_SEQ, global_batch=rows, seed=5)
        return {k: torch.as_tensor(v, device=cuda) for k, v in pipe.batch_for(i).items()}

    return cfg, model, step, state, batch


def _compiled(step):
    from repro_torch.serving.engine import GraphStats
    from repro_torch.training.train_lib import CompiledTrainStep

    return CompiledTrainStep(step, stats=GraphStats())


def _run(step, params, opt, batches) -> tuple:
    """(params, opt, [(loss, grad norm)] a step) after `step` over `batches`."""
    metrics = []
    for b in batches:
        params, opt, m = step(params, opt, b)
        metrics.append((m["loss"].clone(), m["grad_norm"].clone()))
    torch.cuda.synchronize()
    return params, opt, metrics


def _assert_bit_equal(eager, graphed) -> None:
    (p, o, m), (q, r, n) = eager, graphed
    for i, ((la, ga), (lb, gb)) in enumerate(zip(m, n, strict=True)):
        assert torch.equal(la, lb) and torch.equal(ga, gb), f"step {i}"
    from repro_torch.training.tree import leaves

    for i, (a, b) in enumerate(zip(leaves(p) + leaves(o), leaves(q) + leaves(r), strict=True)):
        assert a.dtype == b.dtype and torch.equal(a, b), f"leaf {i}"


@pytest.mark.requires_cuda
def test_compiled_train_step_is_bit_equal_to_eager(cuda):
    """Six steps: a warm-up run eagerly, a capture (which runs the step once,
    by replaying), then four replays; losses, gradient norms, parameters,
    moments and the step counter bit-equal to the eager step's.  The step
    returns the caller's own trees (donated, written in place), leaves them
    frozen, and the graph holds each micro-batch's forward and backward
    kernels; serving's forward after it still launches the direct kernel."""
    from repro_torch.training.tree import leaves

    cfg, model, step, state, batch = _train_setup(cuda)
    batches = [batch(i) for i in range(6)]
    eager = _run(step, *state(), batches)
    compiled = _compiled(step)
    q, r = state()
    graphed = _run(compiled, q, r, batches)
    assert graphed[0] is q and graphed[1] is r and int(r["step"]) == 6
    _assert_bit_equal(eager, graphed)
    s = compiled.stats
    assert (s.misses, s.captures, s.replays, compiled.stats.copy_ins) == (1, 1, 5, 0)
    L = cfg.n_layers
    want = {"rmsnorm": _STEP_ACCUM * (4 * L + 1), "rmsnorm_backward": _STEP_ACCUM * (2 * L + 1),
            "flash_attention_forward_lse": _STEP_ACCUM * 2 * L,
            "flash_attention_backward": _STEP_ACCUM * L}
    assert s.captured == want
    assert s.replayed == {k: 5 * n for k, n in want.items()}
    assert all(not t.requires_grad for t in leaves(q))
    f0, l0 = fa.flash_attention.launches, fa.flash_attention_forward_lse.launches
    model.forward(q, {"tokens": batches[0]["tokens"]})
    torch.cuda.synchronize()
    assert (fa.flash_attention.launches, fa.flash_attention_forward_lse.launches) == (f0 + L, l0)


@pytest.mark.requires_cuda
def test_compiled_train_step_takes_a_restore_mid_run(cuda, tmp_path):
    """After three graphed steps the state is checkpointed and restored into
    fresh tensors (as the elastic loop's restart does); the compiled step
    copies them into the graph's buffers, returns its own trees, and goes
    on bit-equal to an eager run that never stopped."""
    from repro_torch.training import checkpoint as ckpt_lib

    _, _, step, state, batch = _train_setup(cuda)
    batches = [batch(i) for i in range(7)]
    eager = _run(step, *state(), batches)
    compiled = _compiled(step)
    q, r = state()
    q, r, first = _run(compiled, q, r, batches[:3])
    ckpt_lib.save(str(tmp_path), 3, {"params": q, "opt": r})
    fresh_p, fresh_o = state()
    restored, at = ckpt_lib.restore(str(tmp_path), {"params": fresh_p, "opt": fresh_o})
    assert at == 3
    p2, o2, rest = _run(compiled, restored["params"], restored["opt"], batches[3:])
    assert p2 is q and o2 is r and compiled.stats.copy_ins == 1
    _assert_bit_equal(eager, (p2, o2, first + rest))
    assert (compiled.stats.misses, compiled.stats.captures, compiled.stats.replays) == (1, 1, 6)


@pytest.mark.requires_cuda
def test_compiled_train_step_captures_a_graph_per_batch_shape(cuda):
    """A second batch shape (half the rows) gets its own warm-up and graph;
    steps alternating between the shapes stay bit-equal to eager."""
    _, _, step, state, batch = _train_setup(cuda)
    half = _STEP_BATCH // 2
    batches = [batch(0), batch(1), batch(2), batch(3, half), batch(4, half), batch(5, half),
               batch(6)]
    eager = _run(step, *state(), batches)
    compiled = _compiled(step)
    graphed = _run(compiled, *state(), batches)
    _assert_bit_equal(eager, graphed)
    assert len(compiled.graphs) == 2
    assert (compiled.stats.misses, compiled.stats.captures, compiled.stats.replays) == (2, 2, 5)


# the memory the capture may reserve past its pool and what the warm-up
# left allocated: the segments of the static batch and of the metrics'
# clones (2 MiB each in the allocator's small pool) and the rounding of
# the warm-up's kept blocks (cuBLAS's workspaces on the side stream) to
# their segments, with room
_POOL_SLACK = 16 << 20


@pytest.mark.requires_cuda
def test_compiled_train_step_capture_reuses_the_warm_ups_memory(cuda):
    """At `train_small`'s size (d_model 512, 8 layers, 8 x 128 tokens in 2
    micro-batches): the capture releases the warm-up's cached blocks before
    its pool opens, so after it the card reserves no more than before the
    warm-up plus what the warm-up left allocated, the graph's pool and
    `_POOL_SLACK` (without the release: also the warm-up's freed blocks,
    which here reserve more than four times the slack); the graph is
    recorded with its nodes counted; four steps (a warm-up, the capture,
    two replays) bit-equal to eager."""
    from repro_torch.data.tokens import TokenPipeline
    from repro_torch.examples import train_small as ts
    from repro_torch.models.model_zoo import build_model
    from repro_torch.training import AdamWConfig, init_opt_state, make_train_step

    cfg = ts.small_config()
    model = build_model(cfg)
    opt_cfg = AdamWConfig(lr=1e-3)
    step = make_train_step(model, opt_cfg, remat=True, accum_steps=ts.ACCUM)
    pipe = TokenPipeline(vocab=cfg.vocab, seq_len=ts.SEQ, global_batch=ts.BATCH)
    batches = [{k: torch.as_tensor(v, device=cuda) for k, v in pipe.batch_for(i).items()}
               for i in range(4)]

    def state():
        params = model.init(torch.Generator(device=cuda).manual_seed(0))
        return params, init_opt_state(params, opt_cfg)

    eager = _run(step, *state(), batches)
    compiled = _compiled(step)
    q, r = state()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    before, held = torch.cuda.memory_reserved(), torch.cuda.memory_allocated()
    q, r, first = _run(compiled, q, r, batches[:1])
    warm = torch.cuda.max_memory_reserved() - before
    kept = torch.cuda.memory_allocated() - held
    q, r, second = _run(compiled, q, r, batches[1:2])
    after = torch.cuda.memory_reserved() - before
    pool = compiled.stats.reserved_bytes
    assert warm - kept > 4 * _POOL_SLACK, (warm, kept)
    assert after <= kept + pool + _POOL_SLACK, (after, kept, pool, warm)
    (graph,) = compiled.graphs.values()
    assert graph.nodes > 0 and graph.capture_s > 0 and graph.instantiate_s > 0
    q, r, rest = _run(compiled, q, r, batches[2:])
    _assert_bit_equal(eager, (q, r, first + second + rest))
    assert (compiled.stats.misses, compiled.stats.captures, compiled.stats.replays) == (1, 1, 3)


@pytest.mark.requires_cuda
def test_compiled_train_step_capture_failure_raises_program_error(cuda):
    """A step that reads a loss on the host (a sync, refused while a graph
    captures) warms up eagerly, then fails to capture: the port's
    `ProgramError`, not a `RuntimeError` (the elastic loop's node failure),
    chained from the cause; no step runs (state and counters as after the
    warm-up), and the card stays usable (a good step then compiles)."""
    from repro_torch.training.tree import leaves

    _, _, step, state, batch = _train_setup(cuda)

    def syncing(params, opt, b):
        out = step(params, opt, b)
        float(out[2]["loss"])
        return out

    compiled = _compiled(syncing)
    q, r = state()
    compiled(q, r, batch(0))
    torch.cuda.synchronize()
    before = [t.clone() for t in leaves(q) + leaves(r)]
    with pytest.raises(_lib.ProgramError) as info:
        compiled(q, r, batch(1))
    assert not isinstance(info.value, RuntimeError) and info.value.__cause__ is not None
    torch.cuda.synchronize()
    s = compiled.stats
    assert (s.misses, s.captures, s.replays) == (1, 0, 0) and not compiled.graphs
    assert int(r["step"]) == 1 and all(not t.requires_grad for t in leaves(q))
    for a, b in zip(before, leaves(q) + leaves(r), strict=True):
        assert torch.equal(a, b)
    torch.cuda.empty_cache()
    good = _compiled(step)
    _run(good, *state(), [batch(i) for i in range(3)])
    assert (good.stats.misses, good.stats.captures, good.stats.replays) == (1, 1, 2)
