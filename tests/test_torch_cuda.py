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

from repro_torch.kernels.boundary_quant import ops as bq
from repro_torch.kernels.decode_attention import ops as da
from repro_torch.kernels.flash_attention import ops as fa
from repro_torch.kernels.rmsnorm import ops as rn
from repro_torch.kernels.ssd_scan import ops as ssd
from repro_torch.testing.parity import attn_tol, tol


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
                                        (2, 6, 2, 384, 128), (1, 2, 1, 512, 64)])
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
def test_ssd_scan_kernel_refuses_what_it_cannot_take(cuda):
    """A state dim past 64, a chunk past 4096, or q, k, v of mixed dtypes
    raise before any launch; nothing falls back to the plain version."""
    z = torch.zeros(1, 8, 2, 64, device=cuda, dtype=torch.bfloat16)
    g = torch.zeros(1, 8, 2, device=cuda)
    wide = torch.zeros(1, 8, 2, 80, device=cuda, dtype=torch.bfloat16)
    before = ssd.ssd_scan.launches
    with pytest.raises(ValueError, match="state dims"):
        ssd.ssd_scan_bthd(wide, wide, z, g)
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
