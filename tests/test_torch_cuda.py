"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here is marked `requires_cuda` and skips without an NVIDIA GPU
(a CUDA kernel has no CPU mode).  The file imports neither JAX nor the
reference package, so it runs on a machine with the card alone:

    PYTHONPATH=src python -m pytest -q --noconftest tests/test_torch_cuda.py

(`--noconftest` skips tests/conftest.py, which imports JAX.)

Tolerances are those of tests/test_kernels.py (`_tol`: bf16 5e-2, f32
3e-5; the SSD scan atol 5e-4, rtol 2e-3, its test_ssd_scan); quantize and
dequantize must be bit-equal.
"""

import numpy as np
import pytest
import torch

from repro_torch.kernels.boundary_quant import ops as bq
from repro_torch.kernels.decode_attention import ops as da
from repro_torch.kernels.flash_attention import ops as fa
from repro_torch.kernels.rmsnorm import ops as rn
from repro_torch.kernels.ssd_scan import ops as ssd
from repro_torch.testing.parity import tol


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
                                        (1, 2, 1, 70, 40)])
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
    np.testing.assert_allclose(_np(got.cpu()), _np(want.cpu()), **tol(dtype))
    bthd = fa.attention_bthd(q.transpose(1, 2).contiguous(), k.transpose(1, 2).contiguous(),
                             v.transpose(1, 2).contiguous())
    np.testing.assert_array_equal(_np(bthd.transpose(1, 2).cpu()), _np(got.cpu()))


@pytest.mark.requires_cuda
def test_flash_attention_kernel_refuses_float32(cuda):
    """The kernel's products run on bf16 tensor cores; f32 on CUDA raises
    rather than silently computing at lower precision."""
    q = torch.zeros(1, 2, 16, 64, device=cuda)
    with pytest.raises(TypeError, match="bfloat16"):
        fa.flash_attention(q, q, q)


@pytest.mark.requires_cuda
@pytest.mark.parametrize("N,D", [(1024, 2560), (96, 80), (7, 32)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_rmsnorm_kernel_matches_plain(cuda, N, D, dtype):
    x = _on(cuda, 33, (N, D), dtype)
    w = _on(cuda, 34, (D,), dtype)
    got = rn.rmsnorm(x, w)
    torch.cuda.synchronize()
    np.testing.assert_allclose(_np(got.cpu()), _np(rn.rmsnorm_plain(x, w).cpu()), **tol(dtype))


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
])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_decode_attention_kernel_matches_plain(cuda, B, S, KH, G, D, kv_len, dtype):
    q = _on(cuda, 40, (B, 1, KH * G, D), dtype)
    k = _on(cuda, 41, (B, S, KH, D), dtype)
    v = _on(cuda, 42, (B, S, KH, D), dtype)
    lens = torch.tensor(kv_len, dtype=torch.int32, device=cuda)
    before = da.decode_attention.launches
    got = da.decode_attention_bthd(q, k, v, lens)
    torch.cuda.synchronize()
    assert da.decode_attention.launches == before + 1
    want = da.decode_attention_plain(q, k, v, lens)
    np.testing.assert_allclose(_np(got.cpu()), _np(want.cpu()), **tol(dtype))
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
def test_decode_attention_kernel_per_row_lengths(cuda):
    """A (B,) kv_len masks each batch row at its own length."""
    q = _on(cuda, 46, (3, 1, 8, 64), torch.bfloat16)
    k = _on(cuda, 47, (3, 96, 4, 64), torch.bfloat16)
    v = _on(cuda, 48, (3, 96, 4, 64), torch.bfloat16)
    lens = torch.tensor([5, 96, 40], dtype=torch.int32, device=cuda)
    got = da.decode_attention_bthd(q, k, v, lens)
    want = da.decode_attention_plain(q, k, v, lens)
    np.testing.assert_allclose(_np(got.cpu()), _np(want.cpu()), **tol(torch.bfloat16))
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
