"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here is marked `requires_cuda` and skips without an NVIDIA GPU
(a CUDA kernel has no CPU mode).  The file imports neither JAX nor the
reference package, so it runs on a machine with the card alone:

    PYTHONPATH=src python -m pytest -q --noconftest tests/test_torch_cuda.py

(`--noconftest` skips tests/conftest.py, which imports JAX.)

Tolerances are those of tests/test_kernels.py (`_tol`: bf16 5e-2, f32
3e-5); quantize and dequantize must be bit-equal.
"""

import numpy as np
import pytest
import torch

from repro_torch.kernels.boundary_quant import ops as bq
from repro_torch.kernels.flash_attention import ops as fa
from repro_torch.kernels.rmsnorm import ops as rn
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
