"""The port's kernel wrappers and their plain PyTorch versions, held against
the reference's Pallas kernels (interpret mode on the CPU) on a subset of
tests/test_kernels.py's shapes, with that file's tolerances (`_tol`: bf16
5e-2, f32 3e-5; the SSD scan atol 5e-4, rtol 2e-3).  Inputs come from numpy
and reach both sides unchanged.

The CUDA kernels themselves run only on a card: tests/test_torch_cuda.py
compares each with its plain version there.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.boundary_quant import kernel as bq_k
from repro.kernels.decode_attention import kernel as da_k
from repro.kernels.flash_attention import kernel as fa_k
from repro.kernels.rmsnorm import kernel as rn_k
from repro.kernels.ssd_scan import kernel as ssd_k
from repro.models import common as ref_common
from repro_torch.kernels.boundary_quant import ops as bq
from repro_torch.kernels.decode_attention import ops as da
from repro_torch.kernels.flash_attention import ops as fa
from repro_torch.kernels.rmsnorm import ops as rn
from repro_torch.kernels.ssd_scan import ops as ssd
from repro_torch.testing.parity import tol

DTYPES = [(jnp.float32, torch.float32), (jnp.bfloat16, torch.bfloat16)]


def _normal(seed, shape, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape) * scale).astype(np.float32)


def _pair(a: np.ndarray, jdt, tdt):
    """The same values on both sides: rounded once to the working dtype."""
    j = jnp.asarray(a, jdt)
    return j, torch.from_numpy(np.array(j.astype(jnp.float32))).to(tdt)


def _np(t: torch.Tensor) -> np.ndarray:
    return t.float().numpy()


# ---------------------------------------------------------------- (a) parity


@pytest.mark.parametrize("B,H,KH,S,D", [(2, 4, 2, 256, 64), (1, 2, 1, 128, 128)])
@pytest.mark.parametrize("dtypes", DTYPES, ids=["f32", "bf16"])
def test_flash_attention_plain_matches_pallas(B, H, KH, S, D, dtypes):
    jdt, tdt = dtypes
    q, tq = _pair(_normal(0, (B, H, S, D)), jdt, tdt)
    k, tk = _pair(_normal(1, (B, KH, S, D)), jdt, tdt)
    v, tv = _pair(_normal(2, (B, KH, S, D)), jdt, tdt)
    want = np.asarray(fa_k.flash_attention(q, k, v, causal=True, interpret=True), np.float32)
    before = fa.flash_attention.launches
    got = fa.flash_attention(tq, tk, tv, causal=True)
    assert got.dtype == tdt and fa.flash_attention.launches == before  # plain version
    np.testing.assert_allclose(_np(got), want, **tol(tdt))


def test_flash_attention_plain_non_causal_matches_pallas():
    q, tq = _pair(_normal(3, (1, 4, 128, 64)), jnp.float32, torch.float32)
    k, tk = _pair(_normal(4, (1, 4, 128, 64)), jnp.float32, torch.float32)
    v, tv = _pair(_normal(5, (1, 4, 128, 64)), jnp.float32, torch.float32)
    want = np.asarray(fa_k.flash_attention(q, k, v, causal=False, interpret=True))
    got = fa.flash_attention(tq, tk, tv, causal=False)
    np.testing.assert_allclose(_np(got), want, **tol(torch.float32))


def test_flash_attention_model_layout_and_ragged_seq():
    """(B, T, H, D) with head_dim 80 and a sequence no tile divides: the
    model-layout entry equals the (B, H, S, D) one on transposed inputs."""
    q = torch.from_numpy(_normal(6, (2, 12, 4, 80)))
    k = torch.from_numpy(_normal(7, (2, 12, 2, 80)))
    v = torch.from_numpy(_normal(8, (2, 12, 2, 80)))
    got = fa.attention_bthd(q, k, v)
    want = fa.flash_attention(q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2))
    assert got.shape == (2, 12, 4, 80)
    np.testing.assert_array_equal(_np(got), _np(want.transpose(1, 2)))


def test_flash_attention_rejects_unequal_lengths():
    """Top-left and bottom-right causal masks differ when Sq != Sk; the port
    supports Sq == Sk only and says so."""
    q = torch.zeros(1, 2, 8, 16)
    kv = torch.zeros(1, 2, 12, 16)
    with pytest.raises(ValueError, match="Sq == Sk"):
        fa.flash_attention(q, kv, kv)


@pytest.mark.parametrize("N,D", [(256, 512), (128, 2048)])
@pytest.mark.parametrize("dtypes", DTYPES, ids=["f32", "bf16"])
def test_rmsnorm_plain_matches_pallas(N, D, dtypes):
    jdt, tdt = dtypes
    x, tx = _pair(_normal(10, (N, D)), jdt, tdt)
    w, tw = _pair(_normal(11, (D,)), jdt, tdt)
    want = np.asarray(rn_k.rmsnorm(x, w, interpret=True), np.float32)
    before = rn.rmsnorm.launches
    got = rn.rmsnorm(tx, tw)
    assert got.dtype == tdt and rn.rmsnorm.launches == before  # plain version
    np.testing.assert_allclose(_np(got), want, **tol(tdt))


def test_rmsnorm_flattens_leading_dims():
    x = torch.from_numpy(_normal(12, (2, 3, 4, 32)))
    w = torch.from_numpy(_normal(13, (32,)))
    np.testing.assert_array_equal(_np(rn.rmsnorm(x, w)),
                                  _np(rn.rmsnorm(x.reshape(-1, 32), w)).reshape(2, 3, 4, 32))


def _quantize_ieee(x: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """The documented quantize semantics in numpy f32 (IEEE divides, round
    half to even): scale = max|x| / 127 + 1e-12, q = rint(x / scale)."""
    amax = np.abs(x).max(axis=-1, keepdims=True)
    scale = amax / np.float32(127.0) + np.float32(1e-12)
    return np.clip(np.rint(x / scale), -127, 127).astype(np.int8), scale


@pytest.mark.parametrize("N,D", [(256, 512), (512, 1024)])
def test_quantize_plain_matches_pallas(N, D):
    """q is bit-equal to the documented semantics.  Against the Pallas kernel
    (interpret mode) q agrees except where x / scale sits within float32
    rounding of a .5 boundary: XLA on the CPU rewrites `amax / 127.0` as a
    multiply by the rounded reciprocal, so its scale (and its own oracle's)
    can differ in the last bit; the scales agree to rtol 1e-6 as in
    tests/test_kernels.py."""
    x, tx = _pair(_normal(20, (N, D)), jnp.bfloat16, torch.bfloat16)
    q, s = bq_k.quantize(x, interpret=True)
    before = bq.quantize.launches
    tq, ts = bq.quantize(tx)
    assert bq.quantize.launches == before  # plain version
    q_ieee, s_ieee = _quantize_ieee(_np(tx))
    np.testing.assert_array_equal(tq.numpy(), q_ieee)
    np.testing.assert_array_equal(ts.numpy(), s_ieee)
    np.testing.assert_allclose(ts.numpy(), np.asarray(s), rtol=1e-6)
    diff = np.abs(tq.numpy().astype(np.int32) - np.asarray(q, np.int32))
    frac = np.abs(_np(tx) / ts.numpy() % 1.0 - 0.5)
    assert diff.max() <= 1 and (frac[diff > 0] < 1e-4).all()


@pytest.mark.parametrize("dtypes", DTYPES, ids=["f32", "bf16"])
def test_dequantize_plain_matches_pallas(dtypes):
    jdt, tdt = dtypes
    x, tx = _pair(_normal(21, (64, 128), scale=30.0), jnp.bfloat16, torch.bfloat16)
    q, s = bq_k.quantize(x, interpret=True)
    want = np.asarray(bq_k.dequantize(q, s, dtype=jdt, interpret=True), np.float32)
    before = bq.dequantize.launches
    got = bq.dequantize(torch.from_numpy(np.array(q)), torch.from_numpy(np.array(s)), tdt)
    assert got.dtype == tdt and bq.dequantize.launches == before  # plain version
    # same products rounded once to the same dtype: bit-equal
    np.testing.assert_array_equal(_np(got), want)


def test_quantize_any_row_count():
    """No divisor-block search: 7 rows of 3 leading dims work as they are."""
    x = torch.from_numpy(_normal(22, (7, 3, 96)))
    q, s = bq.quantize(x)
    assert q.shape == (7, 3, 96) and q.dtype == torch.int8 and s.shape == (7, 3, 1)
    err = (x - bq.dequantize(q, s, torch.float32)).abs()
    assert (err <= x.abs().amax(-1, keepdim=True) / 127 / 2 + 1e-6).all()


# ------------------------------------------------------- decode attention


@pytest.mark.parametrize("B,KH,G,S,D", [(2, 2, 4, 512, 64), (1, 4, 1, 1024, 128)])
@pytest.mark.parametrize("dtypes", DTYPES, ids=["f32", "bf16"])
def test_decode_attention_plain_matches_pallas(B, KH, G, S, D, dtypes):
    jdt, tdt = dtypes
    q, tq = _pair(_normal(30, (B, KH, G, D)), jdt, tdt)
    k, tk = _pair(_normal(31, (B, KH, S, D)), jdt, tdt)
    v, tv = _pair(_normal(32, (B, KH, S, D)), jdt, tdt)
    want = np.asarray(da_k.decode_attention(q, k, v, jnp.int32(S - 13), interpret=True),
                      np.float32)
    before = da.decode_attention.launches
    got = da.decode_attention(tq, tk, tv, S - 13)
    assert got.dtype == tdt and got.shape == (B, KH, G, D)
    assert da.decode_attention.launches == before  # plain version
    np.testing.assert_allclose(_np(got), want, **tol(tdt))


def test_decode_attention_plain_masks_tail():
    """Garbage beyond kv_len must not leak into the output (the reference's
    test_decode_attention_kv_len_masks_tail), in both layouts."""
    tq = torch.from_numpy(_normal(33, (1, 2, 2, 64)))
    tk = torch.from_numpy(_normal(34, (1, 2, 256, 64)))
    tv = torch.from_numpy(_normal(35, (1, 2, 256, 64)))
    out1 = da.decode_attention(tq, tk, tv, torch.tensor(100, dtype=torch.int32))
    tk2, tv2 = tk.clone(), tv.clone()
    tk2[:, :, 100:], tv2[:, :, 100:] = 1e4, -1e4
    out2 = da.decode_attention(tq, tk2, tv2, 100)
    np.testing.assert_allclose(_np(out1), _np(out2), atol=1e-5)
    want = np.asarray(da_k.decode_attention(jnp.asarray(tq.numpy()), jnp.asarray(tk2.numpy()),
                                            jnp.asarray(tv2.numpy()), jnp.int32(100),
                                            block_s=128, interpret=True))
    np.testing.assert_allclose(_np(out2), want, **tol(torch.float32))


@pytest.mark.parametrize("kv_len", [37, [5, 48]], ids=["scalar", "per_row"])
@pytest.mark.parametrize("dtypes", DTYPES, ids=["f32", "bf16"])
def test_decode_attention_model_layout_matches_reference(kv_len, dtypes):
    """The (B, 1, H, D) / (B, S, KH, D) wrapper against the reference
    model's `common.decode_attention`, with GQA (G = 3), head_dim 80 and a
    scalar or per-row (B,) kv_len."""
    jdt, tdt = dtypes
    q, tq = _pair(_normal(36, (2, 1, 6, 80)), jdt, tdt)
    k, tk = _pair(_normal(37, (2, 48, 2, 80)), jdt, tdt)
    v, tv = _pair(_normal(38, (2, 48, 2, 80)), jdt, tdt)
    want = np.asarray(ref_common.decode_attention(q, k, v, jnp.asarray(kv_len, jnp.int32)),
                      np.float32)
    got = da.decode_attention_bthd(tq, tk, tv, torch.tensor(kv_len, dtype=torch.int32))
    assert got.shape == (2, 1, 6, 80) and got.dtype == tdt
    np.testing.assert_allclose(_np(got), want, **tol(tdt))


# --------------------------------------------------------------- ssd scan

SSD_TOL = dict(atol=5e-4, rtol=2e-3)


def _gates(seed, shape):
    """-softplus(N(0, 1)), as tests/test_kernels.py draws log_g and log_i."""
    return -np.logaddexp(0.0, _normal(seed, shape)).astype(np.float32)


@pytest.mark.parametrize("B,NH,T,DK,DV,chunk", [
    (2, 3, 128, 16, 32, 32), (1, 2, 256, 32, 16, 64), (1, 1, 64, 8, 8, 64),
])
def test_ssd_scan_plain_matches_pallas(B, NH, T, DK, DV, chunk):
    q = _normal(40, (B, NH, T, DK), 0.5)
    k = _normal(41, (B, NH, T, DK), 0.5)
    v = _normal(42, (B, NH, T, DV), 0.5)
    log_g, log_i = _gates(43, (B, NH, T)), _gates(44, (B, NH, T))
    y_want, s_want = ssd_k.ssd_scan(*(jnp.asarray(a) for a in (q, k, v, log_g, log_i)),
                                    chunk=chunk, interpret=True)
    before = ssd.ssd_scan.launches
    y, state = ssd.ssd_scan(*(torch.from_numpy(a) for a in (q, k, v, log_g, log_i)),
                            chunk=chunk)
    assert ssd.ssd_scan.launches == before  # plain version
    assert y.shape == (B, NH, T, DV) and state.shape == (B, NH, DK, DV)
    np.testing.assert_allclose(_np(y), np.asarray(y_want), **SSD_TOL)
    np.testing.assert_allclose(_np(state), np.asarray(s_want), **SSD_TOL)


def test_ssd_scan_ragged_t_equals_zero_padding():
    """Any T: a short last chunk equals the Pallas kernel run on the input
    zero-padded to a whole chunk (log_i padded with -30, as the reference
    model pads), on y's valid rows and on the final state."""
    B, NH, T, D, chunk = 1, 2, 100, 16, 32
    q, k, v = (_normal(45 + i, (B, NH, T, D), 0.5) for i in range(3))
    log_g, log_i = _gates(48, (B, NH, T)), _gates(49, (B, NH, T))
    pad = (-T) % chunk
    padded = [np.pad(a, ((0, 0), (0, 0), (0, pad), (0, 0))) for a in (q, k, v)]
    padded += [np.pad(log_g, ((0, 0), (0, 0), (0, pad))),
               np.pad(log_i, ((0, 0), (0, 0), (0, pad)), constant_values=-30.0)]
    y_want, s_want = ssd_k.ssd_scan(*(jnp.asarray(a) for a in padded), chunk=chunk,
                                    interpret=True)
    y, state = ssd.ssd_scan(*(torch.from_numpy(a) for a in (q, k, v, log_g, log_i)),
                            chunk=chunk)
    np.testing.assert_allclose(_np(y), np.asarray(y_want)[:, :, :T], **SSD_TOL)
    np.testing.assert_allclose(_np(state), np.asarray(s_want), **SSD_TOL)


# ------------------------------------------------- (h) no silent fallback


def test_wrappers_raise_on_meta_tensors():
    x = torch.empty(4, 64, device="meta")
    w = torch.empty(64, device="meta")
    with pytest.raises(RuntimeError, match="meta"):
        rn.rmsnorm(x, w)
    with pytest.raises(RuntimeError, match="meta"):
        bq.quantize(x)
    q = torch.empty(1, 2, 8, 16, device="meta")
    with pytest.raises(RuntimeError, match="meta"):
        fa.flash_attention(q, q, q)


def _meta_calls(device_of):
    """One call of each wrapper added with decode and the SSD scan, its
    tensors on `device_of(i)` for the i-th argument."""
    def on(i, *shape):
        return torch.zeros(*shape, device=device_of(i))

    return {
        "decode_attention": lambda: da.decode_attention(
            on(0, 1, 2, 1, 16), on(1, 1, 2, 8, 16), on(2, 1, 2, 8, 16), 4),
        "decode_attention_bthd": lambda: da.decode_attention_bthd(
            on(0, 1, 1, 2, 16), on(1, 1, 8, 2, 16), on(2, 1, 8, 2, 16), 4),
        "ssd_scan": lambda: ssd.ssd_scan(
            on(0, 1, 2, 8, 4), on(1, 1, 2, 8, 4), on(2, 1, 2, 8, 4), on(3, 1, 2, 8)),
        "ssd_scan_bthd": lambda: ssd.ssd_scan_bthd(
            on(0, 1, 8, 2, 4), on(1, 1, 8, 2, 4), on(2, 1, 8, 2, 4), on(3, 1, 8, 2)),
    }


@pytest.mark.parametrize("name", sorted(_meta_calls(lambda i: "cpu")))
def test_new_wrappers_raise_on_meta_tensors(name):
    with pytest.raises(RuntimeError, match="meta"):
        _meta_calls(lambda i: "meta")[name]()


def test_wrappers_raise_on_mixed_devices():
    with pytest.raises(ValueError, match="different devices"):
        rn.rmsnorm(torch.zeros(2, 8), torch.zeros(8, device="meta"))


@pytest.mark.parametrize("name", sorted(_meta_calls(lambda i: "cpu")))
def test_new_wrappers_raise_on_mixed_devices(name):
    with pytest.raises(ValueError, match="different devices"):
        _meta_calls(lambda i: "meta" if i == 1 else "cpu")[name]()
