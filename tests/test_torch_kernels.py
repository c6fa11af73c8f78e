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
from repro.kernels.ssd_scan import kernel as ssd_k, ref as ssd_r
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


@pytest.mark.parametrize("N,D", [(256, 512), (128, 2048), (512, 128)])
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


@pytest.mark.parametrize("elem_size", [2, 4], ids=["bf16", "f32"])
def test_rmsnorm_launch_plan_covers_every_row(elem_size):
    """The plan is a function of D alone that the kernel can run: every
    element of a row has a lane, a narrow row a group of at most 32 lanes,
    a wide row a block of at most 512 threads."""
    vec = 16 // elem_size
    for D in [1, 2, 7, 8, 9, 31, 64, 80, 96, 127, 128, 129, 1000, 1001, 1024, 1025, 2048,
              2560, 2563, 4096, 5120, 8192, 12000, 16384] + ([32768] if elem_size == 2 else []):
        lanes, vpt = rn.launch_plan(D, elem_size)
        assert vpt in rn.VECTORS and lanes * vpt * vec >= D
        nvec = -(-D // vec)
        if nvec <= rn.NARROW:  # a power of two up to 32
            assert lanes <= 32 and lanes & (lanes - 1) == 0 and vpt <= 4
        else:  # no more than one spare warp of vectors
            assert lanes % 32 == 0 and lanes <= 512 and (lanes - 32) * vpt < nvec


@pytest.mark.parametrize("D,elem_size,plan", [(128, 2, (16, 1)), (2560, 2, (160, 2)),
                                              (5120, 2, (320, 2)), (5120, 4, (448, 3))])
def test_rmsnorm_launch_plan_at_the_smoke_shapes(D, elem_size, plan):
    """bf16: qwen3-14b's qk_norm (D = 128) takes 16 lanes a row, 16 rows a
    256-thread block; the d_model rows (2560) and the Mamba2 gated norm
    (5120) a block of two vectors a thread."""
    assert rn.launch_plan(D, elem_size) == plan


@pytest.mark.parametrize("D,plan", [(16000, (512, 4)), (20000, (320, 8)), (32768, (512, 8))])
def test_rmsnorm_launch_plan_wide_rows(D, plan):
    """bf16 rows past 1024 vectors take at most 512 threads of 4 or 8
    vectors, the widths the card tests run for those instances."""
    assert rn.launch_plan(D, 2) == plan


def test_rmsnorm_refuses_rows_past_the_widest_plan():
    with pytest.raises(ValueError, match="at most 32768"):
        rn.launch_plan(32769, 2)


@pytest.mark.parametrize("offset", [0, 1, 8])
def test_rmsnorm_vector_loads(offset):
    """16-byte accesses only where every base is 16-byte aligned and D keeps
    each row aligned; a view at an element offset takes the element path."""
    base = torch.zeros(4 * 256 + 8, dtype=torch.bfloat16)
    x = base[offset:offset + 4 * 256].view(4, 256)
    w = torch.zeros(256, dtype=torch.bfloat16)
    out = torch.empty_like(x)
    assert rn.vector_loads(x, w, out) == (x.data_ptr() % 16 == 0)
    odd = torch.zeros(4, 250, dtype=torch.bfloat16)
    assert not rn.vector_loads(odd, torch.zeros(250, dtype=torch.bfloat16), odd)


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


@pytest.mark.parametrize("elem_size", [2, 4], ids=["bf16", "f32"])
def test_quantize_launch_plan_covers_every_row(elem_size):
    """Every chunk of a row has exactly one lane, a block holds its rows,
    and rows past the widest plan (D > 32768 in bf16, 16384 in f32) take
    the two-pass kernel."""
    widest = 32768 if elem_size == 2 else 16384
    for D in list(range(1, 1100)) + [2560, 5120, 8192, 8200, 12000, 16384, 16385,
                                     20000, 32768, 32769, 40000]:
        lanes, cpt = bq.launch_plan(D, elem_size)
        if D > widest:
            assert (lanes, cpt) == (0, 0), D
            continue
        nchunk = -(-D // bq.CHUNK)
        assert cpt in bq.CHUNKS and cpt <= (8 if elem_size == 2 else 4), D
        assert lanes * cpt >= nchunk, D
        if lanes <= 32:
            assert lanes & (lanes - 1) == 0 and nchunk <= bq.NARROW, D
            assert lanes == 32 or lanes // 2 < nchunk <= lanes and cpt == 1, D
        else:
            assert lanes % 32 == 0 and lanes <= 512 and lanes * cpt - nchunk < 32 * cpt, D


@pytest.mark.parametrize("N,D,elem_size,plan", [
    (64, 1024, 2, (128, 1)), (527, 1024, 4, (128, 1)), (528, 1024, 2, (32, 4)),
    (77, 264, 2, (64, 1)), (600, 264, 2, (32, 2)), (129, 520, 4, (96, 1)),
    (700, 520, 4, (32, 3)), (5, 96, 2, (16, 1)), (333, 7, 2, (1, 1)), (8, 2560, 2, (160, 2)),
    (3, 20000, 2, (320, 8))])
def test_quantize_launch_plan_few_rows(N, D, elem_size, plan):
    """On a card of 132 SMs: narrow rows of several chunks a lane, fewer
    than THIN an SM, take a block a row of one chunk a thread; rows of at
    most 32 chunks and wide rows keep the plan from D."""
    assert bq.launch_plan(D, elem_size, N, 132) == plan
    lanes, cpt = plan
    assert lanes * cpt >= -(-D // bq.CHUNK) and (lanes <= 32 or lanes % 32 == 0)


def test_quantize_launch_plan_at_the_boundary_shape():
    """The serve's boundary activations (D = 2560) take a block of 160
    threads of two chunks a row, in either dtype."""
    assert bq.launch_plan(2560, 2) == bq.launch_plan(2560, 4) == (160, 2)


def test_quantize_vector_loads():
    x = torch.zeros(4, 2560, dtype=torch.bfloat16)
    assert bq.vector_loads(x)
    assert not bq.vector_loads(torch.zeros(4 * 2560 + 1, dtype=torch.bfloat16)[1:].view(4, 2560))
    assert not bq.vector_loads(torch.zeros(4, 2563, dtype=torch.bfloat16))


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


def _check_plan(B, KH, S, n_sm):
    n, per, ring = da.split_plan(B, KH, S, n_sm)
    assert 0 <= ring < len(da.RINGS)  # a block shape the source builds
    if 2 * B * KH > n_sm:
        assert n == 1  # enough blocks already: one split
    assert 1 <= n <= da.MAX_SPLITS
    bounds = [(i * per, min((i + 1) * per, S)) for i in range(n)]
    assert bounds[0][0] == 0 and bounds[-1][1] == S  # [0, S) exactly,
    assert all(a1 == b0 for (_, a1), (b0, _) in zip(bounds, bounds[1:]))  # no gap, no overlap
    assert all(hi > lo for lo, hi in bounds)
    if n > 1:
        assert all(hi - lo >= da.MIN_SPLIT_KEYS for lo, hi in bounds)
    return n, per


@pytest.mark.parametrize("B,KH,S,n_sm", [
    (4, 32, 528, 132),    # zamba2-2.7b decode
    (8, 32, 160, 132),    # stablelm-3b decode
    (1, 8, 4096, 132),    # a long cache over few heads: capped splits
    (1, 8, 129, 132),     # two splits of 65 and 64
    (2, 8, 300, 132),
    (64, 32, 4096, 132),  # far above the threshold
    (1, 1, 1, 132),
    (1, 2, 70, 132),
    (3, 4, 96, 16),
])
def test_decode_split_plan(B, KH, S, n_sm):
    """The split heuristic is a plain function of host-known shapes: one
    split at or above the threshold, every split of a several-way plan at
    least MIN_SPLIT_KEYS keys, and the splits cover [0, S) exactly."""
    _check_plan(B, KH, S, n_sm)


def test_decode_split_plan_at_the_smoke_shapes():
    """On the H100 (132 SMs): zamba2-2.7b's 4 x 32 = 128 (batch, KV head)
    blocks, one an SM, each stream 528 keys through 8 warps;
    stablelm-3b's 8 x 32 = 256 stream 160 keys each through 4 warps.  Neither
    splits: the kernel's sweep (`decode_attention/sweep.py`) measured the
    splits slower there.  Below, the sweep's fastest plan (or one within 5%
    of it) at shapes that split."""
    assert da.split_plan(4, 32, 528, 132) == (1, 528, 1)
    assert da.split_plan(8, 32, 160, 132) == (1, 160, 0)
    # a long cache over few heads (one sequence of qwen3-14b's 8 KV heads):
    # eight splits of 512 keys, 8 warps each
    assert da.split_plan(1, 8, 4096, 132) == (8, 512, 1)
    assert da.split_plan(2, 8, 1024, 132) == (6, 171, 1)   # 96 blocks
    assert da.split_plan(8, 8, 4096, 132) == (2, 2048, 1)  # 64 pairs: still two
    assert da.split_plan(1, 32, 528, 132) == (3, 176, 1)
    assert da.split_plan(16, 8, 4096, 132) == (1, 4096, 1)  # 128 pairs: one


def test_decode_split_plan_over_a_grid_of_shapes():
    for B in (1, 2, 3, 4, 8, 16, 64):
        for KH in (1, 2, 4, 8, 32, 40):
            for S in (1, 2, 63, 64, 65, 127, 128, 129, 160, 300, 528, 1000, 4096, 32768):
                for n_sm in (16, 132):
                    _check_plan(B, KH, S, n_sm)


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


def _ssd_inputs(B, NH, T, DK, DV, seed=50):
    q = _normal(seed, (B, NH, T, DK), 0.5)
    k = _normal(seed + 1, (B, NH, T, DK), 0.5)
    v = _normal(seed + 2, (B, NH, T, DV), 0.5)
    return q, k, v, _gates(seed + 3, (B, NH, T)), _gates(seed + 4, (B, NH, T))


def _bthd(*arrays):
    """(B, NH, T, ...) numpy arrays as (B, T, NH, ...) tensors."""
    return [torch.from_numpy(np.ascontiguousarray(np.swapaxes(a, 1, 2))) for a in arrays]


@pytest.mark.parametrize("B,NH,T,DK,DV,chunk", [
    (2, 3, 128, 16, 32, 32), (1, 2, 256, 32, 16, 64), (1, 1, 64, 8, 8, 64),
])
def test_ssd_chunk_parallel_plain_matches_pallas_and_ref(B, NH, T, DK, DV, chunk):
    """The kernel's regrouping (chunk-local states, their fold, every chunk's
    outputs from its entering state) is the Pallas kernel's recurrence: held
    to it in interpret mode and to the sequential oracle `ssd_scan_ref`, at
    tests/test_kernels.py's shapes and SSD bound."""
    arrays = _ssd_inputs(B, NH, T, DK, DV)
    y_pal, s_pal = ssd_k.ssd_scan(*(jnp.asarray(a) for a in arrays), chunk=chunk,
                                  interpret=True)
    y_ref, s_ref = ssd_r.ssd_scan_ref(*(jnp.asarray(a) for a in arrays))
    y, state = ssd.chunk_parallel_plain(*_bthd(*arrays[:3]), *_bthd(*arrays[3:]), chunk=chunk)
    for want_y, want_s in ((y_pal, s_pal), (y_ref, s_ref)):
        np.testing.assert_allclose(_np(y.transpose(1, 2)), np.asarray(want_y), **SSD_TOL)
        np.testing.assert_allclose(_np(state), np.asarray(want_s), **SSD_TOL)


@pytest.mark.parametrize("T,chunk", [(100, 32), (40, 64), (200, 64)])
def test_ssd_chunk_parallel_plain_ragged_t(T, chunk):
    """A short last chunk, left short, equals the Pallas kernel on the input
    zero-padded to whole chunks (log_i padded with -30, as the reference
    model pads) and the sequential oracle on the unpadded input."""
    B, NH, D = 1, 2, 16
    q, k, v, log_g, log_i = _ssd_inputs(B, NH, T, D, D, seed=60)
    Q = min(chunk, T)
    pad = (-T) % Q
    padded = [np.pad(a, ((0, 0), (0, 0), (0, pad), (0, 0))) for a in (q, k, v)]
    padded += [np.pad(log_g, ((0, 0), (0, 0), (0, pad))),
               np.pad(log_i, ((0, 0), (0, 0), (0, pad)), constant_values=-30.0)]
    y_pal, s_pal = ssd_k.ssd_scan(*(jnp.asarray(a) for a in padded), chunk=Q, interpret=True)
    y_ref, s_ref = ssd_r.ssd_scan_ref(*(jnp.asarray(a) for a in (q, k, v, log_g, log_i)))
    y, state = ssd.chunk_parallel_plain(*_bthd(q, k, v), *_bthd(log_g, log_i), chunk=chunk)
    np.testing.assert_allclose(_np(y.transpose(1, 2)), np.asarray(y_pal)[:, :, :T], **SSD_TOL)
    np.testing.assert_allclose(_np(state), np.asarray(s_pal), **SSD_TOL)
    np.testing.assert_allclose(_np(y.transpose(1, 2)), np.asarray(y_ref), **SSD_TOL)
    np.testing.assert_allclose(_np(state), np.asarray(s_ref), **SSD_TOL)


def test_ssd_chunk_parallel_plain_broadcast_heads_no_log_i():
    """Mamba2's form: q and k one (B, T, DK) tensor expanded over the heads,
    no log_i; equal to the op-for-op plain version."""
    B, T, NH, D = 2, 150, 4, 16
    c = torch.from_numpy(_normal(70, (B, T, D), 0.5))
    bm = torch.from_numpy(_normal(71, (B, T, D), 0.5))
    v = torch.from_numpy(_normal(72, (B, T, NH, D), 0.5))
    log_g = torch.from_numpy(_gates(73, (B, T, NH)))
    q, k = c[:, :, None].expand(B, T, NH, D), bm[:, :, None].expand(B, T, NH, D)
    y, state = ssd.chunk_parallel_plain(q, k, v, log_g, chunk=64)
    y0, s0 = ssd.chunked_linear_attention_plain(q, k, v, log_g, chunk=64)
    np.testing.assert_allclose(_np(y), _np(y0), **SSD_TOL)
    np.testing.assert_allclose(_np(state), _np(s0), **SSD_TOL)


def test_ssd_vector_loads():
    """16-byte copies for bf16 views whose bases and (batch, time, head)
    strides are 16-byte multiples, Mamba2's stride-0 head broadcast
    included; f32, an element offset, or a width not a multiple of 8 takes
    the element path."""
    B, T, NH = 2, 16, 4
    xbc = torch.zeros(B, T, 64 + 2 * 64 + 8, dtype=torch.bfloat16)  # like Mamba2's xBC
    c = xbc[..., 64:128][:, :, None].expand(B, T, NH, 64)
    v = torch.zeros(B, T, NH, 64, dtype=torch.bfloat16)
    assert ssd.vector_loads(c, c, v)
    assert not ssd.vector_loads(c.float(), c.float(), v.float())
    shifted = xbc[..., 1:65][:, :, None].expand(B, T, NH, 64)
    assert not ssd.vector_loads(shifted, c, v)
    narrow = torch.zeros(B, T, NH, 12, dtype=torch.bfloat16)
    assert not ssd.vector_loads(narrow, narrow, v)


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
