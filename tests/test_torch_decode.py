"""The port's KV-cache decode (dense family), its Mamba2 mixer and its hybrid
assembly (zamba2-2.7b), held against the reference package on reduced
configs.

Parameters come from the reference (`model.init`) and reach the port
through `params_from_numpy`; token ids and activations come from numpy.
Tolerances, as in tests/test_torch_models.py:

* f32, where the point is the algorithm: rtol 1e-4 and atol 1e-4 times the
  largest magnitude of the reference tensor; the chunked scan 1e-4 / 1e-3,
  as tests/test_kernels.py holds the SSD kernel to the model oracle;
* bf16 whole models: atol 0.2, rtol 2e-2, plus the decisive-margin top-1
  rule (PyTorch and XLA accumulate bf16 products in different orders; see
  ROADMAP queue 3).  A cache tensor after prefill is held to the same bound
  scaled to its own magnitude: atol 0.2 at the logits' scale of ~4, i.e.
  0.05 of the tensor's largest value where that exceeds 4 (the Mamba2
  states reach 1e4, the conv inputs ~40; measured error 2-5% of scale).

The serving invariant (prefill + decode equals the teacher-forced forward,
tests/test_models.py) is checked on the port alone, under `PLAIN` and
`KERNELS` (whose wrappers run their plain versions for CPU tensors).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_config
from repro.models import hybrid as ref_hybrid
from repro.models import ssm as ref_ssm
from repro.models.common import NO_SHARDING
from repro.models.model_zoo import build_model as ref_build, layer_costs as ref_layer_costs
from repro_torch.configs import get_config
from repro_torch.kernels.decode_attention import ops as da
from repro_torch.kernels.ssd_scan import ops as ssd
from repro_torch.models import common, hybrid, ssm
from repro_torch.models.model_zoo import build_model, layer_costs
from repro_torch.testing.parity import params_from_numpy

ARCHS = ["stablelm-3b", "qwen3-14b", "zamba2-2.7b"]  # qwen3: qk_norm + GQA
# reduced zamba2-2.7b with its period twice: G = 2 groups, so the (G, K)
# stack, the per-group states and KV caches are indexed past group 0.  It is
# held in f32 only: with the reference's init (a stacked leaf's fan-in is G,
# so the Mamba2 projections draw N(0, 1/2) at width 128) one-ulp bf16
# differences grow through 12 layers, past the serving invariant's bound in
# the reference itself (test_reference_bf16_invariant_breaks_at_two_groups).
TWO_GROUPS = "zamba2-2.7b-x2"
BF16 = dict(atol=0.2, rtol=2e-2)
DTYPES = {"f32": (jnp.float32, torch.float32), "bf16": (jnp.bfloat16, torch.bfloat16)}


def _rng(seed):
    return np.random.default_rng(seed)


def _normal(seed, shape, scale=1.0):
    return (_rng(seed).standard_normal(shape) * scale).astype(np.float32)


def _gates(seed, shape, scale=1.0):
    return (-scale * np.logaddexp(0.0, _normal(seed, shape))).astype(np.float32)


def _np(x) -> np.ndarray:
    return np.asarray(x.float().numpy() if isinstance(x, torch.Tensor) else x, np.float32)


def _f32_close(got, want, rtol=1e-4) -> None:
    got, want = _np(got), _np(want)
    np.testing.assert_allclose(got, want, rtol=rtol,
                               atol=1e-4 * max(1.0, float(np.abs(want).max())))


def _decisive_top1(got: np.ndarray, want: np.ndarray) -> None:
    err = np.abs(got - want).max()
    top2 = np.sort(want, axis=-1)[..., -2:]
    decisive = (top2[..., 1] - top2[..., 0]) > 2 * err
    assert decisive.any(), "no decisive positions"
    assert (got.argmax(-1) == want.argmax(-1))[decisive].all()


def _reduced(get, arch, **overrides):
    """`get(arch).reduced(**overrides)`, or for TWO_GROUPS zamba2-2.7b's
    reduced period repeated twice."""
    if arch != TWO_GROUPS:
        return get(arch).reduced(**overrides)
    pattern = get("zamba2-2.7b").reduced().ssm_pattern * 2
    return get("zamba2-2.7b").reduced(ssm_pattern=pattern, n_layers=len(pattern), **overrides)


def _models(arch, dtype, seed=0):
    jdt, tdt = DTYPES[dtype]
    rcfg = _reduced(ref_config, arch, dtype=jdt)
    cfg = _reduced(get_config, arch, dtype=tdt)
    ref_model = ref_build(rcfg)
    ref_params = ref_model.init(jax.random.PRNGKey(seed))
    tree = jax.tree.map(lambda a: np.asarray(a).astype(np.float32), ref_params)
    return rcfg, ref_model, ref_params, cfg, params_from_numpy(tree, cfg)


def _assert_close(got, want, dtype) -> None:
    if dtype == "f32":
        _f32_close(got, want)
    else:
        np.testing.assert_allclose(_np(got), _np(want), **BF16)


def _assert_state_close(got, want, dtype) -> None:
    """A cache or recurrent-state tensor: the bf16 bound scaled to its size."""
    if dtype == "f32":
        _f32_close(got, want, rtol=1e-3)
    else:
        scale = max(4.0, float(np.abs(_np(want)).max()))
        np.testing.assert_allclose(_np(got), _np(want), rtol=BF16["rtol"],
                                   atol=BF16["atol"] * scale / 4)


# ------------------------------------------------------- the scan and its step


@pytest.mark.parametrize("T,chunk,with_i,with_s0", [
    (64, 16, True, False), (50, 16, True, True), (40, 64, False, False), (37, 8, False, True),
], ids=["whole", "ragged_s0", "one_chunk_no_i", "ragged_no_i_s0"])
def test_chunked_linear_attention_matches_reference(T, chunk, with_i, with_s0):
    B, NH, DK, DV = 2, 3, 16, 8
    q, k = _normal(0, (B, T, NH, DK), 0.5), _normal(1, (B, T, NH, DK), 0.5)
    v = _normal(2, (B, T, NH, DV), 0.5)
    log_g = _gates(3, (B, T, NH))
    log_i = _gates(4, (B, T, NH)) if with_i else None
    s0 = _normal(5, (B, NH, DK, DV)) if with_s0 else None
    args = (q, k, v, log_g, log_i, s0)
    y_want, s_want = ref_ssm.chunked_linear_attention(
        *(None if a is None else jnp.asarray(a) for a in args), chunk=chunk)
    y, state = ssm.chunked_linear_attention(
        *(None if a is None else torch.from_numpy(a) for a in args), chunk=chunk)
    np.testing.assert_allclose(_np(y), _np(y_want), atol=1e-4, rtol=1e-3)
    np.testing.assert_allclose(_np(state), _np(s_want), atol=1e-4, rtol=1e-3)
    # the model-layout wrapper (which starts from a zero state, as the
    # Pallas kernel does) is the same function on CPU tensors
    tensors = [None if a is None else torch.from_numpy(a) for a in args[:5]]
    y2, s2 = ssd.ssd_scan_bthd(*tensors, chunk=chunk)
    y3, s3 = ssm.chunked_linear_attention(*tensors, chunk=chunk)
    np.testing.assert_array_equal(_np(y2), _np(y3))
    np.testing.assert_array_equal(_np(s2), _np(s3))


@pytest.mark.parametrize("with_i", [False, True], ids=["no_i", "with_i"])
def test_linear_attention_step_matches_reference(with_i):
    B, NH, DK, DV = 2, 3, 16, 8
    q, k, v = _normal(6, (B, NH, DK)), _normal(7, (B, NH, DK)), _normal(8, (B, NH, DV))
    log_g = _gates(9, (B, NH))
    log_i = _gates(10, (B, NH)) if with_i else None
    s0 = _normal(11, (B, NH, DK, DV))
    y_want, s_want = ref_ssm.linear_attention_step(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(log_g), jnp.asarray(s0),
        None if log_i is None else jnp.asarray(log_i))
    y, state = ssm.linear_attention_step(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v), torch.from_numpy(log_g),
        torch.from_numpy(s0), None if log_i is None else torch.from_numpy(log_i))
    _f32_close(y, y_want)
    _f32_close(state, s_want)


def test_scan_steps_equal_chunked_scan():
    """The decode recurrence, step by step, ends in the chunked scan's
    state and gives its outputs."""
    B, T, NH, D = 1, 20, 2, 8
    q, k, v = (torch.from_numpy(_normal(12 + i, (B, T, NH, D), 0.5)) for i in range(3))
    log_g = torch.from_numpy(_gates(15, (B, T, NH)))
    y, state = ssm.chunked_linear_attention(q, k, v, log_g, chunk=8)
    s = torch.zeros(B, NH, D, D)
    for t in range(T):
        yt, s = ssm.linear_attention_step(q[:, t], k[:, t], v[:, t], log_g[:, t], s)
        _f32_close(yt, y[:, t])
    _f32_close(s, state)


# --------------------------------------------------------------------- Mamba2


def _mamba_layer(params, rparams):
    return params["inner"][0][1]["mixer"], jax.tree.map(lambda a: a[0, 1], rparams["inner"])[
        "mixer"]


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_mamba2_full_and_step_match_reference(dtype):
    rcfg, _, rparams, cfg, params = _models("zamba2-2.7b", dtype)
    p, rp = _mamba_layer(params, rparams)
    jdt, tdt = DTYPES[dtype]
    x = _normal(20, (2, 12, cfg.d_model))
    jx, tx = jnp.asarray(x, jdt), torch.from_numpy(x).to(tdt)
    want, rst = ref_ssm.mamba2_full(rcfg, NO_SHARDING, rp, jx, return_state=True)
    got, st = ssm.mamba2_full(cfg, common.PLAIN, p, tx, return_state=True)
    _assert_close(got, want, dtype)
    _assert_state_close(st["conv"], rst["conv"], dtype)
    _assert_state_close(st["ssm"], rst["ssm"], dtype)
    assert st["ssm"].dtype == torch.float32 and st["conv"].dtype == tdt
    x1 = _normal(21, (2, 1, cfg.d_model))
    want1, rst1 = ref_ssm.mamba2_step(rcfg, NO_SHARDING, rp, jnp.asarray(x1, jdt), rst)
    got1, st1 = ssm.mamba2_step(cfg, common.KERNELS, p, torch.from_numpy(x1).to(tdt), st)
    _assert_close(got1, want1, dtype)
    _assert_state_close(st1["conv"], rst1["conv"], dtype)
    _assert_state_close(st1["ssm"], rst1["ssm"], dtype)


def test_mamba2_params_keep_their_own_dtypes():
    """A_log, D and dt_bias are f32 under a bf16 config, in the reference and
    after conversion (each leaf takes its own ParamDef's dtype)."""
    _, _, rparams, cfg, params = _models("zamba2-2.7b", "bf16")
    p = params["inner"][0][0]["mixer"]
    for name in ("A_log", "D", "dt_bias"):
        assert rparams["inner"]["mixer"][name].dtype == jnp.float32
        assert p[name].dtype == torch.float32
    assert p["in_proj"].dtype == torch.bfloat16 and params["embed"].dtype == torch.bfloat16
    init = build_model(cfg).init(torch.Generator().manual_seed(0))
    assert init["inner"][0][2]["mixer"]["A_log"].dtype == torch.float32


def test_hybrid_init_keeps_reference_formulas():
    """The (G, K) stack keeps the reference's fan-in, its leading axis G: a
    Mamba2 projection draws normal / sqrt(G); the shared block is unstacked
    (fan-in d_model)."""
    cfg = get_config("zamba2-2.7b").reduced(dtype=torch.float32, d_model=256)
    cfg = cfg.__class__(**{**cfg.__dict__, "ssm_pattern": cfg.ssm_pattern * 4,
                           "n_layers": 4 * cfg.n_layers})
    params = build_model(cfg).init(torch.Generator().manual_seed(0))
    assert len(params["inner"]) == 4 and len(params["inner"][0]) == 5
    w = params["inner"][3][4]["mixer"]["in_proj"]
    assert abs(w.std().item() - 0.5) < 0.02  # 1 / sqrt(4 groups)
    wq = params["shared_attn"]["attn"]["wq"]
    assert abs(wq.std().item() - cfg.d_model ** -0.5) < 2e-3
    assert abs(params["inner"][0][0]["mixer"]["conv_w"].std().item() - 0.5) < 0.02


# ------------------------------------------------- whole models against JAX


def _tokens(cfg, seed=0, B=2, S=12):
    return _rng(seed).integers(0, cfg.vocab, (B, S))


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_hybrid_forward_matches_reference(dtype):
    _, ref_model, rparams, cfg, params = _models("zamba2-2.7b", dtype)
    tokens = _tokens(cfg)
    want = _np(ref_model.forward(rparams, {"tokens": jnp.asarray(tokens, jnp.int32)}))
    for ops in (common.KERNELS, common.PLAIN):
        got = _np(build_model(cfg).forward(params, {"tokens": torch.from_numpy(tokens)},
                                           ops=ops))
        assert got.shape == (2, 12, cfg.padded_vocab)
        _assert_close(got, want, dtype)
        if dtype == "bf16":
            _decisive_top1(got, want)


def _cache_leaves(cache: dict) -> dict:
    out = {}
    for k, v in cache.items():
        if isinstance(v, dict):
            out.update({f"{k}.{n}": a for n, a in v.items()})
        else:
            out[k] = v
    return out


@pytest.mark.parametrize("dtype,arch", [(d, a) for a in ARCHS for d in ("f32", "bf16")]
                         + [("f32", TWO_GROUPS)])
def test_prefill_and_decode_match_reference(dtype, arch):
    """init_cache, prefill (logits and every cache tensor, same keys and
    shapes) and 4 decode steps against the reference."""
    rcfg, ref_model, rparams, cfg, params = _models(arch, dtype)
    model = build_model(cfg)
    if arch == TWO_GROUPS:
        assert len(params["inner"]) == 2 and rparams["inner"]["norm"].shape[0] == 2
    B, S, extra = 2, 12, 4
    tokens = _tokens(cfg, seed=1)
    lg, rcache = ref_model.prefill(rparams, {"tokens": jnp.asarray(tokens, jnp.int32)},
                                   max_len=S + extra)
    got, cache = model.prefill(params, {"tokens": torch.from_numpy(tokens)}, max_len=S + extra)
    _assert_close(got, lg, dtype)
    want_leaves, got_leaves = _cache_leaves(rcache), _cache_leaves(cache)
    empty = _cache_leaves(model.init_cache(B, S + extra, "cpu"))
    ref_empty = _cache_leaves(ref_model.init_cache(B, S + extra))
    assert sorted(got_leaves) == sorted(want_leaves) == sorted(empty) == sorted(ref_empty)
    for name, a in want_leaves.items():
        assert tuple(got_leaves[name].shape) == a.shape == tuple(empty[name].shape), name
        assert tuple(ref_empty[name].shape) == a.shape, name
        _assert_state_close(got_leaves[name], a, dtype)
    steps = []
    for i in range(extra):
        tok = (_rng(10 + i).integers(0, cfg.vocab, (B, 1)))
        lg, rcache = ref_model.decode_step(rparams, jnp.asarray(tok, jnp.int32), rcache,
                                           jnp.int32(S + i))
        got, cache2 = model.decode_step(params, torch.from_numpy(tok), cache,
                                        torch.tensor(S + i, dtype=torch.int32))
        assert cache2 is cache  # updated in place
        assert got.shape == (B, 1, cfg.padded_vocab)
        _assert_close(got, lg, dtype)
        steps.append((_np(got), _np(lg)))
    if dtype == "bf16":  # over every step's rows: one step has only B of them
        _decisive_top1(*(np.concatenate(s) for s in zip(*steps)))


def test_decode_takes_a_python_int_cur_len():
    _, _, _, cfg, params = _models("stablelm-3b", "f32")
    model = build_model(cfg)
    tokens = torch.from_numpy(_tokens(cfg, seed=2))
    _, c1 = model.prefill(params, {"tokens": tokens}, max_len=13)
    _, c2 = model.prefill(params, {"tokens": tokens}, max_len=13)
    tok = tokens[:, :1]
    a, _ = model.decode_step(params, tok, c1, 12)
    b, _ = model.decode_step(params, tok, c2, torch.tensor(12))
    np.testing.assert_array_equal(_np(a), _np(b))
    np.testing.assert_array_equal(_np(c1["k"]), _np(c2["k"]))


# ------------------------------------------------------- the serving invariant


@pytest.mark.parametrize("arch", ARCHS + [TWO_GROUPS])
@pytest.mark.parametrize("ops", ["kernels", "plain"])
def test_prefill_decode_matches_forward(arch, ops):
    """The port's own serving invariant (tests/test_models.py): logits from
    prefill + step-by-step decode equal the teacher-forced forward at every
    position, in bf16, within that test's bounds (prefill 3e-2; decode atol
    0.25, rtol 0.25, top-1 wherever the top-2 margin exceeds 0.3); the two-
    group hybrid in f32, at 1e-4 of the logits' scale."""
    the_ops = common.KERNELS if ops == "kernels" else common.PLAIN
    cfg = _reduced(get_config, arch, **({"dtype": torch.float32} if arch == TWO_GROUPS else {}))
    model = build_model(cfg)
    params = model.init(torch.Generator().manual_seed(0))
    B, S, extra = 2, 12, 4
    tokens = torch.from_numpy(_tokens(cfg, seed=3))
    ext = torch.cat([tokens, (torch.arange(B * extra).reshape(B, extra) + 7) % cfg.vocab], 1)
    full = _np(model.forward(params, {"tokens": ext}, ops=the_ops))
    lg, cache = model.prefill(params, {"tokens": tokens}, max_len=S + extra, ops=the_ops)
    if arch == TWO_GROUPS:
        _f32_close(lg[:, 0], full[:, S - 1])
    else:
        np.testing.assert_allclose(_np(lg[:, 0]), full[:, S - 1], atol=3e-2, rtol=3e-2)
    n_da = da.decode_attention.launches
    for i in range(extra):
        lg, cache = model.decode_step(params, ext[:, S + i][:, None], cache,
                                      torch.tensor(S + i, dtype=torch.int32), ops=the_ops)
        got, want = _np(lg[:, 0]), full[:, S + i]
        if arch == TWO_GROUPS:
            _f32_close(got, want)
        else:
            np.testing.assert_allclose(got, want, atol=0.25, rtol=0.25)
        top2 = np.sort(want, axis=-1)[:, -2:]
        decisive = (top2[:, 1] - top2[:, 0]) > 0.3
        assert (got.argmax(-1) == want.argmax(-1))[decisive].all()
    assert da.decode_attention.launches == n_da  # CPU tensors: plain versions


def test_reference_bf16_invariant_breaks_at_two_groups():
    """Why TWO_GROUPS is held in f32: at two groups the reference's own bf16
    prefill + decode misses its teacher-forced forward past the serving
    invariant's bound (atol 0.25, rtol 0.25, tests/test_models.py), while
    its f32 run agrees to 1e-4 of the logits' scale."""
    B, S, extra = 2, 12, 4
    for dtype in ("f32", "bf16"):
        rcfg = _reduced(ref_config, TWO_GROUPS, dtype=DTYPES[dtype][0])
        model = ref_build(rcfg)
        params = model.init(jax.random.PRNGKey(0))
        tokens = _tokens(rcfg, seed=3)
        ext = np.concatenate([tokens, (np.arange(B * extra).reshape(B, extra) + 7) % rcfg.vocab],
                             axis=1)
        full = _np(model.forward(params, {"tokens": jnp.asarray(ext, jnp.int32)}))
        _, cache = model.prefill(params, {"tokens": jnp.asarray(tokens, jnp.int32)},
                                 max_len=S + extra)
        got = []
        for i in range(extra):
            lg, cache = model.decode_step(params, jnp.asarray(ext[:, S + i:S + i + 1], jnp.int32),
                                          cache, jnp.int32(S + i))
            got.append(_np(lg[:, 0]))
        got, want = np.stack(got, axis=1), full[:, S:]
        if dtype == "f32":
            _f32_close(got, want)
        else:
            assert not np.allclose(got, want, atol=0.25, rtol=0.25)


def test_layer_costs_match_reference():
    """The planner sees zamba2-2.7b's reference profile: one Mamba2 cost per
    'm', one attention + MLP cost per 'a'."""
    for seq in (128, 512):
        got = layer_costs(get_config("zamba2-2.7b"), seq)
        want = ref_layer_costs(ref_config("zamba2-2.7b"), seq)
        assert len(got) == 56
        assert [dict(vars(c)) for c in got] == [dict(vars(c)) for c in want]


def test_cache_layouts_match_reference_init_cache():
    """Fresh caches: the same keys, shapes and dtypes as the reference's."""
    for arch in ARCHS:
        rcfg, cfg = ref_config(arch).reduced(), get_config(arch).reduced()
        want = _cache_leaves(ref_build(rcfg).init_cache(3, 20))
        got = _cache_leaves(build_model(cfg).init_cache(3, 20, "cpu"))
        assert sorted(got) == sorted(want)
        for name, a in want.items():
            assert tuple(got[name].shape) == a.shape
            assert str(got[name].dtype).split(".")[-1] == str(a.dtype), name
            assert not got[name].any()


def test_reference_hybrid_pattern_parse_agrees():
    for arch in ("zamba2-2.7b", "xlstm-1.3b"):
        assert hybrid.parse_pattern(get_config(arch)) == ref_hybrid.parse_pattern(
            ref_config(arch))
