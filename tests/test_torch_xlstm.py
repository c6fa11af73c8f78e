"""The port's xLSTM (xlstm-1.3b: mLSTM and sLSTM cells, the ("M"*7 + "s")
assembly, prefill and decode) held against the reference package, and the
plain scan at the mLSTM's state widths against the Pallas kernel.

Parameters come from the reference (`model.init`) and reach the port
through `params_from_numpy`; token ids and activations come from numpy.
Tolerances are those of tests/test_torch_decode.py: f32 to 1e-4 of the
reference tensor's scale; bf16 whole models at atol 0.2 / rtol 2e-2 plus
the decisive-margin top-1 rule; a recurrent state after prefill to the
bf16 bound scaled to its own magnitude; the port's own serving invariant
at the reference's xLSTM decode bound (atol 0.45, rtol 0.25,
tests/test_models.py).

**Conditioning.**  The reference's init takes a stacked leaf's fan-in from
its leading (group) axis: at `reduced()` (one group) the mLSTM's
projections draw N(0, 1), q and k reach the hundreds, and the normalised
readout divides sums that cancel.  The reference's own f32 forward then
moves by ~5% of the logits' scale when its parameters are scaled by
1 + 2^-20 (`test_reference_f32_forward_is_chaotic_at_its_init`), so no f32
implementation that sums in another order can match it to 1e-4 end to
end.  Each layer is held to the reference at its own init from the same
input (`test_layer_walk_matches_reference_at_its_init`); whole models are
held on the same parameters with every stacked projection rescaled to
the fan-in of its input width (`condition_fan_in`), where the math is
stable.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_config
from repro.kernels.ssd_scan import kernel as ssd_k
from repro.models import hybrid as ref_hybrid
from repro.models import ssm as ref_ssm
from repro.models.common import NO_SHARDING, rms_norm as ref_rms_norm
from repro.models.model_zoo import build_model as ref_build
from repro_torch.configs import get_config
from repro_torch.kernels.ssd_scan import ops as ssd
from repro_torch.models import common, hybrid, ssm
from repro_torch.models import transformer as tfm
from repro_torch.models.model_zoo import build_model
from repro_torch.testing.parity import condition_fan_in, params_from_numpy

ARCH = "xlstm-1.3b"
TWO_GROUPS = "MMMsMMMs"  # G = 2 groups of three mLSTM blocks and an sLSTM block
BF16 = dict(atol=0.2, rtol=2e-2)
SSD_TOL = dict(atol=5e-4, rtol=2e-3)  # tests/test_kernels.py:121-122
DTYPES = {"f32": (jnp.float32, torch.float32), "bf16": (jnp.bfloat16, torch.bfloat16)}


def _rng(seed):
    return np.random.default_rng(seed)


def _normal(seed, shape, scale=1.0):
    return (_rng(seed).standard_normal(shape) * scale).astype(np.float32)


def _np(x) -> np.ndarray:
    return np.asarray(x.float().numpy() if isinstance(x, torch.Tensor) else x, np.float32)


def _f32_close(got, want, rtol=1e-4) -> None:
    got, want = _np(got), _np(want)
    np.testing.assert_allclose(got, want, rtol=rtol,
                               atol=1e-4 * max(1.0, float(np.abs(want).max())))


def _assert_close(got, want, dtype) -> None:
    if dtype == "f32":
        _f32_close(got, want)
    else:
        np.testing.assert_allclose(_np(got), _np(want), **BF16)


def _assert_state_close(got, want, dtype) -> None:
    """A recurrent state: the bf16 bound scaled to the tensor's magnitude."""
    if dtype == "f32":
        _f32_close(got, want, rtol=1e-3)
    else:
        scale = max(4.0, float(np.abs(_np(want)).max()))
        np.testing.assert_allclose(_np(got), _np(want), rtol=BF16["rtol"],
                                   atol=BF16["atol"] * scale / 4)


def _decisive_top1(got: np.ndarray, want: np.ndarray) -> None:
    err = np.abs(got - want).max()
    top2 = np.sort(want, axis=-1)[..., -2:]
    decisive = (top2[..., 1] - top2[..., 0]) > 2 * err
    assert decisive.any(), "no decisive positions"
    assert (got.argmax(-1) == want.argmax(-1))[decisive].all()


def _cfgs(dtype, pattern=None):
    """The reference's and the port's reduced xlstm-1.3b (one group), or
    `pattern` in its place."""
    jdt, tdt = DTYPES[dtype]
    over = dict(ssm_pattern=pattern, n_layers=len(pattern)) if pattern else {}
    return (ref_config(ARCH).reduced(dtype=jdt, **over),
            get_config(ARCH).reduced(dtype=tdt, **over))


def _take(node, i):
    return jax.tree.map(lambda a: a[i], node)


def _models(dtype, pattern=None, conditioned=True, seed=0):
    """(reference config, model, params) and (port config, params) on the
    same parameters: the reference's init, conditioned unless asked not to."""
    rcfg, cfg = _cfgs(dtype, pattern)
    ref_model = ref_build(rcfg)
    rparams = ref_model.init(jax.random.PRNGKey(seed))
    tree = jax.tree.map(lambda a: np.asarray(a).astype(np.float32), rparams)
    if conditioned:
        tree = condition_fan_in(tree, build_model(cfg).defs)
        rparams = jax.tree.map(lambda a, r: jnp.asarray(a).astype(r.dtype), tree, rparams)
        tree = jax.tree.map(lambda a: np.asarray(a).astype(np.float32), rparams)
    return rcfg, ref_model, rparams, cfg, params_from_numpy(tree, cfg)


def _tokens(cfg, seed=0, B=2, S=12):
    return _rng(seed).integers(0, cfg.vocab, (B, S))


def _cache_leaves(cache: dict) -> dict:
    out = {}
    for k, v in cache.items():
        if isinstance(v, dict):
            out.update({f"{k}.{n}": a for n, a in v.items()})
        else:
            out[k] = v
    return out


# ------------------------------------------------------- the cells


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_mlstm_full_and_step_match_reference(dtype):
    """One mLSTM block's mixer (group 0, block 1): the full form with its
    final state (B, nh, hd, hd + 1), then one step from that state."""
    rcfg, _, rparams, cfg, params = _models(dtype)
    p = params["inner"][0][1]["mixer"]
    rp = jax.tree.map(lambda a: a[0, 1], rparams["inner"])["mixer"]
    jdt, tdt = DTYPES[dtype]
    x = _normal(20, (2, 12, cfg.d_model))
    want, rst = ref_ssm.mlstm_full(rcfg, NO_SHARDING, rp, jnp.asarray(x, jdt), return_state=True)
    got, st = ssm.mlstm_full(cfg, common.PLAIN, p, torch.from_numpy(x).to(tdt),
                             return_state=True)
    _assert_close(got, want, dtype)
    assert st["ssm"].shape == (2, 4, 64, 65) and st["ssm"].dtype == torch.float32
    _assert_state_close(st["ssm"], rst["ssm"], dtype)
    x1 = _normal(21, (2, 1, cfg.d_model))
    want1, rst1 = ref_ssm.mlstm_step(rcfg, NO_SHARDING, rp, jnp.asarray(x1, jdt), rst)
    got1, st1 = ssm.mlstm_step(cfg, common.KERNELS, p, torch.from_numpy(x1).to(tdt), st)
    _assert_close(got1, want1, dtype)
    _assert_state_close(st1["ssm"], rst1["ssm"], dtype)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_slstm_full_and_step_match_reference(dtype):
    """The sLSTM block's mixer: the loop over time against the reference's
    `lax.scan`, its (c, n, h, m) state, then one step from it."""
    rcfg, _, rparams, cfg, params = _models(dtype)
    p = params["outer"][0]["mixer"]
    rp = _take(rparams["outer"], 0)["mixer"]
    jdt, tdt = DTYPES[dtype]
    x = _normal(22, (2, 12, cfg.d_model))
    want, rst = ref_ssm.slstm_full(rcfg, NO_SHARDING, rp, jnp.asarray(x, jdt), return_state=True)
    got, st = ssm.slstm_full(cfg, common.PLAIN, p, torch.from_numpy(x).to(tdt),
                             return_state=True)
    _assert_close(got, want, dtype)
    assert sorted(st) == sorted(rst) == ["c", "h", "m", "n"]
    for name in rst:
        assert st[name].dtype == torch.float32
        _assert_state_close(st[name], rst[name], dtype)
    x1 = _normal(23, (2, 1, cfg.d_model))
    want1, rst1 = ref_ssm.slstm_step(rcfg, NO_SHARDING, rp, jnp.asarray(x1, jdt), rst)
    got1, st1 = ssm.slstm_step(cfg, common.KERNELS, p, torch.from_numpy(x1).to(tdt), st)
    _assert_close(got1, want1, dtype)
    for name in rst1:
        _assert_state_close(st1[name], rst1[name], dtype)


def test_mlstm_scans_at_widths_hd_and_hd_plus_one():
    """`mlstm_full` hands `ops.linear_attention` q and k of width hd and v
    of width hd + 1 (a ones column last), log_i clipped to [-30, 10], with
    the config's chunk."""
    _, _, _, cfg, params = _models("f32")
    seen = []

    def spy(q, k, v, log_g, log_i=None, chunk=256):
        seen.append((q.shape, k.shape, v.shape, chunk, float(log_i.min()), float(log_i.max()),
                     bool((v[..., -1] == 1).all())))
        return common.PLAIN.linear_attention(q, k, v, log_g, log_i, chunk=chunk)

    ops = dataclasses.replace(common.PLAIN, linear_attention=spy)
    ssm.mlstm_full(cfg, ops, params["inner"][0][0]["mixer"],
                   torch.from_numpy(_normal(24, (2, 20, cfg.d_model))))
    ((qs, ks, vs, chunk, lo, hi, ones),) = seen
    assert qs == ks == (2, 20, 4, 64) and vs == (2, 20, 4, 65) and chunk == cfg.ssm_chunk
    assert -30.0 <= lo and hi <= 10.0 and ones


# ------------------------------------------------- whole models against JAX


@pytest.mark.parametrize("dtype,pattern", [("f32", None), ("bf16", None), ("f32", TWO_GROUPS)],
                         ids=["f32", "bf16", "f32-two-groups"])
def test_forward_matches_reference(dtype, pattern):
    _, ref_model, rparams, cfg, params = _models(dtype, pattern)
    tokens = _tokens(cfg)
    want = _np(ref_model.forward(rparams, {"tokens": jnp.asarray(tokens, jnp.int32)}))
    for ops in (common.KERNELS, common.PLAIN):
        got = _np(build_model(cfg).forward(params, {"tokens": torch.from_numpy(tokens)},
                                           ops=ops))
        assert got.shape == (2, 12, cfg.padded_vocab)
        _assert_close(got, want, dtype)
        if dtype == "bf16":
            _decisive_top1(got, want)


@pytest.mark.parametrize("dtype,pattern", [("f32", None), ("bf16", None), ("f32", TWO_GROUPS)],
                         ids=["f32", "bf16", "f32-two-groups"])
def test_prefill_and_decode_match_reference(dtype, pattern):
    """init_cache, prefill (logits and every cache tensor: the mLSTM states
    (G, K, B, nh, hd, hd + 1) and the sLSTM's (G, B, nh, hd), same keys) and
    4 decode steps against the reference."""
    _, ref_model, rparams, cfg, params = _models(dtype, pattern)
    model = build_model(cfg)
    B, S, extra = 2, 12, 4
    tokens = _tokens(cfg, seed=1)
    lg, rcache = ref_model.prefill(rparams, {"tokens": jnp.asarray(tokens, jnp.int32)},
                                   max_len=S + extra)
    got, cache = model.prefill(params, {"tokens": torch.from_numpy(tokens)}, max_len=S + extra)
    _assert_close(got, lg, dtype)
    want_leaves, got_leaves = _cache_leaves(rcache), _cache_leaves(cache)
    empty = _cache_leaves(model.init_cache(B, S + extra, "cpu"))
    assert sorted(got_leaves) == sorted(want_leaves) == sorted(empty) == [
        "inner.ssm", "outer.c", "outer.h", "outer.m", "outer.n"]
    for name, a in want_leaves.items():
        assert tuple(got_leaves[name].shape) == a.shape == tuple(empty[name].shape), name
        _assert_state_close(got_leaves[name], a, dtype)
    steps = []
    for i in range(extra):
        tok = _rng(10 + i).integers(0, cfg.vocab, (B, 1))
        lg, rcache = ref_model.decode_step(rparams, jnp.asarray(tok, jnp.int32), rcache,
                                           jnp.int32(S + i))
        got, cache2 = model.decode_step(params, torch.from_numpy(tok), cache, S + i)
        assert cache2 is cache  # updated in place
        _assert_close(got, lg, dtype)
        steps.append((_np(got), _np(lg)))
    for name, a in _cache_leaves(rcache).items():
        _assert_state_close(_cache_leaves(cache)[name], a, dtype)
    if dtype == "bf16":
        _decisive_top1(*(np.concatenate(s) for s in zip(*steps)))


def test_layer_walk_matches_reference_at_its_init():
    """At the reference's own init (f32), every block of the port, from the
    reference's hidden state into it, equals the reference's block: each
    mLSTM block with its state, the sLSTM block with its state, the head."""
    rcfg, _, rparams, cfg, params = _models("f32", TWO_GROUPS, conditioned=False)
    tokens = _tokens(cfg, seed=4)
    x = np.asarray(rparams["embed"])[tokens]
    for g in range(2):
        for j in range(3):
            rp = jax.tree.map(lambda a: a[g, j], rparams["inner"])
            want, rst = ref_ssm.mlstm_full(rcfg, NO_SHARDING, rp["mixer"],
                                           ref_rms_norm(jnp.asarray(x), rp["norm"], 1e-5),
                                           return_state=True)
            want = np.asarray(want) + x
            got, st = hybrid._apply_inner_full(cfg, common.PLAIN, "M", params["inner"][g][j],
                                               torch.from_numpy(x), return_state=True)
            _f32_close(got, want)
            _f32_close(st["ssm"], rst["ssm"], rtol=1e-3)
            x = want
        rp = _take(rparams["outer"], g)
        want, rst = ref_ssm.slstm_full(rcfg, NO_SHARDING, rp["mixer"],
                                       ref_rms_norm(jnp.asarray(x), rp["norm"], 1e-5),
                                       return_state=True)
        want = np.asarray(want) + x
        got, st = hybrid._apply_slstm_full(cfg, common.PLAIN, params["outer"][g],
                                           torch.from_numpy(x))
        _f32_close(got, want)
        for name in rst:
            _f32_close(st[name], rst[name], rtol=1e-3)
        x = want
    head = tfm.unembed(cfg, params, common.PLAIN.rms_norm(torch.from_numpy(x),
                                                          params["final_norm"], cfg.norm_eps))
    want = np.asarray(ref_rms_norm(jnp.asarray(x), rparams["final_norm"], 1e-5)) @ np.asarray(
        rparams["head"])
    _f32_close(head, want)


def test_reference_f32_forward_is_chaotic_at_its_init():
    """Why whole models are held on conditioned parameters: at its own
    init the reference's f32 forward moves by more than 1e-2 of the logits'
    scale when every parameter is scaled by 1 + 2^-20 (eight f32 ulps), a
    hundred times the f32 parity bound; on the conditioned parameters it
    moves by less than 1e-4 of it."""
    for conditioned, lo, hi in ((False, 1e-2, np.inf), (True, 0.0, 1e-4)):
        _, model, rparams, cfg, _ = _models("f32", conditioned=conditioned)
        tokens = jnp.asarray(_tokens(cfg), jnp.int32)
        base = _np(model.forward(rparams, {"tokens": tokens}))
        nudged = _np(model.forward(jax.tree.map(lambda a: a * (1 + 2.0 ** -20), rparams),
                                   {"tokens": tokens}))
        moved = float(np.abs(nudged - base).max()) / float(np.abs(base).max())
        assert lo < moved < hi, (conditioned, moved)


# ------------------------------------------------------- the serving invariant


@pytest.mark.parametrize("ops", ["kernels", "plain"])
def test_prefill_decode_matches_forward(ops):
    """The port's own serving invariant at its own init (bf16, reduced): the
    prefill's last logits within 3e-2, each decode step within the
    reference's xLSTM bound (atol 0.45, rtol 0.25, tests/test_models.py),
    top-1 wherever the top-2 margin exceeds 0.3."""
    the_ops = common.KERNELS if ops == "kernels" else common.PLAIN
    cfg = get_config(ARCH).reduced()
    model = build_model(cfg)
    params = model.init(torch.Generator().manual_seed(0))
    B, S, extra = 2, 12, 4
    tokens = torch.from_numpy(_tokens(cfg, seed=3))
    ext = torch.cat([tokens, (torch.arange(B * extra).reshape(B, extra) + 7) % cfg.vocab], 1)
    full = _np(model.forward(params, {"tokens": ext}, ops=the_ops))
    lg, cache = model.prefill(params, {"tokens": tokens}, max_len=S + extra, ops=the_ops)
    np.testing.assert_allclose(_np(lg[:, 0]), full[:, S - 1], atol=3e-2, rtol=3e-2)
    n_ssd = ssd.ssd_scan.launches
    for i in range(extra):
        lg, cache = model.decode_step(params, ext[:, S + i][:, None], cache, S + i, ops=the_ops)
        got, want = _np(lg[:, 0]), full[:, S + i]
        np.testing.assert_allclose(got, want, atol=0.45, rtol=0.25)
        top2 = np.sort(want, axis=-1)[:, -2:]
        decisive = (top2[:, 1] - top2[:, 0]) > 0.3
        assert (got.argmax(-1) == want.argmax(-1))[decisive].all()
    assert ssd.ssd_scan.launches == n_ssd  # CPU tensors: plain versions


def test_kernels_equal_plain_on_cpu():
    """On CPU tensors every `KERNELS` op is its plain version: forward,
    prefill and a decode step are bit-equal under either."""
    _, _, _, cfg, params = _models("bf16", TWO_GROUPS)
    model = build_model(cfg)
    tokens = torch.from_numpy(_tokens(cfg, seed=5))
    a, b = (model.forward(params, {"tokens": tokens}, ops=o)
            for o in (common.KERNELS, common.PLAIN))
    assert torch.equal(a, b)
    (la, ca), (lb, cb) = (model.prefill(params, {"tokens": tokens}, max_len=13, ops=o)
                          for o in (common.KERNELS, common.PLAIN))
    assert torch.equal(la, lb)
    tok = tokens[:, :1]
    sa, _ = model.decode_step(params, tok, ca, 12, ops=common.KERNELS)
    sb, _ = model.decode_step(params, tok, cb, 12, ops=common.PLAIN)
    assert torch.equal(sa, sb)
    for name, x in _cache_leaves(ca).items():
        assert torch.equal(x, _cache_leaves(cb)[name]), name


# ----------------------------------------------- the scan at the mLSTM's widths


def _wide_gates(seed, shape):
    """log_i spread over the mLSTM's clip range [-30, 10]."""
    return _rng(seed).uniform(-30.0, 10.0, shape).astype(np.float32)


@pytest.mark.parametrize("B,NH,T,DK,DV,chunk", [
    (1, 2, 64, 64, 65, 32),     # reduced xlstm-1.3b: hd 64, v with its ones column
    (1, 2, 96, 96, 97, 32),     # DK past one 64-wide tile, DV = DK + 1
    (2, 1, 64, 128, 40, 64),    # DK two tiles, DV narrower than DK
])
def test_plain_scan_at_wide_states_matches_pallas(B, NH, T, DK, DV, chunk):
    """The plain scan (the kernel's oracle) at DV = DK + 1 and DK > 64, with
    log_i in [-30, 10], against the Pallas kernel in interpret mode at
    tests/test_kernels.py's SSD bound."""
    q = _normal(80, (B, NH, T, DK), 0.5)
    k = _normal(81, (B, NH, T, DK), 0.5)
    v = _normal(82, (B, NH, T, DV), 0.5)
    v[..., -1] = 1.0
    log_g = (-np.logaddexp(0.0, _normal(83, (B, NH, T)))).astype(np.float32)
    log_i = _wide_gates(84, (B, NH, T))
    assert log_i.max() > 9.0 and log_i.min() < -29.0
    y_want, s_want = ssd_k.ssd_scan(*(jnp.asarray(a) for a in (q, k, v, log_g, log_i)),
                                    chunk=chunk, interpret=True)
    y, state = ssd.ssd_scan(*(torch.from_numpy(a) for a in (q, k, v, log_g, log_i)),
                            chunk=chunk)
    assert y.shape == (B, NH, T, DV) and state.shape == (B, NH, DK, DV)
    np.testing.assert_allclose(_np(y), np.asarray(y_want), **SSD_TOL)
    np.testing.assert_allclose(_np(state), np.asarray(s_want), **SSD_TOL)
    y2, s2 = ssd.chunk_parallel_plain(
        *(torch.from_numpy(np.ascontiguousarray(np.swapaxes(a, 1, 2)))
          for a in (q, k, v, log_g, log_i)), chunk=chunk)
    np.testing.assert_allclose(_np(y2.transpose(1, 2)), np.asarray(y_want), **SSD_TOL)
    np.testing.assert_allclose(_np(s2), np.asarray(s_want), **SSD_TOL)


# ------------------------------------------------------- parameters and caches


def test_params_from_numpy_carries_the_xlstm_tree():
    """The reference's (G, K, ...) mLSTM stack and (G, ...) sLSTM stack
    become G lists of K blocks and G blocks, leaf for leaf, each in its
    ParamDef's dtype (b_if and b stay f32 under bf16)."""
    _, _, rparams, cfg, params = _models("bf16", TWO_GROUPS, conditioned=False)
    assert len(params["inner"]) == 2 and len(params["inner"][0]) == 3
    assert len(params["outer"]) == 2 and "shared_attn" not in params
    for g in range(2):
        np.testing.assert_array_equal(_np(params["outer"][g]["mixer"]["r"]),
                                      _np(np.asarray(rparams["outer"]["mixer"]["r"][g])))
        for j in range(3):
            np.testing.assert_array_equal(
                _np(params["inner"][g][j]["mixer"]["wq"]),
                np.asarray(rparams["inner"]["mixer"]["wq"][g, j]).astype(np.float32))
    assert params["inner"][1][2]["mixer"]["b_if"].dtype == torch.float32
    assert params["outer"][1]["mixer"]["b"].dtype == torch.float32
    assert params["inner"][0][0]["mixer"]["wk"].dtype == torch.bfloat16


def test_init_keeps_reference_formulas():
    """The port's own init keeps the reference's: a stacked projection's
    fan-in is G (std 1/sqrt(G), the mLSTM's and the sLSTM's alike); the
    gate and recurrent weights keep their fixed scale 0.02."""
    cfg = get_config(ARCH).reduced(dtype=torch.float32, ssm_pattern=TWO_GROUPS * 2,
                                   n_layers=16)
    params = build_model(cfg).init(torch.Generator().manual_seed(0))
    assert len(params["inner"]) == 4 and len(params["outer"]) == 4
    for w in (params["inner"][3][2]["mixer"]["wq"], params["outer"][2]["mixer"]["w"]):
        assert abs(w.std().item() - 0.5) < 0.02  # 1 / sqrt(4 groups)
    assert abs(params["inner"][0][0]["mixer"]["wif"].std().item() - 0.02) < 2e-3
    assert abs(params["outer"][0]["mixer"]["r"].std().item() - 0.02) < 2e-3


def test_cache_layouts_match_reference_init_cache():
    """Fresh caches: the same keys, shapes, dtypes and values (m starts at
    -30) as the reference's."""
    for pattern in (None, TWO_GROUPS):
        rcfg, cfg = _cfgs("bf16", pattern)
        want = _cache_leaves(ref_build(rcfg).init_cache(3, 20))
        got = _cache_leaves(build_model(cfg).init_cache(3, 20, "cpu"))
        assert sorted(got) == sorted(want)
        for name, a in want.items():
            assert tuple(got[name].shape) == a.shape
            assert str(got[name].dtype).split(".")[-1] == str(a.dtype), name
            np.testing.assert_array_equal(_np(got[name]), _np(a))


@pytest.mark.parametrize("pattern,want", [
    (("M" * 7 + "s") * 6, ("MMMMMMMs", 6)), (TWO_GROUPS, ("MMMs", 2)), ("MMMM", ("M", 4)),
    ("mmmmmammmmma", ("mmmmma", 2)), ("MMMa", ("MMMa", 1)),
])
def test_parse_pattern_agrees_with_reference(pattern, want):
    rcfg, cfg = _cfgs("f32", pattern)
    assert hybrid.parse_pattern(cfg) == ref_hybrid.parse_pattern(rcfg) == want


@pytest.mark.parametrize("pattern", ["MsM", "MsMs" + "MMMs", "sMMM", "mMs"])
def test_parse_pattern_refuses_what_the_assembly_cannot_express(pattern):
    """A period must be inner blocks ('m' or 'M') and at most one outer
    block ('a' or 's') at its end; the reference would misread these."""
    _, cfg = _cfgs("f32", pattern)
    with pytest.raises(ValueError, match="period"):
        hybrid.parse_pattern(cfg)
