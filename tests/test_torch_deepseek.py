"""The port's deepseek-v3-671b (MLA, MoE, MTP), held against the reference
package on `reduced()` configs.

Parameters come from the reference's own init and reach the port through
`params_from_numpy` (the dense and MoE stacks taken apart by layer) or
`parity.tree_from_numpy` (one MLA block); inputs come from numpy.
Tolerances: MLA in f32 to 1e-4 of the reference's scale and in bf16 at
`attn_tol`'s atol and rtol scaled by the output's magnitude; the whole model
in f32 to 1e-4 of scale, bf16 at atol 0.2 / rtol 2e-2 plus the
decisive-margin top-1 rule (ROADMAP §3).  Prefill and decode steps are held
to the reference's, and, as its own test does for this model
(tests/test_models.py), the port's prefill + decode to its forward.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_config
from repro.models import deepseek as ref_ds
from repro.models.common import NO_SHARDING, init_params as ref_init_params
from repro.models.model_zoo import build_model as ref_build
from repro_torch.configs import get_config
from repro_torch.kernels.flash_attention import ops as fa
from repro_torch.models import common, deepseek
from repro_torch.models.model_zoo import build_model
from repro_torch.testing.parity import attn_tol, params_from_numpy, tree_from_numpy

ARCH = "deepseek-v3-671b"
BF16 = dict(atol=0.2, rtol=2e-2)
DTYPES = {"f32": (jnp.float32, torch.float32), "bf16": (jnp.bfloat16, torch.bfloat16)}
OPS = {"kernels": common.KERNELS, "plain": common.PLAIN}


def _np(x) -> np.ndarray:
    return np.asarray(x.float().numpy() if isinstance(x, torch.Tensor) else x, np.float32)


def _tree(params) -> dict:
    return jax.tree.map(lambda a: np.asarray(a).astype(np.float32), params)


def _f32_close(got, want, rel=1e-4) -> None:
    got, want = _np(got), _np(want)
    np.testing.assert_allclose(got, want, rtol=rel,
                               atol=rel * max(1.0, float(np.abs(want).max())))


def _decisive_top1(got, want) -> None:
    got, want = _np(got), _np(want)
    err = np.abs(got - want).max()
    top2 = np.sort(want, axis=-1)[..., -2:]
    decisive = (top2[..., 1] - top2[..., 0]) > 2 * err
    assert decisive.any(), "no decisive positions"
    assert (got.argmax(-1) == want.argmax(-1))[decisive].all()


def _close(got, want, dtype) -> None:
    if dtype == "f32":
        _f32_close(got, want)
    else:
        np.testing.assert_allclose(_np(got), _np(want), **BF16)


def _attn_close(got, want, dtype) -> None:
    """MLA's output: f32 to 1e-4 of scale; bf16 at `attn_tol` relative to the
    output's magnitude (a bf16 output carries one rounding of its own)."""
    if dtype == "f32":
        _f32_close(got, want)
    else:
        scale = max(1.0, float(np.abs(_np(want)).max()))
        t = attn_tol(torch.bfloat16)
        np.testing.assert_allclose(_np(got), _np(want), rtol=t["rtol"], atol=t["atol"] * scale)


def _pair(a: np.ndarray, jdt, tdt):
    j = jnp.asarray(a, jdt)
    return j, torch.from_numpy(np.array(j.astype(jnp.float32))).to(tdt)


def _mla(dtype, seed=0):
    jdt, tdt = DTYPES[dtype]
    rcfg = ref_config(ARCH).reduced(dtype=jdt)
    cfg = get_config(ARCH).reduced(dtype=tdt)
    rp = ref_init_params(ref_ds.mla_defs(rcfg), jax.random.PRNGKey(seed))
    return rcfg, rp, cfg, tree_from_numpy(_tree(rp), deepseek.mla_defs(cfg))


def test_reduced_config_keeps_mla_and_its_widths():
    cfg = get_config(ARCH).reduced()
    assert cfg.mla and cfg.mtp and cfg.family == "moe"
    assert (cfg.n_layers, cfg.dense_layers, cfg.n_experts, cfg.top_k) == (4, 1, 4, 2)
    assert build_model(cfg).mod is deepseek
    full = get_config(ARCH)
    assert full.qk_nope_dim + full.qk_rope_dim == 192 <= fa.MAX_HEAD_DIM
    assert full.v_head_dim == 128


@pytest.mark.parametrize("ops", sorted(OPS))
@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_mla_full_matches_reference(dtype, ops):
    """The expanded form: the output and the latent pair the cache keeps."""
    jdt, tdt = DTYPES[dtype]
    rcfg, rp, cfg, p = _mla(dtype)
    x, tx = _pair(np.random.default_rng(1).standard_normal((2, 10, cfg.d_model)), jdt, tdt)
    pos = np.broadcast_to(np.arange(10), (2, 10))
    want, (ckv, krope) = ref_ds.mla_full(rcfg, NO_SHARDING, rp, x, jnp.asarray(pos))
    got, (c_kv, k_rope) = deepseek.mla_full(cfg, OPS[ops], p, tx, torch.from_numpy(pos.copy()))
    assert got.shape == (2, 10, cfg.d_model) and got.dtype == tdt
    assert c_kv.shape == (2, 10, cfg.kv_lora_rank) and k_rope.shape == (2, 10, cfg.qk_rope_dim)
    _attn_close(got, want, dtype)
    _attn_close(c_kv, ckv, dtype)
    _attn_close(k_rope, krope, dtype)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_mla_decode_matches_reference(dtype):
    """The absorbed form on the same compressed cache (drawn from numpy, 9
    valid rows of 12): the output and the cache with the new row at 9."""
    jdt, tdt = DTYPES[dtype]
    rcfg, rp, cfg, p = _mla(dtype, seed=2)
    rng = np.random.default_rng(3)
    x, tx = _pair(rng.standard_normal((2, 1, cfg.d_model)), jdt, tdt)
    ckv, tckv = _pair(rng.standard_normal((2, 12, cfg.kv_lora_rank)), jdt, tdt)
    krope, tkrope = _pair(rng.standard_normal((2, 12, cfg.qk_rope_dim)), jdt, tdt)
    want, (rckv, rkrope) = ref_ds.mla_decode(rcfg, NO_SHARDING, rp, x, ckv, krope, jnp.int32(9))
    got, (gckv, gkrope) = deepseek.mla_decode(cfg, common.KERNELS, p, tx, tckv, tkrope,
                                              torch.tensor(9))
    assert gckv is tckv and got.shape == (2, 1, cfg.d_model)
    _attn_close(got, want, dtype)
    _attn_close(gckv, rckv, dtype)
    _attn_close(gkrope, rkrope, dtype)


def test_mla_decode_is_the_expanded_form_at_the_last_position():
    """The absorbed decode of the last token over the cache the expanded
    form left for the earlier ones equals the expanded form's last
    position (f32, 1e-4 of scale)."""
    _, _, cfg, p = _mla("f32", seed=4)
    x = torch.from_numpy(np.random.default_rng(5).standard_normal((2, 9, cfg.d_model))).float()
    pos = torch.arange(9).expand(2, 9)
    full, _ = deepseek.mla_full(cfg, common.PLAIN, p, x, pos)
    _, (c_kv, k_rope) = deepseek.mla_full(cfg, common.PLAIN, p, x[:, :8], pos[:, :8])
    ckv = torch.zeros(2, 9, cfg.kv_lora_rank)
    krope = torch.zeros(2, 9, cfg.qk_rope_dim)
    ckv[:, :8], krope[:, :8] = c_kv, k_rope
    step, _ = deepseek.mla_decode(cfg, common.PLAIN, p, x[:, 8:], ckv, krope, 8)
    _f32_close(step[:, 0], full[:, 8])


# ------------------------------------------------------------ whole model


def _models(dtype, seed=0):
    jdt, tdt = DTYPES[dtype]
    rcfg = ref_config(ARCH).reduced(dtype=jdt)
    cfg = get_config(ARCH).reduced(dtype=tdt)
    ref_model = ref_build(rcfg)
    rparams = ref_model.init(jax.random.PRNGKey(seed))
    return rcfg, ref_model, rparams, cfg, params_from_numpy(_tree(rparams), cfg)


def _tokens(cfg, seed=0, B=2, S=12):
    t = np.random.default_rng(seed).integers(0, cfg.vocab, (B, S))
    return jnp.asarray(t, jnp.int32), torch.from_numpy(t)


def test_params_take_the_stacks_apart():
    _, _, rparams, cfg, params = _models("f32")
    assert len(params["dense_layers"]) == cfg.dense_layers == 1
    assert len(params["moe_layers"]) == cfg.n_layers - cfg.dense_layers == 3
    for i, lp in enumerate(params["moe_layers"]):
        np.testing.assert_array_equal(_np(lp["moe"]["gate"]),
                                      np.asarray(rparams["moe_layers"]["moe"]["gate"][i],
                                                 np.float32))
    np.testing.assert_array_equal(_np(params["mtp"]["layer"]["attn"]["kv_b"]),
                                  np.asarray(rparams["mtp"]["layer"]["attn"]["kv_b"],
                                             np.float32))


@pytest.mark.parametrize("ops", sorted(OPS))
@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_forward_matches_reference(dtype, ops):
    _, ref_model, rparams, cfg, params = _models(dtype)
    jt, tt = _tokens(cfg)
    want = ref_model.forward(rparams, {"tokens": jt})
    got = build_model(cfg).forward(params, {"tokens": tt}, ops=OPS[ops])
    assert got.shape == (2, 12, cfg.padded_vocab) == want.shape
    _close(got, want, dtype)
    if dtype == "bf16":
        _decisive_top1(got, want)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_forward_with_mtp_matches_reference(dtype):
    """Both heads: the next-token logits at every position and the MTP
    head's over the first S - 1."""
    rcfg, _, rparams, cfg, params = _models(dtype, seed=1)
    jt, tt = _tokens(cfg, seed=2)
    want, want_mtp = ref_ds.forward_with_mtp(rcfg, NO_SHARDING, rparams, jt)
    got, got_mtp = deepseek.forward_with_mtp(cfg, common.KERNELS, params, tt)
    assert got_mtp.shape == (2, 11, cfg.padded_vocab) == want_mtp.shape
    _close(got, want, dtype)
    _close(got_mtp, want_mtp, dtype)
    if dtype == "bf16":
        _decisive_top1(got_mtp, want_mtp)


def _cache_close(got, want, dtype):
    if dtype == "f32":
        _f32_close(got, want, rel=1e-3)
    else:
        scale = max(4.0, float(np.abs(_np(want)).max()))
        np.testing.assert_allclose(_np(got), _np(want), rtol=BF16["rtol"],
                                   atol=BF16["atol"] * scale / 4)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_prefill_and_decode_match_reference(dtype):
    """The prefill's last logits and compressed cache, then 4 decode steps,
    each side from its own cache, against the reference."""
    _, ref_model, rparams, cfg, params = _models(dtype)
    model = build_model(cfg)
    B, S, extra = 2, 10, 4
    jt, tt = _tokens(cfg, seed=1, B=B, S=S)
    lg, rcache = ref_model.prefill(rparams, {"tokens": jt}, max_len=S + extra)
    got, cache = model.prefill(params, {"tokens": tt}, max_len=S + extra)
    assert got.shape == (B, 1, cfg.padded_vocab)
    _close(got, lg, dtype)
    assert sorted(cache) == sorted(rcache) == ["c_kv", "k_rope"]
    for name in cache:
        assert tuple(cache[name].shape) == tuple(rcache[name].shape)
        _cache_close(cache[name], rcache[name], dtype)
    fed = np.random.default_rng(5).integers(0, cfg.vocab, (B, extra))
    for i in range(extra):
        lg, rcache = ref_model.decode_step(rparams, jnp.asarray(fed[:, i:i + 1], jnp.int32),
                                           rcache, jnp.int32(S + i))
        got, cache = model.decode_step(params, torch.from_numpy(fed[:, i:i + 1]), cache,
                                       torch.tensor(S + i))
        _close(got, lg, dtype)
    for name in cache:
        _cache_close(cache[name], rcache[name], dtype)



@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_decode_step_from_the_same_cache(dtype):
    """One decode step on both sides from the same cache (the reference's
    prefill cache, converted), so the step alone is compared: its logits
    and the cache it writes."""
    _, ref_model, rparams, cfg, params = _models(dtype, seed=2)
    jdt, tdt = DTYPES[dtype]
    B, S = 2, 9
    jt, _ = _tokens(cfg, seed=6, B=B, S=S)
    _, rcache = ref_model.prefill(rparams, {"tokens": jt}, max_len=S + 1)
    cache = {k: torch.from_numpy(np.array(v, np.float32)).to(tdt) for k, v in rcache.items()}
    tok = np.random.default_rng(7).integers(0, cfg.vocab, (B, 1))
    want, rcache = ref_model.decode_step(rparams, jnp.asarray(tok, jnp.int32), rcache,
                                         jnp.int32(S))
    got, cache = build_model(cfg).decode_step(params, torch.from_numpy(tok), cache,
                                              torch.tensor(S))
    assert sorted(cache) == ["c_kv", "k_rope"]
    _close(got, want, dtype)
    if dtype == "bf16":
        _decisive_top1(got, want)
    for name in cache:
        _cache_close(cache[name], rcache[name], dtype)

def test_prefill_and_decode_match_own_forward():
    """The serving invariant in f32, as tests/test_models.py asserts it for
    this model: prefill + step-by-step decode equal the teacher-forced
    forward at every position (the reduced capacity factor drops nothing)."""
    _, _, _, cfg, params = _models("f32", seed=3)
    model = build_model(cfg)
    B, S, extra = 2, 10, 4
    _, tt = _tokens(cfg, seed=4, B=B, S=S + extra)
    full = model.forward(params, {"tokens": tt})
    lg, cache = model.prefill(params, {"tokens": tt[:, :S]}, max_len=S + extra)
    _f32_close(lg[:, 0], full[:, S - 1])
    for i in range(extra - 1):
        lg, cache = model.decode_step(params, tt[:, S + i:S + i + 1], cache, S + i)
        _f32_close(lg[:, 0], full[:, S + i])


def test_init_cache_is_compressed():
    cfg = get_config(ARCH).reduced()
    cache = build_model(cfg).init_cache(2, 64, "cpu")
    assert set(cache) == {"c_kv", "k_rope"}
    assert cache["c_kv"].shape == (cfg.n_layers, 2, 64, cfg.kv_lora_rank)
    assert cache["k_rope"].shape == (cfg.n_layers, 2, 64, cfg.qk_rope_dim)
