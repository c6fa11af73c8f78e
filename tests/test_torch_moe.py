"""The port's MoE FFN and MoE transformer (llama4-maverick-400b-a17b), held
against the reference package on `reduced()` configs, and the sliced draw
of large parameter leaves.

Parameters come from the reference's own init and reach the port through
`parity.tree_from_numpy` / `params_from_numpy`; inputs come from numpy.
Tolerances: `moe_ffn` in f32 to 1e-5 of the reference's scale with the
routing ids equal, the whole model in f32 to 1e-4 of scale, bf16 at atol 0.2
/ rtol 2e-2 plus the decisive-margin top-1 rule (ROADMAP §3).  The port's
own prefill + decode against its forward is not asserted for llama4: the
reference's own check of that is an xfail (tests/test_models.py, MoE
routing).
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_config
from repro.models import moe as ref_moe
from repro.models.common import NO_SHARDING, init_params as ref_init_params
from repro.models.model_zoo import build_model as ref_build
from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.models import common, moe
from repro_torch.models.common import ParamDef
from repro_torch.models.model_zoo import build_model
from repro_torch.testing.parity import params_from_numpy, tree_from_numpy

ARCH = "llama4-maverick-400b-a17b"
BF16 = dict(atol=0.2, rtol=2e-2)
DTYPES = {"f32": (jnp.float32, torch.float32), "bf16": (jnp.bfloat16, torch.bfloat16)}
OPS = {"kernels": common.KERNELS, "plain": common.PLAIN}
# reduced() overrides of the FFN cases: drop-free (reduced's capacity_factor
# 8.0), with capacity drops (tests/test_models.py's 0.5), dispatched in two
# groups, and both
FFN_CASES = {"drop_free": {}, "drops": dict(capacity_factor=0.5),
             "groups": dict(moe_dispatch_groups=2),
             "groups_drops": dict(moe_dispatch_groups=2, capacity_factor=0.5)}


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


def _pair(a: np.ndarray, jdt, tdt):
    j = jnp.asarray(a, jdt)
    return j, torch.from_numpy(np.array(j.astype(jnp.float32))).to(tdt)


def _ffn(dtype, seed=0, **overrides):
    """The reference's and the port's config, and one MoE FFN's parameters
    on each side (the reference's init)."""
    jdt, tdt = DTYPES[dtype]
    rcfg = ref_config(ARCH).reduced(dtype=jdt, **overrides)
    cfg = get_config(ARCH).reduced(dtype=tdt, **overrides)
    rp = ref_init_params(ref_moe.moe_ffn_defs(rcfg), jax.random.PRNGKey(seed))
    return rcfg, rp, cfg, tree_from_numpy(_tree(rp), moe.moe_ffn_defs(cfg))


def _ref_keep(ids: np.ndarray, E: int, cap: int, G: int) -> np.ndarray:
    """Whether each (token, choice) of (N, k) ids is within its expert's
    capacity, counted in flat (token, choice) order within each of G
    groups, as a stable sort by expert orders them."""
    N, k = ids.shape
    keep = np.zeros(N * k, bool)
    for g, flat in enumerate(ids.reshape(G, -1)):
        seen = np.zeros(E, int)
        for j, e in enumerate(flat):
            keep[g * flat.size + j] = seen[e] < cap
            seen[e] += 1
    return keep.reshape(N, k)


@pytest.mark.parametrize("case", sorted(FFN_CASES))
def test_moe_ffn_matches_reference_f32(case):
    """f32 to 1e-5 of scale; each token's expert ids equal the reference's
    router, and its kept choices those of the capacity rule."""
    rcfg, rp, cfg, p = _ffn("f32", **FFN_CASES[case])
    x, tx = _pair(np.random.default_rng(1).standard_normal((2, 12, cfg.d_model)),
                  jnp.float32, torch.float32)
    want = ref_moe.moe_ffn(rcfg, NO_SHARDING, rp, x)
    got = moe.moe_ffn(cfg, common.PLAIN, p, tx)
    assert got.shape == (2, 12, cfg.d_model) and got.dtype == torch.float32
    _f32_close(got, want, rel=1e-5)

    probs = jax.nn.softmax(jnp.einsum("nd,de->ne", x.reshape(24, -1), rp["router"]), axis=-1)
    ref_ids = np.asarray(jax.lax.top_k(probs, rcfg.top_k)[1])
    ids, keep = moe.routing(cfg, p, tx)
    np.testing.assert_array_equal(ids.reshape(24, -1).numpy(), ref_ids)
    G = moe._groups(cfg, 24)
    assert G == (2 if cfg.moe_dispatch_groups == 2 else 1)
    want_keep = _ref_keep(ref_ids, cfg.n_experts, moe.capacity(cfg, 24 // G), G)
    np.testing.assert_array_equal(keep.reshape(24, -1).numpy(), want_keep)
    if case == "drops":
        assert not want_keep.all(), "the capacity factor 0.5 case drops nothing"
    if case in ("drop_free", "groups"):
        assert want_keep.all()


def test_moe_ffn_matches_reference_bf16():
    rcfg, rp, cfg, p = _ffn("bf16")
    x, tx = _pair(np.random.default_rng(2).standard_normal((2, 12, cfg.d_model)),
                  jnp.bfloat16, torch.bfloat16)
    want = ref_moe.moe_ffn(rcfg, NO_SHARDING, rp, x)
    got = moe.moe_ffn(cfg, common.KERNELS, p, tx)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(_np(got), _np(want), **BF16)


def test_dispatch_groups_need_two_tokens_a_group():
    """`moe_dispatch_groups` applies only where it divides the tokens into
    groups of at least two, as in the reference."""
    cfg = get_config(ARCH).reduced(moe_dispatch_groups=4)
    assert [moe._groups(cfg, n) for n in (8, 12, 6, 4, 2)] == [4, 4, 1, 1, 1]
    assert moe._groups(get_config(ARCH).reduced(), 12) == 1


def test_capacity_is_the_reference_formula():
    cfg = get_config(ARCH)
    assert moe.capacity(cfg, 1024) == max(8, math.ceil(1024 * 1 / 128 * 1.25)) == 10
    assert moe.capacity(cfg, 2) == 8
    ds = get_config("deepseek-v3-671b")
    assert moe.capacity(ds, 1024) == math.ceil(1024 * 8 / 256 * 1.25) == 40


# ------------------------------------------------------------ whole model


def _models(dtype, seed=0, **overrides):
    jdt, tdt = DTYPES[dtype]
    rcfg = ref_config(ARCH).reduced(dtype=jdt, **overrides)
    cfg = get_config(ARCH).reduced(dtype=tdt, **overrides)
    ref_model = ref_build(rcfg)
    rparams = ref_model.init(jax.random.PRNGKey(seed))
    return ref_model, rparams, cfg, params_from_numpy(_tree(rparams), cfg)


def _tokens(cfg, seed=0, B=2, S=12):
    t = np.random.default_rng(seed).integers(0, cfg.vocab, (B, S))
    return jnp.asarray(t, jnp.int32), torch.from_numpy(t)


def test_reduced_config_is_the_moe_family():
    cfg = get_config(ARCH).reduced()
    assert cfg.family == "moe" and not cfg.mla and cfg.n_layers == 2
    assert (cfg.n_experts, cfg.top_k, cfg.n_shared_experts) == (4, 1, 1)
    assert build_model(cfg).mod is moe


@pytest.mark.parametrize("ops", sorted(OPS))
@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_forward_matches_reference(dtype, ops):
    ref_model, rparams, cfg, params = _models(dtype)
    jt, tt = _tokens(cfg)
    want = ref_model.forward(rparams, {"tokens": jt})
    got = build_model(cfg).forward(params, {"tokens": tt}, ops=OPS[ops])
    assert got.shape == (2, 12, cfg.padded_vocab) == want.shape
    _close(got, want, dtype)
    if dtype == "bf16":
        _decisive_top1(got, want)


def test_forward_with_capacity_drops_matches_reference():
    """reduced(capacity_factor=0.5), as tests/test_models.py drops tokens:
    the same tokens are dropped on both sides."""
    ref_model, rparams, cfg, params = _models("f32", capacity_factor=0.5)
    jt, tt = _tokens(cfg, seed=3)
    want = ref_model.forward(rparams, {"tokens": jt})
    got = build_model(cfg).forward(params, {"tokens": tt})
    _f32_close(got, want)


def _cache_close(got, want, dtype):
    if dtype == "f32":
        _f32_close(got, want, rel=1e-3)
    else:
        scale = max(4.0, float(np.abs(_np(want)).max()))
        np.testing.assert_allclose(_np(got), _np(want), rtol=BF16["rtol"],
                                   atol=BF16["atol"] * scale / 4)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_prefill_and_decode_match_reference(dtype):
    """The prefill's last logits and KV cache, then 4 decode steps from the
    same cache (the reference's own cache fed back on both sides is not
    needed: each side continues its own), against the reference."""
    ref_model, rparams, cfg, params = _models(dtype)
    model = build_model(cfg)
    B, S, extra = 2, 10, 4
    jt, tt = _tokens(cfg, seed=1, B=B, S=S)
    lg, rcache = ref_model.prefill(rparams, {"tokens": jt}, max_len=S + extra)
    got, cache = model.prefill(params, {"tokens": tt}, max_len=S + extra)
    assert got.shape == (B, 1, cfg.padded_vocab)
    _close(got, lg, dtype)
    assert sorted(cache) == sorted(rcache) == ["k", "v"]
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
    ref_model, rparams, cfg, params = _models(dtype, seed=2)
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
    assert sorted(cache) == ["k", "v"]
    _close(got, want, dtype)
    if dtype == "bf16":
        _decisive_top1(got, want)
    for name in cache:
        _cache_close(cache[name], rcache[name], dtype)

# ------------------------------------------------------------ the init


def _ported_defs():
    """The templates of every config the port built before the MoE family."""
    return [build_model(get_config(a)).defs for a in ARCH_IDS
            if get_config(a).family != "moe"]


def _leaves(node):
    if isinstance(node, ParamDef):
        yield node
    elif isinstance(node, list):
        for v in node:
            yield from _leaves(v)
    else:
        for v in node.values():
            yield from _leaves(v)


def test_other_families_draw_every_leaf_whole():
    """Every leaf of the dense, VLM, hybrid, xLSTM and enc-dec configs is
    under the slicing threshold, so it is drawn in one call, as before the
    slices (the largest, qwen3-14b's embedding, 7.8e8 elements)."""
    largest = max(math.prod(d.shape) for defs in _ported_defs() for d in _leaves(defs))
    assert largest == 152064 * 5120 < common.SLICE_ELEMS


def test_moe_expert_leaves_are_drawn_in_slices():
    """The expert leaves of both MoE models, and their embeddings and heads
    (llama4's 1.04e9 elements, deepseek-v3's 9.3e8), are sliced."""
    llama4 = build_model(get_config(ARCH)).defs
    ds = build_model(get_config("deepseek-v3-671b")).defs
    for leaf in (llama4["layers"][0]["moe"]["gate"], ds["moe_layers"][0]["moe"]["gate"],
                 llama4["embed"], llama4["head"], ds["embed"], ds["head"]):
        assert math.prod(leaf.shape) > common.SLICE_ELEMS


def test_a_leaf_under_the_threshold_is_drawn_as_one_draw():
    d = ParamDef((6, 5, 4), dtype=torch.bfloat16)
    got = d.initialize(torch.Generator().manual_seed(3))
    x = torch.randn((6, 5, 4), generator=torch.Generator().manual_seed(3))
    assert torch.equal(got, (x * (1 / math.sqrt(6))).to(torch.bfloat16))


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "f32"])
def test_a_leaf_over_the_threshold_is_drawn_in_slices(monkeypatch, dtype):
    """Slices of the leading axis of at most SLICE_ELEMS elements, each a
    draw of its own from the generator in turn, scaled and cast as a whole
    draw would be."""
    monkeypatch.setattr(common, "SLICE_ELEMS", 45)
    d = ParamDef((7, 5, 4), dtype=dtype, stacked=3)  # 140 elements: slices of 2 rows
    got = d.initialize(torch.Generator().manual_seed(4))
    g = torch.Generator().manual_seed(4)
    parts = [torch.randn((min(2, 7 - i), 5, 4), generator=g) for i in range(0, 7, 2)]
    want = (torch.cat(parts) * (1 / math.sqrt(3))).to(dtype)
    assert got.dtype == dtype and torch.equal(got, want)
    # a draw of its own: not the whole leaf's one draw
    whole = torch.randn((7, 5, 4), generator=torch.Generator().manual_seed(4))
    assert not torch.equal(got, (whole * (1 / math.sqrt(3))).to(dtype))


def test_init_draws_moe_models():
    """The reduced MoE models initialise on the CPU with the stacked fan-in
    of their templates, and the router in f32."""
    for arch in (ARCH, "deepseek-v3-671b"):
        cfg = get_config(arch).reduced()
        params = build_model(cfg).init(torch.Generator().manual_seed(0))
        lp = params["layers"][0] if "layers" in params else params["moe_layers"][0]
        assert lp["moe"]["router"].dtype == torch.float32
        assert lp["moe"]["gate"].dtype == torch.bfloat16
        assert tuple(lp["moe"]["gate"].shape) == (cfg.n_experts, cfg.d_model, cfg.moe_d_ff)
        n = sum(p.numel() for p in params.parameters())
        assert n == sum(math.prod(d.shape) for d in _leaves(build_model(cfg).defs))
