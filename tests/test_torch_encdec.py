"""The port's encoder-decoder (seamless-m4t-large-v2: a bidirectional encoder
over precomputed frame embeddings, a causal text decoder with
cross-attention), held against the reference package on `reduced()`
configs.

Parameters come from the reference (`model.init`) and reach the port
through `params_from_numpy` (the reference's stacked `enc_layers` and
`dec_layers` become the port's lists); token ids and frame embeddings come
from numpy.  Tolerances, as in tests/test_torch_models.py (ROADMAP §3): f32
to 1e-4 of the reference's scale (cache tensors rtol 1e-3); bf16 atol 0.2
/ rtol 2e-2 (cache tensors at that atol scaled to their own magnitude) plus
the decisive-margin top-1 rule; the port's own serving invariant at
tests/test_models.py's bounds.

**Conditioning**, as tests/test_torch_xlstm.py does for xLSTM.  The
reference's init takes a stacked leaf's fan-in from its leading (layer)
axis: at `reduced()` (two layers each side) every projection draws
N(0, 1/2) at width 128, the encoder's hidden states reach the thousands and
attention is nearly one-hot.  The reference's own f32 forward then moves
by up to 4e-4 of the logits' scale when its parameters are scaled by
1 + 2^-20 (`test_reference_f32_forward_is_sensitive_at_its_init`), past the
1e-4 bound, so whole models are held on the same parameters with every
stacked projection rescaled to the fan-in of its input width
(`condition_fan_in`); each encoder layer and decoder block is held at the
reference's own init from the same input
(`test_layers_match_reference_at_its_init`).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_config
from repro.models import common as ref_common, encdec as ref_encdec
from repro.models.common import NO_SHARDING
from repro.models.model_zoo import build_model as ref_build
from repro_torch.configs import get_config
from repro_torch.kernels.decode_attention import ops as da
from repro_torch.kernels.flash_attention import ops as fa
from repro_torch.models import common, encdec
from repro_torch.models.model_zoo import build_model
from repro_torch.testing.parity import condition_fan_in, params_from_numpy

ARCH = "seamless-m4t-large-v2"
BF16 = dict(atol=0.2, rtol=2e-2)
DTYPES = {"f32": (jnp.float32, torch.float32), "bf16": (jnp.bfloat16, torch.bfloat16)}
OPS = {"kernels": common.KERNELS, "plain": common.PLAIN}


def _rng(seed):
    return np.random.default_rng(seed)


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


def _close(got, want, dtype) -> None:
    if dtype == "f32":
        _f32_close(got, want)
    else:
        np.testing.assert_allclose(_np(got), _np(want), **BF16)


def _cache_close(got, want, dtype) -> None:
    if dtype == "f32":
        _f32_close(got, want, rtol=1e-3)
    else:
        scale = max(4.0, float(np.abs(_np(want)).max()))
        np.testing.assert_allclose(_np(got), _np(want), rtol=BF16["rtol"],
                                   atol=BF16["atol"] * scale / 4)


def _models(dtype, seed=0, conditioned=True):
    """The reference's and the port's reduced models on the same parameters,
    the reference's init, conditioned unless asked not to; and the numpy
    tree."""
    jdt, tdt = DTYPES[dtype]
    rcfg = ref_config(ARCH).reduced(dtype=jdt)
    cfg = get_config(ARCH).reduced(dtype=tdt)
    ref_model = ref_build(rcfg)
    rparams = ref_model.init(jax.random.PRNGKey(seed))
    tree = jax.tree.map(lambda a: np.asarray(a).astype(np.float32), rparams)
    if conditioned:
        tree = condition_fan_in(tree, build_model(cfg).defs)
        rparams = jax.tree.map(lambda a, r: jnp.asarray(a).astype(r.dtype), tree, rparams)
        tree = jax.tree.map(lambda a: np.asarray(a).astype(np.float32), rparams)
    return rcfg, ref_model, rparams, cfg, params_from_numpy(tree, cfg), tree


def _frames(cfg, dtype, seed=0, B=2, S=12):
    """Frame embeddings (B, S, d), the same values on both sides."""
    jdt, tdt = DTYPES[dtype]
    j = jnp.asarray(_rng(seed).standard_normal((B, S, cfg.d_model)).astype(np.float32), jdt)
    return j, torch.from_numpy(np.array(j.astype(jnp.float32))).to(tdt)


def test_params_from_numpy_converts_the_encdec_tree():
    """The reference's stacked enc_layers / dec_layers become lists of the
    same layers, every leaf equal to its slice; the unstacked leaves as
    they are."""
    _, _, _, cfg, params, tree = _models("f32", conditioned=False)
    assert len(params["enc_layers"]) == cfg.encoder_layers == 2
    assert len(params["dec_layers"]) == cfg.n_layers == 2
    for name, n in (("enc_layers", cfg.encoder_layers), ("dec_layers", cfg.n_layers)):
        flat = jax.tree_util.tree_flatten_with_path(tree[name])[0]
        for i in range(n):
            for path, a in flat:
                node = params[name][i]
                for key in path:
                    node = node[key.key]
                np.testing.assert_array_equal(node.numpy(), a[i])
    for name in ("embed", "enc_norm", "final_norm", "head"):
        np.testing.assert_array_equal(params[name].numpy(), tree[name])
    with pytest.raises(ValueError, match="stacked leaf"):
        params_from_numpy(tree, get_config(ARCH).reduced(encoder_layers=3))


@pytest.mark.parametrize("ops", sorted(OPS))
@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_encode_matches_reference(dtype, ops):
    rcfg, _, rparams, cfg, params, _ = _models(dtype)
    jf, tf = _frames(cfg, dtype)
    want = ref_encdec.encode(rcfg, NO_SHARDING, rparams, jf)
    got = encdec.encode(cfg, OPS[ops], params, tf)
    assert got.shape == (2, 12, cfg.d_model) and got.dtype == DTYPES[dtype][1]
    _close(got, want, dtype)


@pytest.mark.parametrize("T,S_enc", [(7, 12), (12, 5), (1, 9), (10, 10)],
                         ids=["T<S", "T>S", "one_token", "T=S"])
@pytest.mark.parametrize("ops", sorted(OPS))
@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_forward_matches_reference(dtype, ops, T, S_enc):
    """The teacher-forced forward: T text positions cross-attend over S_enc
    frames (flash attention at Sq != Sk under `KERNELS`)."""
    _, ref_model, rparams, cfg, params, _ = _models(dtype)
    jf, tf = _frames(cfg, dtype, seed=1, S=S_enc)
    tokens = _rng(2).integers(0, cfg.vocab, (2, T))
    want = _np(ref_model.forward(rparams, {"tokens": jnp.asarray(tokens, jnp.int32),
                                           "frames": jf}))
    got = _np(build_model(cfg).forward(params, {"tokens": torch.from_numpy(tokens),
                                                "frames": tf}, ops=OPS[ops]))
    assert got.shape == (2, T, cfg.padded_vocab) == want.shape
    _close(got, want, dtype)
    if dtype == "bf16" and T > 1:
        _decisive_top1(got, want)


@pytest.mark.parametrize("T,S_enc", [(7, 12), (12, 5)], ids=["T<S", "T>S"])
def test_cross_block_attends_over_every_frame(T, S_enc):
    """The cross-attention block under `KERNELS` (flash attention's plain
    version on the CPU, non-causal at Sq != Sk) equals `PLAIN` (the
    reference's chunked attention) from the same input."""
    _, _, _, cfg, params, _ = _models("f32")
    lp = params["dec_layers"][1]
    x = torch.from_numpy(_rng(6).standard_normal((2, T, cfg.d_model)).astype(np.float32))
    enc_out = torch.from_numpy(_rng(7).standard_normal((2, S_enc, cfg.d_model)).astype(
        np.float32))
    got = encdec.cross_block_full(cfg, common.KERNELS, lp, x, enc_out)
    want = encdec.cross_block_full(cfg, common.PLAIN, lp, x, enc_out)
    _f32_close(got, want)
    # causal attention over the frames would differ at every position but the last
    h = common.rms_norm(x, lp["cross_norm"], cfg.norm_eps)
    q = (h @ lp["cross"]["wq"]).reshape(2, T, cfg.n_heads, cfg.hd)
    k, v = encdec.cross_kv(cfg, lp["cross"], enc_out)
    causal = fa.attention_bthd(q, k, v, causal=True)
    assert not torch.allclose(causal, common.KERNELS.noncausal_attention(cfg, q, k, v))


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_prefill_matches_reference(dtype):
    """The BOS step's logits and every cache tensor: cross_k / cross_v
    projected for every decoder layer, the self-attention cache's row 0."""
    _, ref_model, rparams, cfg, params, _ = _models(dtype)
    jf, tf = _frames(cfg, dtype, seed=3)
    lg, rcache = ref_model.prefill(rparams, {"frames": jf}, max_len=16)
    got, cache = build_model(cfg).prefill(params, {"frames": tf}, max_len=16)
    assert got.shape == (2, 1, cfg.padded_vocab)
    _close(got, lg, dtype)
    assert sorted(cache) == sorted(rcache) == ["cross_k", "cross_v", "k", "v"]
    for name, a in rcache.items():
        assert tuple(cache[name].shape) == a.shape, name
        assert cache[name].dtype == DTYPES[dtype][1]
        _cache_close(cache[name], a, dtype)
    assert cache["cross_k"].shape[2] == 12 and cache["k"].shape[2] == 16
    assert not cache["k"][:, :, 1:].any()


def test_prefill_defaults_max_len_to_the_frames():
    _, ref_model, rparams, cfg, params, _ = _models("f32")
    jf, tf = _frames(cfg, "f32", S=9)
    _, rcache = ref_model.prefill(rparams, {"frames": jf})
    _, cache = build_model(cfg).prefill(params, {"frames": tf})
    assert {k: tuple(v.shape) for k, v in cache.items()} == {
        k: v.shape for k, v in rcache.items()}


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_decode_steps_match_reference(dtype):
    """4 decode steps after the BOS prefill (cur_len 1..4), logits and
    caches against the reference's."""
    _, ref_model, rparams, cfg, params, _ = _models(dtype)
    model = build_model(cfg)
    jf, tf = _frames(cfg, dtype, seed=4)
    _, rcache = ref_model.prefill(rparams, {"frames": jf}, max_len=8)
    _, cache = model.prefill(params, {"frames": tf}, max_len=8)
    steps = []
    for i in range(1, 5):
        tok = _rng(20 + i).integers(0, cfg.vocab, (2, 1))
        lg, rcache = ref_model.decode_step(rparams, jnp.asarray(tok, jnp.int32), rcache,
                                           jnp.int32(i))
        got, cache2 = model.decode_step(params, torch.from_numpy(tok), cache,
                                        torch.tensor(i, dtype=torch.int32))
        assert cache2 is cache and got.shape == (2, 1, cfg.padded_vocab)
        _close(got, lg, dtype)
        steps.append((_np(got), _np(lg)))
    for name, a in rcache.items():
        _cache_close(cache[name], a, dtype)
    if dtype == "bf16":
        _decisive_top1(*(np.concatenate(s) for s in zip(*steps)))


@pytest.mark.parametrize("ops", sorted(OPS))
def test_audio_prefill_decode_consistency(ops):
    """tests/test_models.py's enc-dec invariant on the port: the prefill's
    BOS logits and 3 decode steps equal the teacher-forced forward over
    [bos, t1, t2, ...] (BOS at 3e-2, steps at 5e-2), bf16.  No kernel
    launches on CPU tensors."""
    cfg = get_config(ARCH).reduced()
    model = build_model(cfg)
    params = model.init(torch.Generator().manual_seed(0))
    B, S = 2, 12
    frames = torch.from_numpy(_rng(5).standard_normal((B, S, cfg.d_model))).to(torch.bfloat16)
    text = torch.arange(B * S).reshape(B, S) % cfg.vocab
    toks = torch.cat([torch.ones((B, 1), dtype=torch.long), text[:, :S - 1]], dim=1)
    n_fa, n_da = fa.flash_attention.launches, da.decode_attention.launches
    full = _np(model.forward(params, {"tokens": toks, "frames": frames}, ops=OPS[ops]))
    lg, cache = model.prefill(params, {"frames": frames}, max_len=S, ops=OPS[ops])
    np.testing.assert_allclose(_np(lg[:, 0]), full[:, 0], atol=3e-2, rtol=3e-2)
    for i in range(1, 4):
        lg, cache = model.decode_step(params, toks[:, i][:, None], cache, i, ops=OPS[ops])
        np.testing.assert_allclose(_np(lg[:, 0]), full[:, i], atol=5e-2, rtol=5e-2)
    assert (fa.flash_attention.launches, da.decode_attention.launches) == (n_fa, n_da)


def test_prefill_decode_matches_forward_in_f32():
    """The same invariant in f32 over 6 steps, at 1e-4 of the logits'
    scale: decode (self-attention over the cache, cross-attention over all
    S_enc rows) is the teacher-forced forward's math."""
    cfg = get_config(ARCH).reduced(dtype=torch.float32)
    model = build_model(cfg)
    params = model.init(torch.Generator().manual_seed(1))
    frames = torch.from_numpy(_rng(8).standard_normal((2, 9, cfg.d_model)).astype(np.float32))
    toks = torch.from_numpy(_rng(9).integers(0, cfg.vocab, (2, 7)))
    toks[:, 0] = 1
    full = model.forward(params, {"tokens": toks, "frames": frames})
    lg, cache = model.prefill(params, {"frames": frames}, max_len=7)
    steps = [lg[:, 0]]
    for i in range(1, 7):
        lg, cache = model.decode_step(params, toks[:, i:i + 1], cache, i)
        steps.append(lg[:, 0])
    _f32_close(torch.stack(steps, dim=1), full)


def test_reference_f32_forward_is_sensitive_at_its_init():
    """Why whole models are held on conditioned parameters: at its own
    init (seeds 0-2) the reference's f32 forward moves by more than 1e-4
    of the logits' scale, the f32 parity bound, when every parameter is
    scaled by 1 + 2^-20 (eight f32 ulps); on the conditioned parameters by
    less than a tenth of it."""
    moved = {}
    for conditioned in (False, True):
        for seed in range(3):
            _, model, rparams, cfg, _, _ = _models("f32", seed=seed, conditioned=conditioned)
            jf, _ = _frames(cfg, "f32", seed=seed, S=10)
            batch = {"tokens": jnp.asarray(_rng(seed).integers(0, cfg.vocab, (2, 10)),
                                           jnp.int32), "frames": jf}
            base = _np(model.forward(rparams, batch))
            nudged = _np(model.forward(jax.tree.map(lambda a: a * (1 + 2.0 ** -20), rparams),
                                       batch))
            moved[conditioned, seed] = float(np.abs(nudged - base).max() / np.abs(base).max())
    assert max(moved[False, s] for s in range(3)) > 1e-4, moved
    assert max(moved[True, s] for s in range(3)) < 1e-5, moved


@pytest.mark.parametrize("ops", sorted(OPS))
def test_layers_match_reference_at_its_init(ops):
    """Each encoder layer (followed by the encoder's norm, as the
    reference's `encode` over that one layer gives it) and each decoder
    layer, its cross-attention block alone too, from the same f32 input at
    the reference's own init, within 1e-4 of scale."""
    rcfg, _, rparams, cfg, params, _ = _models("f32", conditioned=False)
    jf, tf = _frames(cfg, "f32", seed=11)
    the_ops = OPS[ops]
    pos = torch.arange(12).expand(2, 12)
    for i, lp in enumerate(params["enc_layers"]):
        one = {"enc_layers": jax.tree.map(lambda a: a[i:i + 1], rparams["enc_layers"]),
               "enc_norm": rparams["enc_norm"]}
        want = ref_encdec.encode(rcfg, NO_SHARDING, one, jf)
        got = the_ops.rms_norm(encdec.enc_layer(cfg, the_ops, lp, tf, pos),
                               params["enc_norm"], cfg.norm_eps)
        _f32_close(got, want)
    enc_j, enc_t = _frames(cfg, "f32", seed=12, S=9)
    x_j, x_t = _frames(cfg, "f32", seed=13, S=5)
    jpos = jnp.broadcast_to(jnp.arange(5), (2, 5))
    for i, lp in enumerate(params["dec_layers"]):
        rlp = jax.tree.map(lambda a: a[i], rparams["dec_layers"])
        want, (rk, rv) = ref_encdec._dec_layer_full(rcfg, NO_SHARDING, rlp, x_j, jpos, enc_j)
        got, (k, v) = encdec.dec_layer_full(cfg, the_ops, lp, x_t, pos[:, :5], enc_t)
        _f32_close(got, want)
        _f32_close(k, rk)
        _f32_close(v, rv)
        h = ref_common.rms_norm(x_j, rlp["cross_norm"], rcfg.norm_eps)
        want = x_j + ref_encdec._cross_attn_full(rcfg, NO_SHARDING, rlp["cross"], h, enc_j)
        _f32_close(encdec.cross_block_full(cfg, the_ops, lp, x_t, enc_t), want)


def test_init_cache_matches_reference():
    """Fresh caches: the same keys, shapes and dtypes as the reference's,
    with and without enc_len."""
    rmodel, model = ref_build(ref_config(ARCH).reduced()), build_model(get_config(ARCH).reduced())
    for enc_len in (None, 30):
        want = ref_encdec.init_cache(rmodel.cfg, NO_SHARDING, 3, 20, enc_len=enc_len)
        got = model.init_cache(3, 20, "cpu", enc_len=enc_len)
        assert sorted(got) == sorted(want)
        for name, a in want.items():
            assert tuple(got[name].shape) == a.shape
            assert str(got[name].dtype).split(".")[-1] == str(a.dtype), name
            assert not got[name].any()
    with pytest.raises(ValueError, match="enc_len"):
        build_model(get_config("stablelm-3b").reduced()).init_cache(1, 4, "cpu", enc_len=8)


def test_init_keeps_reference_formulas():
    """Encoder and decoder matrices at their stack's fan-in (the encoder's
    and the decoder's layer counts), the embedding 0.02, norms ones."""
    cfg = get_config(ARCH).reduced(n_layers=4, encoder_layers=9, dtype=torch.float32)
    params = build_model(cfg).init(torch.Generator().manual_seed(0))
    assert len(params["enc_layers"]) == 9 and len(params["dec_layers"]) == 4
    assert abs(params["enc_layers"][2]["mlp"]["up"].std().item() - 1 / 3) < 0.02
    assert abs(params["dec_layers"][3]["cross"]["wk"].std().item() - 0.5) < 0.02
    assert abs(params["embed"].std().item() - 0.02) < 1e-3
    assert (params["dec_layers"][0]["cross_norm"] == 1).all()
    assert (params["enc_norm"] == 1).all()
