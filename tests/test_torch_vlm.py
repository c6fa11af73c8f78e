"""The port's VLM (llava-next-34b: a dense backbone after precomputed patch
embeddings), held against the reference package on `reduced()` configs.

Parameters come from the reference (`model.init`) and reach the port
through `params_from_numpy`; token ids and patch embeddings come from numpy
(patches as tests/test_models.py draws them: normal x 0.1).  Tolerances, as
in tests/test_torch_models.py (ROADMAP §3): f32 to 1e-4 of the reference's
scale; bf16 atol 0.2 / rtol 2e-2 plus the decisive-margin top-1 rule; the
port's own serving invariant at tests/test_models.py's bounds.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_config
from repro.models.model_zoo import batch_text_offset as ref_text_offset, build_model as ref_build
from repro.serving.engine import split_stages as ref_split
from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.kernels.decode_attention import ops as da
from repro_torch.kernels.flash_attention import ops as fa
from repro_torch.models import common, transformer as tfm
from repro_torch.models.model_zoo import batch_text_offset, build_model
from repro_torch.serving.engine import split_stages
from repro_torch.testing.parity import params_from_numpy

ARCH = "llava-next-34b"
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


def _models(dtype, seed=0):
    jdt, tdt = DTYPES[dtype]
    rcfg = ref_config(ARCH).reduced(dtype=jdt)
    cfg = get_config(ARCH).reduced(dtype=tdt)
    ref_model = ref_build(rcfg)
    rparams = ref_model.init(jax.random.PRNGKey(seed))
    tree = jax.tree.map(lambda a: np.asarray(a).astype(np.float32), rparams)
    return rcfg, ref_model, rparams, cfg, params_from_numpy(tree, cfg)


def _batches(cfg, dtype, seed=0, B=2, S=6):
    """(reference batch, port batch): S text tokens after the config's
    frontend_tokens patch embeddings, the same values on both sides."""
    jdt, tdt = DTYPES[dtype]
    tokens = _rng(seed).integers(0, cfg.vocab, (B, S))
    patches = (_rng(seed + 100).standard_normal((B, cfg.frontend_tokens, cfg.d_model))
               * 0.1).astype(np.float32)
    jp = jnp.asarray(patches, jdt)
    return ({"tokens": jnp.asarray(tokens, jnp.int32), "patches": jp},
            {"tokens": torch.from_numpy(tokens),
             "patches": torch.from_numpy(np.array(jp.astype(jnp.float32))).to(tdt)})


def test_reduced_config_keeps_the_frontend():
    cfg = get_config(ARCH).reduced()
    assert cfg.family == "vlm" and cfg.frontend_tokens == 8 and cfg.kv_heads == 4
    assert get_config(ARCH).frontend_tokens == 2880


@pytest.mark.parametrize("ops", sorted(OPS))
@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_forward_with_patches_matches_reference(dtype, ops):
    """Logits at every position, the patches' included (F + S of them)."""
    _, ref_model, rparams, cfg, params = _models(dtype)
    rbatch, batch = _batches(cfg, dtype)
    want = _np(ref_model.forward(rparams, rbatch))
    got = _np(build_model(cfg).forward(params, batch, ops=OPS[ops]))
    assert got.shape == (2, cfg.frontend_tokens + 6, cfg.padded_vocab) == want.shape
    _close(got, want, dtype)
    if dtype == "bf16":
        _decisive_top1(got, want)


def test_embed_tokens_puts_patches_first_in_the_text_dtype():
    cfg = get_config(ARCH).reduced()
    params = build_model(cfg).init(torch.Generator().manual_seed(0))
    tokens = torch.tensor([[3, 5, 7]])
    patches = torch.randn(1, cfg.frontend_tokens, cfg.d_model, dtype=torch.float32)
    x = tfm.embed_tokens(cfg, params, tokens, patches)
    assert x.dtype == torch.bfloat16 and x.shape == (1, cfg.frontend_tokens + 3, cfg.d_model)
    assert torch.equal(x[:, :cfg.frontend_tokens], patches.to(torch.bfloat16))
    assert torch.equal(x[:, cfg.frontend_tokens:], params["embed"][tokens])


def test_forward_without_patches_is_the_text_backbone():
    """No `patches` in the batch: the dense forward over the text alone (the
    reference's `batch.get("patches")`)."""
    _, ref_model, rparams, cfg, params = _models("f32")
    rbatch, batch = _batches(cfg, "f32")
    want = ref_model.forward(rparams, {"tokens": rbatch["tokens"]})
    got = build_model(cfg).forward(params, {"tokens": batch["tokens"]})
    assert got.shape == (2, 6, cfg.padded_vocab)
    _f32_close(got, want)


def _cache_close(got, want, dtype):
    if dtype == "f32":
        _f32_close(got, want, rtol=1e-3)
    else:
        scale = max(4.0, float(np.abs(_np(want)).max()))
        np.testing.assert_allclose(_np(got), _np(want), rtol=BF16["rtol"],
                                   atol=BF16["atol"] * scale / 4)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_prefill_and_decode_match_reference(dtype):
    """The prefill's last logits and its KV cache (F + S rows filled), then
    4 decode steps at cur_len F + S + i, against the reference."""
    _, ref_model, rparams, cfg, params = _models(dtype)
    model = build_model(cfg)
    rbatch, batch = _batches(cfg, dtype, seed=1)
    B, n0, extra = 2, cfg.frontend_tokens + 6, 4
    lg, rcache = ref_model.prefill(rparams, rbatch, max_len=n0 + extra)
    got, cache = model.prefill(params, batch, max_len=n0 + extra)
    assert got.shape == (B, 1, cfg.padded_vocab)
    _close(got, lg, dtype)
    assert sorted(cache) == sorted(rcache) == ["k", "v"]
    for name in cache:
        assert tuple(cache[name].shape) == rcache[name].shape
        assert not cache[name][:, :, n0:].any()
        _cache_close(cache[name], rcache[name], dtype)
    steps = []
    for i in range(extra):
        tok = _rng(10 + i).integers(0, cfg.vocab, (B, 1))
        lg, rcache = ref_model.decode_step(rparams, jnp.asarray(tok, jnp.int32), rcache,
                                           jnp.int32(n0 + i))
        got, cache2 = model.decode_step(params, torch.from_numpy(tok), cache,
                                        torch.tensor(n0 + i, dtype=torch.int32))
        assert cache2 is cache
        _close(got, lg, dtype)
        steps.append((_np(got), _np(lg)))
    for name in cache:
        _cache_close(cache[name], rcache[name], dtype)
    if dtype == "bf16":
        _decisive_top1(*(np.concatenate(s) for s in zip(*steps)))


@pytest.mark.parametrize("ops", sorted(OPS))
def test_prefill_decode_matches_forward(ops):
    """The port's own serving invariant (tests/test_models.py, whose
    `_batch` puts S - F text tokens after F patches): prefill + step-by-step
    decode equal the teacher-forced forward over patches + text, bf16,
    prefill at 3e-2, steps at atol 0.25 / rtol 0.25 with top-1 wherever
    the top-2 margin exceeds 0.3.  No kernel launches on CPU tensors."""
    cfg = get_config(ARCH).reduced()
    model = build_model(cfg)
    params = model.init(torch.Generator().manual_seed(0))
    B, S, extra = 2, 12, 4
    F = cfg.frontend_tokens
    tokens = torch.from_numpy(_rng(3).integers(0, cfg.vocab, (B, S - F)))
    patches = (torch.from_numpy(_rng(4).standard_normal((B, F, cfg.d_model))) * 0.1).to(
        torch.bfloat16)
    ext = torch.cat([tokens, (torch.arange(B * extra).reshape(B, extra) + 7) % cfg.vocab], 1)
    n_fa, n_da = fa.flash_attention.launches, da.decode_attention.launches
    full = _np(model.forward(params, {"tokens": ext, "patches": patches}, ops=OPS[ops]))
    lg, cache = model.prefill(params, {"tokens": tokens, "patches": patches},
                              max_len=S + extra, ops=OPS[ops])
    np.testing.assert_allclose(_np(lg[:, 0]), full[:, S - 1], atol=3e-2, rtol=3e-2)
    for i in range(extra):
        lg, cache = model.decode_step(params, ext[:, S - F + i][:, None], cache,
                                      torch.tensor(S + i, dtype=torch.int32), ops=OPS[ops])
        got, want = _np(lg[:, 0]), full[:, S + i]
        np.testing.assert_allclose(got, want, atol=0.25, rtol=0.25)
        top2 = np.sort(want, axis=-1)[:, -2:]
        decisive = (top2[:, 1] - top2[:, 0]) > 0.3
        assert (got.argmax(-1) == want.argmax(-1))[decisive].all()
    assert (fa.flash_attention.launches, da.decode_attention.launches) == (n_fa, n_da)


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_batch_text_offset_matches_reference(arch):
    """The patches before the text for the VLM, 0 for every other family."""
    for reduce in (False, True):
        cfg, rcfg = get_config(arch), ref_config(arch)
        if reduce:
            cfg, rcfg = cfg.reduced(), rcfg.reduced()
        assert batch_text_offset(cfg) == ref_text_offset(rcfg)
    assert batch_text_offset(get_config(arch)) == (2880 if arch == ARCH else 0)


def _layer_block_map(n_layers, n_blocks):
    """block 0 = embed, blocks 1..n-2 = layer groups, last = head."""
    per = max(1, n_layers // (n_blocks - 2))
    blocks, start = [(0, 0)], 0
    while start < n_layers:
        end = min(n_layers, start + per)
        blocks.append((start, end))
        start = end
    blocks.append((n_layers, n_layers))
    return blocks


@pytest.mark.parametrize("cut", [1, 2, 3])
def test_split_stages_match_reference(cut):
    """llava-next's stages, text only as the reference builds them (stage 0
    embeds tokens without patches), each stage's output against the
    reference's on shared parameters, in f32, and the whole split against
    the port's own forward over the same tokens."""
    rcfg, _, rparams, cfg, params = _models("f32")
    lbm = _layer_block_map(cfg.n_layers, 4)  # embed, layer 0, layer 1, head
    ranges = [(0, cut), (cut, len(lbm))]
    _, ref_stages = ref_split(rcfg, ranges, lbm)
    model, stages = split_stages(cfg, ranges, lbm)
    tokens = _rng(5).integers(0, cfg.vocab, (2, 10))
    ref_h = ref_stages[0](rparams, jnp.asarray(tokens, jnp.int32))
    h = stages[0](params, torch.from_numpy(tokens))
    _f32_close(h, ref_h)
    got = stages[1](params, h)
    _f32_close(got, ref_stages[1](rparams, ref_h))
    _f32_close(got, model.forward(params, {"tokens": torch.from_numpy(tokens)}))


def test_init_keeps_reference_formulas():
    """Per-layer matrices at the stacked fan-in (the layer count), as the
    dense family's; embed 0.02, head 1/sqrt(d_model)."""
    cfg = get_config(ARCH).reduced(n_layers=4, dtype=torch.float32)
    params = build_model(cfg).init(torch.Generator().manual_seed(0))
    assert len(params["layers"]) == 4
    assert abs(params["layers"][1]["mlp"]["up"].std().item() - 0.5) < 0.02
    assert abs(params["embed"].std().item() - 0.02) < 1e-3
    assert abs(params["head"].std().item() - cfg.d_model ** -0.5) < 2e-3
