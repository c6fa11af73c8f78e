"""The port's model ops, dense forward and stage split, held against the
reference package on reduced configs.

Parameters come from the reference (`model.init`) and reach the port through
`params_from_numpy` (bf16 goes exactly via f32); token ids and activations
come from numpy.  Tolerances:

* f32, where the point is the algorithm: rtol 1e-4 and atol 1e-4 times
  the largest magnitude of the reference tensor (the reference init's
  per-layer fan-in is the layer count, so un-normalised hidden states
  reach the hundreds and f32 sums of them carry absolute errors to match);
  tighter per op;
* bf16 whole forwards: atol 0.2, rtol 2e-2, plus the decisive-margin top-1
  rule of tests/test_serving_engine.py.  PyTorch and XLA accumulate bf16
  matmuls in different orders; single-ulp differences in the hidden states
  then grow through the layers (measured max |err| 0.03-0.14 on logits of
  scale ~4 over seeds 0-3), which a 2e-2 bound on every element does not
  hold.  The f32 runs pin the math.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_config
from repro.models import common as ref_common
from repro.models.model_zoo import build_model as ref_build
from repro.serving.engine import split_stages as ref_split
from repro_torch.configs import get_config
from repro_torch.models import common
from repro_torch.models.model_zoo import build_model
from repro_torch.serving.engine import split_stages
from repro_torch.testing.parity import params_from_numpy

ARCHS = ["stablelm-3b", "qwen3-14b"]  # qwen3: qk_norm + GQA
BF16 = dict(atol=0.2, rtol=2e-2)


def _rng(seed):
    return np.random.default_rng(seed)


def _normal(seed, shape, scale=1.0):
    return (_rng(seed).standard_normal(shape) * scale).astype(np.float32)


def _both(a: np.ndarray, jdt, tdt):
    j = jnp.asarray(a, jdt)
    return j, torch.from_numpy(np.array(j.astype(jnp.float32))).to(tdt)


def _np(x) -> np.ndarray:
    return np.asarray(x.float().numpy() if isinstance(x, torch.Tensor) else x, np.float32)


# ------------------------------------------------------------- (b) the ops


@pytest.mark.parametrize("jdt,tdt,atol", [(jnp.float32, torch.float32, 1e-6),
                                          (jnp.bfloat16, torch.bfloat16, 1e-2)])
def test_rms_norm_matches_reference(jdt, tdt, atol):
    """Casts to x's dtype before the weight multiply (common.py:270)."""
    x, tx = _both(_normal(0, (2, 12, 128), 3.0), jdt, tdt)
    w, tw = _both(_normal(1, (128,)), jdt, tdt)
    want = ref_common.rms_norm(x, w, 1e-5)
    np.testing.assert_allclose(_np(common.rms_norm(tx, tw, 1e-5)), _np(want), atol=atol, rtol=atol)


def test_apply_rope_matches_reference():
    """Rotates split halves, not interleaved pairs (common.py:283-284)."""
    x, tx = _both(_normal(2, (2, 12, 4, 32)), jnp.float32, torch.float32)
    pos = np.broadcast_to(np.arange(12) + 5, (2, 12))
    want = ref_common.apply_rope(x, jnp.asarray(pos), 1e4)
    got = common.apply_rope(tx, torch.from_numpy(pos.copy()), 1e4)
    np.testing.assert_allclose(_np(got), _np(want), atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("jdt,tdt,atol", [(jnp.float32, torch.float32, 1e-5),
                                          (jnp.bfloat16, torch.bfloat16, 2e-2)])
def test_swiglu_matches_reference(jdt, tdt, atol):
    """silu in f32, then cast (common.py:306)."""
    x, tx = _both(_normal(3, (2, 12, 128)), jdt, tdt)
    g, tg = _both(_normal(4, (128, 256), 0.1), jdt, tdt)
    u, tu = _both(_normal(5, (128, 256), 0.1), jdt, tdt)
    d, td = _both(_normal(6, (256, 128), 0.1), jdt, tdt)
    want = ref_common.swiglu(x, g, u, d, ref_common.NO_SHARDING)
    np.testing.assert_allclose(_np(common.swiglu(tx, tg, tu, td)), _np(want),
                               atol=atol, rtol=atol)


@pytest.mark.parametrize("kwargs", [
    dict(causal=True, q_chunk=5, k_chunk=4),
    dict(causal=True, q_offset=3, kv_len=11, q_chunk=8, k_chunk=8),
    dict(causal=False, q_chunk=512, k_chunk=1024),
], ids=["chunked", "offset_kvlen", "noncausal"])
def test_chunked_attention_matches_reference(kwargs):
    q, tq = _both(_normal(7, (2, 12, 4, 32)), jnp.float32, torch.float32)
    k, tk = _both(_normal(8, (2, 14, 2, 32)), jnp.float32, torch.float32)
    v, tv = _both(_normal(9, (2, 14, 2, 32)), jnp.float32, torch.float32)
    want = ref_common.chunked_attention(q, k, v, **kwargs)
    got = common.chunked_attention(tq, tk, tv, **kwargs)
    np.testing.assert_allclose(_np(got), _np(want), atol=3e-5, rtol=3e-5)


# ---------------------------------------------- (c) forward and stage split


def _models(arch, jdt, tdt, n_layers=2, seed=0):
    rcfg = ref_config(arch).reduced(n_layers=n_layers, dtype=jdt)
    cfg = get_config(arch).reduced(n_layers=n_layers, dtype=tdt)
    ref_model = ref_build(rcfg)
    ref_params = ref_model.init(jax.random.PRNGKey(seed))
    tree = jax.tree.map(lambda a: np.asarray(a).astype(np.float32), ref_params)
    return rcfg, ref_model, ref_params, cfg, params_from_numpy(tree, cfg)


def _tokens(cfg, seed=0, B=2, S=12):
    return _rng(seed).integers(0, cfg.vocab, (B, S))


def _assert_f32_close(got: np.ndarray, want: np.ndarray) -> None:
    np.testing.assert_allclose(got, want, rtol=1e-4,
                               atol=1e-4 * max(1.0, float(np.abs(want).max())))


def _decisive_top1(got: np.ndarray, want: np.ndarray) -> None:
    err = np.abs(got - want).max()
    top2 = np.sort(want, axis=-1)[..., -2:]
    decisive = (top2[..., 1] - top2[..., 0]) > 2 * err
    assert decisive.any(), "no decisive positions"
    assert (got.argmax(-1) == want.argmax(-1))[decisive].all()


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("ops", ["kernels", "plain"])
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_forward_matches_reference(arch, ops, dtype):
    """`KERNELS` on CPU tensors runs the kernels' plain versions; `PLAIN`
    the reference's op-for-op math.  Both equal the reference forward."""
    jdt, tdt = (jnp.float32, torch.float32) if dtype == "f32" else (jnp.bfloat16, torch.bfloat16)
    rcfg, ref_model, ref_params, cfg, params = _models(arch, jdt, tdt)
    tokens = _tokens(cfg)
    want = _np(ref_model.forward(ref_params, {"tokens": jnp.asarray(tokens, jnp.int32)}))
    the_ops = common.KERNELS if ops == "kernels" else common.PLAIN
    got = _np(build_model(cfg).forward(params, {"tokens": torch.from_numpy(tokens)}, ops=the_ops))
    assert got.shape == (2, 12, cfg.padded_vocab)
    if dtype == "f32":
        _assert_f32_close(got, want)
    else:
        np.testing.assert_allclose(got, want, **BF16)
        _decisive_top1(got, want)


def _layer_block_map(n_layers, n_blocks):
    """block 0 = embed, blocks 1..n-2 = layer groups, last = head (the
    helper of tests/test_serving_engine.py)."""
    per = max(1, n_layers // (n_blocks - 2))
    blocks, start = [(0, 0)], 0
    while start < n_layers:
        end = min(n_layers, start + per)
        blocks.append((start, end))
        start = end
    blocks.append((n_layers, n_layers))
    return blocks


@pytest.mark.parametrize("arch", ARCHS)
def test_split_stages_match_reference_and_full_forward(arch):
    rcfg, ref_model, ref_params, cfg, params = _models(arch, jnp.float32, torch.float32)
    lbm = _layer_block_map(cfg.n_layers, 5)  # embed, layer 0, layer 1, head
    n = len(lbm)
    ranges = [(0, 2), (2, n)]
    _, ref_stages = ref_split(rcfg, ranges, lbm)
    model, stages = split_stages(cfg, ranges, lbm)
    tokens = _tokens(cfg, seed=1)
    ref_h = ref_stages[0](ref_params, jnp.asarray(tokens, jnp.int32))
    want = _np(ref_stages[1](ref_params, ref_h))
    h = stages[0](params, torch.from_numpy(tokens))
    _assert_f32_close(_np(h), _np(ref_h))
    got = _np(stages[1](params, h))
    _assert_f32_close(got, want)
    full = _np(model.forward(params, {"tokens": torch.from_numpy(tokens)}))
    _assert_f32_close(got, full)


def test_split_stages_bf16_decisive_top1():
    rcfg, ref_model, ref_params, cfg, params = _models("stablelm-3b", jnp.bfloat16,
                                                        torch.bfloat16)
    lbm = _layer_block_map(cfg.n_layers, 5)
    ranges = [(0, 2), (2, len(lbm))]
    _, ref_stages = ref_split(rcfg, ranges, lbm)
    _, stages = split_stages(cfg, ranges, lbm)
    tokens = _tokens(cfg, seed=2)
    want = _np(ref_stages[1](ref_params, ref_stages[0](ref_params, jnp.asarray(tokens))))
    got = _np(stages[1](params, stages[0](params, torch.from_numpy(tokens))))
    np.testing.assert_allclose(got, want, **BF16)
    _decisive_top1(got, want)


def test_init_keeps_reference_formulas():
    """Per-layer matrices draw normal / sqrt(fan_in) with the fan-in of the
    reference's stacked arrays (the layer count), the embedding 0.02, norms
    ones; values come from an explicit generator on the requested device."""
    cfg = get_config("stablelm-3b").reduced(n_layers=4, dtype=torch.float32)
    params = build_model(cfg).init(torch.Generator().manual_seed(0))
    wq = params["layers"][0]["attn"]["wq"]
    assert wq.shape == (cfg.d_model, cfg.n_heads * cfg.hd) and not wq.requires_grad
    assert abs(wq.std().item() - 0.5) < 0.02  # 1 / sqrt(4 layers)
    assert abs(params["embed"].std().item() - 0.02) < 1e-3
    assert abs(params["head"].std().item() - cfg.d_model ** -0.5) < 2e-3
    assert (params["layers"][3]["mlp_norm"] == 1).all()
    again = build_model(cfg).init(torch.Generator().manual_seed(0))
    assert torch.equal(again["layers"][2]["mlp"]["down"], params["layers"][2]["mlp"]["down"])
