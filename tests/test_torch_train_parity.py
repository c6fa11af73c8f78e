"""Shared by the port's loss-and-gradient parity tests
(tests/test_torch_loss_*.py): both packages' reduced models on the same
parameters and batches, their losses and gradients as numpy trees of the
reference's layout, and the bounds they are held to.  It holds no test of
its own.

Bounds:

* f32: the loss within 1e-5 relative, every gradient leaf within 1e-4 of
  its own max |value| (the reference's).  One exception, named where it
  applies: the MoE router's gradient under top-1 routing is zero in exact
  arithmetic (the renormalised weight of the one chosen expert is
  identically 1), so both packages hold it at rounding noise; it is held
  below 1e-6 of the model's largest gradient instead.
* bf16: the loss within 5e-3 relative; each gradient leaf is held to the
  f32 reference gradient of the same parameters: its relative L2 distance
  from it at most 2.5 times the reference's own bf16 gradient's, or 0.02.
  A reduced model's bf16 gradients sit several to tens of percent (L2)
  from the f32 ones in both packages, and XLA and PyTorch place bf16
  roundings apart, so the two bf16 gradients are not held to each other
  directly; the factor leaves room over what every config of `ARCH_IDS`
  needs in tests/test_torch_loss_*.py.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.configs import get_config as ref_config
from repro.models.model_zoo import build_model as ref_build
from repro_torch.configs import get_config
from repro_torch.models.common import KERNELS
from repro_torch.models.model_zoo import build_model
from repro_torch.testing.parity import condition_fan_in, params_from_numpy, tree_to_numpy
from repro_torch.training.tree import leaves, unflatten

DTYPES = {"f32": (jnp.float32, torch.float32), "bf16": (jnp.bfloat16, torch.bfloat16)}
# the recurrent and enc-dec families take fan-in-conditioned parameters, as
# tests/test_torch_xlstm.py and tests/test_torch_encdec.py do: at the
# reference's own init their f32 forwards are chaotic (pinned there)
CONDITIONED = ("ssm", "audio")
F32_LOSS_RTOL, F32_GRAD_TOL, NOISE = 1e-5, 1e-4, 1e-6
BF16_LOSS_RTOL, BF16_L2_FACTOR, BF16_L2_FLOOR = 5e-3, 2.5, 0.02
B, S = 2, 12


def np_tree(tree):
    return jax.tree.map(lambda a: np.asarray(a).astype(np.float32), tree)


def models(arch: str, dtype: str, seed: int = 0, **overrides):
    """(reference model, its params, port config, port model, port params)
    on the same values: the reference's init, conditioned for the recurrent
    and enc-dec families."""
    jdt, tdt = DTYPES[dtype]
    rcfg = ref_config(arch).reduced(dtype=jdt, **overrides)
    cfg = get_config(arch).reduced(dtype=tdt, **overrides)
    ref_model, model = ref_build(rcfg), build_model(cfg)
    rparams = ref_model.init(jax.random.PRNGKey(seed))
    tree = np_tree(rparams)
    if cfg.family in CONDITIONED:
        tree = condition_fan_in(tree, model.defs)
        rparams = jax.tree.map(lambda a, r: jnp.asarray(a).astype(r.dtype), tree, rparams)
        tree = np_tree(rparams)
    return ref_model, rparams, cfg, model, params_from_numpy(tree, cfg)


def batches(cfg, dtype: str, seed: int = 0) -> tuple[dict, dict]:
    """The same batch for both packages: tokens, a VLM's patches (normal x
    0.1), an enc-dec's 10 frames."""
    jdt, tdt = DTYPES[dtype]
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab, (B, S))
    rb, tb = {"tokens": jnp.asarray(toks, jnp.int32)}, {"tokens": torch.from_numpy(toks)}
    extra = {"vlm": ("patches", (B, cfg.frontend_tokens, cfg.d_model), 0.1),
             "audio": ("frames", (B, 10, cfg.d_model), 1.0)}.get(cfg.family)
    if extra:
        key, shape, scale = extra
        j = jnp.asarray((rng.standard_normal(shape) * scale).astype(np.float32), jdt)
        rb[key] = j
        tb[key] = torch.from_numpy(np.array(j.astype(jnp.float32))).to(tdt)
    return rb, tb


def ref_loss_and_grads(ref_model, rparams, rbatch, remat: bool) -> tuple[float, dict]:
    loss, grads = jax.value_and_grad(lambda p: ref_model.loss(p, rbatch, remat=remat))(rparams)
    return float(loss), np_tree(grads)


def port_loss_and_grads(model, params, batch, remat: bool, ops=KERNELS) -> tuple[float, dict]:
    """The port's loss and its gradients (`torch.autograd.grad` on the
    leaves), the gradients in the reference's stacked layout."""
    trained = leaves(params)
    for p in trained:
        p.requires_grad_(True)
    try:
        loss = model.loss(params, batch, remat=remat, ops=ops)
        grads = torch.autograd.grad(loss, trained, materialize_grads=True)
    finally:
        for p in trained:
            p.requires_grad_(False)
    return float(loss.detach()), tree_to_numpy(unflatten(params, list(grads)), model.defs)


@functools.lru_cache(maxsize=None)
def f32_reference(arch: str) -> tuple[float, dict]:
    """The reference's f32 loss and gradients of `arch` (with remat), on
    `models(arch, "f32")` and `batches(cfg, "f32")`."""
    ref_model, rparams, cfg, _, _ = models(arch, "f32")
    return ref_loss_and_grads(ref_model, rparams, batches(cfg, "f32")[0], remat=True)


def leaf_pairs(want: dict, got: dict):
    for path, a in jax.tree_util.tree_flatten_with_path(want)[0]:
        b = got
        for k in path:
            b = b[k.key]
        yield jax.tree_util.keystr(path), a, b


def noise_leaf(cfg, name: str) -> bool:
    """The MoE router under top-1 routing (see the module's note)."""
    return "router" in name and cfg.top_k == 1


def check_f32(cfg, want: tuple[float, dict], got: tuple[float, dict]) -> None:
    (lw, gw), (lg, gg) = want, got
    assert abs(lg - lw) <= F32_LOSS_RTOL * abs(lw), (lg, lw)
    top = max(float(np.abs(a).max()) for a in jax.tree.leaves(gw))
    for name, a, b in leaf_pairs(gw, gg):
        assert a.shape == b.shape, name
        if noise_leaf(cfg, name):
            assert max(np.abs(a).max(), np.abs(b).max()) <= NOISE * top, name
            continue
        err = np.abs(a - b).max() / max(float(np.abs(a).max()), 1e-30)
        assert err <= F32_GRAD_TOL, f"{name}: {err:.3g} of max |grad|"


def check_bf16(cfg, truth: dict, ref: tuple[float, dict], got: tuple[float, dict]) -> None:
    (lr, gr), (lg, gg) = ref, got
    assert abs(lg - lr) <= BF16_LOSS_RTOL * abs(lr), (lg, lr)
    for (name, t, a), (_, _, b) in zip(leaf_pairs(truth, gr), leaf_pairs(truth, gg)):
        if noise_leaf(cfg, name):
            continue
        norm = max(float(np.linalg.norm(t)), 1e-30)
        ref_gap = float(np.linalg.norm(a - t)) / norm
        gap = float(np.linalg.norm(b - t)) / norm
        assert gap <= max(BF16_L2_FACTOR * ref_gap, BF16_L2_FLOOR), \
            f"{name}: {gap:.3g} from the f32 gradient, the reference's bf16 {ref_gap:.3g}"
