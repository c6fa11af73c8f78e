"""Bridge from the reference package's parameters to the port's, and the
shared kernel tolerances.

The reference's parameter tree reaches this module as **numpy arrays**:
the caller converts each JAX array with `np.asarray(a).astype(np.float32)`
(exact for bf16).  Nothing here imports JAX.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from repro_torch.kernels.flash_attention import ops as fa
from repro_torch.models.common import ModelConfig, ParamDef, ParamTree
from repro_torch.models.model_zoo import build_model


def _tensor(a: np.ndarray, dtype, device) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a, dtype=np.float32)).to(
        device=device, dtype=dtype)


def params_from_numpy(tree: dict, cfg: ModelConfig, device="cpu") -> ParamTree:
    """The reference's parameter tree (numpy, f32) of a whole model of
    `cfg` as the port's `ParamTree` on `device`: `tree_from_numpy` against
    the port's model templates."""
    return tree_from_numpy(tree, build_model(cfg).defs, device)


def tree_from_numpy(tree: dict, defs: dict, device="cpu", dtype=None) -> ParamTree:
    """A reference parameter tree (numpy, f32) as the port's `ParamTree`
    of the templates `defs` on `device`, each leaf in the dtype of its own
    `ParamDef` (the Mamba2 `A_log`, `D` and `dt_bias` stay f32 under a bf16
    config), or in `dtype` where one is given (optimizer moments).

    The tree is walked beside the port's templates: where the port keeps a
    list of per-layer templates, the reference keeps one stacked array per
    leaf, so a list of n templates takes the reference subtree apart along
    its leading axis of n.  The dense and MoE `layers` (L, ...), deepseek's
    `dense_layers` and `moe_layers` (their expert leaves (L, E, d, ff)) and
    the enc-dec's stacks become lists of L trees, the hybrid `inner` (G, K,
    ...) a list of G lists of K trees; `shared_attn` and deepseek's
    `mtp.layer` are unstacked on both sides, and the MoE `router` stays
    f32 as its template says."""

    def convert(node, defs):
        if isinstance(defs, ParamDef):
            if tuple(node.shape) != defs.shape:
                raise ValueError(f"leaf of shape {node.shape}, template {defs.shape}")
            return _tensor(node, dtype or defs.dtype, device)
        if isinstance(defs, list):
            return [convert(take(node, i, len(defs)), d) for i, d in enumerate(defs)]
        if set(node) != set(defs):
            raise ValueError(f"keys {sorted(node)} differ from the port's {sorted(defs)}")
        return {k: convert(node[k], defs[k]) for k in defs}

    def take(node, i, n):
        if isinstance(node, dict):
            return {k: take(v, i, n) for k, v in node.items()}
        if node.shape[0] != n:
            raise ValueError(f"stacked leaf has {node.shape[0]} entries, the port {n}")
        return node[i]

    return ParamTree(convert(tree, defs))


def tree_to_numpy(tree, defs) -> dict:
    """The port's tree of the templates `defs` (a `ParamTree` or nested
    dicts and lists of tensors) as the reference's layout, f32 numpy: the
    inverse of `tree_from_numpy`, stacking each list of n per-layer trees
    leaf by leaf along a new leading axis of n (the hybrid `inner`, a list
    of G lists of K trees, to (G, K, ...))."""

    def convert(node, defs):
        if isinstance(defs, ParamDef):
            return node.detach().float().cpu().numpy().copy()
        if isinstance(defs, list):
            return stack([convert(node[i], d) for i, d in enumerate(defs)])
        return {k: convert(node[k], defs[k]) for k in defs}

    def stack(items):
        if isinstance(items[0], dict):
            return {k: stack([it[k] for it in items]) for k in items[0]}
        return np.stack(items)

    return convert(tree, defs)


def condition_fan_in(tree, defs):
    """Every stacked default-init normal leaf of `tree` rescaled from the
    reference's std 1/sqrt(layers) (the fan-in of its stacked array) to
    std 1/sqrt(its input width), where the recurrent and enc-dec f32
    forwards are stable and full-width bf16 attention does not saturate.

    `tree` is the port's (a `ParamTree`, on any device), rescaled in place
    and returned, or the reference's numpy tree, returned rescaled through
    `tree_from_numpy` and `tree_to_numpy` in f32 (exact both ways)."""
    if isinstance(tree, dict):
        port = tree_from_numpy(tree, defs, dtype=torch.float32)
        return tree_to_numpy(condition_fan_in(port, defs), defs)

    def walk(node, d):
        if isinstance(d, ParamDef):
            if d.init == "normal" and d.scale is None and d.stacked:
                node.mul_(math.sqrt(d.stacked / d.shape[0]))
        elif isinstance(d, list):
            for i, x in enumerate(d):
                walk(node[i], x)
        else:
            for k in d:
                walk(node[k], d[k])

    with torch.no_grad():
        walk(tree, defs)
    return tree


def opt_state_from_numpy(state: dict, defs: dict, moment_dtype=torch.float32,
                         device="cpu") -> dict:
    """The reference's optimizer state ({"m", "v"} stacked numpy trees and
    the step) as the port's: per-layer moment trees in `moment_dtype`, as
    `tree_from_numpy` walks them, and an int32 0-d step tensor."""
    return {"m": tree_from_numpy(state["m"], defs, device, moment_dtype),
            "v": tree_from_numpy(state["v"], defs, device, moment_dtype),
            "step": torch.tensor(int(state["step"]), dtype=torch.int32, device=device)}


def tol(dtype) -> dict:
    """The kernel-sweep tolerances of the reference's tests/test_kernels.py
    (`_tol`): bf16 5e-2, f32 3e-5, as atol and rtol."""
    if dtype == torch.bfloat16:
        return dict(atol=5e-2, rtol=5e-2)
    return dict(atol=3e-5, rtol=3e-5)


def attn_tol(dtype) -> dict:
    """The attention kernels against their plain versions: in bf16, atol
    1e-2 and rtol 1e-2, a fifth of `tol`'s.  The rtol covers one bf16 ulp of
    the output (at most 2^-7 of it) where the two round the same f32 value
    apart; the atol is a few times the largest difference of a sound kernel
    (0.002-0.004 at the smoke shapes on the H100) and well under what one
    dropped 16-key group of zamba2-2.7b's 528 keys, or one dropped split of
    eight, moves the outputs (about 0.01 spread, four times that at the
    worst element).  f32 as `tol`."""
    if dtype == torch.bfloat16:
        return dict(atol=1e-2, rtol=1e-2)
    return tol(dtype)


# The backward kernels against their plain backward run in f32 from the same
# bf16 inputs: each gradient within this fraction of that f32 result's
# largest magnitude.  A sound bf16 backward sits well inside it; a dropped
# Delta term, a skipped sum over GQA's heads or dw summed in bf16 land
# outside (tests/test_torch_grad_kernels.py).
GRAD_TOL = 2e-2


def grad_gap(got: torch.Tensor, want: torch.Tensor) -> float:
    """max |got - want| as a fraction of max |want|, in f32."""
    want = want.float()
    scale = float(want.abs().max())
    return float((got.float() - want).abs().max()) / max(scale, 1e-30)


def flash_grads_f32(q, k, v, dout, causal: bool = True
                    ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The yardstick of the flash attention backward: (dq, dk, dv) of the
    plain backward run in f32 from the same (B, H, S, D) inputs (q and dout
    of Sq rows, k and v of Sk; v and dout may be Dv <= D wide), causal
    (top-left) or not, the output and lse recomputed in f32."""
    qf, kf, vf = q.float(), k.float(), v.float()
    D, Dv = q.shape[-1], v.shape[-1]
    o = fa.flash_attention_plain(qf, kf, torch.nn.functional.pad(vf, (0, D - Dv)), causal)
    return fa.flash_attention_backward_plain(
        qf, kf, vf, o[..., :Dv], dout.float(),
        fa.flash_attention_lse_plain(qf, kf, causal=causal), causal=causal)


def assert_grad_close(got: torch.Tensor, want: torch.Tensor, what: str,
                      frac: float = GRAD_TOL) -> float:
    """Raise unless `grad_gap(got, want) <= frac`; returns the gap."""
    gap = grad_gap(got, want)
    if not gap <= frac:
        raise AssertionError(f"{what}: gap {gap:.3g} of max|ref| exceeds {frac}")
    return gap
