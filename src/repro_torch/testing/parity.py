"""Bridge from the reference package's parameters to the port's, and the
shared kernel tolerances.

The reference's parameter tree reaches this module as **numpy arrays**:
the caller converts each JAX array with `np.asarray(a).astype(np.float32)`
(exact for bf16).  Nothing here imports JAX.
"""

from __future__ import annotations

import numpy as np
import torch

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


def tree_from_numpy(tree: dict, defs: dict, device="cpu") -> ParamTree:
    """A reference parameter tree (numpy, f32) as the port's `ParamTree`
    of the templates `defs` on `device`, each leaf in the dtype of its own
    `ParamDef` (the Mamba2 `A_log`, `D` and `dt_bias` stay f32 under a bf16
    config).

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
            return _tensor(node, defs.dtype, device)
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
