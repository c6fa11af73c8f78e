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
    """The reference's parameter tree (numpy, f32) as the port's `ParamTree`
    on `device`, each leaf in the dtype of its own `ParamDef` (the Mamba2
    `A_log`, `D` and `dt_bias` stay f32 under a bf16 config).

    The tree is walked beside the port's templates: where the port keeps a
    list of per-layer templates, the reference keeps one stacked array per
    leaf, so a list of n templates takes the reference subtree apart along
    its leading axis of n.  The dense `layers` (L, ...) become a list of L
    trees, the hybrid `inner` (G, K, ...) a list of G lists of K trees;
    `shared_attn` is unstacked on both sides."""

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

    return ParamTree(convert(tree, build_model(cfg).defs))


def tol(dtype) -> dict:
    """The kernel-sweep tolerances of the reference's tests/test_kernels.py
    (`_tol`): bf16 5e-2, f32 3e-5, as atol and rtol."""
    if dtype == torch.bfloat16:
        return dict(atol=5e-2, rtol=5e-2)
    return dict(atol=3e-5, rtol=3e-5)
