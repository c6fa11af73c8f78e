"""Bridge from the reference package's parameters to the port's, and the
shared kernel tolerances.

The reference's parameter tree reaches this module as **numpy arrays**:
the caller converts each JAX array with `np.asarray(a).astype(np.float32)`
(exact for bf16).  Nothing here imports JAX.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.models.common import ModelConfig, ParamTree


def _tensor(a: np.ndarray, dtype, device) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a, dtype=np.float32)).to(
        device=device, dtype=dtype)


def params_from_numpy(tree: dict, cfg: ModelConfig, device="cpu") -> ParamTree:
    """The reference's dense-model parameter tree (numpy, f32) as the port's
    `ParamTree`, cast to `cfg.dtype` on `device`.  The stacked
    `tree["layers"]` (every leaf with a leading L axis) becomes a list of L
    per-layer trees."""

    def convert(node):
        if isinstance(node, dict):
            return {k: convert(v) for k, v in node.items()}
        return _tensor(node, cfg.dtype, device)

    out = {k: convert(v) for k, v in tree.items() if k != "layers"}
    layers = tree["layers"]
    n = cfg.n_layers

    def take(node, i):
        if isinstance(node, dict):
            return {k: take(v, i) for k, v in node.items()}
        if node.shape[0] != n:
            raise ValueError(f"stacked leaf has {node.shape[0]} layers, config {n}")
        return _tensor(node[i], cfg.dtype, device)

    out["layers"] = [take(layers, i) for i in range(n)]
    return ParamTree(out)


def tol(dtype) -> dict:
    """The kernel-sweep tolerances of the reference's tests/test_kernels.py
    (`_tol`): bf16 5e-2, f32 3e-5, as atol and rtol."""
    if dtype == torch.bfloat16:
        return dict(atol=5e-2, rtol=5e-2)
    return dict(atol=3e-5, rtol=3e-5)
