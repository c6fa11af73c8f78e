"""Architecture registry for the configs the port runs (the dense family and
the Mamba2 hybrid).

The reference's registry also carries input specs and mesh sharding rules
for its dry-run; the port has no counterpart of those yet.
"""

from __future__ import annotations

import importlib

from repro_torch.models.common import ModelConfig

ARCH_MODULES = {
    "stablelm-3b": "stablelm_3b",
    "qwen3-14b": "qwen3_14b",
    "zamba2-2.7b": "zamba2_2_7b",
}

ARCH_IDS = list(ARCH_MODULES)


def get_config(arch: str) -> ModelConfig:
    if arch not in ARCH_MODULES:
        raise KeyError(f"unknown arch {arch!r}; known: {ARCH_IDS}")
    mod = importlib.import_module(f"repro_torch.configs.{ARCH_MODULES[arch]}")
    return mod.CONFIG
