"""Architecture registry: the reference's ten configs, in its order, with
the same fields.  `build_model` runs the dense family, the Mamba2 hybrid
and xLSTM; `layer_costs` (the planner's profile) covers all ten.

The reference's registry also carries the shapes, input specs and mesh
sharding rules of its dry-run; the port has no counterpart of those yet.
"""

from __future__ import annotations

import importlib

from repro_torch.models.common import ModelConfig

ARCH_MODULES = {
    "stablelm-3b": "stablelm_3b",
    "qwen2-1.5b": "qwen2_1_5b",
    "internlm2-20b": "internlm2_20b",
    "qwen3-14b": "qwen3_14b",
    "llava-next-34b": "llava_next_34b",
    "xlstm-1.3b": "xlstm_1_3b",
    "zamba2-2.7b": "zamba2_2_7b",
    "llama4-maverick-400b-a17b": "llama4_maverick_400b_a17b",
    "deepseek-v3-671b": "deepseek_v3_671b",
    "seamless-m4t-large-v2": "seamless_m4t_large_v2",
}

ARCH_IDS = list(ARCH_MODULES)


def get_config(arch: str) -> ModelConfig:
    if arch not in ARCH_MODULES:
        raise KeyError(f"unknown arch {arch!r}; known: {ARCH_IDS}")
    mod = importlib.import_module(f"repro_torch.configs.{ARCH_MODULES[arch]}")
    return mod.CONFIG
