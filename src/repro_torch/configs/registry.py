"""Architecture registry: the reference's ten configs, in its order, with
the same fields, the four shape points of the dry run and their
applicability, and `input_specs`, each cell's inputs as empty tensors.
`build_model` runs all ten (every family); `layer_costs` (the planner's
profile) covers them too.

The reference's mesh sharding rules (`rules_for`, `cache_pspec`,
`VARIANTS`) have no counterpart: the port runs no sharded step (PERF.md,
section 7).
"""

from __future__ import annotations

import importlib
from dataclasses import dataclass

import torch

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


@dataclass(frozen=True)
class ShapeSpec:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # train | prefill | decode


SHAPES = {
    "train_4k": ShapeSpec("train_4k", 4_096, 256, "train"),
    "prefill_32k": ShapeSpec("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeSpec("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeSpec("long_500k", 524_288, 1, "decode"),
}

# Archs whose sequence mixing is sub-quadratic with O(1)-ish state (may run
# long_500k); everything else skips it (full attention at 500k context).
SUBQUADRATIC = {"xlstm-1.3b", "zamba2-2.7b"}


def shape_applicable(arch: str, shape: str) -> tuple[bool, str]:
    if shape == "long_500k" and arch not in SUBQUADRATIC:
        return False, "full-attention arch: 500k-token decode excluded by assignment"
    return True, ""


def all_cells() -> list[tuple[str, str]]:
    return [(a, s) for a in ARCH_IDS for s in SHAPES]


def input_specs(cfg: ModelConfig, shape: ShapeSpec, device="meta") -> dict:
    """The step function's inputs for this (arch, shape) cell as empty
    tensors on `device` (meta: shapes and dtypes, no storage), the keys of
    the reference's `input_specs`:

    train, prefill -> {"tokens"} (B, S) int32; the VLM's {"tokens" (B, S -
                      F), "patches" (B, F, d_model)}; the enc-dec's
                      {"frames" (B, S, d_model), "tokens" (B, S)}
    decode         -> {"token" (B, 1), "cache" (`Model.init_cache(B, S)`),
                      "cur_len" 0-d int32}
    """
    B, S = shape.global_batch, shape.seq_len

    def tok(shape_):
        return torch.empty(shape_, dtype=torch.int32, device=device)

    def emb(shape_):
        return torch.empty(shape_, dtype=cfg.dtype, device=device)

    if shape.kind in ("train", "prefill"):
        if cfg.family == "audio":
            return {"frames": emb((B, S, cfg.d_model)), "tokens": tok((B, S))}
        if cfg.family == "vlm":
            F = cfg.frontend_tokens
            return {"tokens": tok((B, S - F)), "patches": emb((B, F, cfg.d_model))}
        return {"tokens": tok((B, S))}

    from repro_torch.models.model_zoo import build_model

    return {"token": tok((B, 1)), "cache": build_model(cfg).init_cache(B, S, device),
            "cur_len": tok(())}
