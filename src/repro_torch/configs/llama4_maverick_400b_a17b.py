"""llama4-maverick-400b-a17b [moe] — 48L d_model=5120 40H (GQA kv=8) d_ff=8192
vocab=202048, MoE 128 experts top-1 (+1 shared).  Early fusion is multimodal
input fusion; the assigned backbone is text-only.
[hf:meta-llama/Llama-4-Scout-17B-16E; unverified]"""

from repro_torch.models.common import ModelConfig

CONFIG = ModelConfig(
    name="llama4-maverick-400b-a17b",
    family="moe",
    n_layers=48,
    d_model=5120,
    n_heads=40,
    kv_heads=8,
    d_ff=8192,
    vocab=202048,
    head_dim=128,
    n_experts=128,
    top_k=1,
    n_shared_experts=1,
    moe_d_ff=8192,
    capacity_factor=1.25,
    rope_theta=500_000.0,
)
