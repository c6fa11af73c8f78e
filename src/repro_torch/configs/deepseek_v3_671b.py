"""deepseek-v3-671b [moe] — 61L d_model=7168 128H d_ff=2048(routed experts)
vocab=129280, MoE 1 shared + 256 routed top-8, MLA, MTP.
MLA dims and the 3 leading dense layers (dense FFN 18432) follow
arXiv:2412.19437 Table/Sec 4; the assigned spec's d_ff=2048 is the routed
expert width."""

from repro_torch.models.common import ModelConfig

CONFIG = ModelConfig(
    name="deepseek-v3-671b",
    family="moe",
    n_layers=61,
    d_model=7168,
    n_heads=128,
    kv_heads=128,
    d_ff=2048,
    vocab=129280,
    n_experts=256,
    top_k=8,
    n_shared_experts=1,
    moe_d_ff=2048,
    dense_layers=3,
    capacity_factor=1.25,
    mla=True,
    q_lora_rank=1536,
    kv_lora_rank=512,
    qk_nope_dim=128,
    qk_rope_dim=64,
    v_head_dim=128,
    head_dim=192,
    mtp=True,
    rope_theta=10_000.0,
)
