"""zamba2-2.7b [hybrid] — 54L d_model=2560 32H (kv=32) d_ff=10240 vocab=32000,
ssm_state=64.  Mamba2 backbone + ONE shared attention block applied every 6th
layer: ("m"*5 + "a") x 9.  [arXiv:2411.15242; hf]"""

from repro_torch.models.common import ModelConfig

CONFIG = ModelConfig(
    name="zamba2-2.7b",
    family="hybrid",
    n_layers=54,
    d_model=2560,
    n_heads=32,
    kv_heads=32,
    d_ff=10240,
    vocab=32000,
    d_state=64,
    ssm_pattern=("m" * 5 + "a") * 9,
    ssm_expand=2,
    ssm_head_dim=64,
    ssm_chunk=256,
)
