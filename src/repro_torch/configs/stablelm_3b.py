"""stablelm-3b [dense] — 32L d_model=2560 32H (GQA kv=32) d_ff=6912 vocab=50304.
[hf:stabilityai/stablelm-2-1_6b; unverified]"""

from repro_torch.models.common import ModelConfig

CONFIG = ModelConfig(
    name="stablelm-3b",
    family="dense",
    n_layers=32,
    d_model=2560,
    n_heads=32,
    kv_heads=32,
    d_ff=6912,
    vocab=50304,
    rope_theta=10_000.0,
)
