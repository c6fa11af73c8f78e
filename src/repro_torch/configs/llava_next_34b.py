"""llava-next-34b [vlm] — 60L d_model=7168 56H (GQA kv=8) d_ff=20480 vocab=64000.
Anyres tiling frontend is a STUB: input_specs() provides precomputed patch
embeddings (2880 tokens = 5 tiles x 576 patches, anyres 2x2 grid + base).
[hf:llava-hf/llava-v1.6-mistral-7b-hf; unverified]"""

from repro_torch.models.common import ModelConfig

CONFIG = ModelConfig(
    name="llava-next-34b",
    family="vlm",
    n_layers=60,
    d_model=7168,
    n_heads=56,
    kv_heads=8,
    d_ff=20480,
    vocab=64000,
    frontend="patch_embed",
    frontend_tokens=2880,
    rope_theta=5_000_000.0,
)
