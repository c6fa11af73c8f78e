"""seamless-m4t-large-v2 [audio] — enc-dec, 24L d_model=1024 16H (kv=16)
d_ff=8192 vocab=256206.  The speech frontend is a STUB: input_specs() feeds
precomputed frame embeddings to a 24-layer encoder; the 24-layer text decoder
cross-attends.  [arXiv:2308.11596; hf]"""

from repro_torch.models.common import ModelConfig

CONFIG = ModelConfig(
    name="seamless-m4t-large-v2",
    family="audio",
    n_layers=24,
    encoder_layers=24,
    d_model=1024,
    n_heads=16,
    kv_heads=16,
    d_ff=8192,
    vocab=256206,
    frontend="audio_frames",
    rope_theta=10_000.0,
)
