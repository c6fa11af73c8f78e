"""xlstm-1.3b [ssm] — 48L d_model=2048 4H d_ff=0 vocab=50304.
sLSTM + mLSTM blocks in the paper's 7:1 ratio: ("M"*7 + "s") x 6.
[arXiv:2405.04517; unverified]"""

from repro_torch.models.common import ModelConfig

CONFIG = ModelConfig(
    name="xlstm-1.3b",
    family="ssm",
    n_layers=48,
    d_model=2048,
    n_heads=4,
    kv_heads=4,
    d_ff=0,
    vocab=50304,
    ssm_pattern=("M" * 7 + "s") * 6,
    ssm_expand=2,
    ssm_chunk=256,
)
