"""xLSTM-125M — alternating mLSTM (matrix memory) and sLSTM (scalar memory)
blocks; d_ff=0 (no separate FFN — the cells carry their own projections).
[arXiv:2405.04517; unverified]"""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="xlstm-125m",
    family="ssm",
    n_layers=12,
    d_model=768,
    n_heads=4,
    n_kv_heads=4,
    d_ff=0,
    vocab=50304,
    rope_theta=10_000.0,
)
