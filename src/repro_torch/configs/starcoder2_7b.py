"""StarCoder2-7B — dense code model, GQA kv=4, RoPE.
[arXiv:2402.19173; hf]"""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="starcoder2-7b",
    family="dense",
    n_layers=32,
    d_model=4608,
    n_heads=36,
    n_kv_heads=4,
    d_ff=18432,
    vocab=49152,
    rope_theta=100_000.0,
)
