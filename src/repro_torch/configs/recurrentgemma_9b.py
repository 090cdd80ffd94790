"""RecurrentGemma-9B — Griffin: RG-LRU recurrent blocks and local attention, 2:1.
[arXiv:2402.19427; unverified]"""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="recurrentgemma-9b",
    family="hybrid",
    n_layers=38,
    d_model=4096,
    n_heads=16,
    n_kv_heads=1,
    d_ff=12288,
    vocab=256_000,
    rope_theta=10_000.0,
    window=2048,
    lru_width=4096,
)
