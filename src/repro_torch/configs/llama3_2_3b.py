"""Llama-3.2-3B — small Llama-3 dense decoder.
[hf:meta-llama/Llama-3.2-1B; unverified]"""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="llama3.2-3b",
    family="dense",
    n_layers=28,
    d_model=3072,
    n_heads=24,
    n_kv_heads=8,
    d_ff=8192,
    vocab=128256,
    rope_theta=500_000.0,
)
