"""Minitron-4B — pruned Nemotron dense decoder.
[arXiv:2407.14679; hf]"""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="minitron-4b",
    family="dense",
    n_layers=32,
    d_model=3072,
    n_heads=24,
    n_kv_heads=8,
    d_ff=9216,
    vocab=256_000,
    rope_theta=10_000.0,
)
