"""Phi-4-mini 3.8B — dense, RoPE + SwiGLU + GQA, 200k vocab.
[arXiv:2412.08905; hf]"""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="phi4-mini-3.8b",
    family="dense",
    n_layers=32,
    d_model=3072,
    n_heads=24,
    n_kv_heads=8,
    d_ff=8192,
    vocab=200_064,
    rope_theta=10_000.0,
)
