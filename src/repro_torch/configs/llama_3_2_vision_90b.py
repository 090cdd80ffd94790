"""Llama-3.2-Vision-90B — text decoder with interleaved cross-attention image
layers (every 5th layer). The vision tower is a stub: callers supply
precomputed patch embeddings (``Engine.generate(image_emb=...)``).
[hf:meta-llama/Llama-3.2-11B-Vision; unverified]"""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="llama-3.2-vision-90b",
    family="vlm",
    n_layers=100,
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    d_ff=28672,
    vocab=128256,
    rope_theta=500_000.0,
    cross_attn_period=5,
    n_image_tokens=1601,
)
