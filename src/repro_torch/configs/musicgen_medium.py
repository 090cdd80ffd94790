"""MusicGen-medium — decoder-only transformer over EnCodec tokens.
[arXiv:2306.05284; hf]

Backbone only: the EnCodec frontend is a stub — callers supply
precomputed frame embeddings and an ``embed_fn`` that maps sampled codes
back to embeddings (``Engine(embed_fn=...)``); the LM head predicts the
2048-entry codebook vocabulary.
"""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="musicgen-medium",
    family="audio",
    n_layers=48,
    d_model=1536,
    n_heads=24,
    n_kv_heads=24,
    d_ff=6144,
    vocab=2048,
    rope_theta=10_000.0,
    input_kind="embeddings",
)
