"""Llama-4-Maverick 400B-A17B — 128-expert top-1 MoE with a shared expert,
dense and MoE layers interleaved (the modality frontend is not modelled).
[hf:meta-llama/Llama-4-Scout-17B-16E; unverified]"""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="llama4-maverick-400b-a17b",
    family="moe",
    n_layers=48,
    d_model=5120,
    n_heads=40,
    n_kv_heads=8,
    d_ff=8192,
    vocab=202_048,
    rope_theta=500_000.0,
    n_experts=128,
    top_k=1,
    shared_expert=True,
    moe_period=2,  # every second layer is MoE (~400B total)
)
