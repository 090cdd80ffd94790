"""GPT-3 175B — the paper's §IV estimation target (m = d_model = 12288, 96L).
Used by benchmarks/table5_gpt3.py; not part of the assigned dry-run cells.
[paper Table I]"""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="gpt3-175b",
    family="dense",
    n_layers=96,
    d_model=12288,
    n_heads=96,
    n_kv_heads=96,
    d_ff=49152,
    vocab=50257,
    rope_theta=10_000.0,
)
