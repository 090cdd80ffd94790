"""Model configuration (counterpart of ``repro/models/config.py``; only the
dense decoder family is ported so far).

A model is a stack of stages; each stage is ``(pattern, repeat)``: a tuple
of block types applied in order, repeated ``repeat`` times with its
parameters stacked on a leading axis. The dense family is
``(("attn",), n_layers)``.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

Stage = Tuple[Tuple[str, ...], int]

PORTED_FAMILIES = ("dense",)
KV_CACHE_DTYPES = ("bfloat16", "int8")


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    d_head: Optional[int] = None  # default d_model // n_heads
    stages: Optional[Tuple[Stage, ...]] = None  # derived if None
    rope_theta: float = 500_000.0
    param_dtype: str = "bfloat16"
    compute_dtype: str = "bfloat16"
    # "int8": K/V stored as int8 codes with one f32 scale per (token, head)
    # (``models/layers.py::_kv_quantize``); "bfloat16": the cache in the
    # compute dtype (``init_cache``'s ``dtype``)
    kv_cache_dtype: str = "bfloat16"

    def __post_init__(self):
        if self.family not in PORTED_FAMILIES:
            raise ValueError(
                f"family {self.family!r} is not ported yet; ported: {PORTED_FAMILIES}"
            )
        if self.kv_cache_dtype not in KV_CACHE_DTYPES:
            raise ValueError(
                f"kv_cache_dtype {self.kv_cache_dtype!r}: expected one of {KV_CACHE_DTYPES}"
            )
        if self.d_head is None:
            object.__setattr__(self, "d_head", self.d_model // self.n_heads)
        if self.stages is None:
            object.__setattr__(self, "stages", ((("attn",), self.n_layers),))

    @property
    def pdtype(self) -> torch.dtype:
        return getattr(torch, self.param_dtype)

    @property
    def cdtype(self) -> torch.dtype:
        return getattr(torch, self.compute_dtype)

    @property
    def q_dim(self) -> int:
        return self.n_heads * self.d_head

    @property
    def kv_dim(self) -> int:
        return self.n_kv_heads * self.d_head


def reduced(cfg: ModelConfig, **overrides) -> ModelConfig:
    """A tiny same-family config for CPU smoke tests (the reference's sizes)."""
    base = dict(
        name=cfg.name + "-smoke",
        family=cfg.family,
        n_layers=2,
        d_model=64,
        n_heads=4,
        n_kv_heads=max(1, min(cfg.n_kv_heads, 2)),
        d_ff=128 if cfg.d_ff else 0,
        vocab=256,
        rope_theta=cfg.rope_theta,
        param_dtype="float32",
        compute_dtype="float32",
    )
    base.update(overrides)
    return ModelConfig(**base)
