"""Model configuration (counterpart of ``repro/models/config.py``; every
family of the reference is ported: dense, MoE, vlm, audio, hybrid, ssm).

A model is a stack of stages; each stage is ``(pattern, repeat)``: a tuple
of block types applied in order, repeated ``repeat`` times with its
parameters stacked on a leading axis. The stages are derived as the
reference derives them:

  dense    [("attn",) x L]
  audio    [("attn",) x L]   (frame-embedding inputs: ``input_kind="embeddings"``)
  vlm      [("attn",) * (p - 1) + ("cross",) x L // p]   (p = ``cross_attn_period``, L % p == 0)
  moe      [("attn_moe",) x L], or with ``moe_period`` p > 1
           [("attn",) * (p - 1) + ("attn_moe",) x L // p]   (L % p == 0)
  hybrid   [("rglru", "rglru", "local_attn") x L // 3, ("rglru",) * (L % 3) x 1]
  ssm      [("mlstm", "slstm") x L // 2]   (L even)

``rglru`` is Griffin's recurrent block (``models/recurrent.py``),
``local_attn`` attention over a window of ``window`` positions whose KV
cache is a ring of ``min(max_seq, window)`` rows (``models/layers.py``).
``mlstm`` and ``slstm`` are the xLSTM cells (``models/recurrent.py``).
``cross`` is an attention block whose queries attend a provided memory, the
``n_image_tokens`` rows of a stub vision tower's output projected by its
``wk`` / ``wv`` (``models/model.py``); ``input_kind="embeddings"`` (the
audio family's) feeds ``(B, S, d_model)`` frame embeddings in place of
token ids, so such a model has no ``embed`` table.
``attn_moe`` is an attention block whose MLP is a bank of ``n_experts``
SwiGLU experts of width ``moe_d_ff``, ``top_k`` of them a token, plus an
always-on ``shared_expert`` where the config has one (``models/moe.py``).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

Stage = Tuple[Tuple[str, ...], int]

PORTED_FAMILIES = ("dense", "moe", "vlm", "audio", "hybrid", "ssm")
INPUT_KINDS = ("tokens", "embeddings")
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
    window: int = 2048  # local attention window (hybrid family)
    # MoE
    n_experts: int = 0
    top_k: int = 0
    capacity_factor: float = 1.25
    shared_expert: bool = False  # llama4-style always-on expert
    moe_d_ff: Optional[int] = None  # per-expert hidden (defaults to d_ff)
    moe_period: int = 1  # every Nth layer is MoE (llama4 interleaves dense/MoE)
    # VLM
    cross_attn_period: int = 5  # every Nth layer is cross-attention
    n_image_tokens: int = 1601  # stub vision tower output length
    # hybrid (RG-LRU)
    lru_width: Optional[int] = None  # defaults to d_model
    conv_width: int = 4
    # ssm (xLSTM): the mLSTM block's inner width is d_model * this
    mlstm_proj_factor: float = 2.0
    param_dtype: str = "bfloat16"
    compute_dtype: str = "bfloat16"
    # "int8": K/V stored as int8 codes with one f32 scale per (token, head)
    # (``models/layers.py::_kv_quantize``); "bfloat16": the cache in the
    # compute dtype (``init_cache``'s ``dtype``)
    kv_cache_dtype: str = "bfloat16"
    # inputs: "tokens" or "embeddings" (modality-stub archs)
    input_kind: str = "tokens"

    def __post_init__(self):
        if self.family not in PORTED_FAMILIES:
            raise ValueError(f"unknown family {self.family!r}; ported: {PORTED_FAMILIES}")
        if self.kv_cache_dtype not in KV_CACHE_DTYPES:
            raise ValueError(
                f"kv_cache_dtype {self.kv_cache_dtype!r}: expected one of {KV_CACHE_DTYPES}"
            )
        if self.input_kind not in INPUT_KINDS:
            raise ValueError(f"input_kind {self.input_kind!r}: expected one of {INPUT_KINDS}")
        if self.d_head is None:
            object.__setattr__(self, "d_head", self.d_model // self.n_heads)
        if self.lru_width is None:
            object.__setattr__(self, "lru_width", self.d_model)
        if self.moe_d_ff is None and self.n_experts:
            object.__setattr__(self, "moe_d_ff", self.d_ff)
        if self.stages is None:
            object.__setattr__(self, "stages", self._derive_stages())

    def _derive_stages(self) -> Tuple[Stage, ...]:
        L = self.n_layers
        if self.family == "moe":
            if self.moe_period > 1:
                p = self.moe_period
                if L % p:
                    raise ValueError(f"moe layers {L} must divide by period {p}")
                return ((("attn",) * (p - 1) + ("attn_moe",), L // p),)
            return ((("attn_moe",), L),)
        if self.family == "vlm":
            p = self.cross_attn_period
            if L % p:
                raise ValueError(f"vlm layers {L} must divide by period {p}")
            return ((("attn",) * (p - 1) + ("cross",), L // p),)
        if self.family == "hybrid":
            # Griffin 1:2: repeat (rglru, rglru, local_attn); the remainder rglru
            full, rem = divmod(L, 3)
            stages: list = [(("rglru", "rglru", "local_attn"), full)]
            if rem:
                stages.append((("rglru",) * rem, 1))
            return tuple(stages)
        if self.family == "ssm":
            if L % 2:
                raise ValueError("ssm family expects even layer count")
            return ((("mlstm", "slstm"), L // 2),)
        return ((("attn",), L),)

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

    @property
    def supports_long_context(self) -> bool:
        """Sub-quadratic decode: no full-attention block anywhere."""
        return all(
            b in ("rglru", "local_attn", "mlstm", "slstm")
            for pattern, _ in self.stages
            for b in pattern
        )

    def block_counts(self) -> dict:
        """Block type → how many layers of it the model has."""
        counts: dict = {}
        for pattern, repeat in self.stages:
            for b in pattern:
                counts[b] = counts.get(b, 0) + repeat
        return counts


def reduced(cfg: ModelConfig, **overrides) -> ModelConfig:
    """A tiny same-family config for CPU smoke tests (the reference's sizes:
    ``cross_attn_period`` layers for the vlm family (one period: its
    ``attn`` blocks and its ``cross`` block) over 8 image tokens, 5 layers
    for the hybrid family, 2 otherwise, the ssm family's two cells
    included; window 16, lru_width 64; at most 8 experts, top-2,
    ``moe_d_ff`` 64, the shared expert kept; ``input_kind`` carried; like
    the reference it does not carry ``moe_period``, so a reduced
    interleaved MoE is all ``attn_moe`` unless the caller passes one)."""
    base = dict(
        name=cfg.name + "-smoke",
        family=cfg.family,
        n_layers={"vlm": cfg.cross_attn_period, "hybrid": 5, "ssm": 2}.get(cfg.family, 2),
        d_model=64,
        n_heads=4,
        n_kv_heads=max(1, min(cfg.n_kv_heads, 2)),
        d_ff=128 if cfg.d_ff else 0,
        vocab=256,
        rope_theta=cfg.rope_theta,
        window=16,
        n_experts=min(cfg.n_experts, 8),
        top_k=min(cfg.top_k, 2),
        shared_expert=cfg.shared_expert,
        moe_d_ff=64 if cfg.n_experts else None,
        cross_attn_period=cfg.cross_attn_period,
        n_image_tokens=8,
        lru_width=64,
        input_kind=cfg.input_kind,
        param_dtype="float32",
        compute_dtype="float32",
    )
    base.update(overrides)
    return ModelConfig(**base)


# ---------------------------------------------------------------------------
# Input shape sets of the dry run (``launch/dryrun.py``): every LM shape is
# (seq_len, global_batch), the reference's values
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # "train" | "prefill" | "decode"


SHAPES = {
    "train_4k": ShapeConfig("train_4k", 4_096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524_288, 1, "decode"),
}
