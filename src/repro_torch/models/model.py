"""Model assembly: init / forward for the dense decoder (counterpart of
``repro/models/model.py``).

Parameters keep the reference's tree: ``{"stages": ({"b0": block}, ...),
"final_norm", "lm_head", "embed"}`` with each block's leaves stacked over the
stage's layers on a leading axis. The reference's ``lax.scan`` over layers
becomes a Python loop that takes layer ``l``'s views of the stacked leaves.

One :func:`forward` serves train, prefill and decode:
  train    cache=None                      → logits (B, S, V)
  prefill  cache=init_cache(...), pos=0    → logits (B, 1, V) with "last"
  decode   cache=filled, pos=cur_len       → logits (B, 1, V)
The cache is updated in place (``layers._cache_write``) and returned.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.core.qtensor import QuantizedTensor
from repro_torch.kernels.ops import linear
from repro_torch.models import layers as L
from repro_torch.models.config import ModelConfig
from repro_torch.utils import resolve_device, tree_map

ATTN_BLOCKS = ("attn",)


def init_block(gen: torch.Generator, cfg: ModelConfig, btype: str, repeat: int, device) -> dict:
    if btype not in ATTN_BLOCKS:
        raise ValueError(f"block type {btype!r} is not ported yet")
    d, lead = cfg.d_model, (repeat,)
    return {
        "ln1": torch.ones((*lead, d), dtype=cfg.pdtype, device=device),
        "attn": L.init_attention(gen, cfg, lead, device),
        "ln2": torch.ones((*lead, d), dtype=cfg.pdtype, device=device),
        "mlp": L.init_mlp(gen, cfg, lead, device),
    }


def init_params(cfg: ModelConfig, seed: int = 0, *, device="cuda") -> dict:
    """Random parameters from a seeded ``torch.Generator`` on ``device``
    (same shapes, dtypes and scales as the reference's ``init_params``; the
    values differ, since the generators differ)."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    stages = tuple(
        {f"b{bi}": init_block(gen, cfg, bt, repeat, dev) for bi, bt in enumerate(pattern)}
        for pattern, repeat in cfg.stages
    )
    lm_head = L._dense_init(gen, (cfg.d_model, cfg.vocab), cfg.d_model, cfg.pdtype, dev)
    embed = torch.randn((cfg.vocab, cfg.d_model), generator=gen, device=dev) * 0.02
    return {
        "stages": stages,
        "final_norm": torch.ones((cfg.d_model,), dtype=cfg.pdtype, device=dev),
        "lm_head": lm_head,
        "embed": embed.to(cfg.pdtype),
    }


def init_cache(cfg: ModelConfig, batch: int, s_max: int, dtype=None, *, device="cuda") -> dict:
    """Zeroed KV cache, stacked per stage like the params:
    ``k``/``v`` of shape ``(repeat, B, s_max, Hkv, Dh)``."""
    dev = resolve_device(device)
    dtype = dtype or cfg.cdtype
    shape = (batch, s_max, cfg.n_kv_heads, cfg.d_head)

    def block_cache(btype, repeat):
        if btype not in ATTN_BLOCKS:
            raise ValueError(f"block type {btype!r} is not ported yet")
        return {
            "k": torch.zeros((repeat, *shape), dtype=dtype, device=dev),
            "v": torch.zeros((repeat, *shape), dtype=dtype, device=dev),
        }

    return {
        "stages": tuple(
            {f"b{bi}": block_cache(bt, repeat) for bi, bt in enumerate(pattern)}
            for pattern, repeat in cfg.stages
        )
    }


def layer_slice(tree, l: int):
    """Layer ``l``'s views of a stacked block tree (no copies)."""

    def take(leaf):
        if isinstance(leaf, QuantizedTensor):
            return leaf.replace(packed=leaf.packed[l], scales=leaf.scales[l])
        return leaf[l]

    return tree_map(take, tree)


def apply_block(
    p: dict,
    cfg: ModelConfig,
    btype: str,
    h: torch.Tensor,
    positions: torch.Tensor,
    cache: Optional[dict],
    pos,
) -> Tuple[torch.Tensor, Optional[dict]]:
    """One pre-norm decoder block → (h, cache)."""
    if btype not in ATTN_BLOCKS:
        raise ValueError(f"block type {btype!r} is not ported yet")
    r, cache = L.attention(
        p["attn"], cfg, L.rmsnorm(p["ln1"], h), positions, cache=cache, pos=pos
    )
    h = h + r
    h = h + L.mlp_swiglu(p["mlp"], L.rmsnorm(p["ln2"], h))
    return h, cache


def forward(
    cfg: ModelConfig,
    params: dict,
    *,
    tokens: torch.Tensor,
    positions: Optional[torch.Tensor] = None,
    cache: Optional[dict] = None,
    pos=None,
    logits_mode: str = "all",  # "all" | "last"
) -> Tuple[torch.Tensor, Optional[dict]]:
    """Run the decoder on ``tokens (B, S)``. Returns (logits f32, cache)."""
    h = params["embed"][tokens].to(cfg.cdtype)
    b, s = tokens.shape
    if positions is None:
        if pos is None:
            base = torch.zeros((b, 1), dtype=torch.int32, device=h.device)
        elif isinstance(pos, torch.Tensor) and pos.dim() == 1:
            base = pos.to(device=h.device, dtype=torch.int32)[:, None]
        else:
            base = torch.full((b, 1), int(pos), dtype=torch.int32, device=h.device)
        positions = base + torch.arange(s, dtype=torch.int32, device=h.device)[None, :]

    for si, (pattern, repeat) in enumerate(cfg.stages):
        stage_p = params["stages"][si]
        stage_c = None if cache is None else cache["stages"][si]
        for l in range(repeat):
            for bi, btype in enumerate(pattern):
                key = f"b{bi}"
                c_in = None if stage_c is None else layer_slice(stage_c[key], l)
                h, _ = apply_block(
                    layer_slice(stage_p[key], l), cfg, btype, h, positions, c_in, pos
                )

    h = L.rmsnorm(params["final_norm"], h)
    if logits_mode == "last":
        h = h[:, -1:]
    logits = linear(h, params["lm_head"], out_dtype=torch.float32)
    return logits, cache
