"""Decode weight prep: fuse per-block QKV and gate/up projections
(counterpart of ``repro/models/fuse.py``).

For every self-attention block ``wq``/``wk``/``wv`` become one
output-concatenated ``wqkv`` leaf and every SwiGLU MLP's ``w_gate``/``w_up``
become ``w_gate_up``; ``models.layers`` then issues one projection launch per
activation instead of N. Quantized leaves fuse only when they share a format
that supports fusion and the same ``(k, q, g)`` and scale dtype; anything
else is left unfused. The fused tree's parameter bytes equal the unfused
tree's (the concatenation allocates new tensors; the caller frees the old
tree by dropping it).
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch

from repro_torch.core.formats import get_format
from repro_torch.core.qtensor import QuantizedTensor, fuse_tensors
from repro_torch.models.config import ModelConfig

_FUSABLE_ATTN = ("attn",)


def _fuse_leaves(leaves: Sequence) -> Optional[object]:
    """Fuse N projection leaves along the output dim, or None if not fusable."""
    if any(leaf is None for leaf in leaves):
        return None
    if all(isinstance(leaf, QuantizedTensor) for leaf in leaves):
        if len({leaf.fmt for leaf in leaves}) != 1:
            return None
        if not get_format(leaves[0].fmt).supports_fuse:
            return None
        try:
            return fuse_tensors(leaves)
        except ValueError:
            return None
    if any(isinstance(leaf, QuantizedTensor) for leaf in leaves):
        return None  # mixed dense/quantized: no shared kernel to fuse into
    if len({leaf.shape[:-1] for leaf in leaves}) != 1 or len({leaf.dtype for leaf in leaves}) != 1:
        return None
    return torch.cat(list(leaves), dim=-1)


def _fuse_attn(attn: dict) -> dict:
    fused = _fuse_leaves([attn.get("wq"), attn.get("wk"), attn.get("wv")])
    if fused is None:
        return attn
    out = {k: v for k, v in attn.items() if k not in ("wq", "wk", "wv")}
    out["wqkv"] = fused
    return out


def _fuse_mlp(mlp: dict) -> dict:
    if "w_gate" not in mlp or "w_up" not in mlp:
        return mlp
    fused = _fuse_leaves([mlp["w_gate"], mlp["w_up"]])
    if fused is None:
        return mlp
    out = {k: v for k, v in mlp.items() if k not in ("w_gate", "w_up")}
    out["w_gate_up"] = fused
    return out


def fuse_decode_projections(cfg: ModelConfig, params: dict) -> dict:
    """Return a params tree with QKV / gate-up leaves output-fused for decode."""
    stages = []
    for si, (pattern, _) in enumerate(cfg.stages):
        stage_p = dict(params["stages"][si])
        for bi, btype in enumerate(pattern):
            bp = dict(stage_p[f"b{bi}"])
            if btype in _FUSABLE_ATTN and "attn" in bp:
                bp["attn"] = _fuse_attn(bp["attn"])
            if "mlp" in bp and isinstance(bp["mlp"], dict):
                bp["mlp"] = _fuse_mlp(bp["mlp"])
            stage_p[f"b{bi}"] = bp
        stages.append(stage_p)
    out = dict(params)
    out["stages"] = tuple(stages)
    return out
