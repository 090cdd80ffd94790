"""Walk a parameter tree and quantize its linear weights (counterpart of
``repro/quant/quantize.py``).

``QuantPolicy`` is one global ``(q, g, fmt)`` or a per-sublayer-type
assignment (attention vs FFN vs LM head, paper §V.A / Fig. 12). The same
leaves are chosen as in the reference: the names in ``_QUANT_NAMES`` whose
two trailing dims are both at least ``_MIN_DIM`` and whose k divides by 8,
each with the largest valid group size not above the requested one.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

from repro_torch.core.formats import get_format
from repro_torch.core.qtensor import QuantizedTensor
from repro_torch.utils import resolve_device, tree_leaves, tree_map, tree_map_with_path

_QUANT_NAMES = frozenset(
    {
        "wq", "wk", "wv", "wo",  # attention
        "w_gate", "w_up", "w_down",  # (shared-)MLP and MoE experts
        "w_x", "w_y", "w_a", "w_i", "w_out",  # RG-LRU block linears
        "w_z", "w_f", "w_o",  # sLSTM / mLSTM gate projections
        "lm_head",
    }
)
_MIN_DIM = 128  # skip tiny projections


@dataclasses.dataclass(frozen=True)
class QuantPolicy:
    """(q, g[, fmt]) per sublayer type; ``None`` entries use ``(q, g)``."""

    q: int = 4
    g: int = 128
    attn: Optional[Tuple] = None
    ffn: Optional[Tuple] = None
    lm_head: Optional[Tuple] = None
    skip_lm_head: bool = False
    method: str = "alternating"  # "alternating" | "greedy" (BCQ solvers)
    iters: int = 8
    scale_dtype: str = "bfloat16"
    fmt: str = "bcq"

    def resolve(self, path_keys: Tuple) -> Optional[Tuple]:
        """The raw per-path entry (2- or 3-tuple), or the (q, g) defaults."""
        name = path_keys[-1]
        if name not in _QUANT_NAMES:
            return None
        if name == "lm_head":
            if self.skip_lm_head:
                return None
            return self.lm_head or (self.q, self.g)
        if "attn" in path_keys:
            return self.attn or (self.q, self.g)
        return self.ffn or (self.q, self.g)

    def resolve_fmt(self, path_keys: Tuple) -> Optional[Tuple[int, int, str]]:
        """Fully resolved ``(q, g, fmt)`` for a leaf path (None → ineligible)."""
        qg = self.resolve(path_keys)
        if qg is None:
            return None
        if len(qg) == 2:
            return (qg[0], qg[1], self.fmt)
        return (qg[0], qg[1], qg[2])


def _effective_g(k: int, g: int) -> int:
    """Largest group size <= g that divides k and is a multiple of 8."""
    g = min(g, k)
    while g >= 8:
        if k % g == 0 and g % 8 == 0:
            return g
        g -= 8
    return 0


def _eligible(leaf, qgf) -> bool:
    return (
        qgf is not None
        and isinstance(leaf, torch.Tensor)
        and leaf.dim() >= 2
        and leaf.shape[-1] >= _MIN_DIM
        and leaf.shape[-2] >= _MIN_DIM
        and leaf.shape[-2] % 8 == 0
    )


def _quantize_leaf(leaf: torch.Tensor, q: int, g: int, fmt: str, policy: QuantPolicy) -> QuantizedTensor:
    *lead, k, o = leaf.shape
    g_eff = _effective_g(k, g)
    if not g_eff:
        raise ValueError(f"no valid group size for k={k} (requested g={g})")
    fobj = get_format(fmt)
    packed, scales = [], []
    for w in leaf.reshape(-1, k, o):  # one matrix at a time bounds the solver's memory
        qt = fobj.quantize(
            w.to(torch.float32),
            q=q,
            g=g_eff,
            scale_dtype=getattr(torch, policy.scale_dtype),
            method=policy.method,
            iters=policy.iters,
        )
        packed.append(qt.packed)
        scales.append(qt.scales)
    packed_t = torch.stack(packed).reshape(*lead, *packed[0].shape)
    scales_t = torch.stack(scales).reshape(*lead, *scales[0].shape)
    return QuantizedTensor(packed=packed_t, scales=scales_t, g=g_eff, k=k, o=o, fmt=fmt)


def quantize_params(params, policy: QuantPolicy, *, device="cuda"):
    """Replace every eligible dense leaf with a packed QuantizedTensor; the
    result lies on ``device``, where the solver runs."""
    dev = resolve_device(device)

    def visit(path, leaf):
        leaf = leaf.to(dev)
        qgf = policy.resolve_fmt(path)
        if not _eligible(leaf, qgf):
            return leaf
        return _quantize_leaf(leaf, qgf[0], qgf[1], qgf[2], policy)

    return tree_map_with_path(visit, params)


def truncate_params(params, q_draft: int):
    """Truncate every QuantizedTensor leaf to its nested ``q_draft``-bit view;
    every other leaf is returned as is (shared by reference)."""
    if q_draft < 1:
        raise ValueError(f"q_draft must be >= 1, got {q_draft}")

    def visit(leaf):
        if isinstance(leaf, QuantizedTensor):
            return get_format(leaf.fmt).truncate(leaf, min(q_draft, leaf.q))
        return leaf

    return tree_map(visit, params)


def quantized_bytes(tree) -> int:
    """Total parameter bytes (packed where quantized)."""
    total = 0
    for leaf in tree_leaves(tree):
        if isinstance(leaf, QuantizedTensor):
            total += leaf.packed.numel() * leaf.packed.element_size()
            total += leaf.scales.numel() * leaf.scales.element_size()
        else:
            total += leaf.numel() * leaf.element_size()
    return total
