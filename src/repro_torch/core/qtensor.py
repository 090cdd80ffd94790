"""QuantizedTensor — the packed quantized-weight container, tagged by format
(counterpart of ``repro/core/qtensor.py``).

All formats share the physical layout

    packed : uint8 ``(…, P, k // 8, o)`` — P bit planes, 8 codes per byte
             (LSB-first along k; a byte is directly a LUT key for BCQ)
    scales : ``(…, S, k // g, o)``       — per-group affine parameters

with any leading layer stacking. ``fmt`` names a registered
:class:`~repro_torch.core.formats.QuantFormat` that owns the semantics.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence, Tuple

import torch


@dataclasses.dataclass(frozen=True)
class QuantizedTensor:
    """Format-tagged group-wise quantization of a ``(k, o)`` weight matrix.

    ``packed`` uint8 ``(…, P, k // 8, o)``; ``scales`` ``(…, S, k // g, o)``
    (bf16 by default); ``g`` group size; ``k, o`` logical shape of
    ``y = x @ W``; ``fmt`` a registry name.
    """

    packed: torch.Tensor
    scales: torch.Tensor
    g: int
    k: int
    o: int
    fmt: str = "bcq"

    @property
    def q(self) -> int:
        """Code planes, read from the shape (robust to leading stacking)."""
        return self.packed.shape[-3]

    @property
    def shape(self) -> Tuple[int, int]:
        return (self.k, self.o)

    @property
    def dtype(self) -> torch.dtype:
        return self.scales.dtype

    def format(self):
        """The registered :class:`~repro_torch.core.formats.QuantFormat`."""
        from repro_torch.core.formats import get_format

        return get_format(self.fmt)

    def replace(self, **changes) -> "QuantizedTensor":
        return dataclasses.replace(self, **changes)

    def to(self, device) -> "QuantizedTensor":
        return self.replace(packed=self.packed.to(device), scales=self.scales.to(device))

    def dequantize(self, dtype=torch.float32) -> torch.Tensor:
        """Reconstruct the dense ``(…, k, o)`` matrix."""
        return self.format().dequantize(self, dtype=dtype)

    def nbytes(self) -> int:
        """Packed size in bytes (code planes + scales)."""
        return self.format().nbytes(self)

    def truncate(self, q_new: int) -> "QuantizedTensor":
        """The nested ``q_new``-bit approximation living inside this tensor."""
        return self.format().truncate(self, q_new)


def fuse_tensors(qts: Sequence[QuantizedTensor]) -> QuantizedTensor:
    """Concatenate N quantized projections along the output dim (one-time
    weight prep for the fused multi-projection kernel)."""
    first = qts[0]
    for t in qts[1:]:
        if t.fmt != first.fmt:
            raise ValueError(f"cannot fuse: format mismatch {t.fmt!r} vs {first.fmt!r}")
    return first.format().fuse(qts)


def quantize_tensor(
    w: torch.Tensor,
    q: int,
    g: int,
    iters: int = 10,
    scale_dtype=torch.bfloat16,
    method: str = "alternating",
    fmt: str = "bcq",
) -> QuantizedTensor:
    """Quantize a dense ``(k, o)`` weight to a :class:`QuantizedTensor` on
    ``w``'s device. ``method``: ``"alternating"`` or ``"greedy"`` (BCQ)."""
    from repro_torch.core.formats import get_format

    return get_format(fmt).quantize(
        w, q=q, g=g, iters=iters, scale_dtype=scale_dtype, method=method
    )
