"""Fused multi-projection BCQ matmul: QKV and gate/up in one kernel launch.

Replaces ``src/repro/kernels/bcq_mm_fused.py::bcq_mm_fused``, which runs the
``bcq_mm`` TPU kernel over projections whose packed planes and scales were
concatenated along the output dim ahead of time (``core.fuse_tensors``).
Here too it is the ``csrc/bcq_mm.cu`` kernel, launched over the fused
output dim (the projections' boundaries need not fall on a block's 128
columns), and the ``(B, Σo_i)`` result is split into N views by
``out_dims``. The activation is read once for all N projections.

``bcq_mm_fused.launches`` counts its own kernel launches, apart from
``bcq_mm``'s: one a row slab, as ``bcq_mm.launches`` does.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch

from repro_torch.core.formats import split_outputs
from repro_torch.kernels import grouptable
from repro_torch.kernels._common import validate
from repro_torch.kernels.bcq_mm import bcq_mm_plain


def bcq_mm_fused(
    x: torch.Tensor,
    packed: torch.Tensor,
    scales: torch.Tensor,
    *,
    g: int,
    out_dims: Sequence[int],
) -> Tuple[torch.Tensor, ...]:
    """``x (B, k)`` against N fused projections → N ``(B, o_i)`` f32 outputs."""
    o = packed.shape[-1]
    if sum(out_dims) != o:
        raise ValueError(f"out_dims {tuple(out_dims)} do not sum to fused o={o}")
    validate(x, packed, scales, g)
    if not x.is_cuda:
        return split_outputs(bcq_mm_plain(x, packed, scales, g=g), out_dims)
    y, n = grouptable.launch("bcq", x, packed, scales, g)
    bcq_mm_fused.launches += n
    return split_outputs(y, out_dims)


bcq_mm_fused.launches = 0
