"""Ternary {-1, 0, +1} matmul consumed in packed form: ``y = x @ (alpha·t)``.

Replaces the TPU kernel ``src/repro/kernels/ternary_mm.py::ternary_mm``
(``ternary_mm_call``, ``_ternary_mm_kernel``, ``_decode_ternary_block``).
The CUDA kernel is ``csrc/ternary_mm.cu``: K1's layout, with each weight
decoded from its sign and mask bits to ``±alpha`` or 0 in registers.

The packed tensor carries exactly 2 planes (sign, mask) and the scales one
``alpha`` plane; anything else is refused. :func:`ternary_mm` launches the
kernel for CUDA tensors and runs :func:`ternary_mm_plain` for CPU tensors.
``ternary_mm.launches`` counts kernel launches.
"""

from __future__ import annotations

import torch

from repro_torch.core.formats import ternary_dequantize
from repro_torch.kernels._common import launch_matvec, validate

PLANES = 2  # sign + mask


def ternary_mm_plain(x: torch.Tensor, packed: torch.Tensor, scales: torch.Tensor, *, g: int) -> torch.Tensor:
    """The plain PyTorch version: dequantize to f32 ``(2·sign − 1)·mask·alpha``,
    multiply."""
    return torch.matmul(x.to(torch.float32), ternary_dequantize(packed, scales, g))


def ternary_mm(x: torch.Tensor, packed: torch.Tensor, scales: torch.Tensor, *, g: int) -> torch.Tensor:
    """x (B, k) @ ternary[(2, k/8, o) sign+mask planes, (1, k/g, o) alpha] → (B, o) f32.

    x and scales may be f32 or bf16. A CUDA input launches the kernel (or
    raises); a CPU input runs :func:`ternary_mm_plain`.
    """
    if packed.dim() == 3 and packed.shape[0] != PLANES:
        raise ValueError(
            f"ternary packed tensor must carry exactly {PLANES} planes (sign + mask), "
            f"got {packed.shape[0]}"
        )
    validate(x, packed, scales, g, scale_planes=1)
    if not x.is_cuda:
        return ternary_mm_plain(x, packed, scales, g=g)
    out = launch_matvec("ternary_mm", x, packed, scales, g)
    ternary_mm.launches += 1
    return out


ternary_mm.launches = 0
