"""Arbitrary-codebook matmul consumed in packed form: ``w[r, c] = T[idx[r, c], r // g, c]``.

Replaces the TPU kernel ``src/repro/kernels/codebook_mm.py::codebook_mm``
(``codebook_mm_call``, ``_codebook_mm_kernel``, ``_unpack_indices_block``).
The CUDA kernel is ``csrc/codebook_mm.cu``: K1's layout, with the block's
32-column slice of the ``(2^q, k/g, o)`` centroid table staged in shared
memory a few groups at a time and each weight looked up there by the q-bit
index reassembled from the planes (the paper's LUT generalized, as FLUTE
does).

The table must carry ``2^q`` centroids; anything else is refused.
:func:`codebook_mm` launches the kernel for CUDA tensors and runs
:func:`codebook_mm_plain` for CPU tensors. ``codebook_mm.launches`` counts
kernel launches.
"""

from __future__ import annotations

import torch

from repro_torch.core.formats import codebook_dequantize
from repro_torch.kernels._common import launch_matvec, validate


def codebook_mm_plain(x: torch.Tensor, packed: torch.Tensor, scales: torch.Tensor, *, g: int) -> torch.Tensor:
    """The plain PyTorch version: gather the f32 centroids by index, multiply."""
    return torch.matmul(x.to(torch.float32), codebook_dequantize(packed, scales, g))


def codebook_mm(x: torch.Tensor, packed: torch.Tensor, scales: torch.Tensor, *, g: int) -> torch.Tensor:
    """x (B, k) @ codebook[(q, k/8, o) index planes, (2^q, k/g, o) centroids] → (B, o) f32.

    x and scales may be f32 or bf16. A CUDA input launches the kernel (or
    raises); a CPU input runs :func:`codebook_mm_plain`.
    """
    n_cent = 1 << packed.shape[0] if packed.dim() == 3 else None
    if n_cent and scales.dim() == 3 and scales.shape[0] != n_cent:
        raise ValueError(
            f"codebook table carries {scales.shape[0]} centroids but the packed tensor "
            f"has q={packed.shape[0]} index planes (expected {n_cent})"
        )
    validate(x, packed, scales, g, scale_planes=n_cent)
    if not x.is_cuda:
        return codebook_mm_plain(x, packed, scales, g=g)
    out = launch_matvec("codebook_mm", x, packed, scales, g)
    codebook_mm.launches += 1
    return out


codebook_mm.launches = 0
