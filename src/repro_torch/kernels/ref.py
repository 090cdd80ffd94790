"""Oracles for the kernels (counterpart of ``repro/kernels/ref.py``)."""

from __future__ import annotations

import torch

from repro_torch.core import bcq as bcq_lib
from repro_torch.core import packing


def bcq_mm_ref(x: torch.Tensor, packed: torch.Tensor, scales: torch.Tensor, g: int) -> torch.Tensor:
    """Oracle for ``bcq_mm`` and ``lutgemm``: ``y = x @ dequantize(W)``.

    x (B, k); packed (q, k//8, o) uint8; scales (q, k//g, o). Returns (B, o) f32.
    """
    signs = packing.unpack_signs(packed)
    w = bcq_lib.dequantize(scales.to(torch.float32), signs, g)
    return torch.matmul(x.to(torch.float32), w)


def lutgemm_tablewise_ref(
    x: torch.Tensor, packed: torch.Tensor, scales: torch.Tensor, g: int
) -> torch.Tensor:
    """Slow f64 emulation of the LUT algorithm (paper §III.B, Table II): a
    2^mu-entry table per mu-length activation sub-vector, partial sums
    retrieved by packed-byte key, group scales applied, summed over planes.
    Returns (B, o) f64."""
    mu = packing.MU
    q, kc, o = packed.shape
    b = x.shape[0]
    x = x.to(torch.float64)
    scales = scales.to(torch.float64)

    keys = torch.arange(1 << mu, device=x.device)
    patterns = 2.0 * ((keys[:, None] >> torch.arange(mu, device=x.device)[None, :]) & 1) - 1.0
    lut = torch.einsum("pj,bcj->bcp", patterns.to(torch.float64), x.reshape(b, kc, mu))

    out = torch.zeros((b, o), dtype=torch.float64, device=x.device)
    cpg = g // mu
    rows = torch.arange(kc, device=x.device)[:, None]
    for i in range(q):
        part = lut[:, rows, packed[i].long()]  # (b, kc, o)
        grouped = part.reshape(b, kc // cpg, cpg, o).sum(dim=2)
        out += torch.einsum("bGo,Go->bo", grouped, scales[i])
    return out
