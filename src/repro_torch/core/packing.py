"""Bit-packing of BCQ binary codes (counterpart of ``repro/core/packing.py``).

Each uint8 holds ``μ = 8`` consecutive {-1,+1} codes along the reduction
dimension, LSB first, so a byte is directly a LUT key (paper Table II, §III.B).

Layout: codes ``(..., k, o)`` → packed ``(..., k // 8, o)`` uint8; bit ``j`` of
byte ``c`` is row ``8c + j``. The output dimension stays minor, so a GPU warp
reading consecutive columns of one byte row reads consecutive addresses.
"""

from __future__ import annotations

import torch

MU = 8  # paper's practical LUT sub-vector length (§III.B: "μ = 8 is used")


def _bit_weights(device) -> torch.Tensor:
    return torch.tensor([1 << j for j in range(MU)], dtype=torch.int32, device=device)


def pack_signs(binary: torch.Tensor) -> torch.Tensor:
    """Pack {-1,+1} codes ``(..., k, o)`` → uint8 ``(..., k//8, o)``.

    Bit ``j`` of byte ``c`` is 1 iff ``binary[..., 8*c + j, :] == +1``.
    """
    *lead, k, o = binary.shape
    if k % MU != 0:
        raise ValueError(f"reduction dim {k} must be a multiple of {MU}")
    bits = (binary > 0).to(torch.int32).reshape(*lead, k // MU, MU, o)
    w = _bit_weights(binary.device)[:, None]
    return (bits * w).sum(dim=-2).to(torch.uint8)


def unpack_signs(packed: torch.Tensor) -> torch.Tensor:
    """Inverse of :func:`pack_signs`: uint8 ``(..., k//8, o)`` → int8 ``(..., k, o)``."""
    *lead, kc, o = packed.shape
    shifts = torch.arange(MU, dtype=torch.uint8, device=packed.device)[:, None]
    bits = (packed[..., :, None, :] >> shifts) & 1
    return (2 * bits.to(torch.int8) - 1).reshape(*lead, kc * MU, o)


def pack_codes(codes: torch.Tensor, q: int) -> torch.Tensor:
    """Pack unsigned ``q``-bit codes ``(..., k, o)`` → uint8 ``(..., q, k//8, o)``.

    Plane ``i`` holds bit ``i`` of every code, packed 8 per byte along ``k``
    exactly like :func:`pack_signs`.
    """
    *lead, k, o = codes.shape
    if k % MU != 0:
        raise ValueError(f"reduction dim {k} must be a multiple of {MU}")
    plane_shift = torch.arange(q, dtype=torch.int32, device=codes.device)[:, None, None]
    planes = (codes.to(torch.int32)[..., None, :, :] >> plane_shift) & 1
    bits = planes.reshape(*lead, q, k // MU, MU, o)
    w = _bit_weights(codes.device)[:, None]
    return (bits * w).sum(dim=-2).to(torch.uint8)


def unpack_codes(packed: torch.Tensor) -> torch.Tensor:
    """Inverse of :func:`pack_codes`: ``(..., q, k//8, o)`` → int32 ``(..., k, o)``."""
    *lead, q, kc, o = packed.shape
    shifts = torch.arange(MU, dtype=torch.uint8, device=packed.device)[:, None]
    bits = (packed[..., :, :, None, :] >> shifts) & 1
    planes = bits.reshape(*lead, q, kc * MU, o).to(torch.int32)
    w = (1 << torch.arange(q, dtype=torch.int32, device=packed.device))[:, None, None]
    return (planes * w).sum(dim=-3)
