"""Bit-packing of sign and code planes (counterpart of ``repro/core/packing.py``).

Each uint8 holds ``μ = 8`` consecutive {-1,+1} codes along the reduction
dimension, LSB first, so a byte is directly a LUT key (paper Table II, §III.B).

Layout: codes ``(..., k, o)`` → packed ``(..., k // 8, o)`` uint8; bit ``j`` of
byte ``c`` is row ``8c + j``. The output dimension stays minor, so a GPU warp
reading consecutive columns of one byte row reads consecutive addresses.
"""

from __future__ import annotations

import torch

MU = 8  # paper's practical LUT sub-vector length (§III.B: "μ = 8 is used")


def _pack_bits(bits: torch.Tensor) -> torch.Tensor:
    """0/1 values ``(..., k, o)`` → uint8 ``(..., k//8, o)``, bit ``j`` of byte
    ``c`` from row ``8c + j``. Works in uint8, one bit position at a time, so
    the temporaries stay the size of the output."""
    *lead, k, o = bits.shape
    if k % MU != 0:
        raise ValueError(f"reduction dim {k} must be a multiple of {MU}")
    rows = bits.to(torch.uint8).reshape(*lead, k // MU, MU, o)
    out = torch.zeros((*lead, k // MU, o), dtype=torch.uint8, device=bits.device)
    for j in range(MU):
        out |= rows[..., j, :] << j
    return out


def pack_signs(binary: torch.Tensor) -> torch.Tensor:
    """Pack {-1,+1} codes ``(..., k, o)`` → uint8 ``(..., k//8, o)``.

    Bit ``j`` of byte ``c`` is 1 iff ``binary[..., 8*c + j, :] == +1``.
    """
    return _pack_bits(binary > 0)


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
    return torch.stack([_pack_bits((codes >> i) & 1) for i in range(q)], dim=-3)


def unpack_codes(packed: torch.Tensor) -> torch.Tensor:
    """Inverse of :func:`pack_codes`: ``(..., q, k//8, o)`` → int32 ``(..., k, o)``."""
    *lead, q, kc, o = packed.shape
    shifts = torch.arange(MU, dtype=torch.uint8, device=packed.device)[:, None]
    codes = torch.zeros((*lead, kc * MU, o), dtype=torch.int32, device=packed.device)
    for i in range(q):  # one plane at a time bounds the temporaries
        bits = (packed[..., i, :, None, :] >> shifts) & 1
        codes |= bits.reshape(*lead, kc * MU, o).to(torch.int32) << i
    return codes
