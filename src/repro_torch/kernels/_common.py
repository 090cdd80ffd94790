"""Checks and launch plumbing shared by the kernel wrappers.

Every packed-weight kernel takes ``x (B, k)`` f32/bf16, ``packed (P, k/8, o)``
uint8 planes and ``scales (S, k/g, o)`` f32/bf16, and writes ``(B, o)`` f32;
what P and S are is the format's business. The wrappers check here what the
reference's ``_validate_tiling`` checks (``g % 8 == 0``, ``k % g == 0``),
plus shapes, dtypes and devices, before a kernel ever sees the tensors.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.core import packing

# dtype codes understood by the C entry points (csrc/common.cuh::DTypeCode)
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

# The launch shape shared by the split-k kernels (K3 lutgemm, K7 codebook_mm,
# K1/K2 bcq_mm, K5 uniform_mm and both paths of K4 ternary_mm): blocks of 8
# warps, up to 8 batch rows a block (K4's tensor cores: 32), and a k-split
# sized to fill the card.
SMS = 132  # streaming multiprocessors of an H100 SXM
MIN_BLOCKS = 2 * SMS  # two blocks of 8 warps on every SM: one wave (128 registers a thread)
WARPS = 8  # warps of a block
MAX_BT = 8  # batch rows a block owns at most


def row_tile(B: int) -> int:
    """Batch rows a block owns: the smallest of 1, 2, 4, 8 that covers
    ``min(B, 8)`` (``csrc/common.cuh::row_tile``)."""
    return next(t for t in (1, 2, 4, 8) if t >= min(B, MAX_BT))


def _align16(n: int) -> int:
    return -(-n // 16) * 16


def wave_fill(blocks: int) -> float:
    """The share of its last wave's ``MIN_BLOCKS`` slots that a grid of
    ``blocks`` fills, over all its waves: 1.0 when no SM idles at the end."""
    return blocks / (-(-blocks // MIN_BLOCKS) * MIN_BLOCKS)


def split_chunk(kc: int, col_tiles: int, min_chunk: int = WARPS) -> int:
    """Byte rows a k-chunk: at least ``MIN_BLOCKS`` blocks at one batch
    tile, chunks of at least ``min_chunk`` byte rows, and of the split
    counts up to 4x the least such, the one whose waves are fullest (fewest
    splits on a tie)."""
    least = -(-MIN_BLOCKS // col_tiles)
    best = None
    for want in range(least, 4 * least + 1):
        chunk = max(min_chunk, -(-kc // want))
        blocks = col_tiles * -(-kc // chunk)
        key = (blocks >= MIN_BLOCKS, wave_fill(blocks), -blocks)
        if best is None or key > best[0]:
            best = (key, chunk)
    return best[1]


_WORKSPACE: dict = {}  # device → (f32 scratch, int32 tickets), grown on demand


def _workspace(device: torch.device, n_scratch: int, n_tickets: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Scratch for a k-split's partial sums and its zeroed tickets (each
    kernel resets every ticket it uses), kept per device and shared by the
    split-k kernels. Launches on one stream use them in turn."""
    scratch, tickets = _WORKSPACE.get(device, (None, None))
    if scratch is None or scratch.numel() < n_scratch:
        scratch = torch.empty(max(1, n_scratch), dtype=torch.float32, device=device)
    if tickets is None or tickets.numel() < n_tickets:
        tickets = torch.zeros(max(1, n_tickets), dtype=torch.int32, device=device)
    _WORKSPACE[device] = (scratch, tickets)
    return scratch, tickets


def _check_dtype(name: str, t: torch.Tensor) -> None:
    if t.dtype not in DTYPE_CODES:
        raise TypeError(f"{name} must be float32 or bfloat16, got {t.dtype}")


def validate_planes(
    packed: torch.Tensor, scales: torch.Tensor, g: int, *, scale_planes: Optional[int] = None
) -> None:
    """``packed (q, k/8, o)`` uint8 with 1 <= q <= 8, ``scales (S, k/g, o)``
    (S = ``scale_planes``, default q) on one device, ``g % 8 == 0`` and
    ``k % g == 0``."""
    if packed.dim() != 3 or scales.dim() != 3:
        raise ValueError(
            f"expected packed (q, k/8, o) and scales (S, k/g, o); got "
            f"{tuple(packed.shape)}, {tuple(scales.shape)}"
        )
    q, kc, o = packed.shape
    k = kc * packing.MU
    if g <= 0 or g % packing.MU or k % g:
        raise ValueError(f"g={g} must be a multiple of {packing.MU} that divides k={k}")
    s = q if scale_planes is None else scale_planes
    if tuple(scales.shape) != (s, k // g, o):
        raise ValueError(f"scales shape {tuple(scales.shape)} != {(s, k // g, o)}")
    if not 1 <= q <= 8:
        raise ValueError(f"q={q} planes; the kernels take 1..8")
    if packed.dtype != torch.uint8:
        raise TypeError(f"packed must be uint8, got {packed.dtype}")
    _check_dtype("scales", scales)
    if packed.device != scales.device:
        raise ValueError(
            f"packed and scales lie on different devices: {packed.device}, {scales.device}"
        )


def validate(
    x: torch.Tensor,
    packed: torch.Tensor,
    scales: torch.Tensor,
    g: int,
    *,
    scale_planes: Optional[int] = None,
) -> None:
    """:func:`validate_planes`, plus ``x (B, k)`` f32/bf16 on the same device."""
    if x.dim() != 2:
        raise ValueError(f"expected x (B, k); got {tuple(x.shape)}")
    validate_planes(packed, scales, g, scale_planes=scale_planes)
    if packed.shape[1] * packing.MU != x.shape[1]:
        raise ValueError(f"packed k dim {packed.shape[1]}*{packing.MU} != x k dim {x.shape[1]}")
    _check_dtype("x", x)
    if x.device != packed.device:
        raise ValueError(
            f"x, packed and scales lie on different devices: "
            f"{x.device}, {packed.device}, {scales.device}"
        )
