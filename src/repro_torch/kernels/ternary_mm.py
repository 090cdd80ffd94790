"""Ternary {-1, 0, +1} matmul consumed in packed form: ``y = x @ (alpha·t)``.

Replaces the TPU kernel ``src/repro/kernels/ternary_mm.py::ternary_mm``
(``ternary_mm_call``, ``_ternary_mm_kernel``, ``_decode_ternary_block``).
The CUDA source is ``csrc/ternary_mm.cu``; its header note says what bounds
the kernel and how each path answers that. Two paths, chosen by the dtypes
alone, never by B, so a slot batch and a solo decode take the same one:

- bf16 x with bf16 alpha: the tensor cores (``mma.sync`` m16n8k16, weights
  on the M side). Each weight, ``+alpha``, ``-alpha`` or 0, is decoded from
  its sign and mask bits into a bf16 A fragment in registers, exact, so the
  tensor cores sum the plain version's own terms. :func:`tc_plan` makes its
  host-side choices (the k-split, stages, shared memory) from (k, o, g)
  alone. ``ternary_mm.tc_launches`` counts this path's launches.
- any other pair (f32 x, or f32 alpha): the CUDA cores, on the group-table
  skeleton of K1/K5 (:mod:`repro_torch.kernels.grouptable`, format
  ``"ternary"``), the 2-bit code ``sign | mask << 1`` looking up
  ``{0, 0, -alpha, +alpha}``.

The packed tensor carries exactly 2 planes (sign, mask) and the scales one
``alpha`` plane; anything else is refused. :func:`ternary_mm` launches a
kernel for CUDA tensors (or raises) and runs :func:`ternary_mm_plain` for
CPU tensors. ``ternary_mm.launches`` counts kernel launches on either
path: one a call at decode widths, one a row slab where a call is wider
than a slab. :func:`fragment_plain` is the A-fragment decode in plain
PyTorch, for the tests.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
from typing import Optional, Tuple

import torch

from repro_torch.core import packing
from repro_torch.core.formats import ternary_dequantize
from repro_torch.kernels import _build, grouptable
from repro_torch.kernels._common import MIN_BLOCKS, WARPS, _align16, _workspace, split_chunk, validate

PLANES = 2  # sign + mask
MU = packing.MU
TILE_ROWS = 4  # byte rows of a 32-k tile, the unit a warp takes
COLS = 64  # output columns of a block: 4 m16 tiles
PLANE_STRIDE = 96  # staged bytes a byte row (64 columns, padded so fragment reads hit distinct banks)
MAX_ROWS = 32  # batch rows a block owns at most: 4 n8 tiles
RING = 3  # stages of the cp.async ring
STAGE_ROWS = 64  # byte rows of a stage at most (16 tiles: two a warp)
SMEM_BUDGET = 112 * 1024  # a block's shared memory, so two fit an SM


def tc_rows(B: int) -> int:
    """Batch rows a block owns on the tensor-core path: 8, 16 or 32, the
    smallest that covers ``min(B, 32)`` (``csrc/ternary_mm.cu::tc_rows``)."""
    return next(r for r in (8, 16, MAX_ROWS) if r >= min(B, MAX_ROWS))


@dataclasses.dataclass(frozen=True)
class TCPlan:
    """The tensor-core kernel's launch shape for one (k, o, g): ``splits``
    k-chunks of ``chunk`` byte rows (whole 32-k tiles; the last chunk may be
    shorter), each cut into stages of ``stage_rows`` byte rows. A ring stage
    of ``stage_bytes`` holds the two planes' rows and, at ``off_s``, alpha
    of ``stage_groups`` groups (and 3 of margin); x is read from global
    memory. ``smem`` bytes in all. It does not depend on B, so a batch row
    sums in the same order whatever the batch."""

    k: int
    o: int
    g: int
    splits: int
    chunk: int
    stage_rows: int
    stage_bytes: int
    off_s: int
    stage_groups: int
    smem: int

    @property
    def col_tiles(self) -> int:
        return -(-self.o // COLS)

    def scratch_floats(self, B: int) -> int:
        """f32 partial sums a launch of ``B`` rows needs: one (B, o) slab a chunk."""
        return self.splits * B * self.o if self.splits > 1 else 0

    def tickets(self, B: int) -> int:
        """Arrival counters a launch of ``B`` rows needs: one a (column tile, batch tile)."""
        return self.col_tiles * -(-B // tc_rows(B)) if self.splits > 1 else 0

    def slab_rows(self, B: int) -> int:
        """Rows a launch takes: all ``B`` unless the split's scratch would
        pass ``grouptable.SCRATCH_CAP``, else the most whole blocks of 32
        rows within it."""
        if self.splits == 1:
            return B
        most = grouptable.SCRATCH_CAP // (4 * self.splits * self.o) // MAX_ROWS * MAX_ROWS
        return min(B, max(MAX_ROWS, most))

    def args(self) -> tuple:
        """The plan's fields in the order of the C entry's arguments."""
        return (self.splits, self.chunk, self.stage_rows, self.stage_bytes, self.off_s, self.stage_groups,
                self.smem)


@functools.lru_cache(maxsize=None)
def tc_plan(k: int, o: int, g: int, chunk: Optional[int] = None) -> TCPlan:
    """The tensor-core launch shape for ``x (B, k) @ W[(2, k/8, o), (1, k/g, o)]``.

    The k-split (:func:`~repro_torch.kernels._common.split_chunk` over 32-k
    tiles): none where ``col_tiles`` alone reaches two blocks an SM, else
    enough chunks that ``col_tiles * splits`` does as far as k allows, at
    least one tile a warp, with the fullest last wave; ``chunk`` (byte rows, rounded up to whole tiles) overrides it. A
    chunk is cut into the fewest stages of at most ``STAGE_ROWS`` byte rows,
    balanced in whole tiles.
    """
    kc = k // MU
    tiles = -(-kc // TILE_ROWS)
    col_tiles = -(-o // COLS)
    if chunk is None:  # no split where the column tiles alone fill the card (lm_head)
        full = col_tiles >= MIN_BLOCKS
        chunk = TILE_ROWS * (tiles if full else split_chunk(tiles, col_tiles, min_chunk=WARPS))
    chunk = min(-(-chunk // TILE_ROWS), tiles) * TILE_ROWS
    n_stages = -(-chunk // STAGE_ROWS)
    rows = -(-chunk // TILE_ROWS // n_stages) * TILE_ROWS
    sg = grouptable.stage_groups(kc, chunk, rows, g)
    off_s = _align16(2 * rows * PLANE_STRIDE)
    stage_bytes = off_s + (sg + 3) * COLS * 2  # 3 groups of margin: a short last tile reads past its rows
    smem = max(RING * stage_bytes, WARPS * MAX_ROWS * COLS * 4)  # the ring, then the warps' sums
    if smem > SMEM_BUDGET:
        raise ValueError(f"ternary_mm: a stage of {rows} byte rows needs {smem} bytes of shared memory at g={g}")
    return TCPlan(k=k, o=o, g=g, splits=-(-kc // chunk), chunk=chunk, stage_rows=rows, stage_bytes=stage_bytes,
                  off_s=off_s, stage_groups=sg, smem=smem)


@functools.lru_cache(maxsize=None)
def _tc_entry():
    lib = _build.load("ternary_mm")
    fn = lib.ternary_tc_launch
    p, i = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = [p] * 6 + [i] * 4 + [i] * 7 + [p]
    fn.restype = i
    return lib, fn


def _launch_tc(x: torch.Tensor, packed: torch.Tensor, scales: torch.Tensor, g: int) -> Tuple[torch.Tensor, int]:
    """The tensor-core kernel on validated bf16 CUDA inputs → (``(B, o)``
    f32, the launches made), on PyTorch's current stream: one launch for
    each row slab."""
    x, packed, scales = x.contiguous(), packed.contiguous(), scales.contiguous()
    if x.data_ptr() % 16:  # the kernel reads x in 16-byte pieces
        x = x.clone()
    B, k = x.shape
    o = packed.shape[-1]
    out = torch.empty((B, o), dtype=torch.float32, device=x.device)
    if B == 0:
        return out, 0
    pl = tc_plan(k, o, g)
    slab = pl.slab_rows(B)
    lib, fn = _tc_entry()
    with torch.cuda.device(x.device):
        scratch, tickets = _workspace(x.device, pl.scratch_floats(slab), pl.tickets(slab))
        stream = torch.cuda.current_stream(x.device).cuda_stream
        for b0 in range(0, B, slab):
            xs, ys = x[b0 : b0 + slab], out[b0 : b0 + slab]
            rc = fn(xs.data_ptr(), packed.data_ptr(), scales.data_ptr(), ys.data_ptr(), scratch.data_ptr(),
                    tickets.data_ptr(), xs.shape[0], k, o, g, *pl.args(), stream)
            _build.check(lib, rc, "ternary_tc launch")
    return out, -(-B // slab)


def ternary_mm_plain(x: torch.Tensor, packed: torch.Tensor, scales: torch.Tensor, *, g: int) -> torch.Tensor:
    """The plain PyTorch version: dequantize to f32 ``(2·sign − 1)·mask·alpha``,
    multiply."""
    return torch.matmul(x.to(torch.float32), ternary_dequantize(packed, scales, g))


def ternary_mm(x: torch.Tensor, packed: torch.Tensor, scales: torch.Tensor, *, g: int) -> torch.Tensor:
    """x (B, k) @ ternary[(2, k/8, o) sign+mask planes, (1, k/g, o) alpha] → (B, o) f32.

    x and scales may be f32 or bf16. A CUDA input launches a kernel (or
    raises): the tensor cores for bf16 x with bf16 scales, the group-table
    kernel otherwise; a CPU input runs :func:`ternary_mm_plain`.
    """
    if packed.dim() == 3 and packed.shape[0] != PLANES:
        raise ValueError(
            f"ternary packed tensor must carry exactly {PLANES} planes (sign + mask), "
            f"got {packed.shape[0]}"
        )
    validate(x, packed, scales, g, scale_planes=1)
    if not x.is_cuda:
        return ternary_mm_plain(x, packed, scales, g=g)
    if x.dtype == torch.bfloat16 and scales.dtype == torch.bfloat16:
        out, n = _launch_tc(x, packed, scales, g)
        ternary_mm.tc_launches += n
    else:
        out, n = grouptable.launch("ternary", x, packed, scales, g)
    ternary_mm.launches += n
    return out


ternary_mm.launches = 0
ternary_mm.tc_launches = 0  # of them, launches on the tensor-core path


def _spread4(n: torch.Tensor) -> torch.Tensor:
    """Bit j of a nibble to bit 8 j (``csrc/ternary_mm.cu::spread4``)."""
    return (n * 0x204081) & 0x01010101


def _byte_perm(z: torch.Tensor, sel: torch.Tensor) -> torch.Tensor:
    """CUDA's ``__byte_perm(z, 0, sel)``: result byte n is byte
    ``(sel >> 4n) & 7`` of ``z``'s bytes 0-3 followed by four zero bytes."""
    out = torch.zeros_like(z)
    for n in range(4):
        idx = (sel >> (4 * n)) & 7
        byte = torch.where(idx < 4, (z >> (8 * (idx & 3))) & 0xFF, torch.zeros_like(z))
        out |= byte << (8 * n)
    return out


def fragment_plain(sign: torch.Tensor, mask: torch.Tensor, alpha: torch.Tensor, *, high: bool = False,
                   other: int = 0x7FC1) -> torch.Tensor:
    """The tensor-core path's A-fragment decode in plain PyTorch, the same
    integer steps as ``csrc/ternary_mm.cu`` (``source``, ``decode_byte``):
    sign and mask bytes (uint8) and bf16 ``alpha`` of the same shape →
    ``(..., 8)`` bf16, weight j from bit j. Each is ``+alpha`` (sign and
    mask set), ``-alpha`` (mask only) or 0. The kernel reads alpha as one
    half of a bf16 pair: ``high`` puts it in the high half, and the other
    half holds the bits ``other`` (a NaN by default), which must not leak."""
    s, m = sign.to(torch.int64), mask.to(torch.int64)
    a = alpha.to(torch.bfloat16).view(torch.int16).to(torch.int64) & 0xFFFF
    pair = (a << 16) | other if high else a | (other << 16)
    sel = torch.full_like(pair, 0x3324 if high else 0x1104)
    z = _byte_perm(pair, sel) ^ 0x00800000  # (0, alpha_lo, alpha_hi ^ 0x80, alpha_hi)
    sm = s & m
    w0 = _spread4(m & 0xF) * 0x21 + (_spread4(sm & 0xF) << 4)
    w1 = _spread4(m >> 4) * 0x21 + (_spread4(sm >> 4) << 4)
    words = [_byte_perm(z, w) for w in (w0, w0 >> 16, w1, w1 >> 16)]  # bf16 pairs, low half first
    halves = torch.stack([h for w in words for h in (w & 0xFFFF, w >> 16)], dim=-1)
    return torch.where(halves >= 0x8000, halves - 0x10000, halves).to(torch.int16).view(torch.bfloat16)
