"""Arbitrary-codebook matmul consumed in packed form: ``w[r, c] = T[idx[r, c], r // g, c]``.

Replaces the TPU kernel ``src/repro/kernels/codebook_mm.py::codebook_mm``
(``codebook_mm_call``, ``_codebook_mm_kernel``, ``_unpack_indices_block``).
The CUDA kernel is ``csrc/codebook_mm.cu``; its header note says what
bounds it and how the design answers that. In short: a block owns 128
columns (32 at q > 5) and one k-chunk; the planes' bytes, the chunk's slice
of the ``(2^q, k/g, o)`` centroid table and the x rows stream through a
``cp.async`` ring in shared memory, where every lane's lookup lands in its
own bank; the q-bit indices are spread from the plane bytes 8 at a time;
the k-chunks' partial sums are added in chunk order by the last block of
each column tile, in the same launch.

:func:`plan` makes the host-side choices (columns a lane, the k-split,
the ring's stage size); :func:`codebook_mm` allocates the scratch and
tickets the split needs once per device and passes the plan to the kernel.
The table must carry ``2^q`` centroids; anything else is refused.
:func:`codebook_mm` launches the kernel for CUDA tensors and runs
:func:`codebook_mm_plain` for CPU tensors. ``codebook_mm.launches`` counts
kernel launches.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
from typing import Optional

import torch

from repro_torch.core.formats import codebook_dequantize
from repro_torch.kernels import _build
from repro_torch.kernels._common import (  # noqa: F401  (MIN_BLOCKS, wave_fill: read beside the plan)
    DTYPE_CODES,
    MAX_BT,
    MIN_BLOCKS,
    WARPS,
    _align16,
    _workspace,
    forward_only,
    row_tile,
    split_chunk,
    validate,
    wave_fill,
)

RING = 3  # stages of the cp.async ring
STAGE_BUDGET = 32 * 1024  # bytes of one stage: 3 stages leave room for 2 blocks an SM
MAX_SMEM = 232448  # dynamic shared memory a block may opt in to


@dataclasses.dataclass(frozen=True)
class Plan:
    """The kernel's launch shape for one (k, o, q, g, dtypes): ``ns``
    columns a lane (a block owns ``32 ns``), ``splits`` k-chunks of
    ``chunk`` byte rows (8 k each; the last may be shorter), and a ring of
    ``RING`` stages of ``stage_rows`` byte rows, each ``stage_bytes`` long
    with x at ``off_x`` and the table at ``off_t``; ``smem`` bytes in all.
    It does not depend on B, so a batch row sums in the same order whatever
    the batch."""

    k: int
    o: int
    ns: int
    splits: int
    chunk: int
    stage_rows: int
    stage_bytes: int
    off_x: int
    off_t: int
    smem: int

    @property
    def cols(self) -> int:
        return 32 * self.ns

    @property
    def col_tiles(self) -> int:
        return -(-self.o // self.cols)

    def scratch_floats(self, B: int) -> int:
        """f32 partial sums the split needs: one (B, o) slab a chunk."""
        return self.splits * B * self.o if self.splits > 1 else 0

    def tickets(self, B: int) -> int:
        """Arrival counters the split needs: one a (column tile, batch tile)."""
        return self.col_tiles * -(-B // row_tile(B)) if self.splits > 1 else 0


def _stage_layout(rows: int, q: int, g: int, k: int, cols: int, xb: int, tb: int):
    """(off_x, off_t, stage bytes) of a stage of ``rows`` byte rows: the q
    planes' bytes, MAX_BT x rows, then the table of every group such a
    window can touch (it starts at a multiple of 8 k, anywhere in a group)."""
    span = rows * 8
    groups = min(k // g, (g - 8 + span - 1) // g + 1)
    planes = _align16(q * rows * cols)
    xs = _align16(MAX_BT * span * xb)
    table = _align16(groups * (1 << q) * cols * tb)
    return planes, planes + xs, planes + xs + table


def plan(k: int, o: int, q: int, g: int, x_dtype: torch.dtype, t_dtype: torch.dtype,
         chunk: Optional[int] = None) -> Plan:
    """The launch shape for ``x (B, k) @ codebook[(q, k/8, o), (2^q, k/g, o)]``.

    The k-split (:func:`~repro_torch.kernels._common.split_chunk`): enough chunks that
    ``col_tiles * splits >= MIN_BLOCKS`` as far as k allows, with the
    fullest last wave; ``chunk`` (byte rows) overrides it. Stages hold 32 byte rows, fewer
    where that leaves a chunk under 4 stages or a stage over
    ``STAGE_BUDGET``.
    """
    kc = k // 8
    ns = 4 if q <= 5 else 1
    cols = 32 * ns
    col_tiles = -(-o // cols)
    if chunk is None:
        chunk = split_chunk(kc, col_tiles)
    chunk = max(1, min(chunk, kc))
    splits = -(-kc // chunk)
    xb = torch.finfo(x_dtype).bits // 8
    tb = torch.finfo(t_dtype).bits // 8
    rows = 32
    while rows > WARPS and -(-chunk // rows) < 4:
        rows //= 2
    rows = min(rows, chunk)
    while rows > 1 and _stage_layout(rows, q, g, k, cols, xb, tb)[2] > STAGE_BUDGET:
        rows //= 2
    off_x, off_t, stage_bytes = _stage_layout(rows, q, g, k, cols, xb, tb)
    smem = max(RING * stage_bytes, WARPS * MAX_BT * cols * 4)  # the ring, then the warps' sums
    if smem > MAX_SMEM:
        raise ValueError(f"codebook_mm: no stage fits shared memory at q={q}, g={g} ({smem} bytes)")
    return Plan(k=k, o=o, ns=ns, splits=splits, chunk=chunk, stage_rows=rows, stage_bytes=stage_bytes,
                off_x=off_x, off_t=off_t, smem=smem)


def codebook_mm_plain(x: torch.Tensor, packed: torch.Tensor, scales: torch.Tensor, *, g: int) -> torch.Tensor:
    """The plain PyTorch version: gather the f32 centroids by index, multiply."""
    return torch.matmul(x.to(torch.float32), codebook_dequantize(packed, scales, g))


@functools.lru_cache(maxsize=None)
def _entry():
    lib = _build.load("codebook_mm")
    fn = lib.codebook_mm_launch
    p, i = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = [p, i, p, p, i, p, p, p] + [i] * 13 + [p]
    fn.restype = i
    return lib, fn


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
    forward_only("codebook_mm", x, scales)
    x, packed, scales = x.contiguous(), packed.contiguous(), scales.contiguous()
    B, k = x.shape
    q, _, o = packed.shape
    out = torch.empty((B, o), dtype=torch.float32, device=x.device)
    if B == 0:
        return out
    pl = plan(k, o, q, g, x.dtype, scales.dtype)
    lib, fn = _entry()
    with torch.cuda.device(x.device):
        scratch, tickets = _workspace(x.device, pl.scratch_floats(B), pl.tickets(B))
        rc = fn(
            x.data_ptr(), DTYPE_CODES[x.dtype], packed.data_ptr(), scales.data_ptr(),
            DTYPE_CODES[scales.dtype], out.data_ptr(), scratch.data_ptr(), tickets.data_ptr(),
            B, k, o, q, g, pl.ns, pl.splits, pl.chunk, pl.stage_rows, pl.stage_bytes, pl.off_x,
            pl.off_t, pl.smem, torch.cuda.current_stream(x.device).cuda_stream,
        )
    _build.check(lib, rc, "codebook_mm launch")
    codebook_mm.launches += 1
    return out


codebook_mm.launches = 0
