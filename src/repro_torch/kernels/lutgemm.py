"""LUT-GEMM: the paper's lookup-table quantized matmul (§III.B-C).

Replaces the TPU kernel ``src/repro/kernels/lutgemm.py::lutgemm``
(``_lutgemm_kernel``, ``_sign_patterns``). The CUDA kernel is
``csrc/lutgemm.cu``; its header note says what bounds it and how the design
answers that. In short: a block owns 128 columns (4 adjacent a lane), up to
8 batch rows and one k-chunk; the planes' bytes, scales and x stream through
a ``cp.async`` ring in shared memory; each warp builds the table of its own
8-activation chunks at one add an entry from two half tables, keeps the 128
entries of keys < 128 (the others are their negatives), laid out
``[key][row]`` so one wide read returns a key's entry for every batch row;
the k-chunks' partial sums are added in chunk order by the last block of
each column tile, in the same launch.

:func:`plan` makes the host-side choices (the k-split, each row tile's
stage size and shared memory); it does not depend on B, so a row sums in
the same order whatever the batch. :func:`lutgemm` takes the scratch and
tickets the split needs from the per-device workspace it shares with K7
(launches on one stream use it in turn; each resets its tickets) and
passes the plan to the kernel: one launch a call. It runs :func:`lutgemm_plain`, the same table
algorithm on tensors, for CPU tensors. ``lutgemm.launches`` counts kernel
launches.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
from typing import Optional, Tuple

import torch

from repro_torch.core import packing
from repro_torch.kernels import _build
from repro_torch.kernels._common import (
    DTYPE_CODES,
    MIN_BLOCKS,
    _align16,
    _workspace,
    forward_only,
    row_tile,
    validate,
    wave_fill,
)

MU = packing.MU
_PLAIN_MAX_ELEMS = 1 << 27  # bounds the plain version's gathered (rows, k/8, o) block

WARPS = 8  # warps of a block; they take the chunks of its k-range round robin
COLS = 128  # output columns of a block, 4 adjacent a lane
KEYS = 1 << (MU - 1)  # table entries kept a chunk: T[255 - key] = -T[key]
RING = 3  # stages of the cp.async ring
ROW_TILES = (1, 2, 4, 8)  # batch rows a block may own
STAGE_CHUNKS = 32  # byte rows of a ring stage, halved while over the budget
SMEM_BUDGET = 112 * 1024  # a block's shared memory, so two fit an SM (228 KB, 1 KB a block reserved)
DECODE_B = 4  # the batch at which the split's partial-sum traffic is bounded
MIN_CHUNK = WARPS  # byte rows a k-chunk takes at least


@dataclasses.dataclass(frozen=True)
class Stage:
    """Shared-memory layout at row tile ``bt``: a ring stage of ``chunks``
    byte rows is ``stage_bytes`` long (the planes' bytes, then the scales of
    every group such a window can touch at ``off_s`` and x at ``off_x``);
    the warps' tables (``KEYS x bt`` f32 each) sit at ``off_t``, after the
    ring; ``smem`` bytes in all, also enough for the warps' sums at the end."""

    bt: int
    chunks: int
    stage_bytes: int
    off_s: int
    off_x: int
    off_t: int
    smem: int


def stage_groups(chunks: int, g: int, k: int) -> int:
    """Groups a window of ``chunks`` byte rows can touch: it starts at a
    multiple of 8 rows, anywhere in a group (``csrc/lutgemm.cu``)."""
    return min(k // g, (g - MU + chunks * MU - 1) // g + 1)


def _stage(bt: int, chunks: int, q: int, g: int, k: int, xb: int, sb: int) -> Stage:
    off_s = _align16(q * chunks * COLS)
    off_x = off_s + _align16(q * stage_groups(chunks, g, k) * COLS * sb)
    stage_bytes = off_x + _align16(bt * chunks * MU * xb)
    off_t = RING * stage_bytes
    smem = max(off_t + WARPS * KEYS * bt * 4, WARPS * bt * COLS * 4)
    return Stage(bt=bt, chunks=chunks, stage_bytes=stage_bytes, off_s=off_s, off_x=off_x, off_t=off_t,
                 smem=smem)


@dataclasses.dataclass(frozen=True)
class Plan:
    """The kernel's launch shape for one (k, o, q, dtypes): ``splits``
    k-chunks of ``chunk`` byte rows (8 k each; the last may be shorter),
    and a :class:`Stage` for each row tile. Nothing in it depends on B."""

    k: int
    o: int
    splits: int
    chunk: int
    stages: Tuple[Stage, ...]

    @property
    def col_tiles(self) -> int:
        return -(-self.o // COLS)

    def stage(self, bt: int) -> Stage:
        return self.stages[ROW_TILES.index(bt)]

    def scratch_floats(self, B: int) -> int:
        """f32 partial sums the split needs: one (B, o) slab a chunk."""
        return self.splits * B * self.o if self.splits > 1 else 0

    def tickets(self, B: int) -> int:
        """Arrival counters the split needs: one a (column tile, batch tile)."""
        return self.col_tiles * -(-B // row_tile(B)) if self.splits > 1 else 0


def plane_bytes(k: int, o: int, q: int) -> int:
    return q * (k // MU) * o


def partial_bytes(splits: int, o: int, B: int = DECODE_B) -> int:
    """Bytes of partial sums a split writes to scratch and reads back."""
    return 2 * splits * B * o * 4 if splits > 1 else 0


def _split_chunk(k: int, o: int, q: int) -> int:
    """Byte rows a k-chunk: of the split counts up to 4x the least that puts
    ``MIN_BLOCKS`` blocks on the card at one batch tile, those whose partial
    sums stay under a quarter of the planes' bytes at B = 4, the one with
    the most blocks up to ``MIN_BLOCKS``, then the fullest waves, then the
    fewest blocks; chunks of at least ``MIN_CHUNK`` byte rows."""
    kc = k // MU
    col_tiles = -(-o // COLS)
    least = -(-MIN_BLOCKS // col_tiles)
    best = None
    for want in range(1, 4 * least + 1):
        chunk = min(kc, max(MIN_CHUNK, -(-kc // want)))
        splits = -(-kc // chunk)
        if 4 * partial_bytes(splits, o) >= plane_bytes(k, o, q) and splits > 1:
            continue
        blocks = col_tiles * splits
        key = (min(blocks, MIN_BLOCKS), wave_fill(blocks), -blocks)
        if best is None or key > best[0]:
            best = (key, chunk)
    return best[1]


@functools.lru_cache(maxsize=None)
def plan(k: int, o: int, q: int, g: int, x_dtype: torch.dtype, s_dtype: torch.dtype,
         chunk: Optional[int] = None) -> Plan:
    """The launch shape for ``x (B, k) @ BCQ[(q, k/8, o), (q, k/g, o)]``.

    The k-split (:func:`_split_chunk`) depends on (k, o, q) only; ``chunk``
    (byte rows) overrides it. A ring stage holds ``STAGE_CHUNKS`` byte
    rows, halved while the ring and the warps' tables exceed ``SMEM_BUDGET``.
    """
    kc = k // MU
    chunk = max(1, min(kc, chunk or _split_chunk(k, o, q)))
    xb, sb = torch.finfo(x_dtype).bits // 8, torch.finfo(s_dtype).bits // 8
    stages = []
    for bt in ROW_TILES:
        chunks = STAGE_CHUNKS
        while chunks > 1 and _stage(bt, chunks, q, g, k, xb, sb).smem > SMEM_BUDGET:
            chunks //= 2
        stages.append(_stage(bt, chunks, q, g, k, xb, sb))
    return Plan(k=k, o=o, splits=-(-kc // chunk), chunk=chunk, stages=tuple(stages))


def _sign_patterns(dtype, device) -> torch.Tensor:
    """(256, 8): patterns[key, j] = +1 if bit j (LSB-first) of key is set, else -1."""
    keys = torch.arange(1 << MU, device=device)[:, None]
    bits = (keys >> torch.arange(MU, device=device)[None, :]) & 1
    return (2 * bits - 1).to(dtype)


def lutgemm_plain(x: torch.Tensor, packed: torch.Tensor, scales: torch.Tensor, *, g: int) -> torch.Tensor:
    """The table algorithm on tensors, in f32: build ``LUT[b, c, key]``,
    retrieve by packed byte, sum g/8 chunks per group, scale, sum planes."""
    q, kc, o = packed.shape
    B = x.shape[0]
    lut = torch.matmul(
        x.to(torch.float32).reshape(B, kc, MU), _sign_patterns(torch.float32, x.device).T
    )  # (B, kc, 256)
    cpg = g // MU
    rows = torch.arange(kc, device=x.device)[:, None]
    keys = packed.long()
    out = torch.zeros((B, o), dtype=torch.float32, device=x.device)
    step = max(1, _PLAIN_MAX_ELEMS // max(1, kc * o))
    for b0 in range(0, B, step):
        for i in range(q):
            part = lut[b0 : b0 + step, rows, keys[i]]  # (rows, kc, o)
            grouped = part.reshape(part.shape[0], kc // cpg, cpg, o).sum(dim=2)
            out[b0 : b0 + step] += torch.einsum(
                "bGo,Go->bo", grouped, scales[i].to(torch.float32)
            )
    return out


@functools.lru_cache(maxsize=None)
def _entry():
    lib = _build.load("lutgemm")
    fn = lib.lutgemm_launch
    p, i = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = [p, i, p, p, i, p, p, p] + [i] * 13 + [p]
    fn.restype = i
    return lib, fn


def lutgemm(x: torch.Tensor, packed: torch.Tensor, scales: torch.Tensor, *, g: int) -> torch.Tensor:
    """Paper-faithful LUT-GEMM: x (B, k) @ BCQ weights → (B, o) f32.

    Same contract as :func:`repro_torch.kernels.bcq_mm.bcq_mm`. A CUDA input
    launches the kernel once (or raises); a CPU input runs :func:`lutgemm_plain`.
    """
    validate(x, packed, scales, g)
    if not x.is_cuda:
        return lutgemm_plain(x, packed, scales, g=g)
    forward_only("lutgemm", x, scales)
    x, packed, scales = x.contiguous(), packed.contiguous(), scales.contiguous()
    B, k = x.shape
    q, _, o = packed.shape
    out = torch.empty((B, o), dtype=torch.float32, device=x.device)
    if B == 0:
        return out
    pl = plan(k, o, q, g, x.dtype, scales.dtype)
    st = pl.stage(row_tile(B))
    lib, fn = _entry()
    with torch.cuda.device(x.device):
        scratch, tickets = _workspace(x.device, pl.scratch_floats(B), pl.tickets(B))
        rc = fn(
            x.data_ptr(), DTYPE_CODES[x.dtype], packed.data_ptr(), scales.data_ptr(),
            DTYPE_CODES[scales.dtype], out.data_ptr(), scratch.data_ptr(), tickets.data_ptr(),
            B, k, o, q, g, pl.splits, pl.chunk, st.chunks, st.stage_bytes, st.off_s, st.off_x, st.off_t,
            st.smem, torch.cuda.current_stream(x.device).cuda_stream,
        )
    _build.check(lib, rc, "lutgemm launch")
    lutgemm.launches += 1
    return out


lutgemm.launches = 0
