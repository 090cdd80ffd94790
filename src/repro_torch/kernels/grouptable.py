"""The group-table kernels' host side: K1/K2 ``bcq_mm``, K5 ``uniform_mm``
and the CUDA-core path of K4 ``ternary_mm`` (f32 x or f32 alpha).

Each is ``csrc/grouptable.cuh`` with a format's way of making the ``2^q``
weights that a (group, column) pair can take (``csrc/bcq_mm.cu``,
``csrc/uniform_mm.cu``, ``csrc/ternary_mm.cu``); the skeleton's header
note says what bounds them and how the design answers that. In short: a block owns 128 columns (32 for
a table above q = 5), up to 8 batch rows and one k-chunk; planes, the
stage's scales and x stream through a ``cp.async`` ring; the next stage's
tables are built in shared memory from its scales while the current one is
looked up by code; the k-chunks' partial sums are added in chunk order by
the last block of each column tile, in the same launch.

:func:`plan` makes the host-side choices (the table or the direct path,
columns a lane, the k-split, the stage size and shared memory); nothing in
it depends on B. :func:`launch` takes the split's scratch and tickets from
the per-device workspace that K3 and K7 also use, and launches over row
slabs that keep the scratch within ``SCRATCH_CAP``; a row's sum does not
depend on its slab. :func:`table_plain` and :func:`weights_plain` are the
table build in plain PyTorch, for the tests.
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
    MAX_BT,
    WARPS,
    _align16,
    _workspace,
    row_tile,
    split_chunk,
)

MU = packing.MU
RING = 3  # stages of the cp.async ring
STAGE_ROWS = 32  # byte rows of a stage, halved while the block's shared memory is over budget
SMEM_BUDGET = 112 * 1024  # a block's shared memory, so two fit an SM (228 KB, 1 KB a block reserved)
MAX_SMEM = 232448  # dynamic shared memory a block may opt in to
SCRATCH_CAP = 64 * 2**20  # bytes of partial sums a launch may write; wider calls go in row slabs
NS_TABLE_MAX_Q = 5  # above it a table of 4 columns a lane is too large: 1 column a lane
# The largest q that takes the table path, by format; above it each weight
# is made from its code in registers. Measured at llama3.2-3b's wo, B = 4,
# bf16 (chip_smoke.py's table_limit; PERF.md): BCQ's table wins up to q = 5
# (its direct fold costs ~3 operations a plane), uniform's at q = 4 only
# (its direct weight is one conversion, a product and a sum). Ternary
# stores q = 2 planes (sign, mask) whatever its policy says; its table of
# {0, 0, -alpha, +alpha} and its direct select came within 2% of each
# other (the same measurement at f32 x), and it keeps the table.
TABLE_MAX_Q = {"bcq": 5, "uniform": 4, "ternary": 2}
# The format's scale planes: q, 2 (scale, zero) or 1 (alpha).
SCALE_PLANES = {"bcq": None, "uniform": 2, "ternary": 1}


def stage_groups(kc: int, chunk: int, rows: int, g: int) -> int:
    """Groups of g rows that one stage touches at most, over the stages of
    ``rows`` byte rows into which every k-chunk of ``chunk`` byte rows is
    cut (``csrc/grouptable.cuh::stage_groups``)."""
    return max(
        (min(c0 + chunk, kc, r0 + rows) * MU - 1) // g - r0 * MU // g + 1
        for c0 in range(0, kc, chunk) for r0 in range(c0, min(c0 + chunk, kc), rows)
    )


@dataclasses.dataclass(frozen=True)
class Plan:
    """The kernel's launch shape for one (format, k, o, q, g, dtypes):
    ``table`` or the direct path, ``ns`` columns a lane (a block owns
    ``32 ns``), ``splits`` k-chunks of ``chunk`` byte rows (8 k each; the
    last may be shorter), each cut into stages of ``stage_rows`` byte rows
    (the last may be shorter). A ring stage of ``stage_bytes`` holds the planes' bytes, the
    scales of ``stage_groups`` groups at ``off_s`` and x at ``off_x``; two
    table buffers of ``table_bytes`` follow the ring at ``off_t``; ``smem``
    bytes in all. It does not depend on B, so a batch row sums in the same
    order whatever the batch."""

    kind: str
    k: int
    o: int
    q: int
    table: bool
    ns: int
    splits: int
    chunk: int
    stage_rows: int
    stage_bytes: int
    off_s: int
    off_x: int
    stage_groups: int
    off_t: int
    table_bytes: int
    smem: int

    @property
    def cols(self) -> int:
        return 32 * self.ns

    @property
    def col_tiles(self) -> int:
        return -(-self.o // self.cols)

    def scratch_floats(self, B: int) -> int:
        """f32 partial sums a launch of ``B`` rows needs: one (B, o) slab a chunk."""
        return self.splits * B * self.o if self.splits > 1 else 0

    def tickets(self, B: int) -> int:
        """Arrival counters a launch of ``B`` rows needs: one a (column tile, batch tile)."""
        return self.col_tiles * -(-B // row_tile(B)) if self.splits > 1 else 0

    def slab_rows(self, B: int) -> int:
        """Rows a launch takes: all ``B`` unless the split's scratch would
        pass ``SCRATCH_CAP``, else the most whole row tiles of 8 within it."""
        if self.splits == 1:
            return B
        most = SCRATCH_CAP // (4 * self.splits * self.o) // MAX_BT * MAX_BT
        return min(B, max(MAX_BT, most))

    def args(self) -> tuple:
        """The plan's fields in the order of the C entry's arguments."""
        return (int(self.table), self.ns, self.splits, self.chunk, self.stage_rows, self.stage_bytes,
                self.off_s, self.off_x, self.stage_groups, self.off_t, self.table_bytes, self.smem)


def _layout(rows: int, chunk: int, q: int, S: int, g: int, k: int, cols: int, xb: int, sb: int,
            table: bool) -> dict:
    sg = stage_groups(k // MU, chunk, rows, g)
    off_s = _align16(q * rows * cols)
    off_x = off_s + _align16(S * sg * cols * sb)
    stage_bytes = off_x + _align16(MAX_BT * rows * MU * xb)
    off_t = RING * stage_bytes
    table_bytes = _align16(sg * (1 << q) * cols * 4) if table else 0
    smem = max(off_t + 2 * table_bytes, WARPS * MAX_BT * cols * 4)  # the ring and tables, then the warps' sums
    return dict(stage_rows=rows, stage_bytes=stage_bytes, off_s=off_s, off_x=off_x, stage_groups=sg,
                off_t=off_t, table_bytes=table_bytes, smem=smem)


@functools.lru_cache(maxsize=None)
def plan(kind: str, k: int, o: int, q: int, g: int, x_dtype: torch.dtype, s_dtype: torch.dtype,
         chunk: Optional[int] = None, table: Optional[bool] = None) -> Plan:
    """The launch shape for ``x (B, k) @ W[(q, k/8, o) planes, (S, k/g, o) scales]``
    of format ``kind`` (``"bcq"``: S = q; ``"uniform"``: S = 2; ``"ternary"``:
    q = 2, S = 1).

    The path: the table up to ``TABLE_MAX_Q[kind]`` (``table`` overrides),
    with 32 columns a block above ``NS_TABLE_MAX_Q``. The k-split
    (:func:`~repro_torch.kernels._common.split_chunk`): enough chunks that
    ``col_tiles * splits >= MIN_BLOCKS`` as far as k allows, with the
    fullest last wave; ``chunk`` (byte rows) overrides it. A chunk is cut
    into the fewest stages of at most ``STAGE_ROWS`` byte rows, balanced
    (35 rows: 18 and 17); that limit halves while the block's shared
    memory is over ``SMEM_BUDGET``.
    """
    S = SCALE_PLANES[kind] or q
    table = q <= TABLE_MAX_Q[kind] if table is None else bool(table)
    ns = 1 if table and q > NS_TABLE_MAX_Q else 4
    cols = 32 * ns
    kc = k // MU
    chunk = max(1, min(kc, chunk or split_chunk(kc, -(-o // cols))))
    xb, sb = torch.finfo(x_dtype).bits // 8, torch.finfo(s_dtype).bits // 8
    most = STAGE_ROWS
    while True:  # the fewest stages of at most `most` rows, balanced
        rows = -(-chunk // -(-chunk // most))
        lay = _layout(rows, chunk, q, S, g, k, cols, xb, sb, table)
        if most == 1 or lay["smem"] <= SMEM_BUDGET:
            break
        most //= 2
    if lay["smem"] > MAX_SMEM:
        raise ValueError(f"{kind}: no stage fits shared memory at q={q}, g={g} ({lay['smem']} bytes)")
    return Plan(kind=kind, k=k, o=o, q=q, table=table, ns=ns, splits=-(-kc // chunk), chunk=chunk, **lay)


@functools.lru_cache(maxsize=None)
def _entry(kind: str):
    name = f"{kind}_mm"  # csrc/bcq_mm.cu, csrc/uniform_mm.cu, csrc/ternary_mm.cu
    lib = _build.load(name)
    fn = getattr(lib, f"{name}_launch")
    p, i = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = [p, i, p, p, i, p, p, p] + [i] * 17 + [p]
    fn.restype = i
    return lib, fn


def launch(kind: str, x: torch.Tensor, packed: torch.Tensor, scales: torch.Tensor,
           g: int) -> Tuple[torch.Tensor, int]:
    """``csrc/<kind>_mm.cu`` on validated CUDA inputs → (``(B, o)`` f32, the
    launches made), on PyTorch's current stream: one launch for each row
    slab (:meth:`Plan.slab_rows`), one for the whole call at decode widths.
    Counts nothing itself; the public wrappers add the launches it returns."""
    x, packed, scales = x.contiguous(), packed.contiguous(), scales.contiguous()
    B, k = x.shape
    q, _, o = packed.shape
    out = torch.empty((B, o), dtype=torch.float32, device=x.device)
    if B == 0:
        return out, 0
    pl = plan(kind, k, o, q, g, x.dtype, scales.dtype)
    slab = pl.slab_rows(B)
    lib, fn = _entry(kind)
    with torch.cuda.device(x.device):
        scratch, tickets = _workspace(x.device, pl.scratch_floats(slab), pl.tickets(slab))
        stream = torch.cuda.current_stream(x.device).cuda_stream
        for b0 in range(0, B, slab):
            xs, ys = x[b0 : b0 + slab], out[b0 : b0 + slab]
            rc = fn(
                xs.data_ptr(), DTYPE_CODES[x.dtype], packed.data_ptr(), scales.data_ptr(),
                DTYPE_CODES[scales.dtype], ys.data_ptr(), scratch.data_ptr(), tickets.data_ptr(),
                xs.shape[0], k, o, q, g, *pl.args(), stream,
            )
            _build.check(lib, rc, f"{kind}_mm launch")
    return out, -(-B // slab)


def table_plain(kind: str, scales: torch.Tensor, q: int) -> torch.Tensor:
    """The ``(2^q, k/g, o)`` f32 table of the weights each (group, column)
    can take, made as the kernels make it: BCQ entry ``e`` folds
    ``±alpha_i`` over the planes in order (bit i of e set: +), level i
    doubling level i - 1; uniform entry ``c`` is ``c·s + z``, product and
    sum rounded apart; ternary entry ``sign | mask << 1`` is ``{0, 0,
    -alpha, +alpha}``."""
    s = scales.to(torch.float32)
    if kind == "ternary":
        zero = torch.zeros_like(s[0])
        return torch.stack([zero, zero, -s[0], s[0]])
    if kind == "bcq":
        t = torch.stack([-s[0], s[0]])
        for i in range(1, q):
            t = torch.cat([t - s[i], t + s[i]])
        return t
    codes = torch.arange(1 << q, dtype=torch.float32, device=s.device)[:, None, None]
    return codes * s[0] + s[1]


def weights_plain(kind: str, packed: torch.Tensor, scales: torch.Tensor, g: int) -> torch.Tensor:
    """The ``(k, o)`` f32 weights looked up in :func:`table_plain` by each
    weight's code: ``w[r, c] = T[code[r, c], r // g, c]``."""
    q, kc, o = packed.shape
    table = table_plain(kind, scales, q)
    codes = packing.unpack_codes(packed).long()  # (k, o)
    group = (torch.arange(kc * MU, device=packed.device) // g)[:, None].expand(-1, o)
    return table.permute(1, 2, 0)[group, torch.arange(o, device=packed.device)[None, :], codes]
