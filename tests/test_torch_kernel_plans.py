"""The kernel wrappers' host-side choices, as plain Python: K7
``codebook_mm``'s launch plan (columns a lane, the k-split, the ring's
stages, scratch and tickets), K3 ``lutgemm``'s (the k-split, each row
tile's stage and shared memory, scratch and tickets), the group-table plan
of K1/K2 ``bcq_mm`` and K5 ``uniform_mm`` (the table or direct path, the
k-split, stages, tables, row slabs), K8 ``flash_attention``'s choice of kernel
by dtype and its TMA alignment check, and the rings of the scans K10
``mlstm_scan`` and K9 ``rglru_scan`` (tiles, stages, shared memory, the
in-kernel path for misaligned rows). None of this needs a GPU; the
kernels themselves are held to their plain versions on the card
(``tests/test_torch_cuda.py``, ``chip_smoke.py``)."""

import importlib
import inspect
import math
from pathlib import Path

import pytest
import torch

from repro_torch.kernels import flash_attn as fa

# the modules (the package re-exports their functions under the same names)
cm = importlib.import_module("repro_torch.kernels.codebook_mm")
lm = importlib.import_module("repro_torch.kernels.lutgemm")
gt = importlib.import_module("repro_torch.kernels.grouptable")
common = importlib.import_module("repro_torch.kernels._common")

LEAVES = {  # llama3.2-3b: (k, o)
    "wqkv": (3072, 5120),
    "wo": (3072, 3072),
    "w_gate_up": (3072, 16384),
    "w_down": (8192, 3072),
    "lm_head": (3072, 128256),
}
SWEEP = [  # (k, o, q, g): the reference's kernel sweep, then ragged o and large q
    (512, 256, 2, 64),
    (512, 128, 4, 512),
    (1024, 256, 3, 128),
    (512, 384, 1, 8),
    (1024, 128, 5, 1024),
    (2048, 256, 2, 2048),
    (768, 100, 6, 96),
    (768, 130, 7, 8),
    (768, 130, 8, 8),
    (1024, 4096, 8, 128),
]
DTYPES = [torch.bfloat16, torch.float32]


def blocks(p, B):
    """Blocks of the kernel's grid: column tiles x batch tiles x k-chunks."""
    return p.col_tiles * -(-B // cm.row_tile(B)) * p.splits


def chunks(p):
    """The byte-row ranges ``[start, end)`` of the plan's k-chunks, in order."""
    kc = p.k // 8
    return [(i * p.chunk, min(kc, (i + 1) * p.chunk)) for i in range(p.splits)]


def check_plan(p, k, o, q, g, x_dtype, t_dtype):
    xb, tb = torch.finfo(x_dtype).bits // 8, torch.finfo(t_dtype).bits // 8
    kc = k // 8
    chunks_ = chunks(p)
    # the chunks cover k exactly once, in order
    assert chunks_[0][0] == 0 and chunks_[-1][1] == kc
    assert all(a[1] == b[0] for a, b in zip(chunks_, chunks_[1:]))
    assert all(lo < hi for lo, hi in chunks_)
    assert p.ns == (4 if q <= 5 else 1) and p.cols == 32 * p.ns
    assert p.col_tiles * p.cols >= o > (p.col_tiles - 1) * p.cols
    # the stage's regions are 16-byte aligned and in order
    assert 0 < p.off_x < p.off_t < p.stage_bytes
    assert p.off_x % 16 == p.off_t % 16 == p.stage_bytes % 16 == 0
    assert p.off_x >= q * p.stage_rows * p.cols  # the planes' bytes
    assert p.off_t - p.off_x >= cm.MAX_BT * p.stage_rows * 8 * xb
    # the table region holds every group a stage's window can touch
    spanned = max(
        (min(kc, r0 + p.stage_rows) * 8 - 1) // g - r0 * 8 // g + 1
        for lo, hi in chunks_ for r0 in range(lo, hi, p.stage_rows)
    )
    assert p.stage_bytes - p.off_t >= spanned * (1 << q) * p.cols * tb
    # the ring and, after it, the warps' partial sums fit the opt-in limit
    assert cm.RING * p.stage_bytes <= p.smem <= cm.MAX_SMEM
    assert p.smem >= cm.WARPS * cm.MAX_BT * p.cols * 4


@pytest.mark.parametrize("dtype", DTYPES, ids=["bf16", "f32"])
@pytest.mark.parametrize("leaf", list(LEAVES))
def test_codebook_plan_fills_the_card_at_llama_leaves(leaf, dtype):
    """Every llama3.2-3b leaf puts at least two blocks on each of 132 SMs
    at decode widths, with a row a warp in every chunk and full waves."""
    k, o = LEAVES[leaf]
    p = cm.plan(k, o, 4, 128, dtype, dtype)
    check_plan(p, k, o, 4, 128, dtype, dtype)
    for B in (1, 4, 64):
        assert blocks(p, B) >= cm.MIN_BLOCKS
    for B in (1, 4):  # decode: no SM idles long at the end of the grid
        assert cm.wave_fill(blocks(p, B)) >= 0.9
    assert p.chunk >= cm.WARPS
    assert p.stage_bytes <= cm.STAGE_BUDGET
    assert math.ceil(p.chunk / p.stage_rows) >= 4 or p.stage_rows == 32


@pytest.mark.parametrize("dtype", DTYPES, ids=["bf16", "f32"])
@pytest.mark.parametrize("k,o,q,g", SWEEP)
def test_codebook_plan_sweep(k, o, q, g, dtype):
    """Chunks cover k once; the split reaches two blocks an SM unless k is
    too short for chunks of 8 byte rows."""
    p = cm.plan(k, o, q, g, dtype, dtype)
    check_plan(p, k, o, q, g, dtype, dtype)
    kc = k // 8
    assert blocks(p, 1) >= cm.MIN_BLOCKS or p.chunk == min(cm.WARPS, kc)


@pytest.mark.parametrize("chunk", [1, 3, 20, 24, 40, 10_000])
def test_codebook_plan_chunk_override(chunk):
    """A chunk given by the caller: boundaries inside a group (24 byte rows
    = 192 k at g = 128) or on one (32), a short last chunk, a chunk past k."""
    k, o, q, g = 1024, 130, 4, 128
    p = cm.plan(k, o, q, g, torch.bfloat16, torch.float32, chunk=chunk)
    check_plan(p, k, o, q, g, torch.bfloat16, torch.float32)
    kc = k // 8
    assert p.chunk == min(chunk, kc) and p.splits == -(-kc // p.chunk)


def test_codebook_plan_does_not_depend_on_batch():
    """One plan serves every B; only the batch tiles, scratch and tickets
    scale with it."""
    p = cm.plan(3072, 3072, 4, 128, torch.bfloat16, torch.bfloat16)
    assert p.splits > 1
    for B, bt in ((1, 1), (2, 2), (3, 4), (4, 4), (5, 8), (9, 8), (64, 8)):
        assert cm.row_tile(B) == bt
        tiles = p.col_tiles * -(-B // bt)
        assert blocks(p, B) == tiles * p.splits
        assert p.tickets(B) == tiles
        assert p.scratch_floats(B) == p.splits * B * 3072
    one = cm.plan(3072, 128256, 4, 128, torch.bfloat16, torch.bfloat16)
    assert one.splits == 1 and one.scratch_floats(4) == 0 and one.tickets(4) == 0


def test_codebook_plan_refuses_what_does_not_fit(monkeypatch):
    # q = 8 tables at g = 8 with f32 entries: stages shrink to one byte row
    p = cm.plan(768, 130, 8, 8, torch.float32, torch.float32)
    assert p.stage_rows == 1 and p.smem <= cm.MAX_SMEM
    monkeypatch.setattr(cm, "MAX_SMEM", p.smem - 16)
    with pytest.raises(ValueError, match="shared memory"):
        cm.plan(768, 130, 8, 8, torch.float32, torch.float32)


@pytest.mark.parametrize(
    "dtype,kernel",
    [(torch.bfloat16, "tensor_cores"), (torch.float32, "cuda_cores")],
    ids=["bf16", "f32"],
)
def test_flash_kernel_for_dtype(dtype, kernel):
    assert fa.kernel_for(dtype) == kernel


def test_flash_kernel_for_refuses_other_dtypes():
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        fa.kernel_for(torch.float16)


def fused_views(B, S, H, Hkv, Dh, extra=0, dtype=torch.bfloat16):
    """q, k, v as the model passes them: views of one fused projection
    output (B, S, (H + 2 Hkv) Dh + extra)."""
    qkv = torch.zeros((B, S, (H + 2 * Hkv) * Dh + extra), dtype=dtype)
    q, k, v = qkv[..., : H * Dh], qkv[..., H * Dh : (H + Hkv) * Dh], qkv[..., (H + Hkv) * Dh : (H + 2 * Hkv) * Dh]
    return q.reshape(B, S, H, Dh), k.reshape(B, S, Hkv, Dh), v.reshape(B, S, Hkv, Dh)


@pytest.mark.parametrize("Dh", [16, 32, 64, 128])
def test_tma_ready_takes_the_models_fused_views(Dh):
    for t in fused_views(2, 5, 6, 2, Dh):
        assert fa.tma_ready(t)
    assert fa.tma_ready(torch.zeros((3, 7, 4, Dh), dtype=torch.bfloat16))


def test_tma_ready_refuses_misaligned_views():
    base = torch.zeros((1, 5, 2 * 64 + 8), dtype=torch.bfloat16)
    offset = base[..., 1 : 1 + 128].reshape(1, 5, 2, 64)  # base 2 bytes off
    assert offset.data_ptr() % 16 and not fa.tma_ready(offset)
    # a row stride of (3 Dh + 4) bf16 = 392 bytes at Dh 64 is no multiple of 16
    _, k, _ = fused_views(2, 5, 1, 1, 64, extra=4)
    assert not fa.tma_ready(k)
    # ... unless that dim has size 1 (its stride is never used)
    _, k1, _ = fused_views(1, 1, 1, 1, 64, extra=4)
    assert fa.tma_ready(k1)
    # the head dim must be contiguous
    assert not fa.tma_ready(torch.zeros((1, 5, 2, 64), dtype=torch.bfloat16).transpose(2, 3))


def test_kernel_input_copies_only_what_tma_cannot_read():
    fa.flash_attention.copies = 0
    q, k, v = fused_views(2, 5, 6, 2, 64)
    assert all(fa._kernel_input(t) is t for t in (q, k, v))
    assert fa.flash_attention.copies == 0
    base = torch.arange(5 * 136, dtype=torch.float32).to(torch.bfloat16).reshape(1, 5, 136)
    bad = base[..., 1:129].reshape(1, 5, 2, 64)
    got = fa._kernel_input(bad)
    assert got is not bad and fa.tma_ready(got) and torch.equal(got, bad)
    assert fa.flash_attention.copies == 1
    # f32 goes to the CUDA-core kernel, which reads any stride: no copy
    f32 = base.float()[..., 1:129].reshape(1, 5, 2, 64)
    assert fa._kernel_input(f32) is f32 and fa.flash_attention.copies == 1
    fa.flash_attention.copies = 0


# ---- K3 lutgemm ----------------------------------------------------------

LUT_SPLITS = {  # llama3.2-3b leaf at q = 4: (k-chunks, byte rows a chunk)
    "wqkv": (11, 35),
    "wo": (11, 35),
    "w_gate_up": (4, 96),
    "w_down": (11, 94),
    "lm_head": (1, 384),
}
SM_SHARED = 228 * 1024  # shared memory of an H100 SM; each block also reserves 1 KB


def lut_chunks(p):
    kc = p.k // 8
    return [(i * p.chunk, min(kc, (i + 1) * p.chunk)) for i in range(p.splits)]


def check_lut_plan(p, k, o, q, g, x_dtype, s_dtype, own_split=True):
    xb, sb = torch.finfo(x_dtype).bits // 8, torch.finfo(s_dtype).bits // 8
    kc = k // 8
    # the chunks cover k exactly once, in order, each a whole number of 8-row chunks
    ch = lut_chunks(p)
    assert ch[0][0] == 0 and ch[-1][1] == kc
    assert all(a[1] == b[0] for a, b in zip(ch, ch[1:]))
    assert all(lo < hi for lo, hi in ch)
    assert p.col_tiles * lm.COLS >= o > (p.col_tiles - 1) * lm.COLS
    # a stage for every row tile, its regions 16-byte aligned and in order,
    # within the budget that lets two blocks share an SM
    assert tuple(st.bt for st in p.stages) == lm.ROW_TILES
    for st in p.stages:
        assert st.chunks >= 1
        assert st.stage_bytes % 16 == st.off_s % 16 == st.off_x % 16 == st.off_t % 16 == 0
        assert st.off_s >= q * st.chunks * lm.COLS  # the planes' bytes
        # the scales of every group a stage's window touches
        spanned = max(
            (min(hi, r0 + st.chunks) * 8 - 1) // g - r0 * 8 // g + 1
            for lo, hi in ch for r0 in range(lo, hi, st.chunks)
        )
        assert spanned <= lm.stage_groups(st.chunks, g, k)
        assert st.off_x >= st.off_s + q * lm.stage_groups(st.chunks, g, k) * lm.COLS * sb
        assert st.stage_bytes >= st.off_x + st.bt * st.chunks * 8 * xb  # the x rows
        assert st.off_t >= lm.RING * st.stage_bytes
        assert st.smem >= st.off_t + lm.WARPS * lm.KEYS * st.bt * 4  # a [key][row] f32 table a warp
        assert st.smem >= lm.WARPS * st.bt * lm.COLS * 4  # the warps' sums
        assert st.smem <= lm.SMEM_BUDGET and 2 * (st.smem + 1024) <= SM_SHARED
        assert st.chunks <= lm.STAGE_CHUNKS
    # the split's partial sums stay under a quarter of the planes' bytes at B = 4
    assert not own_split or p.splits == 1 or 4 * (2 * p.splits * 4 * o * 4) < q * kc * o


@pytest.mark.parametrize("dtype", DTYPES, ids=["bf16", "f32"])
@pytest.mark.parametrize("leaf", list(LEAVES))
def test_lutgemm_plan_fills_the_card_at_llama_leaves(leaf, dtype):
    """Every llama3.2-3b leaf puts at least two blocks on each of 132 SMs
    at decode widths, within the traffic and shared-memory budgets."""
    k, o = LEAVES[leaf]
    p = lm.plan(k, o, 4, 128, dtype, dtype)
    check_lut_plan(p, k, o, 4, 128, dtype, dtype)
    assert (p.splits, p.chunk) == LUT_SPLITS[leaf]
    for B in (1, 4, 64):
        assert blocks(p, B) >= lm.MIN_BLOCKS
    for B in (1, 4):
        assert lm.wave_fill(blocks(p, B)) >= 0.8
    assert lm.KEYS == 128  # the sign symmetry halves every table


@pytest.mark.parametrize("dtype", DTYPES, ids=["bf16", "f32"])
@pytest.mark.parametrize("k,o,q,g", SWEEP)
def test_lutgemm_plan_sweep(k, o, q, g, dtype):
    """Chunks cover k once; the split reaches two blocks an SM unless the
    partial-sum traffic or chunks of 8 byte rows stop it first."""
    p = lm.plan(k, o, q, g, dtype, dtype)
    check_lut_plan(p, k, o, q, g, dtype, dtype)
    more = p.splits + 1
    capped = 4 * (2 * more * 4 * o * 4) >= q * (k // 8) * o or p.chunk <= lm.MIN_CHUNK
    assert blocks(p, 1) >= lm.MIN_BLOCKS or capped


@pytest.mark.parametrize("chunk", [1, 3, 16, 20, 24, 10_000])
def test_lutgemm_plan_chunk_override(chunk):
    """A chunk given by the caller: boundaries inside a group (3, 20 and 24
    byte rows at g = 128) or on one (16), a short last chunk, a chunk past k."""
    k, o, q = 1024, 130, 4
    p = lm.plan(k, o, q, 128, torch.bfloat16, torch.float32, chunk=chunk)
    check_lut_plan(p, k, o, q, 128, torch.bfloat16, torch.float32, own_split=False)
    kc = k // 8
    assert p.chunk == min(chunk, kc) and p.splits == -(-kc // p.chunk)
    ch = lut_chunks(p)
    assert ch[0][0] == 0 and ch[-1][1] == kc and all(a[1] == b[0] for a, b in zip(ch, ch[1:]))


def test_lutgemm_plan_does_not_depend_on_batch():
    """The plan takes no B: one split and one set of stages serve every
    batch; only the batch tiles, scratch and tickets scale with it."""
    assert "B" not in inspect.signature(lm.plan).parameters
    p = lm.plan(3072, 3072, 4, 128, torch.bfloat16, torch.bfloat16)
    assert p.splits > 1
    for B, bt in ((1, 1), (2, 2), (3, 4), (4, 4), (5, 8), (8, 8), (9, 8), (16, 8), (64, 8)):
        assert lm.row_tile(B) == bt
        tiles = p.col_tiles * -(-B // bt)
        assert blocks(p, B) == tiles * p.splits
        assert p.tickets(B) == tiles
        assert p.scratch_floats(B) == p.splits * B * 3072
        assert p.stage(bt).bt == bt


@pytest.mark.parametrize("leaf", list(LEAVES))
def test_lutgemm_workspace_at_llama_leaves(leaf):
    """Scratch holds one (B, o) f32 slab a k-chunk and tickets one counter
    a (column tile, batch tile), only when k is split."""
    k, o = LEAVES[leaf]
    splits, _ = LUT_SPLITS[leaf]
    p = lm.plan(k, o, 4, 128, torch.bfloat16, torch.bfloat16)
    for B in (1, 4, 9, 16, 64):
        tiles = -(-o // 128) * -(-B // lm.row_tile(B))
        assert p.scratch_floats(B) == (splits * B * o if splits > 1 else 0)
        assert p.tickets(B) == (tiles if splits > 1 else 0)


@pytest.mark.parametrize("k,o,q,g", SWEEP)
def test_lutgemm_workspace_sweep(k, o, q, g):
    p = lm.plan(k, o, q, g, torch.float32, torch.bfloat16)
    for B in (1, 3, 8, 9):
        if p.splits == 1:
            assert p.scratch_floats(B) == 0 and p.tickets(B) == 0
        else:
            assert p.scratch_floats(B) == p.splits * B * o
            assert p.tickets(B) == -(-o // 128) * -(-B // lm.row_tile(B))


def test_lutgemm_plan_shrinks_stages_to_fit():
    """Eight planes with f32 scales at g = 8: a stage as large as the table
    budget allows would put the ring over the shared-memory budget, so it
    halves."""
    p = lm.plan(768, 130, 8, 8, torch.float32, torch.float32)
    st = p.stage(1)
    assert st.chunks < lm.STAGE_CHUNKS and st.smem <= lm.SMEM_BUDGET
    assert lm._stage(1, 2 * st.chunks, 8, 8, 768, 4, 4).smem > lm.SMEM_BUDGET


# ---- K1/K2 bcq_mm and K5 uniform_mm (group tables) ------------------------

KINDS = ["bcq", "uniform"]


def gt_stages(p):
    """Every stage's byte rows ``[r0, r1)``, chunk by chunk, in order."""
    return [[(r0, min(c1, r0 + p.stage_rows)) for r0 in range(c0, c1, p.stage_rows)]
            for c0, c1 in chunks(p)]


def check_gt_plan(p, kind, k, o, q, g, x_dtype, s_dtype):
    xb, sb = torch.finfo(x_dtype).bits // 8, torch.finfo(s_dtype).bits // 8
    S = q if kind == "bcq" else 2
    kc = k // 8
    ch = chunks(p)
    # the chunks cover k exactly once, in order, and the stages each chunk
    assert ch[0][0] == 0 and ch[-1][1] == kc
    assert all(a[1] == b[0] for a, b in zip(ch, ch[1:])) and all(lo < hi for lo, hi in ch)
    for (c0, c1), st in zip(ch, gt_stages(p)):
        assert st[0][0] == c0 and st[-1][1] == c1 and all(a[1] == b[0] for a, b in zip(st, st[1:]))
    assert p.ns == (1 if p.table and q > gt.NS_TABLE_MAX_Q else 4) and p.cols == 32 * p.ns
    assert p.col_tiles * p.cols >= o > (p.col_tiles - 1) * p.cols
    # the scales and tables hold every group a stage touches
    spanned = max((r1 * 8 - 1) // g - r0 * 8 // g + 1 for st in gt_stages(p) for r0, r1 in st)
    assert p.stage_groups == spanned
    # a stage's regions are 16-byte aligned, in order, and large enough
    assert p.stage_bytes % 16 == p.off_s % 16 == p.off_x % 16 == p.off_t % 16 == p.table_bytes % 16 == 0
    assert p.off_s >= q * p.stage_rows * p.cols
    assert p.off_x >= p.off_s + S * p.stage_groups * p.cols * sb
    assert p.stage_bytes >= p.off_x + common.MAX_BT * p.stage_rows * 8 * xb
    assert p.off_t >= gt.RING * p.stage_bytes
    assert p.table_bytes >= (p.stage_groups * (1 << q) * p.cols * 4 if p.table else 0)
    assert p.smem >= p.off_t + 2 * p.table_bytes
    assert p.smem >= common.WARPS * common.MAX_BT * p.cols * 4  # the warps' sums
    # two blocks an SM, as MIN_BLOCKS counts them
    assert p.smem <= gt.SMEM_BUDGET and 2 * (p.smem + 1024) <= SM_SHARED
    assert p.stage_rows <= gt.STAGE_ROWS
    # a whole chunk's stages are balanced: the last is short by less than one row a stage
    for st in gt_stages(p)[:-1]:
        assert len(st) == -(-p.chunk // p.stage_rows)
        assert st[-1][1] - st[-1][0] > p.stage_rows - len(st)


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("dtype", DTYPES, ids=["bf16", "f32"])
@pytest.mark.parametrize("leaf", list(LEAVES))
def test_grouptable_plan_fills_the_card_at_llama_leaves(leaf, dtype, kind):
    """Every llama3.2-3b leaf puts at least two blocks on each of 132 SMs
    at decode widths, with full waves, on the table path at q = 4, within
    the shared memory that lets two blocks share an SM."""
    k, o = LEAVES[leaf]
    p = gt.plan(kind, k, o, 4, 128, dtype, dtype)
    check_gt_plan(p, kind, k, o, 4, 128, dtype, dtype)
    assert p.table and p.ns == 4
    for B in (1, 4, 64):
        assert blocks(p, B) >= common.MIN_BLOCKS
    for B in (1, 4):
        assert common.wave_fill(blocks(p, B)) >= 0.9
    assert p.chunk >= common.WARPS  # a row a warp at least
    # the split of K7's rule: 13 chunks at wqkv, 11 at wo and w_down, 4 at w_gate_up
    assert p.splits == {"wqkv": 13, "wo": 11, "w_gate_up": 4, "w_down": 11, "lm_head": 1}[leaf]


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("dtype", DTYPES, ids=["bf16", "f32"])
@pytest.mark.parametrize("k,o,q,g", SWEEP)
def test_grouptable_plan_sweep(k, o, q, g, dtype, kind):
    """The reference's sweep shapes, ragged o and large q, on the path the
    plan picks and on both forced paths: chunks cover k once, every stage
    fits, and the split reaches two blocks an SM unless chunks of 8 byte
    rows stop it."""
    for table in (None, True, False):
        p = gt.plan(kind, k, o, q, g, dtype, dtype, table=table)
        check_gt_plan(p, kind, k, o, q, g, dtype, dtype)
        assert p.table == (q <= gt.TABLE_MAX_Q[kind] if table is None else table)
        assert blocks(p, 1) >= common.MIN_BLOCKS or p.chunk == min(common.WARPS, k // 8)


@pytest.mark.parametrize("chunk", [1, 3, 16, 20, 35, 10_000])
def test_grouptable_plan_chunk_override(chunk):
    """A chunk given by the caller: boundaries inside a group (3, 20 and 35
    byte rows at g = 128) or on one (16), a short last chunk, a chunk past k."""
    k, o, q, g = 1024, 130, 4, 128
    for kind in KINDS:
        p = gt.plan(kind, k, o, q, g, torch.bfloat16, torch.float32, chunk=chunk)
        check_gt_plan(p, kind, k, o, q, g, torch.bfloat16, torch.float32)
        kc = k // 8
        assert p.chunk == min(chunk, kc) and p.splits == -(-kc // p.chunk)


def test_grouptable_plan_does_not_depend_on_batch():
    """The plan takes no B: one path, split and stage size serve every
    batch; only the batch tiles, row slabs, scratch and tickets scale with it."""
    assert "B" not in inspect.signature(gt.plan).parameters
    p = gt.plan("bcq", 3072, 3072, 4, 128, torch.bfloat16, torch.bfloat16)
    assert p.splits > 1
    for B, bt in ((1, 1), (2, 2), (3, 4), (4, 4), (5, 8), (8, 8), (9, 8), (16, 8), (64, 8)):
        assert common.row_tile(B) == bt
        tiles = p.col_tiles * -(-B // bt)
        assert blocks(p, B) == tiles * p.splits
        assert p.tickets(B) == tiles
        assert p.scratch_floats(B) == p.splits * B * 3072
        assert p.slab_rows(B) == B


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("leaf", list(LEAVES))
def test_grouptable_scratch_within_cap_at_long_prefill(leaf, kind):
    """At the 8192-token prefill the split's scratch would reach gigabytes;
    row slabs of whole row tiles keep a launch's scratch within
    ``SCRATCH_CAP`` (64 MB) and cover the rows once, in order."""
    k, o = LEAVES[leaf]
    p = gt.plan(kind, k, o, 4, 128, torch.bfloat16, torch.bfloat16)
    B = 8192
    slab = p.slab_rows(B)
    assert 4 * p.scratch_floats(slab) <= gt.SCRATCH_CAP
    assert slab == B if p.splits == 1 else (slab % common.MAX_BT == 0 and slab < B)
    starts = list(range(0, B, slab))
    assert sum(min(slab, B - b0) for b0 in starts) == B
    if leaf == "wqkv":  # ~240 rows a slab, ~34 launches a call
        assert 200 <= slab <= 256 and 30 <= len(starts) <= 40


def test_grouptable_table_limit_and_columns():
    """The table path up to ``TABLE_MAX_Q`` of each format, 32 columns a
    block for a table above q = 5; the direct path keeps 128."""
    for kind in KINDS:
        for q in range(1, 9):
            p = gt.plan(kind, 768, 130, q, 8, torch.float32, torch.float32)
            assert p.table == (q <= gt.TABLE_MAX_Q[kind])
            assert p.ns == (1 if p.table and q > gt.NS_TABLE_MAX_Q else 4)
            assert gt.plan(kind, 768, 130, q, 8, torch.float32, torch.float32, table=False).ns == 4


def test_grouptable_plan_refuses_what_does_not_fit(monkeypatch):
    p = gt.plan("bcq", 768, 130, 8, 8, torch.float32, torch.float32, table=True)
    assert p.stage_rows == 1 and p.smem <= gt.MAX_SMEM
    gt.plan.cache_clear()
    monkeypatch.setattr(gt, "MAX_SMEM", p.smem - 16)
    with pytest.raises(ValueError, match="shared memory"):
        gt.plan("bcq", 768, 130, 8, 8, torch.float32, torch.float32, table=True)
    gt.plan.cache_clear()


# K12 expert_mm: olmoe-1b-7b's banks (w_gate / w_up: d -> F, w_down: F -> d), llama4-maverick's reduced
# bank, a ragged bank at q = 3, and a k whose one-expert plan cuts chunks of more than 8 byte rows
BANKS = [("bcq", 2048, 1024, 4, 128), ("bcq", 1024, 2048, 4, 128), ("bcq", 512, 512, 4, 128),
         ("bcq", 256, 200, 3, 64), ("uniform", 2048, 1024, 4, 128), ("bcq", 5120, 8192, 4, 128)]


@pytest.mark.parametrize("dtype", DTYPES, ids=["bf16", "f32"])
@pytest.mark.parametrize("kind,k,o,q,g", BANKS)
def test_bank_plan_keeps_the_one_expert_chunks_without_scratch(kind, k, o, q, g, dtype):
    """K12's plan: the path and k-chunks of ``plan`` for one expert (so each
    row's sum order is K1's), every chunk walked by one block; no scratch,
    no tickets and one launch a bank at every capacity. Chunks of 8 byte
    rows take the column walk (4 warps of 32 columns, stages over all of k,
    no shared memory for sums, four blocks an SM); others the chunk walk
    (K1's columns and stages, the warps' sums after the tables, two blocks
    an SM)."""
    one = gt.plan(kind, k, o, q, g, dtype, dtype)
    p = gt.bank_plan(kind, k, o, q, g, dtype, dtype)
    assert p.grouped and not one.grouped
    assert (p.table, p.splits, p.chunk) == (one.table, one.splits, one.chunk)
    assert chunks(p) == chunks(one)
    xb, sb = torch.finfo(dtype).bits // 8, torch.finfo(dtype).bits // 8
    S = gt.SCALE_PLANES[kind] or q
    kc = k // 8
    if p.chunk == common.WARPS:
        assert p.col_warps == gt.COL_WARPS and p.ns == 1 and p.cols == 128
        stages = [(r0, min(kc, r0 + p.stage_rows)) for r0 in range(0, kc, p.stage_rows)]  # over all of k
        assert p.stage_groups == max((r1 * 8 - 1) // g - r0 * 8 // g + 1 for r0, r1 in stages)
        assert p.off_s >= q * p.stage_rows * p.cols and p.off_x >= p.off_s + S * p.stage_groups * p.cols * sb
        assert p.stage_bytes >= p.off_x + common.MAX_BT * p.stage_rows * 8 * xb
        assert p.off_t >= gt.RING * p.stage_bytes and p.smem == p.off_t + 2 * p.table_bytes
        assert p.table_bytes >= (p.stage_groups * (1 << q) * p.cols * 4 if p.table else 0)
        assert p.smem <= gt.COLS_SMEM_BUDGET and 4 * (p.smem + 1024) <= SM_SHARED
    else:
        assert p.col_warps == 1 and p.ns == one.ns
        check_gt_plan(p, kind, k, o, q, g, dtype, dtype)
        assert p.smem >= p.off_t + 2 * p.table_bytes + common.WARPS * common.MAX_BT * p.cols * 4
        assert p.smem <= gt.SMEM_BUDGET
    for C in (8, 16, 80, 8192):
        assert p.scratch_floats(C) == p.tickets(C) == 0 and p.slab_rows(C) == C
    assert "B" not in inspect.signature(gt.bank_plan).parameters


def test_bank_plan_fills_the_card_at_an_olmoe_decode_step():
    """At B = 4 with top-8, at most 32 of olmoe's 64 experts hold a token:
    128 columns a block give the gate + up launch and the down launch each
    at least two blocks on every one of 132 SMs; olmoe's chunks of 8 byte
    rows take the column walk."""
    for k, o, banks in ((2048, 1024, 2), (1024, 2048, 1)):
        p = gt.bank_plan("bcq", k, o, 4, 128, torch.bfloat16, torch.bfloat16)
        assert p.cols == 128 and p.col_tiles * 32 * banks >= common.MIN_BLOCKS
        assert p.chunk == common.WARPS and p.col_warps == gt.COL_WARPS


def test_bank_plan_walks_chunks_where_they_are_not_8_rows(monkeypatch):
    """Chunks of 35 and 64 byte rows (a one-expert plan that a large o
    cuts coarser) and a table above q = 5 take the chunk walk; a k of at
    most 64 (one chunk of at most 8 rows) the column walk."""
    real = gt.plan
    for chunk, walk in ((35, 1), (64, 1), (8, gt.COL_WARPS)):
        monkeypatch.setattr(gt, "plan", lambda *a, c=chunk, **kw: real(*a, **kw, chunk=c))
        gt.bank_plan.cache_clear()
        p = gt.bank_plan("bcq", 1024, 256, 4, 128, torch.bfloat16, torch.bfloat16)
        assert p.chunk == chunk and p.col_warps == walk
    monkeypatch.setattr(gt, "plan", real)
    gt.bank_plan.cache_clear()
    assert gt.bank_plan("bcq", 1024, 256, 6, 64, torch.float32, torch.float32).col_warps == gt.COL_WARPS  # direct
    monkeypatch.setattr(gt, "TABLE_MAX_Q", {**gt.TABLE_MAX_Q, "bcq": 6})
    gt.plan.cache_clear()
    gt.bank_plan.cache_clear()
    p = gt.bank_plan("bcq", 1024, 256, 6, 64, torch.float32, torch.float32)
    assert p.table and p.col_warps == 1
    gt.plan.cache_clear()
    gt.bank_plan.cache_clear()
    for k in (32, 64):
        p = gt.bank_plan("bcq", k, 256, 2, 32, torch.float32, torch.float32)
        assert p.splits == 1 and p.chunk == k // 8 and p.col_warps == gt.COL_WARPS


def test_split_kernels_share_one_set_of_launch_helpers():
    """K3, K7 and the group-table kernels take the card's numbers, row
    tiles and per-device workspace from one module."""
    for mod in (cm, lm, gt):
        assert mod._workspace is common._workspace
        assert mod.row_tile is common.row_tile
    for mod in (cm, lm):
        assert mod.MIN_BLOCKS == common.MIN_BLOCKS and mod.wave_fill is common.wave_fill


# K4 ternary_mm: the tensor-core path's plan (bf16 x with bf16 alpha) and the
# group-table plan of its CUDA-core path (f32 x or f32 alpha).
tm = importlib.import_module("repro_torch.kernels.ternary_mm")
TC_SWEEP = [(k, o, g) for k, o, _, g in SWEEP] + [(776, 100, 8), (16384, 256, 128), (3072, 130, 3072)]


def check_tc_plan(p, k, o, g):
    kc = k // 8
    ch = chunks(p)
    # the chunks cover k once, in order, in whole 32-k tiles (4 byte rows)
    assert ch[0][0] == 0 and ch[-1][1] == kc
    assert all(a[1] == b[0] for a, b in zip(ch, ch[1:])) and all(lo < hi for lo, hi in ch)
    assert p.chunk % tm.TILE_ROWS == 0 and p.stage_rows % tm.TILE_ROWS == 0
    assert p.stage_rows <= tm.STAGE_ROWS
    stages = [[(r0, min(c1, r0 + p.stage_rows)) for r0 in range(c0, c1, p.stage_rows)] for c0, c1 in ch]
    # a whole chunk's stages are balanced: the fewest of at most STAGE_ROWS, short by less than a tile a stage
    for st in stages[:-1]:
        assert len(st) == -(-p.chunk // tm.STAGE_ROWS)
        assert st[-1][1] - st[-1][0] > p.stage_rows - tm.TILE_ROWS * len(st)
    # alpha holds every group a stage touches, with 3 groups of margin for a short last tile
    spanned = max((r1 * 8 - 1) // g - r0 * 8 // g + 1 for st in stages for r0, r1 in st)
    assert p.stage_groups == spanned
    assert p.off_s >= 2 * p.stage_rows * tm.PLANE_STRIDE
    assert p.stage_bytes >= p.off_s + (p.stage_groups + 3) * tm.COLS * 2
    assert p.off_s % 16 == p.stage_bytes % 16 == 0
    assert p.smem >= tm.RING * p.stage_bytes
    assert p.smem >= common.WARPS * tm.MAX_ROWS * tm.COLS * 4  # the warps' sums
    assert p.smem <= tm.SMEM_BUDGET and 2 * (p.smem + 1024) <= SM_SHARED
    assert p.col_tiles * tm.COLS >= o > (p.col_tiles - 1) * tm.COLS


def tc_blocks(p, B):
    return p.col_tiles * -(-B // tm.tc_rows(B)) * p.splits


@pytest.mark.parametrize("leaf", list(LEAVES))
def test_ternary_tc_plan_fills_the_card_at_llama_leaves(leaf):
    """Every llama3.2-3b leaf puts at least two blocks on each of 132 SMs
    at every width, with full waves at decode widths, at least one 32-k
    tile a warp, and splits k only where the column tiles leave SMs idle."""
    k, o = LEAVES[leaf]
    p = tm.tc_plan(k, o, 128)
    check_tc_plan(p, k, o, 128)
    for B in (1, 4, 64):
        assert tc_blocks(p, B) >= common.MIN_BLOCKS
    for B in (1, 4):
        assert common.wave_fill(tc_blocks(p, B)) >= 0.9
    assert p.chunk >= common.WARPS * tm.TILE_ROWS
    assert p.splits == {"wqkv": 6, "wo": 11, "w_gate_up": 2, "w_down": 11, "lm_head": 1}[leaf]


@pytest.mark.parametrize("k,o,g", TC_SWEEP)
def test_ternary_tc_plan_sweep(k, o, g):
    """The reference's sweep shapes, g = 8 (a group a byte row), g = k, a k
    that is no whole number of 32-k tiles, ragged o: chunks cover k once,
    every stage fits two blocks an SM, and the split reaches two blocks an
    SM unless tiles of one a warp stop it."""
    p = tm.tc_plan(k, o, g)
    check_tc_plan(p, k, o, g)
    tiles = -(-(k // 8) // tm.TILE_ROWS)
    assert tc_blocks(p, 1) >= common.MIN_BLOCKS or p.chunk == tm.TILE_ROWS * min(common.WARPS, tiles)


@pytest.mark.parametrize("chunk", [1, 3, 4, 20, 36, 10_000])
def test_ternary_tc_plan_chunk_override(chunk):
    """A chunk given by the caller, rounded up to whole tiles: boundaries
    inside a group (20 and 36 byte rows at g = 128) or on one, a short last
    chunk, a chunk past k."""
    k, o, g = 1024, 130, 128
    p = tm.tc_plan(k, o, g, chunk=chunk)
    check_tc_plan(p, k, o, g)
    kc = k // 8
    assert p.chunk == min(-(-chunk // 4) * 4, kc) and p.splits == -(-kc // p.chunk)


def test_ternary_tc_plan_does_not_depend_on_batch():
    """The plan takes (k, o, g) alone: one split and one set of stages serve
    every batch; only the batch tiles, row slabs, scratch and tickets scale
    with B."""
    assert list(inspect.signature(tm.tc_plan).parameters) == ["k", "o", "g", "chunk"]
    p = tm.tc_plan(3072, 3072, 128)
    assert p.splits > 1
    for B, rows in ((1, 8), (4, 8), (8, 8), (9, 16), (16, 16), (17, 32), (64, 32)):
        assert tm.tc_rows(B) == rows
        tiles = p.col_tiles * -(-B // rows)
        assert tc_blocks(p, B) == tiles * p.splits
        assert p.tickets(B) == tiles
        assert p.scratch_floats(B) == p.splits * B * 3072
        assert p.slab_rows(B) == B


@pytest.mark.parametrize("leaf", list(LEAVES))
def test_ternary_tc_scratch_within_cap_at_long_prefill(leaf):
    """At 8192 rows the split's scratch would reach gigabytes; row slabs of
    whole 32-row blocks keep a launch's within ``SCRATCH_CAP`` and cover
    the rows once, in order."""
    k, o = LEAVES[leaf]
    p = tm.tc_plan(k, o, 128)
    B = 8192
    slab = p.slab_rows(B)
    assert 4 * p.scratch_floats(slab) <= gt.SCRATCH_CAP
    assert slab == B if p.splits == 1 else (slab % tm.MAX_ROWS == 0 and slab < B)
    assert sum(min(slab, B - b0) for b0 in range(0, B, slab)) == B


@pytest.mark.parametrize("dtypes", [(torch.float32, torch.float32), (torch.float32, torch.bfloat16),
                                    (torch.bfloat16, torch.float32)], ids=["f32_f32", "f32_bf16", "bf16_f32"])
@pytest.mark.parametrize("leaf", list(LEAVES))
def test_ternary_grouptable_plan_at_llama_leaves(leaf, dtypes):
    """The CUDA-core path takes the group-table plan at q = 2 planes and one
    alpha plane: the table path by ``TABLE_MAX_Q``, 128 columns a block,
    two blocks an SM, the same split rule as K1/K5."""
    k, o = LEAVES[leaf]
    p = gt.plan("ternary", k, o, 2, 128, *dtypes)
    assert p.q == 2 and p.ns == 4 and p.table == (2 <= gt.TABLE_MAX_Q["ternary"])
    assert gt.SCALE_PLANES["ternary"] == 1
    assert p.off_x >= p.off_s + 1 * p.stage_groups * p.cols * torch.finfo(dtypes[1]).bits // 8
    assert p.smem <= gt.SMEM_BUDGET
    for B in (1, 4):
        assert blocks(p, B) >= common.MIN_BLOCKS
    assert p.splits == gt.plan("uniform", k, o, 4, 128, *dtypes).splits


# ---- K11 slstm_scan (a cluster per (head, row tile)) ---------------------------------

sm = importlib.import_module("repro_torch.kernels.slstm_scan")


@pytest.mark.parametrize("dtype", DTYPES, ids=["bf16", "f32"])
@pytest.mark.parametrize("Dh", [16, 100, 192, 256])
def test_slstm_plan_divides_dh_and_fits_one_cta(Dh, dtype):
    """The cluster's CTAs split Dh's columns evenly (at most the portable 8),
    every CTA holds its slice of the four R_g, two copies of h and the gate
    sums within 227 KB, and 4 rows x columns x gates threads within 1024;
    xlstm-125m's Dh 192 takes 8 CTAs of 24 columns."""
    p = sm.plan(Dh, dtype)
    rb = torch.finfo(dtype).bits // 8
    assert 1 <= p.cl <= sm.MAX_CLUSTER and Dh % p.cl == 0 and p.cols == Dh // p.cl >= min(8, Dh)
    assert 1 <= p.rb <= 8 and 4 * p.rb * p.cols <= sm.MAX_THREADS
    assert p.smem == sm.smem_bytes(Dh, p.cl, p.rb, rb) <= sm.MAX_SMEM < 227 * 1024 + 1
    assert p.smem >= 4 * Dh * p.cols * rb + 2 * p.rb * Dh * 4 + 4 * p.rb * p.cols * 4  # R, h twice, the gates
    if Dh in (192, 256):
        assert p.cl == 8 and p.rb == 8
    assert "B" not in inspect.signature(sm.plan).parameters


def test_slstm_plan_refuses_a_slice_that_fits_no_cta():
    """A Dh whose divisors up to 8 leave a slice of R past one CTA's shared
    memory (254 = 2 x 127) raises; so does a width past the kernel's."""
    with pytest.raises(ValueError, match="does not fit"):
        sm.plan(254, torch.float32)
    with pytest.raises(ValueError, match="must be in"):
        sm.plan(sm.MAX_DH + 1, torch.float32)
    assert sm.plan(255, torch.float32).cl == 5  # 51 columns a CTA, fewer rows a cluster


# ---- K10 mlstm_scan and K9 rglru_scan: their rings' plans ---------------------------

ms = importlib.import_module("repro_torch.kernels.mlstm_scan")
rs = importlib.import_module("repro_torch.kernels.rglru_scan")
MAX_BLOCK_SMEM = 232448  # 227 KB a block
DH10 = [384, 512, 192, 100, 32, 30, 9, 1]  # xlstm-125m's mLSTM head first, then ragged and misaligned widths


@pytest.mark.parametrize("Dh", DH10)
def test_mlstm_plan_tiles_stages_and_shared_memory(Dh):
    """16 columns of C a block, stages of 8 steps; the ring (with h's
    partials and three mbarriers a stage) and kk within 227 KB, and the most
    stages (2 to 4) that leave three blocks an SM; a staged row holds the 8
    row groups of ceil(Dh / 8) rows, rounded to 16 bytes."""
    p = ms.plan(Dh)
    R = -(-Dh // 8)
    assert p.tile == 16 and p.steps == 8 and 2 <= p.stages <= ms.MAX_STAGES
    assert ms.row_stride(Dh) % 4 == 0 and 8 * R <= ms.row_stride(Dh) < 8 * R + 4
    assert p.smem == ms.smem_bytes(Dh, p.stages) <= MAX_BLOCK_SMEM
    stage = 4 * (2 * p.steps * ms.row_stride(Dh) + p.steps * p.tile + 4 * p.steps + p.steps * 8 * (p.tile + 1))
    assert p.smem >= p.stages * (stage + 24) + 4 * p.steps * ms.row_stride(Dh)
    assert 3 * (p.smem + 1024) <= ms.SM_SMEM or p.stages == 2  # else the fewest stages (Dh 512: two blocks)
    assert p.stages == ms.MAX_STAGES or 3 * (ms.smem_bytes(Dh, p.stages + 1) + 1024) > ms.SM_SMEM
    assert p.grid(1, 4) == (-(-Dh // 16), 4, 1)


def test_mlstm_plan_fills_the_card_at_xlstm_width():
    """xlstm-125m (Dh 384, 4 heads) at B = 1: 96 blocks (the parent's 32-column
    tiles: 48), each on its own SM, 2 stages of 8 steps, bulk copies."""
    p = ms.plan(384)
    assert p.blocks(1, 4) == 96 >= 96 and p.stages == 2 and p.bulk
    assert p.blocks(4, 4) == 4 * p.blocks(1, 4)


def test_mlstm_plan_depends_on_the_width_alone():
    """The plan takes Dh alone: B and S change the grid's row count only."""
    assert list(inspect.signature(ms.plan).parameters) == ["Dh"]
    p = ms.plan(384)
    assert {p.grid(B, 4)[:2] for B in (1, 4, 64)} == {(24, 4)}
    with pytest.raises(ValueError, match="must be in"):
        ms.plan(ms.MAX_DH + 1)


@pytest.mark.parametrize("Dh,bulk", [(384, True), (100, True), (32, True), (30, False), (9, False), (1, False)])
def test_mlstm_misaligned_rows_take_the_in_kernel_path(Dh, bulk):
    """Rows of 4 Dh bytes that are not 16-byte multiples, or q, k, v off a
    16-byte boundary, take the kernel's per-element cp.async path: never the
    plain version."""
    p = ms.plan(Dh)
    assert p.bulk is bulk
    x = torch.zeros(2 * Dh + 4)
    assert ms.use_bulk(p, x[:Dh], x[:Dh], x[:Dh]) is bulk
    assert ms.use_bulk(p, x[:Dh], x[1 : Dh + 1], x[:Dh]) is False


@pytest.mark.parametrize("W", [4096, 2560, 1000, 300, 257, 33, 1])
def test_rglru_plan_slices_stages_and_shared_memory(W):
    """32 channels a ring block, 8 stages of [32 steps x 32 channels] of a
    and g (and two mbarriers each) within 227 KB; sequences up to one stage
    run the short kernel."""
    p = rs.plan(W)
    assert p.slice == 32 and p.steps == 32 and p.short == p.steps and p.stages == 8
    assert p.smem == rs.smem_bytes(p.stages) == p.stages * (2 * p.steps * p.slice * 4 + 16) <= MAX_BLOCK_SMEM
    assert p.grid(3) == (-(-W // 32), 3)


def test_rglru_plan_fills_the_card_at_recurrentgemma_width():
    """recurrentgemma-9b's W = 4096 at B = 1: 128 ring blocks (the parent's
    256-thread blocks: 16, which a decode step still runs)."""
    p = rs.plan(4096)
    assert p.blocks(1, 3000) == 128 >= 128 and p.tma
    assert p.path(p.short) == "short" and p.path(p.short + 1) == "ring"
    assert p.blocks(1, 1) == 16 and p.blocks(4, 20) == 64 and p.blocks(4, 33) == 512
    assert list(inspect.signature(rs.plan).parameters) == ["W"]
    assert {p.grid(B)[0] for B in (1, 4, 64)} == {128}


@pytest.mark.parametrize("W,tma", [(4096, True), (1000, True), (257, False), (300, True), (33, False)])
def test_rglru_misaligned_rows_take_the_in_kernel_path(W, tma):
    """Rows of 4 W bytes that are not 16-byte multiples, or a and g off a
    16-byte boundary, fill the ring by per-element cp.async in the kernel."""
    p = rs.plan(W)
    assert p.tma is tma
    x = torch.zeros(2 * W + 4)
    assert rs.use_tma(p, x[:W], x[:W]) is tma
    assert rs.use_tma(p, x[1 : W + 1], x[:W]) is False


def test_hopper_copy_helpers_live_in_one_header():
    """The mbarrier, TMA and bulk-copy wrappers and the run-time lookup of
    cuTensorMapEncodeTiled are written once, in csrc/hopper.cuh, which K8,
    K9 and K10 include."""
    csrc = Path(ms.__file__).resolve().parents[1] / "csrc"
    header = (csrc / "hopper.cuh").read_text()
    for name in ("mbar_init", "mbar_wait", "mbar_expect_tx", "bulk_load", "tma_load_3d", "tma_load_4d",
                 "cp_async_mbar_arrive", "encode_tiled"):
        assert f" {name}(" in header, name
    for src in sorted(csrc.glob("*.cu")):
        text = src.read_text()
        assert "mbarrier.init" not in text and "cuTensorMapEncodeTiled\", &p" not in text, src.name
        if src.stem in ("flash_attn", "rglru_scan", "mlstm_scan"):
            assert '#include "hopper.cuh"' in text, src.name
