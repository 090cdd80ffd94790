"""The port's hand-written CUDA kernels on the GPU, against their plain
PyTorch versions, the engine's kernel path against its ref-oracle path, and
the slot-batched serving path against solo generation.

Every test here needs a CUDA GPU and skips without one. The file imports
nothing of JAX, so it also runs where JAX is not installed; there, run it
without the suite's conftest (which imports JAX):

    PYTHONPATH=src python -m pytest --noconftest -q tests/test_torch_cuda.py

Tolerance: rtol = atol = 2e-4 for f32 and bf16 inputs alike. A kernel and
its plain version widen the same x and scales to f32 and accumulate in f32,
so only the order of summation separates them. ``dequant_materialize``
computes every weight as its plain version does (a product, then a sum),
so it is held to its plain version bit for bit. ``flash_attention`` is held
to its plain version (``_sdpa`` under a causal mask) at the reference
test's tolerances, 2e-4 in f32 and 3e-2 in bf16: in bf16 the kernel rounds
``exp(s - m)`` per key tile where the plain version rounds the normalised
probabilities. In bf16 each query row is also held to ``BF16_ROW_TOL``
(2^-6) of its largest value, which still sees the long rows, whose values
fall as 1/sqrt(S) below the absolute limit.
"""

import dataclasses
import functools
import importlib

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.infer import Engine, Request, Scheduler, SpecConfig
from repro_torch.core.formats import get_format
from repro_torch.kernels import (
    KERNEL_WRAPPERS,
    bcq_mm,
    bcq_mm_fused,
    bcq_mm_plain,
    codebook_mm,
    codebook_mm_plain,
    dequant_materialize,
    dequant_materialize_plain,
    dequant_mm,
    dequant_mm_plain,
    flash_attention,
    flash_attention_plain,
    impl_mode,
    launch_counts,
    lutgemm,
    lutgemm_plain,
    reset_launch_counts,
    ternary_mm,
    ternary_mm_plain,
    uniform_mm,
    uniform_mm_plain,
)
from repro_torch.kernels.flash_attn import BF16_ROW_TOL, row_rel_err
from repro_torch.models import forward, init_params, reduced
from repro_torch.models.layers import rmsnorm
from repro_torch.quant import QuantPolicy, quantize_params
from repro_torch.utils import ROW_TILE, matmul_rows

pytestmark = pytest.mark.needs_cuda

SHAPES = [  # (B, k, o, q, g): the reference's sweep, a ragged case, a prefill case,
    # and a wide-k, narrow-o case that splits k across the most blocks
    (1, 512, 256, 2, 64),
    (8, 512, 128, 4, 512),
    (8, 1024, 256, 3, 128),
    (16, 512, 384, 1, 8),
    (4, 1024, 128, 5, 1024),
    (2, 2048, 256, 2, 2048),
    (3, 768, 200, 3, 96),
    (64, 3072, 5120, 4, 128),
    (1, 16384, 256, 4, 128),
]
TOL = 2e-4
FORMAT_KERNELS = {  # format: (kernel wrapper, plain version)
    "uniform": (uniform_mm, uniform_mm_plain),
    "ternary": (ternary_mm, ternary_mm_plain),
    "codebook": (codebook_mm, codebook_mm_plain),
    "dequant": (dequant_mm, dequant_mm_plain),
}


def format_planes(fmt, k, o, q, g, dtype, gen, device):
    """Random packed planes and scales of ``fmt`` whose weights are ~1/sqrt(k)."""
    f = get_format(fmt)
    packed = torch.randint(0, 256, (f.planes(q), k // 8, o), generator=gen, device=device, dtype=torch.uint8)
    shape = f.scales_shape(q, k // g, o)
    u = (torch.rand(shape, generator=gen, device=device) + 0.5) / np.sqrt(k)
    if fmt in ("uniform", "dequant"):  # (s, z): codes centred on 0
        s = u[0] / 2**q
        u = torch.stack([s, -s * (2**q - 1) / 2])
    elif fmt == "codebook":
        u = torch.randn(shape, generator=gen, device=device) / np.sqrt(k)
    return packed, u.to(dtype)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU (the hand-written kernels have no CPU mode)")
    return torch.device("cuda")


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("B,k,o,q,g", SHAPES)
def test_kernels_match_plain(cuda, B, k, o, q, g, dtype):
    gen = torch.Generator(device=cuda)
    gen.manual_seed(B * 7 + k + o)
    x = torch.randn((B, k), generator=gen, device=cuda).to(dtype)
    packed = torch.randint(0, 256, (q, k // 8, o), generator=gen, device=cuda, dtype=torch.uint8)
    scales = ((torch.rand((q, k // g, o), generator=gen, device=cuda) + 0.5) / np.sqrt(k * q)).to(dtype)
    want = bcq_mm_plain(x, packed, scales, g=g)
    torch.testing.assert_close(lutgemm_plain(x, packed, scales, g=g), want, rtol=TOL, atol=TOL)
    reset_launch_counts()
    for fn in (bcq_mm, lutgemm):
        got = fn(x, packed, scales, g=g)
        torch.cuda.synchronize()
        torch.testing.assert_close(got, want, rtol=TOL, atol=TOL)
    half = o // 2
    parts = bcq_mm_fused(x, packed, scales, g=g, out_dims=(half, o - half))
    torch.testing.assert_close(torch.cat(parts, -1), want, rtol=TOL, atol=TOL)
    # the other formats' kernels on their own planes at the same shape
    for fmt, (fn, plain) in FORMAT_KERNELS.items():
        fp, fs = format_planes(fmt, k, o, q, g, dtype, gen, cuda)
        got = fn(x, fp, fs, g=g)
        torch.cuda.synchronize()
        torch.testing.assert_close(got, plain(x, fp, fs, g=g), rtol=TOL, atol=TOL, msg=fmt)
        if fmt == "dequant":
            for od in (torch.float32, torch.bfloat16):
                w = dequant_materialize(fp, fs, g=g, out_dtype=od)
                torch.testing.assert_close(w, dequant_materialize_plain(fp, fs, g=g, out_dtype=od), rtol=0, atol=0)
        # deterministic: no atomics, fixed reduction order
        torch.testing.assert_close(fn(x, fp, fs, g=g), got, rtol=0, atol=0, msg=fmt)
    assert launch_counts() == {
        "bcq_mm": 1, "bcq_mm_fused": 1, "lutgemm": 1, "uniform_mm": 2,
        "dequant_materialize": 4, "ternary_mm": 2, "codebook_mm": 2, "flash_attention": 0,
    }
    torch.testing.assert_close(bcq_mm(x, packed, scales, g=g), bcq_mm(x, packed, scales, g=g), rtol=0, atol=0)
    torch.testing.assert_close(lutgemm(x, packed, scales, g=g), lutgemm(x, packed, scales, g=g), rtol=0, atol=0)


def test_kernels_raise_on_mixed_devices(cuda):
    x = torch.randn((2, 256), device=cuda)
    packed = torch.zeros((2, 32, 128), dtype=torch.uint8)
    for fn, s in ((bcq_mm, 2), (lutgemm, 2), (uniform_mm, 2), (ternary_mm, 1), (codebook_mm, 4)):
        with pytest.raises(ValueError, match="devices"):
            fn(x, packed, torch.ones((s, 4, 128)), g=64)
    with pytest.raises(ValueError, match="devices"):
        dequant_materialize(packed.to(cuda), torch.ones((2, 4, 128)), g=64)
    assert len(KERNEL_WRAPPERS) == 8


@pytest.mark.parametrize("fmt", ["uniform", "dequant", "ternary", "codebook"])
def test_engine_format_kernel_path_matches_ref_path(cuda, fmt):
    """Each format's model: 4L+1 launches of its kernel per forward (fused
    leaves are one launch each), no oracle dispatch, logits within 2e-4 of
    the same engine on the ref oracle (reduced f32 model)."""
    cfg = reduced(get_config("llama3.2-3b"), d_model=256, n_kv_heads=4, d_ff=512)
    params = quantize_params(
        init_params(cfg, seed=0, device=cuda), QuantPolicy(q=4, g=128, iters=2, fmt=fmt), device=cuda
    )
    eng = Engine(cfg, params, max_seq=32, device=cuda)
    toks = torch.as_tensor(np.random.default_rng(0).integers(0, cfg.vocab, size=(3, 8)), device=cuda)

    def logits(mode):
        with impl_mode(mode):
            l0, cache = eng.prefill(toks, eng._make_cache(3))
            l1, _ = eng.decode(toks[:, -1:], cache, 8)
        return torch.stack([l0, l1])

    kernel = {"uniform": "uniform_mm", "dequant": "dequant_materialize", "ternary": "ternary_mm",
              "codebook": "codebook_mm"}[fmt]
    reset_launch_counts()
    got = logits(None)
    counts = launch_counts()
    assert counts[kernel] == 2 * (4 * cfg.n_layers + 1)
    assert counts["flash_attention"] == cfg.n_layers  # the prefill's attention
    assert sum(counts.values()) == counts[kernel] + cfg.n_layers
    torch.testing.assert_close(got, logits("ref"), rtol=2e-4, atol=2e-4)


def test_engine_kernel_path_matches_ref_path(cuda):
    cfg = reduced(get_config("llama3.2-3b"), d_model=256, n_kv_heads=4, d_ff=512)
    params = quantize_params(
        init_params(cfg, seed=0, device=cuda), QuantPolicy(q=4, g=128, iters=2), device=cuda
    )
    eng = Engine(cfg, params, max_seq=32, device=cuda)
    prompts = np.random.default_rng(0).integers(0, cfg.vocab, size=(3, 8))
    toks = torch.as_tensor(prompts, device=cuda)

    def logits(mode):
        with impl_mode(mode):
            cache = eng._make_cache(3)
            l0, cache = eng.prefill(toks, cache)
            l1, _ = eng.decode(toks[:, -1:], cache, 8)
        return torch.stack([l0, l1])

    reset_launch_counts()
    got = logits(None)
    assert launch_counts()["bcq_mm"] == 2 * (2 * cfg.n_layers + 1)
    assert launch_counts()["bcq_mm_fused"] == 2 * 2 * cfg.n_layers
    want = logits("ref")
    torch.testing.assert_close(got, want, rtol=2e-4, atol=2e-4)
    torch.testing.assert_close(logits("lutgemm"), want, rtol=2e-4, atol=2e-4)

    a = eng.generate(prompts, 6, temperature=0.7, seed=3, scan=True)
    b = eng.generate(prompts, 6, temperature=0.7, seed=3, scan=False)
    np.testing.assert_array_equal(a.tokens, b.tokens)


FLASH_SHAPES = [  # (B, S, H, Hkv, Dh): decode-width and ragged S around the 64- and
    # 128-row tile edges, GQA ratios 1, 3 and 6, every Dh, B up to 4
    (1, 1, 24, 8, 128),
    (4, 17, 24, 8, 128),
    (2, 100, 6, 1, 64),
    (1, 333, 8, 2, 32),
    (3, 65, 4, 4, 16),
    (1, 1024, 8, 2, 32),
    (1, 63, 6, 1, 128),
    (2, 64, 3, 1, 64),
    (4, 65, 4, 4, 32),
    (1, 127, 6, 2, 16),
    (3, 128, 6, 1, 128),
    (2, 129, 4, 4, 64),
    (1, 1000, 24, 8, 128),
    (4, 1000, 6, 2, 16),
    (1, 2048, 6, 1, 128),
    (2, 2048, 3, 3, 64),
]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("B,S,H,Hkv,Dh", FLASH_SHAPES)
def test_flash_attention_matches_plain(cuda, B, S, H, Hkv, Dh, dtype):
    gen = torch.Generator(device=cuda)
    gen.manual_seed(S * 31 + Dh)
    q = torch.randn((B, S, H, Dh), generator=gen, device=cuda).to(dtype)
    # k and v as strided views of one fused projection output, as the model passes them
    kv = torch.randn((B, S, 2 * Hkv * Dh), generator=gen, device=cuda).to(dtype)
    k, v = (t.reshape(B, S, Hkv, Dh) for t in kv.split(Hkv * Dh, dim=-1))
    tol = 2e-4 if dtype == torch.float32 else 3e-2
    reset_launch_counts()
    got = flash_attention(q, k, v)
    torch.cuda.synchronize()
    assert got.dtype == dtype and got.shape == (B, S, H, Dh)
    plain = flash_attention_plain(q, k, v)
    torch.testing.assert_close(got.float(), plain.float(), rtol=tol, atol=tol)
    if dtype == torch.bfloat16:  # and per query row, relative to the row's values
        assert row_rel_err(got, plain) <= BF16_ROW_TOL
    # deterministic: no atomics, fixed reduction order
    torch.testing.assert_close(flash_attention(q, k, v), got, rtol=0, atol=0)
    assert launch_counts()["flash_attention"] == 2


def test_flash_attention_copies_a_misaligned_view(cuda):
    """A bf16 view the TMA cannot read in place (a base 2 bytes off 16) is
    copied by the wrapper, counted, and gives the same bits as the aligned
    tensor; the fused projection's own views are read in place."""
    gen = torch.Generator(device=cuda)
    gen.manual_seed(5)
    B, S, H, Hkv, Dh = 2, 300, 6, 2, 64
    q = torch.randn((B, S, H, Dh), generator=gen, device=cuda).to(torch.bfloat16)
    kv = torch.randn((B, S, 2 * Hkv * Dh), generator=gen, device=cuda).to(torch.bfloat16)
    k, v = (t.reshape(B, S, Hkv, Dh) for t in kv.split(Hkv * Dh, dim=-1))
    flash_attention.copies = 0
    want = flash_attention(q, k, v)
    assert flash_attention.copies == 0
    buf = torch.zeros((B, S, Hkv * Dh + 8), dtype=torch.bfloat16, device=cuda)
    buf[..., 1 : 1 + Hkv * Dh] = v.reshape(B, S, Hkv * Dh)
    v_off = buf[..., 1 : 1 + Hkv * Dh].reshape(B, S, Hkv, Dh)
    got = flash_attention(q, k, v_off)
    torch.cuda.synchronize()
    assert flash_attention.copies == 1
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    torch.testing.assert_close(got.float(), flash_attention_plain(q, k, v).float(), rtol=3e-2, atol=3e-2)
    flash_attention.copies = 0


CODEBOOK_CASES = [  # (B, o, chunk): batch widths, ragged o, and k-splits whose chunk
    # boundaries fall inside a group (3 and 20 byte rows) or on one (16 at g <= 128)
    (1, 100, None), (3, 130, 3), (4, 100, 20), (8, 130, 16), (9, 256, None), (64, 130, 20),
]


@pytest.mark.parametrize("g", [8, 64, 128, 768])
@pytest.mark.parametrize("q", range(1, 9))
def test_codebook_kernel_matches_plain(cuda, monkeypatch, q, g):
    """K7 against its plain version within 2e-4 for q 1..8, g in {8, 64,
    128, k}, ragged o, B from 1 to 64 and k-splits of several chunk sizes;
    bitwise against 10 reruns, which also shows that every launch left its
    tickets at 0 for the next."""
    cm = importlib.import_module("repro_torch.kernels.codebook_mm")
    plan = cm.plan
    gen = torch.Generator(device=cuda)
    gen.manual_seed(q * 1000 + g)
    k = 768
    for B, o, chunk in CODEBOOK_CASES:
        monkeypatch.setattr(cm, "plan", plan if chunk is None else functools.partial(plan, chunk=chunk))
        for dtype in (torch.bfloat16, torch.float32):
            x = torch.randn((B, k), generator=gen, device=cuda).to(dtype)
            packed = torch.randint(0, 256, (q, k // 8, o), generator=gen, device=cuda, dtype=torch.uint8)
            table = (torch.randn((1 << q, k // g, o), generator=gen, device=cuda) / np.sqrt(k)).to(dtype)
            reset_launch_counts()
            got = codebook_mm(x, packed, table, g=g)
            again = codebook_mm(x, packed, table, g=g)  # back to back, no sync between
            torch.cuda.synchronize()
            assert launch_counts()["codebook_mm"] == 2
            msg = f"B={B} o={o} chunk={chunk} {dtype}"
            torch.testing.assert_close(got, codebook_mm_plain(x, packed, table, g=g), rtol=TOL, atol=TOL, msg=msg)
            torch.testing.assert_close(again, got, rtol=0, atol=0, msg=msg)
            for _ in range(10):
                torch.testing.assert_close(codebook_mm(x, packed, table, g=g), got, rtol=0, atol=0, msg=msg)


LUTGEMM_CASES = [  # (B, o, chunk): every row tile and two batch tiles, ragged o, and
    # k-splits whose chunk boundaries fall inside a group (3 and 20 byte rows)
    # or on one (16 at g <= 128)
    (1, 100, None), (2, 130, 3), (3, 1000, 20), (4, 100, 16), (8, 130, None), (9, 1000, 3),
    (16, 130, 20), (64, 100, 16),
]


@pytest.mark.parametrize("g", [8, 64, 128, 768])
@pytest.mark.parametrize("q", range(1, 9))
def test_lutgemm_kernel_matches_plain(cuda, monkeypatch, q, g):
    """K3 against its plain version within 2e-4 for q 1..8, g in {8, 64,
    128, k}, ragged o, B from 1 to 64 and k-splits of several chunk sizes;
    bitwise against 10 reruns and between two back-to-back launches, which
    also shows that every launch left its tickets at 0 for the next."""
    lm = importlib.import_module("repro_torch.kernels.lutgemm")
    plan = lm.plan
    gen = torch.Generator(device=cuda)
    gen.manual_seed(q * 1000 + g)
    k = 768
    for B, o, chunk in LUTGEMM_CASES:
        monkeypatch.setattr(lm, "plan", plan if chunk is None else functools.partial(plan, chunk=chunk))
        for dtype in (torch.bfloat16, torch.float32):
            x = torch.randn((B, k), generator=gen, device=cuda).to(dtype)
            packed = torch.randint(0, 256, (q, k // 8, o), generator=gen, device=cuda, dtype=torch.uint8)
            scales = ((torch.rand((q, k // g, o), generator=gen, device=cuda) + 0.5) / np.sqrt(k * q)).to(dtype)
            reset_launch_counts()
            got = lutgemm(x, packed, scales, g=g)
            again = lutgemm(x, packed, scales, g=g)  # back to back, no sync between
            torch.cuda.synchronize()
            assert launch_counts()["lutgemm"] == 2
            msg = f"B={B} o={o} chunk={chunk} {dtype}"
            torch.testing.assert_close(got, lutgemm_plain(x, packed, scales, g=g), rtol=TOL, atol=TOL, msg=msg)
            torch.testing.assert_close(again, got, rtol=0, atol=0, msg=msg)
            for _ in range(10):
                torch.testing.assert_close(lutgemm(x, packed, scales, g=g), got, rtol=0, atol=0, msg=msg)


@pytest.mark.parametrize("B", [4, 9, 16, 64])
@pytest.mark.parametrize("k,o,q,g", [(3072, 3072, 4, 128), (1024, 256, 3, 128)], ids=["wo", "sweep"])
def test_lutgemm_rows_equal_solo(cuda, k, o, q, g, B):
    """Batch invariance: row r of a B-row K3 call equals the same row
    called alone, bit for bit (the plan does not depend on B, and a row
    sums in the same order at every row tile)."""
    gen = torch.Generator(device=cuda)
    gen.manual_seed(B + k)
    for dtype in (torch.bfloat16, torch.float32):
        x = torch.randn((B, k), generator=gen, device=cuda).to(dtype)
        packed = torch.randint(0, 256, (q, k // 8, o), generator=gen, device=cuda, dtype=torch.uint8)
        scales = ((torch.rand((q, k // g, o), generator=gen, device=cuda) + 0.5) / np.sqrt(k * q)).to(dtype)
        full = lutgemm(x, packed, scales, g=g)
        for r in range(B):
            torch.testing.assert_close(lutgemm(x[r : r + 1], packed, scales, g=g), full[r : r + 1],
                                       rtol=0, atol=0, msg=f"row {r} of {B}, {dtype}")


GROUPTABLE_CASES = [  # (B, o, chunk): every row tile and two batch tiles, ragged o, and
    # k-splits whose chunk boundaries fall inside a group (3, 20 and 35 byte
    # rows) or on one (16 at g <= 128)
    (1, 100, None), (2, 130, 3), (3, 1000, 20), (4, 100, 16), (8, 130, None), (9, 1000, 35),
    (16, 130, 20), (64, 100, 16),
]
GROUPTABLE_KERNELS = ["bcq_mm", "bcq_mm_fused", "uniform_mm"]


def grouptable_call(name, x, packed, scales, g):
    """One call of a group-table kernel's wrapper → ``(B, o)`` f32; the
    fused wrapper's outputs are concatenated back."""
    if name == "bcq_mm":
        return bcq_mm(x, packed, scales, g=g)
    if name == "uniform_mm":
        return uniform_mm(x, packed, scales, g=g)
    o = packed.shape[-1]
    return torch.cat(bcq_mm_fused(x, packed, scales, g=g, out_dims=(o // 3, o - o // 3)), dim=-1)


def grouptable_inputs(name, B, k, o, q, g, dtype, gen, device):
    x = torch.randn((B, k), generator=gen, device=device).to(dtype)
    fmt = "uniform" if name == "uniform_mm" else "bcq"
    packed, scales = format_planes(fmt, k, o, q, g, dtype, gen, device)
    if fmt == "bcq":
        scales = (scales / np.sqrt(q)).to(dtype)
    return x, packed, scales


@pytest.mark.parametrize("path", ["table", "direct"])
@pytest.mark.parametrize("g", [8, 64, 128, 768])
@pytest.mark.parametrize("q", range(1, 9))
@pytest.mark.parametrize("name", GROUPTABLE_KERNELS)
def test_grouptable_kernel_matches_plain(cuda, monkeypatch, name, q, g, path):
    """K1, K2 and K5 against their plain versions within 2e-4 for q 1..8,
    g in {8, 64, 128, k}, on the table path and the direct path alike,
    ragged o, B from 1 to 64 and k-splits of several chunk sizes; bitwise
    against 10 reruns and between two back-to-back calls, which also shows
    that every launch left its tickets at 0 for the next."""
    gt = importlib.import_module("repro_torch.kernels.grouptable")
    plan = gt.plan
    plain = uniform_mm_plain if name == "uniform_mm" else bcq_mm_plain
    counter = {"bcq_mm": bcq_mm, "bcq_mm_fused": bcq_mm_fused, "uniform_mm": uniform_mm}[name]
    gen = torch.Generator(device=cuda)
    gen.manual_seed(q * 1000 + g)
    k = 768
    for B, o, chunk in GROUPTABLE_CASES:
        monkeypatch.setattr(gt, "plan", functools.partial(plan, chunk=chunk, table=path == "table"))
        for dtype in (torch.bfloat16, torch.float32):
            x, packed, scales = grouptable_inputs(name, B, k, o, q, g, dtype, gen, cuda)
            reset_launch_counts()
            got = grouptable_call(name, x, packed, scales, g)
            again = grouptable_call(name, x, packed, scales, g)  # back to back, no sync between
            torch.cuda.synchronize()
            assert launch_counts()[name] == 2
            msg = f"B={B} o={o} chunk={chunk} {dtype}"
            torch.testing.assert_close(got, plain(x, packed, scales, g=g), rtol=TOL, atol=TOL, msg=msg)
            torch.testing.assert_close(again, got, rtol=0, atol=0, msg=msg)
            for _ in range(10):
                torch.testing.assert_close(grouptable_call(name, x, packed, scales, g), got, rtol=0, atol=0, msg=msg)


@pytest.mark.parametrize("B", [4, 9, 16, 64])
@pytest.mark.parametrize("k,o,q,g", [(3072, 3072, 4, 128), (1024, 256, 3, 128)], ids=["wo", "sweep"])
@pytest.mark.parametrize("name", GROUPTABLE_KERNELS)
def test_grouptable_rows_equal_solo(cuda, name, k, o, q, g, B):
    """Batch invariance: row r of a B-row K1, K2 or K5 call equals the same
    row called alone, bit for bit (the plan does not depend on B, and a row
    sums in the same order at every row tile)."""
    gen = torch.Generator(device=cuda)
    gen.manual_seed(B + k)
    for dtype in (torch.bfloat16, torch.float32):
        x, packed, scales = grouptable_inputs(name, B, k, o, q, g, dtype, gen, cuda)
        full = grouptable_call(name, x, packed, scales, g)
        for r in range(B):
            torch.testing.assert_close(grouptable_call(name, x[r : r + 1], packed, scales, g), full[r : r + 1],
                                       rtol=0, atol=0, msg=f"row {r} of {B}, {dtype}")


@pytest.mark.parametrize("name", GROUPTABLE_KERNELS)
def test_grouptable_rows_equal_solo_across_row_slabs(cuda, monkeypatch, name):
    """A call wider than a row slab launches once a slab (the scratch cap
    lowered here to 8 rows a slab at ``wo``): each row equals the row alone,
    bit for bit, and the call counts one launch a slab (3 for 21 rows)."""
    gt = importlib.import_module("repro_torch.kernels.grouptable")
    k, o, q, g = 3072, 3072, 4, 128
    p = gt.plan("uniform" if name == "uniform_mm" else "bcq", k, o, q, g, torch.bfloat16, torch.bfloat16)
    monkeypatch.setattr(gt, "SCRATCH_CAP", 8 * 4 * p.splits * o)
    assert p.slab_rows(21) == 8
    gen = torch.Generator(device=cuda)
    gen.manual_seed(21)
    for dtype in (torch.bfloat16, torch.float32):
        x, packed, scales = grouptable_inputs(name, 21, k, o, q, g, dtype, gen, cuda)
        reset_launch_counts()
        full = grouptable_call(name, x, packed, scales, g)
        assert launch_counts()[name] == 3
        plain = uniform_mm_plain if name == "uniform_mm" else bcq_mm_plain
        torch.testing.assert_close(full, plain(x, packed, scales, g=g), rtol=TOL, atol=TOL)
        for r in range(21):
            torch.testing.assert_close(grouptable_call(name, x[r : r + 1], packed, scales, g), full[r : r + 1],
                                       rtol=0, atol=0, msg=f"row {r} of 21, {dtype}")


def test_flash_attention_refuses_what_it_does_not_take(cuda):
    q = torch.zeros((1, 8, 4, 48), device=cuda)
    with pytest.raises(ValueError, match="head dim"):
        flash_attention(q, q[:, :, :2], q[:, :, :2])
    with pytest.raises(ValueError, match="devices"):
        flash_attention(q[..., :32], q[:, :, :2, :32].cpu(), q[:, :, :2, :32].cpu())


def test_causal_prefill_runs_on_flash_kernel(cuda):
    """On the GPU every prefill's attention is K8 (one launch a layer), also
    under a kernel impl_mode; impl_mode("ref") takes the plain attention."""
    cfg = reduced(get_config("llama3.2-3b"), d_model=256, n_kv_heads=4, d_ff=512)
    eng = Engine(cfg, init_params(cfg, seed=0, device=cuda), max_seq=48, device=cuda)
    toks = torch.as_tensor(np.random.default_rng(1).integers(0, cfg.vocab, size=(2, 37)), device=cuda)
    out = {}
    for mode in (None, "lutgemm", "ref"):
        reset_launch_counts()
        with impl_mode(mode):
            out[mode], _ = eng.prefill(toks, eng._make_cache(2))
        assert launch_counts()["flash_attention"] == (0 if mode == "ref" else cfg.n_layers)
    torch.testing.assert_close(out[None], out["ref"], rtol=2e-4, atol=2e-4)
    torch.testing.assert_close(out["lutgemm"], out[None], rtol=0, atol=0)


TERNARY_DTYPES = [(torch.bfloat16, torch.bfloat16), (torch.bfloat16, torch.float32),
                  (torch.float32, torch.bfloat16), (torch.float32, torch.float32)]
TERNARY_IDS = ["bf16_bf16", "bf16_f32", "f32_bf16", "f32_f32"]
LLAMA_LEAVES = [(4, 3072, 5120, 4, 128), (4, 3072, 3072, 4, 128), (4, 3072, 16384, 4, 128),
                (4, 8192, 3072, 4, 128), (4, 3072, 128256, 4, 128), (64, 3072, 3072, 4, 128)]
TERNARY_EXTRA = [(5, 776, 100, 2, 8), (33, 1024, 200, 2, 1024), (9, 4096, 130, 2, 64)]  # k no whole 32-k tile, g = k, ragged


def ternary_inputs(B, k, o, g, x_dtype, s_dtype, gen, device):
    x = torch.randn((B, k), generator=gen, device=device).to(x_dtype)
    packed, scales = format_planes("ternary", k, o, 2, g, s_dtype, gen, device)
    return x, packed, scales


@pytest.mark.parametrize("dtypes", TERNARY_DTYPES, ids=TERNARY_IDS)
@pytest.mark.parametrize("B,k,o,q,g", SHAPES + LLAMA_LEAVES + TERNARY_EXTRA)
def test_ternary_kernel_matches_plain_on_both_paths(cuda, B, k, o, q, g, dtypes):
    """K4 against its plain version within 2e-4 at the sweep, llama3.2-3b's
    five leaves and edge shapes (g = 8, g = k, ragged o, a k that is no
    whole number of 32-k tiles), on the tensor cores for bf16 x with bf16
    alpha and on the group-table kernel for the other three pairs; the same
    bits on reruns; the tensor-core count moves for bf16/bf16 only."""
    x_dtype, s_dtype = dtypes
    gen = torch.Generator(device=cuda)
    gen.manual_seed(B * 7 + k + o + g)
    x, packed, scales = ternary_inputs(B, k, o, g, x_dtype, s_dtype, gen, cuda)
    reset_launch_counts()
    got = ternary_mm(x, packed, scales, g=g)
    again = ternary_mm(x, packed, scales, g=g)  # back to back, no sync between
    torch.cuda.synchronize()
    tc = x_dtype == s_dtype == torch.bfloat16
    assert launch_counts()["ternary_mm"] == 2 and ternary_mm.tc_launches == (2 if tc else 0)
    torch.testing.assert_close(got, ternary_mm_plain(x, packed, scales, g=g), rtol=TOL, atol=TOL)
    torch.testing.assert_close(again, got, rtol=0, atol=0)
    for _ in range(3):
        torch.testing.assert_close(ternary_mm(x, packed, scales, g=g), got, rtol=0, atol=0)


def test_ternary_tensor_cores_take_a_misaligned_x(cuda):
    """x whose base is 8 bytes off 16 (a view into a larger buffer): the
    tensor-core kernel reads x in 16-byte pieces, so the wrapper copies it,
    and the result has the bits of the aligned call."""
    gen = torch.Generator(device=cuda)
    gen.manual_seed(3)
    B, k, o, g = 5, 3072, 3072, 128
    x, packed, scales = ternary_inputs(B, k, o, g, torch.bfloat16, torch.bfloat16, gen, cuda)
    buf = torch.empty(B * k + 4, dtype=torch.bfloat16, device=cuda)
    buf[4:] = x.reshape(-1)
    x_off = buf[4:].view(B, k)
    assert x_off.data_ptr() % 16 == 8
    reset_launch_counts()
    got = ternary_mm(x_off, packed, scales, g=g)
    assert ternary_mm.tc_launches == 1
    torch.testing.assert_close(got, ternary_mm(x, packed, scales, g=g), rtol=0, atol=0)


TERNARY_CASES = [  # (B, o, chunk): every row tile and two batch tiles, ragged o, and
    # k-splits of 1, 5 and 3 tiles (chunk boundaries inside a group at g = 128)
    (1, 100, None), (3, 130, 4), (8, 1000, 20), (9, 100, 12), (16, 130, None), (33, 1000, 20), (64, 100, 4),
]


@pytest.mark.parametrize("g", [8, 64, 128, 768])
def test_ternary_tensor_core_kernel_forced_splits(cuda, monkeypatch, g):
    """The tensor-core path at forced k-splits (chunks of 1, 3 and 5
    tiles), every row tile and two batch tiles, ragged o: within 2e-4 of
    the plain version and bitwise against reruns, which also shows that
    every launch left its tickets at 0 for the next."""
    tm = importlib.import_module("repro_torch.kernels.ternary_mm")
    plan = tm.tc_plan
    gen = torch.Generator(device=cuda)
    gen.manual_seed(g)
    k = 768
    for B, o, chunk in TERNARY_CASES:
        monkeypatch.setattr(tm, "tc_plan", plan if chunk is None else functools.partial(plan, chunk=chunk))
        x, packed, scales = ternary_inputs(B, k, o, g, torch.bfloat16, torch.bfloat16, gen, cuda)
        reset_launch_counts()
        got = ternary_mm(x, packed, scales, g=g)
        again = ternary_mm(x, packed, scales, g=g)
        torch.cuda.synchronize()
        assert ternary_mm.tc_launches == 2
        msg = f"B={B} o={o} chunk={chunk}"
        torch.testing.assert_close(got, ternary_mm_plain(x, packed, scales, g=g), rtol=TOL, atol=TOL, msg=msg)
        torch.testing.assert_close(again, got, rtol=0, atol=0, msg=msg)
        for _ in range(5):
            torch.testing.assert_close(ternary_mm(x, packed, scales, g=g), got, rtol=0, atol=0, msg=msg)


@pytest.mark.parametrize("B", [1, 4, 9, 16, 64])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["tensor_cores", "group_table"])
@pytest.mark.parametrize("k,o,g", [(3072, 3072, 128), (1024, 256, 128), (776, 100, 8)], ids=["wo", "sweep", "g8"])
def test_ternary_rows_equal_solo(cuda, k, o, g, dtype, B):
    """Batch invariance on both paths: row r of a B-row K4 call equals the
    same row called alone, bit for bit (the plans do not depend on B, and a
    row sums in the same order in every n-tile and row tile)."""
    gen = torch.Generator(device=cuda)
    gen.manual_seed(B + k)
    x, packed, scales = ternary_inputs(B, k, o, g, dtype, dtype, gen, cuda)
    full = ternary_mm(x, packed, scales, g=g)
    for r in range(B):
        torch.testing.assert_close(ternary_mm(x[r : r + 1], packed, scales, g=g), full[r : r + 1],
                                   rtol=0, atol=0, msg=f"row {r} of {B}")


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["tensor_cores", "group_table"])
def test_ternary_rows_equal_solo_across_row_slabs(cuda, monkeypatch, dtype):
    """A call wider than a row slab launches once a slab (the scratch cap
    lowered here: 32-row slabs on the tensor cores, 8 on the group-table
    path, at ``wo``): each row equals the row alone, bit for bit, and the
    call counts one launch a slab (3 on either path)."""
    gt = importlib.import_module("repro_torch.kernels.grouptable")
    tm = importlib.import_module("repro_torch.kernels.ternary_mm")
    k, o, g = 3072, 3072, 128
    if dtype == torch.bfloat16:
        splits, slab, B = tm.tc_plan(k, o, g).splits, tm.MAX_ROWS, 72
    else:
        splits, slab, B = gt.plan("ternary", k, o, 2, g, dtype, dtype).splits, 8, 21
    monkeypatch.setattr(gt, "SCRATCH_CAP", slab * 4 * splits * o)
    gen = torch.Generator(device=cuda)
    gen.manual_seed(B)
    x, packed, scales = ternary_inputs(B, k, o, g, dtype, dtype, gen, cuda)
    reset_launch_counts()
    full = ternary_mm(x, packed, scales, g=g)
    assert launch_counts()["ternary_mm"] == 3
    assert ternary_mm.tc_launches == (3 if dtype == torch.bfloat16 else 0)
    torch.testing.assert_close(full, ternary_mm_plain(x, packed, scales, g=g), rtol=TOL, atol=TOL)
    for r in range(B):
        torch.testing.assert_close(ternary_mm(x[r : r + 1], packed, scales, g=g), full[r : r + 1],
                                   rtol=0, atol=0, msg=f"row {r} of {B}")


@pytest.mark.parametrize("B", [2, 4, 9, 16, 64])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "f32"])
@pytest.mark.parametrize("k,o", [(3072, 3072), (3072, 16384), (8192, 3072)], ids=["wo", "w_gate_up", "w_down"])
def test_dense_and_dequant_rows_equal_solo(cuda, k, o, dtype, B):
    """Queue 3: a dense linear's product (``utils.matmul_rows`` on decode
    rows, tiles of ``ROW_TILE``) and ``dequant_mm`` told its rows are decode
    rows give each row of a B-row call the bits of the row called alone."""
    gen = torch.Generator(device=cuda)
    gen.manual_seed(B + o)
    x = torch.randn((B, 1, k), generator=gen, device=cuda).to(dtype)
    w = (torch.randn((k, o), generator=gen, device=cuda) / np.sqrt(k)).to(dtype)
    full = matmul_rows(x, w)
    assert full.shape == (B, 1, o)
    torch.testing.assert_close(full, torch.matmul(x, w), rtol=2e-2, atol=2e-2)
    for r in range(B):
        torch.testing.assert_close(matmul_rows(x[r : r + 1], w), full[r : r + 1], rtol=0, atol=0, msg=f"dense {r}")
    packed, scales = format_planes("dequant", k, o, 4, 128, dtype, gen, cuda)
    xd = x[:, 0]
    got = dequant_mm(xd, packed, scales, g=128, token_rows=True)
    torch.testing.assert_close(got, dequant_mm_plain(xd, packed, scales, g=128), rtol=TOL, atol=TOL)
    for r in range(B):
        torch.testing.assert_close(dequant_mm(xd[r : r + 1], packed, scales, g=128, token_rows=True),
                                   got[r : r + 1], rtol=0, atol=0, msg=f"dequant {r}")
    assert ROW_TILE == 8


@pytest.mark.parametrize(
    "q,mode,slots,fmt,dtype",
    [(0, None, 3, "bcq", "float32"), (4, None, 3, "bcq", "float32"), (4, "lutgemm", 9, "bcq", "float32"),
     (0, None, 9, "bcq", "bfloat16"), (4, None, 9, "dequant", "bfloat16"), (4, None, 4, "dequant", "float32"),
     (4, None, 9, "ternary", "bfloat16"), (4, None, 3, "ternary", "float32")],
    ids=["dense", "bcq_q4", "bcq_q4_lutgemm_9slots", "dense_bf16_9slots", "dequant_bf16_9slots", "dequant_f32",
         "ternary_bf16_9slots", "ternary_f32"],
)
def test_slot_batches_match_solo_on_card(cuda, q, mode, slots, fmt, dtype):
    """Continuous batching on the GPU: greedy and sampled requests through
    the slots, each identical to its solo generate (the kernels reduce each
    row in a fixed order whatever the batch; dense and ``dequant`` products
    run decode rows in fixed tiles). Under ``impl_mode("lutgemm")`` 9 slots
    put K3 at a row tile of 8 and two batch tiles; the bf16 ternary model
    runs K4's tensor cores, the f32 one its group-table path."""
    cfg = reduced(get_config("llama3.2-3b"), d_model=256, n_kv_heads=4, d_ff=512, param_dtype=dtype,
                  compute_dtype=dtype)
    params = init_params(cfg, seed=0, device=cuda)
    if q:
        params = quantize_params(params, QuantPolicy(q=q, g=128, iters=2, fmt=fmt), device=cuda)
    eng = Engine(cfg, params, max_seq=64, device=cuda)
    rng = np.random.default_rng(0)
    reqs = [
        Request(prompt=rng.integers(0, cfg.vocab, size=int(rng.integers(4, 40))).astype(np.int32),
                max_new_tokens=int(rng.integers(3, 14)), temperature=[0.0, 1.0, 0.7][i % 3], seed=10 + i)
        for i in range(max(7, slots + 3))
    ]
    reset_launch_counts()
    with impl_mode(mode):
        sched = Scheduler(eng, n_slots=slots, chunk=4)
        for r in reqs:
            sched.submit(r)
        done = {c.rid: c for c in sched.run()}
        for r in reqs:
            solo = eng.generate(r.prompt[None], r.max_new_tokens, temperature=r.temperature, seed=r.seed)
            np.testing.assert_array_equal(done[r.rid].new_tokens, solo.tokens[0, r.prompt.size :])
    assert (launch_counts()["lutgemm"] > 0) == (mode == "lutgemm")
    assert (ternary_mm.tc_launches > 0) == (q > 0 and fmt == "ternary" and dtype == "bfloat16")
    assert (launch_counts()["dequant_materialize"] > 0) == (q > 0 and fmt == "dequant")


# -- self-speculative decoding on the card ------------------------------------

# llama3.2-3b's widths at 2 layers, bf16: the main path's shapes for every kernel
FULL_WIDTH = dict(d_model=3072, n_heads=24, n_kv_heads=8, d_ff=8192, vocab=128256,
                  param_dtype="bfloat16", compute_dtype="bfloat16")


@functools.lru_cache(maxsize=None)
def _full_width_engine(fmt):
    cfg = reduced(get_config("llama3.2-3b"), **FULL_WIDTH)
    params = init_params(cfg, seed=0, device="cuda")
    if fmt != "dense":
        params = quantize_params(params, QuantPolicy(q=4, g=128, iters=2, fmt=fmt), device="cuda")
    return Engine(cfg, params, max_seq=64, device="cuda")


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("d", [256, 3072])
def test_rmsnorm_rows_equal_solo(cuda, d, dtype):
    """``rmsnorm`` gives a row the bits of the row alone at any row count
    (``utils.row_sum``; ``torch.mean`` picks its reduction's block shape by
    the number of rows), as a (N, 1, d) decode batch and as (1, N, d)."""
    gen = torch.Generator(device=cuda)
    gen.manual_seed(0)
    x = torch.randn((64, 1, d), generator=gen, device=cuda).to(dtype)
    w = (1 + 0.1 * torch.randn((d,), generator=gen, device=cuda)).to(dtype)
    alone = torch.cat([rmsnorm(w, x[i : i + 1]) for i in range(64)])
    for n in (1, 2, 4, 5, 9, 16, 20, 45, 64):
        assert torch.equal(rmsnorm(w, x[:n]), alone[:n]), n
        assert torch.equal(rmsnorm(w, x[:n].reshape(1, n, d)).reshape(n, 1, d), alone[:n]), n


@pytest.mark.parametrize("fmt,mode", [("bcq", None), ("bcq", "lutgemm"), ("ternary", None), ("dense", None)],
                         ids=["bcq", "bcq_lutgemm", "ternary", "dense"])
def test_chunked_verify_equals_step_decode_on_card(cuda, fmt, mode):
    """The verify forward of 5 tokens against a filled cache gives each
    position the bits of a single-token decode step there (full widths,
    bf16, every linear on its kernel: K1/K2, K3, K4's tensor cores, or the
    dense row tiles)."""
    eng = _full_width_engine(fmt)
    cfg = eng.cfg
    rng = np.random.default_rng(1)
    prompt = torch.as_tensor(rng.integers(0, cfg.vocab, (4, 12)), device=cuda)
    chunk = torch.as_tensor(rng.integers(0, cfg.vocab, (4, 5)), device=cuda)
    pos = torch.tensor([12, 12, 12, 12], device=cuda)
    with impl_mode(mode):
        _, c_chunk = eng.prefill(prompt, eng._make_cache(4))
        _, c_step = eng.prefill(prompt, eng._make_cache(4))
        got, _ = forward(cfg, eng.params, tokens=chunk, cache=c_chunk, pos=pos, logits_mode="all",
                         chunked_decode=True)
        steps = []
        for t in range(5):
            lg, c_step = eng.decode(chunk[:, t : t + 1], c_step, pos + t)
            steps.append(lg)
    assert torch.equal(got, torch.stack(steps, dim=1))


def test_dense_speculation_accepts_every_proposal_on_card(cuda):
    """A dense model drafts with itself: the chunked verify gives the draft
    steps' bits, so every proposal is accepted (16 tokens: the first, then
    three chunks of 5, so no acceptance falls past the cut uncounted)."""
    eng = _full_width_engine("dense")
    prompts = np.random.default_rng(2).integers(0, eng.cfg.vocab, (4, 8))
    spec = eng.generate(prompts, 16, speculate=SpecConfig(2, 4))
    assert spec.spec_stats["accept_rate"] == 1.0 and spec.spec_stats["chunks"] == 3
    np.testing.assert_array_equal(spec.tokens, eng.generate(prompts, 16).tokens)


@pytest.mark.parametrize("fmt,mode,q_draft", [("bcq", None, 2), ("bcq", "lutgemm", 2), ("ternary", None, 1)],
                         ids=["bcq", "bcq_lutgemm", "ternary"])
def test_spec_greedy_equals_plain_on_card(cuda, fmt, mode, q_draft):
    """Speculative greedy == plain greedy token for token, in bf16 at full
    widths: drafts at q' planes on K1/K2 (K3 under ``lutgemm``), the verify
    on K1/K2, K3 or K4."""
    eng = _full_width_engine(fmt)
    prompts = np.random.default_rng(3).integers(0, eng.cfg.vocab, (4, 8))
    reset_launch_counts()
    with impl_mode(mode):
        spec = eng.generate(prompts, 12, speculate=SpecConfig(q_draft, 4))
        plain = eng.generate(prompts, 12)
    np.testing.assert_array_equal(spec.tokens, plain.tokens)
    counts = launch_counts()
    assert counts["flash_attention"] == 3 * eng.cfg.n_layers  # target + draft prefill, plain prefill
    if fmt == "ternary":
        assert counts["bcq_mm"] > 0 and ternary_mm.tc_launches == counts["ternary_mm"] > 0
    assert (counts["lutgemm"] > 0) == (mode == "lutgemm")


@pytest.mark.parametrize("slots", [4, 9])
def test_spec_slot_batches_match_solo_on_card(cuda, slots):
    """Speculative slots at full widths: greedy requests and sampled requests
    that opt out give the bits of their solo plain ``generate``."""
    eng = _full_width_engine("bcq")
    rng = np.random.default_rng(4)
    reqs = [
        Request(prompt=rng.integers(0, eng.cfg.vocab, size=int(rng.integers(4, 30))).astype(np.int32),
                max_new_tokens=int(rng.integers(3, 14)), temperature=[0.0, 1.0, 0.7][i % 3], seed=10 + i,
                speculate=i % 3 != 1)
        for i in range(slots + 3)
    ]
    sched = Scheduler(eng, n_slots=slots, chunk=2, speculate=SpecConfig(2, 4))
    for r in reqs:
        sched.submit(r)
    done = {c.rid: c for c in sched.run()}
    for r in reqs:
        assert done[r.rid].new_tokens.shape == (r.max_new_tokens,)
        if r.temperature == 0.0 or not r.speculate:
            solo = eng.generate(r.prompt[None], r.max_new_tokens, temperature=r.temperature, seed=r.seed)
            np.testing.assert_array_equal(done[r.rid].new_tokens, solo.tokens[0, r.prompt.size :])


# -- prefix cache and chunked prefill on the card ------------------------------

OFFSET_Q_STARTS = [0, 1, 100, 127, 128, 1000, 8000]
OFFSET_SQ = [1, 7, 64, 129, 512]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("sq", OFFSET_SQ)
@pytest.mark.parametrize("q_start", OFFSET_Q_STARTS)
def test_flash_attention_offset_matches_plain_and_cold_rows(cuda, q_start, sq, dtype):
    """K8's offset entry at llama3.2-3b's heads: queries at ``q_start ..``
    over a KV cache view ``cache[:, :q_start + Sq]`` whose later rows hold
    NaN (the key tiles past the chunk must come from the TMA's zero fill, or
    the f32 kernel's bound, never the cache) against the plain version
    (f32 2e-4; bf16 3e-2 and ``BF16_ROW_TOL`` a row); each row equal, bit for
    bit, to the same row of one cold launch over the whole sequence; the same
    bits on a rerun; the view read in place."""
    H, Hkv, Dh = 24, 8, 128
    sk = q_start + sq
    gen = torch.Generator(device=cuda)
    gen.manual_seed(q_start * 7 + sq)
    q_all = torch.randn((1, sk, H, Dh), generator=gen, device=cuda).to(dtype)
    cache = torch.full((2, 1, sk + 200, Hkv, Dh), float("nan"), device=cuda, dtype=dtype)
    cache[:, :, :sk] = torch.randn((2, 1, sk, Hkv, Dh), generator=gen, device=cuda).to(dtype)
    k, v = cache[0, :, :sk], cache[1, :, :sk]
    q = q_all[:, q_start:]
    flash_attention.copies = 0
    reset_launch_counts()
    got = flash_attention(q, k, v, q_start)
    torch.cuda.synchronize()
    assert flash_attention.copies == 0
    assert flash_attention.launches == 1 and flash_attention.offset_launches == (1 if q_start else 0)
    assert got.shape == (1, sq, H, Dh) and got.dtype == dtype and bool(torch.isfinite(got).all())
    plain = flash_attention_plain(q, k, v, q_start)
    tol = 2e-4 if dtype == torch.float32 else 3e-2
    torch.testing.assert_close(got.float(), plain.float(), rtol=tol, atol=tol)
    if dtype == torch.bfloat16:
        assert row_rel_err(got, plain) <= BF16_ROW_TOL
    cold = flash_attention(q_all, k.contiguous(), v.contiguous())
    torch.testing.assert_close(got, cold[:, q_start:], rtol=0, atol=0)
    torch.testing.assert_close(flash_attention(q, k, v, q_start), got, rtol=0, atol=0)


def test_prefill_chunk_reads_the_cache_in_place(cuda):
    """A prompt chunk at pos > 0 hands K8 views of the layer's cache rows
    (``cache[:, :pos + s]``), which its TMA reads without a copy."""
    eng = _full_width_engine("bcq")
    prompt = torch.as_tensor(np.random.default_rng(3).integers(0, eng.cfg.vocab, (1, 40)), device=cuda)
    cache = eng._make_cache(1)
    forward(eng.cfg, eng.params, tokens=prompt[:, :17], cache=cache, pos=0, logits_mode="last")
    flash_attention.copies = 0
    reset_launch_counts()
    forward(eng.cfg, eng.params, tokens=prompt[:, 17:], cache=cache, pos=17, logits_mode="last")
    assert flash_attention.offset_launches == eng.cfg.n_layers and flash_attention.copies == 0


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "f32"])
@pytest.mark.parametrize("k,o", [(3072, 3072), (3072, 16384), (8192, 3072)], ids=["wo", "w_gate_up", "w_down"])
def test_prompt_rows_equal_in_any_chunk(cuda, k, o, dtype):
    """A prompt's rows run in tiles of ``PROMPT_TILE`` (dense linears and the
    ``dequant`` GEMM): the rows of a 544-row call equal the same rows in a
    32-row call, bitwise, wherever the 32 rows start (tile-aligned or not)."""
    gen = torch.Generator(device=cuda)
    gen.manual_seed(o + k)
    x = torch.randn((1, 544, k), generator=gen, device=cuda).to(dtype)
    w = (torch.randn((k, o), generator=gen, device=cuda) / np.sqrt(k)).to(dtype)
    full = matmul_rows(x, w)
    torch.testing.assert_close(full, torch.matmul(x, w), rtol=2e-2, atol=2e-2)
    packed, scales = format_planes("dequant", k, o, 4, 128, dtype, gen, cuda)
    dfull = dequant_mm(x[0], packed, scales, g=128)
    torch.testing.assert_close(dfull, dequant_mm_plain(x[0], packed, scales, g=128), rtol=TOL, atol=TOL)
    for start in (0, 512, 500, 77):
        part = x[:, start : start + 32]
        torch.testing.assert_close(matmul_rows(part, w), full[:, start : start + 32], rtol=0, atol=0,
                                   msg=f"dense rows {start}..")
        torch.testing.assert_close(dequant_mm(part[0], packed, scales, g=128), dfull[start : start + 32],
                                   rtol=0, atol=0, msg=f"dequant rows {start}..")


@pytest.mark.parametrize("name", ["bcq_mm", "bcq_mm_fused", "lutgemm", "ternary_mm"])
def test_quantized_kernels_rows_equal_at_prompt_widths(cuda, name):
    """K1/K2, K3 and K4 (bf16: its tensor cores) at prompt widths: each row
    of a 544-row call at ``wo`` equals the same row in a 32- or 128-row
    call, wherever it starts, bitwise."""
    k, o, q, g = 3072, 3072, 4, 128
    fmt = "ternary" if name == "ternary_mm" else "bcq"
    fn = {"bcq_mm": bcq_mm, "bcq_mm_fused": bcq_mm_fused, "lutgemm": lutgemm, "ternary_mm": ternary_mm}[name]
    gen = torch.Generator(device=cuda)
    gen.manual_seed(11)
    packed, scales = format_planes(fmt, k, o, 2 if fmt == "ternary" else q, g, torch.bfloat16, gen, cuda)

    def call(x):
        if name == "bcq_mm_fused":
            return torch.cat(fn(x, packed, scales, g=g, out_dims=(1024, 2048)), dim=-1)
        return fn(x, packed, scales, g=g)

    x = torch.randn((544, k), generator=gen, device=cuda).to(torch.bfloat16)
    full = call(x)
    for n, start in ((32, 0), (32, 512), (32, 77), (128, 0), (128, 300)):
        torch.testing.assert_close(call(x[start : start + n]), full[start : start + n], rtol=0, atol=0,
                                   msg=f"{name} rows {start}..{start + n}")


def _admission(eng, prompt, chunk=None):
    """One admission into a fresh 1-slot batch (in ``chunk``-token pieces,
    or whole) → (its last-prompt-position logits, 4 greedy decode tokens)."""
    slots = eng.init_slots(1)
    p = eng.begin_admission(prompt, max_new_tokens=5, chunked=chunk is not None)
    while not p.done:
        eng.advance_admission(p, chunk)
    eng.finish_admission(slots, 0, p)
    logits = slots["logits"][0].clone()
    toks, _, _ = eng.decode_slots(slots, 4)
    return logits, toks[0]


@pytest.mark.parametrize("fmt,mode", [("bcq", None), ("bcq", "lutgemm"), ("ternary", None), ("dense", None)],
                         ids=["bcq", "bcq_lutgemm", "ternary", "dense"])
def test_warm_and_chunked_equal_cold_on_card(cuda, fmt, mode):
    """2 full-width layers, bf16: a warm admission (the 160-token shared
    prefix installed from the cache, only the tail prefilled, at q_start =
    160) and a chunked one (chunks of 48, so chunk starts straddle K8's
    128-key tiles) give the last-position logits and the greedy tokens of
    the cold whole-shot admission, bit for bit."""
    from repro_torch.infer import PrefixCache

    base = _full_width_engine(fmt)
    cold = Engine(base.cfg, base.params, max_seq=256, fuse=False, device=cuda)
    warm = Engine(base.cfg, base.params, max_seq=256, fuse=False, device=cuda,
                  prefix_cache=PrefixCache(block_tokens=16, max_bytes=1 << 30))
    rng = np.random.default_rng(9)
    shared = rng.integers(0, base.cfg.vocab, 160)
    prompts = [np.concatenate([shared, rng.integers(0, base.cfg.vocab, n)]).astype(np.int32) for n in (7, 30, 1)]
    with impl_mode(mode):
        for i, prompt in enumerate(prompts):
            want_l, want_t = _admission(cold, prompt)
            got_l, got_t = _admission(warm, prompt)  # the first prompt commits, the others hit
            hit = warm.take_prefix_handle().length
            assert hit == (0 if i == 0 else 160)
            assert torch.equal(got_l, want_l), (i, "warm")
            np.testing.assert_array_equal(got_t, want_t)
            ch_l, ch_t = _admission(cold, prompt, chunk=48)
            assert torch.equal(ch_l, want_l), (i, "chunked")
            np.testing.assert_array_equal(ch_t, want_t)
        again_l, _ = _admission(warm, prompts[0])  # now a hit of its own 160 + 0 tail blocks
        assert torch.equal(again_l, _admission(cold, prompts[0])[0])
    pc = warm.prefix_cache
    assert pc.pinned == 0 and pc.counters["hits"] + pc.counters["misses"] == pc.counters["commits"]


# -- captured decode steps and the int8 KV cache on the card -------------------

GRAPH_FORMATS = ["dense", "bcq", "uniform", "dequant", "ternary", "codebook"]


@functools.lru_cache(maxsize=None)
def _cache_engine(fmt, kv):
    """``_full_width_engine(fmt)``'s weights behind a cache of ``kv``."""
    base = _full_width_engine(fmt)
    cfg = dataclasses.replace(base.cfg, kv_cache_dtype=kv)
    return Engine(cfg, base.params, max_seq=64, fuse=False, device="cuda")


def _step_logits(eng, prompts, n, captured):
    """Prefill, then ``n`` greedy steps: through the engine's decode graph,
    or eagerly into a fresh cache at scalar positions → (B, n, V) logits."""
    tokens = torch.as_tensor(prompts, device="cuda").long()
    graph = eng._generate_graph(tokens.shape[0]) if captured else None
    logits, cache = eng.prefill(tokens, graph.cache if captured else eng._make_cache(tokens.shape[0]))
    out = []
    for step in range(n):
        tok = torch.argmax(logits, dim=-1)
        if captured:
            logits = graph(tok, tokens.shape[1] + step).clone()
        else:
            logits, cache = eng.decode(tok[:, None], cache, tokens.shape[1] + step)
        out.append(logits)
    return torch.stack(out, dim=1)


@pytest.mark.parametrize("kv", ["bfloat16", "int8"])
@pytest.mark.parametrize("fmt,mode", [(f, None) for f in GRAPH_FORMATS] + [("bcq", "lutgemm")],
                         ids=GRAPH_FORMATS + ["bcq_lutgemm"])
def test_graph_generate_equals_eager_on_card(cuda, fmt, mode, kv):
    """``generate`` (a replayed graph) and ``generate(scan=False)`` (the eager
    loop): the same tokens and, step by step, the same logits, bit for bit;
    the census counts the replays' launches as the eager loop's."""
    eng = _cache_engine(fmt, kv)
    prompts = np.random.default_rng(5).integers(0, eng.cfg.vocab, (4, 9))
    with impl_mode(mode):
        eager_l = _step_logits(eng, prompts, 6, False)
        graph_l = _step_logits(eng, prompts, 6, True)
        assert torch.equal(graph_l, eager_l)
        reset_launch_counts()
        eager = eng.generate(prompts, 7, temperature=0.8, seed=1, scan=False)
        eager_counts = launch_counts()
        reset_launch_counts()
        graphed = eng.generate(prompts, 7, temperature=0.8, seed=1)
        assert launch_counts() == eager_counts
    np.testing.assert_array_equal(graphed.tokens, eager.tokens)
    graph = eng._graphs[(4, mode)]
    assert graph.graph is not None and graph.replays >= 6 + 5


@pytest.mark.parametrize("kv", ["bfloat16", "int8"])
@pytest.mark.parametrize("fmt", ["bcq", "dequant", "dense"])
def test_graph_slots_equal_the_eager_slot_loop_on_card(cuda, fmt, kv, monkeypatch):
    """Ten requests (temperatures 0, 1.0, 0.7) through 4 slots: the slot
    graph and the eager slot loop emit the same tokens and count the same
    launches."""
    from repro_torch.infer import engine as engine_mod

    eng = _cache_engine(fmt, kv)

    def run():
        rng = np.random.default_rng(6)
        reqs = [Request(prompt=rng.integers(0, eng.cfg.vocab, size=int(rng.integers(4, 30))).astype(np.int32),
                        max_new_tokens=int(rng.integers(3, 14)), temperature=[0.0, 1.0, 0.7][i % 3], seed=i)
                for i in range(10)]
        reset_launch_counts()
        sched = Scheduler(eng, n_slots=4, chunk=4)
        for r in reqs:
            sched.submit(r)
        return {c.rid: c.new_tokens.tolist() for c in sched.run()}, launch_counts(), sched

    graphed, counts, sched = run()
    assert sched.slots["graphs"][None].replays > 0
    monkeypatch.setattr(engine_mod, "_EAGER_SLOT_STEPS", True)
    eager, eager_counts, _ = run()
    assert graphed == eager and counts == eager_counts


def test_graph_refuses_another_impl_mode_on_card(cuda):
    eng = _cache_engine("bcq", "bfloat16")
    prompts = np.random.default_rng(7).integers(0, eng.cfg.vocab, (2, 5))
    eng.generate(prompts, 4)
    graph = eng._graphs[(2, None)]
    assert graph.graph is not None
    with impl_mode("lutgemm"), pytest.raises(RuntimeError, match="impl_mode"):
        graph(torch.zeros(2, dtype=torch.long, device=cuda), 5)
    with impl_mode("lutgemm"):
        eng.generate(prompts, 4)
    assert eng._graphs[(2, "lutgemm")] is not graph


def test_generate_keeps_one_width_on_card(cuda):
    """An engine that ``generate``s at B = 8, then B = 1, then B = 8 holds one
    width's cache and graphs at a time: at a switch the old width's cache and
    graph are freed (nothing else holds them) and later captures take a new
    pool, while a slot graph captured in the engine's first pool keeps
    replaying; every run's tokens equal the eager loop's."""
    import gc
    import weakref

    base = _cache_engine("bcq", "bfloat16")
    eng = Engine(base.cfg, base.params, max_seq=256, fuse=False, device=cuda)
    rng = np.random.default_rng(11)
    prompts = rng.integers(0, eng.cfg.vocab, (8, 5))
    reqs = [Request(prompt=rng.integers(0, eng.cfg.vocab, size=6).astype(np.int32), max_new_tokens=5,
                    temperature=0.0, seed=i) for i in range(3)]

    def serve():
        sched = Scheduler(eng, n_slots=2, chunk=4)
        for r in reqs:
            sched.submit(r)
        return {c.rid: c.new_tokens.tolist() for c in sched.run()}, sched

    served, sched = serve()
    held = []
    for rows in (8, 1, 8):
        got = eng.generate(prompts[:rows], 4)
        np.testing.assert_array_equal(got.tokens, eng.generate(prompts[:rows], 4, scan=False).tokens)
        assert list(eng._caches) == [rows] and {key[0] for key in eng._graphs} == {rows}
        gc.collect()
        assert all(ref() is None for ref in held)
        (graph,) = eng._graphs.values()
        assert graph.graph is not None
        held = [weakref.ref(graph), weakref.ref(eng._caches[rows]["stages"][0]["b0"]["k"])]
        del graph
    assert sched.slots["graphs"][None].replays > 0
    assert serve()[0] == served


def test_graph_capture_failure_raises_on_card(cuda, monkeypatch):
    """A step that cannot be captured (here a host read inside the decode
    attention) makes ``generate`` raise at capture; nothing runs eagerly in
    its place."""
    from repro_torch.models import layers

    eng = Engine(_cache_engine("dense", "bfloat16").cfg, _full_width_engine("dense").params, max_seq=64,
                 fuse=False, device=cuda)
    real = layers._sdpa_decode

    def host_read(q, ck, cv, mask):
        q.float().sum().item()
        return real(q, ck, cv, mask)

    monkeypatch.setattr(layers, "_sdpa_decode", host_read)
    prompts = np.random.default_rng(8).integers(0, eng.cfg.vocab, (2, 5))
    with pytest.raises(RuntimeError):
        eng.generate(prompts, 4)
    graph = eng._graphs[(2, None)]
    assert graph.warmed and graph.graph is None and graph.replays == 0


@pytest.mark.parametrize("fmt", ["bcq", "dense"])
def test_int8_slots_and_speculation_exact_on_card(cuda, fmt):
    """Under the int8 cache, at full widths: every greedy and sampled slot
    request equals its solo ``generate`` bit for bit, and (bcq) greedy
    speculative output equals plain output."""
    eng = _cache_engine(fmt, "int8")
    rng = np.random.default_rng(9)
    reqs = [Request(prompt=rng.integers(0, eng.cfg.vocab, size=int(rng.integers(4, 30))).astype(np.int32),
                    max_new_tokens=int(rng.integers(3, 14)), temperature=[0.0, 1.0, 0.7][i % 3], seed=10 + i)
            for i in range(7)]
    sched = Scheduler(eng, n_slots=4, chunk=4)
    for r in reqs:
        sched.submit(r)
    done = {c.rid: c for c in sched.run()}
    for r in reqs:
        solo = eng.generate(r.prompt[None], r.max_new_tokens, temperature=r.temperature, seed=r.seed)
        np.testing.assert_array_equal(done[r.rid].new_tokens, solo.tokens[0, r.prompt.size :])
    prompts = rng.integers(0, eng.cfg.vocab, (4, 8))
    spec = SpecConfig(2, 4) if fmt == "bcq" else None
    if spec is not None:
        np.testing.assert_array_equal(eng.generate(prompts, 12, speculate=spec).tokens,
                                      eng.generate(prompts, 12).tokens)


# -- the serving session and the launch census on the card ---------------------


def _session_streams(eng, reqs, *, observe, tracer=None, arrive_every=0.0):
    """``reqs`` through a 4-slot ``ServeSession`` on ``eng`` (asyncio, no
    sockets); with ``arrive_every`` the requests arrive that many seconds
    apart while the first ones are served → (session, [tokens], [terminal
    events])."""
    import asyncio

    from repro_torch.launch.server import ServeSession

    async def run():
        sess = ServeSession(eng, n_slots=4, chunk=4, observe=observe, tracer=tracer)
        async with sess:
            streams = []
            for r in reqs:
                streams.append(await sess.submit_stream(dataclasses.replace(r, rid=None)))
                await asyncio.sleep(arrive_every)
            out = await asyncio.gather(*(s.drain() for s in streams))
        return sess, [toks for toks, _ in out], [last for _, last in out]

    return asyncio.run(asyncio.wait_for(run(), 300))


def _session_requests(vocab, n=10, seed=8):
    rng = np.random.default_rng(seed)
    return [Request(prompt=rng.integers(0, vocab, size=int(rng.integers(4, 30))).astype(np.int32),
                    max_new_tokens=int(rng.integers(3, 14)), temperature=[0.0, 1.0, 0.7][i % 3], seed=i)
            for i in range(n)]


def test_session_captures_on_the_pump_thread_while_requests_arrive(cuda, monkeypatch):
    """A ServeSession's first decode chunk warms up and captures its slot
    graph on the pump thread while the event loop keeps submitting requests
    (one every 20 ms); every stream, greedy and sampled, equals the
    request's solo ``generate`` bit for bit, and the chunks replay the
    graph."""
    import threading

    from repro_torch.infer.graphs import DecodeGraph

    threads = []
    real = DecodeGraph._capture

    def capture(graph):
        threads.append(threading.current_thread().name)
        real(graph)

    monkeypatch.setattr(DecodeGraph, "_capture", capture)
    base = _full_width_engine("bcq")
    eng = Engine(base.cfg, base.params, max_seq=64, fuse=False, device=cuda)
    reqs = _session_requests(eng.cfg.vocab)
    sess, streams, lasts = _session_streams(eng, reqs, observe=False, arrive_every=0.02)
    assert threads == ["repro-serve-pump"]
    assert sess.sched.slots["graphs"][None].replays > 0
    assert [e.kind for e in lasts] == ["done"] * len(reqs)
    for r, toks in zip(reqs, streams):
        solo = eng.generate(r.prompt[None], r.max_new_tokens, temperature=r.temperature, seed=r.seed)
        assert toks == solo.tokens[0, r.prompt.size:].tolist()


def test_instrumented_session_equals_uninstrumented_on_card(cuda):
    """A session with a tracer on the engine and the scheduler and a
    metrics registry streams the tokens of a session with neither, bit for
    bit; its trace is valid and its counters agree with the scheduler's."""
    from repro_torch.obs import Tracer, validate_chrome_trace
    from repro_torch.obs.metrics import counters_agree

    base = _full_width_engine("bcq")
    tracer = Tracer()
    traced = Engine(base.cfg, base.params, max_seq=64, fuse=False, device=cuda, tracer=tracer)
    plain = Engine(base.cfg, base.params, max_seq=64, fuse=False, device=cuda)
    reqs = _session_requests(base.cfg.vocab, seed=9)
    sess, observed, _ = _session_streams(traced, reqs, observe=True, tracer=tracer)
    dark, unobserved, _ = _session_streams(plain, reqs, observe=False)
    assert observed == unobserved and dark.tracer is None
    assert validate_chrome_trace(sess.trace_json()) == []
    assert counters_agree(sess.registry, sess.sched.counters) == []
    assert {"engine/prefill", "engine/admit", "engine/scan_decode"} <= {e[1] for e in tracer.events()}


def test_calls_wider_than_a_slab_count_a_launch_a_slab_on_card(cuda):
    """The census counts launches: a K1 call and a K4 call (group-table and
    tensor-core paths) 8 rows wider than their row slab at ``wo`` launch
    twice and add 2 to ``launches`` (K4's tensor-core count too); each is
    held to its plain version."""
    gt = importlib.import_module("repro_torch.kernels.grouptable")
    tm = importlib.import_module("repro_torch.kernels.ternary_mm")
    k, o, g = 3072, 3072, 128
    gen = torch.Generator(device=cuda)
    gen.manual_seed(11)
    bf16, f32 = torch.bfloat16, torch.float32
    slab = gt.plan("bcq", k, o, 4, g, bf16, bf16).slab_rows(1 << 20)
    x, packed, scales = grouptable_inputs("bcq_mm", slab + 8, k, o, 4, g, bf16, gen, cuda)
    reset_launch_counts()
    y = bcq_mm(x, packed, scales, g=g)
    assert launch_counts()["bcq_mm"] == 2
    torch.testing.assert_close(y, bcq_mm_plain(x, packed, scales, g=g), rtol=TOL, atol=TOL)
    for dtype, slab in ((f32, gt.plan("ternary", k, o, 2, g, f32, f32).slab_rows(1 << 20)),
                        (bf16, tm.tc_plan(k, o, g).slab_rows(1 << 20))):
        x, packed, scales = ternary_inputs(slab + 8, k, o, g, dtype, dtype, gen, cuda)
        reset_launch_counts()
        y = ternary_mm(x, packed, scales, g=g)
        assert launch_counts()["ternary_mm"] == 2
        assert ternary_mm.tc_launches == (2 if dtype == bf16 else 0)
        torch.testing.assert_close(y, ternary_mm_plain(x, packed, scales, g=g), rtol=TOL, atol=TOL)


def test_prometheus_census_equals_launch_counts_on_card(cuda):
    """After a session on the card, the scrape's ``kernel_launches_total``
    (and its tensor-core, offset and ref-oracle kin) equals the census,
    replays of the slot graph included."""
    from repro_torch.kernels import qmatmul
    from repro_torch.obs import parse_prometheus

    base = _full_width_engine("ternary")
    eng = Engine(base.cfg, base.params, max_seq=64, fuse=False, device=cuda)
    reset_launch_counts()
    sess, _, lasts = _session_streams(eng, _session_requests(eng.cfg.vocab, n=6, seed=10), observe=True)
    assert [e.kind for e in lasts] == ["done"] * 6
    samples = parse_prometheus(sess.prometheus())
    counts = launch_counts()
    assert {ls["kernel"]: v for ls, v in samples["kernel_launches_total"]} == counts
    assert counts["ternary_mm"] > 0 and counts["flash_attention"] > 0
    assert samples["kernel_tc_launches_total"] == [({"kernel": "ternary_mm"}, float(ternary_mm.tc_launches))]
    assert samples["kernel_offset_launches_total"] == [
        ({"kernel": "flash_attention"}, float(flash_attention.offset_launches))]
    assert samples["qmatmul_ref_calls_total"] == [({}, float(qmatmul.ref_calls))]
    assert sess.sched.slots["graphs"][None].replays > 0


def test_engine_with_graphs_is_freed_without_the_cycle_collector_on_card(cuda):
    """An engine whose ``generate`` captured a decode graph is freed when its
    last reference goes, with the cycle collector off: no reference cycle
    keeps a CUDA graph alive until a collection that might run during
    another capture (which a graph destroyed mid-capture would break)."""
    import gc
    import weakref

    base = _full_width_engine("bcq")
    gc.collect()
    gc.disable()
    try:
        eng = Engine(base.cfg, base.params, max_seq=64, fuse=False, device=cuda)
        eng.generate(np.random.default_rng(12).integers(0, eng.cfg.vocab, (2, 5)), 4)
        graph = weakref.ref(eng._graphs[(2, None)])
        assert graph().graph is not None
        engine = weakref.ref(eng)
        del eng
        assert engine() is None and graph() is None
    finally:
        gc.enable()
