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
    bit for bit, and the call counts once."""
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
        assert launch_counts()[name] == 1
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
    call counts once."""
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
    assert launch_counts()["ternary_mm"] == 1
    assert ternary_mm.tc_launches == (1 if dtype == torch.bfloat16 else 0)
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
