"""Port parity for the uniform, dequant, ternary and codebook formats, their
kernels' plain versions and the qmatmul dispatch, against the JAX package.

Inputs are made with numpy from a seed and handed to both packages.
Tolerances:
- dequantize of JAX-packed planes and scales: bit for bit (same f32
  arithmetic, a product then a sum, elementwise);
- quantize: packed planes bit for bit for every format (the rounding rule
  is half to even in both, and no test weight lands within an ulp of a
  rounding boundary or a ternary threshold); uniform scales bit for bit;
  ternary alpha and codebook centroids within 1e-5 relative in f32 (means
  and cluster sums add the same terms in another order), bit for bit
  once rounded to bf16;
- kernels' plain versions vs JAX ``Format.dequantize`` followed by a dot:
  rtol = atol = 2e-4 with f32 x, 2e-2 with bf16 x (the reference's own,
  tests/test_kernels.py);
- ``dequant_materialize_plain`` vs the JAX kernel in interpret mode: bit
  for bit in f32 with bf16 scales (see that test for f32 scales).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_helpers  # noqa: F401  (one torch thread per test worker)
from repro.core import quantize_tensor as jquantize_tensor
from repro.core.formats import get_format as jget_format
from repro.kernels import qmatmul as jqmatmul
from repro.kernels.dequant_mm import dequant_materialize as jdequant_materialize
from repro.quant import QuantPolicy as JPolicy
from repro_torch.core import formats as tformats
from repro_torch.core.formats import format_names, get_format
from repro_torch.core.qtensor import QuantizedTensor, quantize_tensor
from repro_torch.kernels import (
    codebook_mm,
    codebook_mm_plain,
    dequant_materialize,
    dequant_materialize_plain,
    dequant_mm,
    dequant_mm_plain,
    launch_counts,
    qmatmul,
    ternary_mm,
    ternary_mm_plain,
    uniform_mm,
    uniform_mm_plain,
)
from repro_torch.quant import QuantPolicy

NEW_FORMATS = ("uniform", "dequant", "ternary", "codebook")
SWEEP = [  # (B, k, o, q, g), the reference's kernel sweep
    (1, 512, 256, 2, 64),
    (8, 512, 128, 4, 512),
    (8, 1024, 256, 3, 128),
    (16, 512, 384, 1, 8),
    (4, 1024, 128, 5, 1024),
    (2, 2048, 256, 2, 2048),
]
TOL = {"float32": 2e-4, "bfloat16": 2e-2}
KERNELS = {  # format: (wrapper, plain version, impl name)
    "uniform": (uniform_mm, uniform_mm_plain, "uniform_mm"),
    "dequant": (dequant_mm, dequant_mm_plain, "dequant_mm"),
    "ternary": (ternary_mm, ternary_mm_plain, "ternary_mm"),
    "codebook": (codebook_mm, codebook_mm_plain, "codebook_mm"),
}


def _t(a):
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(np.array(a.view(np.uint16))).view(torch.bfloat16)
    return torch.from_numpy(np.array(a))


def _port_qt(jqt) -> QuantizedTensor:
    return QuantizedTensor(
        packed=_t(jqt.packed), scales=_t(jqt.scales), g=jqt.g, k=jqt.k, o=jqt.o, fmt=jqt.fmt
    )


def _jq(w, q, g, fmt, *, method="alternating", scale_dtype=jnp.float32, iters=3):
    return jquantize_tensor(
        jnp.asarray(w), q, g, iters=iters, scale_dtype=scale_dtype, method=method, fmt=fmt
    )


@pytest.mark.parametrize("scale_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("fmt,q,g,method", [
    ("uniform", 4, 128, "alternating"),
    ("uniform", 3, 64, "alternating"),
    ("dequant", 2, 32, "alternating"),
    ("ternary", 4, 64, "alternating"),
    ("codebook", 3, 64, "kmeans"),
    ("codebook", 4, 128, "nf4"),
])
def test_dequantize_of_jax_packed_matches(rng, fmt, q, g, method, scale_dtype):
    w = rng.standard_normal((256, 96)).astype(np.float32)
    jqt = _jq(w, q, g, fmt, method=method, scale_dtype=jnp.dtype(scale_dtype))
    tqt = _port_qt(jqt)
    np.testing.assert_array_equal(tqt.dequantize().numpy(), np.asarray(jqt.dequantize()))


@pytest.mark.parametrize("scale_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("fmt,q,g,method,iters", [
    ("uniform", 1, 8, "alternating", 1),
    ("uniform", 4, 128, "alternating", 1),
    ("uniform", 8, 64, "alternating", 1),
    ("ternary", 4, 64, "alternating", 3),
    ("ternary", 2, 128, "greedy", 0),
    ("codebook", 2, 64, "kmeans", 3),
    ("codebook", 4, 128, "alternating", 4),
    ("codebook", 4, 32, "nf4", 1),
])
def test_quantize_matches_jax(rng, fmt, q, g, method, iters, scale_dtype):
    """Planes bit for bit; scales as the module docstring states."""
    w = rng.standard_normal((512, 160)).astype(np.float32)
    sd = getattr(torch, scale_dtype)
    jqt = _jq(w, q, g, fmt, method=method, scale_dtype=jnp.dtype(scale_dtype), iters=iters)
    tqt = quantize_tensor(torch.from_numpy(w), q, g, iters=iters, scale_dtype=sd, method=method, fmt=fmt)
    assert tqt.fmt == fmt and tuple(tqt.packed.shape) == jqt.packed.shape
    assert tuple(tqt.scales.shape) == jqt.scales.shape and tqt.scales.dtype == sd
    np.testing.assert_array_equal(tqt.packed.numpy(), np.asarray(jqt.packed))
    got, want = tqt.scales.float().numpy(), np.asarray(jqt.scales, np.float32)
    if fmt == "uniform" or sd == torch.bfloat16 or method == "nf4":
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=0)
    jerr = np.linalg.norm(w - np.asarray(jqt.dequantize()))
    terr = np.linalg.norm(w - tqt.dequantize().numpy())
    assert abs(terr - jerr) <= 1e-5 * jerr


def test_codebook_column_chunks_give_the_same_result(rng, monkeypatch):
    """Chunking the k-means along o (bounded memory) changes no code and
    moves a centroid by at most the order of its cluster sum (1e-5 relative)."""
    w = torch.from_numpy(rng.standard_normal((256, 96)).astype(np.float32))
    whole = quantize_tensor(w, 3, 64, iters=3, scale_dtype=torch.float32, fmt="codebook")
    monkeypatch.setattr(tformats, "_KMEANS_BLOCK_ELEMS", 256 * 8 * 7)  # 7-column chunks
    chunked = quantize_tensor(w, 3, 64, iters=3, scale_dtype=torch.float32, fmt="codebook")
    torch.testing.assert_close(chunked.packed, whole.packed, rtol=0, atol=0)
    torch.testing.assert_close(chunked.scales, whole.scales, rtol=1e-5, atol=0)


def test_codebook_quantile_init_matches_jax(rng):
    grouped = rng.standard_normal((3, 64, 40)).astype(np.float32)
    probs = (np.arange(16, dtype=np.float32) + 0.5) / 16
    want = np.moveaxis(np.asarray(jnp.quantile(jnp.asarray(grouped), jnp.asarray(probs), axis=1)), 0, 1)
    got = tformats._quantile_linear(torch.from_numpy(grouped), torch.from_numpy(probs)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)


def test_codebook_nf4_needs_q4():
    with pytest.raises(ValueError, match="q=4"):
        quantize_tensor(torch.zeros((128, 8)), 3, 64, method="nf4", fmt="codebook")
    with pytest.raises(ValueError, match="unknown method"):
        quantize_tensor(torch.zeros((128, 8)), 3, 64, method="nope", fmt="codebook")


@pytest.mark.parametrize("scale_dtype", ["float32", "bfloat16"])
def test_ternary_as_bcq_and_truncate_match_jax(rng, scale_dtype):
    w = rng.standard_normal((256, 64)).astype(np.float32)
    jfmt, tfmt = jget_format("ternary"), get_format("ternary")
    jqt = _jq(w, 2, 64, "ternary", scale_dtype=jnp.dtype(scale_dtype))
    tqt = _port_qt(jqt)
    for jv, tv in ((jfmt.as_bcq(jqt), tfmt.as_bcq(tqt)), (jfmt.truncate(jqt, 1), tfmt.truncate(tqt, 1))):
        assert tv.fmt == jv.fmt == "bcq"
        np.testing.assert_array_equal(tv.packed.numpy(), np.asarray(jv.packed))
        np.testing.assert_array_equal(tv.scales.float().numpy(), np.asarray(jv.scales, np.float32))
    torch.testing.assert_close(tfmt.as_bcq(tqt).dequantize(), tqt.dequantize(), rtol=0, atol=0)
    assert tfmt.truncate(tqt, 2) is tqt and tqt.truncate(1).q == 1
    with pytest.raises(ValueError):
        tqt.truncate(3)


@pytest.mark.parametrize("xdtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,k,o,q,g", SWEEP)
@pytest.mark.parametrize("fmt", NEW_FORMATS)
def test_plain_kernels_match_jax_dequantize_dot(rng, fmt, B, k, o, q, g, xdtype):
    """Wrapper (plain on the CPU), plain version and qmatmul's kernel impl
    vs JAX ``dequantize`` then a dot, and the ref oracle, at the sweep."""
    w = rng.standard_normal((k, o)).astype(np.float32)
    x = rng.standard_normal((B, k)).astype(np.float32)
    jqt = _jq(w, q, g, fmt, iters=2)
    jx = jnp.asarray(x, jnp.dtype(xdtype))
    want = np.asarray(jnp.dot(jx.astype(jnp.float32), jqt.dequantize(), preferred_element_type=jnp.float32))
    tqt = _port_qt(jqt)
    tx = torch.from_numpy(x).to(getattr(torch, xdtype))
    wrapper, plain, impl = KERNELS[fmt]
    tol = TOL[xdtype]
    for got in (
        wrapper(tx, tqt.packed, tqt.scales, g=g),
        plain(tx, tqt.packed, tqt.scales, g=g),
        qmatmul(fmt, tx, tqt, impl=impl, out_dtype=torch.float32)[0],
    ):
        assert got.dtype == torch.float32 and got.shape == (B, o)
        np.testing.assert_allclose(got.numpy(), want, rtol=tol, atol=tol)
    (ref,) = jqmatmul(fmt, jx, jqt, impl="ref")
    (got,) = qmatmul(fmt, tx, tqt, impl="ref")
    np.testing.assert_allclose(got.float().numpy(), np.asarray(ref, np.float32), rtol=tol, atol=tol)


@pytest.mark.parametrize("scale_dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("k,o,q,g,block_k", [
    (512, 256, 4, 128, 512),
    (1024, 256, 3, 64, 512),
    (512, 256, 2, 512, 256),
])
def test_dequant_materialize_plain_matches_jax_kernel(rng, k, o, q, g, block_k, scale_dtype):
    """Bit for bit with bf16 scales (the serving default: code·s is exact in
    f32). With f32 scales the JAX kernel, run by XLA in interpret mode,
    contracts code·s + z into one FMA while ``UniformFormat.dequantize``
    (and the port, plain and CUDA alike) rounds the product first, so the two
    differ by at most one rounding of the product."""
    w = rng.standard_normal((k, o)).astype(np.float32)
    jqt = _jq(w, q, g, "dequant", scale_dtype=jnp.dtype(scale_dtype))
    want = np.asarray(jdequant_materialize(
        jqt.packed, jqt.scales, g=g, block_k=block_k, block_o=256, interpret=True
    ))
    tqt = _port_qt(jqt)
    atol = 0.0
    if scale_dtype == "float32":
        atol = float(np.abs(np.asarray(jqt.scales[0])).max()) * (2**q) * 2.0**-23
        np.testing.assert_array_equal(
            dequant_materialize_plain(tqt.packed, tqt.scales, g=g).numpy(), np.asarray(jqt.dequantize())
        )
    for got in (dequant_materialize_plain(tqt.packed, tqt.scales, g=g),
                dequant_materialize(tqt.packed, tqt.scales, g=g)):
        assert got.dtype == torch.float32
        np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=atol)
    if scale_dtype == "bfloat16":
        w16 = dequant_materialize(tqt.packed, tqt.scales, g=g, out_dtype=torch.bfloat16)
        assert w16.dtype == torch.bfloat16
        want16 = jdequant_materialize(jqt.packed, jqt.scales, g=g, block_k=block_k, block_o=256,
                                      interpret=True, out_dtype=jnp.bfloat16)
        np.testing.assert_array_equal(w16.float().numpy(), np.asarray(want16, np.float32))


@pytest.mark.parametrize("fmt", NEW_FORMATS)
def test_qmatmul_leading_dims_and_out_dims_match_jax_ref(rng, fmt):
    w = rng.standard_normal((512, 256)).astype(np.float32)
    x = rng.standard_normal((2, 5, 512)).astype(np.float32)
    jqt = _jq(w, 3, 64, fmt, iters=2)
    tqt = _port_qt(jqt)
    dims = (160, 96)
    want = jqmatmul(fmt, jnp.asarray(x), jqt, dims, impl="ref")
    for impl in ("auto", "ref", KERNELS[fmt][2]):
        got = qmatmul(fmt, torch.from_numpy(x), tqt, dims, impl=impl)
        assert [t.shape for t in got] == [(2, 5, 160), (2, 5, 96)]
        for a, b in zip(got, want):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=2e-4, atol=2e-4)


def test_kernel_wrappers_refuse_bad_inputs(rng):
    x = torch.from_numpy(rng.standard_normal((2, 256)).astype(np.float32))
    p3 = torch.zeros((3, 32, 128), dtype=torch.uint8)
    with pytest.raises(ValueError, match="exactly 2 planes"):
        ternary_mm(x, p3, torch.ones((1, 4, 128)), g=64)
    with pytest.raises(ValueError, match="centroids"):
        codebook_mm(x, p3, torch.ones((4, 4, 128)), g=64)  # q=3 needs 8
    for fn, s in ((uniform_mm, 2), (ternary_mm, 1), (codebook_mm, 4), (dequant_mm, 2)):
        p = torch.zeros((2, 32, 128), dtype=torch.uint8)
        with pytest.raises(ValueError):
            fn(x, p, torch.ones((s, 4, 128)), g=12)  # g % 8 != 0
        with pytest.raises(ValueError):
            fn(x[:, :128], p, torch.ones((s, 4, 128)), g=64)  # k mismatch
        with pytest.raises(ValueError):
            fn(x, p, torch.ones((s + 1, 4, 128)), g=64)  # wrong scale planes
        with pytest.raises(TypeError):
            fn(x.half(), p, torch.ones((s, 4, 128)), g=64)
    with pytest.raises(TypeError):
        dequant_materialize(p3, torch.ones((2, 4, 128)), g=64, out_dtype=torch.float16)
    qt = quantize_tensor(torch.from_numpy(rng.standard_normal((256, 128)).astype(np.float32)), 2, 64, fmt="uniform")
    for impl in ("bcq_mm", "lutgemm", "ternary_mm", "no_such_kernel"):
        with pytest.raises(ValueError, match="no kernel impl"):
            qmatmul("uniform", x, qt, impl=impl)


def test_cpu_wrappers_count_no_launches(rng):
    x = torch.from_numpy(rng.standard_normal((2, 256)).astype(np.float32))
    before = launch_counts()
    for fmt in NEW_FORMATS:
        qt = quantize_tensor(torch.from_numpy(rng.standard_normal((256, 128)).astype(np.float32)), 2, 64,
                             iters=1, fmt=fmt)
        KERNELS[fmt][0](x, qt.packed, qt.scales, g=64)
        qmatmul(fmt, x, qt, impl=KERNELS[fmt][2])
        if fmt == "dequant":
            dequant_materialize(qt.packed, qt.scales, g=64)
    assert launch_counts() == before


def test_format_registry_matches_jax():
    assert format_names() == ("bcq", "codebook", "dequant", "ternary", "uniform")
    for name in format_names():
        f, jf = get_format(name), jget_format(name)
        assert (f.impls, f.supports_truncate, f.supports_fuse) == (jf.impls, jf.supports_truncate, jf.supports_fuse)
        for q in (1, 4, 5):
            assert f.scales_shape(q, 6, 40) == jf.scales_shape(q, 6, 40)
    assert get_format("ternary").planes(4) == 2 and get_format("codebook").planes(4) == 4
    with pytest.raises(ValueError, match="nested truncation"):
        quantize_tensor(torch.zeros((128, 8)), 2, 64, fmt="uniform").truncate(1)


def test_mixed_format_policy_resolution_matches_jax():
    kw = dict(q=4, g=128, attn=(2, 64, "uniform"), ffn=(4, 128), lm_head=(3, 64, "codebook"), fmt="ternary")
    pol, jpol = QuantPolicy(**kw), JPolicy(**kw)
    for path in [("stages", "0", "b0", "attn", "wq"), ("stages", "0", "b0", "mlp", "w_up"),
                 ("lm_head",), ("stages", "0", "b0", "ln1")]:
        assert pol.resolve_fmt(path) == jpol.resolve_fmt(path)
    assert pol.resolve_fmt(("stages", "0", "b0", "attn", "wq")) == (2, 64, "uniform")
    assert pol.resolve_fmt(("stages", "0", "b0", "mlp", "w_up")) == (4, 128, "ternary")
