"""Port parity: packing and BCQ quantization math against the JAX package.

Inputs are made with numpy from a seed and handed to both packages."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_helpers  # noqa: F401  (one torch thread per test worker)
from repro.core import bcq as jbcq
from repro.core import packing as jpacking
from repro.core.qtensor import quantize_tensor as jquantize_tensor
from repro_torch.core import bcq as tbcq
from repro_torch.core import packing as tpacking
from repro_torch.core.formats import get_format
from repro_torch.core.qtensor import QuantizedTensor, fuse_tensors, quantize_tensor


def _t(a):
    return torch.from_numpy(np.array(a))


@pytest.mark.parametrize("shape", [(64, 16), (3, 128, 40), (2, 2, 256, 8)])
def test_pack_unpack_signs_bit_identical(rng, shape):
    codes = np.where(rng.standard_normal(shape) >= 0, 1, -1).astype(np.int8)
    jp = np.asarray(jpacking.pack_signs(jnp.asarray(codes)))
    tp = tpacking.pack_signs(_t(codes)).numpy()
    assert tp.dtype == np.uint8
    np.testing.assert_array_equal(tp, jp)
    np.testing.assert_array_equal(tpacking.unpack_signs(_t(jp)).numpy(), codes)
    np.testing.assert_array_equal(
        tpacking.unpack_signs(_t(jp)).numpy(), np.asarray(jpacking.unpack_signs(jnp.asarray(jp)))
    )


@pytest.mark.parametrize("q", [1, 2, 3, 4, 5, 6, 7, 8])
def test_pack_unpack_codes_bit_identical(rng, q):
    codes = rng.integers(0, 1 << q, size=(2, 64, 24)).astype(np.uint8)
    jp = np.asarray(jpacking.pack_codes(jnp.asarray(codes), q))
    tp = tpacking.pack_codes(_t(codes), q).numpy()
    np.testing.assert_array_equal(tp, jp)
    np.testing.assert_array_equal(tpacking.unpack_codes(_t(jp)).numpy(), codes.astype(np.int32))


@pytest.mark.parametrize("q,g", [(2, 64), (3, 32), (4, 128), (5, 64)])
def test_dequantize_of_jax_packed_matches(rng, q, g):
    """The port's dequantize of JAX-packed planes and scales equals JAX's
    exactly (f32; both sum the q planes in plane order)."""
    w = rng.standard_normal((256, 96)).astype(np.float32)
    jqt = jquantize_tensor(jnp.asarray(w), q, g, method="greedy", scale_dtype=jnp.float32)
    tqt = QuantizedTensor(
        packed=_t(jqt.packed), scales=_t(jqt.scales), g=g, k=256, o=96, fmt="bcq"
    )
    np.testing.assert_array_equal(tqt.dequantize().numpy(), np.asarray(jqt.dequantize()))


@pytest.mark.parametrize("q,g", [(1, 8), (2, 64), (4, 128)])
def test_greedy_solver_matches_jax(rng, q, g):
    """Packed bytes bit for bit; scales within 1e-6 relative."""
    w = rng.standard_normal((512, 160)).astype(np.float32)
    js, jb = jbcq.quantize_bcq_greedy(jnp.asarray(w), q=q, g=g)
    ts, tb = tbcq.quantize_bcq_greedy(_t(w), q=q, g=g)
    np.testing.assert_array_equal(
        tpacking.pack_signs(tb).numpy(), np.asarray(jpacking.pack_signs(jb))
    )
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), rtol=1e-6, atol=0)


@pytest.mark.parametrize("q,g,iters", [(2, 64, 3), (3, 32, 2)])
def test_alternating_solver_error_matches_jax(rng, q, g, iters):
    """The alternating solver's relative reconstruction error is within 1%
    (relative) of JAX's, and no worse than the greedy init."""
    w = rng.standard_normal((256, 1024)).astype(np.float32)
    js, jb = jbcq.quantize_bcq(jnp.asarray(w), q=q, g=g, iters=iters)
    ts, tb = tbcq.quantize_bcq(_t(w), q=q, g=g, iters=iters)
    jerr = float(jbcq.bcq_error(jnp.asarray(w), js, jb, g))
    terr = float(tbcq.bcq_error(_t(w), ts, tb, g))
    assert abs(terr - jerr) <= 0.01 * jerr, (terr, jerr)
    gs, gb = tbcq.quantize_bcq_greedy(_t(w), q=q, g=g)
    assert terr <= float(tbcq.bcq_error(_t(w), gs, gb, g)) + 1e-6


@pytest.mark.parametrize("q_new", [1, 2, 3])
def test_truncate_equals_greedy_solve(rng, q_new):
    """Inside the port: truncating a q=4 greedy BCQ to q' is bit for bit the
    greedy solve at q' (the nested-draft property)."""
    w = _t(rng.standard_normal((256, 64)).astype(np.float32))
    full = quantize_tensor(w, 4, 64, method="greedy", scale_dtype=torch.float32)
    direct = quantize_tensor(w, q_new, 64, method="greedy", scale_dtype=torch.float32)
    cut = full.truncate(q_new)
    assert cut.q == q_new
    torch.testing.assert_close(cut.packed, direct.packed, rtol=0, atol=0)
    torch.testing.assert_close(cut.scales, direct.scales, rtol=0, atol=0)
    with pytest.raises(ValueError):
        full.truncate(5)


def test_format_registry_and_fuse(rng):
    fmt = get_format("bcq")
    assert fmt.impls == ("bcq_mm", "lutgemm")
    assert fmt.resolve_impl("auto", torch.zeros(1)) == "ref"  # CPU tensor
    with pytest.raises(ValueError):
        fmt.resolve_impl("uniform_mm", torch.zeros(1))
    with pytest.raises(ValueError):
        get_format("nope")
    a = quantize_tensor(_t(rng.standard_normal((128, 32)).astype(np.float32)), 2, 64, method="greedy")
    b = quantize_tensor(_t(rng.standard_normal((128, 48)).astype(np.float32)), 2, 64, method="greedy")
    f = fuse_tensors([a, b])
    assert (f.k, f.o, f.q, f.g) == (128, 80, 2, 64)
    torch.testing.assert_close(f.dequantize(), torch.cat([a.dequantize(), b.dequantize()], -1))
    assert f.nbytes() == a.nbytes() + b.nbytes()
    c = quantize_tensor(_t(rng.standard_normal((128, 32)).astype(np.float32)), 3, 64, method="greedy")
    with pytest.raises(ValueError):
        fuse_tensors([a, c])


def test_compression_ratio_matches_jax():
    for q, g in [(1, 128), (3, 64), (4, 128)]:
        assert tbcq.compression_ratio(q, g) == jbcq.compression_ratio(q, g)
