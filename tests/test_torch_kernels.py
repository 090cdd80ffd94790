"""Port parity: the kernels' plain versions and the qmatmul dispatch against
the JAX package's oracles (``bcq_mm_ref``, ``lutgemm_tablewise_ref`` and
``qmatmul(impl="ref")``). The CUDA kernels themselves are checked against
these plain versions in tests/test_torch_cuda.py.

Tolerances are the reference's own (tests/test_kernels.py): rtol = atol =
2e-4 with f32 x, 2e-2 with bf16 x."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_helpers  # noqa: F401  (one torch thread per test worker)
from repro.core import fuse_tensors as jfuse_tensors
from repro.core import quantize_tensor as jquantize_tensor
from repro.kernels import qmatmul as jqmatmul
from repro.kernels.ref import bcq_mm_ref as jbcq_mm_ref
from repro.kernels.ref import lutgemm_tablewise_ref as jlut_ref
from repro_torch.core.qtensor import QuantizedTensor
from repro_torch.kernels import (
    bcq_mm,
    bcq_mm_fused,
    bcq_mm_plain,
    bcq_mm_ref,
    impl_mode,
    lutgemm,
    lutgemm_plain,
    lutgemm_tablewise_ref,
    qmatmul,
)

SWEEP = [  # (B, k, o, q, g), the reference's kernel sweep
    (1, 512, 256, 2, 64),
    (8, 512, 128, 4, 512),
    (8, 1024, 256, 3, 128),
    (16, 512, 384, 1, 8),
    (4, 1024, 128, 5, 1024),
    (2, 2048, 256, 2, 2048),
]
TOL = {"float32": 2e-4, "bfloat16": 2e-2}


def _t(a):
    return torch.from_numpy(np.array(a))


def _port_qt(jqt) -> QuantizedTensor:
    return QuantizedTensor(
        packed=_t(jqt.packed), scales=_t(jqt.scales), g=jqt.g, k=jqt.k, o=jqt.o, fmt=jqt.fmt
    )


def _make(rng, B, k, o, q, g, xdtype):
    w = rng.standard_normal((k, o)).astype(np.float32)
    x = rng.standard_normal((B, k)).astype(np.float32)
    jqt = jquantize_tensor(jnp.asarray(w), q, g, method="greedy", scale_dtype=jnp.float32)
    jx = jnp.asarray(x, jnp.dtype(xdtype))
    tx = _t(x).to(getattr(torch, xdtype))
    return jx, jqt, tx, _port_qt(jqt)


@pytest.mark.parametrize("xdtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,k,o,q,g", SWEEP)
def test_plain_kernels_match_jax_oracles(rng, B, k, o, q, g, xdtype):
    jx, jqt, tx, tqt = _make(rng, B, k, o, q, g, xdtype)
    want = np.asarray(jbcq_mm_ref(jx, jqt.packed, jqt.scales, g))
    tol = TOL[xdtype]
    for fn in (bcq_mm_plain, lutgemm_plain, bcq_mm, lutgemm):
        got = fn(tx, tqt.packed, tqt.scales, g=g)
        assert got.dtype == torch.float32 and got.shape == (B, o)
        np.testing.assert_allclose(got.numpy(), want, rtol=tol, atol=tol, err_msg=fn.__name__)
    parts = bcq_mm_fused(tx, tqt.packed, tqt.scales, g=g, out_dims=(o // 2, o - o // 2))
    np.testing.assert_allclose(torch.cat(parts, -1).numpy(), want, rtol=tol, atol=tol)
    table = jlut_ref(np.asarray(jx, np.float32), np.asarray(jqt.packed), np.asarray(jqt.scales), g)
    np.testing.assert_allclose(
        lutgemm_plain(tx, tqt.packed, tqt.scales, g=g).numpy(), table, rtol=tol, atol=tol
    )
    np.testing.assert_allclose(
        lutgemm_tablewise_ref(tx, tqt.packed, tqt.scales, g).numpy(), table, rtol=1e-9, atol=1e-9
    )
    np.testing.assert_allclose(
        bcq_mm_ref(tx, tqt.packed, tqt.scales, g).numpy(), want, rtol=tol, atol=tol
    )


@pytest.mark.parametrize("xdtype", ["float32", "bfloat16"])
def test_fused_wrapper_matches_per_projection_oracles(rng, xdtype):
    k, g, q, B, dims = 512, 64, 3, 5, (192, 64, 64)
    x = rng.standard_normal((B, k)).astype(np.float32)
    jqts = [
        jquantize_tensor(
            jnp.asarray(rng.standard_normal((k, d)).astype(np.float32)), q, g,
            method="greedy", scale_dtype=jnp.float32,
        )
        for d in dims
    ]
    fused = _port_qt(jfuse_tensors(jqts))
    tx = _t(x).to(getattr(torch, xdtype))
    jx = jnp.asarray(x, jnp.dtype(xdtype))
    outs = bcq_mm_fused(tx, fused.packed, fused.scales, g=g, out_dims=dims)
    assert [o.shape for o in outs] == [(B, d) for d in dims]
    for got, jqt in zip(outs, jqts):
        want = np.asarray(jbcq_mm_ref(jx, jqt.packed, jqt.scales, g))
        np.testing.assert_allclose(got.numpy(), want, rtol=TOL[xdtype], atol=TOL[xdtype])
    with pytest.raises(ValueError):
        bcq_mm_fused(tx, fused.packed, fused.scales, g=g, out_dims=(192, 64))


def test_cpu_wrappers_count_no_launches(rng):
    _, _, tx, tqt = _make(rng, 2, 256, 128, 2, 64, "float32")
    before = (bcq_mm.launches, bcq_mm_fused.launches, lutgemm.launches)
    bcq_mm(tx, tqt.packed, tqt.scales, g=64)
    lutgemm(tx, tqt.packed, tqt.scales, g=64)
    bcq_mm_fused(tx, tqt.packed, tqt.scales, g=64, out_dims=(64, 64))
    assert (bcq_mm.launches, bcq_mm_fused.launches, lutgemm.launches) == before


def test_qmatmul_padding_case_matches_jax_ref(rng):
    """o=200, B=3, g=96 (no lane-multiple o, no sublane-multiple B)."""
    w = rng.standard_normal((768, 200)).astype(np.float32)
    x = rng.standard_normal((3, 768)).astype(np.float32)
    jqt = jquantize_tensor(jnp.asarray(w), 3, 96, iters=1, scale_dtype=jnp.float32)
    (want,) = jqmatmul("bcq", jnp.asarray(x), jqt, impl="ref")
    tqt = _port_qt(jqt)
    for impl in ("auto", "ref", "bcq_mm", "lutgemm"):
        (got,) = qmatmul("bcq", _t(x), tqt, impl=impl)
        assert got.shape == (3, 200) and got.dtype == torch.float32
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-4, atol=2e-4)


def test_qmatmul_leading_dims_and_out_dims_split(rng):
    w = rng.standard_normal((512, 256)).astype(np.float32)
    x = rng.standard_normal((2, 5, 512)).astype(np.float32)
    jqt = jquantize_tensor(jnp.asarray(w), 2, 64, iters=1, scale_dtype=jnp.float32)
    tqt = _port_qt(jqt)
    dims = (160, 96)
    want = jqmatmul("bcq", jnp.asarray(x), jqt, dims, impl="ref")
    for impl in ("ref", "bcq_mm", "lutgemm"):
        got = qmatmul("bcq", _t(x), tqt, dims, impl=impl)
        assert [g.shape for g in got] == [(2, 5, 160), (2, 5, 96)]
        for a, b in zip(got, want):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=2e-4, atol=2e-4)
    (y,) = qmatmul("bcq", _t(x).to(torch.bfloat16), tqt, impl="bcq_mm")
    assert y.dtype == torch.bfloat16  # out_dtype defaults to x's dtype
    with pytest.raises(ValueError):
        qmatmul("bcq", _t(x), tqt, (100, 100))


def test_impl_mode_overrides_auto_only(rng):
    _, _, tx, tqt = _make(rng, 2, 256, 128, 2, 64, "float32")
    before = qmatmul.ref_calls
    qmatmul("bcq", tx, tqt)  # CPU tensor: auto → ref
    assert qmatmul.ref_calls == before + 1
    with impl_mode("lutgemm"):
        qmatmul("bcq", tx, tqt)
        qmatmul("bcq", tx, tqt, impl="ref")  # explicit impl wins
    assert qmatmul.ref_calls == before + 2
    with impl_mode("no_such_kernel"), pytest.raises(ValueError):
        qmatmul("bcq", tx, tqt)


def test_kernel_wrappers_reject_bad_inputs(rng):
    _, _, tx, tqt = _make(rng, 4, 512, 128, 2, 64, "float32")
    for fn in (bcq_mm, lutgemm):
        with pytest.raises(ValueError):
            fn(tx, tqt.packed, tqt.scales, g=12)  # g % 8 != 0
        with pytest.raises(ValueError):
            fn(tx[:, :256], tqt.packed, tqt.scales, g=64)  # k mismatch
        with pytest.raises(TypeError):
            fn(tx.to(torch.float16), tqt.packed, tqt.scales, g=64)
