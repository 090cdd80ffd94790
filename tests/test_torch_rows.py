"""Dense products whose batch rows do not depend on the batch
(``utils.matmul_rows``, ``utils.matmul_row_tiles``, ``utils.token_rows``)
and the ``dequant`` GEMM that uses them for decode rows.

A slot batch must decode each request exactly as a batch of one does, and
a library product may sum k in another order for B rows than for one. So
on the CPU each batch row is its own product, and on the GPU a call whose
rows are one token each runs in zero-padded tiles of ``ROW_TILE`` rows, one
fixed-shape product a tile. The tiles' bits are held on the card
(``tests/test_torch_cuda.py``, ``chip_smoke.py``); here, that the tiling
pads and unpads to the same rows, that CPU rows stay one at a time, and
that ``qmatmul`` tells the format which calls are decode rows. The
``dequant`` GEMM is held to the JAX package's ``dequant`` oracle."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_helpers  # noqa: F401  (one torch thread per test worker)
from repro.core.formats import get_format as jget_format
from repro.kernels import qmatmul as jqmatmul
from repro_torch.core.formats import DequantFormat, get_format
from repro_torch.kernels import dequant_mm, dequant_mm_plain, qmatmul
from repro_torch.utils import ROW_TILE, matmul_row_tiles, matmul_rows, token_rows


def _xw(B, k, o, seed, lead=()):
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.standard_normal((B, *lead, k)).astype(np.float32))
    w = torch.from_numpy(rng.standard_normal((k, o)).astype(np.float32))
    return x, w


@pytest.mark.parametrize("shape,want", [
    ((5, 16), True), ((5, 1, 16), True), ((5, 1, 1, 16), True), ((1, 1, 16), True),
    ((5, 3, 16), False), ((1, 7, 16), False), ((2, 1, 3, 16), False),
])
def test_token_rows_tells_decode_rows_from_prompts(shape, want):
    assert token_rows(torch.zeros(shape)) is want


@pytest.mark.parametrize("rows", [1, 3, ROW_TILE])
@pytest.mark.parametrize("B", [1, 2, 7, 8, 9, 16, 17, 64])
def test_matmul_row_tiles_pads_and_unpads_to_the_same_rows(B, rows):
    """(B, o) out, row r from the tile that holds it: bitwise the tile's own
    zero-padded product, whatever B; the padding never reaches the output."""
    x, w = _xw(B, 24, 10, seed=B * 10 + rows)
    y = matmul_row_tiles(x, w, rows)
    assert y.shape == (B, 10) and y.dtype == x.dtype
    for t0 in range(0, B, rows):
        tile = torch.zeros((rows, 24))
        n = min(rows, B - t0)
        tile[:n] = x[t0 : t0 + n]
        torch.testing.assert_close(y[t0 : t0 + n], torch.matmul(tile, w)[:n], rtol=0, atol=0)
    torch.testing.assert_close(y, x @ w, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("lead", [(), (1,), (6,)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_matmul_rows_on_cpu_is_one_batch_row_at_a_time(lead, dtype):
    """On the CPU every leading batch row is its own product, decode rows
    and prompts alike: bitwise the row called alone."""
    x, w = _xw(5, 32, 12, seed=len(lead) + 3, lead=lead)
    x, w = x.to(dtype), w.to(dtype)
    y = matmul_rows(x, w)
    assert y.shape == (*x.shape[:-1], 12)
    for r in range(5):
        torch.testing.assert_close(y[r : r + 1], torch.matmul(x[r : r + 1], w), rtol=0, atol=0)
        torch.testing.assert_close(y[r : r + 1], matmul_rows(x[r : r + 1], w), rtol=0, atol=0)


def _dequant_qt(k, o, q, g, seed):
    rng = np.random.default_rng(seed)
    w = torch.from_numpy(rng.standard_normal((k, o)).astype(np.float32))
    return get_format("dequant").quantize(w, q=q, g=g, scale_dtype=torch.float32), w


@pytest.mark.parametrize("B", [1, 4, 9])
def test_dequant_mm_token_rows_match_the_row_alone_and_jax(B):
    """``dequant_mm(token_rows=True)``: each row bitwise the row called
    alone; all rows within the reference's f32 tolerance of the JAX
    package's ``dequant`` oracle on the same packed weights."""
    k, o, q, g = 256, 48, 4, 64
    qt, _ = _dequant_qt(k, o, q, g, seed=B)
    rng = np.random.default_rng(100 + B)
    x = rng.standard_normal((B, k)).astype(np.float32)
    tx = torch.from_numpy(x)
    y = dequant_mm(tx, qt.packed, qt.scales, g=g, token_rows=True)
    for r in range(B):
        alone = dequant_mm(tx[r : r + 1], qt.packed, qt.scales, g=g, token_rows=True)
        torch.testing.assert_close(y[r : r + 1], alone, rtol=0, atol=0)
    torch.testing.assert_close(y, dequant_mm_plain(tx, qt.packed, qt.scales, g=g), rtol=2e-4, atol=2e-4)
    from repro.core.qtensor import QuantizedTensor as JQT

    jqt = JQT(packed=jnp.asarray(qt.packed.numpy()), scales=jnp.asarray(qt.scales.numpy()), g=g, k=k, o=o,
              fmt="dequant")
    (want,) = jqmatmul(jget_format("dequant"), jnp.asarray(x), jqt, impl="ref")
    np.testing.assert_allclose(y.numpy(), np.asarray(want, np.float32), rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("shape,want", [((4, 1, 256), True), ((4, 256), True), ((2, 5, 256), False),
                                        ((1, 9, 256), False)])
def test_qmatmul_tells_the_format_which_calls_are_decode_rows(monkeypatch, shape, want):
    """``qmatmul`` flattens x for the kernel and passes ``token_rows`` along,
    so ``dequant`` can tile a decode step's GEMM and keep a prompt's whole."""
    qt, _ = _dequant_qt(256, 32, 4, 64, seed=7)
    seen = []
    inner = DequantFormat.matvec

    def spy(self, xb, qt_, *, impl, out_dims, token_rows=False):
        seen.append((tuple(xb.shape), token_rows))
        return inner(self, xb, qt_, impl=impl, out_dims=out_dims, token_rows=token_rows)

    monkeypatch.setattr(DequantFormat, "matvec", spy)
    x = torch.from_numpy(np.random.default_rng(1).standard_normal(shape).astype(np.float32))
    (y,) = qmatmul("dequant", x, qt, impl="dequant_mm")
    rows = int(np.prod(shape[:-1]))
    assert seen == [((rows, 256), want)]
    assert y.shape == (*shape[:-1], 32)
    flat = dequant_mm_plain(x.reshape(rows, 256), qt.packed, qt.scales, g=64)
    torch.testing.assert_close(y.reshape(rows, 32), flat, rtol=2e-4, atol=2e-4)
