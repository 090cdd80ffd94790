"""The group-table kernels' table build (K1/K2 ``bcq_mm``, K5 ``uniform_mm``)
in plain PyTorch, against the weights of the kernels' plain versions.

``csrc/grouptable.cuh`` builds, for every (group, column) pair, the ``2^q``
weights the pair can take and looks each weight up by its q-bit code.
``grouptable.table_plain`` makes those tables as the kernels do (BCQ: the
plane-order fold ``±alpha_0 ± … ± alpha_{q-1}``, level i doubling level
i - 1; uniform: ``c·s + z``, product and sum rounded apart). Gathered by the
codes, they must equal the plain versions' weights bit for bit, so a kernel
and its plain version differ only in the order of the k sum. This holds
the design's exactness claim where no card is.
"""

import numpy as np
import pytest
import torch

from repro_torch.core import packing
from repro_torch.core.formats import uniform_dequantize
from repro_torch.kernels import grouptable as gt
from repro_torch.kernels.bcq_mm import bcq_weight_plain

K, O = 256, 24
DTYPES = [torch.float32, torch.bfloat16]


def planes_and_scales(kind, q, g, dtype, seed):
    """Random packed planes and scales of ``kind`` from a numpy seed; BCQ
    alphas of mixed magnitude (so the fold's roundings matter), uniform
    (scale, zero) pairs centring the codes on 0."""
    rng = np.random.default_rng(seed)
    packed = torch.from_numpy(rng.integers(0, 256, size=(q, K // 8, O), dtype=np.uint8))
    G = K // g
    if kind == "bcq":
        scales = rng.uniform(0.5, 1.5, size=(q, G, O)) * 2.0 ** -np.arange(q)[:, None, None] / 7.0
    else:
        s = rng.uniform(0.5, 1.5, size=(G, O)) / 2**q
        scales = np.stack([s, -s * (2**q - 1) / 2 + rng.normal(0, 1e-3, size=(G, O))])
    return packed, torch.from_numpy(scales.astype(np.float32)).to(dtype)


@pytest.mark.parametrize("dtype", DTYPES, ids=["f32", "bf16"])
@pytest.mark.parametrize("g", [8, 64])
@pytest.mark.parametrize("q", range(1, 9))
def test_bcq_table_equals_plain_weights_bitwise(q, g, dtype):
    packed, scales = planes_and_scales("bcq", q, g, dtype, seed=q * 10 + g)
    got = gt.weights_plain("bcq", packed, scales, g)
    want = bcq_weight_plain(packed, scales, g)
    assert got.dtype == want.dtype == torch.float32
    torch.testing.assert_close(got, want, rtol=0, atol=0)


@pytest.mark.parametrize("dtype", DTYPES, ids=["f32", "bf16"])
@pytest.mark.parametrize("g", [8, 64])
@pytest.mark.parametrize("q", range(1, 9))
def test_uniform_table_equals_plain_weights_bitwise(q, g, dtype):
    packed, scales = planes_and_scales("uniform", q, g, dtype, seed=q * 10 + g + 1)
    got = gt.weights_plain("uniform", packed, scales, g)
    want = uniform_dequantize(packed, scales, g)
    assert got.dtype == want.dtype == torch.float32
    torch.testing.assert_close(got, want, rtol=0, atol=0)


@pytest.mark.parametrize("q", [1, 2, 4])
def test_bcq_table_entry_is_the_signed_fold(q):
    """Entry e: bit i of e set means +alpha_i, summed in plane order."""
    _, scales = planes_and_scales("bcq", q, 64, torch.float32, seed=q)
    table = gt.table_plain("bcq", scales, q)
    assert table.shape == (1 << q, K // 64, O)
    for e in range(1 << q):
        want = None
        for i in range(q):
            term = scales[i] if (e >> i) & 1 else -scales[i]
            want = term if want is None else want + term
        torch.testing.assert_close(table[e], want, rtol=0, atol=0)


def test_weights_plain_reads_codes_lsb_first():
    """The gather takes code bit i from plane i (``packing.pack_codes``)."""
    q, g = 3, 64
    rng = np.random.default_rng(5)
    codes = torch.from_numpy(rng.integers(0, 1 << q, size=(K, O)).astype(np.int32))
    packed = packing.pack_codes(codes, q)
    _, scales = planes_and_scales("uniform", q, g, torch.float32, seed=6)
    w = gt.weights_plain("uniform", packed, scales, g)
    rows = torch.arange(K)[:, None] // g
    want = codes.float() * scales[0][rows, torch.arange(O)] + scales[1][rows, torch.arange(O)]
    torch.testing.assert_close(w, want, rtol=0, atol=0)
