"""The group-table kernels' table build (K1/K2 ``bcq_mm``, K5 ``uniform_mm``,
the CUDA-core path of K4 ``ternary_mm``) in plain PyTorch, against the
weights of the kernels' plain versions, and the A-fragment decode of K4's
tensor-core path against the ternary weights.

``csrc/grouptable.cuh`` builds, for every (group, column) pair, the ``2^q``
weights the pair can take and looks each weight up by its q-bit code.
``grouptable.table_plain`` makes those tables as the kernels do (BCQ: the
plane-order fold ``±alpha_0 ± … ± alpha_{q-1}``, level i doubling level
i - 1; uniform: ``c·s + z``, product and sum rounded apart; ternary, by the
code ``sign | mask << 1``: ``{0, 0, -alpha, +alpha}``). Gathered by the
codes, they must equal the plain versions' weights bit for bit, so a kernel
and its plain version differ only in the order of the k sum. This holds
the design's exactness claim where no card is. The tensor-core path
decodes each weight into a bf16 A fragment with byte permutes
(``csrc/ternary_mm.cu::decode_byte``); ``ternary_mm.fragment_plain``
repeats its integer steps and must give exactly ``+alpha``, ``-alpha`` or 0
for every sign and mask bit.
"""

import numpy as np
import pytest
import torch

from repro_torch.core import packing
from repro_torch.core.formats import ternary_dequantize, uniform_dequantize
from repro_torch.kernels import grouptable as gt
from repro_torch.kernels.bcq_mm import bcq_weight_plain
from repro_torch.kernels.ternary_mm import fragment_plain

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
    elif kind == "ternary":  # alpha of either sign, mixed magnitudes
        scales = rng.uniform(-1.5, 1.5, size=(1, G, O)) * 2.0 ** rng.integers(-6, 6, size=(1, G, O))
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


@pytest.mark.parametrize("dtype", DTYPES, ids=["f32", "bf16"])
@pytest.mark.parametrize("g", [8, 64, 256])
def test_ternary_table_equals_plain_weights_bitwise(g, dtype):
    """The CUDA-core path's 4-entry table, looked up by ``sign | mask << 1``,
    gives ``formats.ternary_dequantize``'s ``(2·sign − 1)·mask·alpha``."""
    packed, scales = planes_and_scales("ternary", 2, g, dtype, seed=g + 3)
    got = gt.weights_plain("ternary", packed, scales, g)
    want = ternary_dequantize(packed, scales, g)
    assert got.dtype == want.dtype == torch.float32
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    table = gt.table_plain("ternary", scales, 2)
    a = scales[0].to(torch.float32)
    assert torch.equal(table, torch.stack([torch.zeros_like(a), torch.zeros_like(a), -a, a]))


ALPHAS = [0.37109375, -1.25, 3.0517578125e-05, -6.5e4, 1e30, 1.0e-40, 0.0]


@pytest.mark.parametrize("high", [False, True], ids=["low_half", "high_half"])
@pytest.mark.parametrize("alpha", ALPHAS)
def test_tensor_core_fragment_decode_gives_exact_ternary_weights(alpha, high):
    """Every (sign byte, mask byte) pair, so every bit takes all four codes:
    weight j is +alpha (sign and mask set), -alpha (mask only) or +0 (no
    mask), exactly, in bf16, for alpha in either half of the kernel's bf16
    pair (a NaN in the other half never leaks)."""
    s = torch.arange(256).repeat_interleave(256).to(torch.uint8)
    m = torch.arange(256).repeat(256).to(torch.uint8)
    a = torch.full(s.shape, alpha).to(torch.bfloat16)
    got = fragment_plain(s, m, a, high=high)
    assert got.dtype == torch.bfloat16 and got.shape == (256 * 256, 8)
    bit = torch.arange(8)
    sb = (s[:, None].long() >> bit) & 1
    mb = (m[:, None].long() >> bit) & 1
    af = a.to(torch.float32)[:, None].expand(-1, 8)
    want = torch.where(mb == 1, torch.where(sb == 1, af, -af), torch.zeros_like(af))
    assert torch.equal(got.to(torch.float32), want)
    # bit for bit: a dropped weight is +0, and -alpha is alpha with its sign bit flipped
    bits = got.view(torch.int16)
    abits = a.view(torch.int16)[:, None].expand(-1, 8)
    want_bits = torch.where(mb == 1, torch.where(sb == 1, abits, abits ^ -0x8000), torch.zeros_like(abits))
    assert torch.equal(bits, want_bits)
