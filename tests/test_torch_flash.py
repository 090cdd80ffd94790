"""Port parity for attention: the port's
``flash_attention`` (on the CPU its plain version) against the reference's
Pallas ``flash_attention`` in interpret mode, the port's ``_sdpa_qchunked``
against the reference's, the wrapper's checks, ``_causal``'s rule on the
CPU, and the decode attention over the cache (``_sdpa_decode``) against
the reference's ``_sdpa``.

Tolerances are the reference's own (``tests/test_flash_attn.py``):
rtol = atol = 2e-4 for f32 inputs and 3e-2 for bf16, where the reference
kernel rounds ``exp(s - m)`` per tile and the plain version rounds the
normalised probabilities; in bf16 each query row is also held to
``BF16_ROW_TOL`` of its largest value.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attn import flash_attention as jflash_attention
from repro.models import layers as JL
from repro_torch.kernels import flash_attention, flash_attention_plain
from repro_torch.kernels.flash_attn import BF16_ROW_TOL, row_rel_err
from repro_torch.kernels.ref import causal_mask, sdpa
from repro_torch.models import layers as L
import torch_helpers  # noqa: F401  (one torch thread per test worker)

F32_TOL, BF16_TOL = 2e-4, 3e-2


def _qkv(seed, b, s, h, hkv, dh):
    rng = np.random.default_rng(seed)
    return (
        rng.standard_normal((b, s, h, dh)).astype(np.float32),
        rng.standard_normal((b, s, hkv, dh)).astype(np.float32),
        rng.standard_normal((b, s, hkv, dh)).astype(np.float32),
    )


@pytest.mark.parametrize(
    "b,s,h,hkv,dh,bq,bk",
    [  # the reference's four shapes and its block sizes
        (2, 512, 4, 4, 64, 256, 256),  # MHA
        (1, 1024, 8, 2, 32, 256, 512),  # GQA group 4, rectangular tiles
        (2, 512, 6, 1, 64, 128, 128),  # MQA
        (1, 512, 2, 2, 128, 512, 256),  # single q tile
    ],
)
def test_flash_matches_reference_kernel(b, s, h, hkv, dh, bq, bk):
    q, k, v = _qkv(0, b, s, h, hkv, dh)
    ref = jflash_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), block_q=bq, block_k=bk,
                           interpret=True)
    out = flash_attention(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v))
    assert out.shape == (b, s, h, dh) and out.dtype == torch.float32
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=F32_TOL, atol=F32_TOL)


def test_flash_bf16_matches_reference_kernel():
    q, k, v = _qkv(1, 1, 512, 4, 2, 64)
    jq, jk, jv = (jnp.asarray(t, jnp.bfloat16) for t in (q, k, v))
    ref = jflash_attention(jq, jk, jv, block_q=256, block_k=256, interpret=True)
    tq, tk, tv = (torch.from_numpy(t).to(torch.bfloat16) for t in (q, k, v))
    out = flash_attention(tq, tk, tv)
    assert out.dtype == torch.bfloat16
    ref = torch.from_numpy(np.asarray(ref, np.float32))
    np.testing.assert_allclose(out.float().numpy(), ref.numpy(), rtol=BF16_TOL, atol=BF16_TOL)
    assert row_rel_err(out, ref) <= BF16_ROW_TOL  # per query row, relative to its values


@pytest.mark.parametrize("s", [1, 17, 100])
def test_flash_accepts_ragged_s(s):
    """Any S >= 1: the reference kernel's divisibility rule is a TPU tiling
    rule; its oracle (``_sdpa`` under a causal mask) defines the function."""
    q, k, v = _qkv(2, 2, s, 4, 2, 16)
    ref = JL._sdpa(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), JL.causal_mask(s, s))
    out = flash_attention(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=F32_TOL, atol=F32_TOL)


@pytest.mark.parametrize("s,chunk", [(256, 64), (200, 64)], ids=["chunked", "s_not_divisible"])
def test_sdpa_qchunked_matches_reference(s, chunk):
    q, k, v = _qkv(3, 2, s, 4, 2, 32)
    ref = JL._sdpa_qchunked(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), chunk=chunk)
    out = L._sdpa_qchunked(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v), chunk=chunk)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=F32_TOL, atol=F32_TOL)
    full = flash_attention_plain(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v))
    np.testing.assert_allclose(out.numpy(), full.numpy(), rtol=F32_TOL, atol=F32_TOL)


def test_reference_constants_carried_over():
    assert (L.Q_CHUNK, L.LONG_SEQ_THRESHOLD) == (JL.Q_CHUNK, JL.LONG_SEQ_THRESHOLD)


def test_causal_on_cpu_follows_the_reference_rule(monkeypatch):
    """On the CPU ``_causal`` never launches a kernel: full ``_sdpa`` below
    the threshold, ``_sdpa_qchunked`` from it on."""
    calls = []
    real = L._sdpa_qchunked
    monkeypatch.setattr(L, "_sdpa_qchunked", lambda *a, **kw: calls.append(1) or real(*a, **kw))
    monkeypatch.setattr(L, "LONG_SEQ_THRESHOLD", 64)
    before = flash_attention.launches
    q, k, v = (torch.from_numpy(t) for t in _qkv(4, 1, 64, 4, 2, 16))
    out = L._causal(q, k, v)
    assert calls == [1]
    L._causal(q[:, :63], k[:, :63], v[:, :63])
    assert calls == [1]
    assert flash_attention.launches == before
    np.testing.assert_allclose(out.numpy(), flash_attention_plain(q, k, v).numpy(), rtol=F32_TOL,
                               atol=F32_TOL)


@pytest.mark.parametrize(
    "shapes,err",
    [
        (((1, 8, 4, 16), (1, 8, 2, 16, 1), (1, 8, 2, 16)), ValueError),  # rank
        (((1, 8, 4, 16), (2, 8, 2, 16), (2, 8, 2, 16)), ValueError),  # B
        (((1, 8, 4, 16), (1, 9, 2, 16), (1, 9, 2, 16)), ValueError),  # S
        (((1, 8, 4, 16), (1, 8, 2, 32), (1, 8, 2, 32)), ValueError),  # Dh
        (((1, 8, 6, 16), (1, 8, 4, 16), (1, 8, 4, 16)), ValueError),  # H % Hkv
        (((1, 8, 4, 48), (1, 8, 2, 48), (1, 8, 2, 48)), ValueError),  # Dh outside the set
        (((1, 8, 4, 16), (1, 8, 2, 16), (1, 8, 1, 16)), ValueError),  # k, v differ
    ],
)
def test_flash_wrapper_checks(shapes, err):
    q, k, v = (torch.zeros(s) for s in shapes)
    with pytest.raises(err):
        flash_attention(q, k, v)


def test_flash_wrapper_refuses_mixed_dtypes():
    q, k, v = (torch.zeros((1, 8, 4, 16)), torch.zeros((1, 8, 2, 16)), torch.zeros((1, 8, 2, 16)))
    with pytest.raises(TypeError):
        flash_attention(q.to(torch.bfloat16), k, v)
    with pytest.raises(TypeError):
        flash_attention(q.half(), k.half(), v.half())


def test_bf16_row_check_sees_a_fault_on_the_long_rows():
    """The per-row measure sees what the absolute limit does not: the long
    rows' values fall as 1/sqrt(S). A plain attention that drops key tile 1
    for the last 64 rows stays within 3e-2 of the right answer, but not
    within ``BF16_ROW_TOL`` of each row's values."""
    s = 4096
    q, k, v = (torch.from_numpy(t).to(torch.bfloat16) for t in _qkv(5, 1, s, 1, 1, 64))
    ref = flash_attention_plain(q, k, v)
    mask = causal_mask(s, s).clone()
    mask[..., s - 64 :, 64:128] = False
    faulty = sdpa(q, k, v, mask)
    assert (faulty.float() - ref.float()).abs().max().item() <= BF16_TOL
    assert row_rel_err(faulty, ref) > BF16_ROW_TOL
    assert row_rel_err(ref, ref) == 0.0


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("b,s_max,h,hkv", [(4, 37, 4, 2), (3, 200, 6, 1), (5, 64, 8, 8)])
def test_decode_attention_matches_reference_and_is_batch_invariant(b, s_max, h, hkv, dtype):
    """``_sdpa_decode`` computes the reference's ``_sdpa`` for one query row
    per batch row over a cache masked at per-row positions, and a batch
    row's result equals that row run alone, bit for bit."""
    rng = np.random.default_rng(6)
    q = rng.standard_normal((b, 1, h, 32)).astype(np.float32)
    ck, cv = (rng.standard_normal((b, s_max, hkv, 32)).astype(np.float32) for _ in range(2))
    pos = rng.integers(0, s_max, size=b)
    mask = (np.arange(s_max)[None, :] <= pos[:, None])[:, None, None, :]
    jd = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    ref = JL._sdpa(*(jnp.asarray(t, jd) for t in (q, ck, cv)), jnp.asarray(mask))
    tq, tk, tv = (torch.from_numpy(t).to(dtype) for t in (q, ck, cv))
    tmask = torch.from_numpy(mask)
    out = L._sdpa_decode(tq, tk, tv, tmask)
    tol = F32_TOL if dtype == torch.float32 else BF16_TOL
    np.testing.assert_allclose(out.float().numpy(), np.asarray(ref, np.float32), rtol=tol, atol=tol)
    for i in range(b):
        alone = L._sdpa_decode(tq[i : i + 1], tk[i : i + 1], tv[i : i + 1], tmask[i : i + 1])
        assert torch.equal(out[i : i + 1], alone)
