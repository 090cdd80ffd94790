"""Port parity: gradient compression with error feedback
(``repro_torch/train/compress.py``) against the JAX package's.

``compress_int8``'s payload, scale and residual equal JAX's bit for bit
(both round half to even). ``allreduce_mean_compressed`` over two gloo CPU
ranks (``launch/_ranks.py::run_ranks``) equals a numpy oracle built from
the reference's per-rank ``compress_int8``, exactly for ``int8`` and
``bf16`` (the oracle sums in the all-reduce's order), and the f32 mean for
``none``; the error-feedback and round-trip bounds are the reference's.
"""

import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.train.compress import compress_int8 as jcompress_int8
from repro.train.compress import compress_tree as jcompress_tree
from repro.train.compress import decompress_int8 as jdecompress_int8
from repro_torch.launch._ranks import run_ranks
from repro_torch.train.compress import compress_int8, compress_tree, decompress_int8

import torch_train_ranks as R


def _g(seed, n=257, scale=1.0):
    return np.random.default_rng(seed).standard_normal(n).astype(np.float32) * scale


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("with_residual", [False, True])
def test_compress_int8_equals_jax_bit_for_bit(seed, with_residual):
    g = _g(seed, scale=10.0 ** (seed - 1))
    if seed == 2:
        g[:8] = np.float32(0.5) * np.arange(8)  # exact ties after the scale
    r = _g(seed + 10, scale=1e-2) if with_residual else None
    jq, js, jr = jcompress_int8(jnp.asarray(g), None if r is None else jnp.asarray(r))
    tq, ts, tr = compress_int8(torch.from_numpy(g), None if r is None else torch.from_numpy(r))
    assert tq.dtype == torch.int8 and ts.dtype == tr.dtype == torch.float32
    assert tq.numpy().tobytes() == np.asarray(jq).tobytes()
    assert ts.numpy().tobytes() == np.asarray(js).tobytes()
    assert tr.numpy().tobytes() == np.asarray(jr).tobytes()
    assert decompress_int8(tq, ts).numpy().tobytes() == np.asarray(jdecompress_int8(jq, js)).tobytes()


def test_compress_int8_of_zeros_and_bf16_input():
    for g in (np.zeros(9, np.float32), _g(4).astype(ml_dtypes.bfloat16)):
        jq, js, jr = jcompress_int8(jnp.asarray(g), None)
        tg = torch.from_numpy(g.view(np.int16)).view(torch.bfloat16) if g.dtype.name == "bfloat16" else \
            torch.from_numpy(g)
        tq, ts, tr = compress_int8(tg, None)
        assert (tq.numpy().tobytes(), ts.numpy().tobytes(), tr.numpy().tobytes()) == (
            np.asarray(jq).tobytes(), np.asarray(js).tobytes(), np.asarray(jr).tobytes())


def test_int8_roundtrip_bounded_error():
    g = torch.from_numpy(_g(0, 64))
    q, scale, res = compress_int8(g, None)
    rec = decompress_int8(q, scale)
    assert float((rec - g).abs().max()) <= float(scale) * 0.5 + 1e-6
    torch.testing.assert_close(res, g - rec, rtol=1e-6, atol=0)


def test_error_feedback_compensates():
    g_true = torch.from_numpy(_g(1, 32, 0.01))
    res, total = None, torch.zeros_like(g_true)
    for _ in range(50):
        q, scale, res = compress_int8(g_true, res)
        total = total + decompress_int8(q, scale)
    assert float((total - 50 * g_true).abs().max()) <= float(g_true.abs().max()) + 1e-5


@pytest.mark.parametrize("mode", ["bf16", "int8"])
def test_compress_tree_equals_jax(mode):
    """A dict tree: the reference's ``compress_tree`` takes any tuple in the
    tree for one of its (payload, scale, residual) triples
    (``is_leaf=isinstance(x, tuple)``), so it cannot split a tree holding
    tuples, such as a model's ``stages``; the port's can (checked below)."""
    tree = {"w": _g(5, 12).reshape(3, 4), "b": {"c": _g(6, 5)}}
    jp, jaux, jres = jcompress_tree({"w": jnp.asarray(tree["w"]), "b": {"c": jnp.asarray(tree["b"]["c"])}}, None,
                                    mode)
    tp, taux, tres = compress_tree({"w": torch.from_numpy(tree["w"]), "b": {"c": torch.from_numpy(tree["b"]["c"])}},
                                   None, mode)
    for got, want in ((tp["w"], jp["w"]), (tp["b"]["c"], jp["b"]["c"])):
        bits = got.view(torch.int16).numpy() if got.dtype == torch.bfloat16 else got.numpy()
        assert bits.tobytes() == np.asarray(want).tobytes()
    if mode == "int8":
        for got, want in ((taux["w"], jaux["w"]), (taux["b"]["c"], jaux["b"]["c"]), (tres["w"], jres["w"]),
                          (tres["b"]["c"], jres["b"]["c"])):
            assert got.numpy().tobytes() == np.asarray(want).tobytes()
        # a tree with tuples (a model's stages): each leaf as compress_int8 gives it
        tt = {"stages": (torch.from_numpy(tree["w"]), torch.from_numpy(tree["b"]["c"]))}
        p2, s2, r2 = compress_tree(tt, None, "int8")
        for i in range(2):
            want = compress_int8(tt["stages"][i], None)
            assert all(torch.equal(a, b) for a, b in zip((p2["stages"][i], s2["stages"][i], r2["stages"][i]), want))
    else:
        assert taux is None and tres is None
    with pytest.raises(ValueError):
        compress_tree(tp, None, "fp4")


def _oracle(mode, n, residuals=None):
    """The mean each rank must return: the reference's per-rank compression
    (``compress_int8`` / a bf16 cast), then the sum and the scale's max, in
    numpy, rank order → ({leaf: mean}, {leaf: [rank residuals]})."""
    out, res = {}, {}
    for leaf in ("w", "b"):
        gs = [R.grads_of(r)[leaf] if leaf == "w" else R.grads_of(r)["b"][0] for r in range(n)]
        if mode == "none":
            out[leaf] = sum(g for g in gs) / np.float32(n)
        elif mode == "bf16":
            out[leaf] = sum(g.astype(ml_dtypes.bfloat16).astype(np.float32) for g in gs) / np.float32(n)
        else:
            parts = [jcompress_int8(jnp.asarray(g), None if residuals is None else jnp.asarray(residuals[leaf][r]))
                     for r, g in enumerate(gs)]
            summed = sum(np.asarray(q).astype(np.int32) for q, _, _ in parts)
            scale = max(np.asarray(s) for _, s, _ in parts)
            out[leaf] = summed.astype(np.float32) * scale / np.float32(n)
            res[leaf] = [np.asarray(r_) for _, _, r_ in parts]
    return out, res


@pytest.mark.parametrize("mode", ["none", "bf16", "int8"])
def test_allreduce_mean_compressed_over_two_gloo_ranks(mode):
    n = 2
    got = run_ranks(R.allreduce_rank, n, (mode,), device="cpu", timeout=240)
    want, res = _oracle(mode, n)
    for rank, g in enumerate(got):
        for leaf in ("w", "b"):
            np.testing.assert_allclose(g["out"][leaf], want[leaf], rtol=1e-7 if mode == "none" else 0, atol=0,
                                       err_msg=f"{mode} rank {rank} {leaf}")
            assert (g["out"][leaf] == got[0]["out"][leaf]).all()  # every rank the same mean
    if mode == "int8":
        want2, _ = _oracle(mode, n, res)
        for rank, g in enumerate(got):
            for leaf in ("w", "b"):
                assert g["res"][leaf].tobytes() == res[leaf][rank].tobytes()  # the rank's own residual
                np.testing.assert_array_equal(g["out2"][leaf], want2[leaf])
    else:
        assert all(g["res"] is None for g in got)
