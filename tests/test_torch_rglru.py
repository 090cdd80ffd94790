"""Port parity: the RG-LRU block (``models/recurrent.py``) and the plain
version of its scan kernel K9 (``kernels/rglru_scan.py``) against the JAX
package's ``repro.models.recurrent`` on the reduced recurrentgemma-9b config
(d_model 64, lru_width 64, conv width 4, f32), with the reference's
parameters carried across by ``params_from_numpy``.

Against JAX: rtol = atol = 2e-4 (the packages sum the same f32 products in
different orders; ``log_sigmoid`` and ``gelu`` are written differently).
Inside the port: bit for bit, a scan of S tokens against S decode steps.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.models import recurrent as JR
from repro.models import reduced as jreduced
from repro_torch.configs import get_config
from repro_torch.kernels import launch_counts, reset_launch_counts, rglru_scan, rglru_scan_plain
from repro_torch.models import params_from_numpy, reduced
from repro_torch.models import recurrent as R
from torch_helpers import jax_tree_to_numpy

TOL = 2e-4
B, S = 2, 12


@pytest.fixture(scope="module")
def cfgs():
    return jreduced(jget_config("recurrentgemma-9b")), reduced(get_config("recurrentgemma-9b"))


@pytest.fixture(scope="module")
def params(cfgs):
    jp = JR.init_rglru(jax.random.PRNGKey(3), cfgs[0])
    return jp, params_from_numpy(jax_tree_to_numpy(jp), device="cpu")


def _x(seed, s=S, d=64):
    return np.random.default_rng(seed).standard_normal((B, s, d)).astype(np.float32)


def _state(seed, w=64, k=4):
    rng = np.random.default_rng(seed)
    return {"h": rng.standard_normal((B, w)).astype(np.float32),
            "conv": rng.standard_normal((B, k - 1, w)).astype(np.float32)}


def _tstate(st):
    return {k: torch.from_numpy(v.copy()) for k, v in st.items()}


def _jstate(st):
    return {k: jnp.asarray(v) for k, v in st.items()}


def test_init_rglru_has_the_reference_leaves(cfgs):
    jp = JR.init_rglru(jax.random.PRNGKey(0), cfgs[0])
    tp = R.init_rglru(torch.Generator().manual_seed(0), cfgs[1], device="cpu")
    assert set(tp) == set(jp)
    for name, leaf in jp.items():
        assert tuple(tp[name].shape) == leaf.shape, name
        assert str(tp[name].dtype).split(".")[-1] == str(leaf.dtype), name
    decay = torch.sigmoid(tp["lam"])  # a = σ(Λ)^(c·r) starts in [0.9, 0.999] at r = 1
    assert (decay >= 0.9 - 1e-6).all() and (decay <= 0.999 + 1e-6).all()


@pytest.mark.parametrize("mode", ["train", "state", "decode", "collect"])
def test_rglru_block_matches_jax(cfgs, params, mode):
    """The block's output and state against the reference's: without a
    state (train), from a state over S tokens, one decode step, and the
    per-token stacks of ``collect=True`` ((S, B, W) f32 and (S, B, K-1, W))."""
    jcfg, tcfg = cfgs
    jp, tp = params
    s = 1 if mode == "decode" else S
    x = _x(1, s)
    st = None if mode == "train" else _state(2)
    jout, jst = JR.rglru_block(jp, jcfg, jnp.asarray(x), None if st is None else _jstate(st),
                               collect=mode == "collect")
    tst = None if st is None else _tstate(st)
    with torch.no_grad():
        tout, tret = R.rglru_block(tp, tcfg, torch.from_numpy(x), tst, collect=mode == "collect")
    np.testing.assert_allclose(tout.numpy(), np.asarray(jout), rtol=TOL, atol=TOL)
    if st is None:
        return
    for name in ("h", "conv"):
        np.testing.assert_allclose(tret[name].numpy(), np.asarray(jst[name]), rtol=TOL, atol=TOL, err_msg=name)
    if mode == "collect":
        assert tret["h"].shape == (s, B, 64) and tret["conv"].shape == (s, B, 3, 64)
        for name in ("h", "conv"):  # the live state is left as it was
            np.testing.assert_array_equal(tst[name].numpy(), st[name])
    else:
        assert tret is tst  # updated in place


def test_rglru_scan_matches_jax(cfgs, params):
    """``recurrent.rglru_scan`` (gates, then K9's plain version) against the
    reference's ``lax.scan``: y, the last state and the trajectory."""
    jp, tp = params
    x = _x(4)
    h0 = _state(5)["h"]
    jy, jlast, jhs = JR.rglru_scan(jp, jnp.asarray(x), jnp.asarray(h0))
    ty, tlast, ths = R.rglru_scan(tp, torch.from_numpy(x), torch.from_numpy(h0))
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), rtol=TOL, atol=TOL)
    np.testing.assert_allclose(tlast.numpy(), np.asarray(jlast), rtol=TOL, atol=TOL)
    np.testing.assert_allclose(ths.permute(1, 0, 2).numpy(), np.asarray(jhs), rtol=TOL, atol=TOL)


@pytest.mark.parametrize("s", [0, 1, 7, 33])
def test_plain_scan_matches_a_jax_lax_scan(s):
    """K9's plain version against ``lax.scan`` of ``h = a·h + g`` on the same
    f32 inputs (the reference's step), and its launch count stays 0 on the
    CPU (a CPU tensor takes the plain version)."""
    rng = np.random.default_rng(s)
    a = rng.uniform(0.5, 1.0, (3, s, 40)).astype(np.float32)
    g = rng.standard_normal((3, s, 40)).astype(np.float32)
    h0 = rng.standard_normal((3, 40)).astype(np.float32)

    def step(h, inp):
        a_t, g_t = inp
        h = a_t * h + g_t
        return h, h

    jlast, jhs = jax.lax.scan(step, jnp.asarray(h0), (jnp.asarray(a).transpose(1, 0, 2), jnp.asarray(g).transpose(1, 0, 2)))
    reset_launch_counts()
    hs, last = rglru_scan(torch.from_numpy(a), torch.from_numpy(g), torch.from_numpy(h0))
    assert launch_counts()["rglru_scan"] == 0
    assert hs.shape == (3, s, 40)
    np.testing.assert_allclose(last.numpy(), np.asarray(jlast), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(hs.numpy(), np.asarray(jhs).transpose(1, 0, 2), rtol=1e-6, atol=1e-6)


def test_plain_scan_equals_single_steps_bit_for_bit():
    rng = np.random.default_rng(8)
    a = torch.from_numpy(rng.uniform(0.5, 1.0, (2, 19, 24)).astype(np.float32))
    g = torch.from_numpy(rng.standard_normal((2, 19, 24)).astype(np.float32))
    h = torch.from_numpy(rng.standard_normal((2, 24)).astype(np.float32))
    hs, last = rglru_scan_plain(a, g, h)
    steps = []
    for t in range(19):
        st, h = rglru_scan_plain(a[:, t : t + 1], g[:, t : t + 1], h)
        steps.append(st)
    assert torch.equal(torch.cat(steps, dim=1), hs) and torch.equal(h, last)


def test_rglru_block_scan_equals_stepwise_bit_for_bit(cfgs, params):
    """Inside the port (cf. the reference's ``test_rglru_scan_equals_stepwise``):
    S tokens through the block as one verify (``chunked``: each token a row
    of its own in the linears) equal S single-token steps bit for bit, the
    outputs, the final state and, with ``collect``, every per-token state."""
    _, tcfg = cfgs
    _, tp = params
    x = torch.from_numpy(_x(6))
    st = _state(7)
    with torch.no_grad():
        step_state, outs, hs, convs = _tstate(st), [], [], []
        for t in range(S):
            o, step_state = R.rglru_block(tp, tcfg, x[:, t : t + 1], step_state)
            outs.append(o)
            hs.append(step_state["h"].clone())
            convs.append(step_state["conv"].clone())
        full_state = _tstate(st)
        full, full_state = R.rglru_block(tp, tcfg, x, full_state, chunked=True)
        stacks = R.rglru_block(tp, tcfg, x, _tstate(st), collect=True, chunked=True)[1]
    assert torch.equal(full, torch.cat(outs, dim=1))
    assert torch.equal(full_state["h"], step_state["h"]) and torch.equal(full_state["conv"], step_state["conv"])
    assert torch.equal(stacks["h"], torch.stack(hs)) and torch.equal(stacks["conv"], torch.stack(convs))


def test_causal_conv1d_matches_jax():
    rng = np.random.default_rng(9)
    x = rng.standard_normal((2, 9, 16)).astype(np.float32)
    w = rng.standard_normal((4, 16)).astype(np.float32)
    st = rng.standard_normal((2, 3, 16)).astype(np.float32)
    for state in (None, st):
        jo, jn = JR._causal_conv1d(jnp.asarray(x), jnp.asarray(w), None if state is None else jnp.asarray(state))
        to, tn = R._causal_conv1d(torch.from_numpy(x), torch.from_numpy(w),
                                  None if state is None else torch.from_numpy(state))
        np.testing.assert_allclose(to.numpy(), np.asarray(jo), rtol=1e-6, atol=1e-6)
        np.testing.assert_array_equal(tn.numpy(), np.asarray(jn))


def test_collect_needs_a_state(cfgs, params):
    with pytest.raises(ValueError, match="collect=True requires a decoding state"):
        R.rglru_block(params[1], cfgs[1], torch.zeros((1, 2, 64)), None, collect=True)


def test_rglru_scan_wrapper_checks():
    a = torch.rand((2, 3, 8))
    with pytest.raises(TypeError, match="float32"):
        rglru_scan(a.double(), a.double(), torch.zeros((2, 8), dtype=torch.float64))
    with pytest.raises(ValueError, match=r"\(B, S, W\)"):
        rglru_scan(a, a[:, :2], torch.zeros((2, 8)))
    with pytest.raises(ValueError, match=r"\(B, S, W\)"):
        rglru_scan(a, a, torch.zeros((3, 8)))
