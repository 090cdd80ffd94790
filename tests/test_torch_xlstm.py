"""Port parity: the ssm family, xlstm-125m (mLSTM and sLSTM cells), against
the JAX package on the reference's reduced config (2 layers, d_model 64, 4
heads, f32; a 128-wide variant where quantization must bite), and the
port's own exactness invariants on it.

Against JAX: rtol = atol = 2e-4 for the blocks, the plain versions of the
scan kernels K10 (``kernels/mlstm_scan.py``) and K11
(``kernels/slstm_scan.py``), logits and states (the packages sum the same
f32 products in different orders; ``sigmoid`` and ``log_sigmoid`` are
written differently); cached prefill + decode against the no-cache forward
at the reference's own 5e-4 (``tests/test_models.py``); the cache's initial
values, the rollback primitives and greedy tokens bit for bit. Inside the
port, bit for bit: a scan of S tokens == S decode steps, a verify's rows ==
decode steps, speculative == plain greedy, slot == solo (with slot reuse),
warm == cold through the prefix cache, and the states collected at chosen
steps == the full stack's at those steps.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.infer import speculative as JS
from repro.infer.engine import Engine as JEngine
from repro.models import forward as jforward
from repro.models import init_cache as jinit_cache
from repro.models import init_params as jinit_params
from repro.models import recurrent as JR
from repro.models import reduced as jreduced
from repro.quant import QuantPolicy as JPolicy
from repro.quant import quantize_params as jquantize_params
from repro_torch.configs import get_config
from repro_torch.infer import Engine, PrefixCache, Request, Scheduler, SpecConfig
from repro_torch.infer import speculative as S
from repro_torch.kernels import launch_counts, mlstm_scan, mlstm_scan_plain, reset_launch_counts, slstm_scan
from repro_torch.kernels import slstm_scan_plain
from repro_torch.kernels.mlstm_scan import scale_for
from repro_torch.launch import serve
from repro_torch.models import forward, init_cache, init_params, params_from_numpy, reduced, reset_cache
from repro_torch.models import layers as L
from repro_torch.models import recurrent as R
from repro_torch.quant import QuantPolicy, quantize_params
from repro_torch.utils import tree_leaves
from torch_helpers import jax_tree_to_numpy, quantized_paths

TOL = 2e-4
TRAIN_TOL = 5e-4  # the reference's bound for cached prefill + decode against the train forward
WIDE = dict(d_model=128)  # every linear but the per-head gates quantizable (>= 128 wide)
ARCH = "xlstm-125m"
B = 2


def _cfgs(**kw):
    return jreduced(jget_config(ARCH), **kw), reduced(get_config(ARCH), **kw)


@pytest.fixture(scope="module")
def small():
    jcfg, tcfg = _cfgs()
    jp = jinit_params(jax.random.PRNGKey(0), jcfg)
    return jcfg, tcfg, jp, params_from_numpy(jax_tree_to_numpy(jp), device="cpu")


@pytest.fixture(scope="module")
def wide():
    jcfg, tcfg = _cfgs(**WIDE)
    jp = jinit_params(jax.random.PRNGKey(1), jcfg)
    jq = jquantize_params(jp, JPolicy(q=4, g=64, method="greedy"))
    return jcfg, tcfg, jp, jq


def _np(t):
    return t.float().numpy() if isinstance(t, torch.Tensor) else np.asarray(t, np.float32)


def _close(got, want, tol=TOL, msg=""):
    np.testing.assert_allclose(_np(got), np.asarray(want, np.float32), rtol=tol, atol=tol, err_msg=msg)


# -- the config ---------------------------------------------------------------


def test_config_has_the_reference_sizes():
    jc, tc = jget_config(ARCH), get_config(ARCH)
    for f in ("n_layers", "d_model", "n_heads", "n_kv_heads", "d_ff", "vocab", "d_head", "rope_theta", "stages",
              "family", "mlstm_proj_factor"):
        assert getattr(tc, f) == getattr(jc, f), f
    assert tc.stages == ((("mlstm", "slstm"), 6),)
    assert tc.block_counts() == jc.block_counts() == {"mlstm": 6, "slstm": 6}
    assert tc.supports_long_context
    assert R.mlstm_dims(tc) == (1536, 384)


@pytest.mark.parametrize("n_layers", [2, 4, 12])
def test_reduced_and_stages_match_the_reference(n_layers):
    jc, tc = _cfgs(n_layers=n_layers)
    assert tc.stages == jc.stages == ((("mlstm", "slstm"), n_layers // 2),)
    jr, tr = jreduced(jget_config(ARCH)), reduced(get_config(ARCH))
    for f in ("n_layers", "d_model", "n_heads", "d_ff", "vocab", "param_dtype", "compute_dtype", "stages",
              "mlstm_proj_factor"):
        assert getattr(tr, f) == getattr(jr, f), f
    assert tr.n_layers == 2


def _by_path(tree, path=()):
    """{path: leaf} of a nested dict / tuple tree (JAX sorts dict keys, the
    port keeps their order: compare by path)."""
    if isinstance(tree, dict):
        return {k: v for key, sub in tree.items() for k, v in _by_path(sub, path + (key,)).items()}
    if isinstance(tree, (tuple, list)):
        return {k: v for i, sub in enumerate(tree) for k, v in _by_path(sub, path + (i,)).items()}
    return {path: tree}


def _leaves(tree):
    """{path: (shape, dtype name)}."""
    return {p: (tuple(t.shape), str(t.dtype).split(".")[-1]) for p, t in _by_path(tree).items()}


def test_init_params_have_the_reference_leaves(small):
    """Every leaf of the port's ``init_params`` has the reference's path,
    shape and dtype (the mLSTM gates f32, ``r_*`` (NH, Dh, Dh), no MLP)."""
    _, tcfg, jp, _ = small
    assert _leaves(init_params(tcfg, seed=0, device="cpu")) == _leaves(jp)


@pytest.mark.parametrize("batch", [1, 3])
def test_init_cache_and_reset_give_the_reference_initial_state(small, batch):
    """``init_cache``: the reference's leaves, shapes and initial values bit
    for bit (``m = -inf``, sLSTM ``n = 1e-6``); ``reset_cache`` puts a
    scribbled cache back to them."""
    jcfg, tcfg, _, _ = small
    jc = jinit_cache(jcfg, batch, 16)
    tc = init_cache(tcfg, batch, 16, device="cpu")
    want = {p: np.asarray(x) for p, x in _by_path(jc).items()}

    def check():
        got = _by_path(tc)
        assert set(got) == set(want)
        for p, w in want.items():
            assert got[p].dtype == torch.float32 and tuple(got[p].shape) == w.shape, p
            np.testing.assert_array_equal(got[p].numpy(), w, err_msg=str(p))

    check()
    for leaf in tree_leaves(tc):
        leaf.normal_()
    assert reset_cache(tcfg, tc) is tc
    check()


# -- the blocks against the reference -------------------------------------------


@pytest.fixture(scope="module")
def cells(small):
    jcfg, tcfg, _, _ = small
    jm, js = JR.init_mlstm(jax.random.PRNGKey(3), jcfg), JR.init_slstm(jax.random.PRNGKey(4), jcfg)
    return {"mlstm": (JR.mlstm_block, R.mlstm_block, jm, params_from_numpy(jax_tree_to_numpy(jm), device="cpu")),
            "slstm": (JR.slstm_block, R.slstm_block, js, params_from_numpy(jax_tree_to_numpy(js), device="cpu"))}


def _x(seed, s, d=64):
    return np.random.default_rng(seed).standard_normal((B, s, d)).astype(np.float32)


def _random_state(cfg, btype, seed):
    """A state one might meet mid-sequence: random c, h, positive n, finite m."""
    rng = np.random.default_rng(seed)
    out = {}
    for name, shape in R.state_shapes(cfg, btype, B).items():
        v = rng.standard_normal(shape).astype(np.float32)
        out[name] = np.abs(v) + 0.5 if name == "n" else v
    return out


@pytest.mark.parametrize("btype", ["mlstm", "slstm"])
@pytest.mark.parametrize("mode", ["train", "train_one", "initial", "state", "decode", "collect"])
def test_block_matches_jax(small, cells, btype, mode):
    """The block's output and state against the reference's: no state (the
    mLSTM's quadratic form; at S = 1 the scan from the initial state), from
    the initial state, from a mid-sequence state over 12 tokens, one decode
    step, and the per-token stacks of ``collect=True``."""
    jcfg, tcfg, _, _ = small
    jfn, tfn, jp, tp = cells[btype]
    s = 1 if mode in ("decode", "train_one") else 12
    x = _x(1, s)
    if mode in ("train", "train_one"):
        st = None
    elif mode == "initial":  # the reference's init_cache: layer 0 of the cell's stacked state
        blk = jinit_cache(jcfg, B, 8)["stages"][0]["b0" if btype == "mlstm" else "b1"]
        st = {k: np.array(v[0]) for k, v in blk.items()}
    else:
        st = _random_state(tcfg, btype, 2)
    jout, jst = jfn(jp, jcfg, jnp.asarray(x), None if st is None else {k: jnp.asarray(v) for k, v in st.items()},
                    collect=mode == "collect")
    tst = None if st is None else {k: torch.from_numpy(v.copy()) for k, v in st.items()}
    with torch.no_grad():
        tout, tret = tfn(tp, tcfg, torch.from_numpy(x), tst, collect=mode == "collect")
    _close(tout, jout)
    if st is None:
        assert tret is None
        return
    for name in st:
        _close(tret[name], jst[name], msg=name)
    if mode == "collect":
        assert all(tret[name].shape[0] == s for name in st)
        for name in st:  # the live state is left as it was
            np.testing.assert_array_equal(tst[name].numpy(), st[name])
    else:
        assert tret is tst  # updated in place


def _qkvg(seed, s, b=2, nh=2, dh=16):
    r = np.random.default_rng(seed)
    q, k, v = (r.standard_normal((b, nh, s, dh)).astype(np.float32) for _ in range(3))
    ig = r.standard_normal((b, nh, s)).astype(np.float32)
    fg = (r.standard_normal((b, nh, s)) + 2.0).astype(np.float32)
    return q, k, v, ig, fg


@pytest.mark.parametrize("s", [1, 9, 64])
def test_mlstm_parallel_matches_jax(s):
    args = _qkvg(s, s)
    _close(R._mlstm_parallel(*map(torch.from_numpy, args)), JR._mlstm_parallel(*map(jnp.asarray, args)))


@pytest.mark.parametrize("s,chunk", [(64, 16), (128, 32), (300, 128), (37, 16)])
def test_mlstm_chunkwise_matches_jax(s, chunk):
    """The chunkwise form against the reference's, whole chunks and the pad
    path (S not a multiple of the chunk)."""
    args = _qkvg(s + chunk, s)
    _close(R._mlstm_chunkwise(*map(torch.from_numpy, args), chunk=chunk),
           JR._mlstm_chunkwise(*map(jnp.asarray, args), chunk=chunk))


def test_mlstm_block_takes_the_chunkwise_form_past_its_chunk(small, cells):
    """A train forward of 150 tokens (past ``MLSTM_CHUNK``) through the
    chunkwise form, against the reference's block."""
    jcfg, tcfg, _, _ = small
    jfn, tfn, jp, tp = cells["mlstm"]
    x = _x(5, 150)
    jout, _ = jfn(jp, jcfg, jnp.asarray(x), None)
    with torch.no_grad():
        tout, _ = tfn(tp, tcfg, torch.from_numpy(x), None)
    _close(tout, jout)


# -- the scan kernels' plain versions -------------------------------------------


def _mlstm_inputs(seed, b, s, nh=4, dh=16):
    rng = np.random.default_rng(seed)
    q, k, v = (rng.standard_normal((b, s, nh, dh)).astype(np.float32) for _ in range(3))
    ig = rng.standard_normal((b, s, nh)).astype(np.float32)
    fg = (rng.standard_normal((b, s, nh)) + 1.0).astype(np.float32)
    c = rng.standard_normal((b, nh, dh, dh)).astype(np.float32)
    n = rng.standard_normal((b, nh, dh)).astype(np.float32)
    m = rng.standard_normal((b, nh)).astype(np.float32)
    return q, k, v, ig, fg, c, n, m


def _jax_mlstm_steps(q, k, v, ig, fg, c, n, m, dh):
    """The reference's mLSTM step (``models/recurrent.py:293-312``) under a
    ``lax.scan``, inputs (B, S, NH, ...)."""

    def step(carry, inp):
        c, n, m = carry
        q_t, k_t, v_t, i_t, f_t = inp
        logf = jax.nn.log_sigmoid(f_t)
        m_new = jnp.maximum(logf + m, i_t)
        fg_ = jnp.exp(logf + m - m_new)
        ig_ = jnp.exp(i_t - m_new)
        scale = 1.0 / jnp.sqrt(jnp.float32(dh))
        kv = (ig_[..., None] * k_t * scale)[..., :, None] * v_t[..., None, :]
        c = fg_[..., None, None] * c + kv
        n = fg_[..., None] * n + ig_[..., None] * k_t * scale
        num = jnp.einsum("bhd,bhde->bhe", q_t, c)
        den = jnp.maximum(jnp.abs(jnp.einsum("bhd,bhd->bh", q_t, n)), jnp.exp(-m_new))
        return (c, n, m_new), (num / den[..., None], c, n, m_new)

    seq = tuple(jnp.asarray(t).swapaxes(0, 1) for t in (q, k, v, ig, fg))
    _, (h, cs, ns, ms) = jax.lax.scan(step, tuple(map(jnp.asarray, (c, n, m))), seq)
    return h.swapaxes(0, 1), cs, ns, ms


@pytest.mark.parametrize("b,s", [(1, 1), (2, 7), (3, 20)])
def test_mlstm_plain_scan_matches_the_reference_step(b, s):
    """K10's plain version against the reference's step under ``lax.scan``:
    h and the state at every step (the state left as it was), then h and
    the final state written in place; a CPU tensor launches nothing."""
    q, k, v, ig, fg, c, n, m = _mlstm_inputs(s, b, s)
    jh, jc, jn, jm = _jax_mlstm_steps(q, k, v, ig, fg, c, n, m, 16)
    t = [torch.from_numpy(x.copy()) for x in (q, k, v, ig, fg, c, n, m)]
    logf = torch.nn.functional.logsigmoid(t[4])
    reset_launch_counts()
    h, stacks = mlstm_scan(t[0], t[1], t[2], t[3], logf, t[5], t[6], t[7], scale_for(16), steps=range(s))
    _close(h, jh)
    for name, want, x0 in zip("cnm", (jc, jn, jm), (c, n, m)):
        _close(stacks[name], want, msg=name)
        assert torch.equal({"c": t[5], "n": t[6], "m": t[7]}[name], torch.from_numpy(x0))
    h, none = mlstm_scan(t[0], t[1], t[2], t[3], logf, t[5], t[6], t[7], scale_for(16))
    assert none is None and launch_counts()["mlstm_scan"] == 0
    _close(h, jh)
    for name, want in zip("cnm", (jc, jn, jm)):
        _close({"c": t[5], "n": t[6], "m": t[7]}[name], want[-1], msg=name)


def _jax_slstm_steps(pre, r, st):
    """The reference's sLSTM step (``models/recurrent.py:383-398``) under a
    ``lax.scan``, inputs (B, S, NH, Dh)."""
    rr = [jnp.asarray(w).astype(jnp.float32) for w in r]

    def step(carry, inp):
        h, c, n, m = carry
        pz, pi, pf, po = inp
        rec = lambda rm: jnp.einsum("bhd,hde->bhe", h, rm)  # noqa: E731
        z = jnp.tanh(pz + rec(rr[0]))
        i_log = pi + rec(rr[1])
        f_log = jax.nn.log_sigmoid(pf + rec(rr[2]))
        o = jax.nn.sigmoid(po + rec(rr[3]))
        m_new = jnp.maximum(f_log + m, i_log)
        ig = jnp.exp(i_log - m_new)
        fg = jnp.exp(f_log + m - m_new)
        c = fg * c + ig * z
        n = fg * n + ig
        h = o * c / jnp.maximum(n, 1e-6)
        return (h, c, n, m_new), (h, c, n, m_new)

    seq = tuple(jnp.asarray(t).swapaxes(0, 1) for t in pre)
    _, outs = jax.lax.scan(step, tuple(map(jnp.asarray, st)), seq)
    return outs


def _slstm_inputs(seed, b, s, nh=4, dh=16):
    rng = np.random.default_rng(seed)
    pre = [rng.standard_normal((b, s, nh, dh)).astype(np.float32) for _ in range(4)]
    r = [(rng.standard_normal((nh, dh, dh)) / np.sqrt(dh)).astype(np.float32) for _ in range(4)]
    st = [rng.standard_normal((b, nh, dh)).astype(np.float32) for _ in range(4)]
    st[2] = np.abs(st[2]) + 0.5
    return pre, r, st


@pytest.mark.parametrize("b,s", [(1, 1), (2, 7), (3, 20)])
def test_slstm_plain_scan_matches_the_reference_step(b, s):
    """K11's plain version against the reference's step under ``lax.scan``:
    hs and the state at every step (the state left as it was), then hs and
    the final state written in place; a CPU tensor launches nothing."""
    pre, r, st = _slstm_inputs(s, b, s)
    jh, jc, jn, jm = _jax_slstm_steps(pre, r, st)
    tst = [torch.from_numpy(x.copy()) for x in st]
    tpre, tr = [torch.from_numpy(x) for x in pre], [torch.from_numpy(x) for x in r]
    reset_launch_counts()
    hs, stacks = slstm_scan(tpre, tr, tst, steps=range(s))
    _close(hs, np.asarray(jh).swapaxes(0, 1))
    for name, want, live, x0 in zip("hcnm", (jh, jc, jn, jm), tst, st):
        _close(stacks[name], want, msg=name)
        assert torch.equal(live, torch.from_numpy(x0))
    hs, none = slstm_scan(tpre, tr, tst)
    assert none is None and launch_counts()["slstm_scan"] == 0
    _close(hs, np.asarray(jh).swapaxes(0, 1))
    for name, want, live in zip("hcnm", (jh, jc, jn, jm), tst):
        _close(live, want[-1], msg=name)


def test_plain_scans_equal_single_steps_bit_for_bit():
    """K10's and K11's plain versions: a scan of S steps == S calls at S = 1,
    outputs and final states, bit for bit."""
    q, k, v, ig, fg, c, n, m = (torch.from_numpy(x) for x in _mlstm_inputs(30, 2, 9))
    logf = torch.nn.functional.logsigmoid(fg)
    sc = scale_for(16)
    st_full = [t.clone() for t in (c, n, m)]
    h_full, _ = mlstm_scan_plain(q, k, v, ig, logf, *st_full, sc)
    st = [t.clone() for t in (c, n, m)]
    hs = [mlstm_scan_plain(q[:, t : t + 1], k[:, t : t + 1], v[:, t : t + 1], ig[:, t : t + 1],
                           logf[:, t : t + 1], *st, sc)[0] for t in range(9)]
    assert torch.equal(torch.cat(hs, dim=1), h_full)
    assert all(torch.equal(a, b) for a, b in zip(st, st_full))
    pre, r, s0 = _slstm_inputs(31, 2, 9)
    pre, r = [torch.from_numpy(x) for x in pre], [torch.from_numpy(x) for x in r]
    st_full = [torch.from_numpy(x.copy()) for x in s0]
    h_full, _ = slstm_scan_plain(pre, r, st_full)
    st = [torch.from_numpy(x.copy()) for x in s0]
    hs = [slstm_scan_plain([p[:, t : t + 1] for p in pre], r, st)[0] for t in range(9)]
    assert torch.equal(torch.cat(hs, dim=1), h_full)
    assert all(torch.equal(a, b) for a, b in zip(st, st_full))


@pytest.mark.parametrize("steps", [(0,), (3, 8), (1, 2, 5, 8)])
def test_selected_steps_equal_the_full_stack(steps):
    """States kept at chosen steps == the full per-step stack's entries
    there, bit for bit, and asking for steps leaves the state as it was."""
    q, k, v, ig, fg, c, n, m = (torch.from_numpy(x) for x in _mlstm_inputs(32, 2, 9))
    logf = torch.nn.functional.logsigmoid(fg)
    sc = scale_for(16)
    h_all, full = mlstm_scan_plain(q, k, v, ig, logf, c, n, m, sc, steps=range(9))
    h_sel, sel = mlstm_scan_plain(q, k, v, ig, logf, c, n, m, sc, steps=steps)
    assert torch.equal(h_all, h_sel)
    for name in "cnm":
        assert torch.equal(sel[name], full[name][list(steps)])
    assert torch.equal(c, torch.from_numpy(_mlstm_inputs(32, 2, 9)[5]))
    pre, r, s0 = _slstm_inputs(33, 2, 9)
    pre, r = [torch.from_numpy(x) for x in pre], [torch.from_numpy(x) for x in r]
    st = [torch.from_numpy(x.copy()) for x in s0]
    _, full = slstm_scan_plain(pre, r, st, steps=range(9))
    _, sel = slstm_scan_plain(pre, r, st, steps=steps)
    for name in "hcnm":
        assert torch.equal(sel[name], full[name][list(steps)])
    assert all(torch.equal(a, torch.from_numpy(b)) for a, b in zip(st, s0))


@pytest.mark.parametrize("btype", ["mlstm", "slstm"])
def test_block_scan_equals_stepwise_bit_for_bit(small, cells, btype):
    """Inside the port (cf. the reference's ``test_mlstm_block_state_continuation``):
    S tokens through the block as one verify (``chunked``) equal S
    single-token steps bit for bit: the outputs, the final state and, with
    ``collect``, every per-token state; a chosen step's state equals the
    full stack's."""
    _, tcfg, _, _ = small
    _, tfn, _, tp = cells[btype]
    x = torch.from_numpy(_x(6, 11))
    st = _random_state(tcfg, btype, 7)
    fresh = lambda: {k: torch.from_numpy(v.copy()) for k, v in st.items()}  # noqa: E731
    with torch.no_grad():
        step_state, outs, states = fresh(), [], []
        for t in range(11):
            o, step_state = tfn(tp, tcfg, x[:, t : t + 1], step_state)
            outs.append(o)
            states.append({k: v.clone() for k, v in step_state.items()})
        full, full_state = tfn(tp, tcfg, x, fresh(), chunked=True)
        stacks = tfn(tp, tcfg, x, fresh(), collect=True, chunked=True)[1]
        picked = tfn(tp, tcfg, x, fresh(), collect=(2, 10), chunked=True)[1]
    assert torch.equal(full, torch.cat(outs, dim=1))
    for name in st:
        assert torch.equal(full_state[name], step_state[name]), name
        assert torch.equal(stacks[name], torch.stack([s[name] for s in states])), name
        assert torch.equal(picked[name], stacks[name][[2, 10]]), name


def test_collect_needs_a_state(small, cells):
    _, tcfg, _, _ = small
    for btype in ("mlstm", "slstm"):
        with pytest.raises(ValueError, match="collect=True requires a decoding state"):
            cells[btype][1](cells[btype][3], tcfg, torch.zeros((1, 2, 64)), None, collect=True)


def test_scan_wrapper_checks():
    q = torch.zeros((2, 3, 4, 8))
    g = torch.zeros((2, 3, 4))
    c, n, m = torch.zeros((2, 4, 8, 8)), torch.zeros((2, 4, 8)), torch.zeros((2, 4))
    with pytest.raises(ValueError, match="must be"):
        mlstm_scan(q, q, q, g, g, c, n[:1], m, 1.0)
    with pytest.raises(TypeError, match="float32"):
        mlstm_scan(q, q, q.double(), g, g, c, n, m, 1.0)
    with pytest.raises(ValueError, match="ascending"):
        mlstm_scan(q, q, q, g, g, c, n, m, 1.0, steps=(2, 1))
    with pytest.raises(ValueError, match="ascending"):
        mlstm_scan(q, q, q, g, g, c, n, m, 1.0, steps=(3,))
    st = [n.clone() for _ in range(4)]
    r = [torch.zeros((4, 8, 8)) for _ in range(4)]
    with pytest.raises(ValueError, match="must be"):
        slstm_scan([q] * 4, r[:3] + [torch.zeros((4, 8, 7))], st)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        slstm_scan([q] * 4, r[:3] + [r[3].bfloat16()], st)
    with pytest.raises(ValueError, match="four"):
        slstm_scan([q] * 3, r, st)


# -- the model against JAX -------------------------------------------------------


def _jax_run(jcfg, jp, toks, s, n):
    cache = jinit_cache(jcfg, toks.shape[0], s + n + 4)
    out = []
    logits, cache, _ = jforward(jcfg, jp, tokens=jnp.asarray(toks[:, :s]), cache=cache, pos=jnp.int32(0),
                                logits_mode="last")
    out.append(np.asarray(logits[:, -1]))
    for t in range(n):
        logits, cache, _ = jforward(jcfg, jp, tokens=jnp.asarray(toks[:, s + t : s + t + 1]), cache=cache,
                                    pos=jnp.int32(s + t), logits_mode="last")
        out.append(np.asarray(logits[:, -1]))
    return np.stack(out), cache


def _port_run(tcfg, tp, toks, s, n, per_row=False):
    cache = init_cache(tcfg, toks.shape[0], s + n + 4, device="cpu")
    tt = torch.from_numpy(toks).long()
    out = []
    with torch.no_grad():
        logits, cache = forward(tcfg, tp, tokens=tt[:, :s], cache=cache, pos=0, logits_mode="last", prefill=True)
        out.append(logits[:, -1].numpy())
        for t in range(n):
            pos = torch.full((toks.shape[0],), s + t) if per_row else s + t
            logits, cache = forward(tcfg, tp, tokens=tt[:, s + t : s + t + 1], cache=cache, pos=pos,
                                    logits_mode="last")
            out.append(logits[:, -1].numpy())
    return np.stack(out), cache


def _assert_caches_close(tcache, jcache, tol=TOL):
    for si, stage in enumerate(jcache["stages"]):
        for key, blk in stage.items():
            for name, leaf in blk.items():
                got, want = _np(tcache["stages"][si][key][name]), np.asarray(leaf, np.float32)
                assert got.shape == want.shape, (si, key, name)
                np.testing.assert_allclose(got, want, rtol=tol, atol=tol, err_msg=f"{si}/{key}/{name}")


@pytest.mark.parametrize("per_row", [False, True], ids=["scalar_pos", "row_pos"])
def test_forward_logits_and_states_match_jax(small, per_row):
    """A 20-token prompt, then 10 decode steps: logits at every step and
    every state at the end, against the reference."""
    jcfg, tcfg, jp, tp = small
    toks = np.random.default_rng(0).integers(0, 256, (B, 30)).astype(np.int32)
    want, jcache = _jax_run(jcfg, jp, toks, 20, 10)
    got, tcache = _port_run(tcfg, tp, toks, 20, 10, per_row=per_row)
    _close(got, want)
    _assert_caches_close(tcache, jcache)


def test_quantization_selects_the_reference_leaves(wide):
    """The port's quantizer packs exactly the leaves the reference's does:
    the mLSTM's and sLSTM's projections and the LM head, not the (inner, NH)
    gates, the recurrent ``r_*`` or ``skip_scale``."""
    jcfg, tcfg, jp, jq = wide
    tq = quantize_params(params_from_numpy(jax_tree_to_numpy(jp), device="cpu"),
                         QuantPolicy(q=4, g=64, method="greedy", iters=1), device="cpu")
    want = {tuple(str(k) for k in p): v for p, v in quantized_paths(jq).items()}
    got = {tuple(str(k) for k in p): v for p, v in quantized_paths(tq).items()}
    assert got == want
    names = {p[-1] for p in got}
    assert names == {"w_up", "w_z", "wq", "wk", "wv", "w_down", "w_i", "w_f", "w_o", "w_out", "lm_head"}
    assert all(p[-1] not in ("w_i", "w_f") or "b1" in p for p in got)  # the mLSTM's (inner, NH) gates stay dense


def test_forward_quantized_matches_jax_on_ref(wide):
    """bcq (q = 4, g = 64) on every quantizable linear of the 128-wide model;
    the port's CPU products take the ref oracle."""
    jcfg, tcfg, _, jq = wide
    tq = params_from_numpy(jax_tree_to_numpy(jq), device="cpu")
    toks = np.random.default_rng(2).integers(0, 256, (B, 30)).astype(np.int32)
    want, _ = _jax_run(jcfg, jq, toks, 22, 8)
    got, _ = _port_run(tcfg, tq, toks, 22, 8)
    _close(got, want)


@pytest.mark.parametrize("s", [9, 150])
def test_train_forward_matches_jax(small, s):
    """No cache: the quadratic form (9 tokens) and the chunkwise form (150)."""
    jcfg, tcfg, jp, tp = small
    toks = np.random.default_rng(3).integers(0, 256, (B, s)).astype(np.int32)
    want, _, _ = jforward(jcfg, jp, tokens=jnp.asarray(toks))
    with torch.no_grad():
        got, _ = forward(tcfg, tp, tokens=torch.from_numpy(toks).long())
    _close(got, want)


def test_prefill_decode_matches_train_forward(small):
    """(the reference's ``test_prefill_decode_matches_train_forward`` for
    xlstm-125m, at its 5e-4) cached prefill of S - 1 tokens then one decode
    step give the no-cache forward's last two positions' logits."""
    _, tcfg, _, tp = small
    toks = torch.from_numpy(np.random.default_rng(4).integers(0, 256, (B, 16))).long()
    with torch.no_grad():
        full, _ = forward(tcfg, tp, tokens=toks)
        cache = init_cache(tcfg, B, 16, device="cpu")
        pre, cache = forward(tcfg, tp, tokens=toks[:, :15], cache=cache, pos=0, logits_mode="last", prefill=True)
        dec, _ = forward(tcfg, tp, tokens=toks[:, 15:], cache=cache, pos=15, logits_mode="last")
    _close(pre[:, -1], full[:, 14].numpy(), TRAIN_TOL)
    _close(dec[:, -1], full[:, 15].numpy(), TRAIN_TOL)


def test_collect_states_match_jax_and_selected_steps(small):
    """``forward(collect_states=True)`` on a verify chunk: the per-token
    stacks ((repeat, S, B, ...)) against the reference's, the live cache
    left as it was; ``collect_states=(1, 4)`` keeps those entries only, bit
    for bit."""
    jcfg, tcfg, jp, tp = small
    toks = np.random.default_rng(6).integers(0, 256, (B, 25)).astype(np.int32)
    _, jcache = _jax_run(jcfg, jp, toks, 20, 0)
    _, tcache = _port_run(tcfg, tp, toks, 20, 0)
    before = [leaf.clone() for leaf in tree_leaves(L.snapshot_recurrent(tcache))]
    chunk = toks[:, 20:]
    _, jv, _ = jforward(jcfg, jp, tokens=jnp.asarray(chunk), cache=jcache, pos=jnp.full((B,), 20, jnp.int32),
                        logits_mode="all", chunked_decode=True, collect_states=True)
    with torch.no_grad():
        tl, tv = forward(tcfg, tp, tokens=torch.from_numpy(chunk).long(), cache=tcache, pos=torch.full((B,), 20),
                         logits_mode="all", chunked_decode=True, collect_states=True)
        tl2, tsel = forward(tcfg, tp, tokens=torch.from_numpy(chunk).long(), cache=tcache,
                            pos=torch.full((B,), 20), logits_mode="all", chunked_decode=True,
                            collect_states=(1, 4))
    _assert_caches_close(tv, jv)
    assert torch.equal(tl, tl2)
    for a, b in zip(tree_leaves(tv), tree_leaves(tsel)):
        assert torch.equal(a[:, [1, 4]], b)
    after = tree_leaves(L.snapshot_recurrent(tcache))
    assert all(torch.equal(a, b) for a, b in zip(before, after))


def test_greedy_generate_equals_jax(small):
    """The port's greedy tokens equal the JAX engine's, through the
    captured-step path and the eager loop."""
    jcfg, tcfg, jp, tp = small
    prompts = np.random.default_rng(7).integers(0, 256, (B, 12)).astype(np.int32)
    want = JEngine(jcfg, jp, max_seq=64).generate(prompts, 20).tokens
    eng = Engine(tcfg, tp, max_seq=64, device="cpu")
    np.testing.assert_array_equal(eng.generate(prompts, 20).tokens, want)
    np.testing.assert_array_equal(eng.generate(prompts, 20, scan=False).tokens, want)


# -- the rollback primitives against the reference ---------------------------------


def _filled(small, s=20):
    jcfg, tcfg, jp, tp = small
    toks = np.random.default_rng(8).integers(0, 256, (B, s)).astype(np.int32)
    _, jcache = _jax_run(jcfg, jp, toks, s, 0)
    return jcache, params_from_numpy(jax_tree_to_numpy(jcache), device="cpu")


def test_select_recurrent_match_jax(small):
    """The target and draft selections over mLSTM and sLSTM leaves (``h`` of
    (B, NH, Dh), ``c`` of (B, NH, Dh, Dh) and (B, NH, Dh), ``m`` of (B, NH)
    and (B, NH, Dh): shapes differ by block under one name) bit for bit."""
    jcfg, tcfg, jp, tp = small
    jcache, tcache = _filled(small)
    chunk = np.random.default_rng(10).integers(0, 256, (B, 5)).astype(np.int32)
    _, jv, _ = jforward(jcfg, jp, tokens=jnp.asarray(chunk), cache=jcache, pos=jnp.full((B,), 20, jnp.int32),
                        logits_mode="all", chunked_decode=True, collect_states=True)
    tv = params_from_numpy(jax_tree_to_numpy(jv), device="cpu")
    idx = np.array([3, 0], np.int32)
    want = JS.select_recurrent_target(jv, jnp.asarray(idx))
    got = S.select_recurrent_target(tv, torch.from_numpy(idx))
    for a, b in zip(jax.tree_util.tree_leaves(want), tree_leaves(got)):
        np.testing.assert_array_equal(_np(b), np.asarray(a, np.float32))
    steps = [JS._recurrent_only(jax.tree_util.tree_map(lambda x, i=i: x + i, jcache)) for i in range(4)]
    jst = jax.tree_util.tree_map(lambda *xs: jnp.stack(xs), *steps)
    want = JS.select_recurrent_draft(jcache, jst, jnp.asarray(idx))
    tsteps = [S._recurrent_only(params_from_numpy(jax_tree_to_numpy(jax.tree_util.tree_map(lambda x, i=i: x + i, jcache)),
                                                  device="cpu")) for i in range(4)]
    got = S.select_recurrent_draft(tcache, S._stack_trees(tsteps), torch.from_numpy(idx))
    for a, b in zip(jax.tree_util.tree_leaves(want), tree_leaves(got)):
        np.testing.assert_array_equal(_np(b), np.asarray(a, np.float32))


def test_rejected_chunk_leaves_no_trace(small):
    """A verify chunk of junk rolled back entirely (the recurrent state at
    the chunk's start): the next step's logits equal those of a cache that
    never saw the junk, bit for bit."""
    _, tcfg, _, tp = small
    toks = np.random.default_rng(11).integers(0, 256, (B, 21)).astype(np.int32)
    caches = []
    for _ in range(2):
        c = init_cache(tcfg, B, 40, device="cpu")
        with torch.no_grad():
            forward(tcfg, tp, tokens=torch.from_numpy(toks[:, :20]).long(), cache=c, pos=0, logits_mode="last",
                    prefill=True)
        caches.append(c)
    pos = torch.full((B,), 20)
    state = S._recurrent_only(caches[1])
    with torch.no_grad():
        forward(tcfg, tp, tokens=torch.tensor([[3, 5, 7, 11], [13, 2, 4, 8]]), cache=caches[1], pos=pos,
                logits_mode="all", chunked_decode=True, collect_states=True)
        forward(tcfg, tp, tokens=torch.tensor([[9, 9], [1, 1]]), cache=caches[1], pos=pos, logits_mode="all",
                chunked_decode=True)  # a chunk that wrote the live state, then rolled back below
        L.install_recurrent(caches[1], state)
        tok = torch.from_numpy(toks[:, 20:21]).long()
        want, _ = forward(tcfg, tp, tokens=tok, cache=caches[0], pos=pos, logits_mode="last")
        got, _ = forward(tcfg, tp, tokens=tok, cache=caches[1], pos=pos, logits_mode="last")
    assert torch.equal(got, want)


# -- the port's exactness invariants ----------------------------------------------


@pytest.fixture(scope="module")
def qengine():
    """The 128-wide model in bcq (q = 4, g = 32, so every projection is packed)."""
    cfg = reduced(get_config(ARCH), **WIDE)
    params = quantize_params(init_params(cfg, seed=0, device="cpu"), QuantPolicy(q=4, g=32, iters=2), device="cpu")
    return Engine(cfg, params, max_seq=96, device="cpu")


def test_verify_rows_equal_decode_steps(qengine):
    """A verify of 5 tokens gives each position the bits of a decode step
    there, and leaves the cache a decode loop leaves."""
    eng, cfg = qengine, qengine.cfg
    rng = np.random.default_rng(12)
    prompt = torch.from_numpy(rng.integers(0, 256, (3, 30))).long()
    chunk = torch.from_numpy(rng.integers(0, 256, (3, 5))).long()
    pos = torch.tensor([30, 30, 30])
    _, c_chunk = eng.prefill(prompt, eng._make_cache(3))
    _, c_step = eng.prefill(prompt, eng._make_cache(3))
    with torch.no_grad():
        got, _ = forward(cfg, eng.params, tokens=chunk, cache=c_chunk, pos=pos, logits_mode="all",
                         chunked_decode=True)
    steps = []
    for t in range(5):
        lg, c_step = eng.decode(chunk[:, t : t + 1], c_step, pos + t)
        steps.append(lg)
    assert torch.equal(got, torch.stack(steps, dim=1))
    for a, b in zip(tree_leaves(c_chunk), tree_leaves(c_step)):
        assert torch.equal(a, b)


def test_scan_from_the_initial_state_equals_decode_steps(qengine):
    """S tokens from a fresh cache as one chunked forward (K10 / K11 over S
    steps, each token a row of its own in the linears) equal the same
    tokens as S decode steps, logits and every state bit for bit. (A
    prompt's prefill runs its linears as a prompt's rows, which the CPU's
    products sum by row count; on the card they run in fixed tiles and
    ``tests/test_torch_cuda.py`` holds a prefill to its decode steps.)"""
    eng, cfg = qengine, qengine.cfg
    toks = torch.from_numpy(np.random.default_rng(13).integers(0, 256, (2, 17))).long()
    c_scan, c_step = eng._make_cache(2), eng._make_cache(2)
    with torch.no_grad():
        got, _ = forward(cfg, eng.params, tokens=toks, cache=c_scan, pos=torch.zeros(2, dtype=torch.long),
                         logits_mode="all", chunked_decode=True)
    steps = []
    for t in range(17):
        lg, c_step = eng.decode(toks[:, t : t + 1], c_step, torch.full((2,), t))
        steps.append(lg)
    assert torch.equal(got, torch.stack(steps, dim=1))
    for a, b in zip(tree_leaves(c_scan), tree_leaves(c_step)):
        assert torch.equal(a, b)


@pytest.mark.parametrize("spec", [SpecConfig(1, 3), SpecConfig(2, 4), SpecConfig(4, 4)], ids=["q1g3", "q2g4", "q4g4"])
def test_spec_greedy_equals_plain(qengine, spec):
    """(the reference's ``test_spec_greedy_identical_recurrent_and_window``,
    ``mlstm+slstm``) speculative greedy == plain greedy; q' = q accepts every
    proposal before the cut, in a run that does not end on a chunk
    boundary."""
    prompts = np.random.default_rng(14).integers(0, 256, (3, 20)).astype(np.int32)
    plain = qengine.generate(prompts, 23)
    got = qengine.generate(prompts, 23, speculate=spec)
    np.testing.assert_array_equal(got.tokens, plain.tokens)
    st = got.spec_stats
    assert st["committable"] < st["proposed"]  # 22 tokens after the first: not whole chunks of γ + 1
    if spec.q_draft == 4:
        assert st["accepted"] == st["committable"]


def _requests(n, lens, seed=15, gen=10):
    rng = np.random.default_rng(seed)
    return [Request(prompt=rng.integers(0, 256, lens[i % len(lens)]).astype(np.int32), max_new_tokens=gen + i % 4,
                    temperature=[0.0, 1.0, 0.7][i % 3], seed=i, rid=i) for i in range(n)]


def _solo(eng, reqs):
    return {r.rid: eng.generate(r.prompt[None], r.max_new_tokens, temperature=r.temperature,
                                seed=r.seed).tokens[0, r.prompt.size :].tolist() for r in reqs}


def _serve(eng, reqs, **kw):
    sched = Scheduler(eng, **kw)
    for r in reqs:
        sched.submit(dataclasses.replace(r))
    return {c.rid: c.new_tokens.tolist() for c in sched.run()}


def test_slots_equal_solo(qengine):
    """8 requests, prompts of 5..40 tokens, greedy and sampled, through 4
    slots (each reused after a tenant): each equals its solo ``generate``."""
    reqs = _requests(8, [5, 40, 17, 23, 9, 31, 12, 3])
    assert _serve(qengine, reqs, n_slots=4, chunk=4) == _solo(qengine, reqs)


def test_a_reused_slot_equals_a_fresh_one(qengine):
    """An admission resets the slot's state to the initial values (m = -inf,
    sLSTM n = 1e-6), not to zeros: a slot that served a tenant gives the
    next prompt's first logits bit for bit as a fresh slot batch does."""
    eng = qengine
    rng = np.random.default_rng(16)
    first, second = (rng.integers(0, 256, n).astype(np.int32) for n in (9, 6))
    slots = eng.init_slots(2)
    eng.admit_slot(slots, 1, first, max_new_tokens=4)
    eng.decode_slots(slots, 3)
    eng.admit_slot(slots, 1, second, max_new_tokens=4)
    fresh = eng.init_slots(2)
    eng.admit_slot(fresh, 1, second, max_new_tokens=4)
    assert torch.equal(slots["logits"][1], fresh["logits"][1])
    for a, b in zip(tree_leaves(eng._slot_cache(slots, 1)), tree_leaves(eng._slot_cache(fresh, 1))):
        assert torch.equal(a, b)
    zeroed = eng.init_slots(2)  # a reset to zeros instead would change the first token's gates
    for leaf in tree_leaves(eng._slot_cache(zeroed, 1)):
        leaf.zero_()
    with torch.no_grad():
        lg, _ = forward(eng.cfg, eng.params, tokens=torch.from_numpy(second[None]).long(),
                        cache=eng._slot_cache(zeroed, 1), pos=0, logits_mode="last", prefill=True)
    assert not torch.equal(lg[0, -1], fresh["logits"][1])


def test_spec_slots_equal_solo(qengine):
    """Speculative slots: greedy requests and sampled ones that opt out give
    their solo plain ``generate``'s tokens."""
    reqs = [dataclasses.replace(r, speculate=r.temperature == 0.0) for r in _requests(6, [6, 33, 14, 21])]
    got = _serve(qengine, reqs, n_slots=3, chunk=2, speculate=SpecConfig(2, 3))
    want = _solo(qengine, reqs)
    for r in reqs:
        if r.temperature == 0.0 or not r.speculate:
            assert got[r.rid] == want[r.rid], r.rid


def _admission(eng, prompt):
    slots = eng.init_slots(1)
    p = eng.begin_admission(prompt, max_new_tokens=6)
    while not p.done:
        eng.advance_admission(p)
    eng.finish_admission(slots, 0, p)
    logits = slots["logits"][0].clone()
    toks, _, _ = eng.decode_slots(slots, 5)
    return logits, toks[0]


def test_warm_equals_cold(qengine):
    """(the reference's ``test_recurrent_arch_warm_identity``) a shared
    12-token prefix in blocks of 4: warm admissions install the prefix's
    boundary state (c, n, m of every cell) and prefill only the tail, and
    give the cold admission's tokens, and its last-prompt logits within 2e-4
    (the tail's linears run as a shorter prompt's rows, which the CPU's
    products sum by row count; on the card, in fixed tiles, they are equal
    bit for bit: ``tests/test_torch_cuda.py``); every committed block
    carries its snapshot, counted in the cache's bytes."""
    cold = qengine
    pc = PrefixCache(block_tokens=4, max_bytes=1 << 26)
    warm = Engine(cold.cfg, cold.params, max_seq=96, fuse=False, device="cpu", prefix_cache=pc)
    rng = np.random.default_rng(17)
    shared = rng.integers(0, 256, 12)
    prompts = [np.concatenate([shared, rng.integers(0, 256, n)]).astype(np.int32) for n in (3, 6, 1, 8)]
    for i, prompt in enumerate(prompts):
        want_l, want_t = _admission(cold, prompt)
        got_l, got_t = _admission(warm, prompt)
        assert warm.take_prefix_handle().length == (0 if i == 0 else 12)
        np.testing.assert_array_equal(got_t, want_t)
        torch.testing.assert_close(got_l, want_l, rtol=TOL, atol=TOL)
    assert pc._nodes and all(n.snap is not None for n in pc._nodes)
    snap_bytes = sum(leaf.numel() * leaf.element_size() for n in pc._nodes for leaf in tree_leaves(n.snap))
    assert pc.cached_bytes >= snap_bytes > 0
    assert all(torch.isfinite(leaf).all() for n in pc._nodes for leaf in tree_leaves(n.snap))
    assert pc.pinned == 0 and pc.counters["hits"] + pc.counters["misses"] == pc.counters["commits"]


def test_warm_wave_equals_cold_wave_through_the_scheduler(qengine):
    warm = Engine(qengine.cfg, qengine.params, max_seq=96, fuse=False, device="cpu",
                  prefix_cache=PrefixCache(block_tokens=4, max_bytes=1 << 26))
    rng = np.random.default_rng(18)
    shared = rng.integers(0, 256, 8)
    reqs = [Request(prompt=np.concatenate([shared, rng.integers(0, 256, n)]).astype(np.int32), max_new_tokens=6,
                    temperature=[0.0, 0.9][i % 2], seed=7 + i, rid=i) for i, n in enumerate((2, 5, 7, 20))]
    cold_wave = _serve(warm, reqs, n_slots=2, chunk=3)
    warm_wave = _serve(warm, reqs, n_slots=2, chunk=3)
    assert warm_wave == cold_wave == _solo(qengine, reqs)
    assert warm.prefix_cache.counters["hits"] >= 3


def test_committing_prefill_keeps_only_the_boundary_states(qengine, monkeypatch):
    """A committing prefill collects the states after its blocks' last tokens
    and its own last token, not one a token: the collected stacks of a
    23-token prompt in blocks of 4 hold 5 + 1 states, and their snapshots
    equal those of a prefill that collected every step."""
    pc = PrefixCache(block_tokens=4, max_bytes=1 << 26)
    eng = Engine(qengine.cfg, qengine.params, max_seq=96, fuse=False, device="cpu", prefix_cache=pc)
    prompt = np.random.default_rng(19).integers(0, 256, 23).astype(np.int32)
    seen = []
    real = forward

    def spy(*a, **kw):
        logits, tree = real(*a, **kw)
        if kw.get("collect_states") not in (False, None):
            seen.append((kw["collect_states"], tree))
        return logits, tree

    monkeypatch.setattr("repro_torch.infer.engine.forward", spy)
    slots = eng.init_slots(1)
    eng.admit_slot(slots, 0, prompt, max_new_tokens=2)
    (steps, tree), = seen
    assert steps == (3, 7, 11, 15, 19, 22)
    mlstm_c = tree["stages"][0]["b0"]["c"]
    assert mlstm_c.shape[1] == 6
    cache = eng._admission_cache(23)
    with torch.no_grad():
        _, full = real(eng.cfg, eng.params, tokens=torch.from_numpy(prompt[None]).long(), cache=cache, pos=0,
                       logits_mode="last", prefill=True, collect_states=True)
    for a, b in zip(tree_leaves(L.snapshot_recurrent(tree)), tree_leaves(L.snapshot_recurrent(full))):
        assert torch.equal(a, b[:, list(steps)])
    snaps = sorted(pc._nodes, key=lambda n: n.end)
    for node in snaps:
        for a, b in zip(tree_leaves(node.snap), tree_leaves(L.snapshot_recurrent(full))):
            assert torch.equal(a, b[:, node.end - 1])


# -- refusals and the CLI ----------------------------------------------------------


def test_chunked_prefill_is_refused_with_the_reference_reason(qengine):
    assert not qengine.supports_chunked_prefill
    with pytest.raises(ValueError, match="ring-buffer and recurrent"):
        qengine.begin_admission(np.arange(6), max_new_tokens=2, chunked=True)
    with pytest.raises(ValueError, match="recurrent state folds pad tokens"):
        Scheduler(qengine, n_slots=2, prefill_chunk=4)
    with pytest.raises(SystemExit):
        serve.main(["--arch", ARCH, "--device", "cpu", "--prefill-chunk", "4"])


def test_serve_cli_runs_xlstm(capsys):
    serve.main(["--device", "cpu", "--arch", ARCH, "--speculate", "2:4", "--prefix-cache-mb", "8",
                "--requests", "6", "--gen", "6"])
    out = capsys.readouterr().out
    assert "draft acceptance" in out and "prefix cache:" in out

