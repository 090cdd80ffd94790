"""Port parity: the hybrid family, recurrentgemma-9b (RG-LRU blocks and
local attention on a ring cache), against the JAX package on the reference's
reduced config (5 layers, d_model 64, window 16, lru_width 64, f32; a
128-wide variant where quantization must bite), and the port's own
exactness invariants on it.

Against JAX: rtol = atol = 2e-4 for logits, decode states and ring caches
(the packages sum the same f32 products in different orders); ring-cache
writes of the same K/V, the int8 codes and scales, the rollback primitives
and greedy tokens bit for bit. Inside the port, bit for bit: slot == solo,
speculative == plain greedy (the ring wraps, rejected writes overwrite
live rows), warm == cold through the prefix cache, and a verify's rows ==
decode steps.
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
from repro.models import layers as JL
from repro.models import reduced as jreduced
from repro.models.config import ModelConfig as JModelConfig
from repro.quant import QuantPolicy as JPolicy
from repro.quant import quantize_params as jquantize_params
from repro_torch.configs import get_config
from repro_torch.infer import Engine, PrefixCache, Request, Scheduler, SpecConfig
from repro_torch.infer import speculative as S
from repro_torch.launch import serve
from repro_torch.models import forward, init_cache, init_params, params_from_numpy, reduced
from repro_torch.models import layers as L
from repro_torch.models.config import ModelConfig
from repro_torch.quant import QuantPolicy, quantize_params
from repro_torch.utils import tree_leaves
from torch_helpers import jax_tree_to_numpy

TOL = 2e-4
WIDE = dict(d_model=128, lru_width=128, d_ff=256)  # every linear quantizable (>= 128 wide)
ARCH = "recurrentgemma-9b"


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


# -- the config ---------------------------------------------------------------


def test_config_has_the_reference_sizes():
    jc, tc = jget_config(ARCH), get_config(ARCH)
    for f in ("n_layers", "d_model", "n_heads", "n_kv_heads", "d_ff", "vocab", "d_head", "window",
              "lru_width", "conv_width", "rope_theta", "stages", "family"):
        assert getattr(tc, f) == getattr(jc, f), f
    assert tc.stages == ((("rglru", "rglru", "local_attn"), 12), (("rglru", "rglru"), 1))
    assert tc.block_counts() == jc.block_counts() == {"rglru": 26, "local_attn": 12}
    assert tc.supports_long_context and not get_config("llama3.2-3b").supports_long_context


@pytest.mark.parametrize("n_layers", [1, 3, 5, 6])
def test_reduced_and_stages_match_the_reference(n_layers):
    jc, tc = _cfgs(n_layers=n_layers)
    assert tc.stages == jc.stages
    jr, tr = jreduced(jget_config(ARCH)), reduced(get_config(ARCH))
    for f in ("n_layers", "d_model", "n_heads", "n_kv_heads", "d_ff", "vocab", "window", "lru_width",
              "param_dtype", "compute_dtype", "stages"):
        assert getattr(tr, f) == getattr(jr, f), f
    assert tr.n_layers == 5 and tr.window == 16


@pytest.mark.parametrize("family,missing", [("ssm", "xLSTM"), ("moe", "MoE"), ("vlm", "cross-attention"),
                                            ("audio", "frame-embedding")])
def test_unported_families_name_what_is_missing(family, missing):
    """Every family of the reference is ported now; each case checks that
    its family builds the reference's stages and refuses a layer count the
    reference refuses: odd for ssm (the xLSTM cells), one that the MoE
    period does not divide, one that the vlm family's cross-attention
    period does not divide; the audio family (frame-embedding inputs) is
    ``("attn",)`` times L at any L."""
    kw = dict(name="x", family=family, d_model=64, n_heads=4, n_kv_heads=2, d_ff=128, vocab=256)
    if family == "ssm":
        assert ModelConfig(n_layers=4, **kw).stages == jreduced(jget_config("xlstm-125m"), n_layers=4).stages
        with pytest.raises(ValueError, match="even layer count"):
            ModelConfig(n_layers=3, **kw)
        return
    if family == "moe":
        moe = dict(n_experts=8, top_k=2, moe_period=2)
        want = jreduced(jget_config("llama4-maverick-400b-a17b"), n_layers=4, moe_period=2).stages
        assert ModelConfig(n_layers=4, **moe, **kw).stages == want == ((("attn", "attn_moe"), 2),)
        with pytest.raises(ValueError, match="must divide by period"):
            ModelConfig(n_layers=3, **moe, **kw)
        return
    if family == "vlm":
        want = jreduced(jget_config("llama-3.2-vision-90b"), n_layers=10).stages
        assert ModelConfig(n_layers=10, **kw).stages == want == ((("attn",) * 4 + ("cross",), 2),)
        for cls in (ModelConfig, JModelConfig):
            with pytest.raises(ValueError, match="vlm layers 7 must divide by period 5"):
                cls(n_layers=7, **kw)
        return
    for n_layers in (1, 3, 48):
        want = jreduced(jget_config("musicgen-medium"), n_layers=n_layers).stages
        assert ModelConfig(n_layers=n_layers, input_kind="embeddings", **kw).stages == want == (
            (("attn",), n_layers),)


# -- local attention and the ring cache ----------------------------------------


def _qkv(seed, s, b=2, h=4, hkv=2, dh=16):
    rng = np.random.default_rng(seed)
    return tuple(rng.standard_normal((b, s, n, dh)).astype(np.float32) for n in (h, hkv, hkv))


@pytest.mark.parametrize("s", [9, 16, 32, 37])
def test_local_attention_chunked_matches_jax(s):
    """S below the window, S = 2 windows, and ragged S (padded at the end)."""
    q, k, v = _qkv(s, s)
    want = JL._local_attention_chunked(*map(jnp.asarray, (q, k, v)), 16)
    got = L._local_attention_chunked(*map(torch.from_numpy, (q, k, v)), 16)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL, atol=TOL)


@pytest.mark.parametrize("s,q_start", [(9, 0), (37, 0), (300, 0), (7, 9), (20, 44)])
def test_local_prefill_matches_jax_and_its_own_rows(s, q_start):
    """The prefill's position-aligned blocks against the reference's
    ``_local_attention_chunked`` over the whole sequence, and a suffix at
    ``q_start`` against the same rows of the whole prefill, bit for bit."""
    q, k, v = _qkv(3, q_start + s)
    want = JL._local_attention_chunked(*map(jnp.asarray, (q, k, v)), 16)
    tq, tk, tv = map(torch.from_numpy, (q, k, v))
    whole = L._local_prefill(tq, tk, tv, 16)
    np.testing.assert_allclose(whole.numpy(), np.asarray(want), rtol=TOL, atol=TOL)
    if q_start:
        part = L._local_prefill(tq[:, q_start:], tk, tv, 16, q_start)
        assert torch.equal(part, whole[:, q_start:])


@pytest.mark.parametrize("sq,sk,window", [(5, 5, 0), (5, 5, 3), (4, 9, 4), (1, 30, 16)])
def test_causal_mask_window_matches_jax(sq, sk, window):
    np.testing.assert_array_equal(L.causal_mask(sq, sk, window).numpy(), np.asarray(JL.causal_mask(sq, sk, window)))


def test_ring_positions_match_jax():
    slot = np.arange(16)
    for total in (0, 1, 15, 16, 17, 40):
        np.testing.assert_array_equal(L._ring_positions(torch.from_numpy(slot), total, 16).numpy(),
                                      np.asarray(JL._ring_positions(jnp.asarray(slot), total, 16)))


def _ring_writes():
    """(k, v, pos) writes into a 16-row ring: a prefill longer than the ring,
    one exactly its length, a short write that wraps, per-row decode steps
    that wrap and a per-row verify chunk."""
    rng = np.random.default_rng(4)
    kv = lambda s: tuple(rng.standard_normal((2, s, 2, 16)).astype(np.float32) for _ in range(2))  # noqa: E731
    return [(*kv(37), 0), (*kv(16), 0), (*kv(5), 14), (*kv(1), np.array([17, 31])),
            (*kv(1), np.array([32, 47])), (*kv(4), np.array([40, 13]))]


@pytest.mark.parametrize("kv_dtype", ["bfloat16", "int8"])
def test_ring_cache_write_matches_jax(kv_dtype):
    """The ring ``_cache_write`` against the reference's on the same K/V
    rows: bf16 caches and int8 codes and scales bit for bit."""
    writes = _ring_writes()
    if kv_dtype == "int8":
        jc = {"k": jnp.zeros((2, 16, 2, 16), jnp.int8), "v": jnp.zeros((2, 16, 2, 16), jnp.int8),
              "k_scale": jnp.zeros((2, 16, 2), jnp.float32), "v_scale": jnp.zeros((2, 16, 2), jnp.float32)}
    else:
        jc = {"k": jnp.zeros((2, 16, 2, 16), jnp.bfloat16), "v": jnp.zeros((2, 16, 2, 16), jnp.bfloat16)}
    tc = {name: torch.zeros(leaf.shape, dtype=getattr(torch, str(leaf.dtype))) for name, leaf in jc.items()}
    for k, v, pos in writes:
        jpos = jnp.asarray(pos, jnp.int32)
        jc = JL._cache_write(jc, jnp.asarray(k), jnp.asarray(v), jpos, 16)
        tpos = torch.from_numpy(pos) if isinstance(pos, np.ndarray) else pos
        tc = L._cache_write(tc, torch.from_numpy(k), torch.from_numpy(v), tpos, 16)
        for name in jc:
            np.testing.assert_array_equal(_np(tc[name]), np.asarray(jc[name], np.float32), err_msg=name)


# -- the model against JAX -------------------------------------------------------


def _jax_run(jcfg, jp, toks, s, n, kv="bfloat16"):
    jcfg = dataclasses.replace(jcfg, kv_cache_dtype=kv)
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


def _port_run(tcfg, tp, toks, s, n, kv="bfloat16", per_row=False):
    tcfg = dataclasses.replace(tcfg, kv_cache_dtype=kv)
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
def test_forward_logits_states_and_ring_match_jax(small, per_row):
    """A 40-token prompt (the 16-row ring wraps inside the prefill), then
    10 decode steps that overwrite its oldest rows: logits at every step,
    and at the end every recurrent state and ring row, against the
    reference."""
    jcfg, tcfg, jp, tp = small
    toks = np.random.default_rng(0).integers(0, 256, (2, 50)).astype(np.int32)
    want, jcache = _jax_run(jcfg, jp, toks, 40, 10)
    got, tcache = _port_run(tcfg, tp, toks, 40, 10, per_row=per_row)
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)
    _assert_caches_close(tcache, jcache)


def test_forward_quantized_matches_jax_on_ref(wide):
    """bcq (q = 4, g = 64) on every linear of the 128-wide hybrid; the port's
    CPU products take the ref oracle."""
    jcfg, tcfg, _, jq = wide
    tq = params_from_numpy(jax_tree_to_numpy(jq), device="cpu")
    toks = np.random.default_rng(2).integers(0, 256, (2, 30)).astype(np.int32)
    want, _ = _jax_run(jcfg, jq, toks, 22, 8)
    got, _ = _port_run(tcfg, tq, toks, 22, 8)
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)


def test_train_forward_matches_jax(small):
    jcfg, tcfg, jp, tp = small
    toks = np.random.default_rng(3).integers(0, 256, (2, 37)).astype(np.int32)
    want, _, _ = jforward(jcfg, jp, tokens=jnp.asarray(toks))
    got, _ = forward(tcfg, tp, tokens=torch.from_numpy(toks).long())
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL, atol=TOL)


def test_int8_ring_forward_matches_jax(small):
    """The int8 ring cache: logits within 2e-4 of the reference's int8
    forward and within 5% (relative L2, the reference's bound) of the
    compute-dtype cache's; codes and scales within one code of JAX's (the
    packages' K/V differ by ~1e-7 before rounding)."""
    jcfg, tcfg, jp, tp = small
    toks = np.random.default_rng(5).integers(0, 256, (2, 40)).astype(np.int32)
    want, jcache = _jax_run(jcfg, jp, toks, 30, 10, kv="int8")
    got, tcache = _port_run(tcfg, tp, toks, 30, 10, kv="int8")
    full, _ = _port_run(tcfg, tp, toks, 30, 10)
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)
    assert np.linalg.norm(got - full) / np.linalg.norm(full) < 0.05
    for si, stage in enumerate(jcache["stages"]):
        for key, blk in stage.items():
            if "k_scale" in blk:
                for name in ("k", "v"):
                    diff = np.abs(tcache["stages"][si][key][name].numpy().astype(int) - np.asarray(blk[name], int))
                    assert diff.max() <= 1 and (diff > 0).mean() < 1e-2
                    np.testing.assert_allclose(tcache["stages"][si][key][name + "_scale"].numpy(),
                                               np.asarray(blk[name + "_scale"]), rtol=TOL, atol=TOL)


def test_collect_states_match_jax(small):
    """``forward(collect_states=True)`` on a verify chunk: the per-token
    recurrent stacks ((repeat, S, B, ...)) against the reference's, and
    the live cache's recurrent leaves left as they were."""
    jcfg, tcfg, jp, tp = small
    toks = np.random.default_rng(6).integers(0, 256, (2, 25)).astype(np.int32)
    _, jcache = _jax_run(jcfg, jp, toks, 20, 0)
    _, tcache = _port_run(tcfg, tp, toks, 20, 0)
    before = [leaf.clone() for leaf in tree_leaves(L.snapshot_recurrent(tcache))]
    chunk = toks[:, 20:]
    _, jv, _ = jforward(jcfg, jp, tokens=jnp.asarray(chunk), cache=jcache, pos=jnp.full((2,), 20, jnp.int32),
                        logits_mode="all", chunked_decode=True, collect_states=True)
    with torch.no_grad():
        _, tv = forward(tcfg, tp, tokens=torch.from_numpy(chunk).long(), cache=tcache,
                        pos=torch.full((2,), 20), logits_mode="all", chunked_decode=True, collect_states=True)
    _assert_caches_close(tv, jv)
    after = tree_leaves(L.snapshot_recurrent(tcache))
    assert all(torch.equal(a, b) for a, b in zip(before, after))


def test_greedy_generate_equals_jax(small):
    """20 new tokens past the 16-token window: the port's greedy tokens equal
    the JAX engine's, through the captured-step path and the eager loop."""
    jcfg, tcfg, jp, tp = small
    prompts = np.random.default_rng(7).integers(0, 256, (2, 12)).astype(np.int32)
    want = JEngine(jcfg, jp, max_seq=64).generate(prompts, 20).tokens
    eng = Engine(tcfg, tp, max_seq=64, device="cpu")
    np.testing.assert_array_equal(eng.generate(prompts, 20).tokens, want)
    np.testing.assert_array_equal(eng.generate(prompts, 20, scan=False).tokens, want)


# -- the rollback primitives against the reference ---------------------------------


def _filled(small, b=2, s=20):
    jcfg, tcfg, jp, tp = small
    toks = np.random.default_rng(8).integers(0, 256, (b, s)).astype(np.int32)
    _, jcache = _jax_run(jcfg, jp, toks, s, 0)
    _, tcache = _port_run(tcfg, tp, toks, s, 0)
    # the same values on both sides: carry the reference's cache across
    tcache = params_from_numpy(jax_tree_to_numpy(jcache), device="cpu")
    return jcache, tcache


def test_snapshot_and_restore_rows_match_jax(small):
    jcache, tcache = _filled(small)
    pos = np.array([20, 13], np.int32)
    jsnap = JS.snapshot_rows(jcache, jnp.asarray(pos), 4)
    tsnap = S.snapshot_rows(tcache, pos, 4)
    walked = []

    def cmp(name, t, j):
        walked.append(name)
        np.testing.assert_array_equal(_np(t), np.asarray(j, np.float32))

    L.walk_pairs(jsnap, tsnap, lambda name, j, t: cmp(name, t, j))
    assert sorted(set(walked)) == ["k", "v"]
    # scribble over the chunk's rows, then restore all but the first keep[b]
    rng = np.random.default_rng(9)
    junk = jax.tree_util.tree_map(lambda x: jnp.asarray(rng.standard_normal(x.shape), x.dtype), jcache)
    tjunk = params_from_numpy(jax_tree_to_numpy(junk), device="cpu")
    keep = np.array([1, 3], np.int32)
    jr = JS.restore_rows(junk, jsnap, jnp.asarray(pos), 4, jnp.asarray(keep))
    tr = S.restore_rows(tjunk, tsnap, torch.from_numpy(pos), 4, torch.from_numpy(keep))
    for a, b in zip(jax.tree_util.tree_leaves(jr), tree_leaves(tr)):
        np.testing.assert_array_equal(_np(b), np.asarray(a, np.float32))


def test_select_recurrent_match_jax(small):
    jcfg, tcfg, jp, tp = small
    jcache, tcache = _filled(small)
    chunk = np.random.default_rng(10).integers(0, 256, (2, 5)).astype(np.int32)
    _, jv, _ = jforward(jcfg, jp, tokens=jnp.asarray(chunk), cache=jcache, pos=jnp.full((2,), 20, jnp.int32),
                        logits_mode="all", chunked_decode=True, collect_states=True)
    tv = params_from_numpy(jax_tree_to_numpy(jv), device="cpu")
    idx = np.array([3, 0], np.int32)
    want = JS.select_recurrent_target(jv, jnp.asarray(idx))
    got = S.select_recurrent_target(tv, torch.from_numpy(idx))
    for a, b in zip(jax.tree_util.tree_leaves(want), tree_leaves(got)):
        np.testing.assert_array_equal(_np(b), np.asarray(a, np.float32))
    # the draft side: per-step copies stacked on a leading step axis
    steps = [JS._recurrent_only(jax.tree_util.tree_map(lambda x, i=i: x + i, jcache)) for i in range(4)]
    jst = jax.tree_util.tree_map(lambda *xs: jnp.stack(xs), *steps)
    want = JS.select_recurrent_draft(jcache, jst, jnp.asarray(idx))
    tsteps = [S._recurrent_only(params_from_numpy(jax_tree_to_numpy(jax.tree_util.tree_map(lambda x, i=i: x + i, jcache)),
                                                  device="cpu")) for i in range(4)]
    got = S.select_recurrent_draft(tcache, S._stack_trees(tsteps), torch.from_numpy(idx))
    for a, b in zip(jax.tree_util.tree_leaves(want), tree_leaves(got)):
        np.testing.assert_array_equal(_np(b), np.asarray(a, np.float32))


def test_rejected_chunk_leaves_no_trace(small):
    """(cf. the reference's test of the same name) A verify chunk of junk on
    a wrapped ring, rolled back entirely (ring rows restored, recurrent state
    at the chunk's start): the next step's logits equal those of a cache
    that never saw the junk, bit for bit."""
    _, tcfg, _, tp = small
    toks = np.random.default_rng(11).integers(0, 256, (2, 21)).astype(np.int32)
    caches = []
    for _ in range(2):
        c = init_cache(tcfg, 2, 40, device="cpu")
        forward(tcfg, tp, tokens=torch.from_numpy(toks[:, :20]).long(), cache=c, pos=0, logits_mode="last",
                prefill=True)
        caches.append(c)
    pos = torch.full((2,), 20)
    snap = S.snapshot_rows(caches[1], pos, 4)
    state = S._recurrent_only(caches[1])
    with torch.no_grad():
        forward(tcfg, tp, tokens=torch.tensor([[3, 5, 7, 11], [13, 2, 4, 8]]), cache=caches[1], pos=pos,
                logits_mode="all", chunked_decode=True, collect_states=True)
        S.restore_rows(caches[1], snap, pos, 4, torch.zeros(2, dtype=torch.long))
        L.install_recurrent(caches[1], state)
        tok = torch.from_numpy(toks[:, 20:21]).long()
        want, _ = forward(tcfg, tp, tokens=tok, cache=caches[0], pos=pos, logits_mode="last")
        got, _ = forward(tcfg, tp, tokens=tok, cache=caches[1], pos=pos, logits_mode="last")
    assert torch.equal(got, want)


# -- the port's exactness invariants ----------------------------------------------


@pytest.fixture(scope="module")
def qengine():
    """The 128-wide hybrid in bcq (q = 4, g = 32, so every linear is packed)."""
    cfg = reduced(get_config(ARCH), **WIDE)
    params = quantize_params(init_params(cfg, seed=0, device="cpu"), QuantPolicy(q=4, g=32, iters=2), device="cpu")
    return Engine(cfg, params, max_seq=96, device="cpu")


def test_verify_rows_equal_decode_steps(qengine):
    """A verify of 5 tokens against a ring that wrapped gives each position
    the bits of a decode step there (each token sees the rows the chunk's
    later tokens overwrote back in their slots)."""
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


@pytest.mark.parametrize("spec", [SpecConfig(1, 3), SpecConfig(3, 2), SpecConfig(4, 4)], ids=["q1g3", "q3g2", "q4g4"])
def test_spec_greedy_equals_plain_on_a_wrapping_ring(qengine, spec):
    """(cf. the reference's ``test_spec_greedy_identical_recurrent_and_window``)
    prompts of 20 tokens and 21 new ones on the 16-row ring: speculative
    greedy == plain greedy; q' = q accepts every proposal (21 = the first
    token and four chunks of 5 at γ = 4: no acceptance falls past the cut
    uncounted)."""
    prompts = np.random.default_rng(13).integers(0, 256, (3, 20)).astype(np.int32)
    plain = qengine.generate(prompts, 21)
    got = qengine.generate(prompts, 21, speculate=spec)
    np.testing.assert_array_equal(got.tokens, plain.tokens)
    if spec.q_draft == 4:
        assert got.spec_stats["accept_rate"] == 1.0


def _requests(n, lens, seed=14, gen=10):
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


@pytest.mark.parametrize("kv", ["bfloat16", "int8"])
def test_slots_equal_solo(qengine, kv):
    """(cf. the reference's ``test_continuous_batching_recurrent_and_window``)
    7 requests, prompts of 5..40 tokens, greedy and sampled, through 3
    slots: each equals its solo ``generate``; an admission resets the whole
    slot row (recurrent state and ring rows)."""
    eng = qengine
    if kv == "int8":
        eng = Engine(dataclasses.replace(eng.cfg, kv_cache_dtype="int8"), eng.params, max_seq=96, fuse=False,
                     device="cpu")
    reqs = _requests(7, [5, 40, 17, 23, 9, 31, 12])
    assert _serve(eng, reqs, n_slots=3, chunk=4) == _solo(eng, reqs)


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


def test_warm_equals_cold_and_wrapped_prompts_bypass(qengine):
    """(cf. the reference's ``test_ring_arch_wrapped_prompts_bypass_cache``)
    A shared 8-token prefix in blocks of 4: warm admissions install the
    prefix's rows and its boundary recurrent state and prefill only the
    tail, and give the cold admission's tokens; a prompt past the 16-row
    ring neither matches nor commits, and the trie holds nothing past the
    ring."""
    cold = qengine
    warm = Engine(cold.cfg, cold.params, max_seq=96, fuse=False, device="cpu",
                  prefix_cache=PrefixCache(block_tokens=4, max_bytes=1 << 24))
    rng = np.random.default_rng(15)
    shared = rng.integers(0, 256, 8)
    prompts = [np.concatenate([shared, rng.integers(0, 256, n)]).astype(np.int32) for n in (3, 6, 1, 8)]
    for i, prompt in enumerate(prompts):
        want_l, want_t = _admission(cold, prompt)
        got_l, got_t = _admission(warm, prompt)
        assert warm.take_prefix_handle().length == (0 if i == 0 else 8)
        np.testing.assert_array_equal(got_t, want_t)
        torch.testing.assert_close(got_l, want_l, rtol=TOL, atol=TOL)
    nodes = len(warm.prefix_cache._nodes)
    long = np.concatenate([shared, rng.integers(0, 256, 20)]).astype(np.int32)
    for _ in range(2):
        got_l, got_t = _admission(warm, long)
        h = warm.take_prefix_handle()
        assert h.length == 0 and not h.new_spans
        want_l, want_t = _admission(cold, long)
        assert torch.equal(got_l, want_l)
        np.testing.assert_array_equal(got_t, want_t)
    assert len(warm.prefix_cache._nodes) == nodes
    assert all(n.end <= 16 for n in warm.prefix_cache._nodes)
    assert all(n.snap is not None for n in warm.prefix_cache._nodes)
    pc = warm.prefix_cache
    assert pc.pinned == 0 and pc.counters["hits"] + pc.counters["misses"] == pc.counters["commits"]


def test_warm_wave_equals_cold_wave_through_the_scheduler(qengine):
    warm = Engine(qengine.cfg, qengine.params, max_seq=96, fuse=False, device="cpu",
                  prefix_cache=PrefixCache(block_tokens=4, max_bytes=1 << 24))
    rng = np.random.default_rng(16)
    shared = rng.integers(0, 256, 8)
    reqs = [Request(prompt=np.concatenate([shared, rng.integers(0, 256, n)]).astype(np.int32), max_new_tokens=6,
                    temperature=[0.0, 1.0][i % 2], seed=i, rid=i) for i, n in enumerate((2, 5, 7, 20))]
    cold_wave = _serve(warm, reqs, n_slots=2, chunk=3)
    warm_wave = _serve(warm, reqs, n_slots=2, chunk=3)
    assert warm_wave == cold_wave == _solo(qengine, reqs)
    assert warm.prefix_cache.counters["hits"] >= 3


# -- refusals ------------------------------------------------------------------------


def test_chunked_prefill_is_refused_with_the_reference_reason(qengine):
    assert not qengine.supports_chunked_prefill
    with pytest.raises(ValueError, match="ring-buffer and recurrent"):
        qengine.begin_admission(np.arange(6), max_new_tokens=2, chunked=True)
    with pytest.raises(ValueError, match="ring buffers wrap pad writes"):
        Scheduler(qengine, n_slots=2, prefill_chunk=4)
    with pytest.raises(SystemExit):
        serve.main(["--arch", ARCH, "--device", "cpu", "--prefill-chunk", "4"])


def test_gamma_must_fit_the_ring(qengine):
    with pytest.raises(ValueError, match="need gamma\\+1 < window"):
        qengine.generate(np.zeros((1, 4), np.int32), 4, speculate=SpecConfig(2, 15))
    with pytest.raises(ValueError, match="need gamma\\+1 < window"):
        qengine.init_slots(2, speculate=SpecConfig(2, 16))
    small_ring = Engine(qengine.cfg, qengine.params, max_seq=8, fuse=False, device="cpu")
    with pytest.raises(ValueError, match="window 8"):
        small_ring.init_slots(1, speculate=SpecConfig(2, 7))


def test_a_prefill_past_the_ring_at_pos_gt_0_is_refused(small):
    _, tcfg, _, tp = small
    cache = init_cache(tcfg, 1, 40, device="cpu")
    with pytest.raises(ValueError, match="ring"):
        forward(tcfg, tp, tokens=torch.zeros((1, 10), dtype=torch.long), cache=cache, pos=8, prefill=True)
