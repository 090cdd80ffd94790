"""The port's int8 KV cache (``ModelConfig(kv_cache_dtype="int8")``) against
the JAX package's, on a reduced llama3.2-3b (2 layers, d_model 128, 4 kv
heads, f32).

- Codes and scales equal JAX's ``_kv_quantize`` bit for bit on the same f32
  inputs, all-zero vectors and exact rounding ties among them.
- ``init_cache`` holds the reference's leaves, shapes and dtypes.
- The int8 forward (prefill, then decode steps) is within 2e-4 of the
  reference's int8 forward, and, the mirror of
  ``tests/test_models.py::test_int8_kv_cache_decode_close_to_exact``, its
  decode logits within 5% (relative L2) of the exact full forward.
- Under int8, bit for bit: slot == solo and greedy speculative == plain
  (a row's codes depend on that row alone); the scale leaves travel with
  their rows through the prefix helpers and count in the prefix cache's
  bytes.
- A warm or chunked admission attends dequantized rows where a cold
  whole-shot one attends fresh ones, so they are held to the reference's
  5% bound instead of bit for bit.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.models import forward as jforward
from repro.models import init_cache as jinit_cache
from repro.models import init_params as jinit_params
from repro.models import reduced as jreduced
from repro.models.layers import _kv_dequantize as j_kv_dequantize
from repro.models.layers import _kv_quantize as j_kv_quantize
from repro_torch.configs import get_config
from repro_torch.infer import Engine, PrefixCache, Request, Scheduler, SpecConfig
from repro_torch.models import forward, init_cache, init_params, params_from_numpy, reduced
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import _kv_dequantize, _kv_quantize, gather_prefix_rows, install_prefix_rows
from repro_torch.quant import QuantPolicy, quantize_params
from repro_torch.utils import tree_leaves
from torch_helpers import jax_tree_to_numpy

SIZES = dict(d_model=128, n_kv_heads=4)
REF_TOL = 2e-4  # the port's int8 forward against the reference's
REL_L2 = 0.05  # the reference's bound for int8 against the exact forward
B, S = 2, 32


def _cfgs(kv="int8"):
    jcfg = dataclasses.replace(jreduced(jget_config("llama3.2-3b"), **SIZES), kv_cache_dtype=kv, stages=None)
    return jcfg, reduced(get_config("llama3.2-3b"), **SIZES, kv_cache_dtype=kv)


def _rel_l2(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def _quant_inputs():
    """(3, 5, 4, 32) f32: normal vectors, all-zero vectors, vectors whose
    codes fall on exact ties (x / m * 127 == n + 0.5 in f32), tiny and huge
    magnitudes."""
    rng = np.random.default_rng(0)
    x = rng.standard_normal((3, 5, 4, 32)).astype(np.float32)
    x[0, 1] = 0.0  # every head of one token
    x[1, 2, 3] = 0.0  # one head
    halves = (np.arange(32, dtype=np.float32) - 16.0) + 0.5  # -15.5 .. 15.5
    x[2, 0, :] = halves
    x[2, 0, :, 0] = 127.0  # absmax 127: x / 127 * 127
    x[2, 1, :] = halves * 2.0
    x[2, 1, :, -1] = -254.0
    x[1, 0] *= 1e-20
    x[1, 1] *= 1e20
    return x


def test_codes_and_scales_match_jax_bit_for_bit():
    x = _quant_inputs()
    m = np.maximum(np.abs(x).max(-1, keepdims=True), np.float32(1e-8))
    ties = np.abs((x / m * np.float32(127.0)) % 1 - 0.5) == 0
    assert ties.sum() >= 32, "the inputs must hold exact rounding ties"
    jq, js = j_kv_quantize(jnp.asarray(x))
    q, s = _kv_quantize(torch.from_numpy(x))
    assert q.dtype == torch.int8 and s.dtype == torch.float32 and s.shape == x.shape[:-1]
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(s.numpy(), np.asarray(js))
    assert (q[0, 1] == 0).all() and (s[0, 1] == 0).all()
    for dt, jdt in ((torch.float32, jnp.float32), (torch.bfloat16, jnp.bfloat16)):
        got = _kv_dequantize(q, s, dt).to(torch.float32).numpy()
        want = np.asarray(j_kv_dequantize(jq, js, jdt).astype(jnp.float32))
        np.testing.assert_array_equal(got, want)


def test_init_cache_leaves_match_the_reference():
    jcfg, cfg = _cfgs()
    want = jinit_cache(jcfg, B, S)["stages"][0]["b0"]
    got = init_cache(cfg, B, S, device="cpu")["stages"][0]["b0"]
    assert sorted(got) == sorted(want) == ["k", "k_scale", "v", "v_scale"]
    for name, leaf in got.items():
        assert tuple(leaf.shape) == tuple(want[name].shape), name
        assert str(leaf.dtype).removeprefix("torch.") == str(want[name].dtype), name
        assert not leaf.any()
    assert got["k"].shape == (cfg.n_layers, B, S, cfg.n_kv_heads, cfg.d_head)
    assert got["k_scale"].shape == (cfg.n_layers, B, S, cfg.n_kv_heads)
    bf16 = init_cache(_cfgs("bfloat16")[1], B, S, torch.float32, device="cpu")["stages"][0]["b0"]
    assert sorted(bf16) == ["k", "v"] and bf16["k"].dtype == torch.float32


@pytest.mark.parametrize("value", ["int4", "float16", "bf16", ""])
def test_unknown_kv_cache_dtype_raises(value):
    with pytest.raises(ValueError, match="bfloat16.*int8"):
        reduced(get_config("llama3.2-3b"), kv_cache_dtype=value)
    with pytest.raises(ValueError, match="kv_cache_dtype"):
        ModelConfig(name="x", family="dense", n_layers=1, d_model=8, n_heads=2, n_kv_heads=1, d_ff=8,
                    vocab=16, kv_cache_dtype=value)


@pytest.fixture(scope="module")
def dense():
    """The reference's random dense weights in both packages."""
    jcfg, cfg = _cfgs()
    jparams = jinit_params(jax.random.PRNGKey(0), jcfg)
    return jcfg, cfg, jparams, params_from_numpy(jax_tree_to_numpy(jparams), device="cpu")


def test_int8_forward_matches_the_reference(dense):
    """Prefill S - 4 tokens, then 4 decode steps, in both packages' int8
    caches: logits within rtol = atol = 2e-4 (the repo's "within"), and the
    caches' scales alike. The packages sum K/V in different orders (about
    3e-6 apart in f32 logits with the f32 cache), so a code whose quotient
    lies next to a rounding tie may sit one step off: one of 16384 here,
    2.2e-4 in the logits at most."""
    jcfg, cfg, jparams, params = dense
    toks = np.random.default_rng(1).integers(0, cfg.vocab, size=(B, S)).astype(np.int32)
    n0 = S - 4
    jcache = jinit_cache(jcfg, B, S)
    cache = init_cache(cfg, B, S, device="cpu")
    tt = torch.from_numpy(toks).long()
    with torch.no_grad():
        for t in range(n0, S + 1):
            sl = slice(0, n0) if t == n0 else slice(t - 1, t)
            start = 0 if t == n0 else t - 1
            jl, jcache, _ = jforward(jcfg, jparams, tokens=jnp.asarray(toks[:, sl]), cache=jcache,
                                     pos=jnp.int32(start), logits_mode="last")
            lg, cache = forward(cfg, params, tokens=tt[:, sl], cache=cache, pos=start, logits_mode="last")
            np.testing.assert_allclose(lg.numpy(), np.asarray(jl), rtol=REF_TOL, atol=REF_TOL)
    jleaf, leaf = jcache["stages"][0]["b0"], cache["stages"][0]["b0"]
    for name in ("k_scale", "v_scale"):
        np.testing.assert_allclose(leaf[name].numpy(), np.asarray(jleaf[name]), rtol=1e-5, atol=1e-6)
    for name in ("k", "v"):  # a code may sit one step off where the packages' K/V round apart
        off = np.abs(leaf[name].numpy().astype(int) - np.asarray(jleaf[name]).astype(int))
        assert off.max() <= 1 and (off > 0).sum() <= 2, (name, int((off > 0).sum()))


def test_int8_decode_close_to_exact():
    """The mirror of the reference's test: decode logits with the int8 cache
    within 5% (relative L2) of the exact full forward."""
    _, cfg8 = _cfgs()
    cfg = _cfgs("bfloat16")[1]
    params = init_params(cfg, seed=0, device="cpu")
    toks = torch.from_numpy(np.random.default_rng(0).integers(0, cfg.vocab, size=(B, S))).long()
    with torch.no_grad():
        full, _ = forward(cfg, params, tokens=toks)
        cache = init_cache(cfg8, B, S, device="cpu")
        assert cache["stages"][0]["b0"]["k"].dtype == torch.int8
        assert "k_scale" in cache["stages"][0]["b0"]
        _, cache = forward(cfg8, params, tokens=toks[:, : S - 1], cache=cache, pos=0, logits_mode="last")
        lp2, _ = forward(cfg8, params, tokens=toks[:, S - 1 :], cache=cache, pos=S - 1, logits_mode="last")
    rel = _rel_l2(lp2[:, 0].numpy(), full[:, S - 1].numpy())
    assert 0 < rel < REL_L2, rel


def _engine(q=0, max_seq=48, **kw):
    cfg = reduced(get_config("llama3.2-3b"), **SIZES, kv_cache_dtype="int8")
    params = init_params(dataclasses.replace(cfg, kv_cache_dtype="bfloat16"), seed=0, device="cpu")
    if q:
        params = quantize_params(params, QuantPolicy(q=q, g=64, iters=2), device="cpu")
    return Engine(cfg, params, max_seq=max_seq, device="cpu", **kw)


def _requests(cfg, n, seed=0):
    rng = np.random.default_rng(seed)
    return [Request(prompt=rng.integers(0, cfg.vocab, size=int(rng.integers(4, 14))).astype(np.int32),
                    max_new_tokens=int(rng.integers(3, 10)), temperature=[0.0, 1.0, 0.7][i % 3], seed=10 + i)
            for i in range(n)]


@pytest.mark.parametrize("q", [0, 4], ids=["dense", "bcq_q4"])
def test_int8_slot_equals_solo(q):
    """Six requests (greedy and sampled) through 3 slots: each emits a solo
    ``generate``'s tokens; a slot's carried logits equal the request's own
    prefill and decode steps bit for bit."""
    eng = _engine(q)
    reqs = _requests(eng.cfg, 6)
    sched = Scheduler(eng, n_slots=3, chunk=4)
    for r in reqs:
        sched.submit(r)
    done = {c.rid: c for c in sched.run()}
    for r in reqs:
        solo = eng.generate(r.prompt[None], r.max_new_tokens, temperature=r.temperature, seed=r.seed)
        np.testing.assert_array_equal(solo.tokens[0, r.prompt.size :], done[r.rid].new_tokens)
    prompts = [r.prompt for r in reqs[:3]]
    slots = eng.init_slots(3)
    for i, p in enumerate(prompts):
        eng.admit_slot(slots, i, p, max_new_tokens=4)
    toks, _, slots = eng.decode_slots(slots, 3)
    for i, p in enumerate(prompts):
        logits, cache = eng.prefill(torch.as_tensor(p[None]).long(), eng._make_cache(1))
        for t in range(3):
            logits, cache = eng.decode(torch.tensor([[int(toks[i, t])]]), cache, p.size + t)
        assert torch.equal(logits[0], slots["logits"][i]), f"slot {i}"


def test_int8_greedy_speculative_equals_plain():
    eng = _engine(4)
    prompts = np.random.default_rng(2).integers(0, eng.cfg.vocab, size=(3, 9)).astype(np.int32)
    plain = eng.generate(prompts, 12)
    for spec in (SpecConfig(2, 3), SpecConfig(4, 2)):
        res = eng.generate(prompts, 12, speculate=spec)
        np.testing.assert_array_equal(res.tokens, plain.tokens)
    assert res.spec_stats["accepted"] == res.spec_stats["proposed"]  # q' = q: the draft is the target
    reqs = [dataclasses.replace(r, temperature=0.0) for r in _requests(eng.cfg, 4, seed=3)]
    sched = Scheduler(eng, n_slots=2, chunk=2, speculate=SpecConfig(2, 3))
    for r in reqs:
        sched.submit(r)
    done = {c.rid: c for c in sched.run()}
    for r in reqs:
        solo = eng.generate(r.prompt[None], r.max_new_tokens)
        np.testing.assert_array_equal(solo.tokens[0, r.prompt.size :], done[r.rid].new_tokens)


def test_int8_prefix_rows_carry_their_scales():
    """``gather_prefix_rows`` copies the scale leaves beside the codes,
    ``install_prefix_rows`` writes both back, and the prefix cache counts
    the scales' bytes."""
    eng = _engine()
    cfg = eng.cfg
    prompt = np.random.default_rng(4).integers(0, cfg.vocab, size=(1, 12))
    _, cache = eng.prefill(torch.as_tensor(prompt).long(), eng._make_cache(1))
    rows = gather_prefix_rows(cache, 4, 8)
    leaf = rows["stages"][0]["b0"]
    assert sorted(leaf) == ["k", "k_scale", "v", "v_scale"]
    assert leaf["k_scale"].shape == (cfg.n_layers, 1, 8, cfg.n_kv_heads)
    assert leaf["k"].dtype == torch.int8 and leaf["k_scale"].dtype == torch.float32
    assert leaf["k_scale"].abs().min() > 0
    fresh = install_prefix_rows(eng._make_cache(1), gather_prefix_rows(cache, 0, 12))
    for a, b in zip(tree_leaves(fresh), tree_leaves(cache)):
        assert torch.equal(a[:, :, :12], b[:, :, :12])
    pc = PrefixCache(block_tokens=4, max_bytes=1 << 20)
    eng = _engine(prefix_cache=pc)
    eng.admit_slot(eng.init_slots(1), 0, prompt[0], max_new_tokens=2)
    blocks = 3  # 12 tokens in blocks of 4
    codes = 2 * cfg.n_layers * blocks * 4 * cfg.n_kv_heads * cfg.d_head
    scales = 2 * cfg.n_layers * blocks * 4 * cfg.n_kv_heads * 4
    assert pc.cached_bytes == codes + scales


def test_int8_warm_and_chunked_admissions_within_the_bound():
    """An int8 engine takes the prefix cache and chunked prefill (the
    reference's admissions read the int8 cache too): a warm admission and
    a chunked one give last-prompt logits within 5% of the cold whole-shot
    admission, and the scheduler serves all three."""
    pc = PrefixCache(block_tokens=4, max_bytes=1 << 20)
    eng = _engine(prefix_cache=pc)
    prompt = np.random.default_rng(5).integers(0, eng.cfg.vocab, size=23).astype(np.int32)

    def admit(engine, chunk=None):
        p = engine.begin_admission(prompt, max_new_tokens=4, chunked=chunk is not None)
        while not p.done:
            engine.advance_admission(p, chunk)
        slots = engine.finish_admission(engine.init_slots(1), 0, p)
        return p, slots["logits"][0].numpy()

    cold_p, cold = admit(eng)
    warm_p, warm = admit(eng)
    assert cold_p.whole and not warm_p.whole and warm_p.handle.length == 20
    chunked_p, chunked = admit(_engine(), 6)
    assert chunked_p.prefill_chunks == 4
    for got in (warm, chunked):
        assert _rel_l2(got, cold) < REL_L2
    reqs = _requests(eng.cfg, 4, seed=6)
    for r in reqs:
        r.prompt = np.concatenate([prompt[:16], r.prompt])
    sched = Scheduler(_engine(prefix_cache=PrefixCache(block_tokens=4, max_bytes=1 << 20)), n_slots=2, chunk=3,
                      prefill_chunk=5)
    for r in reqs:
        sched.submit(r)
    done = sched.run()
    assert sorted(len(c.new_tokens) for c in done) == sorted(r.max_new_tokens for r in reqs)
