"""The port's prefix cache and chunked prefill, the mirror of
``tests/test_prefix_cache.py``.

The load-bearing invariant: serving against a warm prefix cache emits
exactly the tokens of serving cold, and of a solo ``Engine.generate``,
across formats and speculative decoding, chunked or whole-shot prefill and
mid-flight eviction; the accounting is leak-free::

    hits + misses == commits + aborts      # every begin ends exactly once
    pinned == 0                            # refcounts drain at quiescence

On the CPU the tokens are equal; on the GPU the logits too, bit for bit
(``tests/test_torch_cuda.py``), because every row of a prompt chunk is
computed as in the whole prompt. Added here: the port against the JAX
package's engine and prefix cache on the same weights, the ``layers``
helpers and the ``pos > 0`` prefill, the offset attention's plain version,
cancel / deadline / failure of a pending chunked admission, refusals and
the CLI.

Not mirrored here: the TP rows of the reference grid, which
``test_torch_tp_serve.py`` holds in spawned ranks, and the recurrent and
ring cases, which ``test_torch_hybrid.py`` / ``test_torch_xlstm.py`` hold.
"""

import dataclasses
import functools
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.infer import Engine as JEngine
from repro.infer import PrefixCache as JPrefixCache
from repro.infer import Request as JRequest
from repro.infer import Scheduler as JScheduler
from repro.models import forward as jforward
from repro.models import init_cache as jinit_cache
from repro.models import init_params as jinit_params
from repro.models import reduced as jreduced
from repro_torch.configs import get_config
from repro_torch.data import MarkovCorpus
from repro_torch.infer import (
    Engine,
    FaultPlan,
    PrefixCache,
    Request,
    RequestState,
    Scheduler,
    SpecConfig,
    StepClock,
    model_identity,
)
from repro_torch.infer.prefix_cache import concat_rows
from repro_torch.kernels import flash_attention, flash_attention_plain
from repro_torch.kernels.ref import causal_mask, sdpa
from repro_torch.launch import serve
from repro_torch.models import forward, init_cache, init_params, params_from_numpy, reduced
from repro_torch.models import layers as L
from repro_torch.quant import QuantPolicy, quantize_params
from torch_helpers import jax_tree_to_numpy

MAX_SEQ = 64
Q_GROUP = 32
SIZES = dict(d_model=128, n_kv_heads=4, d_ff=256)  # the reference test's _cfg
POS_TOL = 2e-5  # f32: prefill at pos > 0 vs the same rows of the whole prompt
# f32 reduced model: the port's warm-suffix logits vs JAX's _prefill_chunk,
# relative to max|logit| (the plain attention sums over the same keys in
# another order, the products likewise)
JAX_LOGITS_REL_TOL = 2e-4


def _cfg():
    return reduced(get_config("llama3.2-3b"), **SIZES)


@functools.lru_cache(maxsize=None)
def _params(fmt: str):
    params = init_params(_cfg(), seed=0, device="cpu")
    if fmt != "dense":
        params = quantize_params(params, QuantPolicy(q=3, g=Q_GROUP, iters=2, fmt=fmt), device="cpu")
    return params


@functools.lru_cache(maxsize=None)
def _cold_engine(fmt: str) -> Engine:
    return Engine(_cfg(), _params(fmt), max_seq=MAX_SEQ, device="cpu")


def _warm_engine(fmt: str, *, block_tokens=4, max_bytes=64 << 20) -> Engine:
    """A fresh engine with a cache (never cached itself: the cache is state)."""
    return Engine(_cfg(), _params(fmt), max_seq=MAX_SEQ, device="cpu",
                  prefix_cache=PrefixCache(block_tokens=block_tokens, max_bytes=max_bytes))


def _shared_prefix_requests(n, *, prefix_len=12, gen=6, seed0=0, cls=Request, vocab=None):
    """``n`` requests sharing a ``prefix_len``-token system prompt, with
    tails of 2..5 tokens: the workload the cache exists for."""
    corpus = MarkovCorpus(vocab or _cfg().vocab, seed=3)
    shared = corpus.sample(1, prefix_len, seed=99)[0, :prefix_len]
    out = []
    for i in range(n):
        tlen = 2 + (i % 4)
        tail = corpus.sample(1, tlen, seed=100 + i)[0, :tlen]
        out.append(cls(prompt=np.concatenate([shared, tail]).astype(np.int32), max_new_tokens=gen,
                       temperature=[0.0, 1.0, 0.7][i % 3], seed=seed0 + 10 + i))
    return out


def _run(engine, reqs, *, speculate=None, prefill_chunk=None, n_slots=2, chunk=3, **kw):
    sched = Scheduler(engine, n_slots=n_slots, chunk=chunk, speculate=speculate, prefill_chunk=prefill_chunk, **kw)
    for r in reqs:
        sched.submit(r)
    return sched, {c.rid: c for c in sched.run()}


def _assert_same_tokens(reqs_a, done_a, reqs_b, done_b, what):
    for ra, rb in zip(reqs_a, reqs_b):
        np.testing.assert_array_equal(done_a[ra.rid].new_tokens, done_b[rb.rid].new_tokens,
                                      err_msg=f"{what}: request {ra.rid} diverged")


def _assert_accounting_clean(pc: PrefixCache):
    c = pc.counters
    assert c["hits"] + c["misses"] == c["commits"] + c["aborts"], c
    assert pc.pinned == 0, "refcounts must drain to zero at quiescence"
    assert pc.cached_bytes == sum(n.nbytes for n in pc._nodes)
    assert pc.cached_bytes <= pc.max_bytes


# ---------------------------------------------------------------------------
# trie / refcount / eviction units (no engine: fake row payloads)
# ---------------------------------------------------------------------------


def _fake_rows(nbytes=64):
    return {"k": np.zeros((1, 1, 1, nbytes), np.int8)}


def test_trie_match_and_commit_roundtrip():
    pc = PrefixCache(block_tokens=4, max_bytes=1 << 20)
    toks = np.arange(10, dtype=np.int32)
    h = pc.begin(toks, max_match=9, max_commit=10)
    assert h.length == 0 and h.new_spans == [(0, 4), (4, 8)]
    h.rows = [_fake_rows(), _fake_rows()]
    pc.complete(h)
    assert pc.n_nodes == 2 and pc.counters == {"hits": 0, "misses": 1, "commits": 1, "aborts": 0, "evictions": 0}
    # the same prompt again: both blocks match (max_match=9 admits [0, 8))
    h2 = pc.begin(toks, max_match=9, max_commit=10)
    assert h2.length == 8 and h2.new_spans == []
    assert pc.counters["hits"] == 1
    pc.complete(h2)
    # a prompt diverging inside block 2 reuses only block 1
    other = toks.copy()
    other[6] = 77
    h3 = pc.begin(other, max_match=9, max_commit=8)
    assert h3.length == 4 and h3.new_spans == [(4, 8)]
    h3.rows = [_fake_rows()]
    pc.complete(h3)
    assert pc.n_nodes == 3  # a sibling block under the shared first block
    _assert_accounting_clean(pc)


def test_begin_caps_match_and_commit():
    pc = PrefixCache(block_tokens=4, max_bytes=1 << 20)
    toks = np.arange(8, dtype=np.int32)
    h = pc.begin(toks, max_match=7, max_commit=8)
    h.rows = [_fake_rows(), _fake_rows()]
    pc.complete(h)
    # max_match=7 < 8: the second block may not be reused though committed
    h2 = pc.begin(toks, max_match=7, max_commit=8)
    assert h2.length == 4
    pc.abort(h2)
    # max_commit=0: nothing planned, nothing committed
    h3 = pc.begin(toks, max_match=0, max_commit=0)
    assert h3.length == 0 and h3.new_spans == []
    pc.complete(h3)
    assert pc.n_nodes == 2
    _assert_accounting_clean(pc)


def test_pinned_blocks_survive_eviction():
    pc = PrefixCache(block_tokens=2, max_bytes=1 << 20)
    toks = np.arange(6, dtype=np.int32)
    h = pc.begin(toks, max_match=6, max_commit=6)
    h.rows = [_fake_rows(), _fake_rows(), _fake_rows()]
    pc.complete(h)
    pinned = pc.begin(toks, max_match=6, max_commit=6)
    assert pinned.length == 6 and pc.pinned == 3
    pc.evict_to(0)  # the pinned path survives a zero budget
    assert pc.n_nodes == 3 and pc.counters["evictions"] == 0
    pc.complete(pinned)
    pc.evict_to(0)  # now the whole chain drains leaf-first
    assert pc.n_nodes == 0 and pc.cached_bytes == 0
    assert pc.counters["evictions"] == 3
    _assert_accounting_clean(pc)


def test_lru_eviction_prefers_oldest_childless():
    pc = PrefixCache(block_tokens=2, max_bytes=1 << 30)
    old, new = np.array([1, 2], np.int32), np.array([3, 4], np.int32)
    for toks in (old, new):
        h = pc.begin(toks, max_match=2, max_commit=2)
        h.rows = [_fake_rows()]
        pc.complete(h)
    # touch `old`, so `new` is the LRU victim
    pc.complete(pc.begin(old, max_match=2, max_commit=2))
    pc.evict_to(pc.cached_bytes - 1)  # exactly one eviction
    assert pc.n_nodes == 1
    assert pc._nodes[0].key == old.tobytes()
    _assert_accounting_clean(pc)


def test_abort_unpins_without_commit():
    pc = PrefixCache(block_tokens=4, max_bytes=1 << 20)
    h = pc.begin(np.arange(8, dtype=np.int32), max_match=8, max_commit=8)
    h.rows = [_fake_rows()]  # captured, then the admission dies
    pc.abort(h)
    pc.abort(h)  # idempotent
    assert pc.n_nodes == 0 and pc.counters["aborts"] == 1
    _assert_accounting_clean(pc)


def test_bind_refuses_mismatched_model_identity():
    pc = PrefixCache()
    pc.bind("model-a")
    pc.bind("model-a")  # the same identity is fine
    with pytest.raises(ValueError, match="bound to model identity"):
        pc.bind("model-b")
    # an engine of another quantization policy refuses a bound cache
    warm = _warm_engine("dense")
    with pytest.raises(ValueError, match="bound to model identity"):
        Engine(_cfg(), _params("bcq"), max_seq=MAX_SEQ, device="cpu", prefix_cache=warm.prefix_cache)


def test_model_identity_distinguishes_policies():
    cfg = _cfg()
    dense = model_identity(cfg, _params("dense"))
    bcq = model_identity(cfg, _params("bcq"))
    ternary = model_identity(cfg, _params("ternary"))
    assert len({dense, bcq, ternary}) == 3
    assert model_identity(cfg, _params("bcq")) == bcq  # deterministic
    assert model_identity(dataclasses.replace(cfg, rope_theta=1e4), _params("bcq")) != bcq


def test_refcount_eviction_property_randomized():
    """A fixed-seed random interleaving of begin / complete / abort /
    evict_to: the accounting holds at every step, refs never underflow and
    the byte ledger matches the live nodes."""
    rng = np.random.default_rng(0)
    pc = PrefixCache(block_tokens=2, max_bytes=4096)
    open_handles = []
    for _ in range(300):
        op = rng.integers(0, 4)
        if op == 0:
            toks = rng.integers(0, 5, size=int(rng.integers(2, 9)))
            h = pc.begin(toks.astype(np.int32), max_match=toks.size, max_commit=toks.size)
            h.rows = [_fake_rows(int(rng.integers(16, 64))) for _ in h.new_spans]
            open_handles.append(h)
        elif op == 1 and open_handles:
            pc.complete(open_handles.pop(int(rng.integers(len(open_handles)))))
        elif op == 2 and open_handles:
            pc.abort(open_handles.pop(int(rng.integers(len(open_handles)))))
        elif op == 3:
            pc.evict_to(int(rng.integers(0, 4096)))
        assert pc.cached_bytes == sum(n.nbytes for n in pc._nodes)
        assert all(n.refs >= 0 for n in pc._nodes)
        assert pc.pinned == sum(len(h.matched) for h in open_handles)
    for h in open_handles:
        pc.abort(h)
    _assert_accounting_clean(pc)


def test_committed_blocks_are_copies():
    """A block's rows are a copy of the admission's cache rows: their own
    storage, exactly the rows' bytes, and unchanged by later writes."""
    warm = _warm_engine("dense")
    slots = warm.init_slots(1)
    (req,) = _shared_prefix_requests(1)
    warm.admit_slot(slots, 0, req.prompt, max_new_tokens=2)
    node = warm.prefix_cache._nodes[0]
    k = node.rows["stages"][0]["b0"]["k"]
    expect = 2 * _cfg().n_layers * 4 * _cfg().n_kv_heads * _cfg().d_head * 4  # k and v, 4 f32 rows a layer
    assert node.nbytes == expect and k.untyped_storage().nbytes() == k.nbytes
    before = k.clone()
    slots["cache"]["stages"][0]["b0"]["k"].fill_(7.0)
    assert torch.equal(k, before)


# ---------------------------------------------------------------------------
# warm == cold == solo across the serving grid
# ---------------------------------------------------------------------------

GRID = [
    ("dense", None),
    ("bcq", None),
    ("bcq", SpecConfig(q_draft=2, gamma=3)),
    ("ternary", None),
    ("ternary", SpecConfig(q_draft=1, gamma=2)),
]


@pytest.mark.parametrize("fmt,spec", GRID, ids=[f"{f}-{'spec' if s else 'plain'}" for f, s in GRID])
def test_warm_vs_cold_identity(fmt, spec):
    """A second wave of identical prompts served against the warm cache
    emits the cold engine's tokens, token for token; a greedy request equals
    solo generate; the accounting is clean."""
    warm = _warm_engine(fmt)
    _run(warm, _shared_prefix_requests(5), speculate=spec)  # wave 1: populate
    hits_before = warm.prefix_cache.counters["hits"]
    reqs_b = _shared_prefix_requests(5)
    sched_b, warm_done = _run(warm, reqs_b, speculate=spec)
    assert warm.prefix_cache.counters["hits"] - hits_before == len(reqs_b)
    assert all(sched_b.outcomes[r.rid].prefix_hit_tokens >= 12 for r in reqs_b)
    reqs_c = _shared_prefix_requests(5)
    _, cold_done = _run(_cold_engine(fmt), reqs_c, speculate=spec)
    _assert_same_tokens(reqs_b, warm_done, reqs_c, cold_done, f"warm vs cold ({fmt})")
    solo = _cold_engine(fmt).generate(reqs_b[0].prompt[None], reqs_b[0].max_new_tokens, speculate=spec)
    np.testing.assert_array_equal(warm_done[reqs_b[0].rid].new_tokens, solo.tokens[0, reqs_b[0].prompt.size:])
    _assert_accounting_clean(warm.prefix_cache)


def test_chunked_vs_unchunked_identity():
    """Chunked prefill is a scheduling knob, never a semantic one: the same
    workload through prefill_chunk=4 with a warm cache and through cold
    whole-shot admission emits the same tokens."""
    warm = _warm_engine("bcq")
    reqs = _shared_prefix_requests(6, prefix_len=16)
    sched, chunked_done = _run(warm, reqs, prefill_chunk=4)
    cold = _shared_prefix_requests(6, prefix_len=16)
    _, cold_done = _run(_cold_engine("bcq"), cold)
    _assert_same_tokens(reqs, chunked_done, cold, cold_done, "chunked + cache vs whole-shot")
    assert warm.prefix_cache.counters["hits"] > 0
    _assert_accounting_clean(warm.prefix_cache)


def test_chunked_prefill_without_cache_identity():
    """Chunked prefill with no prefix cache also equals whole-shot (the two
    features are independent)."""
    eng = _cold_engine("dense")
    reqs = _shared_prefix_requests(4, prefix_len=16, gen=5)
    _, chunked = _run(eng, reqs, prefill_chunk=4)
    whole_reqs = _shared_prefix_requests(4, prefix_len=16, gen=5)
    _, whole = _run(eng, whole_reqs)
    _assert_same_tokens(reqs, chunked, whole_reqs, whole, "chunked vs whole-shot")


def test_mid_flight_eviction_survivor_identity():
    """Evicting the whole cache between scheduler steps, while admissions pin
    and commit against it, never changes tokens: installs are copies, pinned
    paths survive, evicted blocks just stop matching."""
    warm = _warm_engine("dense")
    reqs = _shared_prefix_requests(6)
    sched = Scheduler(warm, n_slots=2, chunk=2, prefill_chunk=4)
    for r in reqs:
        sched.submit(r)
    done = {}
    while not sched.idle:
        for c in sched.step():
            done[c.rid] = c
        warm.prefix_cache.evict_to(0)  # maximum churn
        warm.prefix_cache.max_bytes = 64 << 20
    assert warm.prefix_cache.counters["evictions"] > 0
    cold = _shared_prefix_requests(6)
    _, cold_done = _run(_cold_engine("dense"), cold)
    _assert_same_tokens(reqs, done, cold, cold_done, "mid-flight eviction")
    _assert_accounting_clean(warm.prefix_cache)


def test_metrics_and_trace_instrumentation():
    """Counters mirror into the registry in lockstep, gauges track bytes and
    trie size, and cache_hit / evict instants land on the scheduler lane
    (the scheduler hands the cache its registry and tracer)."""
    from repro_torch.obs import MetricsRegistry, Tracer

    warm = _warm_engine("dense", block_tokens=4)
    metrics, tracer = MetricsRegistry(), Tracer()
    _run(warm, _shared_prefix_requests(5), metrics=metrics, tracer=tracer)
    _run(warm, _shared_prefix_requests(5), metrics=metrics, tracer=tracer)
    pc = warm.prefix_cache
    snap = metrics.snapshot()
    for key, host in pc.counters.items():
        assert sum(s["value"] for s in snap[f"prefix_{key}_total"]["series"]) == host, key
    assert snap["prefix_cached_bytes"]["series"][0]["value"] == pc.cached_bytes
    assert snap["prefix_trie_nodes"]["series"][0]["value"] == pc.n_nodes
    assert snap["prefix_pinned_refs"]["series"][0]["value"] == 0
    hits = [e for e in tracer.events() if e[1] == "cache_hit"]
    assert hits and all(e[3] == "scheduler" for e in hits)
    pc.evict_to(0)
    assert "evict" in [e["name"] for e in tracer.to_chrome()["traceEvents"]]
    assert metrics.gauge("prefix_cached_bytes").value == 0 == pc.cached_bytes


def test_prefix_hit_tokens_stamped_on_lifecycle():
    warm = _warm_engine("dense")
    _run(warm, _shared_prefix_requests(4))
    sched, done = _run(warm, _shared_prefix_requests(4))
    assert all(sched.outcomes[rid].prefix_hit_tokens >= 12 for rid in done)
    assert all(sched.outcomes[rid].prefill_chunks == 1 for rid in done)  # synchronous admission: one dispatch
    # a cold cache and chunked admission: 14..17-token prompts over 4-token
    # chunks take several dispatches (fewer after a hit), and the stamp
    # records them
    reqs = _shared_prefix_requests(4)
    sched2, done2 = _run(_warm_engine("dense"), reqs, prefill_chunk=4)
    for r in reqs:
        rec = sched2.outcomes[r.rid]
        assert rec.prefill_chunks == math.ceil((r.prompt.size - rec.prefix_hit_tokens) / 4), rec
    assert any(sched2.outcomes[rid].prefill_chunks > 1 for rid in done2)
    assert any(sched2.outcomes[rid].prefix_hit_tokens for rid in done2)


def test_speculative_chunked_admission_identity():
    """A speculative scheduler with chunked prefill and a warm cache: the
    target prefills in chunks, the draft whole-shot at finish; greedy tokens
    equal solo plain generate."""
    spec = SpecConfig(q_draft=2, gamma=3)
    warm = _warm_engine("bcq")
    _run(warm, _shared_prefix_requests(4, prefix_len=16), speculate=spec, prefill_chunk=4)
    reqs = _shared_prefix_requests(4, prefix_len=16)
    sched, done = _run(warm, reqs, speculate=spec, prefill_chunk=4)
    cold = _shared_prefix_requests(4, prefix_len=16)
    _, cold_done = _run(_cold_engine("bcq"), cold, speculate=spec)
    _assert_same_tokens(reqs, done, cold, cold_done, "speculative chunked + cache vs cold")
    for r in reqs:
        if r.temperature == 0:
            solo = _cold_engine("bcq").generate(r.prompt[None], r.max_new_tokens)
            np.testing.assert_array_equal(done[r.rid].new_tokens, solo.tokens[0, r.prompt.size:])
    _assert_accounting_clean(warm.prefix_cache)


# ---------------------------------------------------------------------------
# pending chunked admissions: cancel, deadline, failure
# ---------------------------------------------------------------------------


def _long_prompt_requests(n=3, plen=24, gen=4):
    corpus = MarkovCorpus(_cfg().vocab, seed=3)
    return [Request(prompt=corpus.sample(1, plen, seed=200 + i)[0, :plen].astype(np.int32), max_new_tokens=gen,
                    seed=5 + i) for i in range(n)]


def test_cancel_pending_chunked_admission_unpins():
    """Cancelling a request between its prefill chunks releases its prefix
    pins; the others finish with their cold tokens."""
    warm = _warm_engine("dense")
    _run(warm, _long_prompt_requests())  # populate: the second wave hits 20 of 24 tokens
    reqs = _long_prompt_requests()
    sched = Scheduler(warm, n_slots=3, chunk=2, prefill_chunk=1)
    for r in reqs:
        sched.submit(r)
    sched.step()  # every request begins and prefills one token of its suffix
    assert len(sched._pending) == 3
    pinned_one = len(sched._pending[1][1].handle.matched)
    assert pinned_one == 5 and warm.prefix_cache.pinned == 3 * pinned_one
    assert sched.cancel(reqs[1].rid)
    sched.step()
    assert sched.outcomes[reqs[1].rid].state is RequestState.CANCELLED
    assert warm.prefix_cache.pinned == 2 * pinned_one
    done = {c.rid: c for c in sched.run()}
    assert reqs[1].rid not in done
    cold = _long_prompt_requests()
    _, cold_done = _run(_cold_engine("dense"), cold, n_slots=3)
    for i in (0, 2):
        np.testing.assert_array_equal(done[reqs[i].rid].new_tokens, cold_done[cold[i].rid].new_tokens)
    assert warm.prefix_cache.counters["aborts"] == 1
    _assert_accounting_clean(warm.prefix_cache)


def test_deadline_of_pending_chunked_admission_unpins():
    """A pending chunked admission past its TTFT deadline times out between
    chunks and releases its pins."""
    warm = _warm_engine("dense")
    _run(warm, _long_prompt_requests(1))
    (req,) = _long_prompt_requests(1)
    req.ttft_deadline_s = 2.5
    sched = Scheduler(warm, n_slots=1, chunk=2, prefill_chunk=1, clock=StepClock(dt=1.0))
    sched.submit(req)
    sched.step()  # begins (a hit of 20 tokens) and prefills one token of the 4 left
    assert sched._pending and warm.prefix_cache.pinned == 5
    sched.run()
    rec = sched.outcomes[req.rid]
    assert rec.state is RequestState.TIMED_OUT and "mid-prefill" in rec.reason
    assert warm.prefix_cache.counters["aborts"] == 1
    _assert_accounting_clean(warm.prefix_cache)


def test_failed_begin_fails_only_its_request():
    """A FaultPlan prefill failure fires at begin: in chunked mode it fails
    only its request, and the others keep their cold tokens."""
    warm = _warm_engine("dense")
    reqs = _long_prompt_requests()
    faults = FaultPlan(fail_prefill={1: -1})  # the second request's rid: the scheduler numbers from 0
    sched, done = _run(warm, reqs, prefill_chunk=4, n_slots=3, faults=faults, backoff_s=0.0)
    assert sched.outcomes[reqs[1].rid].state is RequestState.FAILED
    assert "admission begin" in sched.outcomes[reqs[1].rid].reason
    assert faults.fired_prefill == sched.retries + 1
    cold = _long_prompt_requests()
    _, cold_done = _run(_cold_engine("dense"), cold, n_slots=3)
    for i in (0, 2):
        np.testing.assert_array_equal(done[reqs[i].rid].new_tokens, cold_done[cold[i].rid].new_tokens)
    _assert_accounting_clean(warm.prefix_cache)


def test_failed_chunk_aborts_its_handle(monkeypatch):
    """A prefill chunk that keeps failing fails its request alone and aborts
    its prefix handle."""
    warm = _warm_engine("dense")
    reqs = _long_prompt_requests(2)
    real = warm.advance_admission

    def flaky(pending, budget=None):
        if torch.equal(pending.prompt[0], torch.as_tensor(reqs[0].prompt).long()) and pending.pos >= 8:
            raise RuntimeError("injected chunk failure")
        return real(pending, budget)

    monkeypatch.setattr(warm, "advance_admission", flaky)
    sched, done = _run(warm, reqs, prefill_chunk=4, n_slots=2, backoff_s=0.0)
    assert sched.outcomes[reqs[0].rid].state is RequestState.FAILED
    assert "prefill chunk" in sched.outcomes[reqs[0].rid].reason
    assert reqs[1].rid in done
    assert warm.prefix_cache.counters["aborts"] == 1
    _assert_accounting_clean(warm.prefix_cache)


# ---------------------------------------------------------------------------
# refusals
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("block,missing", [("rglru", "recurrent"), ("local_attn", "ring-buffer")],
                         ids=["rglru-recurrent boundary snapshots", "local_attn-ring guard"])
def test_prefix_cache_and_chunking_refused_on_unported_families(block, missing):
    """Ring-window and recurrent models take a prefix cache (the ring guard
    and the recurrent boundary snapshots are ported; ``test_torch_hybrid.py``
    holds them), but chunked prefill stays refused for them, with the
    reference's reason (``Engine.supports_chunked_prefill``)."""
    cfg = dataclasses.replace(_cfg(), stages=(((block,), _cfg().n_layers),))
    eng = Engine(cfg, _params("dense"), max_seq=MAX_SEQ, device="cpu", prefix_cache=PrefixCache())
    assert eng.prefix_cache is not None and not eng.supports_chunked_prefill
    with pytest.raises(ValueError, match=missing):
        Scheduler(eng, n_slots=2, chunk=2, prefill_chunk=4)
    with pytest.raises(ValueError, match="chunked prefill"):
        eng.begin_admission(np.arange(6), max_new_tokens=2, chunked=True)


def test_scheduler_and_engine_validation():
    eng = _cold_engine("dense")
    assert eng.supports_chunked_prefill
    with pytest.raises(ValueError, match="prefill_chunk must be >= 1"):
        Scheduler(eng, n_slots=1, prefill_chunk=0)
    p = eng.begin_admission(np.arange(6), max_new_tokens=2, chunked=True)
    with pytest.raises(ValueError, match="not finished"):
        eng.finish_admission(eng.init_slots(1), 0, p)
    with pytest.raises(ValueError, match="max_seq"):
        eng.begin_admission(np.arange(MAX_SEQ), max_new_tokens=2)
    with pytest.raises(ValueError, match="metrics / tracer"):
        PrefixCache(metrics=object())
    with pytest.raises(ValueError, match="block_tokens"):
        PrefixCache(block_tokens=0)


# ---------------------------------------------------------------------------
# against the JAX package, on the same weights
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def jax_pair():
    """(JAX config, JAX params, port config, port params): the same f32
    weights in both packages."""
    jcfg = jreduced(jget_config("llama3.2-3b"), **SIZES)
    jp = jinit_params(jax.random.PRNGKey(0), jcfg)
    return jcfg, jp, _cfg(), params_from_numpy(jax_tree_to_numpy(jp), device="cpu")


def _greedy(reqs):
    for r in reqs:
        r.temperature = 0.0
    return reqs


def test_matches_jax_engine_with_prefix_cache(jax_pair):
    """A JAX Engine with a PrefixCache and the port's, the same greedy
    requests through chunked admission (prefill_chunk=4), twice: the same
    tokens and the same hit / commit counts."""
    jcfg, jp, tcfg, tp = jax_pair
    jeng = JEngine(jcfg, jp, max_seq=MAX_SEQ, prefix_cache=JPrefixCache(block_tokens=4))
    teng = Engine(tcfg, tp, max_seq=MAX_SEQ, device="cpu", prefix_cache=PrefixCache(block_tokens=4))
    for wave in range(2):
        jreqs = _greedy(_shared_prefix_requests(5, prefix_len=16, cls=JRequest))
        treqs = _greedy(_shared_prefix_requests(5, prefix_len=16))
        js = JScheduler(jeng, n_slots=2, chunk=3, prefill_chunk=4)
        for r in jreqs:
            js.submit(r)
        jdone = {c.rid: c for c in js.run()}
        _, tdone = _run(teng, treqs, prefill_chunk=4)
        for jr, tr in zip(jreqs, treqs):
            np.testing.assert_array_equal(np.asarray(jdone[jr.rid].new_tokens), tdone[tr.rid].new_tokens,
                                          err_msg=f"wave {wave}, request {tr.rid}")
        for key in ("hits", "misses", "commits", "aborts"):
            assert jeng.prefix_cache.counters[key] == teng.prefix_cache.counters[key], key
    assert teng.prefix_cache.counters["hits"] >= 5
    _assert_accounting_clean(teng.prefix_cache)


def test_warm_suffix_logits_match_jax_prefill_chunk(jax_pair):
    """The port's last-prompt-position logits of a warm suffix (the prefix
    installed from the cache) against JAX's ``_prefill_chunk`` over the same
    prefix rows: within ``JAX_LOGITS_REL_TOL`` of max|logit| (f32)."""
    jcfg, jp, tcfg, tp = jax_pair
    (req,) = _shared_prefix_requests(1, prefix_len=16)
    plen = req.prompt.size
    teng = Engine(tcfg, tp, max_seq=MAX_SEQ, device="cpu", prefix_cache=PrefixCache(block_tokens=4))
    teng.admit_slot(teng.init_slots(1), 0, req.prompt, max_new_tokens=2)  # commit the blocks
    pending = teng.begin_admission(req.prompt, max_new_tokens=2)
    hit = pending.handle.length
    assert hit == 4 * ((plen - 1) // 4)
    teng.advance_admission(pending)
    teng.abort_admission(pending)
    tlogits = pending.logits1[0].numpy()

    jeng = JEngine(jcfg, jp, max_seq=MAX_SEQ)
    prompt = jnp.asarray(req.prompt[None])
    _, jcache, _ = jforward(jcfg, jeng.params, tokens=prompt[:, :hit], cache=jinit_cache(jcfg, 1, MAX_SEQ),
                            pos=jnp.int32(0), logits_mode="last")
    jlast, _ = jeng._prefill_chunk(jeng.params, prompt[:, hit:], jcache, jnp.int32(hit), jnp.int32(plen - hit - 1))
    jlogits = np.asarray(jlast[0])
    rel = np.abs(tlogits - jlogits).max() / np.abs(jlogits).max()
    assert rel <= JAX_LOGITS_REL_TOL, rel


# ---------------------------------------------------------------------------
# layers: the prefix rows and the pos > 0 prefill
# ---------------------------------------------------------------------------


def test_gather_install_prefix_rows_roundtrip():
    cfg = _cfg()
    gen = torch.Generator().manual_seed(0)
    cache = init_cache(cfg, 1, 20, device="cpu")
    for leaf in (cache["stages"][0]["b0"]["k"], cache["stages"][0]["b0"]["v"]):
        leaf.copy_(torch.randn(leaf.shape, generator=gen))
    blocks = [L.gather_prefix_rows(cache, s, 4) for s in (0, 4, 8)]
    fresh = L.install_prefix_rows(init_cache(cfg, 1, 20, device="cpu"), concat_rows(blocks))
    for key in ("k", "v"):
        src, dst = cache["stages"][0]["b0"][key], fresh["stages"][0]["b0"][key]
        assert torch.equal(dst[:, :, :12], src[:, :, :12])
        assert not dst[:, :, 12:].any()
        assert blocks[1]["stages"][0]["b0"][key].shape == (cfg.n_layers, 1, 4, cfg.n_kv_heads, cfg.d_head)
        assert blocks[1]["stages"][0]["b0"][key].data_ptr() != src.data_ptr()


@pytest.mark.parametrize("split", [1, 5, 8, 13])
def test_prefill_at_pos_matches_whole_prompt(split):
    """The repaired fault: a prompt's tail prefilled at ``pos = split`` over
    a cache holding its first ``split`` rows gives the logits and the K/V
    rows of the whole prompt's prefill (within 2e-5, f32). Before the
    repair the tail attended only itself."""
    cfg = _cfg()
    params = _params("dense")
    tokens = torch.as_tensor(_shared_prefix_requests(1, prefix_len=14)[0].prompt[None]).long()
    s = tokens.shape[1]
    whole_logits, whole = forward(cfg, params, tokens=tokens, cache=init_cache(cfg, 1, 32, device="cpu"), pos=0,
                                  logits_mode="all")
    cache = init_cache(cfg, 1, 32, device="cpu")
    forward(cfg, params, tokens=tokens[:, :split], cache=cache, pos=0, logits_mode="last")
    tail_logits, cache = forward(cfg, params, tokens=tokens[:, split:], cache=cache, pos=split, logits_mode="all")
    err = (tail_logits - whole_logits[:, split:]).abs().max().item()
    assert err <= POS_TOL, err
    for key in ("k", "v"):
        d = (cache["stages"][0]["b0"][key][:, :, :s] - whole["stages"][0]["b0"][key][:, :, :s]).abs().max().item()
        assert d <= POS_TOL, (key, d)


@pytest.mark.parametrize("q_start,sq", [(0, 5), (3, 1), (7, 6), (20, 9)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attention_plain_offset(q_start, sq, dtype):
    """``flash_attention_plain(q_start=…)`` is ``sdpa`` under
    ``causal_mask(Sq, Sk)``, which equals a per-row softmax over keys
    ``<= q_start + r`` computed in f64; the wrapper on CPU tensors runs it."""
    gen = torch.Generator().manual_seed(q_start * 31 + sq)
    b, h, hkv, dh = 2, 4, 2, 16
    sk = q_start + sq
    q = torch.randn((b, sq, h, dh), generator=gen).to(dtype)
    k = torch.randn((b, sk, hkv, dh), generator=gen).to(dtype)
    v = torch.randn((b, sk, hkv, dh), generator=gen).to(dtype)
    out = flash_attention_plain(q, k, v, q_start)
    assert torch.equal(out, sdpa(q, k, v, causal_mask(sq, sk)))
    assert torch.equal(flash_attention(q, k, v, q_start), out)
    g = h // hkv
    ref = torch.empty((b, sq, h, dh), dtype=torch.float64)
    for r in range(sq):
        keys = slice(0, q_start + r + 1)
        for hh in range(h):
            logit = torch.einsum("bd,bkd->bk", q[:, r, hh].double(), k[:, keys, hh // g].double()) / math.sqrt(dh)
            ref[:, r, hh] = torch.einsum("bk,bkd->bd", torch.softmax(logit, -1), v[:, keys, hh // g].double())
    tol = 2e-5 if dtype == torch.float32 else 3e-2
    assert (out.double() - ref).abs().max().item() <= tol
    with pytest.raises(ValueError, match="q_start"):
        flash_attention(q, k[:, :-1], v[:, :-1], q_start)


def test_long_prompt_query_blocks_take_the_offset():
    """``_sdpa_qchunked`` (the plain path from ``LONG_SEQ_THRESHOLD`` queries
    on) with an offset equals one ``sdpa`` under ``causal_mask(Sq, Sk)``."""
    gen = torch.Generator().manual_seed(1)
    q = torch.randn((1, 8, 2, 16), generator=gen)
    k = torch.randn((1, 13, 2, 16), generator=gen)
    v = torch.randn((1, 13, 2, 16), generator=gen)
    got = L._sdpa_qchunked(q, k, v, chunk=4, q_start=5)
    want = sdpa(q, k, v, causal_mask(8, 13))
    assert (got - want).abs().max().item() <= 1e-6


# ---------------------------------------------------------------------------
# CLI
# ---------------------------------------------------------------------------


def test_serve_cli_prefix_cache_and_chunked_prefill(capsys):
    serve.main(["--device", "cpu", "--prefix-cache-mb", "8", "--shared-prefix-len", "8", "--prefill-chunk", "4",
                "--prefix-block", "4", "--requests", "6", "--gen", "4"])
    out = capsys.readouterr().out
    line = next(x for x in out.splitlines() if x.startswith("prefix cache:"))
    hits, misses = int(line.split()[2]), int(line.split()[5])
    assert hits + misses == 6 and hits > 0


@pytest.mark.parametrize("argv,missing", [
    (["--shared-prefix-len", "16"], "at least one token of its own"),
    (["--prefix-block", "4"], "needs --prefix-cache-mb"),
    (["--prefill-chunk", "-2"], "chunked prefill"),
    (["--sequential", "--prefill-chunk", "4"], "cannot be combined with --sequential"),
])
def test_serve_cli_prefix_validation(capsys, argv, missing):
    with pytest.raises(SystemExit) as e:
        serve.main(argv + ["--device", "cpu"])
    assert e.value.code == 2
    assert missing in capsys.readouterr().err


def test_prompt_rows_scope_marks_token_shaped_rows_as_prompt_rows():
    """A one-token prompt chunk is token-shaped, ``(1, 1, k)``; inside
    ``forward(prefill=True)`` (:func:`utils.prompt_rows`) its products are
    told they are a prompt's rows, so on the GPU it takes the prompt tiles
    its row has in the whole prompt."""
    from repro_torch.utils import prompt_rows, token_rows

    x = torch.zeros((1, 1, 8))
    assert token_rows(x)
    with prompt_rows():
        assert not token_rows(x)
        with prompt_rows(False):
            assert token_rows(x)
        assert not token_rows(x)
    assert token_rows(x)
