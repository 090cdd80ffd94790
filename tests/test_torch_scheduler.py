"""The port's continuous-batching scheduler, the mirror of
``tests/test_scheduler.py``: the interleaving must be invisible — every
request's tokens are identical, bit for bit, to a solo batch-1
``Engine.generate`` with the same prompt, temperature and seed, however
requests are interleaved, admitted mid-flight or slots reused.

Not mirrored: ``test_continuous_batching_recurrent_and_window`` (the port
has no recurrent or windowed architectures yet). Added: the port's
scheduler gives the greedy completions of the reference's ``Scheduler`` on
the same weights, and refuses the subsystems it does not have. Speculative
slots are held in ``tests/test_torch_speculative.py``.
"""

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.infer import Engine as JEngine
from repro.infer import Request as JRequest
from repro.infer import Scheduler as JScheduler
from repro.models import forward as jforward
from repro.models import init_params as jinit_params
from repro.models import reduced as jreduced
from repro.quant import QuantPolicy as JPolicy
from repro.quant import quantize_params as jquantize_params
from repro_torch.configs import get_config
from repro_torch.data import MarkovCorpus
from repro_torch.infer import Engine, Request, Scheduler, SpecConfig
from repro_torch.models import init_params, params_from_numpy, reduced
from repro_torch.quant import QuantPolicy, quantize_params
from torch_helpers import jax_tree_to_numpy


def _cfg():
    return reduced(get_config("llama3.2-3b"))


def _engine(q=0, max_seq=40):
    params = init_params(_cfg(), seed=0, device="cpu")
    if q:
        params = quantize_params(params, QuantPolicy(q=q, g=64, iters=2), device="cpu")
    return Engine(_cfg(), params, max_seq=max_seq, device="cpu")


def _requests(cfg, n, *, seed=0, min_len=4, max_len=12, min_gen=3, max_gen=14, cls=Request):
    """Mixed lengths, mixed greedy/sampled temperatures, per-request seeds."""
    corpus = MarkovCorpus(cfg.vocab, seed=3)
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        plen = int(rng.integers(min_len, max_len))
        prompt = corpus.sample(1, plen, seed=100 + i)[0, :plen].astype(np.int32)
        out.append(
            cls(
                prompt=prompt,
                max_new_tokens=int(rng.integers(min_gen, max_gen)),
                temperature=[0.0, 1.0, 0.7][i % 3],
                seed=10 + i,
            )
        )
    return out


def _assert_identical_to_solo(eng, reqs, done):
    for r in reqs:
        solo = eng.generate(r.prompt[None], r.max_new_tokens, temperature=r.temperature, seed=r.seed)
        np.testing.assert_array_equal(
            solo.tokens[0, r.prompt.size :],
            done[r.rid].new_tokens,
            err_msg=f"request {r.rid} diverged from solo generate",
        )
        np.testing.assert_array_equal(done[r.rid].tokens[: r.prompt.size], r.prompt)


@pytest.mark.parametrize("q", [0, 3], ids=["dense", "bcq_q3"])
def test_continuous_batching_token_identical(q):
    """6 requests through 3 slots (half admitted mid-flight into freed
    slots), mixed prompt lengths, mixed greedy/sampled temperatures, for a
    dense and a BCQ q=3 g=64 model."""
    eng = _engine(q, max_seq=48)
    reqs = _requests(_cfg(), 6)
    sched = Scheduler(eng, n_slots=3, chunk=4)
    for r in reqs:
        sched.submit(r)
    done = {c.rid: c for c in sched.run()}
    assert len(done) == len(reqs)
    assert max(c.admitted_at_step for c in done.values()) > 0
    _assert_identical_to_solo(eng, reqs, done)


@pytest.mark.parametrize("q", [0, 3], ids=["dense", "bcq_q3"])
def test_slot_logits_bitwise_equal_solo(q):
    """Below the tokens: a slot batch's carried logits equal, bit for bit,
    those of the same request decoded alone (prefill, then the same tokens
    one step at a time), so no near-tie can flip a token."""
    eng = _engine(q, max_seq=48)
    rng = np.random.default_rng(5)
    prompts = [rng.integers(0, _cfg().vocab, size=n).astype(np.int32) for n in (5, 11, 8)]
    slots = eng.init_slots(len(prompts))
    for i, p in enumerate(prompts):
        eng.admit_slot(slots, i, p, max_new_tokens=4)
    toks, _, slots = eng.decode_slots(slots, 3)
    for i, p in enumerate(prompts):
        logits, cache = eng.prefill(torch.as_tensor(p[None]).long(), eng._make_cache(1))
        for t in range(3):
            logits, cache = eng.decode(torch.tensor([[int(toks[i, t])]]), cache, p.size + t)
        assert torch.equal(logits[0], slots["logits"][i]), f"slot {i}"


def test_slot_reuse_does_not_leak_state():
    """The same request as the first and the last tenant of a heavily
    reused slot pool emits identical tokens (slot-reset contract)."""
    cfg = _cfg()
    eng = _engine()
    corpus = MarkovCorpus(cfg.vocab, seed=5)
    prompt = corpus.sample(1, 6, seed=1)[0, :6].astype(np.int32)
    twin = dict(prompt=prompt, max_new_tokens=8, temperature=1.0, seed=99)
    sched = Scheduler(eng, n_slots=2, chunk=2)
    first = sched.submit(Request(**twin))
    for r in _requests(cfg, 5, seed=7, max_len=8, max_gen=8):
        sched.submit(r)
    last = sched.submit(Request(**twin))
    done = {c.rid: c for c in sched.run()}
    np.testing.assert_array_equal(done[first].new_tokens, done[last].new_tokens)


def test_mid_chunk_completion_and_budgets():
    """A request finishing mid-chunk stops exactly at its budget while its
    neighbour keeps decoding; every completion has its exact length."""
    cfg = _cfg()
    eng = _engine()
    p = MarkovCorpus(cfg.vocab, seed=9).sample(2, 5, seed=2).astype(np.int32)
    sched = Scheduler(eng, n_slots=2, chunk=8)  # budgets 3 and 13 straddle chunks
    a = sched.submit(Request(prompt=p[0, :5], max_new_tokens=3))
    b = sched.submit(Request(prompt=p[1, :5], max_new_tokens=13))
    done = {c.rid: c for c in sched.run()}
    assert done[a].new_tokens.shape == (3,)
    assert done[b].new_tokens.shape == (13,)
    assert done[a].finished_at_step < done[b].finished_at_step
    assert sched.steps_active == 3 + 13


def test_chunk_one_matches_larger_chunks():
    """Chunk size is a latency/throughput knob, never a semantics knob."""
    eng = _engine()
    reqs = _requests(_cfg(), 4, seed=11, max_len=8, max_gen=8)
    outs = []
    for chunk in (1, 5):
        sched = Scheduler(eng, n_slots=2, chunk=chunk)
        rids = [
            sched.submit(Request(prompt=r.prompt, max_new_tokens=r.max_new_tokens,
                                 temperature=r.temperature, seed=r.seed))
            for r in reqs
        ]
        done = {c.rid: c for c in sched.run()}
        outs.append([done[rid].new_tokens for rid in rids])
    for x, y in zip(*outs):
        np.testing.assert_array_equal(x, y)


def test_scheduler_validation():
    eng = _engine(max_seq=16)
    sched = Scheduler(eng, n_slots=2, chunk=2)
    with pytest.raises(ValueError):
        Request(prompt=np.zeros((0,), np.int32), max_new_tokens=4)
    with pytest.raises(ValueError):
        Request(prompt=np.zeros((4,), np.int32), max_new_tokens=0)
    with pytest.raises(ValueError):  # prompt + gen exceeds the engine's cache
        sched.submit(Request(prompt=np.zeros((10,), np.int32), max_new_tokens=10))
    with pytest.raises(ValueError):
        Scheduler(eng, n_slots=0)
    assert sched.idle and sched.step() == []


@pytest.mark.parametrize("kw,missing", [
    # speculation is ported; a speculate that is not a SpecConfig is refused
    (dict(speculate=object()), "speculative"),
    (dict(prefill_chunk=4), "chunked admission"),
    (dict(tracer=object()), "span tracer"),
    (dict(metrics=object()), "metrics registry"),
])
def test_scheduler_refuses_unported_subsystems(kw, missing):
    with pytest.raises(ValueError, match=missing):
        Scheduler(_engine(), n_slots=2, **kw)


def test_init_slots_refuses_speculation():
    """``init_slots`` takes a SpecConfig (speculation is ported) and refuses
    anything else."""
    with pytest.raises(ValueError, match="speculative"):
        _engine().init_slots(2, speculate=object())
    slots = _engine().init_slots(2, speculate=SpecConfig(2, 2))
    assert {"draft_cache", "t_pend", "spec", "draft_gens"} <= set(slots)
    assert not slots["active"].any() and slots["t_pend"].shape == (2,)


def test_greedy_completions_match_reference_scheduler():
    """Same weights in both packages (the reference's BCQ q=4 g=128 model
    carried across), the same greedy requests through each package's
    scheduler: identical completions wherever the reference's own next-token
    choice is decisive at every step (its top-1/top-2 logit margin exceeds
    the f32 parity tolerance; random-init logits can nearly tie, and a near
    tie may flip on summation order alone)."""
    sizes = dict(d_model=256, n_kv_heads=4, d_ff=512)
    jcfg = jreduced(jget_config("llama3.2-3b"), **sizes)
    jq = jquantize_params(jinit_params(jax.random.PRNGKey(0), jcfg), JPolicy(q=4, g=128, method="greedy"))
    tcfg = reduced(get_config("llama3.2-3b"), **sizes)
    teng = Engine(tcfg, params_from_numpy(jax_tree_to_numpy(jq), device="cpu"), max_seq=40, device="cpu")
    jeng = JEngine(jcfg, jq, max_seq=40)

    def greedy(reqs):
        for r in reqs:
            r.temperature = 0.0
        return reqs

    jreqs = greedy(_requests(tcfg, 5, seed=21, max_gen=10, cls=JRequest))
    treqs = greedy(_requests(tcfg, 5, seed=21, max_gen=10))
    jsched, tsched = JScheduler(jeng, n_slots=2, chunk=3), Scheduler(teng, n_slots=2, chunk=3)
    jrids = [jsched.submit(r) for r in jreqs]
    trids = [tsched.submit(r) for r in treqs]
    jdone = {c.rid: c for c in jsched.run()}
    tdone = {c.rid: c for c in tsched.run()}

    decisive = 0
    for jr, jrid, trid in zip(jreqs, jrids, trids):
        full = np.concatenate([jr.prompt, jdone[jrid].new_tokens])[None]
        logits, _, _ = jforward(jcfg, jeng.params, tokens=jax.numpy.asarray(full))
        steps = np.asarray(logits[0, jr.prompt.size - 1 : -1])  # logits that chose each new token
        top2 = np.sort(steps, axis=-1)[:, -2:]
        if not ((top2[:, 1] - top2[:, 0]) > 8e-5 * (1 + np.abs(top2[:, 1]))).all():
            continue
        decisive += 1
        np.testing.assert_array_equal(tdone[trid].new_tokens, jdone[jrid].new_tokens)
    assert decisive >= 3
