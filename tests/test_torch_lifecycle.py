"""The port's request lifecycle, the mirror of ``tests/test_lifecycle.py``:
**survivor invariance** — with any subset of requests cancelled, timed out
or failed by injected faults mid-flight, every surviving request's tokens
are bit-identical to the same request in an undisturbed run — plus the
state machine, validation, backpressure, deadlines, retry, stop tokens and
the streaming callbacks.

Not mirrored: the speculative and tensor-parallel cells of the survivor
matrix (``test_survivor_invariance_speculative``,
``test_survivor_invariance_tp2``): neither subsystem is ported. Added: a
decode chunk that fails part-way leaves the slot state as it was, so its
retry is exact; and the port's lifecycle modules match the reference's.
"""

import functools

import numpy as np
import pytest

from repro.infer import lifecycle as jlifecycle
from repro_torch.configs import get_config
from repro_torch.data import MarkovCorpus
from repro_torch.infer import (
    Engine,
    FaultPlan,
    QueueFullError,
    Request,
    RequestLifecycle,
    RequestState,
    Scheduler,
    StepClock,
    TransitionError,
)
from repro_torch.infer import lifecycle
from repro_torch.models import init_params, reduced
from repro_torch.quant import QuantPolicy, quantize_params
import torch_helpers  # noqa: F401  (one torch thread per test worker)

MAX_SEQ = 64
Q_GROUP = 32  # the reference suite's group size


def _cfg():
    return reduced(get_config("llama3.2-3b"), d_model=128, n_kv_heads=4, d_ff=256)


@functools.lru_cache(maxsize=None)
def _engine(q: int) -> Engine:
    params = init_params(_cfg(), seed=0, device="cpu")
    if q:
        params = quantize_params(params, QuantPolicy(q=q, g=Q_GROUP, iters=2), device="cpu")
    return Engine(_cfg(), params, max_seq=MAX_SEQ, device="cpu")


def _requests(n, *, gen=8, seed0=0, **kw):
    """Fresh Request objects every call (submit assigns rids)."""
    corpus = MarkovCorpus(_cfg().vocab, seed=3)
    out = []
    for i in range(n):
        plen = 4 + (i % 3)
        prompt = corpus.sample(1, plen, seed=100 + i)[0, :plen].astype(np.int32)
        out.append(
            Request(prompt=prompt, max_new_tokens=gen, temperature=[0.0, 1.0, 0.7][i % 3],
                    seed=seed0 + 10 + i, **kw)
        )
    return out


def _run(engine, reqs, *, n_slots=2, chunk=3, **sched_kw):
    sched = Scheduler(engine, n_slots=n_slots, chunk=chunk, **sched_kw)
    rids = [sched.submit(r) for r in reqs]
    done = {c.rid: c for c in sched.run()}
    return sched, rids, done


# ---------------------------------------------------------------------------
# state machine
# ---------------------------------------------------------------------------


def test_state_machine_legal_chain():
    rec = RequestLifecycle(rid=0, submitted_at=1.0)
    rec.transition(RequestState.PREFILLING, 2.0)
    assert rec.admitted_at == 2.0
    rec.transition(RequestState.DECODING, 3.0)
    rec.transition(RequestState.FINISHED, 4.0)
    assert rec.state.terminal and rec.finished_at == 4.0
    assert [s for s, _ in rec.history] == [
        RequestState.PREFILLING,
        RequestState.DECODING,
        RequestState.FINISHED,
    ]


@pytest.mark.parametrize(
    "chain, bad",
    [
        ([], RequestState.DECODING),  # queued can't skip prefill
        ([], RequestState.FINISHED),
        ([RequestState.PREFILLING], RequestState.SHED),  # SHED is queue-only
        ([RequestState.SHED], RequestState.PREFILLING),  # terminal is terminal
        (
            [RequestState.PREFILLING, RequestState.DECODING, RequestState.FINISHED],
            RequestState.FAILED,
        ),
        (
            [RequestState.PREFILLING, RequestState.DECODING, RequestState.CANCELLED],
            RequestState.FINISHED,
        ),
    ],
)
def test_state_machine_illegal_transitions(chain, bad):
    rec = RequestLifecycle(rid=7)
    for s in chain:
        rec.transition(s, 0.0)
    with pytest.raises(TransitionError, match="illegal transition"):
        rec.transition(bad, 1.0)


def test_transition_table_matches_reference():
    """The port keeps its own copy of the numpy-only lifecycle module; its
    states and allowed transitions are the reference's."""
    assert [s.value for s in lifecycle.RequestState] == [s.value for s in jlifecycle.RequestState]
    ours = {a.value: sorted(b.value for b in bs) for a, bs in lifecycle._ALLOWED.items()}
    theirs = {a.value: sorted(b.value for b in bs) for a, bs in jlifecycle._ALLOWED.items()}
    assert ours == theirs


def test_cancel_unknown_or_terminal_rid_is_noop():
    sched = Scheduler(_engine(0), n_slots=2, chunk=2)
    assert not sched.cancel(12345)
    (req,) = _requests(1, gen=2)
    rid = sched.submit(req)
    sched.run()
    assert sched.outcomes[rid].state is RequestState.FINISHED
    assert not sched.cancel(rid)


# ---------------------------------------------------------------------------
# validation
# ---------------------------------------------------------------------------


def test_generate_rejects_prompt_past_cache():
    eng = _engine(0)
    with pytest.raises(ValueError, match=r"max_seq"):
        eng.generate(np.zeros((1, MAX_SEQ - 2), np.int32), 8)
    eng.generate(np.zeros((1, 4), np.int32), 2)
    with pytest.raises(ValueError, match=rf"vocab={_cfg().vocab}"):
        eng.generate(np.full((1, 4), _cfg().vocab, np.int32), 2)


def test_request_validation_loud():
    with pytest.raises(ValueError, match="integer token ids"):
        Request(prompt=np.array([0.5, 1.5]), max_new_tokens=4)
    with pytest.raises(ValueError, match="seed"):
        Request(prompt=np.array([1, 2]), max_new_tokens=4, seed=1.5)
    with pytest.raises(ValueError, match="int64"):
        Request(prompt=np.array([1, 2]), max_new_tokens=4, seed=2**63)
    with pytest.raises(ValueError, match="seed"):
        Request(prompt=np.array([1, 2]), max_new_tokens=4, seed=True)
    with pytest.raises(ValueError, match="stop_tokens"):
        Request(prompt=np.array([1, 2]), max_new_tokens=4, stop_tokens=[1.5])
    with pytest.raises(ValueError, match="deadline_s"):
        Request(prompt=np.array([1, 2]), max_new_tokens=4, deadline_s=-1.0)
    with pytest.raises(ValueError, match="ttft_deadline_s"):
        Request(prompt=np.array([1, 2]), max_new_tokens=4, ttft_deadline_s=0.0)
    Request(prompt=np.array([1, 2]), max_new_tokens=4, seed=-1)


def test_submit_rejects_out_of_vocab_prompt():
    sched = Scheduler(_engine(0), n_slots=1, chunk=1)
    bad = Request(prompt=np.array([0, _cfg().vocab], np.int32), max_new_tokens=4)
    with pytest.raises(ValueError, match=rf"vocab={_cfg().vocab}"):
        sched.submit(bad)


# ---------------------------------------------------------------------------
# backpressure
# ---------------------------------------------------------------------------


def test_bounded_queue_rejects_loudly_then_recovers():
    sched = Scheduler(_engine(0), n_slots=1, chunk=2, max_queue=2)
    for r in _requests(2, gen=3):
        sched.submit(r)
    with pytest.raises(QueueFullError, match="admission queue full"):
        sched.submit(_requests(1, gen=3, seed0=50)[0])
    assert sched.counters["rejected_queue_full"] == 1
    sched.run()
    rid = sched.submit(_requests(1, gen=3, seed0=60)[0])
    done = {c.rid: c for c in sched.run()}
    assert rid in done


def test_queue_bound_validation():
    eng = _engine(0)
    with pytest.raises(ValueError, match="max_queue"):
        Scheduler(eng, n_slots=1, max_queue=0)
    with pytest.raises(ValueError, match="retries"):
        Scheduler(eng, n_slots=1, retries=-1)


# ---------------------------------------------------------------------------
# survivor invariance: cancellation
# ---------------------------------------------------------------------------


def test_cancel_queued_and_midflight_survivors_identical():
    eng = _engine(0)
    _, rids_ref, ref = _run(eng, _requests(6))

    sched = Scheduler(eng, n_slots=2, chunk=3)
    rids = [sched.submit(r) for r in _requests(6)]
    out = sched.step()
    assert sched.cancel(rids[0])  # mid-flight
    assert sched.cancel(rids[4])  # still queued
    done = {c.rid: c for c in (out + sched.run())}

    assert sched.outcomes[rids[0]].state is RequestState.CANCELLED
    assert sched.outcomes[rids[4]].state is RequestState.CANCELLED
    assert rids[0] not in done and rids[4] not in done
    assert sched.counters["cancelled"] == 2
    partial = sched.outcomes[rids[0]].new_tokens
    np.testing.assert_array_equal(partial, ref[rids_ref[0]].new_tokens[: partial.size])
    for k in (1, 2, 3, 5):
        np.testing.assert_array_equal(
            done[rids[k]].new_tokens, ref[rids_ref[k]].new_tokens,
            err_msg=f"survivor {k} diverged after cancellations",
        )


# ---------------------------------------------------------------------------
# deadlines (injectable clock)
# ---------------------------------------------------------------------------


def test_deadline_timeout_midflight_survivors_identical():
    eng = _engine(0)
    _, rids_ref, ref = _run(eng, _requests(4))

    clk = StepClock()
    sched = Scheduler(eng, n_slots=2, chunk=3, clock=clk, sleep=clk.sleep)
    reqs = _requests(4)
    reqs[1].deadline_s = 0.5
    rids = [sched.submit(r) for r in reqs]
    out = sched.step()
    clk.advance(1.0)
    done = {c.rid: c for c in (out + sched.run())}

    rec = sched.outcomes[rids[1]]
    assert rec.state is RequestState.TIMED_OUT
    assert "deadline 0.5s" in rec.reason
    assert sched.counters["timed_out"] == 1
    for k in (0, 2, 3):
        np.testing.assert_array_equal(done[rids[k]].new_tokens, ref[rids_ref[k]].new_tokens)


def test_deadline_shed_in_queue_before_prefill():
    clk = StepClock()
    sched = Scheduler(_engine(0), n_slots=1, chunk=2, clock=clk, sleep=clk.sleep)
    reqs = _requests(3)
    reqs[2].ttft_deadline_s = 0.25
    rids = [sched.submit(r) for r in reqs]
    sched.step()
    clk.advance(1.0)
    done = {c.rid: c for c in sched.run()}
    rec = sched.outcomes[rids[2]]
    assert rec.state is RequestState.SHED
    assert "shed in queue" in rec.reason
    assert rec.admitted_at is None
    assert sched.counters["shed"] == 1
    assert rids[2] not in done and rids[0] in done and rids[1] in done


def test_latency_summary_reports_percentiles():
    clk = StepClock(dt=0.001)
    sched = Scheduler(_engine(0), n_slots=2, chunk=2, clock=clk, sleep=clk.sleep)
    for r in _requests(4, gen=6):
        sched.submit(r)
    sched.run()
    s = sched.summary()
    assert s["by_state"] == {"finished": 4}
    assert s["ttft_s"]["n"] == 4 and s["ttft_s"]["p50"] > 0
    assert s["tpot_s"]["n"] == 4 and s["tpot_s"]["p95"] >= s["tpot_s"]["p50"]
    assert s["counters"]["retries"] == 0


# ---------------------------------------------------------------------------
# fault injection: prefill / decode dispatch failures
# ---------------------------------------------------------------------------


def test_transient_prefill_fault_retries_and_recovers():
    eng = _engine(0)
    _, rids_ref, ref = _run(eng, _requests(3))
    plan = FaultPlan(fail_prefill={1: 2})
    sched = Scheduler(eng, n_slots=2, chunk=3, retries=2, faults=plan, sleep=lambda s: None)
    rids = [sched.submit(r) for r in _requests(3)]
    done = {c.rid: c for c in sched.run()}
    assert plan.fired_prefill == 2
    assert sched.counters["retries"] == 2
    for k in range(3):
        np.testing.assert_array_equal(done[rids[k]].new_tokens, ref[rids_ref[k]].new_tokens)


def test_permanent_prefill_fault_quarantines_one_request():
    eng = _engine(0)
    _, rids_ref, ref = _run(eng, _requests(4))
    plan = FaultPlan(fail_prefill={2: -1})
    sched = Scheduler(eng, n_slots=2, chunk=3, retries=1, faults=plan, sleep=lambda s: None)
    rids = [sched.submit(r) for r in _requests(4)]
    done = {c.rid: c for c in sched.run()}
    rec = sched.outcomes[rids[2]]
    assert rec.state is RequestState.FAILED
    assert "admission prefill" in rec.reason and "injected" in rec.reason
    assert rids[2] not in done
    for k in (0, 1, 3):
        np.testing.assert_array_equal(done[rids[k]].new_tokens, ref[rids_ref[k]].new_tokens)


def test_transient_decode_fault_is_invisible():
    eng = _engine(0)
    _, rids_ref, ref = _run(eng, _requests(4))
    plan = FaultPlan(fail_chunk={1: 1})
    sched = Scheduler(eng, n_slots=2, chunk=3, retries=2, faults=plan, sleep=lambda s: None)
    rids = [sched.submit(r) for r in _requests(4)]
    done = {c.rid: c for c in sched.run()}
    assert plan.fired_chunk == 1 and sched.counters["retries"] == 1
    for k in range(4):
        np.testing.assert_array_equal(done[rids[k]].new_tokens, ref[rids_ref[k]].new_tokens)


def test_decode_failure_midchunk_retry_is_exact(monkeypatch):
    """A decode chunk that raises after some of its steps already ran (not
    an injected fault before the dispatch, a failure inside it) leaves
    positions, budgets, logits and generators as they were, so the retried
    chunk emits what an undisturbed run emits."""
    eng = _engine(0)
    _, rids_ref, ref = _run(eng, _requests(4))
    real, calls = Engine.decode, [0]

    def flaky(self, tok, cache, pos):
        calls[0] += 1
        if calls[0] == 5:  # the second step of the second chunk
            raise RuntimeError("device fault mid-chunk")
        return real(self, tok, cache, pos)

    monkeypatch.setattr(Engine, "decode", flaky)
    sched = Scheduler(eng, n_slots=2, chunk=3, retries=1, sleep=lambda s: None)
    rids = [sched.submit(r) for r in _requests(4)]
    done = {c.rid: c for c in sched.run()}
    assert sched.counters["retries"] == 1
    for k in range(4):
        np.testing.assert_array_equal(done[rids[k]].new_tokens, ref[rids_ref[k]].new_tokens)


def test_permanent_decode_fault_fails_active_completes_queued():
    eng = _engine(0)
    _, rids_ref, ref = _run(eng, _requests(5))
    plan = FaultPlan(fail_chunk={1: -1})
    sched = Scheduler(eng, n_slots=2, chunk=3, retries=1, faults=plan, sleep=lambda s: None)
    rids = [sched.submit(r) for r in _requests(5)]
    done = {c.rid: c for c in sched.run()}
    failed = [r for r in rids if sched.outcomes[r].state is RequestState.FAILED]
    assert len(failed) == 2
    assert sched.counters["decode_dispatch_failures"] == 1
    survivors = [r for r in rids if r not in failed]
    assert sorted(done) == sorted(survivors)
    for rid, rid_ref in zip(rids, rids_ref):
        if rid in done:
            np.testing.assert_array_equal(done[rid].new_tokens, ref[rid_ref].new_tokens)


# ---------------------------------------------------------------------------
# NaN/inf logit guard
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("q", [0, 3], ids=["dense", "bcq_q3"])
def test_nan_row_quarantined_neighbours_untouched(q):
    eng = _engine(q)
    _, rids_ref, ref = _run(eng, _requests(4))
    plan = FaultPlan(nan_row={1: 4})
    sched = Scheduler(eng, n_slots=2, chunk=3, faults=plan)
    rids = [sched.submit(r) for r in _requests(4)]
    done = {c.rid: c for c in sched.run()}
    rec = sched.outcomes[rids[1]]
    assert rec.state is RequestState.FAILED
    assert "non-finite logits" in rec.reason
    assert plan.fired_nan == 1
    assert sched.counters["nan_quarantined"] == 1
    np.testing.assert_array_equal(rec.new_tokens, ref[rids_ref[1]].new_tokens[: rec.n_tokens])
    assert rids[1] not in done
    for k in (0, 2, 3):
        np.testing.assert_array_equal(done[rids[k]].new_tokens, ref[rids_ref[k]].new_tokens)


def test_nan_guard_off_is_an_opt_out():
    plan = FaultPlan(nan_row={0: 2})
    sched = Scheduler(_engine(0), n_slots=1, chunk=2, faults=plan, nan_guard=False)
    rid = sched.submit(_requests(1, gen=6)[0])
    sched.run()
    assert sched.outcomes[rid].state is RequestState.FINISHED
    assert sched.counters["nan_quarantined"] == 0


# ---------------------------------------------------------------------------
# stop tokens
# ---------------------------------------------------------------------------


def test_stop_token_truncation_identical_to_solo():
    eng = _engine(0)
    (base,) = _requests(1, gen=10)
    solo_full = eng.generate(base.prompt[None], 10)
    stop_tok = int(solo_full.tokens[0, base.prompt.size + 4])

    solo_stop = eng.generate(base.prompt[None], 10, stop_tokens=(stop_tok,))
    assert solo_stop.stop_positions is not None
    truncated = solo_stop.generated(0)
    assert truncated[-1] == stop_tok and truncated.size <= 10

    sched = Scheduler(eng, n_slots=2, chunk=3)
    rid = sched.submit(Request(prompt=base.prompt, max_new_tokens=10, stop_tokens=(stop_tok,)))
    done = {c.rid: c for c in sched.run()}
    np.testing.assert_array_equal(done[rid].new_tokens, truncated)
    assert done[rid].stopped
    assert sched.counters["stopped_early"] == 1
    assert sched.outcomes[rid].reason == "stop token"


def test_stop_token_frees_slot_early_for_queued_request():
    eng = _engine(0)
    (probe,) = _requests(1, gen=12)
    solo = eng.generate(probe.prompt[None], 12)
    stop_tok = int(solo.tokens[0, probe.prompt.size + 1])

    sched = Scheduler(eng, n_slots=1, chunk=3)
    a = sched.submit(Request(prompt=probe.prompt, max_new_tokens=12, stop_tokens=(stop_tok,)))
    tail = _requests(1, seed0=30, gen=4)[0]
    b = sched.submit(tail)
    done = {c.rid: c for c in sched.run()}
    assert done[a].stopped and done[a].new_tokens.size <= 3
    assert done[b].admitted_at_step <= 3
    solo_tail = eng.generate(tail.prompt[None], 4, temperature=tail.temperature, seed=tail.seed)
    np.testing.assert_array_equal(done[b].new_tokens, solo_tail.tokens[0, tail.prompt.size :])


def test_stop_token_never_emitted_runs_full_budget():
    eng = _engine(0)
    (base,) = _requests(1, gen=6)
    new = eng.generate(base.prompt[None], 6).tokens[0, base.prompt.size :]
    unused = int(next(t for t in range(_cfg().vocab) if t not in set(int(x) for x in new)))
    sched = Scheduler(eng, n_slots=1, chunk=2)
    rid = sched.submit(Request(prompt=base.prompt, max_new_tokens=6, stop_tokens=(unused,)))
    done = {c.rid: c for c in sched.run()}
    assert not done[rid].stopped
    np.testing.assert_array_equal(done[rid].new_tokens, new)


# ---------------------------------------------------------------------------
# streaming callbacks
# ---------------------------------------------------------------------------


def test_on_tokens_streams_exactly_the_completion():
    seen: dict = {}
    sched = Scheduler(
        _engine(0), n_slots=2, chunk=3,
        on_tokens=lambda rid, toks: seen.setdefault(rid, []).extend(toks),
    )
    rids = [sched.submit(r) for r in _requests(3)]
    done = {c.rid: c for c in sched.run()}
    for rid in rids:
        np.testing.assert_array_equal(np.asarray(seen[rid]), done[rid].new_tokens)


def test_on_event_fires_once_per_terminal_state():
    events = []
    sched = Scheduler(_engine(0), n_slots=1, chunk=2, on_event=lambda rec: events.append(rec))
    rids = [sched.submit(r) for r in _requests(2, gen=4)]
    sched.cancel(rids[1])
    sched.run()
    assert sorted(e.rid for e in events) == sorted(rids)
    states = {e.rid: e.state for e in events}
    assert states[rids[0]] is RequestState.FINISHED
    assert states[rids[1]] is RequestState.CANCELLED


# ---------------------------------------------------------------------------
# survivor invariance: one mid-flight cancel + one NaN row + one deadline
# ---------------------------------------------------------------------------


def _matrix_requests():
    reqs = _requests(5)
    reqs[0].max_new_tokens = 12
    reqs[2].max_new_tokens = 12
    return reqs


@pytest.mark.parametrize("q", [0, 4], ids=["dense", "bcq_q4"])
def test_survivor_invariance_plain(q):
    engine = _engine(q)
    _, rids_ref, ref = _run(engine, _matrix_requests(), chunk=2)

    clk = StepClock()
    plan = FaultPlan(nan_row={2: 1})
    sched = Scheduler(engine, n_slots=2, chunk=2, faults=plan, clock=clk, sleep=clk.sleep)
    reqs = _matrix_requests()
    reqs[3].deadline_s = 0.5
    rids = [sched.submit(r) for r in reqs]
    out = sched.step()
    sched.cancel(rids[0])
    clk.advance(1.0)
    done = {c.rid: c for c in (out + sched.run())}

    states = {i: sched.outcomes[rids[i]].state for i in range(5)}
    assert states[0] is RequestState.CANCELLED
    assert states[2] is RequestState.FAILED
    assert states[3] in (RequestState.TIMED_OUT, RequestState.SHED)
    survivors = [i for i in range(5) if states[i] is RequestState.FINISHED]
    assert survivors
    for i in survivors:
        np.testing.assert_array_equal(
            done[rids[i]].new_tokens, ref[rids_ref[i]].new_tokens,
            err_msg=f"survivor {i} diverged in the disturbed run",
        )
    for i in (0, 2):
        part = sched.outcomes[rids[i]].new_tokens
        np.testing.assert_array_equal(part, ref[rids_ref[i]].new_tokens[: part.size])
