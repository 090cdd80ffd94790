"""The port's async streaming front end (``repro_torch/launch/server.py``),
the mirror of ``tests/test_server.py``.

The ServeSession core is exercised directly with asyncio (no sockets):
submit / stream / drain, mid-flight cancellation, loud queue-full
rejection, invalid-request rejection, the bounded-buffer slow-client
policy. End-to-end WebSocket and SSE tests over an ephemeral port cover the
aiohttp transport. Every async case runs under its own ``asyncio.wait_for``
timeout.

Added: the port's session streams equal the JAX package's ``ServeSession``
greedy streams on the same weights; an instrumented session equals an
uninstrumented one bit for bit; every engine call runs on the pump thread;
without aiohttp the session core still serves and ``make_app`` / ``main``
raise naming it; the CLI serves on the CPU from a subprocess.
"""

import asyncio
import functools
import json
import os
import subprocess
import sys
import threading
from pathlib import Path

import jax
import numpy as np
import pytest

from repro.configs import get_config as jget_config
from repro.infer import Engine as JEngine
from repro.infer import Request as JRequest
from repro.launch.server import ServeSession as JServeSession
from repro.models import init_params as jinit_params
from repro.models import reduced as jreduced
from repro_torch.configs import get_config
from repro_torch.data import MarkovCorpus
from repro_torch.infer import Engine, FaultPlan, PrefixCache, Request
from repro_torch.launch import server
from repro_torch.launch.server import ServeSession, StreamEvent, request_from_json
from repro_torch.models import params_from_numpy, reduced
from repro_torch.obs import Tracer
from torch_helpers import jax_tree_to_numpy

ROOT = Path(__file__).resolve().parents[1]
MAX_SEQ = 64
SIZES = dict(d_model=128, n_kv_heads=4, d_ff=256)  # the reference test's _cfg


def _cfg():
    return reduced(get_config("llama3.2-3b"), **SIZES)


@functools.lru_cache(maxsize=None)
def _jax_params():
    """(JAX config, JAX params, the port's params): the same f32 weights."""
    jcfg = jreduced(jget_config("llama3.2-3b"), **SIZES)
    jp = jinit_params(jax.random.PRNGKey(0), jcfg)
    return jcfg, jp, params_from_numpy(jax_tree_to_numpy(jp), device="cpu")


@functools.lru_cache(maxsize=None)
def _engine() -> Engine:
    return Engine(_cfg(), _jax_params()[2], max_seq=MAX_SEQ, device="cpu")


def _prompt(i: int = 0, plen: int = 5) -> np.ndarray:
    corpus = MarkovCorpus(_cfg().vocab, seed=3)
    return corpus.sample(1, plen, seed=200 + i)[0, :plen].astype(np.int32)


def _go(coro, timeout=120.0):
    return asyncio.run(asyncio.wait_for(coro, timeout))


async def _await_true(predicate, *, timeout=30.0, every=0.005):
    waited = 0.0
    while not predicate():
        await asyncio.sleep(every)
        waited += every
        if waited > timeout:
            raise AssertionError("condition not reached in time")


# ---------------------------------------------------------------------------
# session core (no sockets)
# ---------------------------------------------------------------------------


def test_session_streams_match_solo_generate():
    eng = _engine()
    p0, p1 = _prompt(0), _prompt(1, plen=6)
    solo0 = eng.generate(p0[None], 8)
    solo1 = eng.generate(p1[None], 8, temperature=0.8, seed=7)

    async def run():
        async with ServeSession(eng, n_slots=2, chunk=3) as sess:
            s0 = await sess.submit_stream(Request(prompt=p0, max_new_tokens=8))
            s1 = await sess.submit_stream(Request(prompt=p1, max_new_tokens=8, temperature=0.8, seed=7))
            (t0, last0), (t1, last1) = await asyncio.gather(s0.drain(), s1.drain())
            m = sess.metrics()
        return t0, last0, t1, last1, m

    t0, last0, t1, last1, m = _go(run())
    assert last0.kind == "done" and last0.status == "finished"
    assert last1.kind == "done" and last1.n_tokens == 8
    np.testing.assert_array_equal(np.asarray(t0), solo0.tokens[0, p0.size:])
    np.testing.assert_array_equal(np.asarray(t1), solo1.tokens[0, p1.size:])
    assert m["by_state"] == {"finished": 2}
    assert m["ttft_s"]["n"] == 2
    assert m["server"] == {"overflow_cancelled": 0, "rejected": 0}


def test_session_cancel_midflight_survivor_exact():
    eng = _engine()
    p0, p1 = _prompt(2), _prompt(3)
    solo1 = eng.generate(p1[None], 10)

    async def run():
        async with ServeSession(eng, n_slots=2, chunk=2) as sess:
            victim = await sess.submit_stream(Request(prompt=p0, max_new_tokens=24))
            survivor = await sess.submit_stream(Request(prompt=p1, max_new_tokens=10))
            first = None
            async for ev in victim:
                if ev.kind == "tokens":
                    first = ev
                    break
            victim.cancel("user hit stop")
            _, vlast = await victim.drain()
            stoks, slast = await survivor.drain()
            m = sess.metrics()
        return first, vlast, stoks, slast, m

    first, vlast, stoks, slast, m = _go(run())
    assert first is not None and len(first.tokens) > 0
    assert vlast.kind == "error" and vlast.status == "cancelled"
    assert vlast.reason == "user hit stop"
    assert slast.kind == "done"
    np.testing.assert_array_equal(np.asarray(stoks), solo1.tokens[0, p1.size:])
    assert m["by_state"]["cancelled"] == 1
    assert m["counters"]["cancelled"] == 1


def test_session_queue_full_surfaces_as_rejected_event():
    eng = _engine()

    async def run():
        async with ServeSession(eng, n_slots=1, chunk=2, max_queue=1) as sess:
            streams = [await sess.submit_stream(Request(prompt=_prompt(i), max_new_tokens=6)) for i in range(6)]
            results = await asyncio.gather(*(s.drain() for s in streams))
            m = sess.metrics()
        return results, m

    results, m = _go(run())
    kinds = [last.kind for _, last in results]
    assert kinds.count("rejected") >= 1, kinds
    assert kinds.count("done") >= 1
    rej = next(last for _, last in results if last.kind == "rejected")
    assert "admission queue full" in rej.reason
    assert m["server"]["rejected"] == kinds.count("rejected")
    assert m["counters"]["rejected_queue_full"] == kinds.count("rejected")


def test_session_invalid_request_rejected_not_fatal():
    eng = _engine()

    async def run():
        async with ServeSession(eng, n_slots=1, chunk=2) as sess:
            too_long = await sess.submit_stream(Request(prompt=_prompt(0), max_new_tokens=MAX_SEQ * 2))
            _, bad = await too_long.drain()
            ok = await sess.submit_stream(Request(prompt=_prompt(1), max_new_tokens=4))
            toks, last = await ok.drain()
        return bad, toks, last

    bad, toks, last = _go(run())
    assert bad.kind == "rejected" and "max_seq" in bad.reason
    assert last.kind == "done" and len(toks) == 4


def test_session_slow_client_bound_counts_events_in_flight(monkeypatch):
    """An event loop that lags the pump thread (a loaded host): events the
    pump posted and the loop has not queued yet count against the buffer,
    so the request is cancelled with at most ``max_buffer`` token events
    delivered, as with a prompt loop."""
    import time

    real = ServeSession._deliver

    def lagging(self, rid, q, ev):
        time.sleep(0.02)  # the loop is busy; the pump keeps posting
        real(self, rid, q, ev)

    monkeypatch.setattr(ServeSession, "_deliver", lagging)
    eng = _engine()

    async def run():
        async with ServeSession(eng, n_slots=1, chunk=1, max_buffer=2) as sess:
            stream = await sess.submit_stream(Request(prompt=_prompt(4), max_new_tokens=40))
            await _await_true(lambda: sess.counters["overflow_cancelled"] >= 1)
            toks, last = await stream.drain()
        return toks, last

    toks, last = _go(run())
    assert last.kind == "error" and last.status == "cancelled"
    assert len(toks) <= 2


def test_session_slow_client_overflow_cancelled():
    eng = _engine()

    async def run():
        async with ServeSession(eng, n_slots=1, chunk=1, max_buffer=2) as sess:
            stream = await sess.submit_stream(Request(prompt=_prompt(4), max_new_tokens=40))
            # never read: the 2-event buffer overflows and the session
            # cancels the request instead of buffering 40 events
            await _await_true(lambda: sess.counters["overflow_cancelled"] >= 1)
            toks, last = await stream.drain()
            m = sess.metrics()
        return toks, last, m

    toks, last, m = _go(run())
    assert last.kind == "error" and last.status == "cancelled"
    assert "slow client" in last.reason and "overflowed" in last.reason
    assert len(toks) <= 2
    assert m["by_state"].get("cancelled") == 1


def test_session_stop_cancels_inflight_with_terminal_events():
    eng = _engine()

    async def run():
        sess = ServeSession(eng, n_slots=1, chunk=2)
        async with sess:
            stream = await sess.submit_stream(Request(prompt=_prompt(5), max_new_tokens=48))
            async for ev in stream:
                if ev.kind == "tokens":
                    break
        _, last = await stream.drain()
        return last

    last = _go(run())
    assert last.terminal and last.status == "cancelled"
    assert "shutting down" in last.reason


def test_session_client_stall_fault_still_correct():
    eng = _engine()
    p = _prompt(6)
    solo = eng.generate(p[None], 6)

    async def run():
        plan = FaultPlan(client_stall={0: 0.01})
        async with ServeSession(eng, n_slots=1, chunk=2, faults=plan) as sess:
            stream = await sess.submit_stream(Request(prompt=p, max_new_tokens=6, rid=0))
            return await stream.drain()

    toks, last = _go(run())
    assert last.kind == "done"
    np.testing.assert_array_equal(np.asarray(toks), solo.tokens[0, p.size:])


def test_request_from_json_roundtrip():
    req = request_from_json({"prompt": [1, 2, 3], "max_new_tokens": 5, "temperature": 0.5, "seed": 9,
                             "stop_tokens": [2], "deadline_s": 30.0})
    assert req.max_new_tokens == 5 and req.temperature == 0.5
    assert req.stop_tokens == (2,) and req.deadline_s == 30.0
    with pytest.raises(KeyError):
        request_from_json({"max_new_tokens": 5})
    with pytest.raises(ValueError, match="integer token ids"):
        request_from_json({"prompt": [0.5]})


def test_stream_event_json_shapes():
    done = StreamEvent(kind="done", rid=3, status="finished", n_tokens=7)
    assert done.terminal
    assert done.to_json() == {"type": "done", "rid": 3, "status": "finished", "n_tokens": 7}
    toks = StreamEvent(kind="tokens", rid=3, tokens=[1, 2])
    assert not toks.terminal
    assert toks.to_json() == {"type": "tokens", "rid": 3, "tokens": [1, 2]}


def test_session_streams_match_jax_session():
    """The port's ServeSession and the JAX package's, on the same f32
    weights, the same greedy requests: the same streamed tokens."""
    jcfg, jp, _ = _jax_params()
    jeng = JEngine(jcfg, jp, max_seq=MAX_SEQ)
    prompts = [_prompt(i, plen=4 + i) for i in range(3)]

    async def run(session_cls, eng, req_cls):
        async with session_cls(eng, n_slots=2, chunk=3) as sess:
            streams = [await sess.submit_stream(req_cls(prompt=p, max_new_tokens=8)) for p in prompts]
            return await asyncio.gather(*(s.drain() for s in streams))

    theirs = _go(run(JServeSession, jeng, JRequest), timeout=180.0)
    ours = _go(run(ServeSession, _engine(), Request))
    for i, ((jt, jlast), (tt, tlast)) in enumerate(zip(theirs, ours)):
        assert jlast.kind == tlast.kind == "done"
        assert [int(t) for t in jt] == tt, f"request {i}"


def test_instrumented_session_equals_uninstrumented():
    """``observe=True`` (tracer and registry, engine spans too) against
    ``observe=False``: the same streams, sampled requests included."""
    tracer = Tracer()
    eng_traced = Engine(_cfg(), _jax_params()[2], max_seq=MAX_SEQ, device="cpu", tracer=tracer)
    reqs = [(_prompt(i, plen=4 + i % 3), [0.0, 1.0, 0.7][i % 3], 10 + i) for i in range(5)]

    async def run(observe):
        sess = (ServeSession(eng_traced, n_slots=2, chunk=3, tracer=tracer) if observe
                else ServeSession(_engine(), n_slots=2, chunk=3, observe=False))
        async with sess:
            streams = [await sess.submit_stream(Request(prompt=p, max_new_tokens=7, temperature=t, seed=s))
                       for p, t, s in reqs]
            out = await asyncio.gather(*(st.drain() for st in streams))
        return out, sess

    plain, dark = _go(run(False))
    traced, sess = _go(run(True))
    assert [toks for toks, _ in plain] == [toks for toks, _ in traced]
    assert dark.tracer is None and sess.tracer.stats()["recorded"] > 0
    lanes = {e[3] for e in sess.tracer.events()}
    assert {"engine", "scheduler", "pump"} <= lanes


def test_every_engine_call_runs_on_the_pump_thread(monkeypatch):
    """One thread owns the device: every engine scope (prefill, admission,
    decode chunk) runs on the session's pump thread, none on the event
    loop's thread."""
    threads = []
    real = Engine._obs_scope

    def scope(self, name, **args):
        threads.append((name, threading.current_thread().name))
        return real(self, name, **args)

    monkeypatch.setattr(Engine, "_obs_scope", scope)

    async def run():
        async with ServeSession(_engine(), n_slots=2, chunk=2) as sess:
            streams = [await sess.submit_stream(Request(prompt=_prompt(i), max_new_tokens=5)) for i in range(3)]
            await asyncio.gather(*(s.drain() for s in streams))
        return threading.current_thread().name

    loop_thread = _go(run())
    assert {"engine/prefill", "engine/admit", "engine/scan_decode"} <= {n for n, _ in threads}
    assert {t for _, t in threads} == {"repro-serve-pump"} != {loop_thread}


def test_call_on_pump_runs_there_and_profiles_the_engine_scopes():
    """``call_on_pump`` runs a function on the pump thread (its exception
    reaches the caller); a ``torch.profiler`` started and stopped there
    records the engine's ``record_function`` scopes of the requests served
    in between, which a profiler on the event loop's thread would miss."""
    import torch

    tracer = Tracer()
    eng = Engine(_cfg(), _jax_params()[2], max_seq=MAX_SEQ, device="cpu", tracer=tracer)
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        pass  # the profiler initialises on this thread, before it starts on the pump
    prof = torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU])

    async def run():
        async with ServeSession(eng, n_slots=2, chunk=3, tracer=tracer) as sess:
            name = await sess.call_on_pump(lambda: threading.current_thread().name)
            with pytest.raises(ZeroDivisionError):
                await sess.call_on_pump(lambda: 1 / 0)
            await sess.call_on_pump(prof.start)
            mark = len(tracer.events())
            streams = [await sess.submit_stream(Request(prompt=_prompt(i), max_new_tokens=4)) for i in range(3)]
            await asyncio.gather(*(st.drain() for st in streams))
            await sess.call_on_pump(prof.stop)
        return name, {e[1] for e in tracer.events()[mark:] if e[3] == "engine"}

    name, entered = _go(run())
    assert name == "repro-serve-pump"
    assert {"engine/prefill", "engine/admit", "engine/scan_decode"} <= entered
    recorded = {e.key for e in prof.key_averages()}
    assert entered <= recorded, entered - recorded


def test_pump_selects_the_card_of_the_slot_state(monkeypatch):
    """The pump thread's first act on a CUDA engine is
    ``torch.cuda.set_device`` with the index of the card its slot state
    lives on (``set_device`` refuses a device without an index), on the
    pump thread itself: the setting is per thread."""
    import torch

    calls = []
    monkeypatch.setattr(server.torch.cuda, "set_device",
                        lambda dev: calls.append((dev, threading.current_thread().name)))

    async def run():
        sess = ServeSession(_engine(), n_slots=1, chunk=2, observe=False)
        sess._device = torch.device("cuda", 1)  # as if the slot state were on card 1
        async with sess:
            return await (await sess.submit_stream(Request(prompt=_prompt(0), max_new_tokens=2))).drain()

    _, last = _go(run())
    assert last.kind == "done"
    assert calls == [(torch.device("cuda", 1), "repro-serve-pump")]


def test_pump_death_ends_every_stream_and_stop_raises(monkeypatch):
    """A pump thread that dies (here: its scheduler step raises) sends every
    open stream a terminal ``failed`` event naming the error, refuses new
    submits, and ``stop`` raises it: no client waits forever."""
    async def run():
        sess = ServeSession(_engine(), n_slots=1, chunk=2, observe=False)

        def broken():
            raise MemoryError("device lost")

        monkeypatch.setattr(sess.sched, "step", broken)
        await sess.start()
        stream = await sess.submit_stream(Request(prompt=_prompt(0), max_new_tokens=4))
        toks, last = await stream.drain()
        with pytest.raises(RuntimeError, match="pump thread died"):
            await sess.submit_stream(Request(prompt=_prompt(1), max_new_tokens=4))
        with pytest.raises(RuntimeError, match="pump thread died") as e:
            await sess.stop()
        return toks, last, e.value.__cause__

    toks, last, cause = _go(run())
    assert toks == [] and last.kind == "error" and last.status == "failed"
    assert "device lost" in last.reason and isinstance(cause, MemoryError)


def test_session_core_serves_without_aiohttp(monkeypatch):
    """aiohttp is optional: without it the session core still serves, and
    the transport (``make_app``, ``run_server``, ``main``) raises naming
    aiohttp."""
    monkeypatch.setattr(server, "web", None)
    eng = _engine()
    with pytest.raises(RuntimeError, match="aiohttp"):
        server.make_app(ServeSession(eng, observe=False))
    with pytest.raises(RuntimeError, match="aiohttp"):
        _go(server.run_server(ServeSession(eng, observe=False), port=0))
    with pytest.raises(RuntimeError, match="aiohttp"):
        server.main(["--device", "cpu", "--port", "0"])

    async def run():
        async with ServeSession(eng, n_slots=1, chunk=2) as sess:
            return await (await sess.submit_stream(Request(prompt=_prompt(0), max_new_tokens=3))).drain()

    toks, last = _go(run())
    assert last.kind == "done" and len(toks) == 3


# ---------------------------------------------------------------------------
# aiohttp websocket transport (end-to-end over a real socket)
# ---------------------------------------------------------------------------


def test_websocket_end_to_end_stream_cancel_disconnect_metrics():
    aiohttp = pytest.importorskip("aiohttp")
    from repro_torch.launch.server import bound_port, run_server

    eng = _engine()
    p = _prompt(7)
    expect = [int(t) for t in eng.generate(p[None], 8).tokens[0, p.size:]]

    async def run():
        session = ServeSession(eng, n_slots=2, chunk=3)
        async with session:
            runner = await run_server(session, port=0)
            base = f"http://127.0.0.1:{bound_port(runner)}"
            try:
                async with aiohttp.ClientSession() as client:
                    async with client.get(f"{base}/healthz") as r:
                        assert (await r.json()) == {"ok": True}

                    async with client.ws_connect(f"{base}/v1/stream") as ws:
                        await ws.send_json({"prompt": [int(t) for t in p], "max_new_tokens": 8})
                        got, done_frame = [], None
                        while True:
                            frame = await ws.receive_json()
                            if frame["type"] == "accepted":
                                continue
                            if frame["type"] == "tokens":
                                got.extend(frame["tokens"])
                                continue
                            done_frame = frame
                            break
                    assert done_frame["type"] == "done" and done_frame["status"] == "finished"
                    assert got == expect

                    async with client.ws_connect(f"{base}/v1/stream") as ws:
                        await ws.send_json({"prompt": [int(t) for t in p], "max_new_tokens": 48})
                        while (await ws.receive_json())["type"] != "tokens":
                            pass
                        await ws.send_json({"type": "cancel"})
                        while True:
                            frame = await ws.receive_json()
                            if frame["type"] in ("error", "done"):
                                break
                    assert frame["type"] == "error" and frame["status"] == "cancelled"
                    assert "cancel frame" in frame["reason"]

                    ws = await client.ws_connect(f"{base}/v1/stream")
                    await ws.send_json({"prompt": [int(t) for t in p], "max_new_tokens": 48})
                    while (await ws.receive_json())["type"] != "tokens":
                        pass
                    await ws.close()
                    await _await_true(lambda: session.sched.counters["cancelled"] >= 2)

                    async with client.ws_connect(f"{base}/v1/stream") as ws:
                        await ws.send_json({"max_new_tokens": 4})
                        frame = await ws.receive_json()
                    assert frame["type"] == "rejected" and "bad request" in frame["reason"]

                    async with client.get(f"{base}/v1/metrics") as r:
                        m = await r.json()
            finally:
                await runner.cleanup()
        return m

    m = _go(run(), timeout=180.0)
    assert m["by_state"]["finished"] == 1
    assert m["by_state"]["cancelled"] == 2
    assert m["ttft_s"]["n"] == 1
    assert m["counters"]["cancelled"] == 2


# ---------------------------------------------------------------------------
# HTTP SSE transport (same session core and frame schema as the WS endpoint)
# ---------------------------------------------------------------------------


async def _sse_frames(resp):
    frames = []
    async for line in resp.content:
        line = line.decode("utf-8").strip()
        if line.startswith("data: "):
            frames.append(json.loads(line[len("data: "):]))
    return frames


def test_sse_generate_end_to_end():
    aiohttp = pytest.importorskip("aiohttp")
    from repro_torch.launch.server import bound_port, run_server

    eng = _engine()
    p = _prompt(8)
    expect = [int(t) for t in eng.generate(p[None], 8).tokens[0, p.size:]]

    async def run():
        session = ServeSession(eng, n_slots=2, chunk=3)
        async with session:
            runner = await run_server(session, port=0)
            base = f"http://127.0.0.1:{bound_port(runner)}"
            try:
                async with aiohttp.ClientSession() as client:
                    async with client.post(f"{base}/v1/generate",
                                           json={"prompt": [int(t) for t in p], "max_new_tokens": 8}) as r:
                        assert r.status == 200
                        assert r.headers["Content-Type"].startswith("text/event-stream")
                        frames = await _sse_frames(r)
                    async with client.post(f"{base}/v1/generate", json={"max_new_tokens": 4}) as r:
                        bad_status, bad = r.status, await r.json()
            finally:
                await runner.cleanup()
        return frames, bad_status, bad

    frames, bad_status, bad = _go(run(), timeout=180.0)
    assert frames[0]["type"] == "accepted"
    assert [t for f in frames if f["type"] == "tokens" for t in f["tokens"]] == expect
    assert frames[-1]["type"] == "done"
    assert frames[-1]["status"] == "finished" and frames[-1]["n_tokens"] == 8
    assert bad_status == 400 and bad["type"] == "rejected" and "bad request" in bad["reason"]


def test_sse_disconnect_cancels_request():
    aiohttp = pytest.importorskip("aiohttp")
    from repro_torch.launch.server import bound_port, run_server

    eng = _engine()
    p = _prompt(9)

    async def run():
        session = ServeSession(eng, n_slots=1, chunk=1)
        async with session:
            runner = await run_server(session, port=0)
            base = f"http://127.0.0.1:{bound_port(runner)}"
            try:
                async with aiohttp.ClientSession() as client:
                    resp = await client.post(f"{base}/v1/generate",
                                             json={"prompt": [int(t) for t in p], "max_new_tokens": 48})
                    async for line in resp.content:
                        if b'"tokens"' in line:
                            break
                    resp.close()
                    await _await_true(lambda: session.sched.counters["cancelled"] >= 1)
                    m = session.metrics()
            finally:
                await runner.cleanup()
        return m

    m = _go(run(), timeout=180.0)
    assert m["by_state"].get("cancelled") == 1


def test_session_prefix_cache_chunked_prefill_identity():
    """prefill_chunk reaches the scheduler and the engine's prefix cache
    serves a warm repeat with the cold tokens, bit for bit, through the
    async front end."""
    eng = Engine(_cfg(), _jax_params()[2], max_seq=MAX_SEQ, device="cpu", prefix_cache=PrefixCache(block_tokens=4))
    p = _prompt(10, plen=12)
    expect = [int(t) for t in _engine().generate(p[None], 8).tokens[0, p.size:]]

    async def run():
        async with ServeSession(eng, n_slots=2, chunk=3, prefill_chunk=4) as sess:
            t_cold, last_cold = await (await sess.submit_stream(Request(prompt=p, max_new_tokens=8))).drain()
            t_warm, last_warm = await (await sess.submit_stream(Request(prompt=p, max_new_tokens=8))).drain()
        return t_cold, last_cold, t_warm, last_warm

    t_cold, last_cold, t_warm, last_warm = _go(run())
    assert last_cold.kind == "done" and last_warm.kind == "done"
    assert list(t_cold) == expect and list(t_warm) == expect
    st = eng.prefix_cache.stats()
    assert st["hits"] >= 1 and st["pinned"] == 0
    assert st["hits"] + st["misses"] == st["commits"] + st["aborts"]


def test_server_cli_serves_on_the_cpu():
    """``python -m repro_torch.launch.server --device cpu --port 0``: the
    banner names the bound port; health, SSE, the Prometheus scrape (with
    the launch census) and the trace answer; the process stops on SIGTERM."""
    aiohttp = pytest.importorskip("aiohttp")
    proc = subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.server", "--device", "cpu", "--port", "0", "--slots", "2"],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        env=dict(os.environ, PYTHONPATH=str(ROOT / "src")),
    )
    try:
        banner = proc.stdout.readline()
        assert "/v1/stream" in banner, (banner, proc.stderr.read() if proc.poll() is not None else "")
        base = "http://" + banner.split("ws://")[1].split("/v1/stream")[0]

        async def run():
            async with aiohttp.ClientSession() as client:
                async with client.get(f"{base}/healthz") as r:
                    health = await r.json()
                async with client.post(f"{base}/v1/generate", json={"prompt": [5, 9, 12], "max_new_tokens": 4}) as r:
                    frames = await _sse_frames(r)
                async with client.get(f"{base}/v1/metrics", params={"format": "prometheus"}) as r:
                    text = await r.text()
                async with client.get(f"{base}/v1/trace") as r:
                    trace = await r.json()
            return health, frames, text, trace

        health, frames, text, trace = _go(run(), timeout=60.0)
        assert health == {"ok": True}
        assert frames[-1]["type"] == "done" and frames[-1]["n_tokens"] == 4
        assert "kernel_launches_total{kernel=\"bcq_mm\"} 0" in text and "serve_finished_total 1" in text
        assert trace["traceEvents"]
    finally:
        proc.terminate()
        proc.wait(timeout=30)
