"""Async streaming serve front end (counterpart of ``repro/launch/server.py``).

``launch/serve.py`` is a synchronous driver; production traffic is concurrent
clients, streamed tokens, and tail-latency SLOs. This module serves the
continuous-batching scheduler to real clients:

- :class:`ServeSession` — the transport-agnostic core. One dedicated **pump
  thread** owns the :class:`~repro_torch.infer.Scheduler` (an engine step
  blocks on the device, so it must stay off the event loop); the asyncio
  side talks to it through a thread-safe inbox (submits/cancels) and
  per-request ``asyncio.Queue`` streams fed via
  ``loop.call_soon_threadsafe``. Tokens stream per-slot as chunks complete;
  terminal lifecycle events (finished / cancelled / timed-out / failed /
  shed) close the stream with a per-request status.
- an **aiohttp app** (:func:`make_app`) on top with two stream transports
  over the *same* session core and frame schema: a WebSocket endpoint
  (``/v1/stream``) and an HTTP SSE endpoint (``POST /v1/generate``, one
  ``data:`` line per frame — curl-able, no WS client needed). Both honour
  client disconnect as cancellation at the next chunk boundary and apply
  admission control under burst load (a full queue rejects loudly instead
  of buffering without bound). A ``/v1/metrics`` endpoint reports
  per-request TTFT/TPOT p50/p95/p99 as JSON (``?format=prometheus`` for the
  text exposition over the session's metrics registry + the process-global
  registry, which carries the kernels' launch census as
  ``kernel_launches_total{kernel=…}``), and a ``/v1/trace`` endpoint exports
  the session tracer's recent window as Chrome/Perfetto trace-event JSON.
  aiohttp is optional — the session core works without it (and is what the
  differential tests drive); ``make_app`` and ``main`` raise an error naming
  it when it is missing.

**The card belongs to the pump thread.** Every forward, graph capture and
replay runs there; the pump first selects the engine's device
(``torch.cuda.set_device``, a per-thread setting). The event loop never
touches CUDA: tokens reach it as Python ints, and what it reads
(summaries, the registry, the tracer, the launch census) is host state.
This matters beyond speed: a decode graph is captured in
``capture_error_mode="global"``, where a ``cudaMalloc`` or a sync made by
another thread during the capture invalidates it, and ``ops.impl_mode`` /
``utils.prompt_rows`` are process-global settings that only the thread
running the forward may set. The constructor allocates the slot state on
the calling thread, before the pump exists, so run one session per card
at a time. Work that must run on the card's thread goes through
:meth:`ServeSession.call_on_pump`, which runs a function there between two
scheduler steps: starting and stopping ``torch.profiler``, for one, since
PyTorch's profiler records the CPU ranges of the thread that starts it and
the engine's ``record_function`` scopes live on the pump.

Slow clients: each stream buffer is bounded (``max_buffer`` events). A client
that stops reading while the scheduler keeps emitting overflows its buffer
and is **cancelled with a reason** — one stalled consumer must not grow host
memory or, worse, backpressure the whole decode batch. (Deterministic stalls
are injectable via ``FaultPlan.client_stall`` for exactly this test.)

Run it::

    PYTHONPATH=src python -m repro_torch.launch.server --arch llama3.2-3b \
        --q 4 --g 128 --slots 4 --port 8777          # --device cpu: on the CPU

WebSocket protocol (``/v1/stream``, JSON frames)::

    -> {"prompt": [...], "max_new_tokens": 16, "temperature": 0.7,
        "seed": 1, "stop_tokens": [2], "deadline_s": 30.0}
    <- {"type": "accepted", "rid": 0}
    <- {"type": "tokens", "rid": 0, "tokens": [5, 17, ...]}   (per chunk)
    <- {"type": "done", "rid": 0, "status": "finished", "n_tokens": 16}
    or {"type": "error", "rid": 0, "status": "timed_out", "reason": "..."}
    or {"type": "rejected", "reason": "admission queue full (...)"}
    -> {"type": "cancel"}        (or just close the socket)

SSE protocol (``POST /v1/generate``, same JSON frames, one per ``data:``
line; closing the connection cancels the request)::

    curl -N -X POST http://HOST:PORT/v1/generate \
        -d '{"prompt": [1, 2, 3], "max_new_tokens": 16}'
    data: {"type": "accepted", "rid": 0}
    data: {"type": "tokens", "rid": 0, "tokens": [5, 17]}
    data: {"type": "done", "rid": 0, "status": "finished", "n_tokens": 16}
"""

from __future__ import annotations

import asyncio
import dataclasses
import itertools
import json
import threading
import time
from collections import deque
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.infer import (
    FaultPlan,
    QueueFullError,
    Request,
    RequestLifecycle,
    RequestState,
    Scheduler,
)
from repro_torch.kernels import census_families
from repro_torch.obs import MetricsRegistry, Tracer, default_registry, prometheus_text

try:  # aiohttp is optional: the session core must import without it
    from aiohttp import WSMsgType, web
except ImportError:  # pragma: no cover - exercised on minimal installs
    web = None
    WSMsgType = None


@dataclasses.dataclass
class StreamEvent:
    """One event on a request's stream. ``kind``: accepted | tokens | done |
    error | rejected. Terminal kinds (done/error/rejected) end the stream."""

    kind: str
    rid: int = -1
    tokens: Optional[List[int]] = None
    status: str = ""
    reason: str = ""
    n_tokens: int = 0

    @property
    def terminal(self) -> bool:
        return self.kind in ("done", "error", "rejected")

    def to_json(self) -> dict:
        d = {"type": self.kind, "rid": self.rid}
        if self.tokens is not None:
            d["tokens"] = self.tokens
        if self.status:
            d["status"] = self.status
        if self.reason:
            d["reason"] = self.reason
        if self.kind == "done":
            d["n_tokens"] = self.n_tokens
        return d


class RequestStream:
    """Async view of one in-flight request: iterate to receive events until a
    terminal one; ``cancel()`` flags host-side cancellation (applied at the
    next chunk boundary)."""

    def __init__(self, rid: int, queue: "asyncio.Queue[StreamEvent]",
                 session: "ServeSession"):
        self.rid = rid
        self._queue = queue
        self._session = session
        self._done = False

    def __aiter__(self):
        return self

    async def __anext__(self) -> StreamEvent:
        if self._done:
            raise StopAsyncIteration
        ev = await self._queue.get()
        if ev.terminal:
            self._done = True
        return ev

    def cancel(self, reason: str = "cancelled by client") -> None:
        self._session.cancel(self.rid, reason)

    async def drain(self) -> Tuple[List[int], StreamEvent]:
        """Collect the whole stream: (all tokens, terminal event)."""
        toks: List[int] = []
        last = StreamEvent(kind="error", rid=self.rid, reason="stream ended")
        async for ev in self:
            if ev.kind == "tokens" and ev.tokens:
                toks.extend(ev.tokens)
            last = ev
        return toks, last


class ServeSession:
    """Pump a Scheduler off-thread and expose async per-request streams.

    The scheduler is single-threaded by contract; every mutation (submit,
    step, cancel application) happens on the pump thread. The asyncio side
    only appends to a thread-safe inbox and reads from per-request queues.
    """

    def __init__(
        self,
        engine,
        *,
        n_slots: int = 4,
        chunk: int = 8,
        speculate=None,
        prefill_chunk: Optional[int] = None,
        max_queue: Optional[int] = 64,
        max_buffer: int = 1024,
        nan_guard: bool = True,
        faults: Optional[FaultPlan] = None,
        idle_wait_s: float = 0.005,
        tracer: Optional[Tracer] = None,
        metrics: Optional[MetricsRegistry] = None,
        observe: bool = True,
    ):
        """``tracer``/``metrics`` default to fresh per-session instances
        (``observe=False`` turns both off unless passed explicitly): a
        serving session should always be able to answer ``/v1/trace`` and
        ``/v1/metrics`` — the observability layer is host-side-only and
        never perturbs tokens (tests/test_torch_obs.py), so on-by-default is
        safe. Pass a shared registry/tracer to aggregate across sessions.
        With a registry, the kernels' launch census is registered on the
        process-global registry as a collector, read at each scrape.
        ``prefill_chunk`` enables chunked prefill on the scheduler — long-
        prompt admissions then interleave with decode instead of stalling
        it."""
        self._engine = engine
        self._faults = faults
        self._max_buffer = max_buffer
        self._idle_wait_s = idle_wait_s
        if observe:
            tracer = Tracer() if tracer is None else tracer
            metrics = MetricsRegistry() if metrics is None else metrics
        self.tracer = tracer
        self.registry = metrics
        self.sched = Scheduler(
            engine,
            n_slots=n_slots,
            chunk=chunk,
            speculate=speculate,
            prefill_chunk=prefill_chunk,
            max_queue=max_queue,
            nan_guard=nan_guard,
            faults=faults,
            on_tokens=self._on_tokens,
            on_event=self._on_event,
            tracer=tracer,
            metrics=metrics,
        )
        # ("submit", req) | ("cancel", rid, reason) | ("call", fn, future)
        self._inbox: deque = deque()
        # the card the slot state lives on, with its index (an engine's
        # "cuda" names the current device of the thread that made it)
        self._device = self.sched.slots["logits"].device
        self._wake = threading.Event()
        self._stop_flag = False
        self.pump_error: Optional[BaseException] = None  # what killed the pump, if anything
        self._thread: Optional[threading.Thread] = None
        self._loop: Optional[asyncio.AbstractEventLoop] = None
        # rid -> (asyncio queue, overflowed flag holder)
        self._streams: Dict[int, "asyncio.Queue[StreamEvent]"] = {}
        self._rids = itertools.count()
        self.counters = {"overflow_cancelled": 0, "rejected": 0}
        if self.registry is not None:
            for key in self.counters:
                self.registry.counter(
                    f"server_{key}_total", f"server-side events: {key}"
                )
            default_registry().add_collector("kernel_census", census_families)

    def _count(self, key: str, n: int = 1) -> None:
        """Server-side counter increments, mirrored into the registry as
        ``server_<key>_total`` (same lockstep contract as the scheduler)."""
        self.counters[key] += n
        if self.registry is not None:
            self.registry.counter(f"server_{key}_total").inc(n)

    # -- lifecycle of the session itself -------------------------------------

    async def __aenter__(self) -> "ServeSession":
        await self.start()
        return self

    async def __aexit__(self, *exc) -> None:
        await self.stop()

    async def start(self) -> None:
        if self._thread is not None:
            raise RuntimeError("session already started")
        self._loop = asyncio.get_running_loop()
        self._thread = threading.Thread(
            target=self._pump, name="repro-serve-pump", daemon=True
        )
        self._thread.start()

    async def stop(self, drain: bool = False) -> None:
        """Stop the pump. ``drain=True`` serves out everything in flight
        first; otherwise in-flight requests are cancelled at the next chunk
        boundary (their streams receive a terminal event either way)."""
        if self._thread is None:
            return
        if drain:
            while not self.sched.idle or self._inbox:
                await asyncio.sleep(self._idle_wait_s)
        self._stop_flag = True
        self._wake.set()
        await asyncio.get_running_loop().run_in_executor(
            None, self._thread.join
        )
        self._thread = None
        if self.pump_error is not None:
            raise RuntimeError("the serving pump thread died") from self.pump_error

    # -- async client API -----------------------------------------------------

    async def submit_stream(self, req: Request) -> RequestStream:
        """Submit a request; returns its stream. Admission happens on the
        pump thread — a full queue surfaces as a terminal ``rejected`` event
        on the stream (never an unbounded enqueue)."""
        if self._loop is None:
            raise RuntimeError("session not started")
        if self.pump_error is not None:
            raise RuntimeError("the serving pump thread died") from self.pump_error
        rid = req.rid if req.rid is not None else next(self._rids)
        req.rid = rid
        q: "asyncio.Queue[StreamEvent]" = asyncio.Queue()
        self._streams[rid] = q
        self._inbox.append(("submit", req))
        self._wake.set()
        return RequestStream(rid, q, self)

    def cancel(self, rid: int, reason: str = "cancelled by client") -> None:
        self._inbox.append(("cancel", rid, reason))
        self._wake.set()

    async def call_on_pump(self, fn):
        """Run ``fn()`` on the pump thread between two scheduler steps and
        return its result (its exception is raised here): for work that
        must happen on the thread that owns the card, such as
        ``torch.profiler``'s start and stop or a device sync."""
        if self._loop is None:
            raise RuntimeError("session not started")
        fut = self._loop.create_future()
        self._inbox.append(("call", fn, fut))
        self._wake.set()
        return await fut

    def metrics(self) -> dict:
        """Scheduler lifecycle/latency summary + server-side counters.
        Snapshot read across threads: dict/int reads are atomic under the
        GIL, and the records it summarises are terminal (immutable). With a
        registry attached, its full snapshot (queue depth, slot occupancy,
        speculative acceptance, histograms, ...) rides along under
        ``registry`` and the tracer's ring stats under ``tracer``."""
        out = self.sched.summary()
        out["server"] = dict(self.counters)
        if self.registry is not None:
            out["registry"] = self.registry.snapshot()
        if self.tracer is not None:
            out["tracer"] = self.tracer.stats()
        return out

    def prometheus(self) -> str:
        """Prometheus text exposition over the session registry plus the
        process-global default registry (the kernels' launch census),
        deduplicated when they are the same object."""
        if self.registry is None:
            raise RuntimeError("session has no metrics registry (observe=False)")
        regs = [self.registry]
        if self.registry is not default_registry():
            regs.append(default_registry())
        return prometheus_text(*regs)

    def trace_json(self) -> dict:
        """The session tracer's buffered window as a Chrome trace object."""
        if self.tracer is None:
            raise RuntimeError("session has no tracer (observe=False)")
        return self.tracer.to_chrome()

    # -- pump thread ----------------------------------------------------------

    def _post(self, rid: int, ev: StreamEvent) -> None:
        """Pump thread -> event loop: deliver one event to a stream, applying
        the bounded-buffer slow-client policy."""
        q = self._streams.get(rid)
        if q is None or self._loop is None:
            return
        if ev.terminal:
            self._streams.pop(rid, None)
        elif q.qsize() >= self._max_buffer:
            # slow client: its buffer is full. Cancel the request rather than
            # grow host memory; the terminal event will still be delivered
            # (terminal events bypass the bound — the stream is closing).
            self._count("overflow_cancelled")
            if self.tracer is not None:
                self.tracer.instant(
                    "overflow_cancel", cat="server", lane="pump",
                    args={"rid": rid, "max_buffer": self._max_buffer},
                )
            self.sched.cancel(
                rid,
                f"slow client: stream buffer overflowed ({self._max_buffer} "
                f"events unread)",
            )
            return
        self._loop.call_soon_threadsafe(q.put_nowait, ev)

    def _on_tokens(self, rid: int, tokens: List[int]) -> None:
        if self._faults is not None:
            stall = self._faults.stall_for(rid)
            if stall > 0:
                time.sleep(stall)  # injected slow consumer (pump-side stall)
        self._post(rid, StreamEvent(kind="tokens", rid=rid, tokens=tokens))

    def _on_event(self, rec: RequestLifecycle) -> None:
        if rec.state is RequestState.FINISHED:
            ev = StreamEvent(
                kind="done", rid=rec.rid, status=rec.state.value,
                reason=rec.reason, n_tokens=rec.n_tokens,
            )
        else:
            ev = StreamEvent(
                kind="error", rid=rec.rid, status=rec.state.value,
                reason=rec.reason,
            )
        self._post(rec.rid, ev)

    def _drain_inbox(self) -> int:
        n = 0
        while self._inbox:
            item = self._inbox.popleft()
            n += 1
            if item[0] == "submit":
                req = item[1]
                try:
                    self.sched.submit(req)
                    self._post(req.rid, StreamEvent(kind="accepted", rid=req.rid))
                except QueueFullError as e:
                    self._count("rejected")
                    self._post(
                        req.rid,
                        StreamEvent(kind="rejected", rid=req.rid, reason=str(e)),
                    )
                except (ValueError, OverflowError) as e:
                    # invalid request (too long for the cache, bad token ids):
                    # reject on the stream instead of killing the pump
                    self._post(
                        req.rid,
                        StreamEvent(kind="rejected", rid=req.rid, reason=str(e)),
                    )
            elif item[0] == "call":
                _, fn, fut = item
                try:
                    result, error = fn(), None
                except Exception as e:  # noqa: BLE001 — delivered to the caller
                    result, error = None, e
                self._loop.call_soon_threadsafe(_settle, fut, result, error)
            else:
                _, rid, reason = item
                self.sched.cancel(rid, reason)
        return n

    def _pump(self) -> None:
        """The pump thread. If it dies, every open stream gets a terminal
        ``failed`` event naming the error (no client waits forever) and
        :meth:`stop` raises it."""
        try:
            self._pump_loop()
        except BaseException as e:
            self.pump_error = e
            for rid in list(self._streams):
                self._post(rid, StreamEvent(kind="error", rid=rid, status="failed",
                                            reason=f"serving pump died: {e!r}"))

    def _pump_loop(self) -> None:
        if self._device.type == "cuda":
            torch.cuda.set_device(self._device)  # a per-thread setting
        tr = self.tracer
        if tr is not None:
            tr.instant("pump_start", cat="server", lane="pump")
        while True:
            if self._inbox and tr is not None:
                # span only when there is work: the idle poll must not fill
                # the ring with empty drains
                with tr.span("drain_inbox", cat="server", lane="pump") as sp:
                    drained = self._drain_inbox()
                    sp.annotate(items=drained)
            else:
                drained = self._drain_inbox()
            if self._stop_flag:
                break
            if self.sched.idle and not drained:
                self._wake.wait(timeout=self._idle_wait_s)
                self._wake.clear()
                continue
            self.sched.step()
        # shutdown: everything still queued or decoding is cancelled so no
        # stream is left hanging without a terminal event
        for rid, rec in list(self.sched.outcomes.items()):
            if not rec.state.terminal:
                self.sched.cancel(rid, "server shutting down")
        self.sched.step()
        if tr is not None:
            tr.instant("pump_stop", cat="server", lane="pump")


def _settle(fut: "asyncio.Future", result, error) -> None:
    """Event-loop side of :meth:`ServeSession.call_on_pump`."""
    if fut.cancelled():
        return
    if error is not None:
        fut.set_exception(error)
    else:
        fut.set_result(result)


# -- aiohttp transport --------------------------------------------------------


def _require_aiohttp() -> None:
    if web is None:
        raise RuntimeError(
            "the websocket and SSE front end needs aiohttp, which is not "
            "installed; the ServeSession core works without it"
        )


def request_from_json(msg: dict) -> Request:
    """Build a Request from one client JSON frame (validation happens in
    Request.__post_init__ / Scheduler.submit and surfaces as a rejection)."""
    return Request(
        # no dtype coercion: a JSON list of ints arrives as an integer array,
        # and float token ids must hit Request's loud dtype validation
        # instead of being silently truncated here
        prompt=np.asarray(msg["prompt"]),
        max_new_tokens=int(msg.get("max_new_tokens", 16)),
        temperature=float(msg.get("temperature", 0.0)),
        seed=msg.get("seed", 0),
        stop_tokens=msg.get("stop_tokens"),
        ttft_deadline_s=msg.get("ttft_deadline_s"),
        deadline_s=msg.get("deadline_s"),
        speculate=msg.get("speculate"),
    )


def make_app(session: ServeSession) -> "web.Application":
    """The aiohttp app: WS streaming + health + metrics."""
    _require_aiohttp()

    async def healthz(_request):
        return web.json_response({"ok": True})

    async def metrics(request):
        # ?format=prometheus (or an Accept header naming the exposition
        # content type) switches to Prometheus text; default stays the JSON
        # summary existing consumers parse
        fmt = request.query.get("format", "")
        accept = request.headers.get("Accept", "")
        if fmt == "prometheus" or "application/openmetrics-text" in accept:
            if session.registry is None:
                return web.json_response(
                    {"error": "session has no metrics registry"}, status=501
                )
            return web.Response(
                text=session.prometheus(),
                content_type="text/plain",
                charset="utf-8",
            )
        return web.json_response(session.metrics())

    async def trace(_request):
        if session.tracer is None:
            return web.json_response(
                {"error": "session has no tracer"}, status=501
            )
        return web.json_response(session.trace_json())

    async def stream(request):
        ws = web.WebSocketResponse()
        await ws.prepare(request)
        try:
            msg = await ws.receive_json()
            req = request_from_json(msg)
        except (KeyError, TypeError, ValueError) as e:
            await ws.send_json(
                {"type": "rejected", "reason": f"bad request: {e!r}"}
            )
            await ws.close()
            return ws
        stream = await session.submit_stream(req)

        async def watch_client():
            # a close/cancel frame — or the socket dropping — cancels the
            # request at the next chunk boundary (disconnect-as-cancel)
            async for m in ws:
                if m.type == WSMsgType.TEXT:
                    try:
                        frame = m.json()
                    except ValueError:
                        continue
                    if frame.get("type") == "cancel":
                        stream.cancel("cancel frame from client")
            stream.cancel("client disconnected")

        watcher = asyncio.ensure_future(watch_client())
        try:
            async for ev in stream:
                if ws.closed:
                    stream.cancel("client disconnected")
                    break
                try:
                    await ws.send_json(ev.to_json())
                except (ConnectionResetError, RuntimeError):
                    stream.cancel("client disconnected")
                    break
        finally:
            watcher.cancel()
            if not ws.closed:
                await ws.close()
        return ws

    async def generate(request):
        # SSE transport: same session core and frame schema as the WS
        # endpoint, but over plain HTTP — one JSON frame per ``data:`` line.
        try:
            msg = await request.json()
            req = request_from_json(msg)
        except (KeyError, TypeError, ValueError) as e:
            return web.json_response(
                {"type": "rejected", "reason": f"bad request: {e!r}"},
                status=400,
            )
        stream = await session.submit_stream(req)
        resp = web.StreamResponse(
            headers={
                "Content-Type": "text/event-stream",
                "Cache-Control": "no-cache",
                "X-Accel-Buffering": "no",
            }
        )
        await resp.prepare(request)
        try:
            async for ev in stream:
                frame = f"data: {json.dumps(ev.to_json())}\n\n"
                try:
                    await resp.write(frame.encode("utf-8"))
                except (ConnectionResetError, RuntimeError):
                    stream.cancel("client disconnected")
                    break
        except asyncio.CancelledError:
            # aiohttp cancels the handler when the peer drops mid-stream:
            # disconnect-as-cancel, same contract as the WS endpoint
            stream.cancel("client disconnected")
            raise
        try:
            await resp.write_eof()
        except (ConnectionResetError, RuntimeError):
            pass
        return resp

    app = web.Application()
    app.router.add_get("/healthz", healthz)
    app.router.add_get("/v1/metrics", metrics)
    app.router.add_get("/v1/trace", trace)
    app.router.add_get("/v1/stream", stream)
    app.router.add_post("/v1/generate", generate)
    return app


async def run_server(
    session: ServeSession, host: str = "127.0.0.1", port: int = 8777
) -> "web.AppRunner":
    """Start the app on (host, port); returns the runner (cleanup() to stop).
    port=0 binds an ephemeral port — read it back from the runner for tests."""
    _require_aiohttp()
    app = make_app(session)
    runner = web.AppRunner(app)
    await runner.setup()
    site = web.TCPSite(runner, host, port)
    await site.start()
    return runner


def bound_port(runner: "web.AppRunner") -> int:
    for site in runner.sites:
        server = site._server  # noqa: SLF001 - aiohttp exposes no public port
        if server and server.sockets:
            return server.sockets[0].getsockname()[1]
    raise RuntimeError("server has no bound socket")


# -- CLI ----------------------------------------------------------------------


def main(argv=None) -> None:  # pragma: no cover - CLI wrapper over tested pieces
    import argparse

    from repro_torch.configs import ARCH_IDS, get_config
    from repro_torch.infer import Engine, PrefixCache, SpecConfig
    from repro_torch.models import init_params, reduced
    from repro_torch.quant import QuantPolicy, quantize_params

    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=ARCH_IDS, default="llama3.2-3b")
    ap.add_argument("--q", type=int, default=4)
    ap.add_argument("--g", type=int, default=128)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--chunk", type=int, default=8)
    ap.add_argument("--max-seq", type=int, default=256)
    ap.add_argument("--max-queue", type=int, default=64)
    ap.add_argument("--speculate", type=str, default=None, metavar="QD:GAMMA")
    ap.add_argument("--prefix-cache-mb", type=int, default=0,
                    help="KV prefix-cache budget in MiB (0 disables)")
    ap.add_argument("--prefill-chunk", type=int, default=0,
                    help="chunked-prefill token budget per step (0 = whole-shot)")
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int, default=8777)
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                    help="where the model runs (default: the GPU)")
    args = ap.parse_args(argv)
    _require_aiohttp()

    spec = SpecConfig.parse(args.speculate) if args.speculate else None
    cfg = reduced(get_config(args.arch), d_model=256, n_kv_heads=4,
                  d_ff=512 if get_config(args.arch).d_ff else 0)
    params = init_params(cfg, seed=0, device=args.device)
    if args.q:
        params = quantize_params(params, QuantPolicy(q=args.q, g=args.g, iters=4), device=args.device)
    engine_max_seq = args.max_seq + (spec.gamma + 1 if spec else 0)
    pc = (
        PrefixCache(max_bytes=args.prefix_cache_mb << 20)
        if args.prefix_cache_mb > 0
        else None
    )
    engine = Engine(cfg, params, max_seq=engine_max_seq, prefix_cache=pc, device=args.device)

    async def serve():
        session = ServeSession(
            engine, n_slots=args.slots, chunk=args.chunk, speculate=spec,
            prefill_chunk=args.prefill_chunk or None,
            max_queue=args.max_queue,
        )
        async with session:
            runner = await run_server(session, args.host, args.port)
            print(f"serving {args.arch} (q={args.q}) on {engine.device}, "
                  f"ws://{args.host}:{bound_port(runner)}/v1/stream "
                  f"({args.slots} slots, chunk={args.chunk}, "
                  f"prefill_chunk={args.prefill_chunk or 'off'}, "
                  f"prefix_cache={args.prefix_cache_mb}MiB, "
                  f"max_queue={args.max_queue})", flush=True)
            try:
                while True:
                    await asyncio.sleep(3600)
            finally:
                await runner.cleanup()

    asyncio.run(serve())


if __name__ == "__main__":
    main()
