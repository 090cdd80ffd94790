"""Ring-buffered span tracer with Chrome/Perfetto trace-event export
(counterpart of ``repro/obs/trace.py``).

The serving stack (scheduler chunk loop, engine dispatches, ServeSession
pump thread) emits spans here; ``to_chrome()`` renders them in the Chrome
trace-event JSON format, loadable in ``chrome://tracing`` or
https://ui.perfetto.dev. The spans time what the *host* did; what the
device did in each engine span is ``torch.profiler``'s job (the engine
opens a ``record_function`` range of the same name, ``launch/serve.py
--profile-dir``). Design constraints:

- **Low overhead**: a recorded span is one clock reading at enter, one at
  exit, and one tuple append under a lock — no dict churn, no string
  formatting until export. A disabled tracer never touches its clock, so
  ``tracer=None`` and ``Tracer(enabled=False)`` are both true zeros.
- **Bounded memory**: a ring of ``capacity`` events; the oldest are evicted
  and counted (``evicted``) so a long-lived server can always answer
  ``/v1/trace`` with its recent window without growing without bound.
- **Injectable clock**: defaults to ``time.monotonic``; tests drive it with
  ``repro_torch.infer.faults.StepClock``. The tracer's clock is deliberately *separate*
  from the scheduler's — recording spans must never consume scheduler clock
  readings, or tracing would perturb deadline behaviour under StepClock.
- **Two timestamp sources, one rule**: live spans (:meth:`Tracer.span`)
  read the tracer clock; lifecycle spans replayed from
  ``RequestLifecycle`` records (:meth:`Tracer.complete`) reuse timestamps
  the scheduler already took. In production both clocks are
  ``time.monotonic`` so the lanes align; under a fake clock they are
  separate timebases and tests assert within-lane ordering only.

``python -m repro_torch.obs.trace`` runs a short fault-injected serve
(cancel + NaN poison + deadline shed, mirroring
tests/test_torch_lifecycle.py) on the GPU (``--device cpu`` on the CPU),
dumps the trace JSON, and validates it — ``--smoke`` also checks the
Prometheus export and the request accounting.
"""

from __future__ import annotations

import json
import threading
import time
from collections import deque
from typing import Callable, Dict, List, Optional, Tuple

# event tuples: (ph, name, cat, lane, ts, dur, args)
#   ph "X" = complete span (dur set), "i" = instant (dur None)
_Event = Tuple[str, str, str, str, float, Optional[float], Optional[dict]]


class _SpanHandle:
    """Context manager for one live span; ``annotate()`` adds args mid-span
    (e.g. tokens committed, discovered only at chunk end)."""

    __slots__ = ("_tracer", "name", "cat", "lane", "args", "_start")

    def __init__(self, tracer: "Tracer", name: str, cat: str, lane: str, args: dict):
        self._tracer = tracer
        self.name = name
        self.cat = cat
        self.lane = lane
        self.args = args
        self._start = 0.0

    def annotate(self, **kw) -> None:
        self.args.update(kw)

    def __enter__(self) -> "_SpanHandle":
        self._start = self._tracer._clock()
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        end = self._tracer._clock()
        if exc_type is not None:
            self.args["error"] = f"{exc_type.__name__}: {exc}"
        self._tracer.complete(
            self.name, self._start, end, cat=self.cat, lane=self.lane,
            args=self.args or None,
        )


class _NullSpan:
    """Zero-cost stand-in when the tracer is disabled: no clock reads."""

    __slots__ = ()

    def annotate(self, **kw) -> None:
        pass

    def __enter__(self) -> "_NullSpan":
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        pass


_NULL_SPAN = _NullSpan()


class Tracer:
    """Thread-safe ring buffer of spans/instants with Chrome-trace export.

    >>> tr = Tracer(capacity=4096)
    >>> with tr.span("decode_chunk", lane="scheduler", ordinal=3):
    ...     ...
    >>> tr.complete("queued", t_submit, t_admit, lane="req:0")
    >>> json.dump(tr.to_chrome(), open("trace.json", "w"))
    """

    def __init__(
        self,
        capacity: int = 8192,
        clock: Callable[[], float] = time.monotonic,
        enabled: bool = True,
    ):
        if capacity < 1:
            raise ValueError(f"capacity must be >= 1, got {capacity}")
        self.capacity = capacity
        self.enabled = enabled
        self._clock = clock
        self._events: deque = deque()
        self._lock = threading.Lock()
        self.evicted = 0
        self.recorded = 0

    # -- recording -------------------------------------------------------------

    def _append(self, ev: _Event) -> None:
        with self._lock:
            if len(self._events) >= self.capacity:
                self._events.popleft()
                self.evicted += 1
            self._events.append(ev)
            self.recorded += 1

    def span(self, name: str, *, cat: str = "", lane: str = "main", **args):
        """Live span context manager: reads the tracer clock at enter/exit.
        Disabled → a shared no-op handle (no clock reads, no allocation
        beyond the kwargs dict the caller already built)."""
        if not self.enabled:
            return _NULL_SPAN
        return _SpanHandle(self, name, cat, lane, args)

    def complete(self, name: str, start: float, end: float, *, cat: str = "",
                 lane: str = "main", args: Optional[dict] = None) -> None:
        """Record a span from timestamps the caller already holds (lifecycle
        records replay through here — zero extra clock readings)."""
        if not self.enabled:
            return
        self._append(("X", name, cat, lane, start, max(0.0, end - start), args))

    def instant(self, name: str, *, ts: Optional[float] = None, cat: str = "",
                lane: str = "main", args: Optional[dict] = None) -> None:
        if not self.enabled:
            return
        self._append(("i", name, cat, lane, self._clock() if ts is None else ts,
                      None, args))

    def now(self) -> float:
        """One tracer-clock reading (for callers composing complete())."""
        return self._clock()

    def clear(self) -> None:
        with self._lock:
            self._events.clear()

    def stats(self) -> dict:
        with self._lock:
            return {
                "recorded": self.recorded,
                "buffered": len(self._events),
                "evicted": self.evicted,
                "capacity": self.capacity,
            }

    # -- export ----------------------------------------------------------------

    def events(self) -> List[_Event]:
        """The buffered raw event tuples, oldest first (a copy)."""
        with self._lock:
            return list(self._events)

    def chrome_events(self) -> List[dict]:
        """Render as Chrome trace-event dicts: ``ph:"X"`` complete events and
        ``ph:"i"`` instants, timestamps in µs relative to the earliest
        buffered event, one ``tid`` lane per distinct ``lane`` string (with
        ``M`` thread_name/thread_sort_index metadata so Perfetto labels and
        orders them)."""
        raw = self.events()
        if not raw:
            return []
        t0 = min(ev[4] for ev in raw)
        lanes: Dict[str, int] = {}
        out: List[dict] = []
        for ph, name, cat, lane, ts, dur, args in raw:
            tid = lanes.setdefault(lane, len(lanes) + 1)
            ev: dict = {
                "ph": ph,
                "name": name,
                "pid": 1,
                "tid": tid,
                "ts": round((ts - t0) * 1e6, 3),
            }
            if cat:
                ev["cat"] = cat
            if ph == "X":
                ev["dur"] = round((dur or 0.0) * 1e6, 3)
            else:
                ev["s"] = "t"  # thread-scoped instant
            if args:
                ev["args"] = args
            out.append(ev)
        meta: List[dict] = [
            {"ph": "M", "name": "process_name", "pid": 1, "tid": 0,
             "args": {"name": "repro.serve"}},  # the reference's name: the two traces compare equal
        ]
        for lane, tid in sorted(lanes.items(), key=lambda kv: kv[1]):
            meta.append({"ph": "M", "name": "thread_name", "pid": 1, "tid": tid,
                         "args": {"name": lane}})
            meta.append({"ph": "M", "name": "thread_sort_index", "pid": 1,
                         "tid": tid, "args": {"sort_index": tid}})
        return meta + out

    def to_chrome(self) -> dict:
        """The full Chrome trace object (JSON Object Format): load the dump
        in chrome://tracing or ui.perfetto.dev as-is."""
        return {
            "traceEvents": self.chrome_events(),
            "displayTimeUnit": "ms",
            "otherData": self.stats(),
        }


_VALID_PH = {"X", "i", "M"}


def validate_chrome_trace(trace) -> List[str]:
    """Schema check for the trace-event JSON we emit (and the subset of the
    format Perfetto requires). Accepts the dict or its JSON string; returns a
    list of problems — empty means valid. Checked shape:

    - top level: object with a ``traceEvents`` list;
    - every event: ``ph`` ∈ {X, i, M}, string ``name``, integer ``pid``/
      ``tid``, and for X/i a numeric non-negative ``ts`` (µs);
    - ``X`` events: numeric non-negative ``dur``;
    - ``i`` events: scope ``s`` ∈ {g, p, t};
    - ``M`` events: an ``args`` object (thread/process metadata payload).
    """
    problems: List[str] = []
    if isinstance(trace, (str, bytes)):
        try:
            trace = json.loads(trace)
        except json.JSONDecodeError as e:
            return [f"not valid JSON: {e}"]
    if not isinstance(trace, dict):
        return [f"top level must be an object, got {type(trace).__name__}"]
    events = trace.get("traceEvents")
    if not isinstance(events, list):
        return ["missing or non-list 'traceEvents'"]
    for i, ev in enumerate(events):
        where = f"traceEvents[{i}]"
        if not isinstance(ev, dict):
            problems.append(f"{where}: not an object")
            continue
        ph = ev.get("ph")
        if ph not in _VALID_PH:
            problems.append(f"{where}: ph={ph!r} not in {sorted(_VALID_PH)}")
            continue
        if not isinstance(ev.get("name"), str) or not ev["name"]:
            problems.append(f"{where}: missing/empty 'name'")
        for key in ("pid", "tid"):
            if not isinstance(ev.get(key), int):
                problems.append(f"{where}: '{key}' must be an int")
        if ph in ("X", "i"):
            ts = ev.get("ts")
            if not isinstance(ts, (int, float)) or ts < 0:
                problems.append(f"{where}: 'ts' must be a number >= 0, got {ts!r}")
        if ph == "X":
            dur = ev.get("dur")
            if not isinstance(dur, (int, float)) or dur < 0:
                problems.append(f"{where}: X event 'dur' must be >= 0, got {dur!r}")
        if ph == "i" and ev.get("s") not in ("g", "p", "t"):
            problems.append(f"{where}: instant scope 's' must be g/p/t")
        if ph == "M" and not isinstance(ev.get("args"), dict):
            problems.append(f"{where}: metadata event needs an 'args' object")
        if "args" in ev and not isinstance(ev["args"], dict):
            problems.append(f"{where}: 'args' must be an object")
    return problems


def request_lifecycles(trace) -> Dict[str, List[dict]]:
    """Group a Chrome trace's events by request lane (``req:<rid>``), each
    sorted by ts — the reconstruction primitive the acceptance test uses to
    prove every request's lifecycle is recoverable from the trace alone."""
    if isinstance(trace, (str, bytes)):
        trace = json.loads(trace)
    lane_names: Dict[int, str] = {}
    for ev in trace["traceEvents"]:
        if ev.get("ph") == "M" and ev.get("name") == "thread_name":
            lane_names[ev["tid"]] = ev["args"]["name"]
    out: Dict[str, List[dict]] = {}
    for ev in trace["traceEvents"]:
        if ev.get("ph") == "M":
            continue
        lane = lane_names.get(ev["tid"], str(ev["tid"]))
        if lane.startswith("req:"):
            out.setdefault(lane, []).append(ev)
    for evs in out.values():
        evs.sort(key=lambda e: e["ts"])
    return out


# -- CLI ------------------------------------------------------------------------
#
# `python -m repro_torch.obs.trace` runs a short fault-injected serve and
# dumps a trace; `--smoke` additionally validates everything and exits
# non-zero on any problem. Engine/scheduler imports happen inside the
# functions: the module itself must stay importable without torch
# (tests/test_torch_obs.py checks module-level imports).


def demo_serve(gen: int = 6, n_requests: int = 6, device: str = "cuda"):
    """A deliberately disturbed serve run on a tiny reduced model: one
    client cancel, one NaN-poisoned row, one deadline shed — the same
    unhappy-path mix tests/test_torch_lifecycle.py hardens. Returns
    ``(scheduler, tracer, registry)`` after the queue drains."""
    import numpy as np  # noqa: PLC0415 — lazy: keep repro_torch.obs importable without torch

    from repro_torch.configs import get_config  # noqa: PLC0415
    from repro_torch.data import MarkovCorpus  # noqa: PLC0415
    from repro_torch.infer import (  # noqa: PLC0415
        Engine,
        FaultPlan,
        Request,
        Scheduler,
        StepClock,
    )
    from repro_torch.models import init_params, reduced  # noqa: PLC0415
    from repro_torch.obs.metrics import MetricsRegistry  # noqa: PLC0415
    from repro_torch.quant import QuantPolicy, quantize_params  # noqa: PLC0415

    # 128-dim linears: the smallest size the quantization policy accepts, so
    # the demo really serves BCQ (64-dim would silently fall back to dense)
    cfg = reduced(get_config("llama3.2-3b"), d_model=128, n_kv_heads=4, d_ff=256)
    params = quantize_params(
        init_params(cfg, seed=0, device=device), QuantPolicy(q=3, g=32, iters=2), device=device
    )
    tracer = Tracer(capacity=4096)
    registry = MetricsRegistry()
    engine = Engine(cfg, params, max_seq=64, tracer=tracer, device=device)

    corpus = MarkovCorpus(cfg.vocab, seed=3)
    reqs = []
    for i in range(n_requests):
        plen = 4 + (i % 3)
        prompt = corpus.sample(1, plen, seed=100 + i)[0, :plen].astype(np.int32)
        reqs.append(Request(prompt=prompt, max_new_tokens=gen,
                            temperature=[0.0, 0.7][i % 2], seed=10 + i))
    # request n-1 sheds in queue: its deadline expires while earlier requests
    # hold both slots (StepClock advances 0.05 s per reading)
    reqs[-1].deadline_s = 0.01
    clk = StepClock(dt=0.05)
    sched = Scheduler(
        engine, n_slots=2, chunk=3,
        faults=FaultPlan(nan_row={1: 2}),  # rids are assigned 0..n-1 in submit order
        clock=clk, sleep=clk.sleep,
        tracer=tracer, metrics=registry,
    )
    rids = [sched.submit(r) for r in reqs]
    sched.cancel(rids[2], "demo client cancel")
    sched.run()
    return sched, tracer, registry


def main(argv: Optional[List[str]] = None) -> int:
    import argparse  # noqa: PLC0415

    p = argparse.ArgumentParser(
        prog="python -m repro_torch.obs.trace",
        description="Capture (or validate) a Chrome trace of a fault-injected "
                    "demo serve run.",
    )
    p.add_argument("--out", default="trace.json", help="trace output path")
    p.add_argument("--validate", metavar="FILE",
                   help="validate an existing trace JSON file and exit")
    p.add_argument("--smoke", action="store_true",
                   help="run the demo, validate the trace, parse the "
                        "Prometheus export, check request accounting; exit "
                        "non-zero on any problem")
    p.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                   help="where the demo model runs (default: the GPU)")
    args = p.parse_args(argv)

    if args.validate:
        with open(args.validate) as f:
            problems = validate_chrome_trace(f.read())
        for msg in problems:
            print(f"INVALID: {msg}")
        print(f"{args.validate}: {'OK' if not problems else f'{len(problems)} problem(s)'}")
        return 1 if problems else 0

    sched, tracer, registry = demo_serve(device=args.device)
    trace = tracer.to_chrome()
    with open(args.out, "w") as f:
        json.dump(trace, f)
    summary = sched.summary()
    states = summary["by_state"]
    print(f"wrote {args.out}: {len(trace['traceEvents'])} events "
          f"({tracer.stats()['evicted']} evicted)")
    print(f"requests: {states}")
    print("open in chrome://tracing or https://ui.perfetto.dev")

    if not args.smoke:
        return 0

    from repro_torch.obs.metrics import (  # noqa: PLC0415
        counters_agree,
        parse_prometheus,
        prometheus_text,
    )

    failures: List[str] = []
    failures += [f"trace: {m}" for m in validate_chrome_trace(trace)]
    lanes = request_lifecycles(trace)
    for rid in sched.outcomes:
        if f"req:{rid}" not in lanes:
            failures.append(f"trace: request {rid} has no lane")
    try:
        samples = parse_prometheus(prometheus_text(registry))
    except ValueError as e:
        samples = {}
        failures.append(f"prometheus: {e}")
    submitted = sum(v for _, v in samples.get("serve_submitted_total", []))
    terminal = sum(
        sum(v for _, v in samples.get(f"serve_{k}_total", []))
        for k in ("finished", "cancelled", "timed_out", "shed", "failed",
                  "rejected_queue_full")
    )
    if submitted == 0 or submitted != terminal:
        failures.append(
            f"accounting: submitted={submitted} != terminal sum={terminal}"
        )
    failures += [f"counters: {m}" for m in counters_agree(registry, sched.counters)]
    for msg in failures:
        print(f"SMOKE FAIL: {msg}")
    print(f"smoke: {'OK' if not failures else f'{len(failures)} failure(s)'}")
    return 1 if failures else 0


if __name__ == "__main__":
    raise SystemExit(main())
