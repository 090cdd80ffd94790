"""Continuous-batching scheduler over the slot-batched decode path
(counterpart of ``repro/infer/scheduler.py``, with its contract).

The paper's workload (§V) is many concurrent decode requests against one
weight-resident quantized model. One-shot ``Engine.generate`` runs a fixed
batch in lockstep; this module keeps a fixed-width decode batch full
instead (Orca-style continuous batching):

- requests wait in a **bounded admission queue**;
- the decode batch has ``n_slots`` **slots**; a free slot is filled by a
  batch-1 prefill of the next queued request, installed into the slot
  (``Engine.admit_slot``); on the GPU that prefill's attention runs on the
  flash-attention kernel at the request's own prompt length. With a prefix
  cache on the engine (``Engine(prefix_cache=...)``) only the prompt's
  uncached suffix prefills;
- decode runs in **chunks** of ``chunk`` steps over the whole batch
  (``Engine.decode_slots``); per-slot active masks let requests finish
  mid-chunk without stalling neighbours;
- a finished slot is freed and refilled at the next chunk boundary.

Correctness contract (``tests/test_torch_scheduler.py``): the interleaving
is *invisible* — each request's tokens are identical to running it alone
through ``Engine.generate(prompt, max_new_tokens, temperature=..., seed=...)``,
because batch rows are independent in the forward (per-slot positions,
cache rows and generators, and per-row products: see ``infer/engine.py``).

**Request lifecycle** (``infer/lifecycle.py``): QUEUED → PREFILLING →
DECODING → {FINISHED, CANCELLED, TIMED_OUT, FAILED}, with SHED for
deadline-aware queue shedding and a loud :class:`QueueFullError` when the
bounded queue rejects a submit. Whatever happens to any subset of requests —
cancellation, deadline expiry, injected dispatch failures, NaN-poisoned
rows — every surviving request's tokens stay bit-identical to an
undisturbed run (``tests/test_torch_lifecycle.py``). The mechanisms:

- **cancellation** (:meth:`Scheduler.cancel` only flags): the slot is
  reclaimed at the next chunk boundary (``Engine.release_slot``);
- **deadlines**: per-request TTFT and total deadlines, checked at chunk
  boundaries against the injectable ``clock``; queued requests whose
  deadline already passed are SHED before they cost a prefill;
- **NaN/inf logit guard**: a per-chunk (B,)-bool check; a non-finite row is
  FAILED and its slot scrubbed while neighbours decode on untouched;
- **bounded retry with backoff** around every engine dispatch; a prefill
  that keeps failing fails only its request, a decode chunk that keeps
  failing fails the active tenants and rebuilds the slot state so queued
  requests still complete;
- **fault injection** (``infer/faults.py``): a :class:`FaultPlan` threaded
  through the dispatch points makes all of the above testable.

**Stop tokens**: ``Request.stop_tokens`` finish a row early — host-side
truncation at the chunk boundary (the stop token is kept), the slot frees at
once, and the completion equals a solo ``generate`` cut at the same place.

**Speculative slots** (``speculate=SpecConfig(...)``, ``infer/speculative.py``):
each dispatch runs ``chunk`` speculative chunks (``Engine.spec_decode_slots``),
each committing 1..γ + 1 tokens a row; admission emits the request's first
token, so a budget-1 request completes at admission, and every request needs
γ + 1 cache rows of headroom. ``Request.speculate=False`` opts a request out:
it commits one plain token a chunk, its solo plain ``generate``'s stream.
Greedy and opted-out requests stay identical to their solo plain ``generate``.

**Chunked prefill** (``prefill_chunk``): a free slot claims a queued
request (``Engine.begin_admission``: the prefix lookup and install), and
every pending admission then prefills at most ``prefill_chunk`` prompt
tokens a step (``Engine.advance_admission``), between decode chunks, so one
long prompt never stalls the decode of the other slots; a finished one is
installed in the same step (``Engine.finish_admission``). A pending
admission can be cancelled or time out between its chunks, which releases
its prefix handle; one whose chunks keep failing fails alone. The
lifecycle record carries ``prefix_hit_tokens`` and ``prefill_chunks``.

**Observability** (``tracer`` / ``metrics``, ``repro_torch.obs``): every
``counters`` increment is mirrored as ``serve_<key>_total`` (with
``serve_submitted_total``, ``serve_finished_total``, ``serve_tokens_total``,
``serve_decode_chunks_total``, queue and slot gauges and TTFT / TPOT / e2e
histograms), and the tracer records a ``decode_chunk`` span a dispatch, a
request's lifecycle on its ``req:<rid>`` lane, and ``retry``,
``nan_quarantine``, ``reject_queue_full``, ``cache_hit`` and
``spec_verify`` instants. The hooks run between engine dispatches, and
the spans read the tracer's clock, never the scheduler's, so tracing moves
neither tokens nor deadlines.
"""

from __future__ import annotations

import contextlib
import dataclasses
import itertools
import time
from collections import deque
from typing import Callable, Deque, Dict, List, Optional, Sequence

import numpy as np

from repro_torch.infer.engine import Engine
from repro_torch.infer.faults import FaultPlan
from repro_torch.infer.lifecycle import (
    QueueFullError,
    RequestLifecycle,
    RequestState,
    latency_summary,
)
from repro_torch.infer.prefix_cache import check_observers
from repro_torch.infer.speculative import SpecConfig


class DispatchError(RuntimeError):
    """An engine dispatch kept failing after bounded retries."""


@dataclasses.dataclass
class Request:
    """One generation request. ``seed`` and ``temperature`` are per request:
    greedy and sampled requests share a batch. In a speculative scheduler,
    ``speculate=False`` opts the request out of drafting (None or True: it
    speculates); elsewhere it is ignored.

    ``stop_tokens`` ends the generation early at the first matching token
    (kept; the slot frees at the next chunk boundary).
    ``ttft_deadline_s`` / ``deadline_s`` are wall-clock budgets from submit:
    a request that misses one is TIMED_OUT (or SHED while still queued) at
    the next chunk boundary."""

    prompt: np.ndarray  # (prompt_len,) int32
    max_new_tokens: int
    temperature: float = 0.0
    seed: int = 0
    speculate: Optional[bool] = None
    stop_tokens: Optional[Sequence[int]] = None
    ttft_deadline_s: Optional[float] = None
    deadline_s: Optional[float] = None
    rid: Optional[int] = None  # assigned at submit() if None

    def __post_init__(self):
        arr = np.asarray(self.prompt)
        if arr.dtype.kind not in "iu":
            # a silent float -> int cast would truncate values the caller
            # never meant as token ids
            raise ValueError(f"prompt must be integer token ids, got dtype {arr.dtype}")
        self.prompt = arr.astype(np.int32).reshape(-1)
        if self.prompt.size == 0:
            raise ValueError("empty prompt")
        if self.max_new_tokens < 1:
            raise ValueError("max_new_tokens must be >= 1")
        # NaN/inf would poison sampling silently, a negative temperature
        # would invert the distribution; exactly 0.0 means greedy
        if not np.isfinite(self.temperature):
            raise ValueError(f"temperature must be finite, got {self.temperature!r}")
        if self.temperature < 0:
            raise ValueError(f"temperature must be >= 0 (0 = greedy), got {self.temperature!r}")
        self.temperature = float(self.temperature)
        # the seed goes to torch.Generator.manual_seed; keep the reference's
        # int64 range so a request valid there is valid here
        if isinstance(self.seed, bool) or not isinstance(self.seed, (int, np.integer)):
            raise ValueError(f"seed must be an integer, got {self.seed!r}")
        if not (-(2**63) <= int(self.seed) < 2**63):
            raise ValueError(f"seed must fit in int64 ([-2**63, 2**63)), got {self.seed}")
        self.seed = int(self.seed)
        if self.stop_tokens is not None:
            if any(
                isinstance(t, bool) or not isinstance(t, (int, np.integer))
                for t in self.stop_tokens
            ):
                raise ValueError(f"stop_tokens must be integer token ids, got {self.stop_tokens!r}")
            self.stop_tokens = tuple(int(t) for t in self.stop_tokens)
        for name in ("ttft_deadline_s", "deadline_s"):
            v = getattr(self, name)
            if v is not None and not (np.isfinite(v) and v > 0):
                raise ValueError(f"{name} must be a positive number, got {v!r}")


@dataclasses.dataclass
class Completion:
    rid: int
    prompt: np.ndarray  # (prompt_len,)
    new_tokens: np.ndarray  # (<= max_new_tokens,) — shorter iff stopped early
    admitted_at_step: int  # scheduler decode-step counter at admission
    finished_at_step: int
    stopped: bool = False  # True iff ended on a stop token before the budget

    @property
    def tokens(self) -> np.ndarray:
        """prompt + generation, the layout ``GenerationResult.tokens`` uses."""
        return np.concatenate([self.prompt, self.new_tokens])


class _Tenant:
    __slots__ = ("req", "emitted", "admitted_at_step", "stop")

    def __init__(self, req: Request, admitted_at_step: int):
        self.req = req
        self.emitted: List[int] = []
        self.admitted_at_step = admitted_at_step
        self.stop = frozenset(req.stop_tokens or ())


class Scheduler:
    """Continuous-batching front end for one :class:`Engine`.

    >>> sched = Scheduler(engine, n_slots=4)
    >>> sched.submit(Request(prompt, max_new_tokens=16))
    >>> done = sched.run()   # or: sched.step() in a serving loop

    - ``speculate``: a :class:`SpecConfig` makes every dispatch ``chunk``
      speculative chunks (module docstring), with γ + 1 rows of headroom.
    - ``max_queue`` bounds the admission queue; a full queue rejects at
      ``submit`` with :class:`QueueFullError` (None = unbounded).
    - ``retries`` / ``backoff_s``: bounded exponential-backoff retry around
      every engine dispatch.
    - ``nan_guard``: per-chunk non-finite-logit check; poisoned rows are
      FAILED and their slot scrubbed, neighbours untouched.
    - ``faults``: a :class:`FaultPlan` threaded through the dispatch points.
    - ``clock`` / ``sleep``: injectable time sources for deadlines and
      backoff (tests drive them with ``faults.StepClock``).
    - ``on_tokens(rid, tokens)``: fired at every chunk boundary with the
      request's newly visible (post-truncation) tokens.
    - ``on_event(record)``: fired at every terminal transition with the
      request's :class:`RequestLifecycle` (partial tokens attached).
    - ``tracer`` / ``metrics``: a :class:`~repro_torch.obs.Tracer` and a
      :class:`~repro_torch.obs.MetricsRegistry` (module docstring); the
      engine's prefix cache adopts them unless it has its own.

    Single-threaded: drive ``submit`` / ``step`` / ``run`` from one thread.
    :meth:`cancel` only flags; the flag applies at the next chunk boundary.
    """

    def __init__(
        self,
        engine: Engine,
        n_slots: int = 4,
        chunk: int = 8,
        speculate: Optional[SpecConfig] = None,
        *,
        prefill_chunk: Optional[int] = None,
        max_queue: Optional[int] = 64,
        retries: int = 2,
        backoff_s: float = 0.05,
        nan_guard: bool = True,
        faults: Optional[FaultPlan] = None,
        clock: Callable[[], float] = time.monotonic,
        sleep: Callable[[float], None] = time.sleep,
        on_tokens: Optional[Callable[[int, List[int]], None]] = None,
        on_event: Optional[Callable[[RequestLifecycle], None]] = None,
        tracer=None,
        metrics=None,
    ):
        check_observers(metrics, tracer, "Scheduler")
        if n_slots < 1:
            raise ValueError("n_slots must be >= 1")
        if chunk < 1:
            raise ValueError("chunk must be >= 1")
        if max_queue is not None and max_queue < 1:
            raise ValueError("max_queue must be >= 1 (or None for unbounded)")
        if retries < 0:
            raise ValueError("retries must be >= 0")
        if prefill_chunk is not None:
            if prefill_chunk < 1:
                raise ValueError(
                    "prefill_chunk must be >= 1 (or None for whole-prompt admission instead of "
                    "chunked admission)"
                )
            if not engine.supports_chunked_prefill:
                raise ValueError(f"chunked prefill: {engine._prefix_refusal()}; use prefill_chunk=None")
        self.prefill_chunk = prefill_chunk
        self.engine = engine
        self.n_slots = n_slots
        self.chunk = chunk
        self.speculate = speculate
        self.max_queue = max_queue
        self.retries = retries
        self.backoff_s = backoff_s
        self.nan_guard = nan_guard
        self.faults = faults
        self.on_tokens = on_tokens
        self.on_event = on_event
        self._clock = clock
        self._sleep = sleep
        self.slots = engine.init_slots(n_slots, speculate=speculate)
        self.queue: Deque[Request] = deque()
        self._tenants: List[Optional[_Tenant]] = [None] * n_slots
        # chunked admissions in flight: slot -> (Request, PendingAdmission)
        self._pending: Dict[int, tuple] = {}
        self.outcomes: Dict[int, RequestLifecycle] = {}
        self._pending_cancel: Dict[int, str] = {}
        self.decode_steps = 0  # total chunked decode steps executed
        self.steps_active = 0  # sum over steps of active slots (utilisation); tokens in spec mode
        self.chunk_rows = 0  # spec mode: row-chunks dispatched (the accept-rate estimate)
        self.counters: Dict[str, int] = {
            "rejected_queue_full": 0,
            "shed": 0,
            "cancelled": 0,
            "timed_out": 0,
            "failed": 0,
            "nan_quarantined": 0,
            "retries": 0,
            "decode_dispatch_failures": 0,
            "stopped_early": 0,
        }
        self._chunk_ordinal = 0  # decode dispatches over the lifetime
        self._rid_counter = itertools.count()
        self._used_rids = set()  # rids ever seen by this scheduler
        self.tracer = tracer
        self.metrics = metrics
        if engine.prefix_cache is not None:
            # prefix metrics and evict instants share the serve exporter
            # unless the cache has its own
            engine.prefix_cache.attach(metrics=metrics, tracer=tracer)
        if metrics is not None:
            metrics.gauge("serve_slot_capacity", "configured decode-batch slots").set(n_slots)
            # the zero-valued series, so a scrape before traffic (and
            # counters_agree) sees every family
            for key in self.counters:
                metrics.counter(f"serve_{key}_total", f"requests/events: {key}")
            metrics.counter("serve_submitted_total", "submit() calls incl. queue-full rejections")
            metrics.counter("serve_finished_total", "requests that reached FINISHED")
            metrics.counter("serve_tokens_total", "committed output tokens")
            metrics.counter("serve_decode_chunks_total", "decode/speculative chunk dispatches")

    def _count(self, key: str, n: int = 1) -> None:
        """The one place ``counters`` increments happen: the host-side dict
        and the exported ``serve_<key>_total`` series move together."""
        self.counters[key] += n
        if self.metrics is not None:
            self.metrics.counter(f"serve_{key}_total").inc(n)

    def _observe_gauges(self) -> None:
        if self.metrics is None:
            return
        active = self.n_active
        self.metrics.gauge("serve_queue_depth", "requests waiting for admission").set(len(self.queue))
        self.metrics.gauge("serve_active_slots", "slots with a live tenant").set(active)
        self.metrics.gauge("serve_batch_efficiency",
                           "active slots / capacity at the last chunk boundary").set(active / self.n_slots)
        if self.speculate is not None and self.chunk_rows:
            self.metrics.gauge("serve_spec_accept_rate",
                               "estimated draft-token acceptance rate").set(self.spec_accept_rate)

    def _trace_lifecycle(self, rec: RequestLifecycle) -> None:
        """Replay one terminal record as spans on its ``req:<rid>`` lane.
        Every timestamp comes from the record (the scheduler's own lifecycle
        stamps), so tracing takes no clock readings here."""
        lane = f"req:{rec.rid}"
        # QUEUED from submit to the first transition, then each history
        # entry to the next; the terminal entry is an instant with the reason
        t_prev, name_prev = rec.submitted_at, "queued"
        for state, at in rec.history:
            self.tracer.complete(name_prev, t_prev, at, cat="lifecycle", lane=lane, args={"rid": rec.rid})
            t_prev, name_prev = at, state.value
        self.tracer.instant(rec.state.value, ts=rec.finished_at, cat="lifecycle", lane=lane,
                            args={"rid": rec.rid, "reason": rec.reason, "n_tokens": rec.n_tokens})

    def _observe_latency(self, rec: RequestLifecycle) -> None:
        """Terminal-time latency histograms (a record turns terminal once)."""
        if rec.ttft is not None:
            self.metrics.histogram("serve_ttft_seconds", "submit -> first token").observe(rec.ttft)
        if rec.tpot is not None:
            self.metrics.histogram("serve_tpot_seconds", "mean time per token after the first").observe(rec.tpot)
        if rec.finished_at is not None:
            self.metrics.histogram("serve_e2e_seconds", "submit -> terminal state").observe(
                rec.finished_at - rec.submitted_at)

    # -- queue ---------------------------------------------------------------

    def submit(self, req: Request) -> int:
        plen = int(req.prompt.size)
        headroom = 0 if self.speculate is None else self.speculate.gamma + 1
        if plen + req.max_new_tokens + headroom > self.engine.max_seq:
            raise ValueError(
                f"request needs {plen + req.max_new_tokens + headroom} cache rows "
                f"(incl. {headroom} speculation headroom), engine "
                f"max_seq={self.engine.max_seq}"
            )
        vocab = self.engine.cfg.vocab
        if req.prompt.min() < 0 or req.prompt.max() >= vocab:
            raise ValueError(
                f"prompt token ids must lie in [0, vocab={vocab}); got range "
                f"[{req.prompt.min()}, {req.prompt.max()}] — out-of-range ids "
                f"index garbage embedding rows"
            )
        if self.metrics is not None:
            # counted after validation, before the queue-full check: finished
            # + cancelled + timed_out + shed + failed + rejected_queue_full ==
            # submitted (a ValueError above is a malformed call, not a request)
            self.metrics.counter("serve_submitted_total").inc()
        if self.max_queue is not None and len(self.queue) >= self.max_queue:
            # a loud reject with its reason: the caller decides whether to
            # retry, and the queue never grows without bound
            self._count("rejected_queue_full")
            if self.tracer is not None:
                self.tracer.instant("reject_queue_full", cat="admission", lane="scheduler",
                                    args={"queued": len(self.queue)})
            raise QueueFullError(
                f"admission queue full ({self.max_queue} waiting): request "
                f"rejected — resubmit later, shrink the burst, or raise max_queue"
            )
        if req.rid is None:
            # skip values a caller-supplied rid already claimed
            req.rid = next(r for r in self._rid_counter if r not in self._used_rids)
        elif req.rid in self._used_rids:
            raise ValueError(
                f"rid {req.rid!r} already used in this scheduler (a Request "
                "submitted elsewhere keeps its assigned rid — pass a fresh "
                "Request or an explicit unique rid)"
            )
        self._used_rids.add(req.rid)
        rec = RequestLifecycle(rid=req.rid, submitted_at=self._clock())
        self.outcomes[req.rid] = rec
        self.queue.append(req)
        if self.tracer is not None:
            self.tracer.instant("submit", ts=rec.submitted_at, cat="lifecycle", lane=f"req:{req.rid}",
                                args={"rid": req.rid, "prompt_len": plen, "max_new_tokens": req.max_new_tokens})
        self._observe_gauges()
        return req.rid

    def cancel(self, rid: int, reason: str = "cancelled by client") -> bool:
        """Flag a request for cancellation; applied at the next chunk
        boundary (queued → removed before prefill, decoding → slot
        reclaimed). False if the rid is unknown or already terminal."""
        rec = self.outcomes.get(rid)
        if rec is None or rec.state.terminal:
            return False
        self._pending_cancel[rid] = reason
        return True

    @property
    def n_active(self) -> int:
        return sum(t is not None for t in self._tenants)

    @property
    def idle(self) -> bool:
        return not self.queue and self.n_active == 0 and not self._pending

    @property
    def spec_accept_rate(self) -> float:
        """Estimated draft acceptance over all speculative dispatches: a
        row-chunk commits 1 + γ·accept_rate tokens on average (a slight
        underestimate when rows finish mid-dispatch). 0.0 until a speculative
        chunk has run."""
        if self.speculate is None or self.chunk_rows == 0:
            return 0.0
        tokens_per_row_chunk = self.steps_active / self.chunk_rows
        return max(0.0, (tokens_per_row_chunk - 1.0) / self.speculate.gamma)

    def summary(self) -> dict:
        """Lifecycle and latency summary: TTFT/TPOT percentiles over finished
        requests, terminal-state counts and the robustness counters."""
        out = latency_summary(self.outcomes.values())
        out["counters"] = dict(self.counters)
        out["decode_steps"] = self.decode_steps
        return out

    # -- lifecycle internals -------------------------------------------------

    def _terminal(
        self,
        rec: RequestLifecycle,
        state: RequestState,
        reason: str,
        tokens: Optional[List[int]] = None,
    ) -> None:
        rec.transition(state, self._clock(), reason)
        rec.new_tokens = np.asarray(tokens or [], np.int32)
        rec.n_tokens = int(rec.new_tokens.size)
        if self.tracer is not None:
            self._trace_lifecycle(rec)
        if self.metrics is not None:
            self._observe_latency(rec)
        if self.on_event is not None:
            self.on_event(rec)

    def _evict(self, slot: int, state: RequestState, reason: str) -> None:
        """Reclaim a slot mid-flight (cancel, timeout, quarantine): terminal
        transition with the partial tokens, then deactivate the row."""
        tenant = self._tenants[slot]
        assert tenant is not None
        self._terminal(self.outcomes[tenant.req.rid], state, reason, tokens=tenant.emitted)
        self._tenants[slot] = None
        self.slots = self.engine.release_slot(self.slots, slot)

    def _apply_cancels(self) -> None:
        if not self._pending_cancel:
            return
        keep: Deque[Request] = deque()
        for req in self.queue:
            reason = self._pending_cancel.pop(req.rid, None)
            if reason is None:
                keep.append(req)
            else:
                self._count("cancelled")
                self._terminal(self.outcomes[req.rid], RequestState.CANCELLED, reason)
        self.queue = keep
        # chunked admissions cancel between their chunks: release the prefix
        # handle and drop the pending state; the slot's rows were never
        # written, so the slot is simply free again
        for slot, (req, pending) in list(self._pending.items()):
            reason = self._pending_cancel.pop(req.rid, None)
            if reason is not None:
                self._count("cancelled")
                self.engine.abort_admission(pending)
                del self._pending[slot]
                self._terminal(self.outcomes[req.rid], RequestState.CANCELLED, reason)
        for slot, tenant in enumerate(self._tenants):
            if tenant is None:
                continue
            reason = self._pending_cancel.pop(tenant.req.rid, None)
            if reason is not None:
                self._count("cancelled")
                self._evict(slot, RequestState.CANCELLED, reason)
        self._pending_cancel.clear()  # unknown or raced rids: nothing to do

    def _enforce_deadlines(self) -> None:
        now = self._clock()
        # queued requests whose deadline already passed are shed before
        # they cost a prefill
        keep: Deque[Request] = deque()
        for req in self.queue:
            rec = self.outcomes[req.rid]
            waited = now - rec.submitted_at
            expired = None
            if req.ttft_deadline_s is not None and waited > req.ttft_deadline_s:
                expired = (
                    f"shed in queue: TTFT deadline {req.ttft_deadline_s}s "
                    f"expired after {waited:.3f}s waiting"
                )
            elif req.deadline_s is not None and waited > req.deadline_s:
                expired = (
                    f"shed in queue: deadline {req.deadline_s}s expired "
                    f"after {waited:.3f}s waiting"
                )
            if expired is None:
                keep.append(req)
            else:
                self._count("shed")
                self._terminal(rec, RequestState.SHED, expired)
        self.queue = keep
        # mid-prefill deadlines (a chunked admission spans steps); the TTFT
        # deadline always applies: there is no first token yet
        for slot, (req, pending) in list(self._pending.items()):
            rec = self.outcomes[req.rid]
            age = now - rec.submitted_at
            expired = None
            if req.deadline_s is not None and age > req.deadline_s:
                expired = (f"deadline {req.deadline_s}s exceeded mid-prefill "
                           f"({pending.pos}/{pending.plen} prompt tokens)")
            elif req.ttft_deadline_s is not None and age > req.ttft_deadline_s:
                expired = (f"TTFT deadline {req.ttft_deadline_s}s exceeded mid-prefill "
                           f"({pending.pos}/{pending.plen} prompt tokens)")
            if expired is not None:
                self._count("timed_out")
                self.engine.abort_admission(pending)
                del self._pending[slot]
                self._terminal(rec, RequestState.TIMED_OUT, expired)
        for slot, tenant in enumerate(self._tenants):
            if tenant is None:
                continue
            req = tenant.req
            rec = self.outcomes[req.rid]
            age = now - rec.submitted_at
            if req.deadline_s is not None and age > req.deadline_s:
                self._count("timed_out")
                self._evict(
                    slot,
                    RequestState.TIMED_OUT,
                    f"deadline {req.deadline_s}s exceeded after {len(tenant.emitted)} tokens",
                )
            elif (
                req.ttft_deadline_s is not None
                and rec.first_token_at is None
                and age > req.ttft_deadline_s
            ):
                self._count("timed_out")
                self._evict(
                    slot,
                    RequestState.TIMED_OUT,
                    f"TTFT deadline {req.ttft_deadline_s}s exceeded before first token",
                )

    def _with_retry(self, fn, what: str):
        """Bounded exponential-backoff retry around one engine dispatch.
        Sound because a failed dispatch leaves the slot state as it was
        (``Engine.decode_slots`` commits at the end of a chunk; an admission
        only writes a free slot)."""
        delay = self.backoff_s
        last: Optional[Exception] = None
        for attempt in range(self.retries + 1):
            try:
                return fn()
            except Exception as e:  # noqa: BLE001 — retry, then re-raise below
                last = e
                if attempt < self.retries:
                    self._count("retries")
                    if self.tracer is not None:
                        self.tracer.instant("retry", cat="fault", lane="scheduler",
                                            args={"what": what, "attempt": attempt + 1, "error": repr(e)})
                    self._sleep(delay)
                    delay *= 2
        raise DispatchError(f"{what} failed after {self.retries + 1} attempt(s): {last!r}") from last

    # -- scheduling ----------------------------------------------------------

    def _record_tokens(self, tenant: _Tenant, new: List[int]) -> bool:
        """Append a chunk's emitted tokens to the tenant, cut after a stop
        token (kept), and stream exactly those. True if a stop token ended
        the request."""
        rec = self.outcomes[tenant.req.rid]
        stopped = False
        if tenant.stop:
            for i, t in enumerate(new):
                if t in tenant.stop:
                    new = new[: i + 1]
                    stopped = True
                    break
        if new:
            if rec.first_token_at is None:
                rec.first_token_at = self._clock()
            tenant.emitted.extend(new)
            rec.n_tokens = len(tenant.emitted)
            if self.metrics is not None:
                self.metrics.counter("serve_tokens_total").inc(len(new))
            if self.on_tokens is not None:
                self.on_tokens(tenant.req.rid, list(new))
        return stopped

    def _finish(self, slot: int, *, stopped: bool) -> Completion:
        """FINISH a tenant (budget exhausted or stop token). An early stop
        releases the slot; budget exhaustion already deactivated the row."""
        tenant = self._tenants[slot]
        assert tenant is not None
        if stopped:
            self._count("stopped_early")
            self.slots = self.engine.release_slot(self.slots, slot)
        if self.metrics is not None:
            self.metrics.counter("serve_finished_total").inc()
        self._terminal(
            self.outcomes[tenant.req.rid],
            RequestState.FINISHED,
            "stop token" if stopped else "budget exhausted",
            tokens=tenant.emitted,
        )
        self._tenants[slot] = None  # freed; refilled at the next chunk boundary
        return Completion(
            rid=tenant.req.rid,
            prompt=tenant.req.prompt,
            new_tokens=np.asarray(tenant.emitted, np.int32),
            admitted_at_step=tenant.admitted_at_step,
            finished_at_step=self.decode_steps,
            stopped=stopped,
        )

    def _note_prefix(self, rec: RequestLifecycle, prompt_len: int) -> None:
        """Stamp the admission's prefix-cache hit onto its lifecycle record,
        and trace a hit as a ``cache_hit`` instant."""
        h = self.engine.take_prefix_handle()
        if h is None:
            return
        rec.prefix_hit_tokens = h.length
        if h.length and self.tracer is not None:
            self.tracer.instant("cache_hit", cat="prefix", lane="scheduler",
                                args={"rid": rec.rid, "hit_tokens": h.length, "prompt_len": prompt_len})

    def _install_tenant(self, slot: int, req: Request, prefill_chunks: int = 1) -> Optional[Completion]:
        """After a successful admission: the DECODING transition, the prefix
        and chunk stamps and the tenant; in spec mode also the first token,
        sampled at admission, which completes a budget-1 request right
        here."""
        rec = self.outcomes[req.rid]
        rec.prefill_chunks = prefill_chunks
        rec.transition(RequestState.DECODING, self._clock())
        self._note_prefix(rec, int(req.prompt.size))
        tenant = _Tenant(req, self.decode_steps)
        self._tenants[slot] = tenant
        if self.speculate is not None:
            stopped = self._record_tokens(tenant, [int(self.slots["t_pend"][slot])])
            if stopped or len(tenant.emitted) >= req.max_new_tokens:
                return self._finish(slot, stopped=stopped)
        return None

    def _admit_free_slots(self) -> List[Completion]:
        """Fill free slots from the queue. A prefill that keeps failing
        fails only its request; the slot stays free for the next one. In
        spec mode a request done at admission (budget 1, or a stop token
        first) is returned, and its slot refills in the same round. With
        ``prefill_chunk`` set, admission is chunked (:meth:`_admit_chunked`)."""
        if self.prefill_chunk is not None:
            return self._admit_chunked()
        done: List[Completion] = []
        for slot in range(self.n_slots):
            while self.queue and self._tenants[slot] is None:
                req = self.queue.popleft()
                rec = self.outcomes[req.rid]
                rec.transition(RequestState.PREFILLING, self._clock())

                def dispatch(req=req, slot=slot):
                    if self.faults is not None:
                        self.faults.on_prefill(req.rid)
                    return self.engine.admit_slot(
                        self.slots,
                        slot,
                        req.prompt,
                        max_new_tokens=req.max_new_tokens,
                        temperature=req.temperature,
                        seed=req.seed,
                        speculate=req.speculate is not False,
                    )

                try:
                    self.slots = self._with_retry(
                        dispatch, what=f"admission prefill (request {req.rid})"
                    )
                except DispatchError as e:
                    self._count("failed")
                    self._terminal(rec, RequestState.FAILED, str(e))
                    continue  # the slot is still free: try the next request
                c = self._install_tenant(slot, req)
                if c is not None:
                    done.append(c)
        return done

    def _admit_chunked(self) -> List[Completion]:
        """Chunked admission: free slots claim queued requests (prefix
        lookup and install; the fault plan's prefill failure fires here),
        then every pending admission prefills ``prefill_chunk`` more prompt
        tokens. One that completes is installed in this same step; one that
        keeps failing is FAILED alone, its prefix pins released."""
        done: List[Completion] = []
        for slot in range(self.n_slots):
            if self._tenants[slot] is not None or slot in self._pending:
                continue
            if not self.queue:
                break
            req = self.queue.popleft()
            rec = self.outcomes[req.rid]
            rec.transition(RequestState.PREFILLING, self._clock())

            def begin(req=req):
                if self.faults is not None:
                    self.faults.on_prefill(req.rid)
                return self.engine.begin_admission(
                    req.prompt, max_new_tokens=req.max_new_tokens, temperature=req.temperature,
                    seed=req.seed, speculate=req.speculate is not False, chunked=True,
                )

            try:
                pending = self._with_retry(begin, what=f"admission begin (request {req.rid})")
            except DispatchError as e:
                self._count("failed")
                self._terminal(rec, RequestState.FAILED, str(e))
                continue
            self._pending[slot] = (req, pending)
        for slot, (req, pending) in sorted(self._pending.items()):

            def fail(e: DispatchError, req=req, pending=pending, slot=slot) -> None:
                self.engine.abort_admission(pending)
                del self._pending[slot]
                self._count("failed")
                self._terminal(self.outcomes[req.rid], RequestState.FAILED, str(e))

            try:
                self._with_retry(lambda pending=pending: self.engine.advance_admission(pending, self.prefill_chunk),
                                 what=f"prefill chunk (request {req.rid})")
            except DispatchError as e:
                fail(e)
                continue
            if not pending.done:
                continue
            try:
                self.slots = self._with_retry(
                    lambda pending=pending, slot=slot: self.engine.finish_admission(self.slots, slot, pending),
                    what=f"admission install (request {req.rid})",
                )
            except DispatchError as e:
                fail(e)
                continue
            del self._pending[slot]
            c = self._install_tenant(slot, req, pending.prefill_chunks)
            if c is not None:
                done.append(c)
        return done

    def _harvest(self, slot: int) -> Optional[Completion]:
        tenant = self._tenants[slot]
        if tenant is None or len(tenant.emitted) < tenant.req.max_new_tokens:
            return None
        assert len(tenant.emitted) == tenant.req.max_new_tokens, (
            "the slot's active mask emitted past the request budget"
        )
        return self._finish(slot, stopped=False)

    def _dispatch_decode(self):
        """One decode chunk with fault injection and bounded retry. Returns
        ``(tokens, valid, slots)``, or None after exhausted retries — then
        every active tenant is FAILED and the slot state rebuilt so queued
        requests still serve."""
        ordinal = self._chunk_ordinal
        self._chunk_ordinal += 1

        def dispatch():
            if self.faults is not None:
                self.faults.on_chunk(ordinal)
            if self.speculate is None:
                return self.engine.decode_slots(self.slots, self.chunk)
            return self.engine.spec_decode_slots(self.slots, self.chunk)

        try:
            return self._with_retry(dispatch, what=f"decode chunk {ordinal}")
        except DispatchError as e:
            self._count("decode_dispatch_failures")
            for slot, tenant in enumerate(self._tenants):
                if tenant is None:
                    continue
                self._count("failed")
                self._terminal(
                    self.outcomes[tenant.req.rid], RequestState.FAILED, str(e),
                    tokens=tenant.emitted,
                )
                self._tenants[slot] = None
            self.slots = self.engine.init_slots(self.n_slots, speculate=self.speculate)
            return None

    def _inject_and_guard_nan(self) -> None:
        """After a chunk: the FaultPlan poisons due rows, then the guard
        fails and quarantines every non-finite row."""
        if self.faults is not None:
            for slot, tenant in enumerate(self._tenants):
                if tenant is not None and self.faults.poison_due(tenant.req.rid, len(tenant.emitted)):
                    self.slots = self.engine.poison_logit_row(self.slots, slot)
        if not self.nan_guard:
            return
        occupied = [s for s, t in enumerate(self._tenants) if t is not None]
        if not occupied:
            return
        finite = self.engine.finite_logit_rows(self.slots)
        for slot in occupied:
            if not finite[slot]:
                self._count("nan_quarantined")
                self._count("failed")
                if self.tracer is not None:
                    self.tracer.instant("nan_quarantine", cat="fault", lane="scheduler",
                                        args={"slot": slot, "rid": self._tenants[slot].req.rid})
                self._evict(
                    slot,
                    RequestState.FAILED,
                    "non-finite logits: row quarantined (slot scrubbed; neighbours unaffected)",
                )

    def step(self) -> List[Completion]:
        """One chunk boundary: apply cancels, enforce deadlines, admit into
        free slots, run one decode chunk, harvest completions, guard NaNs."""
        done: List[Completion] = []
        self._apply_cancels()
        self._enforce_deadlines()
        done.extend(self._admit_free_slots())
        if self.n_active == 0:
            self._observe_gauges()
            return done
        # the span covers the dispatch and the host fetch of its tokens (the
        # sync point), so it is the chunk's wall; it reads the tracer's
        # clock, never the scheduler's, so tracing cannot move a deadline
        span = contextlib.nullcontext() if self.tracer is None else self.tracer.span(
            "decode_chunk", cat="scheduler", lane="scheduler", ordinal=self._chunk_ordinal,
            active=self.n_active, chunk=self.chunk, spec=self.speculate is not None)
        with span as sp:
            res = self._dispatch_decode()
            if self.metrics is not None:
                self.metrics.counter("serve_decode_chunks_total").inc()
            if res is None:
                self._observe_gauges()
                return done
            toks, valid, self.slots = res
            self.decode_steps += self.chunk
            if self.speculate is not None:
                self.chunk_rows += self.n_active * self.chunk
            committed = int(valid.sum())
            self.steps_active += committed
            if sp is not None:
                sp.annotate(tokens=committed)
        if self.speculate is not None and self.tracer is not None:
            self._trace_spec_subchunks(valid)
        if self.metrics is not None:
            self.metrics.histogram("serve_chunk_commit_tokens", "tokens committed per decode chunk",
                                   buckets=tuple(float(2**i) for i in range(10))).observe(committed)
        for slot, tenant in enumerate(self._tenants):
            if tenant is None:
                continue
            stopped = self._record_tokens(tenant, [int(t) for t in toks[slot][valid[slot]]])
            if stopped:
                done.append(self._finish(slot, stopped=True))
            else:
                c = self._harvest(slot)
                if c is not None:
                    done.append(c)
        self._inject_and_guard_nan()
        self._observe_gauges()
        return done

    def _trace_spec_subchunks(self, valid: np.ndarray) -> None:
        """Per row and speculative sub-chunk, how many drafted tokens the
        verify kept and how many rolled back, as ``spec_verify`` instants on
        the request's lane, read off the host's valid mask (each sub-chunk
        row: γ draft places, then the bonus or correction token). Their
        device time is in the chunk span and in ``torch.profiler``'s
        ``engine/spec_chunks`` range."""
        gamma = self.speculate.gamma
        ordinal = self._chunk_ordinal - 1
        for slot, tenant in enumerate(self._tenants):
            if tenant is None or tenant.req.speculate is False:
                continue  # plain rows have no draft to account for
            sub = valid[slot].reshape(self.chunk, gamma + 1)
            for j in range(self.chunk):
                committed = int(sub[j].sum())
                if committed == 0:
                    continue  # the row went inactive before this sub-chunk
                accepted = max(0, committed - 1)
                self.tracer.instant("spec_verify", cat="speculative", lane=f"req:{tenant.req.rid}",
                                    args={"chunk": ordinal, "sub": j, "drafted": gamma, "accepted": accepted,
                                          "rolled_back": gamma - accepted})

    def run(self, max_chunks: int = 100_000) -> List[Completion]:
        """Drain the queue; completions in finish order. Requests that end
        CANCELLED / TIMED_OUT / FAILED / SHED produce no Completion — read
        their records from ``outcomes`` (or stream them via ``on_event``)."""
        out: List[Completion] = []
        for _ in range(max_chunks):
            if self.idle:
                return out
            out.extend(self.step())
        raise RuntimeError(f"scheduler did not drain within {max_chunks} chunks")
